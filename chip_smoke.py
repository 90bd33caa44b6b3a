#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py

Phases, each a hard check (any failure exits non-zero and prints no result):

1. the card (``nvidia-smi`` name and power limit) and the nvcc build of
   every kernel source, from this checkout (one nvcc per source, all
   started together); what a process holds on the card beside its
   allocator's reserve (its CUDA context), read while it is alone there;
2. every hand-written kernel held against its plain PyTorch version on the
   card, timed with CUDA events (median over batches of back-to-back
   launches after warm-up) beside its plain version, the one PyTorch call
   computing the same function where there is one, and its bound: the
   larger of bytes moved / 3.35 TB/s and operations / peak (67 TFLOP/s
   fp32 without tensor cores, 989 TFLOP/s bf16):
   K1 one leaf a launch and K2 (max abs error, fp32 <= 1e-5, bf16 <=
   2e-2); K1 over each path's whole leaf set in one launch (the MLP's, and
   Granite-3.0-2B's, Mamba2-130M's and Qwen1.5-MoE's at 3 layers in the
   dtypes their runs store), with and without momentum, and K2 over
   `PREFIX_SHAPES` (the MLP's cells and Mamba2-130M's blocked ring, whose
   phase-10 run stores fp32), each bitwise equal to its
   plain version and to a second launch, timed beside ``torch._foreach_add``
   (K1); K3 flash
   attention over its shape grid (allclose with atol = rtol = 2e-5 fp32,
   2e-2 bf16, `tests/test_kernels.py`'s rule), plus K3's gradients through
   `FlashAttention` against the reference's; K4 chunked SSD over its shape
   grid (y allclose as K3, the state within 1e-4 fp32 / 1e-2 bf16 of its
   magnitude), its gradients through `SSDScan`, and one launch under
   ``vmap`` with a batched A, equal to a loop (K5: phase 11); K6, the
   lane-sharded scatter, over `SCATTER_SHAPES` (every ring row and w'
   bitwise equal to the plain version), timed beside its plain version and
   ``index_copy_``, and across cells in one launch (`CELLS_SCATTER_SHAPES`:
   4 and 27 cells, fp32 and bf16 rings, bitwise), timed beside
   ``index_copy_`` on the flattened (B·R, P) ring;
3. the MLP slice — the paper's experiment, the plain path:
   ``run_experiment(FLConfig(n_clients=256, concurrency=64,
   server_steps=2000, engine="scan"), "gen_async", eval_every=500)`` with
   the full-width `ClassificationTask` MLP (hidden 128, batch 128, shard
   1024);
4. the MLP per-event kernel path (``update="pallas"``, block_size=1): K1
   launches == T, leaves covered == T x 6, weights within 1e-5 of
   ``update="jnp"``;
5. the MLP blocked kernel path (``block_size=8, update="pallas"``): K2
   launches == block count, weights within 1e-5 of ``update="jnp"``;
   against the per-event run, eval accuracies within 10/2048 at T=2000 and
   weights within 1e-4 at T=200;
6. the replay engine against the port's own per-event Python oracle at full
   width and T=200 (<= 1e-5), then a profile of the MLP kernel paths;
7. Granite-3.0-2B at full width in fp32, at the config's remat "full": one
   loss and gradient with the kernel (``use_pallas=True``) and with the
   plain attention — loss within 1e-5 relative, gradients within 1e-4 x
   max|g| — and one more with the kernel at remat "none" on the same
   weights and batch, bitwise the "full" one; K3 launches == 2 x layers a
   gradient at "full" (the recompute runs each block's forward again);
8. the LM slice: full-width Granite-3.0-2B (bf16, ``use_pallas=True``),
   ``LMTask(batch 8, seq 128, shard 256)`` through ``run_experiment(
   FLConfig(n_clients=20, concurrency=4, server_steps=64,
   sampling="optimal", speed_ratio=10.0, engine="scan"), "gen_async",
   eval_every=16)`` (``run_lm``'s configuration with C cut from 8 to 4 to
   fit the card; remat "full"), then the same task with ``update="pallas"``:
   K3 launches == 40 x (2 x 64 gradients + 4 evals), K1 launches == 64
   covering 64 x 11 leaves, eval loss
   finite and falling, the curve within `LM_CURVE_TOL` of the plain
   attention's, peak device memory, and a profile of a few events;
9. Mamba2-130M (K4) and Zamba2-2.7B (K3 at head_dim 80 and K4) at full
   width in fp32, at remat "full" and, with the kernels, "none" (bitwise),
   as phase 7: one loss and gradient with the kernels and with the plain
   versions — loss within 1e-5 relative, gradients within 1e-4 x max|g|,
   K4 launches == 2 x num_layers and K3 launches == shared sites a gradient
   (the hybrid recomputes its Mamba2 bodies, not its shared block);
10. the Mamba2 LM slice at full width and depth (bf16, ``use_pallas=True``,
   remat pinned to "none", below): ``run_lm``'s configuration, ``LMTask(batch 8, seq 128, shard 256)``,
   n=20, C=8, sampling "optimal", speed ratio 10, with T cut from 200 to 64
   and the eval cadence from 50 to 16, four ways: ``run_experiment`` (K4),
   ``update="pallas"`` (K1 launches == 64, leaves 64 x 11), blocked
   ``block_size=4,
   update="pallas"`` (K2 launches == block rows, K4 through the `vmap`
   rule == 24 x (block rows + evals)), and the plain SSD; K4 launches ==
   24 x forwards on the per-event runs, eval loss finite, the clients'
   training loss over the run's 64 trained minibatches falling (K4 and
   plain SSD; the eval loss does not fall over these 64 events, with the
   plain SSD neither), the curves within `MAMBA_CURVE_TOL` of each other
   and the eval loss of the initial weights with K4 within
   `MAMBA_CURVE_TOL["plain_ssd"]` of the plain SSD's, peak device memory,
   and a profile of a few events of the per-event and blocked kernel paths;
11. K5, the grouped expert matmul, against its plain version over
   `GMM_SHAPES` (allclose with atol = rtol = 2e-5 fp32, 2e-2 bf16), timed
   at Qwen1.5-MoE-A2.7B's path shape beside the plain version and
   `torch.bmm`; its gradients through `MoeGMM`; one launch under ``vmap``
   over 4 lanes, equal to a loop; a CPU tensor takes the plain version and
   a dtype mismatch raises;
12. Qwen1.5-MoE-A2.7B at full width, depth cut to `MOE_LAYERS`, in fp32
   under the sort dispatch, at remat "full" and "none" as phase 7: one loss
   and gradient with the kernels (K3, K5) and with the plain versions —
   loss within 1e-5 relative, gradients within 1e-4 x max|g|, K5 launches
   == 2 x 3 x layers a gradient — and the loss of the
   einsum dispatch (no K5) on the same weights within 1e-5 of the sort
   dispatch's;
13. the Qwen1.5-MoE LM slice at full width, depth `MOE_LAYERS` (bf16,
   ``use_pallas=True``, ``moe_dispatch="sort"``): ``run_lm``'s
   configuration with C cut to 4, T to 64 and the eval cadence to 16, as
   for Granite, three ways: ``run_experiment`` (K3 + K5), ``update=
   "pallas"`` (K1 launches == 64, leaves 64 x 19) and ``use_pallas=False``
   (plain
   attention, bf16 einsum experts on the same dispatch), at remat "full";
   K5 launches == 3 x layers x forwards and K3 == layers x forwards on the
   kernel runs, a gradient counting two forwards (`_passes`),
   eval loss finite and falling, the curves within 1e-3 (K1) and
   `MOE_CURVE_TOL` (plain) of the kernel run's, peak device memory, and a
   profile of a few events.

14.-16. FedBuff on the MLP, the lane-sharded MLP slice on 2 gloo ranks
   sharing the card, the FL launcher's defaults, FedAvg and FAVANO.  The
   same 2 ranks then run, at T=400 (`LANE_T`), the fused device stream
   blocked E=8 with ``devices=2`` (event clock and completion counts exact
   against the unsharded fused run, weights within 1e-4), the host stream
   under phase 18's guard with a spiking / NaN gradient (rejects and stale
   drops equal to the unsharded run's, weights within 1e-4, K6 launches ==
   block rows) and ``run_matrix(devices=2, kernel="pallas")`` over 2 seeds
   x 2 policies (K6 scatters the 4 cells in one launch a block; curves,
   final accuracies and the cells' weights within 1e-4 of the unsharded
   matrix); then 4 gloo ranks run ``run_matrix(stream="device",
   devices=2)`` as shard 2 x lane 2 at T=200 (`SHARD_T`) against the
   unsharded device matrix (curves within 1e-4, eval times and extras
   exact).  Every rank's
   results are bitwise equal to every other's;
17. the scenario matrix on the host stream (``--only matrix`` the MLP's,
   `phase_matrix`; ``--only matrix_mamba`` the Mamba2-130M matrix below,
   first in the LM lane, see `phase_matrix_mamba`): the paper's grid as `examples/scenario_matrix.py`
   runs it (the MLP, n=40, C=16,
   T=2000, seeds 0-2 x policies uniform / optimal / physical_time x speed
   ratios 1, 4, 16 = 27 cells, eta 0.08, eval every 200) through
   ``run_matrix`` per event and blocked E=8 (curves within 10/2048 of each
   other, one cell against ``run_experiment`` of it alone: eval times
   bitwise, curve within 10/2048), then the kernel paths on the same stacked
   inputs: K1 across cells per event (3 launches an event, the final weights
   bitwise the flat update's or within 1e-5) and K2 across cells blocked
   (one launch a block, bitwise its plain version), events/s summed over
   cells beside one run's, and profiles.  The Mamba2-130M matrix (phase
   10's run over 3 policies, at the config's remat "full"): (i) first one
   vmapped gradient call as its blocked engine makes it over 48 folded
   rows (3 cells x 2 lanes x batch 8) at remat "none", "dots" and "full"
   (the peak above the call's entry printed for each, the gradients bitwise
   equal, "full"'s peak the lower, "dots"'s between), then over 96 rows
   (E=4) at "full";
   (ii) per event and blocked E=`MAMBA_MATRIX_E`, K4 folded over the cells
   (24 launches a forward, 48 a gradient), curves finite and within
   `MAMBA_CURVE_TOL["blocked"]` of each other and of each cell run alone
   (per event; the "optimal" cell blocked too),
   peak device memory; then the cells' final weights from ``jit_runner``
   on the same stacked inputs (curves bitwise run_matrix's, or within 1e-5
   relative): each cell's training loss over its trained minibatches
   falls, and each cell's weights lie nearer its own run alone (per event)
   or its own per-event cell (blocked) than `MAMBA_OWN_GAP` of the nearest
   other cell's.  Phase 2 also holds K2 and K1 across the matrix's 27 cells
   alone (bitwise; K2 timed over rotating copies of its operands, three
   L2s in all, K1 beside ``torch._foreach_addcmul``) and K4 at the
   matrix's folds;
18. faults, the divergence guard, scenarios and kill-and-resume
   checkpointing on the host stream (``--only robust`` the MLP's,
   `phase_robust`; ``--only robust_mamba`` Mamba2-130M's), at
   the reference's benchmark settings (`ROBUST_FAULT`, ``GuardConfig(
   max_grad_norm=1e3, stale_cutoff=4 C)``).  The MLP slice (n=256, C=64,
   T=2000, eval every 500): per event (flat update) and blocked E=8 with K2
   under faults and the guard (K2 bitwise ``update="jnp"``, ``kind_count``
   the stream's, ``stale_drops`` computed from ``delay_steps`` and the
   scales, no rejects), per event with K1 under faults (bitwise the flat
   update or within 1e-5); a gradient that spikes by 1e6 every 50th step
   and is NaN at one step (the rejects equal the injected live events, the
   weights stay finite; unguarded the run ends non-finite or above 1e4);
   scenarios ``erlang2_onoff`` and ``hyperexp2`` per event and blocked with
   K2 (``kind_count`` the stream's over 6 kinds); ``run_matrix(scenario=
   "erlang2")`` blocked over phase 17's 27 cells, K2 across cells on the
   same stacked inputs bitwise its curves, one cell against
   ``run_experiment`` alone.  Kill and resume: the blocked checkpointed run
   (``ckpt_every=500``) is bitwise the un-checkpointed run; the same run in
   a child process SIGKILLs itself after its second save and a fresh child
   resumes it, bitwise the uninterrupted run (the children run beside the
   MLP and matrix parts, which their timings then include); per event,
   truncate and resume in process.  Mamba2-130M at full width and depth
   (phase 10's blocked E=4 run, K4 + K2, with T cut to
   `ROBUST_MAMBA_T` = 32) with faults, the guard, a bf16 ring and
   ``ckpt_every=16``, truncated to step 16 and resumed: bitwise; events/s
   with and without checkpoints, a save's bytes and the time the carry
   copy holds the loop, peak device memory and the free disk.  The
   checkpoints go under ``build/`` and are deleted.

19. the device event stream, its control plane and adaptive sampling
   (``--only stream``; `phase_stream`, after phase 18 in the MLP lane; its
   sizes are cut for time, `STREAM_CARD_T` and below).  (a) The stream at the MLP
   slice's network (n=256, C=64, its speeds and sampling p; T cut from
   2000 to 1000) from uniforms drawn on the CPU: on the card equal to the
   CPU's run of the same draws (J, K, slot, delay and the integer
   statistics exactly; times and float statistics within 1e-6 relative),
   also over 27 cells of T=250 on the cell axis; the replay check of
   `tests/test_stream_device.py` (FIFO, Lemma 9, delays); under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync) one chunk of
   the stream, and one chunk of the fused runner on the MLP,
   importance-weighted and adaptive (slot scales, replay, ``ctrl_refresh``);
   `generate_stream` events/s against `export_stream`'s and device
   operations an event.  (e) MVA on the card against the numpy Buzen (<=
   1e-5 relative) and the milliseconds of one ``ctrl_refresh`` at n=256,
   C=64.  (b) ``run_experiment(FLConfig(stream="device"))`` on the
   full-width MLP (T=2000, eval every 500; per event, plain), then on the
   same draws per event with K1 (launches == T, weights within 1e-5 of the
   plain run) and blocked E=8 (the plain prefix: the reference's blocked
   device path takes only the default update; eval accuracies within
   10/2048 of per event), FedBuff Z=10 with K1 and adaptive
   (refresh every 250: ``p_final`` sums to 1, its Theorem-1 bound below
   uniform's); every accuracy rises and ends within the host stream's
   range at seeds 0-2 (blocked E=8) widened by 0.02; a
   profile of the K1 run.  (d) ``run_matrix(stream="device")`` over phase
   17's 27 cells at T=1000, plain and adaptive (p refreshed at each eval
   point, every 200): finite curves, accuracy rising in every cell,
   events/s summed, and every adaptive cell with unequal speeds ending
   below uniform's bound.  (c) Mamba2-130M at full width and depth (phase
   10's configuration, n=20, C=8, T=64) per
   event on the device stream, K4 + K1: K1 launches == T, K4 == 24 x
   forwards, the clients' training loss over the run's trained minibatches
   falling, events/s and peak memory.

20. faults, the divergence guard, scenarios and the checkpointed fused
   driver on the device stream (``--only stream_robust``;
   `phase_stream_robust`, after phase 19 in the MLP lane; phase 18's settings on the
   MLP slice's network, sizes cut for time, `ROBUST_DEV_*`).  (a) The fault
   stream and the ``erlang2_onoff`` / ``hyperexp2`` scenario streams at
   T=1000 from uniforms drawn on the CPU: on the card equal to the CPU's
   run of the same draws (J, K, slot, kind, delay and the integer
   statistics exactly; times and float statistics within 1e-6 relative),
   the fault stream also over 27 cells of T=250 on the cell axis.  (b)
   ``run_experiment(FLConfig(stream="device"))`` on the full-width MLP
   (T=2000, eval every 500) with faults and the guard, per event and
   blocked E=8 (accuracies within 10/2048 of per event, ``kind_count``
   equal), and per event with K1 under faults (T cut to 1000; launches ==
   T, flips included; weights within 1e-5 of the flat update on the same
   draws);
   each run's ``kind_count`` the stream's (`generate_stream` of the same
   seed), summing to T, its stale drops those of the stream's delays and
   scales; the accuracy rises and ends within the host stream's range under
   the same faults (phase 18's runs and seeds 0-7, replayed in lockstep on
   the cell axis) widened by 0.02.
   (c) A gradient that spikes by 1e6 every 50th step and is NaN at one live
   step, T=500: guarded, the rejects equal the injected live events and the
   weights stay finite; unguarded, non-finite or above 1e4.  (d)
   ``erlang2_onoff`` per event (T cut to 1000; ``kind_count`` the stream's
   over 6 kinds, accuracy rising) and ``run_matrix(stream="device",
   scenario="erlang2")`` over phase 17's 27 cells at T=1000 (finite curves,
   accuracy rising in every cell, each cell's kinds summing to T, events/s
   summed).  (e) Checkpoints: the MLP per event with faults and the guard
   through `engine_ckpt.run_checkpointed` (``ckpt_every=250``, T=1000),
   truncated to its second save and resumed in process (bitwise), and a
   child process (``--robust-child DIR fused_kill``) that SIGKILLs itself
   after its second save, then a fresh child (``fused_resume``) that
   resumes, bitwise the uninterrupted run (the children run beside
   (b)-(d)); Mamba2-130M at full width and depth (phase 19
   (c)'s configuration, T cut to 32) per event with faults and the guard,
   ``ckpt_every=16``, truncated to step 16 and resumed (bitwise; K4
   launches == 24 x forwards; the clients' training loss over the run's
   trained minibatches falls).  Events/s, a save's bytes, the milliseconds
   the carry copy holds the loop and peak memory are printed; the
   checkpoints go under ``build/`` and are deleted.

21. the sparse O(C) stream and the class-collapsed control plane
   (``--only sparse``; `phase_sparse`, last in the MLP lane; `SPARSE_*`).  (a)
   The sparse stream at n = 10^3 and 10^6 (`tests/test_scale.py`'s two speed
   classes, C=64, T=1000), clean and under phase 18's faults, from uniforms
   drawn on the CPU: on the card equal to the CPU's run of the same draws
   (J, K, slot, kind, delay and the integer statistics exactly; times and
   float statistics within 1e-6 relative); the class occupancy sums to C;
   its laws over 8 cells x 2500 events at 10^6 (time-averaged occupancy C,
   mean delay C-1 within 0.5 sqrt(C), class occupancy within 5% of the
   class-collapsed MVA); the per-event time at 10^6 within 2x of that at
   10^3 (warm streams, timed alternately); a chunk under
   ``set_sync_debug_mode("error")``.  (b) The class MVA at 10^6 against the
   numpy float64 MVA (<= 1e-5) and the milliseconds of one
   ``ctrl_refresh(counts=)``.  (c) The slice's path: ``run_experiment(
   FLConfig(n_clients=50_000, concurrency=64, server_steps=1000,
   engine="scan", stream="device"), "gen_async", eval_every=250,
   task=ClassificationTask(shard_size=128))`` on the full-width MLP (the
   paper's two clusters, "optimal" p: m = 2 classes; ``sparse="auto"`` takes
   the sparse stream), then per event with K1 on the same draws (launches ==
   T, weights within 1e-5), K1 under phase 18's faults with the flip rates
   scaled by 256/n (`_sparse_fault`; kinds sum to T), the plain update under
   those faults and phase 18's guard (kinds sum to T), every accuracy rising,
   a profile of the K1 run, and a chunk of the sparse fused runner under the
   faults and the guard, importance-weighted and adaptive, under the sync
   check.  Cuts: shard 1024 -> 128 and T 2000 -> 1000.

22. the serving plane (``--only serve``; `phase_serve`, last in the LM
   lane; `SERVE_*`), under two serving configurations: `tests/test_serving.py`'s
   2x overload (arrival 6, serve 3, queue cap 5, deadline 1, 2 retries,
   backoff 0.1 / 0.4) and the serving driver's CLI defaults (arrival 2,
   serve 4, queue cap 8, deadline 2, 2 retries).  (a) The stream merged with
   the serving plane (`scan_draws(serving=)`) at the MLP slice's network
   (n=256, C=64, T=1000) under each, from uniforms drawn on the CPU: on the
   card equal to the CPU's run of the same draws (events, integer
   statistics, the request table and its counters and histograms exactly;
   times and float statistics within 1e-6 relative); the serving marginal's
   law against `simulate_serving_host` at `test_device_matches_host_oracle_law`'s
   configuration, network (n=8, C=4) and bars, 16 cells x 1000 events on
   the cell axis; a chunk under ``set_sync_debug_mode("error")``.  (b) The
   full-width MLP through ``run_experiment(FLConfig(stream="device"),
   "gen_async", serving=overload)`` at T=1000, checkpointed every 250
   events: requests conserved exactly (served + shed + timed out + pending
   = arrivals), queue depth <= the cap, the read path's checksum finite,
   accuracy rising; truncated after its second save and resumed, bitwise;
   a gradient that spikes by 1e6 every 50th step and is NaN at step 333
   under phase 18's guard (T=400: rejected updates never served, the
   checksum finite) and unguarded (T=400: the poison reaches the served
   rows); a chunk of the fused runner with serving and the guard under the
   sync check, and its profile.  (c) Mamba2-130M at full width and depth
   (``use_pallas=True``) through the driver's training plane
   (`launch.serve._train_under_traffic`: 8 clients, C=4, T=32 merged events,
   ``LMTask(batch 2, seq 16)``) under the CLI's traffic: K4 launches == 24
   x T (a serve event computes a gradient too), requests conserved, the
   known-good step moved; then `launch.serve._decode` from those weights
   (B=4, prompt 16, 32 steps: prefill and decode ms, tokens/s), decode of
   48 tokens against the full-sequence forward (bf16 within
   `SERVE_DECODE_BF16_TOL`; the same weights in fp32 within 1e-4 of the
   largest logit over 16 positions), profiles of the training plane and of
   decode.  (d) Granite-3.0-2B decode at full width and depth (bf16, random
   weights from the seed): the same checks.  (e)
   Qwen1.5-MoE-A2.7B decode at full width, depth `MOE_LAYERS`, sort
   dispatch: K5 (``use_pallas``) against the plain experts on the same
   tokens, on the tokens routed to the same experts in both (bf16 2e-2 of
   the largest logit); K5 launches == 3 x layers x steps.  (f) The serving
   driver's command line (`tests/test_serve_driver.py`'s arguments) on the
   card.  Phase 2 also holds K4 at the serve task's shape and K5 at
   decode's 4-row capacity.
23. the optimizer step (`optim.make_optimizer`, `api.train_step`), the dry
   run and the examples (group ``optim``, last in the LM lane): (a)
   Mamba2-130M at full width and depth (``use_pallas=True``, remat pinned
   to "none") on one fixed
   `SyntheticLMStream` batch of 8 x 128 with `optimizer_for`'s AdamW (fp32
   moments): `OPTIM_WARM` warm-up steps, then `OPTIM_STEPS` timed, the
   sampling weight cycling over 1/(n p_j) of the LM slice's network; the
   loss falls, every ``grad_norm`` is finite, ``count`` is 19, the moments
   are fp32, K4 launches == 24 x 19; ms a step, tokens/s, peak GiB and one
   profiled step.  (b) The first step again with the plain SSD: new params
   and loss within 2e-2 of the largest value.  (c) Each optimizer's update
   (sgd, momentum, adamw; fp32 and bf16 state) on the card against the same
   update on the CPU over 3 steps: fp32 within `OPTIM_F32_REL` of each
   leaf's largest magnitude, bf16 within one ulp; Arctic's `optimizer_for`
   keeps m in bf16.  (d) Qwen1.5-MoE-A2.7B at depth `MOE_LAYERS`, sort
   dispatch, K3 + K5, AdamW: `OPTIM_MOE_STEPS` steps, the loss falls,
   ``moe_aux`` finite and > 0, the first step's loss equal to `api.loss_fn`'s
   on the same params, at the config's remat "full": K3 / K5 launches ==
   2 x 3 / 2 x 9 a step.  (e)
   `launch.dryrun.run_pair` of (a)'s and (d)'s configs at their 8 x 128
   shape on the meta device: ``ok``, its parameter count, the card's peak
   >= its argument bytes; the counted FLOPs (with (d)'s recompute, and at
   remat "none") against 6 N D and the achieved TFLOP/s beside the card's
   name and power limit.  (f) A duck-typed task
   (`_DuckTask`, wrapping `ClassificationTask`'s build) through
   `run_experiment`, the K1 replay and `run_matrix` over 2 cells with K1
   across them, bitwise the same runs with `ClassificationTask`.  (g)
   ``examples/torch/quickstart.py`` in a child process exits 0.
24. Zamba2-2.7B's first async-FL training run (group ``zamba``, in the LM
   lane after the Mamba2 matrix, before the MLP lane's Mamba2 parts
   declare their memory; `ZAMBA_*`): ``run_lm``'s
   configuration (``LMTask(batch 8, seq 128, shard 256)``, n=20, sampling
   "optimal", speed ratio 10, C cut from 8 to `ZAMBA_C`: 8 rows of the fp32
   ring alone are 72.2 GiB) at full width and depth (54
   Mamba2 layers, 9 shared attention sites, head_dim 80, bf16), remat
   "full", per event with K1 (``update="pallas"``), T cut from 200 to
   `ZAMBA_T` with an eval every `ZAMBA_EVAL`, once with the kernels (K3,
   K4, K1) and once with the plain attention and SSD on the same weights:
   K3 launches == 9 a forward, K4 == 54 x (2 a gradient + 1 an eval), K1
   == T; eval losses finite, the clients' training loss over the run's
   trained minibatches falling in both, the curves within
   `ZAMBA_CURVE_TOL`, the eval loss of the initial weights and the training
   loss after the run within `ZAMBA_INIT_TOL` and `ZAMBA_TRAIN_TOL`; the peak, events/s, tokens/s and a `ZAMBA_PROFILE_T`-event
   profile.  Phase 2 holds K3 and K4 at its shapes (`FA_PATH_SHAPES`,
   `SSD_ZAMBA_SHAPE`).
25. the model-sharded train step (group ``sharded``, last in the MLP
   lane; `SHARDED_*`): Granite-3.0-2B at full width, depth cut to 4, bf16
   and fp32, one fixed `SyntheticLMStream` batch of 8 x 128, AdamW,
   ``use_pallas=True``, remat "none", on 2 gloo ranks sharing the card
   (`launch.lanes.run_lanes`) over two meshes of the same ranks: (data 1,
   model 2) under the tensor-parallel rules ``tp_only`` and (data 2, model
   1) under the default (FSDP) rules.  Parameters, optimizer state and
   batch are DTensors (`launch.shardings`), `api.train_step` runs under
   ``activate_rules``, and K3 runs on each rank's local heads through
   ``local_map``: K3 launches == 4 a step on every rank; the loss and the
   gathered gradients (the new first moment) against the one-rank step of
   the same weights and batch (bf16 within 2e-2, through K3 as the sharded
   step; fp32 1e-5 for the loss and 1e-4 x max|g| for the gradients,
   through the plain attention, so that K3 on the ranks' local heads is
   held against the plain route as phase 7 holds it); the leaves that set
   the bf16 gaps, beside one rank's bf16 gradient against its fp32 one;
   ms a step, collective bytes (`launch.op_analysis.OpCounter`) and peak
   GiB a rank; the ranks' reserved peaks plus a CUDA context each (phase
   1's reading) within the phase's declaration `SHARDED_GIB`.  Phase 2 holds K3 at the ranks'
   shapes (`FA_PATH_SHAPES`).

Remat.  The configs default to ``remat="full"``, as the reference's do
(`src/repro/configs/base.py:50`), and the port rematerialises as the
reference does (`models/remat.py`): phases 7-9, 12, 13, 17's matrix, 23
(d) and 24 run at that default, and their launch counts take the
recompute's second forward of each block (`_passes`).  Phases 10, 17's
cells run alone, 18's, 19's and 20's Mamba2 parts,
22 (c) and 23 (a)-(b) hold under 20 GiB and pass ``remat="none"``
explicitly, so that their times and peaks stay comparable with PERF.md's
history: the reference runs that value itself (`smoke_config`, the 100m
preset), and remat changes what the backward keeps, not the numbers
(`tests/test_torch_remat.py`; phases 7, 9, 12 and 17 (i) on the card).

A whole run builds the kernels, then runs phases 2 and 11 alone in a
process of their own (``--lane-out``; the kernel lane), so that their
timings see no other process on the card and their profiler has traced
nothing before (after the other phases, in one process, it read half the
kernels' device time).  Then it runs two lanes (`LM_LANE`, `MLP_LANE`):
the MLP lane's groups (mlp, lanes, matrix, robust, stream, stream_robust,
sparse, robust_mamba, sharded: phases 3-6, 14-16, 17 and 18 on the MLP,
19-21, 18 on Mamba2-130M, 25) run in a second process (its output in
``build/lanes/MLP_lane.log``, printed whole when it ends) beside the LM
lane's (matrix_mamba, zamba, granite, ssm, moe, serve, optim: phases 17 on
Mamba2-130M, 24, 7-13, 22, 23) in this one: the card idles 82-98% of every path but MoE, so the two
lanes share it with little wait.  Each part that holds more than a few
GiB of the card declares it (`_card_memory`), and a declaration waits
while both lanes' would pass `CARD_BUDGET_GIB`.  The events/s and
profiles of phases 3-22 are taken beside the other lane.
The CPU runs that phases 19-22 hold the card to, and phase 21's client
shards, are computed in CPU-only worker processes of the lane that needs
them, beside its first phases.

Phase 10 reuses phase 17's run of its "optimal" Mamba2 cell alone (the
same configuration, asserted), and the phases of each lane share one
Mamba2-130M task and its setup (`_mamba_task`); every LM part prints its set-up time
apart from its timed runs.  ``--memory-history`` records the allocator's
history around phase 17's blocked Mamba2 matrix and prints the owners of
the live memory at K2's plain-version entry and at the peak.

Phases 4, 5, 8, 10, 13, 17, 18, 19, 20, 21, 22, 23, 24 and 25 are the kernel paths: each launch
count is zeroed just before the run and read just after.  fp32 matmuls run
in full fp32 (TF32 off for matmul and cuDNN).  The line before the last is
the ``kernels`` JSON object; the last line is the result object.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

# The blocked Mamba2 matrix (phase 17) peaks at 62.8-73.3 GiB of the card's
# 79.2 and has run out of memory with 6 GiB of the allocator's cache reserved
# but too fragmented to use; expandable segments let the allocator reuse
# that memory (the cause of the swing stays open: ROADMAP Queue 3).  Set
# before torch first touches the card; the phase-18 children inherit it.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
L2_BYTES = 50 * 2**20       # H100 SXM L2 cache
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py's
# K3 shapes (B, S, H, K, D, T, window, q_offset): the grid of
# tests/test_kernels.py, the LM path shapes (Granite-3.0-2B's,
# Qwen1.5-MoE-A2.7B's, Zamba2-2.7B's shared attention at head_dim 80, then
# the sharded Granite step's two a rank), a long causal sequence with and without a window,
# D=80 and D=128 with ragged S and T, rows whose every key is masked (T a
# multiple of the key tile or not), and windows that let the tensor-core
# kernel's 64-row query tiles skip 64-key tiles on both sides, beside rows
# masked on every key (q tile 0 of the last shape visits every tile)
FA_PATH_SHAPES = [(8, 128, 32, 8, 64, 128, 0, 0), (8, 128, 16, 16, 128, 128, 0, 0),
                  (8, 128, 32, 32, 80, 128, 0, 0),
                  # phase 25's Granite shapes a rank: tensor parallel (16 q / 4 kv
                  # heads), FSDP (4 batch rows)
                  (8, 128, 16, 4, 64, 128, 0, 0), (4, 128, 32, 8, 64, 128, 0, 0)]
FA_PATH_SHAPE = FA_PATH_SHAPES[0]
FA_SHAPES = [
    (2, 128, 4, 2, 64, 128, 0, 0),
    (1, 256, 8, 4, 64, 256, 64, 0),
    (1, 64, 4, 1, 128, 64, 0, 0),
    (1, 128, 4, 4, 128, 384, 0, 256),
    (2, 64, 6, 2, 32, 64, 16, 0),
    *FA_PATH_SHAPES,
    (1, 2048, 32, 8, 64, 2048, 0, 0),
    (1, 2048, 32, 8, 64, 2048, 512, 0),
    (2, 100, 8, 2, 80, 100, 0, 0),
    (1, 200, 4, 2, 128, 333, 0, 133),
    (1, 64, 4, 2, 64, 64, 16, 200),
    (1, 40, 2, 1, 64, 50, 8, 100),
    (1, 512, 8, 2, 64, 512, 96, 0),
    (2, 200, 8, 2, 80, 200, 70, 0),
    (1, 192, 4, 2, 128, 256, 40, 100),
    (1, 128, 4, 2, 64, 128, 16, 120),
]
# the LM slice: run_lm's configuration, C cut from 8 to 4.  At remat "full"
# C=8 fits (63.220 GiB, NVIDIA H100 80GB HBM3, 700.00 W), but over T=64 its
# eval loss rises (11.22642 -> 11.30367) and its K3-vs-plain curve gap is
# 1.247e-3: the phase's checks hold C=4's run
LM_ARCH, LM_N, LM_C, LM_T, LM_EVAL = "granite-3-2b", 20, 4, 64, 16
LM_BATCH, LM_SEQ, LM_SHARD = 8, 128, 256
LM_PARAMS = 2_533_531_648
LM_LEAVES = 11
# eval-loss curve, kernel vs plain attention, relative: 5x the gap measured
# on the card (1.95e-4, NVIDIA H100 80GB HBM3, 700 W)
LM_CURVE_TOL = 1e-3
# K4 shapes (B, S, H, P, N, chunk, A range, dt range): the grid of
# tests/test_kernels.py, Mamba2-130M's path shape and the same folded to
# B=32 (blocked E=4), to B=24, 48 and 96 (the matrix's 3 cells per event,
# x 2 lanes blocked on the path, x 4 lanes), Zamba2-2.7B's shape, a long sequence (32
# chunks of carried state), S < chunk, and the overflow case (A in -[1, 16],
# dt up to 1: the masked exp(cs_i - cs_j) is inf, so the kernel must select)
SSD_PATH_SHAPE = (8, 128, 24, 64, 128, 64, (1.0, 16.0), (0.001, 0.1))
SSD_SHAPES = [
    (2, 128, 3, 32, 16, 32, (0.5, 2.0), (0.01, 0.2)),
    (1, 64, 2, 64, 128, 64, (0.5, 2.0), (0.01, 0.2)),
    (1, 256, 4, 16, 8, 16, (0.5, 2.0), (0.01, 0.2)),
    SSD_PATH_SHAPE,
    (32, 128, 24, 64, 128, 64, (1.0, 16.0), (0.001, 0.1)),
    (24, 128, 24, 64, 128, 64, (1.0, 16.0), (0.001, 0.1)),
    (48, 128, 24, 64, 128, 64, (1.0, 16.0), (0.001, 0.1)),
    (96, 128, 24, 64, 128, 64, (1.0, 16.0), (0.001, 0.1)),
    (2, 128, 80, 64, 64, 64, (1.0, 16.0), (0.001, 0.1)),
    (1, 2048, 24, 64, 128, 64, (1.0, 16.0), (0.001, 0.1)),
    (2, 40, 4, 32, 16, 64, (0.5, 2.0), (0.01, 0.2)),
    (2, 128, 3, 32, 16, 64, (1.0, 16.0), (0.0, 1.0)),
]
# the serving plane's training task (phase 22 (c), LMTask(batch 2, seq 16) on
# Mamba2-130M): the chunk 64 covers the 16-token sequence, Q = 16
SSD_SERVE_SHAPE = (2, 16, 24, 64, 128, 64, (1.0, 16.0), (0.001, 0.1))
SSD_SHAPES.append(SSD_SERVE_SHAPE)
# Zamba2-2.7B's training path (phase 24, LMTask(batch 8, seq 128)): 80 heads
# of P = 64, N = 64
SSD_ZAMBA_SHAPE = (8, 128, 80, 64, 64, 64, (1.0, 16.0), (0.001, 0.1))
SSD_SHAPES.append(SSD_ZAMBA_SHAPE)
SSD_STATE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the shapes that must take the tensor-core kernel in bf16 (Mamba2-130M's
# path shape, its blocked and matrix folds, Zamba2-2.7B's), and the ones
# timed in full
SSD_TC_SHAPES = SSD_SHAPES[3:9] + [SSD_SERVE_SHAPE, SSD_ZAMBA_SHAPE]
SSD_TIMED_SHAPES = SSD_SHAPES[3:5] + [SSD_SERVE_SHAPE, SSD_ZAMBA_SHAPE]
SSD_MATRIX_SHAPES = SSD_SHAPES[5:8]
# the Mamba2 LM slice: run_lm's configuration at full width and depth
MAMBA_ARCH, MAMBA_C, MAMBA_E = "mamba2-130m", 8, 4
MAMBA_PARAMS, MAMBA_LEAVES = 128_983_488, 11
# eval-loss curves, relative: 5x the gaps measured on the card (NVIDIA H100
# 80GB HBM3, 700 W): K1 per leaf (bf16 leaves rounded every event) vs the
# fp32 flat update 7.52e-4, K4 vs the plain SSD 2.77e-4, blocked E=4 vs
# per-event 1.76e-4
MAMBA_CURVE_TOL = {"pallas_update": 3.8e-3, "plain_ssd": 1.4e-3, "blocked": 8.8e-4}
# K5 shapes (E, C, D, F): Qwen1.5-MoE-A2.7B's path shapes (one dispatch group
# of 8 x 128 tokens, capacity 88; gate / up, then down), the grid of
# tests/test_kernels.py, a ragged capacity, C over two 128-row slabs with D
# and F that rule out 16-byte loads, and Arctic's per-expert shape at 16 of
# its 128 experts (capacity 12 from a group of 512 tokens, top-2; bf16 only)
GMM_PATH_SHAPES = [(60, 88, 2048, 1408), (60, 88, 1408, 2048)]
GMM_PATH_SHAPE = GMM_PATH_SHAPES[0]
GMM_SHAPES = [
    *GMM_PATH_SHAPES,
    (4, 256, 128, 256),
    (2, 128, 256, 128),
    (8, 64, 64, 64),
    (4, 20, 256, 128),
    (3, 130, 100, 70),
]
GMM_ARCTIC = (16, 12, 7168, 4864)
# decode (phase 22 (e)): B = 4 tokens a step route 16 choices over 60 experts,
# the capacity floor of 4 rows an expert (layers._capacity); gate / up, down
GMM_DECODE_SHAPES = [(60, 4, 2048, 1408), (60, 4, 1408, 2048)]
GMM_SHAPES += GMM_DECODE_SHAPES
# gradients and vmap: Qwen1.5-MoE's experts at the capacity of phase 12's
# batch (2 x 128 tokens: 24)
GMM_GRAD_SHAPE = (60, 24, 2048, 1408)
# the Qwen1.5-MoE LM slice: run_lm's configuration at full width, depth cut
# from 24 to 3 layers (the bf16 ring of 24 layers is 28.6 GB a row)
MOE_ARCH, MOE_LAYERS = "qwen2-moe-a2.7b", 3
MOE_PARAMS, MOE_LEAVES = 2_334_007_296, 19
# eval-loss curve, K3 + K5 vs plain attention and einsum experts, relative:
# 5x the gap measured on the card (7.30e-4, NVIDIA H100 80GB HBM3, 700 W)
MOE_CURVE_TOL = 3.7e-3
MLP_LEAVES = {  # the ClassificationTask MLP at dim 64, hidden 128, 10 classes
    "b1": (128,), "b2": (128,), "b3": (10,),
    "w1": (64, 128), "w2": (128, 128), "w3": (128, 10),
}
EXTRA_SHAPES = [(17,), (1000, 37), (3, 5, 7)]
# K6 shapes (ring rows C+1, P, E, padded lanes on the trash row, ring dtype):
# the MLP's blocked ring and block (the main path's), a ragged P, and
# Mamba2-130M's fp32 ring at C=8 (128,983,488 padded to a multiple of 1024)
# with E=4, in fp32 and as a bf16 ring
SCATTER_PATH_SHAPE = (65, 26624, 8, 3, torch.float32)
SCATTER_SHAPES = [
    SCATTER_PATH_SHAPE,
    (65, 26624, 8, 3, torch.bfloat16),
    (65, 26122, 8, 3, torch.float32),
    (9, 128_984_064, 4, 0, torch.float32),
    (9, 128_984_064, 4, 0, torch.bfloat16),
]
# K2 cells (ring rows C+1, P, E, padded lanes on the trash row, ring dtype,
# w dtype): the MLP's blocked ring at E in {4, 8, 16} (two padded lanes at
# E > 2; E=8 fp32 is the main path's), fp32 and bf16 rings beside fp32 w, a
# ragged P, then Mamba2-130M's blocked ring at C=8 (128,983,488 padded to a
# multiple of 1024) with E=4, fp32 and bf16 (the ring and w both)
PREFIX_PATH_SHAPE = (65, 26624, 8, 2, torch.float32, torch.float32)
PREFIX_SHAPES = [
    (65, 26624, 4, 2, torch.float32, torch.float32),
    PREFIX_PATH_SHAPE,
    (65, 26624, 16, 2, torch.float32, torch.float32),
    (65, 26624, 4, 2, torch.bfloat16, torch.float32),
    (65, 26624, 8, 2, torch.bfloat16, torch.float32),
    (65, 26624, 16, 2, torch.bfloat16, torch.float32),
    (65, 26122, 8, 2, torch.float32, torch.float32),
    (9, 128_984_064, 4, 0, torch.float32, torch.float32),
    (9, 128_984_064, 4, 0, torch.bfloat16, torch.bfloat16),
]
# the lane-sharded MLP slice: 2 gloo ranks sharing the one card
LANE_RANKS, MLP_E, FEDBUFF_Z = 2, 8, 10
# phase 15's later runs under lanes and shards, at the MLP slice's width (T
# cut from 2000 to 400 for time, eval every 200): the fused device stream,
# the guard on the host stream, and run_matrix over 2 seeds x 2 policies
# (4 cells) on 2 ranks; then the device matrix on 4 ranks (shard 2 x lane
# 2), T cut to 200 (eval every 100): five processes on the one card ran it
# at 73.2 events/s summed at T=400 (NVIDIA H100 80GB HBM3, 700 W)
LANE_T, LANE_EVAL, LANE_NAN_STEP = 400, 200, 333
SHARD_RANKS, SHARD_T, SHARD_EVAL = 4, 200, 100
LANE_GRID = dict(seeds=(0, 1), policies=("uniform", "optimal"), speed_ratios=(10.0,))
# the scenario matrix (phase 17): examples/scenario_matrix.py's configuration,
# 3 seeds x 3 policies x 3 speed ratios = 27 cells, uncut; MATRIX_CELL is the
# (seed, policy, ratio) index of the cell run alone (flc's: seed 0, "optimal",
# ratio 4)
MATRIX_N, MATRIX_C, MATRIX_T, MATRIX_ETA, MATRIX_EVAL, MATRIX_E = 40, 16, 2000, 0.08, 200, 8
MATRIX_GRID = dict(seeds=(0, 1, 2), policies=("uniform", "optimal", "physical_time"),
                   speed_ratios=(1.0, 4.0, 16.0))
MATRIX_CELL = (0, 1, 1)
# K2 and K1 across the matrix's cells, alone: 27 blocked rings of (C+1, P)
# at E = 8 with 2 padded lanes a cell (P padded to a multiple of 1024, as
# the kernel path pads it), fp32 and bf16 rings; K1 over 27 x the MLP's 6
# leaves
CELLS_PREFIX_SHAPES = [(27, 17, 26624, 8, 2, torch.float32), (27, 17, 26624, 8, 2, torch.bfloat16)]
CELLS = 27
# K6 across cells (cells, ring rows C+1, P, E, padded lanes a cell, ring
# dtype): the MLP's blocked ring (n=256, C=64, P padded to a multiple of
# 1024) at E = 8 over the 4 cells of phase 15's lane-sharded matrix and the
# matrix's 27, three lanes a cell on the trash row, fp32 and bf16 rings
CELLS_SCATTER_SHAPES = [(B, 65, 26624, 8, 3, dt) for B in (4, 27)
                        for dt in (torch.float32, torch.bfloat16)]
# the Mamba2-130M matrix: phase 10's configuration over 3 policies (seed 0,
# ratio 10), per event and blocked, at the config's remat "full".  Blocked at
# E=4 the gradient call folds 3 x 4 x 8 = 96 rows; without remat it ran out
# of the card's memory (75.9 GiB allocated, NVIDIA H100 80GB HBM3, 700 W),
# and the blocked matrix ran at E=2 (48 rows) until the port rematerialised
MAMBA_MATRIX_GRID = dict(seeds=(0,), policies=("uniform", "optimal", "physical_time"),
                         speed_ratios=(10.0,))
MAMBA_MATRIX_E = 4
# a matrix cell's final weights lie at most this fraction of the distance to
# the nearest other cell's from its own reference run (`_own_gap`); measured
# 0.12-0.23 (bf16 weights; NVIDIA H100 80GB HBM3, 700 W)
MAMBA_OWN_GAP = 0.4
# 18. faults, the guard, scenarios and checkpoints on the host stream, at the
# reference's benchmark settings (benchmarks/engine.py:371-374); the guard's
# stale cutoff is ROBUST_STALE x C.  The MLP checkpoints every 500 events (a
# multiple of its eval cadence, as the blocked layout needs).  Mamba2-130M
# runs phase 10's blocked configuration with T cut from LM_T = 64 to 32 (the
# whole script's time) and checkpoints every 16 events.  The checkpoints live
# under build/ and are deleted.
ROBUST_FAULT = dict(off_rate=0.2, on_rate=1.0, crash_rate=0.05, timeout_rate=0.1)
ROBUST_NORM, ROBUST_STALE = 1e3, 4
ROBUST_CKPT_EVERY, ROBUST_MAMBA_T, ROBUST_MAMBA_CKPT_EVERY = 500, 32, 16
ROBUST_SPIKE_EVERY = 50
ROBUST_SCENARIOS = ("erlang2_onoff", "hyperexp2")
ROBUST_MATRIX_SCENARIO = "erlang2"
CKPT_ROOT = Path(__file__).resolve().parent / "build" / "robust_ckpt"
# 19. the device event stream: the MLP slice's network (n=256, C=64; its
# runs T=2000, adaptive refreshing p every 250 events).  Cut for time (the
# whole command must end within 1200 s; in a whole run on an NVIDIA H100
# 80GB HBM3 at 700 W phases 1-18 took 734 s and phases 1-19 822 s, with
# phase 20 after them 990 s): the stream alone on the
# card against the CPU at T=1000 and over 27 cells of T=250 on the cell
# axis; the 27-cell device matrix at T=1000 (its time follows the events,
# not the cells, so cutting cells saves nothing); the profiles over 100
# events.  The host stream's accuracy range is taken at three seeds.
STREAM_N, STREAM_C, STREAM_T, STREAM_CARD_T = 256, 64, 2000, 1000
STREAM_CELLS_T, STREAM_REFRESH, STREAM_SEEDS = 250, 250, (0, 1, 2)
STREAM_MATRIX_T, STREAM_PROFILE_T, STREAM_MAMBA_T = 1000, 100, 64

# 20. faults, the guard, scenarios and the checkpointed fused driver on the
# device stream, at phase 18's settings (ROBUST_FAULT, the guard) on the MLP
# slice's network (n=256, C=64; T=2000, eval every 500).  Cut for time (the
# whole command must end within 1200 s, and on a host 10% slower than the
# fastest seen it took 1089 s with these at T=2000): K1 under faults and its
# flat reference run T=1000, as does `erlang2_onoff` per event; the spiking
# gradient runs T=500 events, the 27-cell scenario matrix T=1000 (as phase
# 19's device matrix), the checkpointed MLP T=1000 with a save every 250
# events and Mamba2-130M T=32 (phase 18's ROBUST_MAMBA_T) with a save every
# 16.  The host stream's
# accuracy range under faults is phase 18's runs (seed 0) and eight seeds
# (ROBUST_DEV_SEEDS) replayed in lockstep: three seeds spanned less than
# one realization's spread (PERF.md section 6).  The checkpoints live under
# build/ and are deleted.
ROBUST_DEV_SPIKE_T, ROBUST_DEV_MATRIX_T = 500, 1000
ROBUST_DEV_K1_T, ROBUST_DEV_SCENARIO_T = 1000, 1000
ROBUST_DEV_CKPT_T, ROBUST_DEV_CKPT_EVERY = 1000, 250
ROBUST_DEV_MAMBA_T, ROBUST_DEV_MAMBA_CKPT_EVERY = 32, 16
ROBUST_DEV_SEEDS = tuple(range(8))
ROBUST_DEV_SCENARIO = "erlang2_onoff"
DEV_CKPT_ROOT = Path(__file__).resolve().parent / "build" / "robust_device_ckpt"

# 21. the sparse O(C) stream and the class-collapsed control plane: the
# stream alone at n = 10^3 and 10^6 (two speed classes, `tests/test_scale.py`'s
# mix; C = 64, T = 1000) clean and under phase 18's faults, and its laws over
# 8 cells x 2500 events on the cell axis at n = 10^6; the control plane there; the
# slice's path, the full-width MLP at n = 50,000 (the paper's two clusters,
# "optimal" p: m = 2 classes), where sparse="auto" takes the sparse stream.
# Cut for time (the whole command must end within 1200 s): the MLP's shard
# from 1024 to 128 examples (the host builds the shards client by client: ~15
# s at 128, over a minute and 13 GB at 1024) and T from 2000 to 1000.  The
# MLP's n client shards are built in a CPU-only worker beside the build.
SPARSE_SHARDS = Path(__file__).resolve().parent / "build" / "sparse_shards"
SPARSE_NS, SPARSE_C, SPARSE_T = (1_000, 1_000_000), 64, 1000
SPARSE_LAW_CELLS, SPARSE_LAW_T, SPARSE_CHUNK = 8, 2500, 100
SPARSE_MLP_N, SPARSE_MLP_T, SPARSE_MLP_EVAL, SPARSE_SHARD = 50_000, 1000, 250, 128
SPARSE_PROFILE_T = 100

# 22. the serving plane (`--only serve`; last in the LM lane).  Two serving
# configurations: tests/test_serving.py's 2x overload and the serving
# driver's CLI defaults (src/repro/launch/serve.py:65-71).  (a) the merged
# stream on the MLP slice's network (n=256, C=64) at T=1000, on the card
# against the CPU; its law against the host oracle at
# test_device_matches_host_oracle_law's configuration and bars on that
# test's network (n=8, C=4), 8 cells x 4000 events on the cell axis.  (b) the
# MLP through run_experiment(stream="device", serving=overload) at T=1000
# (cut from the slice's 2000), checkpointed every 250 events.  (c)
# Mamba2-130M at full width and depth through the driver's training plane
# (8 clients, C=4, T=32 merged events, LMTask(batch 2, seq 16)), then decode
# from its weights (B=4, prompt 16, 32 steps).  (d) Granite-3.0-2B decode at
# full width and depth.  (e) Qwen1.5-MoE-A2.7B decode at full width, depth
# MOE_LAYERS, K5 against the plain experts.  (f) the driver's command line.
SERVE_OVERLOAD = dict(arrival_rate=6.0, serve_rate=3.0, queue_cap=5, deadline=1.0,
                      max_retries=2, backoff_base=0.1, backoff_cap=0.4)
SERVE_CLI = dict(arrival_rate=2.0, serve_rate=4.0, queue_cap=8, bucket_rate=0.0,
                 bucket_cap=8.0, deadline=2.0, max_retries=2)
SERVE_LAW = dict(arrival_rate=2.5, serve_rate=3.0, queue_cap=5, deadline=0.8, max_retries=1,
                 backoff_base=0.2, backoff_cap=0.8)
SERVE_T, SERVE_EVAL, SERVE_CKPT_EVERY = 1000, 250, 250
# the spiking gradient's runs (NaN at step 333) and the chunk under the sync
# check and the profile, cut for time
SERVE_SPIKE_T, SERVE_CONTROL_T, SERVE_CHUNK_T = 400, 400, 100
# the law: 16 cells x 1000 events (16,000 pooled, the reference's 3 x 4000)
SERVE_LAW_N, SERVE_LAW_C, SERVE_LAW_CELLS, SERVE_LAW_T = 8, 4, 16, 1000
SERVE_MAMBA_ARGS = ["--arch", "mamba2-130m", "--preset", "full", "--clients", "8",
                    "--concurrency", "4", "--train-steps", "32", "--batch", "4",
                    "--prompt-len", "16", "--steps", "32"]
SERVE_DRIVER_ARGS = ["--arch", "mamba2-130m", "--preset", "small", "--batch", "2",
                     "--prompt-len", "4", "--steps", "4", "--train-steps", "40", "--clients",
                     "4", "--concurrency", "2", "--arrival-rate", "2.0", "--serve-rate", "4.0",
                     "--deadline", "1.0", "--max-retries", "1"]
SERVE_DECODE_B, SERVE_DECODE_PROMPT, SERVE_DECODE_STEPS = 4, 16, 32
# decode against the full-sequence forward at full width and depth: in fp32
# within 1e-4 of the largest logit (16 positions); in bf16 within 5x the gap
# measured on the card (PR 24 call 1, NVIDIA H100 80GB HBM3, 700.00 W:
# Mamba2-130M 3.673e-2, Granite-3.0-2B 2.266e-2 of the largest logit over 48
# positions: bf16 rounds the residual stream at other places token by token)
SERVE_DECODE_FP32_TOL, SERVE_DECODE_FP32_S = 1e-4, 16
SERVE_DECODE_BF16_TOL = {MAMBA_ARCH: 0.18, LM_ARCH: 0.11}
# MoE decode tokens within this of a router tie are counted (ROADMAP Queue 3,
# "Routing flips in bf16"); the comparison leaves out the tokens routed to
# other experts with and without K5
SERVE_ROUTER_TIE = 1e-3
SERVE_CKPT_ROOT = Path(__file__).resolve().parent / "build" / "serve_ckpt"
# phase 23, the optimizer step (`api.train_step`): (a) Mamba2-130M at full
# width and depth with K4, LMTask's batch (8 x 128) and `optimizer_for`'s
# AdamW, OPTIM_WARM warm-up steps and OPTIM_STEPS timed ones, the sampling
# weight cycling over 1/(n p_j) of the LM slice's first clients; (d)
# Qwen1.5-MoE-A2.7B at MOE_LAYERS with K3 + K5, OPTIM_MOE_STEPS steps; (e)
# the dry run at their shape; (f) a duck-typed task over the MLP slice's
# network at OPTIM_DUCK_T events, 2 cells in its matrix.  (b) holds (a)'s
# first step to the plain SSD within the LM path's bf16 tolerance, (c) the
# optimizers' update on the card to the same update on the CPU: fp32 leaves
# within OPTIM_F32_REL of each leaf's largest magnitude, bf16 within one ulp.
OPTIM_WARM, OPTIM_STEPS, OPTIM_MOE_STEPS = 3, 16, 8
OPTIM_F32_REL = 1e-6
OPTIM_DUCK_T = 200
OPTIM_DRYRUN_ROOT = Path(__file__).resolve().parent / "build" / "dryrun_smoke"
# phase 24, Zamba2-2.7B's async-FL training run: run_lm's configuration
# (src/repro/launch/train.py:66-146: LMTask(batch 8, seq 128, shard 256),
# n=20, sampling "optimal", speed ratio 10) at full width and depth (54
# Mamba2 layers, d_model 2560, 9 shared attention sites, head_dim 80, bf16),
# remat "full", per event with K1 (``update="pallas"``).  C cut from 8 to 4:
# the per-event ring packs the mixed bf16 / fp32 tree in fp32 (9.69 GB a row;
# the un-checkpointed per-event replay ignores snapshot_dtype, as the
# reference's does), and C=8's ring alone asked for 72.20 GiB of the card's
# 79.18 (NVIDIA H100 80GB HBM3, 700.00 W).  T cut from 200 to ZAMBA_T for
# time (16, eval every 8, took the whole script to 1038 s), eval every
# ZAMBA_EVAL; a ZAMBA_PROFILE_T-event profile.  The part declares ZAMBA_GIB
# and caps this process's allocator there (its cache reached 77.0 GiB
# reserved for a 61.1 GiB allocated peak, beside the other lane)
ZAMBA_ARCH, ZAMBA_C, ZAMBA_T, ZAMBA_EVAL, ZAMBA_PROFILE_T = "zamba2-2.7b", 4, 8, 4, 2
ZAMBA_GIB = 72
ZAMBA_PARAMS, ZAMBA_LEAVES = 2_422_670_240, 21
# K3 + K4 against the plain attention and SSD, relative gaps (NVIDIA H100
# 80GB HBM3, 700.00 W).  The eval-loss curve: 5x the gap first measured, at
# T=16 (3.004e-3); at T=8 it read 3.913e-3, as large as the curve's own
# movement from the initial weights (1.6e-3-5.4e-3), so this check catches
# only gross faults.  The two below hold the path more tightly, each at 5x its
# reading at T=8 and far below what training moves: the eval loss of the
# initial weights (8.0e-5; 4 events move it 3.2e-3) and the clients' training
# loss over the run's minibatches after it (5.78e-4; the run moves it 3.94e-2)
ZAMBA_CURVE_TOL = 1.5e-2
ZAMBA_INIT_TOL, ZAMBA_TRAIN_TOL = 4e-4, 2.9e-3
# phase 25, the model-sharded train step: Granite-3.0-2B at full width, depth
# cut to SHARDED_LAYERS, LMTask's batch of 8 x 128, AdamW, K3 on each rank's
# local heads, on 2 gloo ranks sharing the card over two meshes of the same
# ranks, (data, model, rules): tensor parallel and FSDP.  bf16 and fp32, each
# against the one-rank step of the same weights and batch: bf16 loss and
# gradients within the LM phases' 2e-2 (of the loss, of the largest
# gradient), fp32 loss within 1e-5 relative, gradients within 1e-4 x max|g|
SHARDED_ARCH, SHARDED_LAYERS = "granite-3-2b", 4
SHARDED_MESHES = ((1, 2, "tp_only"), (2, 1, "default"))
SHARDED_STEPS = 2          # timed bf16 steps a mesh, after the counted one
SHARDED_REF_RANK = {"bfloat16": 0, "float32": 1}  # the rank that runs a dtype's one-rank step
# the attention of a dtype's one-rank step: bf16 K3, as the sharded step (the
# gap is the sharding's); fp32 the plain route (K3 on local heads vs plain)
SHARDED_REF_KERNEL = {"bfloat16": True, "float32": False}
SHARDED_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-5, 1e-4)}  # (loss, gradients)
# both ranks' reserved peaks and CUDA contexts (checked): room beside the
# MoE phases' 52 GiB within CARD_BUDGET_GIB
SHARDED_GIB = 22

# The two lanes of a whole run (`main`).  The LM parts, which hold most of
# the card's memory, run in this process; the MLP and stream parts, which
# hold little of it and leave the card idle 96-98% of their time, run beside
# them in a second process; the kernels against their plain versions run
# before both, alone in a process of their own, so that no other process
# shares the card while they are timed.  A part that holds more than a few GiB
# declares it (`_card_memory`) and waits while the two lanes' declarations
# would pass CARD_BUDGET_GIB of the card's 79.2 (the rest: the processes'
# contexts and the undeclared MLP parts).  Declared: each part's peak in PR
# 24's whole runs (NVIDIA H100 80GB HBM3, 700.00 W) with room to spare; the
# Mamba2 matrix's, Zamba2's, Granite's and Qwen1.5-MoE's from PR 27's runs
# at remat "full" (Granite: 48.1 GiB allocated, 52.9 reserved; MoE: 39.5,
# 44.1-49.4), so that the MLP lane's Mamba2 parts (16 and 21 GiB) fit
# beside them.  Phase 18's Mamba2 part (~35 s) runs last in the MLP lane, to
# even the lanes: the LM lane holds the Mamba2 matrix at T=64 (~310 s) and
# Zamba2's run.  It reserved 35.756 GiB there (beside that process's own
# Mamba2 task), so it declares 38.
LM_LANE = ("matrix_mamba", "zamba", "granite", "ssm", "moe", "serve", "optim")
MLP_LANE = ("mlp", "lanes", "matrix", "robust", "stream", "stream_robust", "sparse", "robust_mamba",
            "sharded")
KERNEL_GROUPS = ("k1k2k6", "fa", "ssd", "gmm")
CARD_BUDGET_GIB = 74.0
LANE_DIR = Path(__file__).resolve().parent / "build" / "lanes"
ROBUST_MAMBA_CKPT_ROOT = Path(__file__).resolve().parent / "build" / "robust_mamba_ckpt"

failures: list[str] = []
# results one phase hands to a later one (the phases of a partial run
# recompute what they need when it is missing)
_SHARED: dict = {}


def check(ok: bool, what: str) -> None:
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass
    return True


@contextlib.contextmanager
def _card_memory(gib: float, label: str):
    """Declare that the enclosed part holds up to ``gib`` GiB of the card
    and wait while the declarations of this run's processes (a ledger under
    `LANE_DIR`) would pass `CARD_BUDGET_GIB`; on leaving, return the
    allocator's cache to the card and withdraw the declaration."""
    import fcntl

    if gib > CARD_BUDGET_GIB:
        raise ValueError(f"{label}: {gib} GiB is more than the budget {CARD_BUDGET_GIB}")
    LANE_DIR.mkdir(parents=True, exist_ok=True)
    ledger, key = LANE_DIR / "card_memory.json", f"{os.getpid()} {label}"

    def update(change) -> bool:
        with open(LANE_DIR / "card_memory.lock", "a+") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            held = json.loads(ledger.read_text() or "{}") if ledger.exists() else {}
            held = {k: v for k, v in held.items() if _alive(int(k.split()[0]))}
            ok = change(held)
            ledger.write_text(json.dumps(held))
            return ok

    def take(held: dict) -> bool:
        if sum(held.values()) + gib > CARD_BUDGET_GIB:
            return False
        held[key] = gib
        return True

    t0 = time.perf_counter()
    while not update(take):
        time.sleep(0.5)
    waited = time.perf_counter() - t0
    if waited >= 1.0:
        print(f"card memory: {label} waited {waited:.1f} s for its {gib} GiB", flush=True)
    torch.cuda.reset_peak_memory_stats()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_reserved() / 2**30
        torch.cuda.empty_cache()
        update(lambda held: bool(held.pop(key, None)))
        print(f"card memory: {label} declared {gib} GiB; reserved peak since the part's last "
              f"reset of the peak {peak:.3f} GiB", flush=True)


def _kill_tree(pid: int, keep_root: bool = False) -> None:
    """SIGKILL every process descended from ``pid`` (read from /proc), and
    ``pid`` itself unless ``keep_root``."""
    kids: dict[int, list[int]] = {}
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                ppid = int((d / "stat").read_text().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                continue
            kids.setdefault(ppid, []).append(int(d.name))
    todo, tree = [pid], []
    while todo:
        q = todo.pop()
        tree.append(q)
        todo.extend(kids.get(q, []))
    for q in tree[1:] if keep_root else tree:
        try:
            os.kill(q, signal.SIGKILL)
        except ProcessLookupError:
            pass


def _die_with_parent() -> None:
    """In a lane's process: once the parent is gone, stop this
    process's descendants and exit."""
    import threading

    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        _kill_tree(os.getpid(), keep_root=True)
        os._exit(3)

    threading.Thread(target=watch, daemon=True).start()


def _start_lane(name: str, groups: list[str], t_start: float):
    """Start a lane: this script on ``groups`` in a process of its own, its
    output to ``LANE_DIR/<name>_lane.log``, its failures, kernel launches and
    kernel rows to ``LANE_DIR/<name>_lane.json``."""
    out, log = LANE_DIR / f"{name}_lane.json", LANE_DIR / f"{name}_lane.log"
    out.unlink(missing_ok=True)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--only", ",".join(groups),
           "--lane-out", str(out), "--t-start", repr(t_start)]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                env=dict(os.environ, PYTHONUNBUFFERED="1"))
    return name, groups, proc, out, log


def _join_lane(lane, launches: dict) -> dict:
    """Wait for a lane, print its output, take its kernel launches and
    failures into this run's, and return its kernel rows."""
    name, groups, proc, out, log = lane
    t0 = time.perf_counter()
    rc = proc.wait()
    print(f"---- the {name} lane (groups {', '.join(groups)}), in a process of its own; "
          f"waited {time.perf_counter() - t0:.1f} s for it ----")
    print(log.read_text(), end="")
    print(f"---- end of the {name} lane ----", flush=True)
    res = json.loads(out.read_text()) if out.is_file() else None
    if res is not None:
        launches.update(res["launches"])
        failures.extend(f"{name} lane: {w}" for w in res["failures"])
    check(rc == 0 and res is not None,
          f"the {name} lane exited {rc} and reported its results {res is not None}")
    return {} if res is None else res["rows"]


def time_ms(fn, batches: int = 11, per_batch: int = 50, warmup: int = 10) -> float:
    """Time of one call as its caller sees it: CUDA events around each batch
    of back-to-back calls, median over the batches of the per-call mean.
    Where the host launches slower than the device runs, this is the host's
    launch cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_batch)
    return float(np.median(times))


_PROFILER_UTILITY_OPS = ("[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                         "profiler::_record_function_enter_new",
                         "profiler::_record_function_exit", "aten::is_leaf", "aten::output_nr",
                         "aten::_version")


def _device_events(prof, device_type=None) -> list:
    """``(name, ms)`` of the profiled window's device events (kernels and
    copies on the card; ``device_type`` another one), read from the
    profiler's raw kineto events: the same events and durations as
    ``prof.events()`` gives, without building its tree of Python objects
    (which took most of a profiled LM part's time: ~12 s per 200k events
    on a CPU), and skipping the utility ops it skips."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _rewrite_name

    want = DeviceType.CUDA if device_type is None else device_type
    return [(_rewrite_name(e.name(), with_wildcard=True), (e.end_ns() - e.start_ns()) / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == want and e.name() not in _PROFILER_UTILITY_OPS
            and not getattr(e, "is_hidden_event", lambda: False)()]


def profile(fn, calls: int = 1):
    """``(device_ms_per_call, wall_ms_per_call, top, device_ops_per_call)``
    over one profiled window: device time is the sum of the kernels' and
    copies' own durations on the card (one stream, so they do not overlap),
    ``top`` the five largest names.  ``None`` device time if the profiler
    saw no device activity."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
    fn()
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    evs = _device_events(prof)
    if not evs:
        return None, wall, [], 0
    by_name: dict[str, float] = {}
    for name, ms in evs:
        by_name[name] = by_name.get(name, 0.0) + ms / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return sum(by_name.values()), wall, top, len(evs) / calls


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------------ #
def _timings(kernel, plain, library=None) -> dict:
    """Per-call time (`time_ms`) and device-only time (`profile`) of a
    kernel, its plain version and, where there is one, the library call."""
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        if fn is None:
            out[key + "ms"], out[key + "device_ms"] = None, None
            continue
        out[key + "ms"] = time_ms(fn)
        out[key + "device_ms"] = profile(fn, calls=50)[0]
    return out


def _rotating(fn, copies: list):
    """``fn`` over the operand tuples of ``copies`` in turn, one tuple a
    call: with copies that add up to several times the L2, no call finds
    the previous calls' operands in the cache."""
    it = itertools.cycle(copies)
    return lambda: fn(*next(it))


def _sum_rows(rows: list[dict]) -> dict:
    return {k: (None if any(r[k] is None for r in rows) else sum(r[k] for r in rows))
            for k in rows[0]}


def _leaf_sets() -> dict:
    """K1's leaf set on each path: name -> [(shape, dtype)], the MLP's 6 fp32
    leaves, then the LM paths' from the model's metadata in the dtypes
    `init_params` stores (Mamba2's A_log and dt_bias stay fp32)."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.module import _stored_dtype
    from repro_torch.tree import tree_leaves

    sets = {"mlp": [(shape, torch.float32) for shape in MLP_LEAVES.values()]}
    for name, cfg in (("granite", get_config(LM_ARCH)), ("mamba2", get_config(MAMBA_ARCH)),
                      ("qwen_moe", get_config(MOE_ARCH).replace(num_layers=MOE_LAYERS))):
        sets[name] = [(tuple(m.shape), _stored_dtype(m, None))
                      for m in tree_leaves(api.model_meta(cfg))]
    return sets


def _k1_cost(leaves: list, momentum: bool) -> tuple[int, int]:
    """Bytes and operations K1 must spend on a leaf set: read w and g, write
    w' (with momentum also read m and write m', fp32)."""
    nbytes = flops = 0
    for shape, dtype in leaves:
        n, esz = int(np.prod(shape)), torch.finfo(dtype).bits // 8
        nbytes += n * (3 * esz + (8 if momentum else 0))
        flops += n * (4 if momentum else 2)
    return nbytes, flops


def _leaf_set(dev, name: str, leaves: list, momentum: float) -> dict:
    """K1 (with ``momentum`` or none) over one path's leaf set, drawn on the
    card: one launch covering every leaf, bitwise equal to the plain version
    leaf by leaf and to a second launch, then timed beside the plain version
    and (no momentum) ``torch._foreach_add`` over the same leaves, plus the
    per-leaf ``torch.addcmul`` calls at the MLP set.  In full at the MLP set;
    at the LM sets a few calls, the plain version a few times (its fp32
    temporaries)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import weighted_update as wu

    g = torch.Generator(device=dev).manual_seed(len(leaves) + int(10 * momentum))
    ws = [torch.randn(shape, generator=g, device=dev).to(dtype) for shape, dtype in leaves]
    gs = [torch.randn(shape, generator=g, device=dev).to(dtype) for shape, dtype in leaves]
    ms = [torch.randn(shape, generator=g, device=dev) for shape, _ in leaves] if momentum else None
    s = torch.tensor(0.37, device=dev)
    key = "weighted_update_momentum" if momentum else "weighted_update"
    wu.reset_launches()
    out, out_m = wu.weighted_update_leaves(ws, gs, s, ms, momentum)
    counted = (wu.launches[key], wu.launches[key + "_leaves"])
    err, same = 0.0, True
    for i in range(len(leaves)):
        rw, rm = ref.weighted_update_ref(ws[i], gs[i], s, m=None if ms is None else ms[i],
                                         momentum=momentum)
        pairs = [(out[i], rw)] + ([(out_m[i], rm)] if momentum else [])
        for a, b in pairs:
            same = same and a.dtype == b.dtype and torch.equal(a, b)
            err = max(err, max_err(a, b) if a.numel() else 0.0)
        del rw, rm
    again, again_m = wu.weighted_update_leaves(ws, gs, s, ms, momentum)
    torch.cuda.synchronize()
    twice = all(torch.equal(a, b) for a, b in zip(out, again))
    if momentum:
        twice = twice and all(torch.equal(a, b) for a, b in zip(out_m, again_m))
    del out, out_m, again, again_m
    n = sum(int(np.prod(shape)) for shape, _ in leaves)
    tag = (f"weighted_update{' momentum' if momentum else ''}, {name} event ({len(leaves)} leaves, "
           f"{n:,} values, {sorted({str(d)[6:] for _, d in leaves})})")
    covered = sum(1 for shape, _ in leaves if np.prod(shape) > 0)
    check(counted == (1, covered) and same and twice and err == 0.0,
          f"{tag}: launches {counted} == (1, {covered}), every leaf bitwise equal to the plain "
          f"version {same} (max abs err {err:.3e}), two launches bitwise equal {twice}")
    b, by = bound_ms(*_k1_cost(leaves, bool(momentum)))
    row = dict(leaves=len(leaves), values=n, max_abs_err=err, bitwise=same, bound_ms=b, bound_by=by)
    kernel = lambda: wu.weighted_update_leaves(ws, gs, s, ms, momentum)  # noqa: E731
    plain = lambda: [ref.weighted_update_ref(ws[i], gs[i], s,  # noqa: E731
                                             m=None if ms is None else ms[i], momentum=momentum)
                     for i in range(len(leaves))]
    if name == "mlp":
        library = None if momentum else (lambda: torch._foreach_add(ws, gs, alpha=-0.37))
        row.update(_timings(kernel, plain, library))
        if not momentum:
            row["addcmul_ms"] = time_ms(lambda: [torch.addcmul(w, x, s, value=-1)
                                                 for w, x in zip(ws, gs)])
            row["addcmul_device_ms"] = profile(lambda: [torch.addcmul(w, x, s, value=-1)
                                                        for w, x in zip(ws, gs)], calls=50)[0]
    elif not momentum:
        quick = dict(batches=5, per_batch=4, warmup=2)
        library = lambda: torch._foreach_add(ws, gs, alpha=-0.37)  # noqa: E731
        row.update(ms=time_ms(kernel, **quick), device_ms=profile(kernel, calls=4)[0],
                   plain_ms=time_ms(plain, batches=3, per_batch=1, warmup=1),
                   plain_device_ms=profile(plain, calls=1)[0],
                   library_ms=time_ms(library, **quick),
                   library_device_ms=profile(library, calls=4)[0])
    print(f"     {tag}: {json.dumps(row)}")
    del ws, gs, ms, kernel, plain
    torch.cuda.empty_cache()
    return row


def _phase_leaf_sets(dev) -> dict:
    """K1 over each path's leaf set (`_leaf_sets`), without momentum (K1a)
    and with it (K1b, timed at the MLP set only), then `update_kernel_info`."""
    from repro_torch.kernels import weighted_update as wu

    rows = {}
    sets = _leaf_sets()
    for momentum in (0.0, 0.9):
        name = "weighted_update_momentum" if momentum else "weighted_update"
        got = {path: _leaf_set(dev, path, leaves, momentum) for path, leaves in sets.items()}
        rows[name] = dict(got["mlp"], path_shapes={p: r for p, r in got.items() if p != "mlp"})
    info = {f"momentum={m}": wu.update_kernel_info(m) for m in (False, True)}
    print(f"     weighted_update_leaves kernels (registers, static shared memory, local bytes, "
          f"CTAs an SM, leaf table bytes, leaves a launch): {json.dumps(info)}")
    check(all(i["local_bytes"] == 0 for i in info.values())
          and all(i["max_leaves"] == wu.MAX_LEAVES for i in info.values()),
          f"weighted_update_leaves kernels spill nothing to local memory and take "
          f"{wu.MAX_LEAVES} leaves a launch")
    for row in rows.values():
        row["kernel_info"] = info
    return rows


def phase_kernels(dev, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels import weighted_update as wu

    rows, grid_worst = {}, {}
    # K1a / K1b at every shape, fp32 and bf16, one leaf a launch
    for momentum in (0.0, 0.9):
        name = "weighted_update_momentum" if momentum else "weighted_update"
        worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
        for dtype in (torch.float32, torch.bfloat16):
            for shape in list(MLP_LEAVES.values()) + EXTRA_SHAPES:
                w = torch.randn(shape, generator=gen).to(dev, dtype)
                g = torch.randn(shape, generator=gen).to(dev, dtype)
                m = torch.randn(shape, generator=gen).to(dev) if momentum else None
                s = torch.tensor(0.37, device=dev)
                kw, km = wu.weighted_update(w, g, s, m=m, momentum=momentum)
                rw, rm = ref.weighted_update_ref(w, g, s, m=m, momentum=momentum)
                err = max_err(kw, rw)
                if momentum:
                    err = max(err, max_err(km, rm))
                worst[dtype] = max(worst[dtype], err)
        torch.cuda.synchronize()
        for dtype, err in worst.items():
            check(err <= TOL[dtype], f"{name} {str(dtype)[6:]} max_abs_err {err:.3e} <= {TOL[dtype]}")
        grid_worst[name] = max(worst.values())
    rows.update(_phase_leaf_sets(dev))
    for name, row in rows.items():
        row["max_abs_err"] = max([grid_worst[name], row["max_abs_err"]]
                                 + [r["max_abs_err"] for r in row["path_shapes"].values()])

    rows.update(_phase_prefix_update(dev))
    rows.update(_phase_scatter_rows(dev))
    _phase_cells(dev, rows)
    return rows


def _phase_cells(dev, rows: dict) -> None:
    """K2 and K1 across the scenario matrix's cells, alone: K2 over
    `CELLS_PREFIX_SHAPES` in one launch (every cell's ring rows and w'
    bitwise equal to the plain version with a cell axis and to a second
    launch), K1 over `CELLS` x the MLP's 6 leaves with one scale a cell
    (bitwise, ceil(6 x 27 / 64) = 3 launches); each timed beside its plain
    version with its byte bound.  Adds them to ``rows`` as ``cells``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import weighted_update as wu

    cells = []
    for B, R, P, E, pad, dtype in CELLS_PREFIX_SHAPES:
        rng = np.random.default_rng(B + E)
        slots_np = np.stack([np.concatenate([rng.choice(R - 1, size=E - pad, replace=False),
                                             np.full(pad, R - 1)]) for _ in range(B)])
        slots = torch.as_tensor(slots_np, device=dev)
        g = torch.Generator(device=dev).manual_seed(B + P)
        snaps0 = torch.randn((B, R, P), generator=g, device=dev).to(dtype)
        w = torch.randn((B, P), generator=g, device=dev)
        D = 0.01 * torch.randn((B, E, P), generator=g, device=dev)
        D[:, E - pad:] = 0.0
        wu.reset_launches()
        ks, kw_ = wu.block_prefix_update(snaps0.clone(), w, D, slots)
        n_launch = wu.launches["block_prefix_update"]
        rs, rw_ = ref.block_prefix_update_ref(snaps0.clone(), w, D, slots)
        again, again_w = wu.block_prefix_update(snaps0.clone(), w, D, slots)
        torch.cuda.synchronize()
        same = torch.equal(ks, rs) and torch.equal(kw_, rw_)
        twice = torch.equal(ks, again) and torch.equal(kw_, again_w)
        err = max(max_err(ks, rs), max_err(kw_, rw_))
        tag = (f"block_prefix_update across {B} cells, {str(dtype)[6:]} rings {(R, P)} E={E} "
               f"({pad} padded a cell)")
        check(n_launch == 1 and same and twice,
              f"{tag}: {n_launch} launch == 1, every cell's ring rows and w' bitwise equal to "
              f"the plain version {same} (max abs err {err:.3e}), two launches bitwise {twice}")
        del ks, kw_, rs, rw_, again, again_w
        esz = torch.finfo(dtype).bits // 8
        distinct = sum(len(set(r.tolist())) for r in slots_np)
        # read w, D, slots; write each cell's distinct ring rows and w'
        b, by = bound_ms(B * (4 * P + 4 * E * P + 8 * E + 4 * P) + distinct * P * esz, B * E * P)
        vec = wu.prefix_vec(snaps0, w, D)
        row = dict(name="block_prefix_update", shape=[B, R, P, E, pad, str(dtype)[6:]],
                   launches=n_launch, max_abs_err=err, bitwise=same, bound_ms=b, bound_by=by,
                   library_ms=None, kernel_info=wu.prefix_kernel_info(dtype, vec, E))
        # timed over rotating copies of the operands, three L2s of them in
        # all: back to back on one copy the rings, w and D stay in the L2
        ops = (snaps0, w, D, slots)
        work = sum(t.numel() * t.element_size() for t in ops)
        copies = [ops] + [tuple(t.clone() for t in ops) for _ in range(-(-3 * L2_BYTES // work) - 1)]
        row.update(copies=len(copies), **_timings(_rotating(wu.block_prefix_update, copies),
                                                  _rotating(ref.block_prefix_update_ref, copies)))
        print(f"     {tag}: {json.dumps(row)}")
        cells.append(row)
        del snaps0, w, D, ops, copies
        torch.cuda.empty_cache()
    rows["block_prefix_update"]["cells"] = cells
    rows["block_scatter_rows"]["cells"] = [_scatter_cells(dev, *sh)
                                           for sh in CELLS_SCATTER_SHAPES]

    g = torch.Generator(device=dev).manual_seed(CELLS)
    shapes = list(MLP_LEAVES.values())
    ws = [torch.randn((CELLS, *sh), generator=g, device=dev) for sh in shapes]
    gs = [torch.randn((CELLS, *sh), generator=g, device=dev) for sh in shapes]
    sc = 0.05 + torch.rand((CELLS,), generator=g, device=dev)
    wu.reset_launches()
    out, _ = wu.weighted_update_leaves(ws, gs, sc)
    counted = (wu.launches["weighted_update"], wu.launches["weighted_update_leaves"])
    again, _ = wu.weighted_update_leaves(ws, gs, sc)
    plain = [ref.weighted_update_ref(w, x, sc)[0] for w, x in zip(ws, gs)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(out, plain))
    twice = all(torch.equal(a, b) for a, b in zip(out, again))
    err = max(max_err(a, b) for a, b in zip(out, plain))
    want = (-(-CELLS * len(shapes) // wu.MAX_LEAVES), CELLS * len(shapes))
    tag = f"weighted_update across {CELLS} cells (the MLP's {len(shapes)} fp32 leaves a cell)"
    check(counted == want and same and twice,
          f"{tag}: launches {counted} == {want}, every cell of every leaf bitwise equal to the "
          f"plain version {same} (max abs err {err:.3e}), two launches bitwise equal {twice}")
    b, by = bound_ms(*(CELLS * x for x in _k1_cost([(sh, torch.float32) for sh in shapes],
                                                   False)))
    row = dict(name="weighted_update", leaves=CELLS * len(shapes), launches=counted[0],
               max_abs_err=err, bitwise=same, bound_ms=b, bound_by=by,
               kernel_info=wu.update_kernel_info(False))
    # the library's one call for w - s[c] g: addcmul over the leaf list,
    # each leaf's scale a (B, 1, ...) view of the cells' scales
    views = [sc.view(-1, *(1,) * (w.ndim - 1)) for w in ws]
    row.update(_timings(lambda: wu.weighted_update_leaves(ws, gs, sc),
                        lambda: [ref.weighted_update_ref(w, x, sc) for w, x in zip(ws, gs)],
                        lambda: torch._foreach_addcmul(ws, gs, views, value=-1.0)))
    print(f"     {tag}: {json.dumps(row)}")
    rows["weighted_update"]["cells"] = [row]


def _scatter_cells(dev, B: int, R: int, P: int, E: int, pad: int, dtype) -> dict:
    """K6 across B cells in one launch against its plain version with a
    cell axis: every cell's ring rows and w' bitwise, a second launch
    bitwise, each cell's lanes ``pad`` of them on the trash row and one
    real row targeted twice (the later lane wins); timed beside the plain
    version and ``index_copy_`` of the B·E rows into the flattened (B·R, P)
    ring plus the final rows' copy (one PyTorch call each; with duplicate
    slots ``index_copy_`` leaves those rows undefined, which no reader
    sees), with its byte bound (`_scatter_cost` a cell)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import weighted_update as wu

    rng = np.random.default_rng(B + E + pad)
    slots_np = np.stack([np.concatenate([rng.choice(R - 1, size=E - pad, replace=False),
                                         np.full(pad, R - 1)]) for _ in range(B)])
    slots_np[:, 1] = slots_np[:, 0]
    slots = torch.as_tensor(slots_np, device=dev)
    g = torch.Generator(device=dev).manual_seed(B + P)
    snaps0 = torch.randn((B, R, P), generator=g, device=dev).to(dtype)
    w = torch.randn((B, P), generator=g, device=dev)
    W = torch.randn((B, E, P), generator=g, device=dev)
    wu.reset_launches()
    ks, kw_ = wu.block_scatter_rows(snaps0.clone(), w, W, slots)
    n_launch = wu.launches["block_scatter_rows"]
    rs, rw_ = ref.block_scatter_rows_ref(snaps0.clone(), w, W, slots)
    again, again_w = wu.block_scatter_rows(snaps0.clone(), w, W, slots)
    torch.cuda.synchronize()
    same = torch.equal(ks, rs) and torch.equal(kw_, rw_)
    twice = torch.equal(ks, again) and torch.equal(kw_, again_w)
    err = max(max_err(ks, rs), max_err(kw_, rw_))
    tag = (f"block_scatter_rows across {B} cells, {str(dtype)[6:]} rings {(R, P)} E={E} "
           f"({pad} padded a cell, a real row twice)")
    check(n_launch == 1 and same and twice,
          f"{tag}: {n_launch} launch == 1, every cell's ring rows and w' bitwise equal to the "
          f"plain version {same} (max abs err {err:.3e}), two launches bitwise {twice}")
    del ks, kw_, rs, rw_, again, again_w
    esz = torch.finfo(dtype).bits // 8
    b, by = bound_ms(sum(_scatter_cost(r.tolist(), P, esz, 4) for r in slots_np), 0.0)
    buf = snaps0
    flat_rows = (torch.arange(B, device=dev)[:, None] * R + slots).reshape(-1)
    row = dict(name="block_scatter_rows", shape=[B, R, P, E, pad, str(dtype)[6:]],
               launches=n_launch, max_abs_err=err, bitwise=same, bound_ms=b, bound_by=by,
               vec=wu.scatter_vec(snaps0, W))
    row.update(_timings(lambda: wu.block_scatter_rows(buf, w, W, slots),
                        lambda: ref.block_scatter_rows_ref(buf, w, W, slots),
                        lambda: (buf.view(B * R, P).index_copy_(0, flat_rows,
                                                                W.view(B * E, P).to(dtype)),
                                 W[:, -1].to(w.dtype))))
    print(f"     {tag}: {json.dumps(row)}")
    del snaps0, buf, w, W
    torch.cuda.empty_cache()
    return row


def _prefix_cell(dev, shape: tuple, timed: str) -> dict:
    """K2 on one cell (ring rows R = C+1, P, E, padded lanes on the trash row,
    ring dtype, w dtype), drawn on the card: every ring row and w' bitwise
    equal to the plain version (which stores every lane in event order, the
    kernel only the live lanes) and to a second launch, then timed beside
    the plain version (``timed``: "full", or "kernel" with a few calls of
    the plain version)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import weighted_update as wu

    R, P, E, pad, dtype, w_dtype = shape
    real = np.random.default_rng(P + E).choice(R - 1, size=E - pad, replace=False)
    slots_np = np.concatenate([real, np.full(pad, R - 1)]).astype(np.int64)
    slots = torch.as_tensor(slots_np, device=dev)
    g = torch.Generator(device=dev).manual_seed(P + E)
    snaps0 = torch.randn((R, P), generator=g, device=dev).to(dtype)
    w = torch.randn((P,), generator=g, device=dev).to(w_dtype)
    D = 0.01 * torch.randn((E, P), generator=g, device=dev)
    D[E - pad:] = 0.0
    ks, kw_ = wu.block_prefix_update(snaps0.clone(), w, D, slots)
    rs, rw_ = ref.block_prefix_update_ref(snaps0.clone(), w, D, slots)
    torch.cuda.synchronize()
    same = torch.equal(ks, rs) and torch.equal(kw_, rw_)
    err = max(max_err(ks, rs), max_err(kw_, rw_))  # full ring, trash row included
    del rs, rw_
    again, again_w = wu.block_prefix_update(snaps0.clone(), w, D, slots)
    torch.cuda.synchronize()
    twice = torch.equal(ks, again) and torch.equal(kw_, again_w)
    del ks, kw_, again, again_w
    vec = wu.prefix_vec(snaps0, w, D)
    tag = (f"block_prefix_update {str(dtype)[6:]} ring (w {str(w_dtype)[6:]}) {(R, P)} E={E} "
           f"({pad} padded, live {wu.live_lanes(slots_np, R)}, {vec} values an access)")
    check(same and twice, f"{tag}: every ring row and w' bitwise equal to the plain version "
          f"{same} (max abs err {err:.3e}), two launches bitwise equal {twice}")
    distinct = len(set(slots_np.tolist()))
    esz, wsz = torch.finfo(dtype).bits // 8, torch.finfo(w_dtype).bits // 8
    # read w, D, slots; write the distinct ring rows and w'
    nbytes = wsz * P + 4 * E * P + 8 * E + distinct * P * esz + wsz * P
    b, by = bound_ms(nbytes, E * P)
    row = dict(shape=[R, P, E, pad, str(dtype)[6:], str(w_dtype)[6:]], max_abs_err=err,
               bitwise=same, vec=vec, bound_ms=b, bound_by=by)
    buf = snaps0
    kernel = lambda: wu.block_prefix_update(buf, w, D, slots)  # noqa: E731
    plain = lambda: ref.block_prefix_update_ref(buf, w, D, slots)  # noqa: E731
    if timed == "full":
        row.update(_timings(kernel, plain))
    else:
        row.update(ms=time_ms(kernel), device_ms=profile(kernel, calls=50)[0],
                   plain_ms=time_ms(plain, batches=3, per_batch=3, warmup=1),
                   plain_device_ms=profile(plain, calls=3)[0])
    print(f"     {tag}: {json.dumps(row)}")
    del snaps0, buf, w, D, kernel, plain
    torch.cuda.empty_cache()
    return row


def _phase_prefix_update(dev) -> dict:
    """K2 over `PREFIX_SHAPES` (`_prefix_cell`): every ring row bitwise, the
    present tolerance checks, then `prefix_kernel_info`."""
    from repro_torch.kernels import weighted_update as wu

    got = {shape: _prefix_cell(dev, shape, "full" if shape[1] < 10**8 else "kernel")
           for shape in PREFIX_SHAPES}
    for dtype in (torch.float32, torch.bfloat16):
        err = max(r["max_abs_err"] for sh, r in got.items() if sh[4] == dtype)
        check(err <= TOL[dtype],
              f"block_prefix_update {str(dtype)[6:]} max_abs_err {err:.3e} <= {TOL[dtype]}")
    info = {f"{str(dt)[6:]} ring, w {str(wd)[6:]}, {v} an access": wu.prefix_kernel_info(dt, v, E, wd)
            for dt, wd, v, E in ((torch.float32, torch.float32, 4, 8),
                                 (torch.float32, torch.float32, 1, 8),
                                 (torch.bfloat16, torch.float32, 8, 8),
                                 (torch.bfloat16, torch.float32, 1, 8),
                                 (torch.bfloat16, torch.bfloat16, 8, 4))}
    print(f"     block_prefix_update kernels (registers, static / dynamic shared memory, local "
          f"bytes, CTAs an SM): {json.dumps(info)}")
    check(all(i["local_bytes"] == 0 for i in info.values()),
          "block_prefix_update kernels spill nothing to local memory")
    first = dict(got[PREFIX_PATH_SHAPE], max_abs_err=max(r["max_abs_err"] for r in got.values()))
    first.update(path_shapes=[got[sh] for sh in PREFIX_SHAPES if sh[1] > 10**8], kernel_info=info)
    return {"block_prefix_update": first}


def _scatter_cost(slots: list[int], P: int, esz_ring: int, esz_w: int) -> int:
    """Bytes K6 must move for these slots: each distinct ring row is written
    once (the last lane that targets it wins, and the last lane always
    does), so it reads those rows of W once, the slots, and writes those
    ring rows and w'."""
    distinct = len(set(slots))
    return distinct * P * 4 + 8 * len(slots) + distinct * P * esz_ring + P * esz_w


def _phase_scatter_rows(dev) -> dict:
    """K6 against its plain version over `SCATTER_SHAPES`: every ring row and
    w' bitwise (the plain version stores the rows in event order, the kernel
    only the live lanes'), each cell launched twice (bitwise equal), timed
    beside the plain version and ``index_copy_`` plus the final-row copy
    (one PyTorch call each; with duplicate trash-row slots ``index_copy_``
    leaves the trash row undefined, which no reader sees), in full at the
    path shape and at Mamba2-130M's rings; then `scatter_kernel_info`."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import weighted_update as wu

    rows = {}
    worst = 0.0
    for shape in SCATTER_SHAPES:
        R, P, E, pad, dtype = shape
        real = np.random.default_rng(P + E).choice(R - 1, size=E - pad, replace=False)
        slots_np = np.concatenate([real, np.full(pad, R - 1)]).astype(np.int64)
        slots = torch.as_tensor(slots_np, device=dev)
        # drawn on the card: a CPU draw of Mamba2's 1.2 G ring values takes seconds
        g = torch.Generator(device=dev).manual_seed(P + E)
        snaps0 = torch.randn((R, P), generator=g, device=dev).to(dtype)
        w = torch.randn((P,), generator=g, device=dev)
        W = torch.randn((E, P), generator=g, device=dev)
        ks, kw_ = wu.block_scatter_rows(snaps0.clone(), w, W, slots)
        rs, rw_ = ref.block_scatter_rows_ref(snaps0.clone(), w, W, slots)
        torch.cuda.synchronize()
        same = torch.equal(ks, rs) and torch.equal(kw_, rw_)
        err = max(max_err(ks, rs), max_err(kw_, rw_))
        worst = max(worst, err)
        del rs, rw_
        again, again_w = wu.block_scatter_rows(snaps0.clone(), w, W, slots)
        torch.cuda.synchronize()
        twice = torch.equal(ks, again) and torch.equal(kw_, again_w)
        vec = wu.scatter_vec(snaps0, W)
        tag = (f"block_scatter_rows {str(dtype)[6:]} ring {(R, P)} E={E} ({pad} padded, "
               f"live {wu.live_lanes(slots_np, R)}, {vec} values an access)")
        check(same and twice and kw_.dtype == w.dtype,
              f"{tag}: every ring row and w' bitwise equal to the plain version {same} (max "
              f"abs err {err:.3e}), two launches bitwise equal {twice}")
        del ks, kw_, again, again_w
        buf = snaps0
        kernel = lambda: wu.block_scatter_rows(buf, w, W, slots)  # noqa: E731
        plain = lambda: ref.block_scatter_rows_ref(buf, w, W, slots)  # noqa: E731
        library = lambda: (buf.index_copy_(0, slots, W.to(buf.dtype)),  # noqa: E731
                           W[-1].to(w.dtype))
        nbytes = _scatter_cost(slots_np.tolist(), P, torch.finfo(dtype).bits // 8, 4)
        b, by = bound_ms(nbytes, 0.0)
        row = dict(shape=[R, P, E, pad, str(dtype)[6:]], max_abs_err=err, bitwise=same,
                   vec=vec, bound_ms=b, bound_by=by)
        if shape == SCATTER_PATH_SHAPE or P > 10**8:
            row.update(_timings(kernel, plain, library))
        else:
            quick = dict(batches=5, per_batch=10, warmup=3)
            row.update(ms=time_ms(kernel, **quick), plain_ms=time_ms(plain, **quick),
                       library_ms=time_ms(library, **quick))
        print(f"     {tag}: {json.dumps(row)}")
        rows[shape] = row
        del snaps0, buf, w, W, kernel, plain, library
        torch.cuda.empty_cache()
    info = {f"{str(dt)[6:]} ring, {v} an access": wu.scatter_kernel_info(dt, v)
            for dt, v in ((torch.float32, 4), (torch.float32, 1), (torch.bfloat16, 8),
                          (torch.bfloat16, 1))}
    print(f"     block_scatter_rows kernels at E=8 (registers, static / dynamic shared memory, "
          f"local bytes, CTAs an SM): {json.dumps(info)}")
    check(all(i["local_bytes"] == 0 for i in info.values()),
          "block_scatter_rows kernels spill nothing to local memory")
    first = dict(rows[SCATTER_PATH_SHAPE], max_abs_err=worst)
    first.update(path_shapes=[rows[sh] for sh in SCATTER_SHAPES if sh[1] > 10**8],
                 kernel_info=info)
    return {"block_scatter_rows": first}


def _mlp_flc(dev):
    """The MLP slice's configuration: the README's and `BENCH_engine.json`'s."""
    from repro_torch.configs.base import FLConfig

    return FLConfig(n_clients=256, concurrency=64, server_steps=2000, engine="scan",
                    device=dev.type)


def _mlp_setup(dev, data=None):
    """``(setup, ServerConfig)`` of the MLP slice's gen_async run, built as
    `run_experiment` builds it (eval every 500 events; on ``data``, a
    `FederatedClassification` whose cached setup a run already built)."""
    from repro_torch.core.async_sgd import ServerConfig

    flc = _mlp_flc(dev)
    setup, mu, p = _build_task(flc, dev, data)
    return setup, ServerConfig(n=flc.n_clients, C=flc.concurrency, T=flc.server_steps,
                               eta=0.05, mu=mu, p=p, seed=flc.seed, eval_every=500,
                               engine="scan", weighting="importance", device=dev.type)


def _build_task(flc, dev, data=None):
    """The task, clients, p and mu exactly as `run_experiment` builds them."""
    from repro_torch.data.pipeline import FederatedClassification, make_client_speeds
    from repro_torch.fl.engine import _cached_fl_setup, sampling_for

    data = data or FederatedClassification(n_clients=flc.n_clients, seed=flc.seed)
    mu = make_client_speeds(flc.n_clients, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
    setup = _cached_fl_setup(data, flc.seed, None, n_clients=flc.n_clients, device=dev)
    return setup, mu, sampling_for(flc, mu)


def _tree_gap(a: dict, b: dict) -> float:
    return max(max_err(a[k], b[k]) for k in a)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _TIMED[0] += wall
    return out, wall


_TIMED = [0.0]  # seconds spent inside `_timed` (the timed runs) so far


class _Part:
    """Splits an LM part's wall time into its timed runs (`_timed`) and the
    rest: model and task set-up, loss passes, checks and profiles."""

    def __init__(self, label: str):
        self.label, self.t0, self.timed0 = label, time.perf_counter(), _TIMED[0]

    def end(self) -> None:
        total, runs = time.perf_counter() - self.t0, _TIMED[0] - self.timed0
        print(f"{self.label} part: {total:.1f} s, of which timed runs {runs:.1f} s and set-up, "
              f"loss passes, checks and profiles {total - runs:.1f} s")


def _mamba_task(dev, remat: str = "none"):
    """The Mamba2-130M `LMTask` at full width and depth with K4
    (``use_pallas=True``): built once a remat policy and shared by phases
    10, 17, 18, 19 and 20, its setup (weights, client shards, eval batch)
    cached on it.  The pinned phases take remat "none" (the module docstring
    says why); phase 17's matrix takes "full", and its gradient call (i)
    "dots" too: tasks of their own, their weights made from the same seed."""
    from repro_torch.configs import get_config
    from repro_torch.fl.engine import LMTask, _cached_fl_setup

    key = "mamba_task" if remat == "none" else f"mamba_task_{remat}"
    if key not in _SHARED:
        task = LMTask(get_config(MAMBA_ARCH).replace(use_pallas=True, remat=remat),
                      batch_size=LM_BATCH, seq_len=LM_SEQ, shard_size=LM_SHARD)
        t0 = time.perf_counter()
        _cached_fl_setup(None, 0, task, n_clients=LM_N, device=dev)
        torch.cuda.synchronize()
        print(f"Mamba2-130M task set-up at remat {remat} (weights, client shards, eval batch; "
              f"shared by phases 10 and 17-20): {time.perf_counter() - t0:.3f} s")
        _SHARED[key] = task
    return _SHARED[key]


def _allclose_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The least tol with |a - b| <= tol + tol * |b| everywhere (allclose
    with atol = rtol = tol)."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def _fa_pairs(S: int, T: int, window: int, q_offset: int) -> int:
    """(query, key) pairs the attention needs: the unmasked keys of each
    row, or all T keys for a row whose every key is masked (it averages v
    over all of them)."""
    qpos = np.arange(S)[:, None] + q_offset
    kpos = np.arange(T)[None, :]
    keep = kpos <= qpos
    if window:
        keep &= qpos - kpos < window
    per_row = keep.sum(axis=1)
    return int(np.where(per_row == 0, T, per_row).sum())


def phase_flash_attention(dev) -> dict:
    """K3 against its plain version over `FA_SHAPES`, fp32 and bf16, each
    cell launched twice (bitwise equal), timed beside the plain version and
    `F.scaled_dot_product_attention` (causal, square, no window: the only
    shapes where one library call computes the same function), in full at
    `FA_PATH_SHAPES` in bf16; then its gradients through `FlashAttention`."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(0)
    path_rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FA_SHAPES:
            B, S, H, K, D, T, window, q_offset = shape
            q = torch.randn((B, S, H, D), generator=gen).to(dev, dtype)
            k = torch.randn((B, T, K, D), generator=gen).to(dev, dtype)
            v = torch.randn((B, T, K, D), generator=gen).to(dev, dtype)
            kw = dict(causal=True, window=window, q_offset=q_offset)
            out = fa.flash_attention_fwd(q, k, v, **kw)
            again = fa.flash_attention_fwd(q, k, v, **kw)
            exp = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err, close = max_err(out, exp), _allclose_err(out, exp)
            same = torch.equal(out, again)
            bq, bk = fa.kernel_tiles(q, k, v, out, window, q_offset)
            # (query, key) pairs the tile plan scores over those the function
            # needs, computed from `key_tiles` (the kernels do not count them)
            work = fa.visited_pairs(S, T, True, window, q_offset, bq, bk) / _fa_pairs(
                S, T, window, q_offset)
            tag = (f"flash_attention {str(dtype)[6:]} {shape} tile {bq}x{bk} "
                   f"(scored / needed pairs by key_tiles {work:.3f})")
            check(close <= FA_TOL[dtype] and out.dtype == dtype and same,
                  f"{tag} allclose tol {close:.3e} <= {FA_TOL[dtype]} (max abs err {err:.3e}), "
                  f"two launches bitwise equal {same}")
            library = None
            if window == 0 and q_offset == 0 and S == T:
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            esz = torch.finfo(dtype).bits // 8
            nbytes = esz * (2 * B * S * H * D + 2 * B * T * K * D)  # read q, k, v; write o
            flops = 4 * D * B * H * _fa_pairs(S, T, window, q_offset)  # QK^T and PV
            b, by = bound_ms(nbytes, flops, BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
            row = dict(shape=list(shape), max_abs_err=err, allclose_tol=close, bound_ms=b,
                       bound_by=by)
            if shape in FA_PATH_SHAPES and dtype == torch.bfloat16:
                row.update(_timings(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                                    lambda: ref.flash_attention_ref(q, k, v, **kw), library))
                path_rows[shape] = row
            else:
                quick = dict(batches=5, per_batch=10, warmup=3)
                row.update(ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw), **quick),
                           plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), **quick),
                           library_ms=None if library is None else time_ms(library, **quick))
            print(f"     {tag}: {json.dumps(row)}")
            del q, k, v, out, again, exp, library
    torch.cuda.empty_cache()
    info = {f"{str(dt)[6:]} D={D}": fa.kernel_info(dt, D)
            for dt, D in [(torch.bfloat16, D) for D in fa.TC_HEAD_DIMS]
            + [(torch.bfloat16, 96), (torch.float32, 64), (torch.float32, 128)]}
    print(f"     flash_attention kernels (registers, static / dynamic shared memory, "
          f"local bytes): {json.dumps(info)}")
    check(all(i["local_bytes"] == 0 for i in info.values()),
          "flash_attention kernels spill nothing to local memory")

    # gradients: FlashAttention (kernel forward, reference VJP) vs the
    # reference, with tests/test_lm_engine.py's linear probe loss
    for dtype in (torch.float32, torch.bfloat16):
        B, S, H, K, D, T = 2, 128, 8, 2, 64, 128
        q, k, v = (torch.randn(sh, generator=gen).to(dev, dtype)
                   for sh in ((B, S, H, D), (B, T, K, D), (B, T, K, D)))
        probe = torch.randn((B, S, H, D), generator=gen).to(dev)

        def loss(fn):
            return lambda q, k, v: torch.sum(fn(q, k, v).float() * probe)

        gk = torch.func.grad(loss(ops.flash_attention), argnums=(0, 1, 2))(q, k, v)
        gr = torch.func.grad(loss(ref.flash_attention_ref), argnums=(0, 1, 2))(q, k, v)
        close = max(_allclose_err(a, b) for a, b in zip(gk, gr))
        check(close <= FA_TOL[dtype],
              f"flash_attention grads {str(dtype)[6:]} allclose tol {close:.3e} <= {FA_TOL[dtype]}")
    first = dict(path_rows[FA_PATH_SHAPES[0]])
    first.update(path_shapes=[path_rows[sh] for sh in FA_PATH_SHAPES], kernel_info=info)
    return {"flash_attention": first}


def _ssd_inputs(dev, dtype, B, S, H, P, N, a_range, dt_range, gen):
    """(x, dt, A (H,), Bm, Cm) on the card: x, B and C normal in ``dtype``,
    dt and -A uniform over their ranges in fp32."""
    x = torch.randn((B, S, H, P), generator=gen).to(dev, dtype)
    dt = (dt_range[0] + (dt_range[1] - dt_range[0]) * torch.rand((B, S, H), generator=gen)).to(dev)
    A = -(a_range[0] + (a_range[1] - a_range[0]) * torch.rand((H,), generator=gen)).to(dev)
    Bm = torch.randn((B, S, N), generator=gen).to(dev, dtype)
    Cm = torch.randn((B, S, N), generator=gen).to(dev, dtype)
    return x, dt, A, Bm, Cm


def _ssd_cost(B: int, S: int, H: int, P: int, N: int, Q: int, esz: int) -> tuple[int, int]:
    """(bytes, operations) of one chunked SSD call: x, B, C, dt and A read
    once, y and the fp32 state written once; per chunk C B^T once per batch
    row (lower triangle), and per (row, head) the masked (Q,Q)(Q,P) product,
    C state and B^T x."""
    nc, tri = S // Q, Q * (Q + 1) // 2
    nbytes = esz * (2 * B * S * H * P + 2 * B * S * N) + 4 * (B * S * H + B * H + B * H * N * P)
    flops = 2 * B * nc * tri * N + 2 * B * H * nc * (tri * P + 2 * Q * N * P)
    return nbytes, flops


def phase_ssd_scan(dev) -> dict:
    """K4 against its plain version over `SSD_SHAPES`, fp32 and bf16, each
    bf16 cell launched twice (bitwise equal), the library's route printed for
    every cell and required to be "tc" at `SSD_TC_SHAPES` in bf16, timed
    beside the plain version (no single PyTorch call computes the chunked
    SSD) in full at `SSD_TIMED_SHAPES` in bf16; `kernel_info` of both
    kernels; then its gradients through `SSDScan`, and one launch under
    ``vmap`` with a batched A, equal to a loop."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as k4

    gen = torch.Generator().manual_seed(1)
    path_rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SSD_SHAPES:
            B, S, H, P, N, chunk, a_range, dt_range = shape
            x, dt, A, Bm, Cm = _ssd_inputs(dev, dtype, *shape[:5], a_range, dt_range, gen)
            A_rows = A.expand(B, H).contiguous()
            y, st = k4.ssd_scan_fwd(x, dt, A_rows, Bm, Cm, chunk)
            ey, est = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
            torch.cuda.synchronize()
            err, close = max_err(y, ey), _allclose_err(y, ey)
            smax = max(1.0, float(est.abs().max()))
            serr = max_err(st, est)
            finite = bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(st).all())
            route = k4.kernel_route(x, Bm, Cm, chunk)
            twice = True  # bf16 cells: a second launch gives the same bits (no atomics)
            if dtype == torch.bfloat16:
                y2, st2 = k4.ssd_scan_fwd(x, dt, A_rows, Bm, Cm, chunk)
                torch.cuda.synchronize()
                twice = torch.equal(y, y2) and torch.equal(st, st2)
                del y2, st2
            tag = (f"ssd_scan {str(dtype)[6:]} {shape[:6]} A in -{list(a_range)} dt in "
                   f"{list(dt_range)} route {route}")
            check(finite and close <= FA_TOL[dtype] and y.dtype == dtype
                  and serr <= SSD_STATE_TOL[dtype] * smax and twice,
                  f"{tag}: finite {finite}, y allclose tol {close:.3e} <= {FA_TOL[dtype]} (max abs "
                  f"err {err:.3e}), state err {serr:.3e} <= {SSD_STATE_TOL[dtype]} x {smax:.3g}, "
                  f"two launches bitwise equal {twice}")
            if dtype == torch.bfloat16 and shape in SSD_TC_SHAPES:
                check(route == "tc", f"{tag}: a path shape takes the tensor-core kernel")
            Q = min(chunk, S)
            nbytes, flops = _ssd_cost(B, S, H, P, N, Q, torch.finfo(dtype).bits // 8)
            b, by = bound_ms(nbytes, flops, BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
            kernel = lambda: k4.ssd_scan_fwd(x, dt, A_rows, Bm, Cm, chunk)  # noqa: E731
            plain = lambda: ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)  # noqa: E731
            row = dict(shape=list(shape[:6]), kernel=route, max_abs_err=err, allclose_tol=close,
                       state_err=serr, bound_ms=b, bound_by=by)
            if shape in SSD_TIMED_SHAPES and dtype == torch.bfloat16:
                row.update(_timings(kernel, plain))
                path_rows[shape] = row
            else:
                quick = dict(batches=5, per_batch=10, warmup=3)
                row.update(ms=time_ms(kernel, **quick), plain_ms=time_ms(plain, **quick),
                           library_ms=None)
                if shape in SSD_MATRIX_SHAPES and dtype == torch.bfloat16:
                    row["device_ms"] = profile(kernel, calls=10)[0]
                    path_rows[shape] = row
            print(f"     {tag}: {json.dumps(row)}")
            del x, dt, A, A_rows, Bm, Cm, y, st, ey, est
    torch.cuda.empty_cache()
    info = {}
    for dt, N in ((torch.bfloat16, 128), (torch.bfloat16, 64), (torch.float32, 128)):
        i = k4.kernel_info(dt, 64, N, 64)
        info[f"{str(dt)[6:]} {i.pop('kernel')} N={N}"] = i
    print(f"     ssd_scan kernels at (Q, P) = (64, 64) (registers, static / dynamic shared memory, "
          f"local bytes, CTAs an SM): {json.dumps(info)}")
    check(all(i["local_bytes"] == 0 for i in info.values()),
          "ssd_scan kernels spill nothing to local memory")
    tc_ctas = info.get("bfloat16 tc N=128", {}).get("ctas_per_sm", 0)
    check(tc_ctas >= 2, f"ssd_scan tensor-core kernel at Mamba2-130M's (Q, N, P): {tc_ctas} CTAs "
          "an SM >= 2 (the path shape's 192 CTAs in one wave)")

    # gradients of all five inputs: SSDScan (kernel forward, reference VJP)
    # vs the reference, linear probe loss on both outputs
    for dtype in (torch.float32, torch.bfloat16):
        args = _ssd_inputs(dev, dtype, 2, 128, 4, 32, 16, (0.5, 2.0), (0.01, 0.2), gen)
        py = torch.randn((2, 128, 4, 32), generator=gen).to(dev)
        ps = torch.randn((2, 4, 16, 32), generator=gen).to(dev)

        def loss(fn):
            def f(*a):
                y, s = fn(*a, chunk=32)
                return torch.sum(y.float() * py) + torch.sum(s * ps)
            return f

        gk = torch.func.grad(loss(ops.ssd_scan), argnums=(0, 1, 2, 3, 4))(*args)
        gr = torch.func.grad(loss(ref.ssd_scan_ref), argnums=(0, 1, 2, 3, 4))(*args)
        close = max(_allclose_err(a, b) for a, b in zip(gk, gr))
        check(close <= FA_TOL[dtype],
              f"ssd_scan grads {str(dtype)[6:]} allclose tol {close:.3e} <= {FA_TOL[dtype]}")

    # vmap with a batched A (one per lane, as the blocked engine's snapshots
    # give): one launch over the folded lanes, equal to a loop
    x, dt, A, Bm, Cm = _ssd_inputs(dev, torch.float32, 2, 128, 24, 64, 128, (1.0, 16.0),
                                   (0.001, 0.1), gen)
    xs, Bs, Cs = (torch.stack([t, 0.5 * t, 2.0 * t, -t]) for t in (x, Bm, Cm))
    dts = torch.stack([dt, 0.5 * dt, 2.0 * dt, dt.flip(0)])
    As = torch.stack([A, 2.0 * A, 0.25 * A, A.flip(0)])
    k4.reset_launches()
    y, st = torch.func.vmap(lambda *a: ops.ssd_scan(*a, chunk=64))(xs, dts, As, Bs, Cs)
    n = k4.launches["ssd_scan"]
    close = max(_allclose_err(y[i], ref.ssd_scan_ref(xs[i], dts[i], As[i], Bs[i], Cs[i], 64)[0])
                for i in range(4))
    check(n == 1 and close <= FA_TOL[torch.float32],
          f"ssd_scan under vmap with a batched A: {n} launch(es) == 1, equal to a loop "
          f"(allclose tol {close:.3e} <= {FA_TOL[torch.float32]})")
    first = dict(path_rows[SSD_PATH_SHAPE])
    first.update(path_shapes=[path_rows[sh] for sh in SSD_TIMED_SHAPES[:2]],
                 serve_shape=path_rows[SSD_SERVE_SHAPE],
                 zamba2_shape=path_rows[SSD_ZAMBA_SHAPE],
                 matrix_shapes=[path_rows[sh] for sh in SSD_MATRIX_SHAPES], kernel_info=info)
    return {"ssd_scan": first}


def _gmm_inputs(dev, dtype, E, C, D, F, gen):
    """x unit normal, w normal with std 1/sqrt(D) (the experts' fan-in
    init), so y is O(1) as on the path."""
    x = torch.randn((E, C, D), generator=gen).to(dev, dtype)
    w = (torch.randn((E, D, F), generator=gen) / np.sqrt(D)).to(dev, dtype)
    return x, w


def phase_moe_gmm(dev) -> dict:
    """11. K5 against its plain version over `GMM_SHAPES` (and Arctic's shape
    in bf16), each cell launched twice (bitwise equal), timed in full at
    `GMM_PATH_SHAPES` in bf16 beside the plain version and `torch.bmm`
    (bf16 in, fp32 accumulation, bf16 out: the same function in one call);
    its gradients through `MoeGMM`; one launch under ``vmap``; the CPU and
    dtype dispatch."""
    from repro_torch.kernels import moe_gmm as k5
    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(2)
    path_rows = {}
    cells = [(d, s) for d in (torch.float32, torch.bfloat16) for s in GMM_SHAPES]
    for dtype, shape in cells + [(torch.bfloat16, GMM_ARCTIC)]:
        E, C, D, F = shape
        x, w = _gmm_inputs(dev, dtype, *shape, gen)
        y = k5.moe_gmm_fwd(x, w)
        again = k5.moe_gmm_fwd(x, w)
        e = ref.moe_gmm_ref(x, w)
        torch.cuda.synchronize()
        err, close = max_err(y, e), _allclose_err(y, e)
        finite = bool(torch.isfinite(y.float()).all())
        same = torch.equal(y, again)
        tag = f"moe_gmm {str(dtype)[6:]} {shape} {k5.kernel_path(x, w)}"
        check(finite and close <= FA_TOL[dtype] and y.dtype == dtype and same,
              f"{tag}: finite {finite}, allclose tol {close:.3e} <= {FA_TOL[dtype]} "
              f"(max abs err {err:.3e}), two launches bitwise equal {same}")
        esz = torch.finfo(dtype).bits // 8
        nbytes = esz * (E * C * D + E * D * F + E * C * F)  # read x, w; write y
        b, by = bound_ms(nbytes, 2 * E * C * D * F,
                         BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
        kernel = lambda: k5.moe_gmm_fwd(x, w)  # noqa: E731
        plain = lambda: ref.moe_gmm_ref(x, w)  # noqa: E731
        library = lambda: torch.bmm(x, w)  # noqa: E731
        row = dict(shape=list(shape), max_abs_err=err, allclose_tol=close, bound_ms=b,
                   bound_by=by)
        if shape in GMM_PATH_SHAPES + GMM_DECODE_SHAPES and dtype == torch.bfloat16:
            row.update(_timings(kernel, plain, library))
            path_rows[shape] = row
        else:
            quick = dict(batches=5, per_batch=10, warmup=3)
            row.update(ms=time_ms(kernel, **quick), plain_ms=time_ms(plain, **quick),
                       library_ms=time_ms(library, **quick))
        print(f"     {tag}: {json.dumps(row)}")
        del x, w, y, again, e, kernel, plain, library
    torch.cuda.empty_cache()
    info = {"bf16 tc": k5.kernel_info(torch.bfloat16, True),
            "bf16 scalar": k5.kernel_info(torch.bfloat16, False),
            "f32": k5.kernel_info(torch.float32, True)}
    print(f"     moe_gmm kernels (registers, static / dynamic shared memory, local bytes): "
          f"{json.dumps(info)}")
    check(all(i["local_bytes"] == 0 for i in info.values()),
          "moe_gmm kernels spill nothing to local memory")

    # gradients of x and w: MoeGMM (kernel forward, reference VJP) vs the
    # reference, linear probe loss
    for dtype in (torch.float32, torch.bfloat16):
        x, w = _gmm_inputs(dev, dtype, *GMM_GRAD_SHAPE, gen)
        E, C, _, F = GMM_GRAD_SHAPE
        probe = torch.randn((E, C, F), generator=gen).to(dev)

        def loss(fn):
            return lambda x, w: torch.sum(fn(x, w).float() * probe)

        gk = torch.func.grad(loss(ops.moe_gmm), argnums=(0, 1))(x, w)
        gr = torch.func.grad(loss(ref.moe_gmm_ref), argnums=(0, 1))(x, w)
        close = max(_allclose_err(a, b) for a, b in zip(gk, gr))
        check(close <= FA_TOL[dtype] and all(a.dtype == dtype for a in gk),
              f"moe_gmm grads {str(dtype)[6:]} allclose tol {close:.3e} <= {FA_TOL[dtype]}")
        del x, w, gk, gr

    # vmap with x and w both mapped over 4 lanes (the blocked engine's case:
    # one set of expert weights per lane): one launch, equal to a loop
    x, w = _gmm_inputs(dev, torch.bfloat16, *GMM_GRAD_SHAPE, gen)
    xs = torch.stack([x, 0.5 * x, -x, x.flip(1)])
    ws = torch.stack([w, 2.0 * w, w.flip(0), -w])
    k5.reset_launches()
    y = torch.func.vmap(ops.moe_gmm)(xs, ws)
    n = k5.launches["moe_gmm"]
    close = max(_allclose_err(y[i], ref.moe_gmm_ref(xs[i], ws[i])) for i in range(4))
    check(n == 1 and close <= FA_TOL[torch.bfloat16],
          f"moe_gmm under vmap over 4 lanes: {n} launch(es) == 1, equal to a loop "
          f"(allclose tol {close:.3e} <= {FA_TOL[torch.bfloat16]})")
    del x, w, xs, ws, y
    # a CPU tensor takes the plain version (no launch); a dtype mismatch raises
    xc, wc = _gmm_inputs(torch.device("cpu"), torch.float32, 2, 8, 16, 4, gen)
    k5.reset_launches()
    same = torch.equal(ops.moe_gmm(xc, wc), ref.moe_gmm_ref(xc, wc))
    try:
        k5.moe_gmm_fwd(xc.to(dev), wc.to(dev, torch.bfloat16))
        raised = False
    except TypeError:
        raised = True
    check(same and k5.launches["moe_gmm"] == 0 and raised,
          f"moe_gmm dispatch: CPU tensor -> plain version {same}, no launch "
          f"({k5.launches['moe_gmm']}), dtype mismatch raises {raised}")
    torch.cuda.empty_cache()
    first = dict(path_rows[GMM_PATH_SHAPES[0]])
    first.update(path_shapes=[path_rows[sh] for sh in GMM_PATH_SHAPES],
                 decode_shapes=[path_rows[sh] for sh in GMM_DECODE_SHAPES], kernel_info=info)
    return {"moe_gmm": first}


def _k1_counts(path: dict, label: str, T: int, leaves: int) -> None:
    """A per-event ``update="pallas"`` run of T events just ended: K1 made one
    launch an event and covered every leaf of each; adds both counts to
    ``path``."""
    from repro_torch.kernels import weighted_update as wu

    got, covered = wu.launches["weighted_update"], wu.launches["weighted_update_leaves"]
    path["weighted_update"] = path.get("weighted_update", 0) + got
    path["weighted_update_leaves"] = path.get("weighted_update_leaves", 0) + covered
    check(got == T and covered == T * leaves,
          f"{label} K1 launches {got} == T = {T}, leaves covered {covered} == {T} x {leaves}")


def phase_mlp(dev, launches: dict) -> dict:
    """Phases 3-6 (the MLP slice) and its profile; adds the kernel paths'
    launch counts to ``launches`` under "mlp".  Returns what the lane-sharded
    phase holds its runs against: the blocked K2 run's eval curve, events/s
    and block rows, and its weights at T=200."""
    from repro_torch.core.async_sgd import run_generalized_async_sgd
    from repro_torch.core.engine_scan import blocked_inputs, step_scales
    from repro_torch.core.queue_sim import EventBlocks, SimConfig, export_stream
    from repro_torch.fl.engine import run_experiment
    from repro_torch.kernels import weighted_update as wu

    # 3. the paper's experiment, plain (jnp-equivalent) update path
    flc = _mlp_flc(dev)
    r, wall = _timed(lambda: run_experiment(flc, "gen_async", eval_every=500))
    acc = np.asarray(r.eval_acc, np.float64)
    print(f"run_experiment n=256 C=64 T=2000: {wall:.3f} s, {flc.server_steps / wall:.1f} events/s, "
          f"eval steps {r.eval_steps.tolist()} acc {acc.tolist()}")
    check(acc.shape == (4,) and bool(np.all(np.isfinite(acc))), "eval accuracies finite, 4 points")
    check(bool(acc[-1] > acc[0]), f"accuracy rises: {acc[0]:.4f} -> {acc[-1]:.4f}")
    check(all(bool(torch.isfinite(v).all()) for v in r.final_params.values()), "final params finite")

    # 4./5. the kernel path, built as run_experiment builds it
    (setup, base), wall = _timed(lambda: _mlp_setup(dev))
    mu, p = base.mu, base.p
    print(f"task setup (data shards, sampling p, MLP, clients): {wall:.3f} s")
    run = lambda cfg: run_generalized_async_sgd(setup.params, setup.clients, cfg,  # noqa: E731
                                                eval_fn=setup.eval_fn)
    mlp = launches.setdefault("mlp", {})

    wu.reset_launches()
    (w_pe, tr_pe), wall = _timed(lambda: run(replace(base, update="pallas", block_size=1)))
    _k1_counts(mlp, "MLP", flc.server_steps, 6)
    print(f"per-event pallas: {wall:.3f} s ({flc.server_steps / wall:.1f} events/s), "
          f"launches {dict(wu.launches)}, acc {tr_pe.eval_values}")
    (w_pe_j, _), wall = _timed(lambda: run(replace(base, update="jnp", block_size=1)))
    print(f"per-event jnp: {wall:.3f} s ({flc.server_steps / wall:.1f} events/s)")
    gap = _tree_gap(w_pe, w_pe_j)
    check(gap <= 1e-5, f"per-event pallas vs jnp max gap {gap:.3e} <= 1e-5")

    E = MLP_E
    stream = export_stream(SimConfig(mu=mu, p=p, C=base.C, T=base.T, seed=base.seed))
    blocks = EventBlocks.from_stream(stream, E, cut_every=base.eval_every)
    # one launch per row of the blocked layout: the conflict-free blocks plus
    # the all-masked rows that pad each eval interval to a common width
    n_blocks = blocked_inputs(blocks, step_scales(stream, base.eta, p, "importance"),
                              base.eval_every)[0].shape[0]
    print(f"blocked layout E={E}: {blocks.B} conflict-free blocks, {n_blocks} rows")
    wu.reset_launches()
    (w_bl, tr_bl), wall = _timed(lambda: run(replace(base, update="pallas", block_size=E)))
    blocked = dict(acc=tr_bl.eval_values, events_per_s=flc.server_steps / wall, rows=n_blocks)
    mlp["block_prefix_update"] = wu.launches["block_prefix_update"]
    print(f"blocked E={E} pallas: {wall:.3f} s ({flc.server_steps / wall:.1f} events/s), "
          f"launches {dict(wu.launches)}, acc {tr_bl.eval_values}")
    check(wu.launches["block_prefix_update"] == n_blocks,
          f"K2 launches {wu.launches['block_prefix_update']} == block count {n_blocks}")
    (w_bl_j, _), wall = _timed(lambda: run(replace(base, update="jnp", block_size=E)))
    print(f"blocked E={E} jnp: {wall:.3f} s ({flc.server_steps / wall:.1f} events/s)")
    gap = _tree_gap(w_bl, w_bl_j)
    check(gap <= 1e-5, f"blocked pallas vs jnp max gap {gap:.3e} <= 1e-5")
    # blocked and per-event replay re-associate the fp32 update sums; after a
    # few hundred events a ReLU kink turns that rounding into a ~1e-3 weight
    # gap, in the JAX package as in the port, so the weights are held to
    # 1e-4 over the first 200 events and the T=2000 curves to 10 of 2048
    # eval samples
    dacc = float(np.max(np.abs(np.subtract(tr_bl.eval_values, tr_pe.eval_values))))
    check(dacc <= 10 / 2048, f"blocked vs per-event eval accuracy gap {dacc:.5f} <= 10/2048")
    small = replace(base, T=200, eval_every=0)
    (w_pe_s, _), (w_bl_s, _) = run(small), run(replace(small, update="pallas", block_size=E))
    gap = _tree_gap(w_bl_s, w_pe_s)
    check(gap <= 1e-4, f"blocked vs per-event (T=200) max gap {gap:.3e} <= 1e-4")
    blocked["w_200"] = w_bl_s

    # 6. replay engine vs the port's per-event Python oracle, full width
    w_py, _ = run_generalized_async_sgd(setup.params, setup.clients,
                                        replace(small, engine="python"))
    gap = _tree_gap(w_pe_s, w_py)
    check(gap <= 1e-5, f"scan vs python oracle (T=200) max gap {gap:.3e} <= 1e-5")

    # where the time goes on the kernel path (under the profiler)
    for label, cfg, T in (("per-event", replace(small, update="pallas"), 200),
                          ("blocked E=8", replace(small, update="pallas", block_size=E, T=400), 400)):
        _print_profile(f"MLP {label} T={T}", lambda: run(cfg), T)
    return blocked


def _np_tree(w: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in w.items()}


def _np_gap(a: dict, b: dict) -> float:
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)


def _acc_gap(a: list, b: list) -> float:
    return float(np.max(np.abs(np.subtract(a, b)))) if len(a) == len(b) else float("inf")


def _lanes_rank(rank: int, world: int, device: str) -> dict:
    """One rank of the lane-sharded MLP slice (15.): the ranks share the card
    over a gloo group.  gen_async blocked E=8 with K6 (T=200 without eval,
    which also warms the rank up, then T=2000) and with the plain scatter,
    FedBuff blocked E=8 with K2 after the gather (T=200 and T=2000), and a
    profile of 400 events of the K6 path; each run's launch counts are
    zeroed just before it and read just after."""
    from repro_torch.core.async_sgd import run_fedbuff, run_generalized_async_sgd
    from repro_torch.kernels import weighted_update as wu

    from repro_torch.data.pipeline import FederatedClassification

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flc = _mlp_flc(torch.device(device))
    data = FederatedClassification(n_clients=flc.n_clients, seed=flc.seed)
    setup, base = _mlp_setup(torch.device(device), data)
    base = replace(base, block_size=MLP_E, devices=world)
    gen = lambda c: run_generalized_async_sgd(setup.params, setup.clients, c,  # noqa: E731
                                              eval_fn=setup.eval_fn)
    fb = lambda c: run_fedbuff(setup.params, setup.clients, c, Z=FEDBUFF_Z,  # noqa: E731
                               eval_fn=setup.eval_fn)
    small = dict(T=200, eval_every=0)
    out = {}
    for name, fn, cfg in (("gen_async_200", gen, dict(update="pallas", **small)),
                          ("gen_async", gen, dict(update="pallas")),
                          ("gen_async_jnp", gen, dict(update="jnp")),
                          ("fedbuff_200", fb, dict(update="pallas", **small)),
                          ("fedbuff", fb, dict(update="pallas"))):
        wu.reset_launches()
        (w, tr), wall = _timed(lambda: fn(replace(base, **cfg)))
        out[name] = dict(w=_np_tree(w), acc=tr.eval_values, wall=wall, launches=dict(wu.launches))
    out["profile"] = profile(lambda: gen(replace(base, update="pallas", T=400, eval_every=0)))
    out.update(_lanes_later(rank, world, data, setup, base))
    return out


def _lanes_later(rank: int, world: int, data, setup, base) -> dict:
    """Phase 15's runs of the later lanes (T = `LANE_T`, eval every
    `LANE_EVAL`), each sharded over the ``world`` ranks with its launch
    counts zeroed just before it and read just after: (a) the fused device
    stream blocked E=8 (`run_generalized_async_sgd(ServerConfig(stream=
    "device", devices=2))`, the plain update: the fused runner's blocks take
    no kernel); (b) the host stream blocked E=8 with K6 under phase 18's
    guard and a spiking / NaN gradient; (c) ``run_matrix(devices=2,
    kernel="pallas")`` over `LANE_GRID`'s 4 cells (K6 across the cells),
    and `jit_runner` on its stacked inputs for the cells' final weights.
    The unsharded runs they are held to are shared out over the ranks
    (rank 0: (a) and (c), rank 1: (b)), each after the sharded ones.  The
    matrix reuses ``data``'s cached task setup (``setup``'s)."""
    from repro_torch.core.async_sgd import run_generalized_async_sgd
    from repro_torch.core.engine_scan import jit_runner
    from repro_torch.fl.engine import run_matrix
    from repro_torch.kernels import weighted_update as wu

    dev = setup.params["w1"].device
    flc = replace(_mlp_flc(dev), server_steps=LANE_T)
    short = replace(base, T=LANE_T, eval_every=LANE_EVAL)
    fused = replace(short, stream="device", update="jnp")
    guarded = replace(_mlp_robust_cfg(short, base.C), faults=None, update="pallas")
    spiky = _Spiky(setup.clients, LANE_NAN_STEP)

    def gen(cfg, source=setup.clients):
        return run_generalized_async_sgd(setup.params, source, cfg, eval_fn=setup.eval_fn)

    def matrix(devices):
        return run_matrix(flc, eval_every=LANE_EVAL, block_size=MLP_E, devices=devices,
                          kernel="pallas", data=data, **LANE_GRID)

    def weights(devices):
        blocked, layout = _matrix_inputs(flc, LANE_GRID, 0.05, LANE_EVAL, MLP_E, dev)[1:]
        run = jit_runner(setup.clients.device_grad, flc.concurrency, eval_fn=setup.eval_fn,
                         block_size=MLP_E, vmap_streams=True, kernel="pallas",
                         lane_devices=devices)
        return _np_tree(run(setup.params, *blocked, **layout)[0])

    out = {}

    def record(name, fn):
        wu.reset_launches()
        res, wall = _timed(fn)
        out[name] = dict(res=res, wall=wall, launches=dict(wu.launches))

    record("fused", lambda: gen(fused))
    record("guard", lambda: gen(guarded, spiky))
    record("matrix", lambda: matrix(world))
    record("matrix_w", lambda: weights(world))
    if rank == 0:
        record("fused_unsharded", lambda: gen(replace(fused, devices=1)))
        record("matrix_unsharded", lambda: matrix(1))
        record("matrix_w_unsharded", lambda: weights(1))
    else:
        record("guard_unsharded", lambda: gen(replace(guarded, devices=1), spiky))
    for o in out.values():  # to the parent as numpy
        r = o.pop("res")
        if isinstance(r, tuple):  # (weights, trace)
            w, tr = r
            o.update(w=_np_tree(w), acc=tr.eval_values, times=np.asarray(tr.times),
                     extras={k: np.asarray(v) for k, v in tr.extras.items()})
        elif isinstance(r, dict):
            o["w"] = r
        else:  # a MatrixResult
            o.update(acc=r.eval_acc, final_acc=r.final_acc, times=r.eval_times)
    return out


def _shard_matrix(dev, devices: int, data=None):
    """The device-stream matrix of phase 15's 2-D layout: `LANE_GRID`'s 4
    cells, blocked E=8, T = `SHARD_T`."""
    from repro_torch.fl.engine import run_matrix

    flc = replace(_mlp_flc(dev), server_steps=SHARD_T)
    return run_matrix(flc, eval_every=SHARD_EVAL, stream="device", block_size=MLP_E,
                      devices=devices, data=data, **LANE_GRID)


def _shards_rank(rank: int, world: int, device: str) -> dict:
    """One rank of phase 15's 2-D layout: ``run_matrix(stream="device",
    devices=2)`` in a group of `SHARD_RANKS` (shard 2 x lane 2: each rank
    runs 2 cells and shards their blocks' lanes over 2 ranks)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m, wall = _timed(lambda: _shard_matrix(torch.device(device), 2))
    return dict(acc=m.eval_acc, final_acc=m.final_acc, times=m.eval_times, wall=wall,
                extras={k: v for k, v in m.extras.items() if k != "stream"})


def phase_lanes(dev, launches: dict, blocked: dict) -> None:
    """14.-16.: FedBuff on the MLP, the lane-sharded MLP slice on 2 ranks,
    the FL launcher's defaults, FedAvg and FAVANO; adds the kernel paths'
    launch counts to ``launches`` ("fedbuff", "lanes_rank0", "lanes_rank1").
    ``blocked`` is phase 5's unsharded K2 run (`phase_mlp`)."""
    import io

    from repro_torch.core.async_sgd import run_fedbuff
    from repro_torch.core.engine_scan import blocked_inputs, step_scales
    from repro_torch.core.queue_sim import EventBlocks, SimConfig, export_stream
    from repro_torch.data.pipeline import FederatedClassification
    from repro_torch.fl.engine import run_experiment
    from repro_torch.kernels import weighted_update as wu
    from repro_torch.launch import train
    from repro_torch.launch.lanes import run_lanes

    flc = replace(_mlp_flc(dev), fedbuff_Z=FEDBUFF_Z)
    data = FederatedClassification(n_clients=flc.n_clients, seed=flc.seed)
    setup, base = _mlp_setup(dev, data)
    T = base.T
    fb = lambda cfg: run_fedbuff(setup.params, setup.clients, cfg, Z=FEDBUFF_Z,  # noqa: E731
                                 eval_fn=setup.eval_fn)
    uniform = np.full(base.n, 1.0 / base.n)  # FedBuff samples uniformly
    stream = export_stream(SimConfig(mu=base.mu, p=uniform, C=base.C, T=T, seed=base.seed))
    fb_rows = blocked_inputs(EventBlocks.from_stream(stream, MLP_E, cut_every=base.eval_every),
                             step_scales(stream, base.eta, uniform, "plain"),
                             base.eval_every)[0].shape[0]

    # 14. FedBuff (Z=10): the entry point, per event with K1 (one launch an
    # event), blocked E=8 with K2, and the port's Python loop at T=200
    r, wall = _timed(lambda: run_experiment(flc, "fedbuff", eval_every=500))
    print(f"run_experiment fedbuff Z={FEDBUFF_Z} n=256 C=64 T=2000: {wall:.3f} s, "
          f"{T / wall:.1f} events/s, acc {r.eval_acc.tolist()}")
    check(len(r.eval_acc) == 4 and bool(np.all(np.isfinite(r.eval_acc))),
          "fedbuff eval accuracies finite, 4 points")
    path = launches.setdefault("fedbuff", {})
    wu.reset_launches()
    (w_pe, tr_pe), wall = _timed(lambda: fb(replace(base, update="pallas")))
    _k1_counts(path, "fedbuff", T, 6)
    fb_pe_rate = T / wall
    print(f"fedbuff per-event pallas: {wall:.3f} s ({fb_pe_rate:.1f} events/s), launches "
          f"{dict(wu.launches)}, acc {tr_pe.eval_values}")
    gap = _tree_gap(w_pe, r.final_params)
    check(gap <= 1e-5, f"fedbuff per-event K1 vs run_experiment (flat update) max gap {gap:.3e} <= 1e-5")
    wu.reset_launches()
    (w_bl, tr_bl), wall = _timed(lambda: fb(replace(base, update="pallas", block_size=MLP_E)))
    path["block_prefix_update"] = wu.launches["block_prefix_update"]
    fb_bl_rate = T / wall
    print(f"fedbuff blocked E={MLP_E} pallas: {wall:.3f} s ({fb_bl_rate:.1f} events/s), launches "
          f"{dict(wu.launches)}, acc {tr_bl.eval_values}")
    check(wu.launches["block_prefix_update"] == fb_rows,
          f"fedbuff K2 launches {wu.launches['block_prefix_update']} == block rows {fb_rows}")
    dacc = _acc_gap(tr_bl.eval_values, tr_pe.eval_values)
    check(dacc <= 10 / 2048, f"fedbuff blocked vs per-event eval accuracy gap {dacc:.5f} <= 10/2048")
    small = replace(base, T=200, eval_every=0)
    w_py = _np_tree(fb(replace(small, engine="python"))[0])
    gap = _np_gap(_np_tree(fb(replace(small, update="pallas"))[0]), w_py)
    check(gap <= 1e-5, f"fedbuff per-event K1 vs the Python loop (T=200) max gap {gap:.3e} <= 1e-5")
    gap = _np_gap(_np_tree(fb(replace(small, update="pallas", block_size=MLP_E))[0]), w_py)
    check(gap <= 1e-4, f"fedbuff blocked K2 vs the Python loop (T=200) max gap {gap:.3e} <= 1e-4")
    del w_pe, w_bl, r

    # 15. the lane-sharded MLP slice: 2 gloo ranks, each on the one card
    res, wall = _timed(lambda: run_lanes(_lanes_rank, LANE_RANKS, (dev.type,), timeout=300.0))
    print(f"lane-sharded MLP, {LANE_RANKS} ranks: {wall:.3f} s including their start-up")
    later = [{k: out.pop(k) for k in list(out) if k.startswith(("fused", "guard", "matrix"))}
             for out in res]
    for rank, out in enumerate(res):
        dms, wms, top, ops = out.pop("profile")
        print(f"     rank {rank}: " + ", ".join(
            f"{name} {o['wall']:.3f} s launches {o['launches']}" for name, o in out.items()))
        idle = None if dms is None else 1.0 - dms / wms
        print(f"profile lane-sharded rank {rank}, gen_async K6 T=400: wall {wms / 400:.4f} ms/event, "
              f"device busy {None if dms is None else round(dms / 400, 6)} ms/event, idle share "
              f"{idle}, {ops / 400:.1f} device ops/event")
        for k, v in top:
            print(f"     {v / 400:.6f} ms/event  {k[:110]}")
        got = {"block_scatter_rows": out["gen_async"]["launches"]["block_scatter_rows"],
               "block_prefix_update": out["fedbuff"]["launches"]["block_prefix_update"]}
        launches[f"lanes_rank{rank}"] = got
        check(got["block_scatter_rows"] == blocked["rows"]
              and out["gen_async"]["launches"]["block_prefix_update"] == 0,
              f"rank {rank}: K6 launches {got['block_scatter_rows']} == block rows "
              f"{blocked['rows']} (no K2)")
        check(sum(out["gen_async_jnp"]["launches"].values()) == 0,
              f"rank {rank}: the plain scatter launches no kernel")
        check(got["block_prefix_update"] == fb_rows,
              f"rank {rank}: fedbuff K2 launches {got['block_prefix_update']} == block rows {fb_rows}")
    for name, o in res[0].items():
        same = _np_gap(o["w"], res[1][name]["w"]) == 0.0 and o["acc"] == res[1][name]["acc"]
        check(same, f"lane-sharded {name}: the {LANE_RANKS} ranks' weights and curves bitwise equal")
    o = res[0]
    print(f"lane-sharded gen_async K6 acc {o['gen_async']['acc']}; fedbuff K2 acc "
          f"{o['fedbuff']['acc']}")
    gap = _np_gap(o["gen_async"]["w"], o["gen_async_jnp"]["w"])
    check(gap <= 1e-5, f"lane-sharded K6 vs plain scatter max gap {gap:.3e} <= 1e-5")
    gap = _np_gap(o["gen_async_200"]["w"], _np_tree(blocked["w_200"]))
    check(gap <= 1e-4, f"lane-sharded vs unsharded K2 (T=200) max gap {gap:.3e} <= 1e-4")
    dacc = _acc_gap(o["gen_async"]["acc"], blocked["acc"])
    check(dacc <= 10 / 2048, f"lane-sharded vs unsharded eval accuracy gap {dacc:.5f} <= 10/2048")
    gap = _np_gap(o["fedbuff_200"]["w"], w_py)
    check(gap <= 1e-4, f"lane-sharded fedbuff vs the Python loop (T=200) max gap {gap:.3e} <= 1e-4")
    dacc = _acc_gap(o["fedbuff"]["acc"], tr_pe.eval_values)
    check(dacc <= 10 / 2048, f"lane-sharded fedbuff vs per-event eval accuracy gap {dacc:.5f} <= 10/2048")
    rate = lambda name: T / max(out[name]["wall"] for out in res)  # noqa: E731
    print(f"events/s, {LANE_RANKS} ranks sharing the card vs one process: gen_async K6 "
          f"{rate('gen_async'):.1f} vs K2 {blocked['events_per_s']:.1f}; gen_async plain scatter "
          f"{rate('gen_async_jnp'):.1f}; fedbuff K2 {rate('fedbuff'):.1f} vs blocked "
          f"{fb_bl_rate:.1f} (per event {fb_pe_rate:.1f})")
    _check_lanes_later(dev, later, launches, base)
    _check_shards(dev, data)

    # 16. the FL launcher's defaults on the card, and the synchronous baselines
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, wall = _timed(lambda: train.main(["--mode", "fl", "--steps", "200", "--eval-every", "100",
                                            "--device", dev.type]))
    lines = [line for line in buf.getvalue().splitlines() if "final_acc=" in line]
    print(buf.getvalue().rstrip())
    accs = [float(line.split("final_acc=")[1].split()[0]) for line in lines]
    check([line.split()[0] for line in lines] == ["gen_async", "async_sgd", "fedbuff"]
          and bool(np.all(np.isfinite(accs))),
          f"launch.train --mode fl runs its default methods on the card ({wall:.3f} s)")
    for method, rounds, every in (("fedavg", 20, 10), ("favano", 4, 2)):
        r, wall = _timed(lambda: run_experiment(replace(flc, server_steps=rounds), method,
                                                eval_every=every))
        print(f"run_experiment {method} n=256, {rounds} rounds: {wall:.3f} s, acc "
              f"{r.eval_acc.tolist()} at rounds {r.eval_steps.tolist()}")
        check(r.eval_steps.tolist() == list(range(every, rounds + 1, every))
              and bool(np.all(np.isfinite(r.eval_acc)))
              and all(bool(torch.isfinite(v).all()) for v in r.final_params.values()),
              f"{method}: finite weights and eval accuracies at every {every} rounds")


def _check_lanes_later(dev, later: list, launches: dict, base) -> None:
    """Phase 15's later lanes (`_lanes_later`) against their unsharded runs:
    the ranks bitwise equal; (a) the fused device stream's event clock and
    completion counts exact, its weights within 1e-4; (b) the guard's
    rejects (> 0) and stale drops exact, the weights within 1e-4, K6
    launches == the block rows; (c) the matrix's curves and final
    accuracies within 1e-4, eval times exact, the cells' final weights
    within 1e-4, K6 launches == the block rows of the 4 cells' layout, each
    launch scattering 4 cells.  Adds "lanes_guard_rank<r>" and
    "lanes_matrix_rank<r>" to ``launches``."""
    from repro_torch.core.engine_scan import blocked_inputs, step_scales
    from repro_torch.core.queue_sim import EventBlocks, SimConfig, export_stream

    flc = replace(_mlp_flc(dev), server_steps=LANE_T)
    stream = export_stream(SimConfig(mu=base.mu, p=base.p, C=base.C, T=LANE_T, seed=base.seed))
    guard_rows = blocked_inputs(EventBlocks.from_stream(stream, MLP_E, cut_every=LANE_EVAL),
                                step_scales(stream, base.eta, base.p, "importance"),
                                LANE_EVAL)[0].shape[0]
    blocked = _matrix_inputs(flc, LANE_GRID, 0.05, LANE_EVAL, MLP_E, dev)[1]
    cells, matrix_rows = int(blocked[0].shape[0]), int(blocked[0].shape[1])
    for name in ("fused", "guard", "matrix", "matrix_w"):
        a, b = later[0][name], later[1][name]
        same = all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) if k != "w"
                   else _np_gap(a["w"], b["w"]) == 0.0
                   for k in a if k not in ("wall", "launches", "extras"))
        same = same and all(np.array_equal(a["extras"][k], b["extras"][k])
                            for k in a.get("extras", {}))
        check(same, f"later lanes {name}: the {LANE_RANKS} ranks bitwise equal")
    one, two = later
    for rank, o in enumerate(later):
        launches[f"lanes_guard_rank{rank}"] = {
            "block_scatter_rows": o["guard"]["launches"]["block_scatter_rows"]}
        launches[f"lanes_matrix_rank{rank}"] = {
            "block_scatter_rows": o["matrix"]["launches"]["block_scatter_rows"], "cells": cells}
        for name, rows in (("guard", guard_rows), ("matrix", matrix_rows)):
            got = o[name]["launches"]
            check(got["block_scatter_rows"] == rows and got["block_prefix_update"] == 0,
                  f"rank {rank}: later lanes {name} K6 launches {got['block_scatter_rows']} == "
                  f"block rows {rows} (no K2)")
        check(sum(o["fused"]["launches"].values()) == 0,
              f"rank {rank}: the fused runner's lanes launch no kernel (the plain scatter)")
    # (a) the fused device stream
    a, u = one["fused"], one["fused_unsharded"]
    gap = _np_gap(a["w"], u["w"])
    exact = (np.array_equal(a["times"], u["times"])
             and np.array_equal(a["extras"]["comp"], u["extras"]["comp"]))
    check(exact and gap <= 1e-4 and _acc_gap(a["acc"], u["acc"]) <= 1e-4,
          f"fused device stream E={MLP_E} on {LANE_RANKS} ranks vs unsharded (T={LANE_T}): event "
          f"clock and completion counts exact {exact}, weights max gap {gap:.3e} <= 1e-4, "
          f"accuracy gap {_acc_gap(a['acc'], u['acc']):.5f}")
    # (b) the guard under lanes
    g, u = one["guard"], two["guard_unsharded"]
    rej = [int(x["extras"][k]) for x in (g, u) for k in ("guard_rejects", "stale_drops")]
    gap = _np_gap(g["w"], u["w"])
    check(rej[0] == rej[2] > 0 and rej[1] == rej[3] and gap <= 1e-4,
          f"guarded host E={MLP_E} K6 on {LANE_RANKS} ranks vs unsharded K2: rejects "
          f"{rej[0]} == {rej[2]} > 0, stale drops {rej[1]} == {rej[3]}, weights max gap "
          f"{gap:.3e} <= 1e-4")
    check(u["launches"]["block_prefix_update"] == guard_rows,
          f"guarded unsharded K2 launches {u['launches']['block_prefix_update']} == {guard_rows}")
    # (c) run_matrix with K6 across the cells
    m, u = one["matrix"], one["matrix_unsharded"]
    dacc = max(float(np.max(np.abs(m["acc"] - u["acc"]))),
               float(np.max(np.abs(m["final_acc"] - u["final_acc"]))))
    gap = _np_gap(one["matrix_w"]["w"], one["matrix_w_unsharded"]["w"])
    check(dacc <= 1e-4 and gap <= 1e-4 and np.array_equal(m["times"], u["times"]),
          f"run_matrix devices={LANE_RANKS} kernel=pallas over {cells} cells vs unsharded K2: "
          f"curves and final accuracies max gap {dacc:.3e} <= 1e-4, the cells' final weights "
          f"max gap {gap:.3e} <= 1e-4, eval times exact")
    check(u["launches"]["block_prefix_update"] == matrix_rows,
          f"unsharded matrix K2 launches {u['launches']['block_prefix_update']} == {matrix_rows}")
    wall = lambda name: max(o[name]["wall"] for o in later)  # noqa: E731
    print(f"later lanes, events/s on {LANE_RANKS} ranks sharing the card vs one process "
          f"(T={LANE_T}): fused device stream E={MLP_E} {LANE_T / wall('fused'):.1f} vs "
          f"{LANE_T / one['fused_unsharded']['wall']:.1f}; guarded host K6 "
          f"{LANE_T / wall('guard'):.1f} vs K2 {LANE_T / two['guard_unsharded']['wall']:.1f}; "
          f"run_matrix {cells} cells summed, K6 across cells {cells * LANE_T / wall('matrix'):.1f} "
          f"vs K2 {cells * LANE_T / u['wall']:.1f}")


def _check_shards(dev, data) -> None:
    """Phase 15's 2-D layout: ``run_matrix(stream="device", devices=2)`` in
    a group of `SHARD_RANKS` gloo ranks on the card (shard 2 x lane 2),
    while this process runs the unsharded device matrix (on ``data``'s
    cached task setup); the ranks bitwise equal, curves and final
    accuracies within 1e-4 of the unsharded ones, eval times and the
    per-client extras exact."""
    from repro_torch.launch.lanes import run_lanes

    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_timed, lambda: run_lanes(_shards_rank, SHARD_RANKS, (dev.type,),
                                                    timeout=300.0))
        u, wall_u = _timed(lambda: _shard_matrix(dev, 1, data))
        res, wall = fut.result()
    first = res[0]
    for rank, o in enumerate(res[1:], 1):
        same = all(np.array_equal(o[k], first[k]) for k in ("acc", "final_acc", "times")) \
            and all(np.array_equal(o["extras"][k], first["extras"][k]) for k in first["extras"])
        check(same, f"device matrix shard 2 x lane 2: rank {rank} bitwise rank 0")
    dacc = max(float(np.max(np.abs(first["acc"] - u.eval_acc))),
               float(np.max(np.abs(first["final_acc"] - u.final_acc))))
    exact = np.array_equal(first["times"], u.eval_times) and all(
        np.array_equal(first["extras"][k], u.extras[k]) for k in first["extras"])
    check(dacc <= 1e-4 and exact,
          f"device matrix E={MLP_E} on {SHARD_RANKS} ranks (shard 2 x lane 2) vs unsharded: "
          f"curves and final accuracies max gap {dacc:.3e} <= 1e-4, eval times and extras "
          f"({sorted(first['extras'])}) exact {exact}")
    cells = first["acc"].size // first["acc"].shape[-1]
    slow = max(o["wall"] for o in res)
    print(f"device matrix {cells} cells (T={SHARD_T}), events/s summed: {SHARD_RANKS} ranks "
          f"sharing the card {cells * SHARD_T / slow:.1f} (their spawn {wall:.3f} s in all) vs "
          f"one process {cells * SHARD_T / wall_u:.1f} beside them")


def _print_profile(label: str, fn, events: int) -> None:
    t0 = time.perf_counter()
    dms, wms, top, ops = profile(fn)
    idle = None if dms is None else 1.0 - dms / wms
    print(f"profile {label}: wall {wms / events:.4f} ms/event, device busy "
          f"{None if dms is None else round(dms / events, 6)} ms/event, idle share {idle}, "
          f"{ops / events:.1f} device ops/event (warm-up, profiled window and reading "
          f"{time.perf_counter() - t0:.1f} s)")
    for k, v in top:
        print(f"     {v / events:.6f} ms/event  {k[:110]}")


def _lm_batch(cfg, B: int, S: int, seed: int, dev) -> dict:
    from repro_torch.data.pipeline import SyntheticLMStream

    b = SyntheticLMStream(cfg.vocab_size, S, seed=seed).batch(B)
    return {k: torch.as_tensor(v, dtype=torch.int64, device=dev) for k, v in b.items()}


def phase_grad_check(dev, arch: str, num_layers: int | None = None) -> None:
    """7. / 9. / 12. One loss and gradient of a full-width config in fp32
    with the kernels (``use_pallas=True``) and with the plain versions, on
    the same weights and batch; one K3 launch per attention block, one K4
    launch per Mamba2 layer and three K5 launches per MoE layer (the sort
    dispatch) per forward.  ``num_layers`` cuts the depth; an MoE config
    also gives the loss of the einsum dispatch (no K5) on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as k5
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.models import api, hybrid
    from repro_torch.models.module import init_params
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch).replace(dtype="float32")
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    moe = cfg.family == "moe"
    if moe:
        cfg = cfg.replace(moe_dispatch="sort")
    ssm = cfg.family in ("ssm", "hybrid")
    attention = (0 if cfg.family == "ssm" else
                 hybrid.num_shared_sites(cfg) if cfg.family == "hybrid" else cfg.num_layers)
    per_forward = {"flash_attention": attention, "ssd_scan": cfg.num_layers if ssm else 0,
                   "moe_gmm": 3 * cfg.num_layers if moe else 0}
    params = init_params(api.model_meta(cfg), 0, dev)
    batch = _lm_batch(cfg, 2, LM_SEQ, 1, dev)
    res = {}
    for use_pallas, remat in ((True, cfg.remat), (True, "none"), (False, cfg.remat)):
        c = cfg.replace(use_pallas=use_pallas, remat=remat)
        for mod in (fa, k4, k5):
            mod.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res[use_pallas, remat], wall = _timed(lambda: torch.func.grad_and_value(
            lambda p: api.loss_fn(p, batch, c)[0])(params))
        got = {"flash_attention": fa.launches["flash_attention"], "ssd_scan": k4.launches["ssd_scan"],
               "moe_gmm": k5.launches["moe_gmm"]}
        print(f"{arch} ({cfg.num_layers} layers) fp32 full-width loss+grad, use_pallas={use_pallas}, "
              f"remat {remat}: {wall:.3f} s, loss {float(res[use_pallas, remat][1]):.7f}, launches "
              f"{got}, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if use_pallas:
            want = {k: v * _passes(c, k) for k, v in per_forward.items()}
            check(got == want, f"{arch} launches per gradient at remat {remat} {got} == {want}")
        if (use_pallas, remat) == (True, "none"):
            # remat changes what the backward keeps, not the numbers
            (gf, lf), (gn, ln) = res[True, cfg.remat], res.pop((True, "none"))
            same = [torch.equal(a, b) for a, b in zip(tree_leaves(gf), tree_leaves(gn))]
            gap = max(max_err(a, b) for a, b in zip(tree_leaves(gf), tree_leaves(gn)))
            check(all(same) and torch.equal(lf, ln),
                  f"{arch} fp32 full-width, kernels, remat {cfg.remat} vs none: loss bitwise "
                  f"{torch.equal(lf, ln)}, gradients bitwise on {sum(same)} of {len(same)} "
                  f"leaves (max gap {gap:.3e})")
            del gf, gn
    (gk, lk), (gp, lp) = res[True, cfg.remat], res[False, cfg.remat]
    rel = abs(float(lk) - float(lp)) / abs(float(lp))
    check(rel <= 1e-5, f"{arch} fp32 full-width loss, kernel vs plain: relative gap {rel:.3e} <= 1e-5")
    if moe:
        with torch.no_grad():
            le = api.loss_fn(params, batch, cfg.replace(moe_dispatch="einsum"))[0]
        rel = abs(float(le) - float(lp)) / abs(float(lp))
        check(rel <= 1e-5, f"{arch} fp32 full-width loss, einsum vs sort dispatch: relative gap "
              f"{rel:.3e} <= 1e-5 (einsum {float(le):.7f})")
    gmax = max(float(g.abs().max()) for g in tree_leaves(gp))
    gap = max(max_err(a, b) for a, b in zip(tree_leaves(gk), tree_leaves(gp)))
    per_leaf = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(tree_leaves(gk), tree_leaves(gp)))
    check(gap <= 1e-4 * gmax, f"{arch} fp32 full-width grads, kernel vs plain: max gap {gap:.3e} <= "
          f"1e-4 * max|g| = {1e-4 * gmax:.3e} (worst leaf, relative to its own max: {per_leaf:.3e})")
    del params, res, gk, gp
    torch.cuda.empty_cache()


def phase_lm(dev, launches: dict) -> None:
    """8. The LM slice at full width (see the module docstring); adds the
    kernel launches of its two runs to ``launches`` under "lm"."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.async_sgd import ServerConfig, run_generalized_async_sgd
    from repro_torch.data.pipeline import make_client_speeds
    from repro_torch.fl.engine import LMTask, _cached_fl_setup, run_experiment, sampling_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import weighted_update as wu
    from repro_torch.models import api
    from repro_torch.models.module import param_count

    part = _Part("Granite LM (phase 8)")
    cfg = get_config(LM_ARCH).replace(use_pallas=True)  # remat "full", the config's
    n_params = param_count(api.model_meta(cfg))
    check(n_params == LM_PARAMS, f"{LM_ARCH} parameters {n_params:,} == {LM_PARAMS:,}")
    flc = FLConfig(n_clients=LM_N, concurrency=LM_C, server_steps=LM_T, sampling="optimal",
                   speed_ratio=10.0, engine="scan", device=dev.type)
    forwards = _forwards(LM_T, LM_EVAL, cfg, "flash_attention")
    tokens = LM_T * LM_BATCH * LM_SEQ
    lm = launches.setdefault("lm", {"weighted_update": 0, "flash_attention": 0})

    def experiment(use_pallas: bool):
        task = LMTask(cfg.replace(use_pallas=use_pallas), batch_size=LM_BATCH,
                      seq_len=LM_SEQ, shard_size=LM_SHARD)
        r, wall = _timed(lambda: run_experiment(flc, "gen_async", eval_every=LM_EVAL, task=task))
        curve = np.asarray(r.eval_acc, np.float64)
        print(f"LM run_experiment {LM_ARCH} use_pallas={use_pallas} n={LM_N} C={LM_C} "
              f"T={LM_T}: {wall:.3f} s, {LM_T / wall:.3f} events/s, {tokens / wall:.1f} tokens/s, "
              f"eval steps {r.eval_steps.tolist()} loss {curve.tolist()}")
        return task, curve

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    wu.reset_launches()
    task, curve = experiment(True)
    lm["flash_attention"] += fa.launches["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    print(f"LM peak device memory (run_experiment, C={LM_C}, remat {cfg.remat}): "
          f"{peak / 2**30:.3f} GiB")
    check(curve.shape == (LM_T // LM_EVAL,) and bool(np.all(np.isfinite(curve))),
          f"LM eval losses finite, {LM_T // LM_EVAL} points")
    check(bool(curve[-1] < curve[0]), f"LM eval loss falls: {curve[0]:.5f} -> {curve[-1]:.5f}")
    check(fa.launches["flash_attention"] == cfg.num_layers * forwards,
          f"K3 launches {fa.launches['flash_attention']} == {cfg.num_layers} x {forwards} forwards")

    # the same task with the per-leaf K1 update
    setup = _cached_fl_setup(None, flc.seed, task, n_clients=LM_N, device=dev)
    mu = make_client_speeds(LM_N, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
    base = ServerConfig(n=LM_N, C=LM_C, T=LM_T, eta=0.05, mu=mu, p=sampling_for(flc, mu),
                        seed=flc.seed, eval_every=LM_EVAL, engine="scan",
                        weighting="importance", update="pallas", device=dev.type)
    run = lambda c: run_generalized_async_sgd(setup.params, setup.clients, c,  # noqa: E731
                                              eval_fn=setup.eval_fn)
    fa.reset_launches()
    wu.reset_launches()
    (w, tr), wall = _timed(lambda: run(base))
    lm["flash_attention"] += fa.launches["flash_attention"]
    _k1_counts(lm, "LM", LM_T, LM_LEAVES)
    del w
    print(f"LM update=pallas: {wall:.3f} s, {LM_T / wall:.3f} events/s, {tokens / wall:.1f} "
          f"tokens/s, launches K1 {wu.launches['weighted_update']} K3 "
          f"{fa.launches['flash_attention']}, loss {tr.eval_values}")
    check(fa.launches["flash_attention"] == cfg.num_layers * forwards,
          f"K3 launches {fa.launches['flash_attention']} == {cfg.num_layers} x {forwards} forwards")
    gap = float(np.max(np.abs(np.asarray(tr.eval_values) - curve) / np.abs(curve)))
    check(gap <= 1e-3, f"LM eval curve, update=pallas vs jnp: relative gap {gap:.3e} <= 1e-3")
    peak = torch.cuda.max_memory_allocated()
    st = torch.cuda.memory_stats()
    print(f"LM peak device memory (both runs): {peak / 2**30:.3f} GiB; allocator: "
          + ", ".join(f"{k} {st[k]}" for k in ("num_alloc_retries", "num_device_alloc",
                                                "num_device_free") if k in st))

    # where the time goes: a few events of the kernel path under the profiler
    few = 8
    _print_profile(f"LM update=pallas, use_pallas=True, T={few} (incl. ring set-up)",
                   lambda: run(replace(base, T=few, eval_every=0)), few)
    del setup, run
    task.__dict__.pop("_fl_setup_cache")
    torch.cuda.empty_cache()

    # the same run with the plain attention
    _, curve0 = experiment(False)
    gap = float(np.max(np.abs(curve - curve0) / np.abs(curve0)))
    check(gap <= LM_CURVE_TOL,
          f"LM eval curve, K3 vs plain attention: relative gap {gap:.3e} <= {LM_CURVE_TOL}")
    part.end()


def _train_loss(setup, params, J, steps=None) -> float:
    """Mean loss of ``params`` over a run's trained minibatches (event k:
    client J[k]'s window at step k; ``steps`` the trained events, default
    all), sixteen minibatches a forward (each forward's mean weighted by its
    minibatches); memoized for the initial weights, which several checks
    share."""
    import weakref

    ks = list(range(len(J)) if steps is None else steps)
    memo = _SHARED.setdefault("train_loss", {})
    key = (id(setup), np.asarray(J)[ks].tobytes()) if params is setup.params else None
    if key in memo and memo[key][0]() is setup:
        return memo[key][1]
    total = 0.0
    with torch.no_grad():
        for i in range(0, len(ks), 16):
            bs = [setup.clients.client_batch(int(J[k]), int(k)) for k in ks[i:i + 16]]
            batch = {key: torch.cat([b[key] for b in bs]) for key in bs[0]}
            total += float(setup.clients.loss_fn(params, batch)) * len(bs)
    if key is not None:
        memo[key] = weakref.ref(setup), total / len(ks)
    return total / len(ks)


def _passes(cfg, kernel: str) -> int:
    """Forwards of ``kernel`` a gradient runs under ``cfg.remat``: the
    recompute of "full" and "dots" runs each rematerialised block's forward
    (K3, K4, K5) a second time, as the reference's ``jax.checkpoint`` runs
    its Pallas kernels twice; the hybrid recomputes its Mamba2 bodies (K4),
    never its shared attention sites (K3)."""
    if cfg.remat == "none" or (cfg.family == "hybrid" and kernel == "flash_attention"):
        return 1
    return 2


def _forwards(T: int, every: int, cfg=None, kernel: str = "ssd_scan") -> int:
    """Forwards of ``kernel`` in a per-event run: `_passes` per gradient, one
    per eval (one per gradient when ``cfg`` is not given)."""
    return T * (1 if cfg is None else _passes(cfg, kernel)) + T // every


def phase_mamba(dev, launches: dict) -> None:
    """10. The Mamba2 LM slice at full width and depth (see the module
    docstring); adds the kernel launches of its three kernel runs to
    ``launches`` under "mamba2"."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.async_sgd import ServerConfig, run_generalized_async_sgd
    from repro_torch.core.engine_scan import _snapshot_codec, blocked_inputs, step_scales
    from repro_torch.core.queue_sim import EventBlocks, SimConfig, export_stream
    from repro_torch.data.pipeline import make_client_speeds
    from repro_torch.fl.engine import LMTask, _cached_fl_setup, run_experiment, sampling_for
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.kernels import weighted_update as wu
    from repro_torch.models import api
    from repro_torch.models.module import param_count
    from repro_torch.tree import tree_map

    part = _Part("Mamba2 (phase 10)")
    cfg = get_config(MAMBA_ARCH).replace(use_pallas=True, remat="none")  # pinned: see `_mamba_task`
    n_params = param_count(api.model_meta(cfg))
    check(n_params == MAMBA_PARAMS, f"{MAMBA_ARCH} parameters {n_params:,} == {MAMBA_PARAMS:,}")
    nL = cfg.num_layers
    flc = FLConfig(n_clients=LM_N, concurrency=MAMBA_C, server_steps=LM_T, sampling="optimal",
                   speed_ratio=10.0, engine="scan", device=dev.type)
    forwards = _forwards(LM_T, LM_EVAL)
    tokens = LM_T * LM_BATCH * LM_SEQ
    path = launches.setdefault("mamba2", {"weighted_update": 0, "block_prefix_update": 0,
                                          "ssd_scan": 0})

    def task_for(use_pallas: bool):
        if use_pallas:
            return _mamba_task(dev)
        return LMTask(cfg.replace(use_pallas=False), batch_size=LM_BATCH, seq_len=LM_SEQ,
                      shard_size=LM_SHARD)

    def experiment(task, label: str):
        """``(curve, final weights, K4 launches, peak)`` of `run_experiment`;
        with K4, phase 17's run of its "optimal" cell alone when that was the
        same configuration (`phase_matrix_mamba` keeps it)."""
        done = _SHARED.get("mamba_alone")
        if (task.cfg.use_pallas and done is not None and done["flc"] == flc
                and done["every"] == LM_EVAL and done["task"] == task.cache_key()):
            r, wall, n4, peak = done["run"], done["wall"], done["k4"], done["peak"]
            final = tree_map(lambda v: v.to(dev), r.final_params)
            source = " (phase 17's run of its \"optimal\" cell alone: the same configuration)"
        else:
            k4.reset_launches()
            r, wall = _timed(lambda: run_experiment(flc, "gen_async", eval_every=LM_EVAL,
                                                    task=task))
            n4, final, source = k4.launches["ssd_scan"], r.final_params, ""
            peak = torch.cuda.max_memory_allocated()
        curve = np.asarray(r.eval_acc, np.float64)
        print(f"Mamba2 run_experiment ({label}) n={LM_N} C={MAMBA_C} T={LM_T}{source}: "
              f"{wall:.3f} s, {LM_T / wall:.3f} events/s, {tokens / wall:.1f} tokens/s, "
              f"eval steps {r.eval_steps.tolist()} loss {curve.tolist()}")
        return curve, final, n4, peak

    def curve_gap(a, b) -> float:
        return float(np.max(np.abs(np.asarray(a) - b) / np.abs(b)))

    mu = make_client_speeds(LM_N, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
    p = sampling_for(flc, mu)
    stream = export_stream(SimConfig(mu=mu, p=p, C=MAMBA_C, T=LM_T, seed=flc.seed))

    def learns(label: str, task, curve, final) -> float:
        """After a run, outside its timed window and its launch counts: the
        eval curve from the initial weights, and the check that the
        clients' training loss falls; returns the initial eval loss."""
        setup = _cached_fl_setup(None, flc.seed, task, n_clients=LM_N, device=dev)
        with torch.no_grad():
            loss0 = float(setup.eval_fn(setup.params))
        before = _train_loss(setup, setup.params, stream.J)
        after = _train_loss(setup, final, stream.J)
        print(f"Mamba2 eval loss ({label}) from the initial weights: {loss0:.5f} -> "
              f"{curve.tolist()}")
        check(after < before, f"Mamba2 training loss ({label}) over the run's {LM_T} trained "
              f"minibatches falls: {before:.5f} -> {after:.5f}")
        return loss0

    # 1. run_experiment with K4, the plain update.  Its eval loss does not
    # fall over these 64 events, with the plain SSD neither (the eval stream
    # has its own bigram structure, the clients' their own; PERF.md): the
    # run is held to its clients' training loss falling, and the kernel to
    # the plain SSD on the curve and on the initial weights' eval loss
    torch.cuda.reset_peak_memory_stats()
    task = task_for(True)
    curve, final, n4, peak = experiment(task, "K4")
    path["ssd_scan"] += n4
    print(f"Mamba2 peak device memory (run_experiment): {peak / 2**30:.3f} GiB")
    check(curve.shape == (LM_T // LM_EVAL,) and bool(np.all(np.isfinite(curve))),
          f"Mamba2 eval losses finite, {LM_T // LM_EVAL} points")
    check(n4 == nL * forwards, f"K4 launches {n4} == {nL} x {forwards} forwards")
    loss0 = learns("K4", task, curve, final)
    del final
    setup = _cached_fl_setup(None, flc.seed, task, n_clients=LM_N, device=dev)

    # 2. the same task with the per-leaf K1 update; 3. blocked with K2
    base = ServerConfig(n=LM_N, C=MAMBA_C, T=LM_T, eta=0.05, mu=mu, p=p, seed=flc.seed,
                        eval_every=LM_EVAL, engine="scan", weighting="importance",
                        update="pallas", device=dev.type)
    run = lambda c: run_generalized_async_sgd(setup.params, setup.clients, c,  # noqa: E731
                                              eval_fn=setup.eval_fn)
    wu.reset_launches()
    k4.reset_launches()
    (w, tr), wall = _timed(lambda: run(base))
    _k1_counts(path, "Mamba2", LM_T, MAMBA_LEAVES)
    path["ssd_scan"] += k4.launches["ssd_scan"]
    del w
    print(f"Mamba2 update=pallas: {wall:.3f} s, {LM_T / wall:.3f} events/s, "
          f"{tokens / wall:.1f} tokens/s, launches K1 {wu.launches['weighted_update']} "
          f"K4 {k4.launches['ssd_scan']}, loss {tr.eval_values}")
    check(k4.launches["ssd_scan"] == nL * forwards,
          f"K4 launches {k4.launches['ssd_scan']} == {nL} x {forwards} forwards")
    gap = curve_gap(tr.eval_values, curve)
    tol = MAMBA_CURVE_TOL["pallas_update"]
    check(gap <= tol, f"Mamba2 eval curve, update=pallas (bf16 leaves) vs the fp32 flat "
          f"update: relative gap {gap:.3e} <= {tol}")

    rows = blocked_inputs(EventBlocks.from_stream(stream, MAMBA_E, cut_every=LM_EVAL),
                          step_scales(stream, base.eta, p, "importance"), LM_EVAL)[0].shape[0]
    evals = LM_T // LM_EVAL
    blocked = replace(base, block_size=MAMBA_E)
    pack, _, enc = _snapshot_codec(setup.params, blocked.snapshot_dtype)
    flat = pack(setup.params)
    print(f"Mamba2 blocked E={MAMBA_E}: K2's ring stores {enc(flat).dtype}, w is {flat.dtype}")
    del flat
    wu.reset_launches()
    k4.reset_launches()
    (w, tr_b), wall = _timed(lambda: run(blocked))
    path["block_prefix_update"] += wu.launches["block_prefix_update"]
    path["ssd_scan"] += k4.launches["ssd_scan"]
    del w
    print(f"Mamba2 blocked E={MAMBA_E} update=pallas: {rows} block rows, {wall:.3f} s, "
          f"{LM_T / wall:.3f} events/s, {tokens / wall:.1f} tokens/s, launches K2 "
          f"{wu.launches['block_prefix_update']} K4 {k4.launches['ssd_scan']}, "
          f"loss {tr_b.eval_values}")
    check(wu.launches["block_prefix_update"] == rows,
          f"K2 launches {wu.launches['block_prefix_update']} == block rows {rows}")
    check(k4.launches["ssd_scan"] == nL * (rows + evals),
          f"K4 launches {k4.launches['ssd_scan']} == {nL} x ({rows} block rows + {evals} evals)")
    gap = curve_gap(tr_b.eval_values, curve)
    tol = MAMBA_CURVE_TOL["blocked"]
    check(gap <= tol, f"Mamba2 eval curve, blocked vs per-event: relative gap {gap:.3e} <= {tol}")
    peak = torch.cuda.max_memory_allocated()
    print(f"Mamba2 peak device memory (three kernel runs): {peak / 2**30:.3f} GiB")

    # where the time goes: a few events of each kernel path under the profiler
    few = 8
    _print_profile(f"Mamba2 update=pallas, use_pallas=True, T={few} (incl. ring set-up)",
                   lambda: run(replace(base, T=few, eval_every=0)), few)
    _print_profile(f"Mamba2 blocked E={MAMBA_E}, update=pallas, use_pallas=True, T={2 * few} "
                   "(incl. ring set-up)",
                   lambda: run(replace(blocked, T=2 * few, eval_every=0)), 2 * few)
    del setup, run
    torch.cuda.empty_cache()

    # 4. the same run with the plain SSD
    task0 = task_for(False)
    curve0, final, _, _ = experiment(task0, "plain SSD")
    loss0_plain = learns("plain SSD", task0, curve0, final)
    del final
    tol = MAMBA_CURVE_TOL["plain_ssd"]
    gap = curve_gap([loss0], np.asarray([loss0_plain]))
    check(gap <= tol, f"Mamba2 eval loss of the initial weights, K4 vs plain SSD: relative gap "
          f"{gap:.3e} <= {tol}")
    gap = curve_gap(curve, curve0)
    check(gap <= tol, f"Mamba2 eval curve, K4 vs plain SSD: relative gap {gap:.3e} <= {tol}")
    part.end()


def phase_moe_lm(dev, launches: dict) -> None:
    """13. The Qwen1.5-MoE LM slice at full width (see the module
    docstring); adds the kernel launches of its two kernel runs to
    ``launches`` under "qwen_moe"."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.async_sgd import ServerConfig, run_generalized_async_sgd
    from repro_torch.data.pipeline import make_client_speeds
    from repro_torch.fl.engine import LMTask, _cached_fl_setup, run_experiment, sampling_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as k5
    from repro_torch.kernels import weighted_update as wu
    from repro_torch.models import api
    from repro_torch.models.module import param_count

    part = _Part("Qwen1.5-MoE LM (phase 13)")
    cfg = get_config(MOE_ARCH).replace(num_layers=MOE_LAYERS, use_pallas=True,
                                       moe_dispatch="sort")
    n_params = param_count(api.model_meta(cfg))
    check(n_params == MOE_PARAMS,
          f"{MOE_ARCH} ({MOE_LAYERS} layers) parameters {n_params:,} == {MOE_PARAMS:,}")
    nL = cfg.num_layers
    flc = FLConfig(n_clients=LM_N, concurrency=LM_C, server_steps=LM_T, sampling="optimal",
                   speed_ratio=10.0, engine="scan", device=dev.type)
    forwards = _forwards(LM_T, LM_EVAL, cfg, "moe_gmm")  # K3 and K5 alike: remat "full"
    tokens = LM_T * LM_BATCH * LM_SEQ
    path = launches.setdefault("qwen_moe", {"weighted_update": 0, "flash_attention": 0,
                                            "moe_gmm": 0})

    def experiment(use_pallas: bool):
        task = LMTask(cfg.replace(use_pallas=use_pallas), batch_size=LM_BATCH,
                      seq_len=LM_SEQ, shard_size=LM_SHARD)
        r, wall = _timed(lambda: run_experiment(flc, "gen_async", eval_every=LM_EVAL, task=task))
        curve = np.asarray(r.eval_acc, np.float64)
        print(f"Qwen-MoE run_experiment use_pallas={use_pallas} n={LM_N} C={LM_C} T={LM_T}: "
              f"{wall:.3f} s, {LM_T / wall:.3f} events/s, {tokens / wall:.1f} tokens/s, "
              f"eval steps {r.eval_steps.tolist()} loss {curve.tolist()}")
        return task, curve

    def counts_ok(label: str) -> None:
        check(k5.launches["moe_gmm"] == 3 * nL * forwards,
              f"Qwen-MoE {label}: K5 launches {k5.launches['moe_gmm']} == 3 x {nL} x "
              f"{forwards} forwards")
        check(fa.launches["flash_attention"] == nL * forwards,
              f"Qwen-MoE {label}: K3 launches {fa.launches['flash_attention']} == {nL} x "
              f"{forwards} forwards")

    # 1. run_experiment with K3 and K5, the plain update
    torch.cuda.reset_peak_memory_stats()
    for mod in (fa, k5, wu):
        mod.reset_launches()
    task, curve = experiment(True)
    path["flash_attention"] += fa.launches["flash_attention"]
    path["moe_gmm"] += k5.launches["moe_gmm"]
    print(f"Qwen-MoE peak device memory (run_experiment): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(curve.shape == (LM_T // LM_EVAL,) and bool(np.all(np.isfinite(curve))),
          f"Qwen-MoE eval losses finite, {LM_T // LM_EVAL} points")
    check(bool(curve[-1] < curve[0]), f"Qwen-MoE eval loss falls: {curve[0]:.5f} -> {curve[-1]:.5f}")
    counts_ok("run_experiment")

    # 1b. the same run again: the K3 + K5 path repeats bitwise (no atomics
    # on its forward or backward, the sort dispatch included)
    task.__dict__.pop("_fl_setup_cache", None)
    for mod in (fa, k5, wu):
        mod.reset_launches()
    task, curve_again = experiment(True)
    path["flash_attention"] += fa.launches["flash_attention"]
    path["moe_gmm"] += k5.launches["moe_gmm"]
    counts_ok("run_experiment, repeated")
    # the exact curve, to compare across calls
    print(f"Qwen-MoE K3 + K5 eval curve (float.hex): {[float(v).hex() for v in curve]}")
    check(np.array_equal(curve, curve_again),
          f"Qwen-MoE K3 + K5 eval curve repeats bitwise: {curve.tolist()} == "
          f"{curve_again.tolist()}")

    # 2. the same task with the per-leaf K1 update
    setup = _cached_fl_setup(None, flc.seed, task, n_clients=LM_N, device=dev)
    mu = make_client_speeds(LM_N, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
    base = ServerConfig(n=LM_N, C=LM_C, T=LM_T, eta=0.05, mu=mu, p=sampling_for(flc, mu),
                        seed=flc.seed, eval_every=LM_EVAL, engine="scan",
                        weighting="importance", update="pallas", device=dev.type)
    run = lambda c: run_generalized_async_sgd(setup.params, setup.clients, c,  # noqa: E731
                                              eval_fn=setup.eval_fn)
    for mod in (fa, k5, wu):
        mod.reset_launches()
    (w, tr), wall = _timed(lambda: run(base))
    _k1_counts(path, "Qwen-MoE", LM_T, MOE_LEAVES)
    path["flash_attention"] += fa.launches["flash_attention"]
    path["moe_gmm"] += k5.launches["moe_gmm"]
    del w
    print(f"Qwen-MoE update=pallas: {wall:.3f} s, {LM_T / wall:.3f} events/s, "
          f"{tokens / wall:.1f} tokens/s, launches K1 {wu.launches['weighted_update']} K3 "
          f"{fa.launches['flash_attention']} K5 {k5.launches['moe_gmm']}, loss {tr.eval_values}")
    counts_ok("update=pallas")
    gap = float(np.max(np.abs(np.asarray(tr.eval_values) - curve) / np.abs(curve)))
    check(gap <= 1e-3, f"Qwen-MoE eval curve, update=pallas vs the flat update: relative gap "
          f"{gap:.3e} <= 1e-3")
    peak = torch.cuda.max_memory_allocated()
    print(f"Qwen-MoE peak device memory (both kernel runs): {peak / 2**30:.3f} GiB")
    check(peak < 80e9, f"Qwen-MoE peak device memory {peak / 1e9:.3f} GB < 80 GB")

    # where the time goes: a few events of the kernel path under the profiler
    few = 8
    _print_profile(f"Qwen-MoE update=pallas, use_pallas=True, T={few} (incl. ring set-up)",
                   lambda: run(replace(base, T=few, eval_every=0)), few)
    del setup, run
    task.__dict__.pop("_fl_setup_cache")
    torch.cuda.empty_cache()

    # 3. plain attention and bf16 einsum experts on the same sort dispatch
    _, curve0 = experiment(False)
    gap = float(np.max(np.abs(curve - curve0) / np.abs(curve0)))
    check(gap <= MOE_CURVE_TOL, f"Qwen-MoE eval curve, K3 + K5 vs plain: relative gap "
          f"{gap:.3e} <= {MOE_CURVE_TOL}")
    part.end()
    torch.cuda.empty_cache()


def phase_zamba(dev, launches: dict) -> None:
    """24. Zamba2-2.7B's async-FL training run at full width and depth (see
    `ZAMBA_T`), remat "full", per event with K1: with the kernels (K3 at the
    9 shared sites, head_dim 80; K4 in the 54 Mamba2 layers), then with the
    plain attention and SSD on the same weights and stream.  K3 launches ==
    9 a forward (the shared sites are not rematerialised), K4 == 54 x 2 a
    gradient + 54 an eval, K1 == T; the eval curves within
    `ZAMBA_CURVE_TOL` of each other; the clients' training loss over the
    run's trained minibatches falls; the eval loss of the initial weights and
    the training loss after the run within `ZAMBA_INIT_TOL` and
    `ZAMBA_TRAIN_TOL` of the plain run's; peak memory, events/s, tokens/s and
    a profile.  Adds the launches to ``launches`` under "zamba2"."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.async_sgd import ServerConfig, run_generalized_async_sgd
    from repro_torch.core.queue_sim import SimConfig, export_stream
    from repro_torch.data.pipeline import make_client_speeds
    from repro_torch.fl.engine import LMTask, _cached_fl_setup, sampling_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.kernels import weighted_update as wu
    from repro_torch.models import api, hybrid
    from repro_torch.models.module import param_count

    part = _Part("Zamba2-2.7B (phase 24)")
    cfg = get_config(ZAMBA_ARCH).replace(use_pallas=True)  # remat "full", the config's
    n_params = param_count(api.model_meta(cfg))
    check(n_params == ZAMBA_PARAMS, f"{ZAMBA_ARCH} parameters {n_params:,} == {ZAMBA_PARAMS:,}")
    nL, sites = cfg.num_layers, hybrid.num_shared_sites(cfg)
    flc = FLConfig(n_clients=LM_N, concurrency=ZAMBA_C, server_steps=ZAMBA_T,
                   sampling="optimal", speed_ratio=10.0, engine="scan", device=dev.type)
    mu = make_client_speeds(LM_N, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
    p = sampling_for(flc, mu)
    base = ServerConfig(n=LM_N, C=ZAMBA_C, T=ZAMBA_T, eta=0.05, mu=mu, p=p, seed=flc.seed,
                        eval_every=ZAMBA_EVAL, engine="scan", weighting="importance",
                        update="pallas", device=dev.type)
    stream = export_stream(SimConfig(mu=mu, p=p, C=ZAMBA_C, T=ZAMBA_T, seed=flc.seed))
    tokens = ZAMBA_T * LM_BATCH * LM_SEQ
    evals = ZAMBA_T // ZAMBA_EVAL
    path = launches.setdefault("zamba2", {"weighted_update": 0, "flash_attention": 0,
                                          "ssd_scan": 0})
    curves, init, trained = {}, {}, {}
    total = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.set_per_process_memory_fraction(min(1.0, ZAMBA_GIB * 2**30 / total))
    for use_pallas in (True, False):
        label = "K3 + K4" if use_pallas else "plain attention and SSD"
        task = LMTask(cfg.replace(use_pallas=use_pallas), batch_size=LM_BATCH, seq_len=LM_SEQ,
                      shard_size=LM_SHARD)
        t0 = time.perf_counter()
        setup = _cached_fl_setup(None, flc.seed, task, n_clients=LM_N, device=dev)
        torch.cuda.synchronize()
        print(f"Zamba2 task set-up ({label}): {time.perf_counter() - t0:.3f} s")
        run = lambda c, setup=setup: run_generalized_async_sgd(  # noqa: E731
            setup.params, setup.clients, c, eval_fn=setup.eval_fn)
        for mod in (fa, k4, wu):
            mod.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        (w, tr), wall = _timed(lambda: run(base))
        peak = torch.cuda.max_memory_allocated() / 2**30
        curve = np.asarray(tr.eval_values, np.float64)
        curves[use_pallas] = curve
        print(f"Zamba2 ({label}) n={LM_N} C={ZAMBA_C} T={ZAMBA_T} remat {cfg.remat} K1: "
              f"{wall:.3f} s, {ZAMBA_T / wall:.4f} events/s, {tokens / wall:.1f} tokens/s, peak "
              f"device memory {peak:.3f} GiB ({_SHARED.get('smi', 'card not queried')}); "
              f"launches K1 {wu.launches['weighted_update']} K3 {fa.launches['flash_attention']} "
              f"K4 {k4.launches['ssd_scan']}; eval loss {curve.tolist()}")
        check(curve.shape == (evals,) and bool(np.all(np.isfinite(curve))),
              f"Zamba2 ({label}) eval losses finite, {evals} points")
        if use_pallas:
            _k1_counts(path, "Zamba2", ZAMBA_T, ZAMBA_LEAVES)
            path["flash_attention"] += fa.launches["flash_attention"]
            path["ssd_scan"] += k4.launches["ssd_scan"]
            f3 = _forwards(ZAMBA_T, ZAMBA_EVAL, cfg, "flash_attention")
            f4 = _forwards(ZAMBA_T, ZAMBA_EVAL, cfg, "ssd_scan")
            check(fa.launches["flash_attention"] == sites * f3,
                  f"Zamba2 K3 launches {fa.launches['flash_attention']} == {sites} sites x {f3} "
                  f"forwards (the shared sites run once a gradient)")
            check(k4.launches["ssd_scan"] == nL * f4,
                  f"Zamba2 K4 launches {k4.launches['ssd_scan']} == {nL} layers x {f4} forwards "
                  f"({ZAMBA_T} gradients x 2 under remat, {evals} evals)")
        with torch.no_grad():
            loss0 = float(setup.eval_fn(setup.params))
        before = _train_loss(setup, setup.params, stream.J)
        after = _train_loss(setup, w, stream.J)
        init[use_pallas], trained[use_pallas] = loss0, after
        print(f"Zamba2 ({label}) eval loss from the initial weights {loss0:.5f} -> "
              f"{curve.tolist()}; training loss over the run's {ZAMBA_T} trained minibatches "
              f"{before:.5f} -> {after:.5f}")
        check(after < before, f"Zamba2 ({label}) training loss over the run's {ZAMBA_T} trained "
              f"minibatches falls: {before:.5f} -> {after:.5f}")
        del w
        if use_pallas:
            _print_profile(f"Zamba2-2.7B update=pallas, K3 + K4, T={ZAMBA_PROFILE_T} (incl. ring "
                           "set-up)", lambda: run(replace(base, T=ZAMBA_PROFILE_T, eval_every=0)),
                           ZAMBA_PROFILE_T)
        del setup, run
        task.__dict__.pop("_fl_setup_cache", None)
        torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(1.0)
    gap = float(np.max(np.abs(curves[True] - curves[False]) / np.abs(curves[False])))
    check(gap <= ZAMBA_CURVE_TOL, f"Zamba2 eval curve, K3 + K4 vs plain: relative gap {gap:.3e} "
          f"<= {ZAMBA_CURVE_TOL}")
    for what, got, tol in (("eval loss of the initial weights", init, ZAMBA_INIT_TOL),
                           (f"training loss after the run's {ZAMBA_T} events", trained,
                            ZAMBA_TRAIN_TOL)):
        gap = abs(got[True] - got[False]) / abs(got[False])
        check(gap <= tol, f"Zamba2 {what}, K3 + K4 vs plain: relative gap {gap:.3e} <= {tol}")
    part.end()


def _matrix_inputs(flc, grid: dict, eta: float, every: int, E: int, dev, scenario=None):
    """The scenario grid's stacked replay inputs on ``dev``, as `run_matrix`
    builds them (`matrix_streams`, under ``scenario`` when given): per event
    ``(J, slot, scale)`` (B, T), and blocked E ``(J, slot, scale, k, mask)``
    (B, rows, E) with its ``(chunk_blocks, n_chunks)``."""
    from repro_torch.core.engine_scan import blocked_inputs_batch
    from repro_torch.core.queue_sim import EventBlocks
    from repro_torch.fl.engine import matrix_streams

    _, streams = matrix_streams(flc, eta=eta, scenario=scenario, **grid)
    idx = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)  # noqa: E731
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    per_event = (idx([es.J for es, _ in streams]), idx([es.slot for es, _ in streams]),
                 f32([s for _, s in streams]))
    J, slot, sc, kb, mask, G, nc = blocked_inputs_batch(
        [EventBlocks.from_stream(es, E, cut_every=every, method=flc.segmentation)
         for es, _ in streams], [s for _, s in streams], every)
    blocked = (idx(J), idx(slot), f32(sc), idx(kb), torch.as_tensor(mask, device=dev))
    return per_event, blocked, dict(chunk_blocks=G, n_chunks=nc)


def phase_matrix(dev, launches: dict) -> None:
    """17. The scenario matrix on the host stream (see the module
    docstring), the paper's 27-cell MLP grid and its profiles (the 3-cell
    Mamba2-130M grid is `phase_matrix_mamba`); adds the kernel paths'
    launches to ``launches`` under "matrix" (K1, K2)."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.engine_scan import jit_runner
    from repro_torch.data.pipeline import FederatedClassification
    from repro_torch.fl.engine import _cached_fl_setup, run_experiment, run_matrix
    from repro_torch.kernels import weighted_update as wu
    from repro_torch.kernels.ops import tree_weighted_update

    # (a) the paper's matrix at full width: 27 runs in lockstep
    flc = FLConfig(n_clients=MATRIX_N, concurrency=MATRIX_C, server_steps=MATRIX_T,
                   engine="scan", device=dev.type)
    T, every, B = MATRIX_T, MATRIX_EVAL, 27
    shape = (3, 3, 3, T // every)
    mk = dict(MATRIX_GRID, eta=MATRIX_ETA, eval_every=every)
    data = FederatedClassification(n_clients=MATRIX_N, seed=flc.seed)
    res = {}
    for label, E in (("per event", 1), (f"blocked E={MATRIX_E}", MATRIX_E)):
        m, wall = _timed(lambda: run_matrix(flc, data=data, block_size=E, **mk))
        acc, final = np.asarray(m.eval_acc), np.asarray(m.final_acc)
        print(f"run_matrix {label}, {B} cells n={MATRIX_N} C={MATRIX_C} T={T}: {wall:.3f} s, "
              f"{B * T / wall:.1f} events/s summed over cells; final acc (seed-mean, policy x "
              f"ratio) {final.mean(axis=0).round(4).tolist()}")
        check(acc.shape == shape and final.shape == shape[:3] and bool(np.isfinite(acc).all())
              and bool(np.isfinite(final).all())
              and m.eval_steps.tolist() == list(range(every, T + 1, every))
              and bool(np.all(np.diff(m.eval_times, axis=-1) >= 0)),
              f"run_matrix {label}: eval curves {acc.shape} == {shape}, finite, eval_times "
              "monotone in every cell")
        res[E] = (m, wall)
    (m, wall_pe), (mb, wall_bl) = res[1], res[MATRIX_E]
    dacc = float(np.max(np.abs(mb.eval_acc - m.eval_acc)))
    check(dacc <= 10 / 2048, f"run_matrix blocked vs per event: eval accuracy gap {dacc:.5f} "
          "<= 10/2048")
    s_i, p_i, h_i = MATRIX_CELL
    one = replace(flc, seed=MATRIX_GRID["seeds"][s_i], sampling=MATRIX_GRID["policies"][p_i],
                  speed_ratio=MATRIX_GRID["speed_ratios"][h_i])
    r, wall_1 = _timed(lambda: run_experiment(one, "gen_async", eta=MATRIX_ETA, eval_every=every,
                                              data=data))
    dacc = _acc_gap(list(r.eval_acc), list(m.eval_acc[MATRIX_CELL]))
    check(np.array_equal(r.eval_times, m.eval_times[MATRIX_CELL]) and dacc <= 10 / 2048,
          f"matrix cell {MATRIX_CELL} vs run_experiment alone: eval_times bitwise "
          f"{np.array_equal(r.eval_times, m.eval_times[MATRIX_CELL])}, accuracy gap "
          f"{dacc:.5f} <= 10/2048")
    print(f"events/s: matrix per event {B * T / wall_pe:.1f} summed over {B} cells, blocked "
          f"E={MATRIX_E} {B * T / wall_bl:.1f}; one run_experiment alone {T / wall_1:.1f} "
          f"(x{B * T / wall_pe / (T / wall_1):.2f} per event)")

    # the kernel paths on the same stacked inputs: K1 and K2 across cells
    setup = _cached_fl_setup(data, flc.seed, None, device=dev)
    grad = setup.clients.device_grad
    pe, bl, layout = _matrix_inputs(flc, MATRIX_GRID, MATRIX_ETA, every, MATRIX_E, dev)
    path = launches.setdefault("matrix", {})
    plain = jit_runner(grad, MATRIX_C, eval_fn=setup.eval_fn, eval_every=every, vmap_streams=True)
    w_p, ev_p = plain(setup.params, *pe)
    wu.reset_launches()
    (w_k, ev_k), wall = _timed(lambda: jit_runner(
        grad, MATRIX_C, eval_fn=setup.eval_fn, eval_every=every,
        update_fn=tree_weighted_update, vmap_streams=True)(setup.params, *pe))
    per = -(-B * 6 // wu.MAX_LEAVES)
    got, covered = wu.launches["weighted_update"], wu.launches["weighted_update_leaves"]
    path.update(weighted_update=got, weighted_update_leaves=covered)
    check(got == per * T and covered == T * B * 6,
          f"matrix per event K1 across cells: launches {got} == {per} x T, leaves covered "
          f"{covered} == T x {B} x 6 ({B * T / wall:.1f} events/s summed)")
    same = all(torch.equal(w_k[k], w_p[k]) for k in w_p)
    gap = _tree_gap(w_k, w_p)
    check(same or gap <= 1e-5, f"matrix per event K1 vs the flat update: final weights bitwise "
          f"{same} (max gap {gap:.3e} <= 1e-5), curves bitwise {torch.equal(ev_k, ev_p)}")
    del w_k, ev_k
    blocked = lambda kernel: jit_runner(  # noqa: E731
        grad, MATRIX_C, eval_fn=setup.eval_fn, block_size=MATRIX_E, kernel=kernel,
        vmap_streams=True)(setup.params, *bl, **layout)
    wu.reset_launches()
    (w_b, ev_b), wall = _timed(lambda: blocked("pallas"))
    rows = bl[0].shape[1]
    path["block_prefix_update"] = wu.launches["block_prefix_update"]
    check(wu.launches["block_prefix_update"] == rows,
          f"matrix blocked E={MATRIX_E} K2 across cells: launches "
          f"{wu.launches['block_prefix_update']} == block rows {rows} ({B * T / wall:.1f} "
          "events/s summed)")
    w_j, ev_j = blocked("jnp")
    check(all(torch.equal(w_b[k], w_j[k]) for k in w_j) and torch.equal(ev_b, ev_j),
          f"matrix blocked K2 vs its plain version with the cell axis: final weights and "
          f"curves bitwise (max gap {_tree_gap(w_b, w_j):.3e})")
    del w_b, w_j, w_p
    few = 200
    _print_profile(f"MLP matrix per event, {B} cells in lockstep, T={few} (event steps)",
                   lambda: plain(setup.params, *(a[:, :few] for a in pe)), few)
    _print_profile(f"MLP matrix per event, K1 across cells, T={few} (event steps)",
                   lambda: jit_runner(grad, MATRIX_C, eval_fn=setup.eval_fn, eval_every=every,
                                      update_fn=tree_weighted_update, vmap_streams=True)(
                       setup.params, *(a[:, :few] for a in pe)), few)
    del setup, plain, data
    torch.cuda.empty_cache()


def _flat_cpu(params) -> torch.Tensor:
    """A weight tree as one fp32 vector in host memory."""
    from repro_torch.tree import tree_leaves

    return torch.cat([x.detach().float().reshape(-1).cpu() for x in tree_leaves(params)])


def _own_gap(label: str, cells: list, refs: list, names) -> None:
    """Each cell's final weights (`_flat_cpu`) against the reference run of
    that cell (``refs[c]``) and of every other cell, as ||a - b|| / ||b||:
    the own gap must be below `MAMBA_OWN_GAP` of the nearest other one, so
    swapped or untrained cells fail."""
    for c, name in enumerate(names):
        gaps = [float(torch.linalg.vector_norm(cells[c] - r) / torch.linalg.vector_norm(r))
                for r in refs]
        other = min(g for i, g in enumerate(gaps) if i != c)
        check(gaps[c] <= MAMBA_OWN_GAP * other,
              f"Mamba2 matrix {label}, cell {name!r}: final weights' relative gap to its own "
              f"run {gaps[c]:.3e} <= {MAMBA_OWN_GAP} x the nearest other cell's {other:.3e} "
              f"(all {[float(f'{g:.3e}') for g in gaps]})")


def _frames_key(frames) -> str:
    """The first three repository frames of an allocation's stack (else
    its first two frames): the key `_MemoryOwners` groups blocks by."""
    mine = [f"{os.path.basename(f.get('filename', '?'))}:{f.get('line')} {f.get('name')}"
            for f in frames or []
            if "repro_torch" in f.get("filename", "") or "chip_smoke" in f.get("filename", "")]
    return " <- ".join(mine[:3]) or (" <- ".join(
        f"{os.path.basename(f.get('filename', '?'))}:{f.get('name')}"
        for f in (frames or [])[:2]) or "no frames")


def _owner_lines(title: str, blocks, top: int) -> list[str]:
    """``blocks``: (size, frames) pairs, grouped by `_frames_key`, largest
    first."""
    owners: dict = {}
    for size, frames in blocks:
        key = _frames_key(frames)
        cnt, tot = owners.get(key, (0, 0))
        owners[key] = (cnt + 1, tot + size)
    rows = sorted(owners.items(), key=lambda kv: -kv[1][1])[:top]
    return [title] + [f"     {tot / 2**30:8.3f} GiB in {cnt:5d} blocks  {key[:200]}"
                      for key, (cnt, tot) in rows]


class _MemoryOwners:
    """``--memory-history`` (ROADMAP Queue 3): record the allocator's history
    (`torch.cuda.memory._record_memory_history`) over a block, and at each
    entry of K2's plain version (`kernels.ref.block_prefix_update_ref`, the
    blocked matrix's update) where the allocated bytes reach a new high,
    take `torch.cuda.memory._snapshot()` and print the live blocks grouped
    by the repository frames that allocated them, largest first.  At the
    block's end, the recorded trace is replayed backwards from the final
    snapshot to the point where the most bytes were live, and the owners
    of those bytes are printed the same way."""

    def __init__(self, label: str, top: int = 14):
        self.label, self.top, self.high, self.lines = label, top, 0, []

    def __enter__(self):
        from repro_torch.kernels import ref

        self.ref, self.orig = ref, ref.block_prefix_update_ref
        owner = self

        def entry(*a, **k):
            if owner.active:
                owner.look()
            return owner.orig(*a, **k)

        self.active = True
        ref.block_prefix_update_ref = entry
        torch.cuda.memory._record_memory_history(max_entries=100_000)
        return self

    def look(self) -> None:
        alloc = torch.cuda.memory_allocated()
        if alloc < self.high + 2**30:
            return
        self.high = alloc
        blocks = [(b.get("size", 0), b.get("frames"))
                  for seg in torch.cuda.memory._snapshot().get("segments", [])
                  for b in seg.get("blocks", []) if b.get("state") == "active_allocated"]
        self.lines = _owner_lines(
            f"memory owners at K2's plain-version entry ({self.label}): {alloc / 2**30:.2f} GiB "
            f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved", blocks,
            self.top)

    def peak_lines(self) -> list[str]:
        """The owners at the trace's peak: live blocks replayed backwards
        from the final snapshot (an ``alloc`` did not exist before it, a
        ``free_completed`` did)."""
        snap = torch.cuda.memory._snapshot()
        live = {b["address"]: (b.get("size", 0), b.get("frames"))
                for seg in snap.get("segments", []) for b in seg.get("blocks", [])
                if b.get("state") == "active_allocated"}
        trace = (snap.get("device_traces") or [[]])[torch.cuda.current_device()]
        cur = sum(size for size, _ in live.values())
        best, at = cur, len(trace)
        for i in range(len(trace) - 1, -1, -1):
            ev = trace[i]
            if ev.get("action") == "alloc":
                cur -= ev.get("size", 0)
            elif ev.get("action") == "free_completed":
                cur += ev.get("size", 0)
            if cur > best:
                best, at = cur, i
        for ev in reversed(trace[at:]):
            if ev.get("action") == "alloc":
                live.pop(ev.get("addr"), None)
            elif ev.get("action") == "free_completed":
                live[ev.get("addr")] = (ev.get("size", 0), ev.get("frames"))
        return _owner_lines(
            f"memory owners at the peak of the last {len(trace)} recorded allocator events "
            f"({self.label}): {best / 2**30:.2f} GiB live", live.values(), self.top)

    def __exit__(self, *exc):
        self.active = False
        self.ref.block_prefix_update_ref = self.orig
        lines = self.lines + self.peak_lines()
        torch.cuda.memory._record_memory_history(enabled=None)
        for line in lines:
            print(line)
        return False


def _matrix_grad_peaks(dev, task) -> None:
    """17 (c) (i). One vmapped gradient call of the Mamba2 matrix alone, as
    its blocked engine makes it (`DeviceTaskClients.device_grad` under a
    `vmap` over the cells of a `vmap` over the lanes, each row its own
    snapshot, client and step): over 3 cells x 2 lanes x batch 8 = 48
    folded rows at remat "none", "dots" and "full" (gradients bitwise
    equal, "full" and "dots" below "none"'s peak), then over 3 x 4 x 8 = 96
    rows at "full".  The peak is the allocator's above the call's entry;
    "dots" keeps the per-row products of the 2-D weights (`models.remat`),
    so its peak shows what they cost beside "full"'s block inputs."""
    from repro_torch.fl.engine import _cached_fl_setup
    from repro_torch.tree import tree_leaves, tree_map

    B = len(MAMBA_MATRIX_GRID["policies"])
    peaks, none = {}, None
    for E, remat in ((2, "none"), (2, "dots"), (2, "full"), (4, "full")):
        setup = _cached_fl_setup(None, 0, _mamba_task(dev, remat), n_clients=LM_N, device=dev)
        rows = tree_map(lambda x: (x.float() * (1.0 + 1e-3 * torch.arange(
            B * E, device=dev).view(-1, *[1] * x.ndim))).to(x.dtype).view(B, E, *x.shape),
            setup.params)
        J = (torch.arange(B * E, device=dev) % LM_N).view(B, E)
        K = torch.arange(B * E, device=dev).view(B, E)
        fn = torch.func.vmap(torch.func.vmap(setup.clients.device_grad))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        entry = torch.cuda.memory_allocated()
        g = fn(J, rows, K)
        torch.cuda.synchronize()
        peaks[E, remat] = (torch.cuda.max_memory_allocated() - entry) / 2**30
        print(f"Mamba2 matrix gradient call, {B} cells x {E} lanes x batch {LM_BATCH} = "
              f"{B * E * LM_BATCH} folded rows, remat {remat}: peak {peaks[E, remat]:.3f} GiB "
              f"above the entry ({entry / 2**30:.3f} GiB held at the entry)", flush=True)
        if remat == "none":
            none = g
        elif E == 2:
            same = [torch.equal(a, b) for a, b in zip(tree_leaves(none), tree_leaves(g))]
            check(all(same), f"Mamba2 matrix gradient call at 48 rows: remat {remat} bitwise "
                  f"none on {sum(same)} of {len(same)} leaves")
            check(peaks[2, remat] < peaks[2, "none"],
                  f"Mamba2 matrix gradient call at 48 rows: peak at remat {remat} "
                  f"{peaks[2, remat]:.3f} GiB < none {peaks[2, 'none']:.3f} GiB")
        del g, rows, setup
    _SHARED.pop("mamba_task_dots")  # only this call takes "dots"
    del none
    torch.cuda.empty_cache()


def phase_matrix_mamba(dev, launches: dict) -> None:
    """17 (c). The 3-cell Mamba2-130M matrix at full width and depth, per
    event and blocked, K4 folded over the cells (and cells x lanes); then
    the cells' final weights from the engine on the same stacked inputs:
    each cell's training loss falls, and each cell is nearest its own
    single run (per event) and its own per-event cell (blocked).  Adds K4's
    launches to ``launches`` under "matrix_mamba2".  `main` runs it first
    in its process: before the port rematerialised, the blocked Mamba2
    matrix at E=2 needed up to 73.3 GiB of the card's 79.2, and after the
    other phases it ran out of memory with 5.9-6.3 GiB of the allocator's
    cache reserved but unused (PERF.md); at remat "full" and E=4 it peaked
    at 42.1 GiB."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.engine_scan import jit_runner
    from repro_torch.fl.engine import _cached_fl_setup, run_experiment, run_matrix
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.tree import tree_map

    part = _Part("Mamba2 matrix (phase 17)")
    alone_task = _mamba_task(dev)  # remat "none", the pinned phases' task
    task = _mamba_task(dev, "full")
    _matrix_grad_peaks(dev, task)
    nL, T, every = task.cfg.num_layers, LM_T, LM_EVAL
    flc = FLConfig(n_clients=LM_N, concurrency=MAMBA_C, server_steps=T, speed_ratio=10.0,
                   engine="scan", device=dev.type)
    policies = MAMBA_MATRIX_GRID["policies"]
    B, E = len(policies), MAMBA_MATRIX_E
    mk = dict(MAMBA_MATRIX_GRID, eta=0.05, eval_every=every)
    pe, bl, layout = _matrix_inputs(flc, MAMBA_MATRIX_GRID, 0.05, every, E, dev)
    rows = bl[0].shape[1]
    path = launches.setdefault("matrix_mamba2", {"ssd_scan": 0})
    ring = MAMBA_PARAMS * 4  # bytes of one fp32 ring row
    curves = {}
    for label, bs, steps, folded in (("per event", 1, T, LM_BATCH * B),
                                     (f"blocked E={E}", E, rows, LM_BATCH * B * E)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        k4.reset_launches()
        if bs > 1 and _SHARED.get("memory_history"):
            with _MemoryOwners(f"Mamba2 run_matrix {label}"):
                m, wall = _timed(lambda: run_matrix(flc, task=task, block_size=bs, **mk))
        else:
            m, wall = _timed(lambda: run_matrix(flc, task=task, block_size=bs, **mk))
        n = k4.launches["ssd_scan"]
        path["ssd_scan"] += n
        curve = np.asarray(m.eval_acc, np.float64).reshape(B, -1)
        curves[bs] = curve
        forwards = steps * _passes(task.cfg, "ssd_scan") + T // every + 1  # + evals, the final
        peak = torch.cuda.max_memory_allocated()
        print(f"Mamba2 run_matrix {label}, {B} cells n={LM_N} C={MAMBA_C} T={T}: {wall:.3f} s, "
              f"{B * T / wall:.3f} events/s summed over cells, K4 launches {n}; peak device "
              f"memory {peak / 2**30:.3f} GiB at remat {task.cfg.remat} (rings {B} x "
              f"{ring * (MAMBA_C + (bs > 1)) / 1e9:.2f} GB); "
              f"loss {curve.tolist()}")
        check(curve.shape == (B, T // every) and bool(np.isfinite(curve).all())
              and bool(np.isfinite(m.final_acc).all()),
              f"Mamba2 run_matrix {label}: {B} finite eval-loss curves of {T // every} points")
        check(n == nL * forwards,
              f"Mamba2 run_matrix {label}: K4 launches {n} == {nL} x {forwards} forwards, each "
              f"over the {folded} rows the cells{' x lanes' if bs > 1 else ''} fold into")
    tol = MAMBA_CURVE_TOL["blocked"]
    gap = float(np.max(np.abs(curves[E] - curves[1]) / np.abs(curves[1])))
    check(gap <= tol, f"Mamba2 matrix blocked vs per event: relative gap {gap:.3e} <= {tol}")

    # the cells' final weights: the memoized runner `run_matrix` replays,
    # driven on the same stacked inputs (its curves held to run_matrix's);
    # kept in host memory, as the blocked runs need most of the card
    setup = _cached_fl_setup(None, flc.seed, task, n_clients=LM_N, device=dev)
    grad, J = setup.clients.device_grad, pe[0].cpu().numpy()
    finals = {}
    for bs, args, kw in ((1, pe, dict(eval_every=every)), (E, bl, dict(block_size=E))):
        torch.cuda.empty_cache()
        w, ev = jit_runner(grad, MAMBA_C, eval_fn=setup.eval_fn, vmap_streams=True, **kw)(
            setup.params, *args, **(layout if bs > 1 else {}))
        ev = ev.cpu().numpy().astype(np.float64)
        gap = float(np.max(np.abs(ev - curves[bs]) / np.abs(curves[bs])))
        check(np.array_equal(ev, curves[bs]) or gap <= 1e-5,
              f"Mamba2 matrix E={bs} through jit_runner: curves bitwise run_matrix's "
              f"{np.array_equal(ev, curves[bs])} (relative gap {gap:.3e} <= 1e-5)")
        cells = [tree_map(lambda x, c=c: x[c], w) for c in range(B)]
        del w
        for c, pol in enumerate(policies):
            before = _train_loss(setup, setup.params, J[c])
            after = _train_loss(setup, cells[c], J[c])
            check(after < before, f"Mamba2 matrix E={bs}, cell {pol!r}: training loss over its "
                  f"{T} trained minibatches falls: {before:.5f} -> {after:.5f}")
        finals[bs] = [_flat_cpu(w) for w in cells]
        del cells
    # each cell alone, per event, and the "optimal" cell blocked at the
    # matrix's E
    opt = policies.index("optimal")
    alone = {}
    for c, pol in enumerate(policies):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        k4.reset_launches()
        one = replace(flc, sampling=pol)
        r, wall = _timed(lambda: run_experiment(one, "gen_async", eval_every=every,
                                                task=alone_task))
        alone[c] = (np.asarray(r.eval_acc), _flat_cpu(r.final_params))
        if pol == "optimal":  # phase 10's run_experiment: the same configuration
            _SHARED["mamba_alone"] = dict(
                flc=one, every=every, task=alone_task.cache_key(), wall=wall,
                k4=k4.launches["ssd_scan"], peak=torch.cuda.max_memory_allocated(),
                run=replace(r, final_params=tree_map(lambda v: v.cpu(), r.final_params)))
        del r
    _own_gap("per event vs each cell run alone", finals[1], [alone[c][1] for c in range(B)],
             policies)
    _own_gap(f"blocked E={E} vs the per-event matrix", finals[E], finals[1], policies)
    torch.cuda.empty_cache()
    blocked_alone = np.asarray(run_experiment(replace(flc, sampling="optimal", block_size=E),
                                              "gen_async", eval_every=every, task=task).eval_acc)
    for c, pol in enumerate(policies):
        gap = float(np.max(np.abs(curves[1][c] - alone[c][0]) / np.abs(alone[c][0])))
        check(gap <= tol, f"Mamba2 matrix cell {pol!r} (per event) vs the run alone: relative "
              f"curve gap {gap:.3e} <= {tol}")
    gap = float(np.max(np.abs(curves[E][opt] - blocked_alone) / np.abs(blocked_alone)))
    check(gap <= tol, f"Mamba2 matrix \"optimal\" cell (blocked) vs the run alone: relative "
          f"curve gap {gap:.3e} <= {tol}")
    del finals, alone, setup
    part.end()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ #
# 18. faults, the divergence guard, scenarios and checkpoints
# ------------------------------------------------------------------ #
def _robust_settings(C: int):
    """The reference's benchmark fault and guard settings at concurrency C."""
    from repro_torch.core import FaultConfig, GuardConfig

    return (FaultConfig(**ROBUST_FAULT),
            GuardConfig(max_grad_norm=ROBUST_NORM, stale_cutoff=ROBUST_STALE * C))


class _Spiky:
    """A device gradient source that adds 1e6 to every gradient of every
    ``ROBUST_SPIKE_EVERY``-th server step and returns NaN at ``nan_step``
    (`tests/test_faults.py`'s `_SpikeSource` around the MLP's clients)."""

    def __init__(self, clients, nan_step: int):
        self.clients, self.nan_step = clients, nan_step

    def device_grad(self, j, w, k):
        g = self.clients.device_grad(j, w, k)
        spike = (k % ROBUST_SPIKE_EVERY) == ROBUST_SPIKE_EVERY - 1
        nan = k == self.nan_step
        return {name: torch.where(nan, torch.full_like(x, float("nan")),
                                  torch.where(spike, x + 1e6, x)) for name, x in g.items()}


def _same_extras(a: dict, b: dict) -> bool:
    """Two traces' extras (counters and kind counts) equal, key by key."""
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def _truncate_ckpts(d, keep_step: int) -> list[int]:
    from repro_torch.ckpt import checkpoint as ck

    for s in ck.available_steps(str(d)):
        if s > keep_step:
            shutil.rmtree(os.path.join(str(d), f"step_{s:010d}"))
    return ck.available_steps(str(d))


def _print_saves(label: str) -> list[dict]:
    """The saves of the checkpointed run that just ended (`engine_ckpt.saves`)."""
    from repro_torch.core import engine_ckpt as ec

    for s in ec.saves:
        print(f"     {label} save at event {s['step']}: {s['bytes']:,} bytes copied to the host "
              f"({s.get('file_bytes', 0):,} in arrays.npz), the loop held {s['copy_s'] * 1e3:.2f} "
              f"ms for the copy and {s['wait_s'] * 1e3:.2f} ms for the previous write")
    return list(ec.saves)


def _mlp_robust_cfg(base, C: int):
    """The MLP slice's ServerConfig with faults and the guard."""
    fault, guard = _robust_settings(C)
    return replace(base, faults=fault, guard=guard)


def _robust_child(ckpt_dir: str, mode: str, dev) -> int:
    """The kill-and-resume child of phase 18 (``mode`` "kill" / "resume"):
    the blocked E=8 MLP run with faults, the guard, K2 and
    ``ckpt_every=500`` under ``ckpt_dir``; and of phase 20 ("fused_kill" /
    "fused_resume"): `_dev_ckpt_cfg`'s per-event MLP run on the device
    stream through `engine_ckpt.run_checkpointed`.  A "kill" mode SIGKILLs
    this process after its second checkpoint lands; a "resume" mode resumes
    from the latest checkpoint and writes the final weights and eval curve
    to ``ckpt_dir/result.npz``."""
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.core.async_sgd import run_generalized_async_sgd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fused = mode.startswith("fused_")
    mode = mode.removeprefix("fused_")
    if mode == "kill":
        saved, real = [0], ck.save

        def killing_save(*a, **k):
            out = real(*a, **k)
            saved[0] += 1
            if saved[0] == 2:
                os.kill(os.getpid(), signal.SIGKILL)
            return out

        ck.save = killing_save
    setup, base = _mlp_setup(dev)
    if fused:
        cfg = replace(_dev_ckpt_cfg(base, ckpt_dir), resume=mode == "resume")
    else:
        cfg = replace(_mlp_robust_cfg(base, base.C), update="pallas", block_size=MLP_E,
                      ckpt_dir=ckpt_dir, ckpt_every=ROBUST_CKPT_EVERY, resume=mode == "resume")
    w, tr = run_generalized_async_sgd(setup.params, setup.clients, cfg, eval_fn=setup.eval_fn)
    if mode == "kill":
        print("robust child survived past its second checkpoint", file=sys.stderr)
        return 1
    np.savez(os.path.join(ckpt_dir, "result.npz"), evals=np.asarray(tr.eval_values),
             gcnt=np.asarray([tr.extras["guard_rejects"], tr.extras["stale_drops"]]),
             **{k: v.cpu().numpy() for k, v in w.items()})
    return 0


def _run_robust_child(ckpt_dir, mode: str):
    """``(CompletedProcess, seconds)`` of one `_robust_child` in a fresh
    process (``python3 chip_smoke.py --robust-child DIR MODE``)."""
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--robust-child", str(ckpt_dir), mode],
        capture_output=True, text=True, timeout=600)
    return p, time.perf_counter() - t0


def _robust_mlp(dev, launches: dict) -> dict:
    """18., the MLP slice under faults, the guard, spikes, scenarios and
    checkpoints (see the module docstring); its kernel launches go to
    ``launches["robust_mlp"]``.  Returns the uninterrupted blocked
    checkpointed run's final weights (numpy), curve and guard counter, the
    reference of the kill-and-resume children."""
    from repro_torch.core import engine_ckpt as ec
    from repro_torch.core.async_sgd import run_generalized_async_sgd
    from repro_torch.core.engine_scan import blocked_inputs, step_scales
    from repro_torch.core.queue_sim import EventBlocks, SimConfig, export_stream
    from repro_torch.core.scenario import get_scenario
    from repro_torch.kernels import weighted_update as wu

    setup, base = _mlp_setup(dev)
    C, T, E, every = base.C, base.T, MLP_E, base.eval_every
    guarded = _mlp_robust_cfg(base, C)
    fault, guard = guarded.faults, guarded.guard
    faulty = replace(guarded, guard=None)
    path = launches.setdefault("robust_mlp", {"weighted_update": 0, "weighted_update_leaves": 0,
                                              "block_prefix_update": 0})

    def run(cfg, src=setup.clients):
        return run_generalized_async_sgd(setup.params, src, cfg, eval_fn=setup.eval_fn)

    def k2_run(label, cfg, rows, src=setup.clients):
        wu.reset_launches()
        out, wall = _timed(lambda: run(cfg, src))
        got = wu.launches["block_prefix_update"]
        path["block_prefix_update"] += got
        check(got == rows, f"{label}: K2 launches {got} == block rows {rows}")
        return out, wall

    def finite(w) -> bool:
        return all(bool(torch.isfinite(v).all()) for v in w.values())

    def same(a, b) -> bool:
        return all(torch.equal(a[k], b[k]) for k in a)

    # the stream every fault run replays, and what its counters must read
    stream = export_stream(SimConfig(mu=base.mu, p=base.p, C=C, T=T, seed=base.seed, fault=fault))
    scale = step_scales(stream, base.eta, base.p, "importance")
    stale = (stream.delay_steps > guard.stale_cutoff) & (scale != 0)
    live = (scale != 0) & ~stale
    kinds = np.bincount(stream.kind, minlength=4)
    n_stale = int(stale.sum())
    rows = blocked_inputs(EventBlocks.from_stream(stream, E, cut_every=every), scale,
                          every)[0].shape[0]
    print(f"robust MLP stream n={base.n} C={C} T={T}: kinds (complete, crash, timeout, flip) "
          f"{kinds.tolist()}, {n_stale} of {int((scale != 0).sum())} completions staler than "
          f"{guard.stale_cutoff} steps, {int((stream.slot == C).sum())} events on the trash "
          f"slot; blocked E={E}: {rows} rows")

    def counters(label, tr, rejects=0):
        x = tr.extras
        check(np.array_equal(x["kind_count"], kinds) and x["stale_drops"] == n_stale
              and x["guard_rejects"] == rejects,
              f"{label}: kind_count {x['kind_count'].tolist()} == the stream's, stale_drops "
              f"{x['stale_drops']} == {n_stale} from delay_steps and the scales, guard_rejects "
              f"{x['guard_rejects']} == {rejects}")

    # per event (flat update) and blocked with K2, faults + guard
    (w_pe, tr_pe), wall_pe = _timed(lambda: run(guarded))
    print(f"robust MLP per event, faults + guard: {wall_pe:.3f} s ({T / wall_pe:.1f} events/s), "
          f"acc {tr_pe.eval_values}")
    counters("robust MLP per event", tr_pe)
    check(finite(w_pe) and len(tr_pe.eval_values) == T // every
          and bool(np.isfinite(tr_pe.eval_values).all()),
          f"robust MLP per event: weights finite, {T // every} finite eval points")
    (w_bl, tr_bl), wall_bl = k2_run(f"robust MLP blocked E={E}",
                                    replace(guarded, update="pallas", block_size=E), rows)
    print(f"robust MLP blocked E={E} K2, faults + guard: {wall_bl:.3f} s ({T / wall_bl:.1f} "
          f"events/s), acc {tr_bl.eval_values}")
    counters(f"robust MLP blocked E={E} K2", tr_bl)
    w_j, tr_j = run(replace(guarded, update="jnp", block_size=E))
    check(same(w_bl, w_j) and tr_bl.eval_values == tr_j.eval_values
          and tr_bl.extras["guard_rejects"] == tr_j.extras["guard_rejects"],
          f"robust MLP blocked K2 vs update=\"jnp\": weights and curve bitwise (max gap "
          f"{_tree_gap(w_bl, w_j):.3e})")
    dacc = _acc_gap(tr_bl.eval_values, tr_pe.eval_values)
    check(dacc <= 10 / 2048, f"robust MLP blocked vs per event: accuracy gap {dacc:.5f} <= 10/2048")
    del w_j

    # K1 per event under faults (no guard: it needs the flat update)
    wu.reset_launches()
    (w_k1, tr_k1), wall = _timed(lambda: run(replace(faulty, update="pallas")))
    _k1_counts(path, "robust MLP per event (faults)", T, 6)
    print(f"robust MLP per event K1, faults: {wall:.3f} s ({T / wall:.1f} events/s)")
    w_f, tr_f = run(faulty)
    gap = _tree_gap(w_k1, w_f)
    check((same(w_k1, w_f) or gap <= 1e-5)
          and np.array_equal(tr_k1.extras["kind_count"], kinds),
          f"robust MLP per event K1 vs the flat update under faults: bitwise {same(w_k1, w_f)} "
          f"(max gap {gap:.3e} <= 1e-5), kind_count the stream's")
    del w_k1, w_f

    # a gradient that spikes every 50th step and is NaN at one live step
    steps = np.arange(T)
    nan_step = int(next(k for k in range(T // 2, T)
                        if live[k] and k % ROBUST_SPIKE_EVERY != ROBUST_SPIKE_EVERY - 1))
    injected = (steps % ROBUST_SPIKE_EVERY == ROBUST_SPIKE_EVERY - 1) | (steps == nan_step)
    expect = int((injected & live).sum())
    spiky = _Spiky(setup.clients, nan_step)
    (w_s, tr_s), wall = _timed(lambda: run(guarded, spiky))
    print(f"robust MLP spikes (every {ROBUST_SPIKE_EVERY}th step, NaN at {nan_step}) per event: "
          f"{wall:.3f} s, rejects {tr_s.extras['guard_rejects']}, acc {tr_s.eval_values}")
    counters("robust MLP spikes per event", tr_s, rejects=expect)
    check(finite(w_s), "robust MLP spikes per event: weights finite")
    (w_sb, tr_sb), wall = k2_run(f"robust MLP spikes blocked E={E}",
                                 replace(guarded, update="pallas", block_size=E), rows, spiky)
    counters(f"robust MLP spikes blocked E={E} K2", tr_sb, rejects=expect)
    check(finite(w_sb), f"robust MLP spikes blocked E={E} K2: weights finite")
    (w_o, _), _ = k2_run(f"robust MLP spikes blocked E={E}, no guard",
                         replace(faulty, update="pallas", block_size=E), rows, spiky)
    big = max(float(v.abs().max()) for v in w_o.values())
    check(not finite(w_o) or big > 1e4,
          f"robust MLP spikes without the guard: weights finite {finite(w_o)}, max |w| {big:.3e} "
          "(non-finite or > 1e4)")
    del w_s, w_sb, w_o

    # scenarios, per event and blocked with K2
    for name in ROBUST_SCENARIOS:
        es = export_stream(SimConfig(mu=base.mu, p=base.p, C=C, T=T, seed=base.seed,
                                     scenario=get_scenario(name)))
        kinds6 = np.bincount(es.kind, minlength=6)
        srows = blocked_inputs(EventBlocks.from_stream(es, E, cut_every=every),
                               step_scales(es, base.eta, base.p, "importance"), every)[0].shape[0]
        for label, cfg in (("per event", replace(base, scenario=name)),
                           (f"blocked E={E} K2", replace(base, scenario=name, update="pallas",
                                                          block_size=E))):
            if "K2" in label:
                (w, tr), wall = k2_run(f"robust MLP {name} {label}", cfg, srows)
            else:
                (w, tr), wall = _timed(lambda: run(cfg))
            print(f"robust MLP {name} {label}: {wall:.3f} s ({T / wall:.1f} events/s), kinds "
                  f"{tr.extras['kind_count'].tolist()}, acc {tr.eval_values}")
            check(np.array_equal(tr.extras["kind_count"], kinds6) and finite(w)
                  and len(tr.eval_values) == T // every
                  and bool(np.isfinite(tr.eval_values).all()),
                  f"robust MLP {name} {label}: kind_count == the stream's over 6 kinds, weights "
                  f"and {T // every} eval points finite")

    # the blocked checkpointed run: the kill-and-resume children's reference
    d_full, d_pe = CKPT_ROOT / "mlp_full", CKPT_ROOT / "mlp_per_event"
    ec.reset_saves()
    blocked_ck = replace(guarded, update="pallas", block_size=E, ckpt_dir=str(d_full),
                         ckpt_every=ROBUST_CKPT_EVERY)
    (w_ck, tr_ck), wall_ck = k2_run("robust MLP blocked, checkpointed", blocked_ck, rows)
    saves = _print_saves("robust MLP blocked")
    print(f"robust MLP blocked E={E} K2: {T / wall_ck:.1f} events/s checkpointed every "
          f"{ROBUST_CKPT_EVERY} ({len(saves)} saves), {T / wall_bl:.1f} without")
    check(same(w_ck, w_bl) and tr_ck.eval_values == tr_bl.eval_values
          and _same_extras(tr_ck.extras, tr_bl.extras),
          "robust MLP blocked: the uninterrupted checkpointed run bitwise the un-checkpointed "
          f"run (max gap {_tree_gap(w_ck, w_bl):.3e})")
    ref = dict(w={k: v.cpu().numpy() for k, v in w_ck.items()}, evals=tr_ck.eval_values,
               gcnt=[tr_ck.extras["guard_rejects"], tr_ck.extras["stale_drops"]])
    # phase 20 holds the device stream's faulted MLP runs to these curves
    _SHARED["robust_host_curves"] = [tr_pe.eval_values, tr_bl.eval_values, tr_k1.eval_values]

    # per event: truncate and resume in this process
    ec.reset_saves()
    pe_ck = replace(guarded, ckpt_dir=str(d_pe), ckpt_every=ROBUST_CKPT_EVERY)
    (w_pc, tr_pc), wall_pc = _timed(lambda: run(pe_ck))
    _print_saves("robust MLP per event")
    print(f"robust MLP per event: {T / wall_pc:.1f} events/s checkpointed every "
          f"{ROBUST_CKPT_EVERY}, {T / wall_pe:.1f} without")
    check(same(w_pc, w_pe) and tr_pc.eval_values == tr_pe.eval_values,
          "robust MLP per event: the checkpointed run bitwise the un-checkpointed run")
    left = _truncate_ckpts(d_pe, 2 * ROBUST_CKPT_EVERY)
    (w_pr, tr_pr), wall = _timed(lambda: run(replace(pe_ck, resume=True)))
    check(left[-1] == 2 * ROBUST_CKPT_EVERY and same(w_pr, w_pc)
          and tr_pr.eval_values == tr_pc.eval_values and _same_extras(tr_pr.extras, tr_pc.extras),
          f"robust MLP per event truncated to step {left[-1]} and resumed ({wall:.3f} s): "
          "weights, curve and counters bitwise")
    shutil.rmtree(d_full, ignore_errors=True)
    shutil.rmtree(d_pe, ignore_errors=True)
    return ref


def _robust_matrix(dev, launches: dict) -> None:
    """18., `run_matrix` under a scenario over phase 17's 27 cells, blocked,
    and K2 across the cells on the same stacked inputs (launches under
    ``launches["robust_matrix"]``)."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.engine_scan import jit_runner
    from repro_torch.core.scenario import get_scenario
    from repro_torch.data.pipeline import FederatedClassification
    from repro_torch.fl.engine import _cached_fl_setup, run_experiment, run_matrix
    from repro_torch.kernels import weighted_update as wu

    flc = FLConfig(n_clients=MATRIX_N, concurrency=MATRIX_C, server_steps=MATRIX_T,
                   engine="scan", device=dev.type)
    T, every, E, name = MATRIX_T, MATRIX_EVAL, MATRIX_E, ROBUST_MATRIX_SCENARIO
    grid = tuple(len(MATRIX_GRID[k]) for k in ("seeds", "policies", "speed_ratios"))
    B = int(np.prod(grid))
    data = FederatedClassification(n_clients=MATRIX_N, seed=flc.seed)
    m, wall = _timed(lambda: run_matrix(flc, data=data, block_size=E, scenario=name,
                                        eta=MATRIX_ETA, eval_every=every, **MATRIX_GRID))
    acc = np.asarray(m.eval_acc)
    print(f"run_matrix scenario={name!r} blocked E={E}, {B} cells: {wall:.3f} s, "
          f"{B * T / wall:.1f} events/s summed; final acc (seed-mean) "
          f"{np.asarray(m.final_acc).mean(axis=0).round(4).tolist()}")
    check(acc.shape == (*grid, T // every) and bool(np.isfinite(acc).all()),
          f"run_matrix scenario={name!r}: {B} finite curves of {T // every} points")
    s_i, p_i, h_i = MATRIX_CELL
    one = replace(flc, seed=MATRIX_GRID["seeds"][s_i], sampling=MATRIX_GRID["policies"][p_i],
                  speed_ratio=MATRIX_GRID["speed_ratios"][h_i], block_size=E, scenario=name)
    r = run_experiment(one, "gen_async", eta=MATRIX_ETA, eval_every=every, data=data)
    dacc = _acc_gap(list(r.eval_acc), list(acc[MATRIX_CELL]))
    check(np.array_equal(r.eval_times, m.eval_times[MATRIX_CELL]) and dacc <= 10 / 2048,
          f"run_matrix scenario={name!r} cell {MATRIX_CELL} vs run_experiment alone: eval_times "
          f"bitwise {np.array_equal(r.eval_times, m.eval_times[MATRIX_CELL])}, accuracy gap "
          f"{dacc:.5f} <= 10/2048; kinds {r.extras['kind_count'].tolist()}")
    setup = _cached_fl_setup(data, flc.seed, None, device=dev)
    _, bl, layout = _matrix_inputs(flc, MATRIX_GRID, MATRIX_ETA, every, E, dev,
                                   scenario=get_scenario(name))
    rows = bl[0].shape[1]
    wu.reset_launches()
    (w_b, ev_b), wall = _timed(lambda: jit_runner(
        setup.clients.device_grad, MATRIX_C, eval_fn=setup.eval_fn, block_size=E,
        kernel="pallas", vmap_streams=True)(setup.params, *bl, **layout))
    got = wu.launches["block_prefix_update"]
    launches.setdefault("robust_matrix", {})["block_prefix_update"] = got
    check(got == rows, f"run_matrix scenario={name!r} K2 across cells: launches {got} == block "
          f"rows {rows} ({B * T / wall:.1f} events/s summed)")
    check(np.array_equal(ev_b.cpu().numpy(), acc.reshape(B, -1)),
          f"run_matrix scenario={name!r}: K2 across cells gives run_matrix's curves bitwise")
    del w_b, setup, data
    torch.cuda.empty_cache()


def _robust_mamba(dev, launches: dict) -> None:
    """18., Mamba2-130M at full width and depth: phase 10's blocked E=4 run
    with faults, the guard, a bf16 ring and checkpoints every
    ``ROBUST_MAMBA_CKPT_EVERY`` events, then truncated to its first
    checkpoint and resumed (launches under
    ``launches["robust_mamba2"]``)."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import engine_ckpt as ec
    from repro_torch.core.async_sgd import ServerConfig, run_generalized_async_sgd
    from repro_torch.core.engine_scan import blocked_inputs, step_scales
    from repro_torch.core.queue_sim import EventBlocks, SimConfig, export_stream
    from repro_torch.data.pipeline import make_client_speeds
    from repro_torch.fl.engine import _cached_fl_setup, sampling_for
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.kernels import weighted_update as wu

    part = _Part("robust Mamba2 (phase 18)")
    task = _mamba_task(dev)
    nL, T, every, E, C = task.cfg.num_layers, ROBUST_MAMBA_T, LM_EVAL, MAMBA_E, MAMBA_C
    flc = FLConfig(n_clients=LM_N, concurrency=C, server_steps=T, sampling="optimal",
                   speed_ratio=10.0, engine="scan", device=dev.type)
    setup = _cached_fl_setup(None, flc.seed, task, n_clients=LM_N, device=dev)
    mu = make_client_speeds(LM_N, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
    p = sampling_for(flc, mu)
    fault, guard = _robust_settings(C)
    d = ROBUST_MAMBA_CKPT_ROOT / "mamba2"
    shutil.rmtree(d, ignore_errors=True)
    base = ServerConfig(n=LM_N, C=C, T=T, eta=0.05, mu=mu, p=p, seed=flc.seed, eval_every=every,
                        engine="scan", weighting="importance", update="pallas", block_size=E,
                        snapshot_dtype="bfloat16", faults=fault, guard=guard, ckpt_dir=str(d),
                        ckpt_every=ROBUST_MAMBA_CKPT_EVERY, device=dev.type)
    stream = export_stream(SimConfig(mu=mu, p=p, C=C, T=T, seed=flc.seed, fault=fault))
    scale = step_scales(stream, base.eta, p, "importance")
    stale = (stream.delay_steps > guard.stale_cutoff) & (scale != 0)
    kinds = np.bincount(stream.kind, minlength=4)
    lay = blocked_inputs(EventBlocks.from_stream(stream, E, cut_every=every), scale, every)
    rows, G, evals = lay[0].shape[0], lay[5], T // every
    path = launches.setdefault("robust_mamba2", {"block_prefix_update": 0, "ssd_scan": 0})
    run = lambda c: run_generalized_async_sgd(setup.params, setup.clients, c,  # noqa: E731
                                              eval_fn=setup.eval_fn)
    free = lambda: shutil.disk_usage(str(ROBUST_MAMBA_CKPT_ROOT.parent)).free / 2**30  # noqa: E731

    def counted(label, c, want_k2, want_evals):
        wu.reset_launches()
        k4.reset_launches()
        ec.reset_saves()
        out, wall = _timed(lambda: run(c))
        k2, n4 = wu.launches["block_prefix_update"], k4.launches["ssd_scan"]
        path["block_prefix_update"] += k2
        path["ssd_scan"] += n4
        check(k2 == want_k2 and n4 == nL * (want_k2 + want_evals),
              f"{label}: K2 launches {k2} == block rows {want_k2}, K4 launches {n4} == {nL} x "
              f"({want_k2} block rows + {want_evals} evals)")
        return out, wall

    disk0 = free()
    torch.cuda.reset_peak_memory_stats()
    (w, tr), wall = counted("robust Mamba2 blocked, checkpointed", base, rows, evals)
    saves = _print_saves("robust Mamba2")
    peak = torch.cuda.max_memory_allocated() / 2**30
    disk1 = free()
    print(f"robust Mamba2 blocked E={E} K4 + K2, bf16 ring, faults + guard, checkpointed every "
          f"{ROBUST_MAMBA_CKPT_EVERY}: {wall:.3f} s ({T / wall:.3f} events/s, "
          f"{T * LM_BATCH * LM_SEQ / wall:.1f} tokens/s), {len(saves)} saves, kinds "
          f"{tr.extras['kind_count'].tolist()}, rejects {tr.extras['guard_rejects']}, stale "
          f"{tr.extras['stale_drops']}, loss {tr.eval_values}; peak device memory {peak:.3f} GiB; "
          f"free disk {disk0:.2f} -> {disk1:.2f} GiB")
    check(len(tr.eval_values) == evals and bool(np.isfinite(tr.eval_values).all())
          and np.array_equal(tr.extras["kind_count"], kinds)
          and tr.extras["stale_drops"] == int(stale.sum()),
          f"robust Mamba2: {evals} finite eval points, kind_count the stream's, stale_drops "
          f"{tr.extras['stale_drops']} == {int(stale.sum())}")
    w_full = _flat_cpu(w)
    del w
    torch.cuda.empty_cache()
    left = _truncate_ckpts(d, ROBUST_MAMBA_CKPT_EVERY)
    done_rows = (ROBUST_MAMBA_CKPT_EVERY // every) * G
    (w2, tr2), wall2 = counted("robust Mamba2 resumed", replace(base, resume=True),
                               rows - done_rows, evals - ROBUST_MAMBA_CKPT_EVERY // every)
    check(left == [ROBUST_MAMBA_CKPT_EVERY] and torch.equal(_flat_cpu(w2), w_full)
          and tr2.eval_values == tr.eval_values and _same_extras(tr2.extras, tr.extras),
          f"robust Mamba2 truncated to step {left} and resumed ({wall2:.3f} s): weights, loss "
          "curve and counters bitwise the uninterrupted run's")
    del w2, setup
    shutil.rmtree(d, ignore_errors=True)
    print(f"robust Mamba2: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB over both runs; free disk {free():.2f} GiB after deleting the checkpoints")
    part.end()
    torch.cuda.empty_cache()


def phase_robust(dev, launches: dict) -> None:
    """18. Faults, the divergence guard, scenarios and kill-and-resume
    checkpointing on the host stream, the MLP parts (see the module
    docstring; Mamba2's is `phase_robust_mamba`).  The kill-and-resume
    children run one after the other on a thread beside the MLP and matrix
    parts (their start-up is mostly host time)."""
    from repro_torch.ckpt import checkpoint as ck

    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    CKPT_ROOT.mkdir(parents=True)
    d_kill = CKPT_ROOT / "mlp_killed"

    def children():
        killed = _run_robust_child(d_kill, "kill")
        left = ck.available_steps(str(d_kill))
        return killed, left, _run_robust_child(d_kill, "resume")

    with ThreadPoolExecutor(1) as pool:
        both = pool.submit(children)
        ref = _robust_mlp(dev, launches)
        _robust_matrix(dev, launches)
        (p1, wall1), left, (p2, wall2) = both.result()
    print(f"robust MLP kill-and-resume children: the killed child exited {p1.returncode} after "
          f"{wall1:.3f} s and left steps {left}; the resumed child exited {p2.returncode} after "
          f"{wall2:.3f} s")
    for p in (p1, p2):
        if p.returncode not in (0, -signal.SIGKILL):
            print(p.stderr[-4000:], file=sys.stderr)
    check(p1.returncode == -signal.SIGKILL and left == [ROBUST_CKPT_EVERY, 2 * ROBUST_CKPT_EVERY]
          and p2.returncode == 0,
          f"robust MLP child SIGKILLed after its second save (steps left {left}), a fresh "
          "child resumed")
    if p2.returncode == 0:
        res = np.load(d_kill / "result.npz")
        bitwise = all(np.array_equal(res[k], v) for k, v in ref["w"].items())
        check(bitwise and res["evals"].tolist() == ref["evals"]
              and res["gcnt"].tolist() == ref["gcnt"],
              "robust MLP killed and resumed in fresh processes: final weights, eval curve and "
              "guard counter bitwise the uninterrupted checkpointed run's")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)


def phase_robust_mamba(dev, launches: dict) -> None:
    """18., Mamba2-130M under faults, the guard and checkpoints
    (`_robust_mamba`), its checkpoints under their own root."""
    shutil.rmtree(ROBUST_MAMBA_CKPT_ROOT, ignore_errors=True)
    ROBUST_MAMBA_CKPT_ROOT.mkdir(parents=True)
    _robust_mamba(dev, launches)
    shutil.rmtree(ROBUST_MAMBA_CKPT_ROOT, ignore_errors=True)


# ------------------------------------------------------------------ #
# 19. the device event stream, its control plane and adaptive sampling
# ------------------------------------------------------------------ #
def _fifo_ok(J, K, slot, delay, nodes, n: int, C: int) -> bool:
    """`tests/test_stream_device.py`'s replay check of an exported stream:
    FIFO completions, C - 1 tasks in flight at each completion (Lemma 9),
    every freed slot reused once, and the stream's delays those of an
    exact recount."""
    fifo = [[] for _ in range(n)]
    for s, node in enumerate(nodes):
        fifo[int(node)].append((0, s))
    for k in range(len(J)):
        j, k_new, s = int(J[k]), int(K[k]), int(slot[k])
        if not fifo[j]:
            return False
        disp_step, disp_slot = fifo[j].pop(0)
        if disp_slot != s or int(delay[k]) != k - disp_step:
            return False
        if sum(len(q) for q in fifo) != C - 1:
            return False
        fifo[k_new].append((k + 1, s))
    return sum(len(q) for q in fifo) == C


def _same_stream(label: str, a, b) -> None:
    """Two `stream_device.scan_draws` results (the card's, the CPU's on the
    same draws): J, K, slot, delay (and a fault or scenario stream's kind)
    and the integer statistics equal, the times and the float statistics
    within 1e-6 relative."""
    (_, ea, sa), (_, eb, sb) = a, b
    tagged = len(ea) > 5
    ints = all(torch.equal(ea[i].cpu(), eb[i].cpu()) for i in (0, 1, 3, 4, 5)[:4 + tagged]) and all(
        torch.equal(getattr(sa, f).cpu(), getattr(sb, f).cpu())
        for f in ("occ_sum", "comp", "slot_step") + (("kind_count",) if tagged else ()))
    rel = max(float(((x.cpu().double() - y.cpu().double()).abs()
                     / y.cpu().double().abs().clamp_min(1e-30)).max())
              for x, y in [(ea[2], eb[2])] + [
                  (getattr(sa, f), getattr(sb, f))
                  for f in ("occ_tw", "busy_t", "delay_sum") + (("avail_tw",) if tagged else ())])
    check(ints and rel <= 1e-6, f"{label}: J, K, slot, delay{', kind' if tagged else ''} and the "
          f"integer statistics equal the CPU's on the same draws; times and float statistics "
          f"within {rel:.2e} <= 1e-6 relative")


def _stream_inputs(mu, p):
    """Phase 19 (a)'s inputs, drawn on the CPU: ``(args, u_disp, args_cells)``
    for `stream_device.scan_draws`, one stream of `STREAM_CARD_T` events
    (seed 0) and `CELLS` of `STREAM_CELLS_T` (seeds 1000 + b)."""
    from repro_torch.core import stream_device as sd

    n, C, T = STREAM_N, STREAM_C, STREAM_CARD_T
    f32 = torch.float32
    nodes, ur, ue, ud = sd.draw_uniforms(0, n, C, T, p, device="cpu")
    K = sd.tree_sample(sd.tree_build(torch.tensor(p, dtype=f32)), ud)
    args = (torch.tensor(mu, dtype=f32), nodes, ur, ue, K)
    B, Tb = CELLS, STREAM_CELLS_T
    draws = [sd.draw_uniforms(1000 + b, n, C, Tb, p, device="cpu") for b in range(B)]
    nb, urb, ueb, udb = (torch.stack(a) for a in zip(*draws))
    Kb = sd.tree_sample(sd.tree_build(torch.tensor(p, dtype=f32).expand(B, n)), udb)
    return args, ud, (torch.tensor(mu, dtype=f32).expand(B, n), nb, urb, ueb, Kb)


def _robust_stream_inputs(mu, p):
    """Phase 20 (a)'s inputs, drawn on the CPU: ``([(name, args, ph), ...],
    args_cells)``: the fault stream and the `ROBUST_SCENARIOS` streams of
    `STREAM_CARD_T` events (seed 0; ``ph`` a scenario's phase uniforms) and
    the fault stream over `CELLS` of `STREAM_CELLS_T` (seeds 2000 + b)."""
    from repro_torch.core import stream_device as sd

    n, C, T = STREAM_N, STREAM_C, STREAM_CARD_T
    f32 = torch.float32
    streams = []
    for name in ("fault",) + ROBUST_SCENARIOS:
        nodes, ur, ue, ud, *ph = sd.draw_uniforms(0, n, C, T, p, device="cpu",
                                                  scenario=name != "fault")
        K = sd.tree_sample(sd.tree_build(torch.tensor(p, dtype=f32)), ud)
        streams.append((name, (torch.tensor(mu, dtype=f32), nodes, ur, ue, K), ph))
    B, Tb = CELLS, STREAM_CELLS_T
    draws = [sd.draw_uniforms(2000 + b, n, C, Tb, p, device="cpu") for b in range(B)]
    nb, urb, ueb, udb = (torch.stack(a) for a in zip(*draws))
    Kb = sd.tree_sample(sd.tree_build(torch.tensor(p, dtype=f32).expand(B, n)), udb)
    return streams, (torch.tensor(mu, dtype=f32).expand(B, n), nb, urb, ueb, Kb)


def _robust_mode(name: str, ph, d) -> dict:
    """`stream_device.scan_draws`'s keywords of a phase 20 (a) stream on
    device ``d``."""
    from repro_torch.core import FaultConfig, get_scenario

    if name == "fault":
        return dict(fault=FaultConfig(**ROBUST_FAULT))
    return dict(scenario=get_scenario(name), u_ph=ph[0].to(d), u_phase0=ph[1].to(d))


def _cpu_references(kind: str):
    """The CPU runs the card's streams are held to, in a CPU-only worker
    process (one thread) beside the build: ``"stream"`` phase 19 (a)'s two,
    ``"stream_robust"`` phase 20 (a)'s four, ``"sparse"`` phase 21 (a)'s
    four, ``"serve"`` phase 22 (a)'s two."""
    from repro_torch.core import stream_device as sd
    from repro_torch.data.pipeline import make_client_speeds
    from repro_torch.fl.engine import sampling_for

    os.nice(10)  # below the lanes, which wait for these results much later
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny operations: no gain from threads
    try:
        if kind == "sparse":
            return {r: _sparse_cpu_run(*r) for r in _sparse_runs()}
        if kind == "serve":
            return _serve_cpu_refs()
        flc = _mlp_flc(torch.device("cpu"))
        mu = make_client_speeds(flc.n_clients, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
        p = sampling_for(flc, mu)
        if kind == "stream":
            args, _, argsb = _stream_inputs(mu, p)
            return sd.scan_draws(*args), sd.scan_draws(*argsb)
        streams, argsb = _robust_stream_inputs(mu, p)
        return ({name: sd.scan_draws(*args, **_robust_mode(name, ph, "cpu"))
                 for name, args, ph in streams},
                sd.scan_draws(*argsb, fault=_robust_mode("fault", None, "cpu")["fault"]))
    finally:
        torch.set_num_threads(threads)


def _start_cpu_references(groups) -> None:
    """Start `_cpu_references` for the phase groups of this process, and
    phase 21's shards (`_build_sparse_shards`), in up to three spawned
    CPU-only worker processes beside the build and the first phases;
    `_cpu_refs` waits for them when a phase first needs one."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    kinds = [k for k in ("sparse", "stream", "stream_robust", "serve") if k in groups]
    if not kinds:
        return
    pool = ProcessPoolExecutor(min(3, len(kinds) + ("sparse" in groups)),
                               mp_context=multiprocessing.get_context("spawn"))
    jobs = {}
    if "sparse" in groups:  # the longest job first
        jobs["sparse_shards"] = pool.submit(_build_sparse_shards, SPARSE_MLP_N, 0, SPARSE_SHARD)
    jobs.update({k: pool.submit(_cpu_references, k) for k in kinds})
    _SHARED["cpu_workers"] = pool, jobs


def _collect_cpu_references() -> None:
    """Wait for the workers of `_start_cpu_references`, keep their results
    for `_cpu_refs` and stop the workers."""
    started = _SHARED.pop("cpu_workers", None)
    if started is None:
        return
    pool, jobs = started
    t0 = time.perf_counter()
    _SHARED["cpu_refs"] = {k: job.result() for k, job in jobs.items()}
    pool.shutdown()
    print(f"the CPU workers' results: waited {time.perf_counter() - t0:.1f} s", flush=True)


def _cpu_refs(kind: str):
    """A result of the CPU workers: `_cpu_references(kind)`, or the seconds
    `_build_sparse_shards` took (``"sparse_shards"``)."""
    _collect_cpu_references()
    return _SHARED["cpu_refs"].pop(kind)


def _stream_card(dev, mu, p, setup) -> dict:
    """19 (a): the stream on the card against the CPU, its FIFO law, no host
    sync in a chunk of the stream or of the fused runner (the MLP's
    ``setup``), events/s against `export_stream`, device ops an event."""
    from repro_torch.core import stream_device as sd
    from repro_torch.core.async_sgd import _device_grad_fn
    from repro_torch.core.engine_scan import make_fused_runner
    from repro_torch.core.queue_sim import SimConfig, export_stream

    n, C, T = STREAM_N, STREAM_C, STREAM_CARD_T
    f32 = torch.float32
    args, ud, argsb = _stream_inputs(mu, p)
    nodes, ur, ue, K = args[1:]
    t0 = time.perf_counter()
    cpu, cpub = _cpu_refs("stream")
    card, wall = _timed(lambda: sd.scan_draws(*(a.to(dev) for a in args)))
    _same_stream(f"stream on the card n={n} C={C} T={T}", card, cpu)
    _, (J, Kg, _, slot, delay), _ = card
    check(_fifo_ok(J.cpu(), Kg.cpu(), slot.cpu(), delay.cpu(), nodes, n, C),
          f"the card's stream passes the FIFO / Lemma-9 / delay replay check ({T} events)")
    # B cells on the cell axis
    B, Tb = CELLS, STREAM_CELLS_T
    cardb, wall_b = _timed(lambda: sd.scan_draws(*(a.to(dev) for a in argsb)))
    _same_stream(f"stream on the card, {B} cells on the cell axis, T={Tb}", cardb, cpub)
    t_cmp = time.perf_counter() - t0
    # one chunk of the fused runner's stream under the sync check
    state, _ = sd.stream_init(nodes.to(dev)[None], n, C)
    stats = sd.stats_init(n, C, cells=1, device=dev)
    cst = sd._Consts((1,), C, dev)
    L = STREAM_REFRESH
    mu_g, p_g = torch.tensor(mu, dtype=f32, device=dev)[None], torch.tensor(p, dtype=f32,
                                                                             device=dev)[None]
    ur_g, ue_g, ud_g = (a.to(dev)[None, :L] for a in (ur, ue, ud))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        Kc = sd.tree_sample(sd.tree_build(p_g), ud_g)
        sd._advance(state, stats, mu_g, -torch.log1p(-ue_g), ur_g, Kc, 0, cst)
        synced = False
    except RuntimeError as e:
        synced = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(synced is False, f"a chunk of {L} stream events makes no host sync "
          f"(set_sync_debug_mode('error')){'' if synced is False else ': ' + synced[:200]}")
    # one chunk of the fused runner itself: importance-weighted and adaptive
    # (dispatch-time slot scales, the MLP's per-event replay, ctrl_refresh at
    # the chunk's end)
    fused = make_fused_runner(_device_grad_fn(setup.clients), n, C, L, weighting="importance",
                              adaptive=True, refresh_every=L)
    draws = sd.draw_uniforms(5, n, C, L, p_g[0], device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w_f, _, ex_f = fused.from_draws(setup.params, mu_g[0], p_g[0], 0.05, *draws)
        synced = False
    except RuntimeError as e:
        synced = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ok = synced is False and all(bool(torch.isfinite(v).all()) for v in w_f.values())
    check(ok and tuple(ex_f["p_traj"].shape) == (1, n),
          f"one chunk of the fused runner ({L} events, importance-weighted, adaptive: slot "
          "scales, the MLP's per-event replay and ctrl_refresh) makes no host sync "
          f"(set_sync_debug_mode('error')){'' if synced is False else ': ' + synced[:200]}")
    # events/s: generate_stream on the card against the host simulator
    _, w_gen = _timed(lambda: sd.generate_stream(mu, p, C, T, seed=0, device=dev))
    t0 = time.perf_counter()
    export_stream(SimConfig(mu=mu, p=p, C=C, T=T, seed=0))
    w_exp = time.perf_counter() - t0
    Tp = STREAM_PROFILE_T
    short = (mu_g[0], nodes.to(dev), *(a.to(dev)[:Tp] for a in (ur, ue, K)))
    dms, wms, _, ops = profile(lambda: sd.scan_draws(*short))
    idle = None if dms is None else 1.0 - dms / wms
    print(f"stream n={n} C={C} T={T}: scan on the card {wall:.3f} s ({T / wall:.1f} events/s), "
          f"{B} cells x {Tb} on the cell axis {wall_b:.3f} s ({B * Tb / wall_b:.1f} events/s "
          f"summed); generate_stream {T / w_gen:.1f} events/s vs export_stream "
          f"{T / w_exp:.1f} events/s; profile ({Tp} events): {ops / Tp:.1f} device ops/event, "
          f"wall {wms / Tp:.4f} ms/event, device busy "
          f"{None if dms is None else round(dms / Tp, 6)} ms/event, idle share {idle}; the "
          f"card-against-CPU checks took {t_cmp:.1f} s, (a) {time.perf_counter() - t0:.1f} s")
    return dict(gen_eps=T / w_gen, export_eps=T / w_exp, ops=ops / Tp)


def _stream_mlp(dev, launches: dict, data) -> dict:
    """19 (b): the full-width MLP on the device stream, five ways, each
    against the host stream's accuracy range at three seeds (on ``data``,
    the slice's `FederatedClassification`)."""
    from repro_torch.core.async_sgd import run_fedbuff, run_generalized_async_sgd
    from repro_torch.core.sampling import bound_for_p
    from repro_torch.core.theory import BoundConstants
    from repro_torch.fl.engine import run_experiment
    from repro_torch.kernels import weighted_update as wu

    path = launches.setdefault("stream_mlp", {"weighted_update": 0})
    flc = replace(_mlp_flc(dev), stream="device")
    T = flc.server_steps
    # the entry point is the per-event plain run: the same setup (cached on
    # ``data``), p and draws (seed 0) as the runs below
    r, wall = _timed(lambda: run_experiment(flc, "gen_async", eval_every=500, data=data))
    w_pe = r.final_params
    accs = {"per event (run_experiment)": (list(r.eval_acc), T / wall, "gen_async")}
    setup, base = _mlp_setup(dev, data)
    dbase = replace(base, stream="device")
    run = lambda c: run_generalized_async_sgd(setup.params, setup.clients, c,  # noqa: E731
                                              eval_fn=setup.eval_fn)
    fedbuff = lambda c: run_fedbuff(setup.params, setup.clients,  # noqa: E731
                                    replace(c, weighting="plain"), Z=FEDBUFF_Z,
                                    eval_fn=setup.eval_fn)
    wu.reset_launches()
    (w_k1, tr), wall = _timed(lambda: run(replace(dbase, update="pallas")))
    _k1_counts(path, "MLP device stream per event", T, 6)
    accs["per event K1"] = (tr.eval_values, T / wall, "gen_async")
    gap = _tree_gap(w_k1, w_pe)
    check(gap <= 1e-5, f"MLP device stream: K1 vs the flat update, max weight gap {gap:.3e} "
          "<= 1e-5")
    (w_bl, tr), wall = _timed(lambda: run(replace(dbase, block_size=MLP_E)))
    accs[f"blocked E={MLP_E}"] = (tr.eval_values, T / wall, "gen_async")
    dacc = _acc_gap(tr.eval_values, accs["per event (run_experiment)"][0])
    check(dacc <= 10 / 2048, f"MLP device stream: blocked E={MLP_E} (plain prefix) vs per event "
          f"on the same draws, eval accuracy gap {dacc:.5f} <= 10/2048")
    wu.reset_launches()
    (w_fb, tr), wall = _timed(lambda: fedbuff(replace(dbase, update="pallas")))
    _k1_counts(path, "MLP device stream FedBuff", T, 6)
    accs[f"FedBuff Z={FEDBUFF_Z} K1"] = (tr.eval_values, T / wall, "fedbuff")
    (w_ad, tr_ad), wall = _timed(lambda: run(replace(dbase, adaptive=True,
                                                      refresh_every=STREAM_REFRESH)))
    accs[f"adaptive every {STREAM_REFRESH}"] = (tr_ad.eval_values, T / wall, "gen_async")
    p_fin = tr_ad.extras["p_final"]
    k = BoundConstants(C=base.C, T=T)
    b_ad = bound_for_p(base.mu, p_fin / p_fin.sum(), k)[0]
    b_un = bound_for_p(base.mu, np.full(base.n, 1.0 / base.n), k)[0]
    check(abs(p_fin.sum() - 1.0) <= 1e-5 and b_ad < b_un,
          f"MLP adaptive: p_final sums to {p_fin.sum():.7f}, its Theorem-1 bound {b_ad:.5f} < "
          f"uniform's {b_un:.5f} for the run's mu")
    # the host stream's curves at three seeds (blocked E=8, plain prefix)
    host = {"gen_async": [run(replace(base, seed=s, block_size=MLP_E))[1].eval_values
                          for s in STREAM_SEEDS],
            "fedbuff": [fedbuff(replace(base, seed=s, block_size=MLP_E))[1].eval_values
                        for s in STREAM_SEEDS]}
    for label, (acc, eps, algo) in accs.items():
        at = [curve[len(acc) - 1] for curve in host[algo]]
        lo, hi = min(at), max(at)
        print(f"MLP device stream {label}: {eps:.1f} events/s, acc {acc}")
        check(len(acc) >= 2 and bool(np.isfinite(acc).all()) and acc[-1] > acc[0]
              and lo - 0.02 <= acc[-1] <= hi + 0.02,
              f"MLP device stream {label}: accuracy rises {acc[0]:.4f} -> {acc[-1]:.4f}, within "
              f"the host stream's [{lo:.4f}, {hi:.4f}] at seeds {STREAM_SEEDS} +- 0.02")
    small = replace(dbase, update="pallas", T=STREAM_PROFILE_T, eval_every=0)
    _print_profile(f"MLP device stream per-event K1, T={STREAM_PROFILE_T}", lambda: run(small),
                   STREAM_PROFILE_T)
    del w_pe, w_k1, w_bl, w_fb, w_ad
    return {k: v[1] for k, v in accs.items()}


def _stream_mamba(dev, launches: dict) -> None:
    """19 (c): Mamba2-130M at full width and depth on the device stream,
    per event, K4 + K1."""
    from repro_torch.core import stream_device as sd
    from repro_torch.core.async_sgd import ServerConfig, run_generalized_async_sgd
    from repro_torch.data.pipeline import make_client_speeds
    from repro_torch.configs.base import FLConfig
    from repro_torch.fl.engine import _cached_fl_setup, sampling_for
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.kernels import weighted_update as wu

    part = _Part("Mamba2 device stream (phase 19)")
    task = _mamba_task(dev)
    nL, T = task.cfg.num_layers, STREAM_MAMBA_T
    flc = FLConfig(n_clients=LM_N, concurrency=MAMBA_C, server_steps=T, sampling="optimal",
                   speed_ratio=10.0, engine="scan", stream="device", device=dev.type)
    setup = _cached_fl_setup(None, flc.seed, task, n_clients=LM_N, device=dev)
    mu = make_client_speeds(LM_N, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
    p = sampling_for(flc, mu)
    base = ServerConfig(n=LM_N, C=MAMBA_C, T=T, eta=0.05, mu=mu, p=p, seed=flc.seed,
                        eval_every=LM_EVAL, engine="scan", stream="device", update="pallas",
                        device=dev.type)
    path = launches.setdefault("stream_mamba2", {"weighted_update": 0, "ssd_scan": 0})
    torch.cuda.reset_peak_memory_stats()
    wu.reset_launches()
    k4.reset_launches()
    (w, tr), wall = _timed(lambda: run_generalized_async_sgd(setup.params, setup.clients, base,
                                                             eval_fn=setup.eval_fn))
    _k1_counts(path, "Mamba2 device stream", T, MAMBA_LEAVES)
    n4 = k4.launches["ssd_scan"]
    path["ssd_scan"] += n4
    forwards = _forwards(T, LM_EVAL)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"Mamba2 device stream per event, K4 + K1, n={LM_N} C={MAMBA_C} T={T}: {wall:.3f} s, "
          f"{T / wall:.3f} events/s, {T * LM_BATCH * LM_SEQ / wall:.1f} tokens/s, K4 launches "
          f"{n4}, loss {tr.eval_values}; peak device memory {peak:.3f} GiB")
    check(n4 == nL * forwards, f"Mamba2 device stream: K4 launches {n4} == {nL} x {forwards} "
          "forwards")
    check(len(tr.eval_values) == T // LM_EVAL and bool(np.isfinite(tr.eval_values).all()),
          f"Mamba2 device stream: {T // LM_EVAL} finite eval points")
    # the run's events: its own draws again (the generator is seeded from cfg.seed)
    nodes, ur, ue, ud = sd.draw_uniforms(flc.seed, LM_N, MAMBA_C, T, p, device=dev)
    K = sd.tree_sample(sd.tree_build(torch.tensor(p, dtype=torch.float32, device=dev)), ud)
    _, (J, _, _, _, _), _ = sd.scan_draws(torch.tensor(mu, dtype=torch.float32, device=dev),
                                          nodes, ur, ue, K)
    J = J.cpu().numpy()
    before, after = _train_loss(setup, setup.params, J), _train_loss(setup, w, J)
    check(after < before, f"Mamba2 device stream: the clients' training loss over the run's {T} "
          f"trained minibatches falls: {before:.5f} -> {after:.5f}")
    del w, setup
    part.end()
    torch.cuda.empty_cache()


def _stream_matrix(dev) -> None:
    """19 (d): phase 17's 27-cell MLP matrix on the device stream (T cut to
    `STREAM_MATRIX_T`), per event, plain and adaptive."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.sampling import bound_for_p
    from repro_torch.core.theory import BoundConstants
    from repro_torch.data.pipeline import FederatedClassification, make_client_speeds
    from repro_torch.fl.engine import run_matrix

    flc = FLConfig(n_clients=MATRIX_N, concurrency=MATRIX_C, server_steps=MATRIX_T,
                   engine="scan", stream="device", device=dev.type)
    grid = MATRIX_GRID
    T, B = STREAM_MATRIX_T, CELLS
    flc = replace(flc, server_steps=T)
    data = FederatedClassification(n_clients=MATRIX_N, seed=flc.seed)
    mk = dict(grid, eta=MATRIX_ETA, eval_every=MATRIX_EVAL, data=data)
    k = BoundConstants(C=MATRIX_C, T=T)
    # the adaptive matrix refreshes p at each eval point (the eval cadence
    # must be a multiple of the refresh cadence)
    for label, f in (("plain", flc), ("adaptive", replace(flc, adaptive=True,
                                                          refresh_every=MATRIX_EVAL))):
        m, wall = _timed(lambda: run_matrix(f, **mk))
        acc = np.asarray(m.eval_acc)
        print(f"run_matrix(stream='device') {label}, {B} cells n={MATRIX_N} C={MATRIX_C} T={T}: "
              f"{wall:.3f} s, {B * T / wall:.1f} events/s summed over cells; final acc "
              f"(seed-mean, policy x ratio) {np.asarray(m.final_acc).mean(0).round(4).tolist()}")
        shape = tuple(len(grid[k]) for k in ("seeds", "policies", "speed_ratios"))
        check(acc.shape == shape + (T // MATRIX_EVAL,) and bool(np.isfinite(acc).all())
              and bool((acc[..., -1] > acc[..., 0]).all())
              and bool(np.all(np.diff(m.eval_times, axis=-1) >= 0)),
              f"run_matrix(stream='device') {label}: finite curves, accuracy rises in every cell, "
              "eval times monotone")
        if label == "adaptive":
            worse = []
            for (s, pi, h), _ in np.ndenumerate(m.final_acc):
                ratio = grid["speed_ratios"][h]
                if ratio == 1.0:  # equal speeds: uniform is already the optimum
                    continue
                mu = make_client_speeds(MATRIX_N, flc.frac_fast, ratio, seed=flc.seed)
                pf = m.extras["p_final"][s, pi, h]
                if not (bound_for_p(mu, pf / pf.sum(), k)[0]
                        < bound_for_p(mu, np.full(MATRIX_N, 1 / MATRIX_N), k)[0]):
                    worse.append((s, pi, h))
            check(not worse, "run_matrix adaptive: every cell with unequal speeds ends with a "
                  f"Theorem-1 bound below uniform's (cells that do not: {worse})")


def _stream_control(dev, mu, p) -> None:
    """19 (e): MVA on the card against the numpy Buzen; ms per ctrl_refresh."""
    from repro_torch.core import stream_device as sd
    from repro_torch.core.jackson import JacksonNetwork
    from repro_torch.core.theory import BoundConstants

    n, C = STREAM_N, STREAM_C
    mu_g = torch.tensor(mu, dtype=torch.float32, device=dev)
    p_g = torch.tensor(p, dtype=torch.float32, device=dev)
    m, lam = sd.mva_throughput_delays(mu_g, p_g, C)
    net = JacksonNetwork(mu=mu, p=p, C=C)
    want = net.expected_delays()
    rel = float(np.max(np.abs(m.cpu().double().numpy() - want) / np.abs(want)))
    rl = abs(float(lam) / net.throughput() - 1.0)
    check(rel <= 1e-5 and rl <= 1e-5, f"MVA on the card n={n} C={C} vs the numpy Buzen: delays "
          f"{rel:.2e}, throughput {rl:.2e} <= 1e-5 relative")
    rng = np.random.default_rng(0)
    comp = torch.tensor(rng.integers(1, 60, n), device=dev)
    busy = torch.tensor(rng.uniform(5.0, 50.0, n), dtype=torch.float32, device=dev)
    k = BoundConstants(C=C, T=STREAM_T)
    ms = []
    for _ in range(4):
        _, wall = _timed(lambda: sd.ctrl_refresh(p_g, comp, busy, k))
        ms.append(wall * 1e3)
    out = sd.ctrl_refresh(p_g, comp, busy, k)
    check(bool(torch.isfinite(out).all()) and abs(float(out.sum()) - 1.0) <= 1e-5,
          "ctrl_refresh on the card: a finite p summing to 1")
    print(f"ctrl_refresh n={n} C={C} (4 exponentiated-gradient steps through the MVA): "
          f"{float(np.median(ms[1:])):.3f} ms (median of 3 after one warm-up; first "
          f"{ms[0]:.3f} ms)")


def phase_stream(dev, launches: dict) -> None:
    """19. The device event stream, its control plane and adaptive sampling
    (see the module docstring); adds the kernel launches to ``launches``
    under "stream_mlp" (K1) and "stream_mamba2" (K4, K1)."""
    from repro_torch.data.pipeline import FederatedClassification

    t0 = time.perf_counter()
    flc = _mlp_flc(dev)
    data = FederatedClassification(n_clients=flc.n_clients, seed=flc.seed)
    setup, base = _mlp_setup(dev, data)
    mu, p = base.mu, base.p
    _stream_card(dev, mu, p, setup)
    _stream_control(dev, mu, p)
    t1 = time.perf_counter()
    _stream_mlp(dev, launches, data)
    t2 = time.perf_counter()
    _stream_matrix(dev)
    t3 = time.perf_counter()
    with _card_memory(16, "19 (c): Mamba2-130M on the device stream"):
        _stream_mamba(dev, launches)
    t4 = time.perf_counter()
    print(f"phase 19 times: stream and control plane {t1 - t0:.1f} s, MLP {t2 - t1:.1f} s, "
          f"matrix {t3 - t2:.1f} s, Mamba2 {t4 - t3:.1f} s; phase 19 {t4 - t0:.1f} s")


# ------------------------------------------------------------------ #
# 20. faults, the guard, scenarios and checkpoints on the device stream
# ------------------------------------------------------------------ #
def _dev_ckpt_cfg(base, ckpt_dir):
    """Phase 20's checkpointed MLP run: the slice's ServerConfig on the
    device stream, per event with faults and the guard, T cut to
    `ROBUST_DEV_CKPT_T`, a save every `ROBUST_DEV_CKPT_EVERY` events
    (`engine_ckpt.run_checkpointed`)."""
    return replace(_mlp_robust_cfg(base, base.C), stream="device", T=ROBUST_DEV_CKPT_T,
                   ckpt_dir=str(ckpt_dir), ckpt_every=ROBUST_DEV_CKPT_EVERY)


def _ckpt_events(mu, p, C: int, T: int, L: int, seed: int, fault, dev):
    """The events of a checkpointed fused run (`engine_ckpt.run_checkpointed`,
    static p): its initial placement and chunk draws (`engine_ckpt.chunk_seed`),
    K from ``cumsum(p)``, through `stream_device.scan_draws`: ``(J, kind,
    delay)`` as numpy arrays."""
    from repro_torch.core import engine_ckpt as ec
    from repro_torch.core import stream_device as sd

    n = len(mu)
    p_t = torch.tensor(p, dtype=torch.float32, device=dev).reshape(1, n)
    cdf = torch.cumsum(p_t, dim=-1)
    nodes, chunk_draws = ec._port_draws(seed, n, C, p_t[0], "distinct", dev)
    parts = [chunk_draws(c, min(L, T - c * L)) for c in range(-(-T // L))]
    K = torch.cat([torch.clamp_max(torch.searchsorted(cdf, ud[None], right=True), n - 1)[0]
                   for _, _, ud in parts])
    ur, ue = (torch.cat(x) for x in list(zip(*parts))[:2])
    _, ev, _ = sd.scan_draws(torch.tensor(mu, dtype=torch.float32, device=dev), nodes, ur, ue, K,
                             fault=fault)
    return ev[0].cpu().numpy(), ev[5].cpu().numpy(), ev[4].cpu().numpy()


def _robust_dev_card(dev, mu, p) -> None:
    """20 (a): the fault stream and the scenario streams on the card against
    the CPU on the same CPU-drawn uniforms (T=`STREAM_CARD_T`), and the fault
    stream over 27 cells of T=`STREAM_CELLS_T` on the cell axis."""
    from repro_torch.core import FaultConfig
    from repro_torch.core import stream_device as sd

    n, C, T = STREAM_N, STREAM_C, STREAM_CARD_T
    streams, argsb = _robust_stream_inputs(mu, p)
    cpus, cpub = _cpu_refs("stream_robust")
    for name, args, ph in streams:
        scen = name != "fault"
        mode = lambda d, ph=ph, name=name: _robust_mode(name, ph, d)  # noqa: E731
        card, wall = _timed(lambda: sd.scan_draws(*(a.to(dev) for a in args), **mode(dev)))
        _same_stream(f"{name} stream on the card n={n} C={C} T={T}", card, cpus[name])
        kinds = card[2].kind_count.cpu().tolist()
        Tp = STREAM_PROFILE_T
        short = (args[0].to(dev), args[1].to(dev), *(a.to(dev)[:Tp] for a in args[2:]))
        extra = mode(dev)
        if scen:
            extra["u_ph"] = extra["u_ph"][:Tp]
        dms, wms, _, ops = profile(lambda: sd.scan_draws(*short, **extra))
        print(f"{name} stream on the card: {T / wall:.1f} events/s, kinds {kinds}; profile "
              f"({Tp} events): {ops / Tp:.1f} device ops/event, wall {wms / Tp:.4f} ms/event, "
              f"device busy {None if dms is None else round(dms / Tp, 6)} ms/event")
        check(sum(kinds) == T, f"{name} stream: kind counts {kinds} sum to T = {T}")
    B, Tb = CELLS, STREAM_CELLS_T
    cardb, wall_b = _timed(lambda: sd.scan_draws(*(a.to(dev) for a in argsb),
                                                 fault=FaultConfig(**ROBUST_FAULT)))
    _same_stream(f"fault stream on the card, {B} cells on the cell axis, T={Tb}", cardb, cpub)
    print(f"fault stream, {B} cells x {Tb} on the cell axis: {B * Tb / wall_b:.1f} events/s "
          "summed")


def _host_fault_curves(dev, setup, base) -> list:
    """The host stream's eval curves under phase 18's faults and guard at
    the seeds `ROBUST_DEV_SEEDS`, replayed in lockstep on the cell axis
    (`jit_runner(..., vmap_streams=True)`): each seed's `export_stream`
    with its stale completions dropped from the scales, as the host
    replay's guard drops them (`async_sgd._run_scan`); the norm cap, which
    rejects nothing on this MLP, is not on the cell axis."""
    from repro_torch.core.engine_scan import jit_runner, step_scales
    from repro_torch.core.queue_sim import SimConfig, export_stream

    fault, guard = _robust_settings(base.C)
    J, slot, scale = [], [], []
    for s in ROBUST_DEV_SEEDS:
        es = export_stream(SimConfig(mu=base.mu, p=base.p, C=base.C, T=base.T, seed=s, fault=fault,
                                     record_delays=True))
        sc = step_scales(es, base.eta, base.p, "importance")
        J.append(es.J)
        slot.append(es.slot)
        scale.append(np.where((es.delay_steps > guard.stale_cutoff) & (sc != 0), 0.0, sc))
    idx = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)  # noqa: E731
    run = jit_runner(setup.clients.device_grad, base.C, eval_fn=setup.eval_fn,
                     eval_every=base.eval_every, vmap_streams=True)
    (_, ev), wall = _timed(lambda: run(setup.params, idx(J), idx(slot),
                                       torch.as_tensor(np.asarray(scale), dtype=torch.float32,
                                                       device=dev)))
    curves = ev.cpu().numpy().tolist()
    print(f"host stream under faults + guard, seeds {list(ROBUST_DEV_SEEDS)} in lockstep: "
          f"{wall:.3f} s, final acc {[round(c[-1], 4) for c in curves]}")
    return curves


def _robust_dev_mlp(dev, launches: dict, data) -> None:
    """20 (b), (c), (d): the full-width MLP on the device stream under faults
    and the guard (per event, blocked E=8, K1), a spiking / NaN gradient,
    the ``erlang2_onoff`` scenario per event and the 27-cell ``erlang2``
    device matrix.  K1's launches go to ``launches["robust_device_mlp"]``."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import stream_device as sd
    from repro_torch.core.async_sgd import run_generalized_async_sgd
    from repro_torch.core.scenario import get_scenario
    from repro_torch.fl.engine import run_experiment, run_matrix
    from repro_torch.kernels import weighted_update as wu

    path = launches.setdefault("robust_device_mlp", {"weighted_update": 0})
    flc = replace(_mlp_flc(dev), stream="device")
    setup, base = _mlp_setup(dev, data)
    T, every = flc.server_steps, base.eval_every
    fault, guard = _robust_settings(base.C)
    cutoff = guard.stale_cutoff
    dbase = replace(base, stream="device", faults=fault)
    run = lambda c, src=setup.clients: run_generalized_async_sgd(  # noqa: E731
        setup.params, src, c, eval_fn=setup.eval_fn)

    def finite(w) -> bool:
        return all(bool(torch.isfinite(v).all()) for v in w.values())

    def stream_of(T_, **kw):
        """The events a fused run of seed ``base.seed`` replays (its own
        draws, from the same generator): kinds and stale completions."""
        es = sd.generate_stream(base.mu, base.p, base.C, T_, seed=base.seed, device=dev, **kw)
        return es, (es.delay_steps > cutoff) & (es.kind == 0)

    es, stale = stream_of(T, fault=fault)
    kinds = np.bincount(es.kind, minlength=4)
    print(f"robust device MLP stream n={base.n} C={base.C} T={T}: kinds (complete, crash, "
          f"timeout, flip) {kinds.tolist()}, {int(stale.sum())} completions staler than {cutoff} "
          "steps")

    def counters(label, x, rejects=0):
        check(np.array_equal(x["kind_count"], kinds) and int(np.sum(x["kind_count"])) == T
              and int(x["stale_drops"]) == int(stale.sum())
              and int(x["guard_rejects"]) == rejects,
              f"{label}: kind_count {np.asarray(x['kind_count']).tolist()} == the stream's, "
              f"summing to T; stale_drops {int(x['stale_drops'])} == {int(stale.sum())} from the "
              f"stream's delays and scales; guard_rejects {int(x['guard_rejects'])} == {rejects}")

    accs = {}
    r, wall = _timed(lambda: run_experiment(flc, "gen_async", eval_every=every, data=data,
                                            faults=fault, guard=guard))
    accs["per event, faults + guard"] = (list(r.eval_acc), T / wall)
    counters("robust device MLP per event (run_experiment)", r.extras)
    rb, wall = _timed(lambda: run_experiment(replace(flc, block_size=MLP_E), "gen_async",
                                             eval_every=every, data=data, faults=fault,
                                             guard=guard))
    accs[f"blocked E={MLP_E}, faults + guard"] = (list(rb.eval_acc), T / wall)
    counters(f"robust device MLP blocked E={MLP_E} (run_experiment)", rb.extras)
    dacc = _acc_gap(list(rb.eval_acc), list(r.eval_acc))
    check(dacc <= 10 / 2048, f"robust device MLP blocked E={MLP_E} vs per event: accuracy gap "
          f"{dacc:.5f} <= 10/2048")
    # K1 under faults (no guard: it needs the flat update), flips included,
    # at T cut to ROBUST_DEV_K1_T (its stream's own kinds)
    Tk = ROBUST_DEV_K1_T
    kinds_k = np.bincount(stream_of(Tk, fault=fault)[0].kind, minlength=4)
    wu.reset_launches()
    (w_k1, tr_k1), wall = _timed(lambda: run(replace(dbase, T=Tk, update="pallas")))
    _k1_counts(path, "robust device MLP per event (faults)", Tk, 6)
    accs["per event K1, faults"] = (tr_k1.eval_values, Tk / wall)
    w_f, tr_f = run(replace(dbase, T=Tk))
    gap = _tree_gap(w_k1, w_f)
    check(gap <= 1e-5 and np.array_equal(tr_k1.extras["kind_count"], kinds_k),
          f"robust device MLP K1 vs the flat update under faults on the same draws (T={Tk}): "
          f"max gap {gap:.3e} <= 1e-5, kind_count {kinds_k.tolist()} the stream's")
    del w_k1, w_f
    # the host stream's range under the same faults and guard: phase 18's
    # runs (seed 0) and `_host_fault_curves`' seeds, in lockstep
    curves = _SHARED.get("robust_host_curves", []) + _host_fault_curves(dev, setup, base)
    for label, (acc, eps) in accs.items():
        # the host stream at the run's last eval point (a cut T: an earlier one)
        at = [c[len(acc) - 1] for c in curves]
        lo, hi = min(at), max(at)
        print(f"robust device MLP {label}: {eps:.1f} events/s, acc {acc}")
        check(len(acc) >= 2 and bool(np.isfinite(acc).all()) and acc[-1] > acc[0]
              and lo - 0.02 <= acc[-1] <= hi + 0.02,
              f"robust device MLP {label}: accuracy rises {acc[0]:.4f} -> {acc[-1]:.4f}, within "
              f"the host stream's [{lo:.4f}, {hi:.4f}] under the same faults (phase 18's runs, "
              f"seeds {list(ROBUST_DEV_SEEDS)}) +- 0.02")

    # (c) a gradient that spikes every 50th step and is NaN at one live step
    Ts = ROBUST_DEV_SPIKE_T
    es_s, stale_s = stream_of(Ts, fault=fault)
    live = (es_s.kind == 0) & ~stale_s
    steps = np.arange(Ts)
    nan_step = int(next(k for k in range(Ts // 2, Ts)
                        if live[k] and k % ROBUST_SPIKE_EVERY != ROBUST_SPIKE_EVERY - 1))
    injected = (steps % ROBUST_SPIKE_EVERY == ROBUST_SPIKE_EVERY - 1) | (steps == nan_step)
    expect = int((injected & live).sum())
    spiky = _Spiky(setup.clients, nan_step)
    dspike = replace(dbase, T=Ts, guard=guard, eval_every=0)
    (w_s, tr_s), wall = _timed(lambda: run(dspike, spiky))
    check(int(tr_s.extras["guard_rejects"]) == expect
          and int(tr_s.extras["stale_drops"]) == int(stale_s.sum()) and finite(w_s),
          f"robust device MLP spikes (every {ROBUST_SPIKE_EVERY}th step, NaN at {nan_step}), "
          f"T={Ts}: rejects {int(tr_s.extras['guard_rejects'])} == the injected live events "
          f"{expect}, stale_drops {int(tr_s.extras['stale_drops'])} == {int(stale_s.sum())}, "
          f"weights finite ({wall:.3f} s)")
    w_o, _ = run(replace(dspike, guard=None), spiky)
    big = max(float(v.abs().max()) for v in w_o.values())
    check(not finite(w_o) or big > 1e4,
          f"robust device MLP spikes without the guard: weights finite {finite(w_o)}, max |w| "
          f"{big:.3e} (non-finite or > 1e4)")
    del w_s, w_o

    # (d) a scenario per event, and the 27-cell device matrix under one
    name, Ts6 = ROBUST_DEV_SCENARIO, ROBUST_DEV_SCENARIO_T
    es6, _ = stream_of(Ts6, scenario=get_scenario(name))
    kinds6 = np.bincount(es6.kind, minlength=6)
    rs, wall = _timed(lambda: run_experiment(replace(flc, server_steps=Ts6, scenario=name),
                                             "gen_async", eval_every=every, data=data))
    acc = list(rs.eval_acc)
    print(f"robust device MLP {name} per event, T={Ts6}: {Ts6 / wall:.1f} events/s, kinds "
          f"{rs.extras['kind_count'].tolist()}, acc {acc}")
    check(np.array_equal(rs.extras["kind_count"], kinds6) and bool(np.isfinite(acc).all())
          and acc[-1] > acc[0],
          f"robust device MLP {name} per event: kind_count == the stream's over 6 kinds, "
          f"accuracy finite and rising {acc[0]:.4f} -> {acc[-1]:.4f}")
    mflc = FLConfig(n_clients=MATRIX_N, concurrency=MATRIX_C, server_steps=ROBUST_DEV_MATRIX_T,
                    engine="scan", stream="device", device=dev.type)
    from repro_torch.data.pipeline import FederatedClassification

    mdata = FederatedClassification(n_clients=MATRIX_N, seed=mflc.seed)
    Tm = ROBUST_DEV_MATRIX_T
    B = int(np.prod([len(v) for v in MATRIX_GRID.values()]))
    m, wall = _timed(lambda: run_matrix(mflc, data=mdata, scenario=ROBUST_MATRIX_SCENARIO,
                                        eta=MATRIX_ETA, eval_every=MATRIX_EVAL, **MATRIX_GRID))
    acc = np.asarray(m.eval_acc)
    kc = np.asarray(m.extras["kind_count"])
    print(f"run_matrix(stream='device', scenario={ROBUST_MATRIX_SCENARIO!r}), {B} cells "
          f"n={MATRIX_N} C={MATRIX_C} T={Tm}: {wall:.3f} s, {B * Tm / wall:.1f} events/s summed "
          f"over cells; kinds summed {kc.reshape(-1, 6).sum(0).tolist()}; final acc (seed-mean) "
          f"{np.asarray(m.final_acc).mean(0).round(4).tolist()}")
    grid = tuple(len(MATRIX_GRID[k]) for k in ("seeds", "policies", "speed_ratios"))
    check(acc.shape == grid + (Tm // MATRIX_EVAL,) and bool(np.isfinite(acc).all())
          and bool((acc[..., -1] > acc[..., 0]).all()) and kc.shape == grid + (6,)
          and bool((kc.sum(-1) == Tm).all()),
          f"run_matrix(stream='device', scenario={ROBUST_MATRIX_SCENARIO!r}): finite curves, "
          "accuracy rises in every cell, each cell's kinds over 6 tags sum to T")


def _robust_dev_ckpt_mlp(dev, data) -> dict:
    """20 (e), the MLP: the checkpointed fused run (`_dev_ckpt_cfg`), then
    truncated to its second save and resumed in this process.  Returns the
    uninterrupted run's weights (numpy), curve and counters: the reference
    of the kill-and-resume children."""
    from repro_torch.core import engine_ckpt as ec
    from repro_torch.core.async_sgd import run_generalized_async_sgd

    setup, base = _mlp_setup(dev, data)
    d = DEV_CKPT_ROOT / "mlp"
    cfg = _dev_ckpt_cfg(base, d)
    T = cfg.T
    run = lambda c: run_generalized_async_sgd(setup.params, setup.clients, c,  # noqa: E731
                                              eval_fn=setup.eval_fn)
    ec.reset_saves()
    (w, tr), wall = _timed(lambda: run(cfg))
    saves = _print_saves("robust device MLP")
    print(f"robust device MLP per event, faults + guard, checkpointed every "
          f"{ROBUST_DEV_CKPT_EVERY}: {T / wall:.1f} events/s, {len(saves)} saves, acc "
          f"{tr.eval_values}, kinds {tr.extras['kind_count'].tolist()}, rejects "
          f"{int(tr.extras['guard_rejects'])}, stale {int(tr.extras['stale_drops'])}")
    check(len(tr.eval_values) == T // base.eval_every and bool(np.isfinite(tr.eval_values).all())
          and int(tr.extras["kind_count"].sum()) == T and np.isnan(tr.times).all(),
          f"robust device MLP checkpointed: {T // base.eval_every} finite eval points, kinds of "
          "all T events, NaN event times (the chunked driver keeps the final clock)")
    left = _truncate_ckpts(d, 2 * ROBUST_DEV_CKPT_EVERY)
    (w2, tr2), wall2 = _timed(lambda: run(replace(cfg, resume=True)))
    check(left[-1] == 2 * ROBUST_DEV_CKPT_EVERY and all(torch.equal(w2[k], w[k]) for k in w)
          and tr2.eval_values == tr.eval_values and _same_extras(tr2.extras, tr.extras),
          f"robust device MLP truncated to step {left[-1]} and resumed ({wall2:.3f} s): weights, "
          "curve and counters bitwise the uninterrupted run's")
    shutil.rmtree(d, ignore_errors=True)
    return dict(w={k: v.cpu().numpy() for k, v in w.items()}, evals=tr.eval_values,
                gcnt=[int(tr.extras["guard_rejects"]), int(tr.extras["stale_drops"])])


def _robust_dev_mamba(dev, launches: dict) -> None:
    """20 (e), Mamba2-130M at full width and depth (phase 19 (c)'s
    configuration, T cut to `ROBUST_DEV_MAMBA_T`) per event on the device
    stream with faults and the guard, checkpointed every
    `ROBUST_DEV_MAMBA_CKPT_EVERY` events, truncated to its first save and
    resumed; K4's launches go to ``launches["robust_device_mamba2"]``."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import engine_ckpt as ec
    from repro_torch.core.async_sgd import ServerConfig, run_generalized_async_sgd
    from repro_torch.data.pipeline import make_client_speeds
    from repro_torch.fl.engine import _cached_fl_setup, sampling_for
    from repro_torch.kernels import ssd_scan as k4

    part = _Part("robust device Mamba2")
    task = _mamba_task(dev)
    nL, T, every, C = task.cfg.num_layers, ROBUST_DEV_MAMBA_T, LM_EVAL, MAMBA_C
    every_ck = ROBUST_DEV_MAMBA_CKPT_EVERY
    flc = FLConfig(n_clients=LM_N, concurrency=C, server_steps=T, sampling="optimal",
                   speed_ratio=10.0, engine="scan", stream="device", device=dev.type)
    setup = _cached_fl_setup(None, flc.seed, task, n_clients=LM_N, device=dev)
    mu = make_client_speeds(LM_N, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
    p = sampling_for(flc, mu)
    fault, guard = _robust_settings(C)
    d = DEV_CKPT_ROOT / "mamba2"
    shutil.rmtree(d, ignore_errors=True)
    base = ServerConfig(n=LM_N, C=C, T=T, eta=0.05, mu=mu, p=p, seed=flc.seed, eval_every=every,
                        engine="scan", stream="device", faults=fault, guard=guard,
                        ckpt_dir=str(d), ckpt_every=every_ck, device=dev.type)
    path = launches.setdefault("robust_device_mamba2", {"ssd_scan": 0})
    run = lambda c: run_generalized_async_sgd(setup.params, setup.clients, c,  # noqa: E731
                                              eval_fn=setup.eval_fn)

    def counted(label, c, forwards):
        k4.reset_launches()
        ec.reset_saves()
        out, wall = _timed(lambda: run(c))
        n4 = k4.launches["ssd_scan"]
        path["ssd_scan"] += n4
        check(n4 == nL * forwards, f"{label}: K4 launches {n4} == {nL} x {forwards} forwards "
              "(a gradient every event, flips included, and an eval every "
              f"{every})")
        return out, wall

    torch.cuda.reset_peak_memory_stats()
    (w, tr), wall = counted("robust device Mamba2, checkpointed", base, _forwards(T, every))
    saves = _print_saves("robust device Mamba2")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"robust device Mamba2 per event, faults + guard, checkpointed every {every_ck}: "
          f"{wall:.3f} s ({T / wall:.3f} events/s, {T * LM_BATCH * LM_SEQ / wall:.1f} tokens/s), "
          f"{len(saves)} saves, kinds {tr.extras['kind_count'].tolist()}, rejects "
          f"{int(tr.extras['guard_rejects'])}, stale {int(tr.extras['stale_drops'])}, loss "
          f"{tr.eval_values}; peak device memory {peak:.3f} GiB")
    check(len(tr.eval_values) == T // every and bool(np.isfinite(tr.eval_values).all())
          and int(tr.extras["kind_count"].sum()) == T,
          f"robust device Mamba2: {T // every} finite eval points, kinds of all T events")
    J, kind, delay = _ckpt_events(mu, p, C, T, every_ck, flc.seed, fault, dev)
    trained = np.flatnonzero((kind == 0) & (delay <= guard.stale_cutoff))
    before = _train_loss(setup, setup.params, J, trained)
    after = _train_loss(setup, w, J, trained)
    check(after < before, f"robust device Mamba2: the clients' training loss over the run's "
          f"{trained.size} trained minibatches falls: {before:.5f} -> {after:.5f}")
    w_full = _flat_cpu(w)
    del w
    left = _truncate_ckpts(d, every_ck)
    (w2, tr2), wall2 = counted("robust device Mamba2 resumed", replace(base, resume=True),
                               _forwards(T - every_ck, every))
    check(left == [every_ck] and torch.equal(_flat_cpu(w2), w_full)
          and tr2.eval_values == tr.eval_values and _same_extras(tr2.extras, tr.extras),
          f"robust device Mamba2 truncated to step {left} and resumed ({wall2:.3f} s): weights, "
          "loss curve and counters bitwise the uninterrupted run's")
    del w2
    shutil.rmtree(d, ignore_errors=True)
    part.end()
    torch.cuda.empty_cache()


def phase_stream_robust(dev, launches: dict) -> None:
    """20. Faults, the guard, scenarios and the checkpointed fused driver on
    the device stream (see the module docstring); adds the kernel launches
    to ``launches`` under "robust_device_mlp" (K1) and
    "robust_device_mamba2" (K4).  The kill-and-resume children run one
    after the other on a thread, beside the MLP part (not beside Mamba2:
    a child there halved its events/s)."""
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.data.pipeline import FederatedClassification

    t0 = time.perf_counter()
    shutil.rmtree(DEV_CKPT_ROOT, ignore_errors=True)
    DEV_CKPT_ROOT.mkdir(parents=True)
    flc = _mlp_flc(dev)
    data = FederatedClassification(n_clients=flc.n_clients, seed=flc.seed)
    setup, base = _mlp_setup(dev, data)
    _robust_dev_card(dev, base.mu, base.p)
    t1 = time.perf_counter()
    ref = _robust_dev_ckpt_mlp(dev, data)
    t2 = time.perf_counter()
    d_kill = DEV_CKPT_ROOT / "mlp_killed"

    def children():
        killed = _run_robust_child(d_kill, "fused_kill")
        left = ck.available_steps(str(d_kill))
        return killed, left, _run_robust_child(d_kill, "fused_resume")

    with ThreadPoolExecutor(1) as pool:
        both = pool.submit(children)
        _robust_dev_mlp(dev, launches, data)
        t3 = time.perf_counter()
        (p1, wall1), left, (p2, wall2) = both.result()
        t4 = time.perf_counter()
    with _card_memory(21, "20: Mamba2-130M under faults, checkpointed"):
        _robust_dev_mamba(dev, launches)
    t5 = time.perf_counter()
    print(f"robust device MLP kill-and-resume children: the killed child exited {p1.returncode} "
          f"after {wall1:.3f} s and left steps {left}; the resumed child exited {p2.returncode} "
          f"after {wall2:.3f} s")
    for p in (p1, p2):
        if p.returncode not in (0, -signal.SIGKILL):
            print(p.stderr[-4000:], file=sys.stderr)
    every = ROBUST_DEV_CKPT_EVERY
    check(p1.returncode == -signal.SIGKILL and left == [every, 2 * every] and p2.returncode == 0,
          f"robust device MLP child SIGKILLed after its second save (steps left {left}), a fresh "
          "child resumed")
    if p2.returncode == 0:
        res = np.load(d_kill / "result.npz")
        bitwise = all(np.array_equal(res[k], v) for k, v in ref["w"].items())
        check(bitwise and res["evals"].tolist() == ref["evals"]
              and res["gcnt"].tolist() == ref["gcnt"],
              "robust device MLP killed and resumed in fresh processes: final weights, eval "
              "curve and guard counter bitwise the uninterrupted checkpointed run's")
    shutil.rmtree(DEV_CKPT_ROOT, ignore_errors=True)
    print(f"phase 20 times: streams on the card {t1 - t0:.1f} s, checkpointed MLP {t2 - t1:.1f} "
          f"s, MLP under faults, spikes and scenarios (children beside) {t3 - t2:.1f} s, the "
          f"children's rest {t4 - t3:.1f} s, Mamba2 {t5 - t4:.1f} s; phase 20 {t5 - t0:.1f} s")


# ------------------------------------------------------------------ #
# 21. the sparse O(C) stream and the class-collapsed control plane
# ------------------------------------------------------------------ #
def _two_class_mu(n: int, seed: int = 7, frac: float = 0.3, ratio: float = 2.5) -> np.ndarray:
    """`tests/test_scale.py`'s two speed classes: a fraction ``frac`` of the
    clients ``ratio`` times faster."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random(n) < frac, ratio, 1.0)


def _sparse_inputs(n: int, tagged: bool):
    """The stream of 21 (a) at ``n``: its class spec and its CPU-drawn
    inputs ``(mu_m, nodes, u_race, u_exp, K[, u_bit])`` (seed 0)."""
    from repro_torch.core import stream_device as sd
    from repro_torch.core.classes import build_class_spec

    spec, mu_m, p_m = build_class_spec(_two_class_mu(n))
    p_c = torch.tensor(p_m, dtype=torch.float32)
    nodes, ur, ue, ud, um, *ub = sd.draw_sparse_uniforms(0, spec, SPARSE_C, SPARSE_T, p_c,
                                                         device="cpu", fault=tagged)
    K = sd.sample_dispatch_classes(p_c, spec, ud, um)
    return spec, (torch.tensor(mu_m, dtype=torch.float32), nodes, ur, ue, K, *ub)


def _sparse_runs() -> list:
    """21 (a)'s streams: ``(n, faults on)`` pairs."""
    return [(n, tagged) for n in SPARSE_NS for tagged in (False, True)]


def _sparse_cpu_run(n: int, tagged: bool):
    """21 (a)'s CPU run of one stream: `sparse_scan_draws`'s ``(nodes,
    events, stats)``."""
    from repro_torch.core import FaultConfig
    from repro_torch.core import stream_device as sd

    spec, args = _sparse_inputs(n, tagged)
    fault = FaultConfig(**ROBUST_FAULT) if tagged else None
    return sd.sparse_scan_draws(args[0], spec, *args[1:], fault=fault)[:3]


def _sparse_card(dev) -> dict:
    """21 (a): the sparse stream on the card against the CPU on CPU-drawn
    uniforms at each n of `SPARSE_NS`, clean and under phase 18's faults
    (the CPU's runs: `_cpu_references("sparse")`); its laws over
    `SPARSE_LAW_CELLS` cells at n = 10^6 (n = 10^3: the CPU tests); the
    per-event time flat in n (every stream warmed up on its first
    `SPARSE_CHUNK` events, the clean ones timed twice in the order 10^3,
    10^6, 10^6, 10^3); one chunk with no host sync."""
    from repro_torch.core import FaultConfig
    from repro_torch.core import stream_device as sd
    from repro_torch.core.classes import build_class_spec

    C, T = SPARSE_C, SPARSE_T
    f32 = torch.float32
    eps, t0 = {}, time.perf_counter()
    cpu_runs = _cpu_refs("sparse")
    runs = {}
    for n, tagged in _sparse_runs():
        fault = FaultConfig(**ROBUST_FAULT) if tagged else None
        spec, args = _sparse_inputs(n, tagged)
        spec_g = sd._spec_on(spec, dev)
        on_card = [a.to(dev) for a in args]

        def run(a=on_card, spec_g=spec_g, fault=fault):
            return sd.sparse_scan_draws(a[0], spec_g, *a[1:], fault=fault)

        run([a[:SPARSE_CHUNK] if i >= 2 else a for i, a in enumerate(on_card)])  # warm-up
        runs[(n, tagged)] = spec, run
    lo, hi = SPARSE_NS
    cards, walls = {}, {}
    for key in [(lo, False), (hi, False), (lo, True), (hi, True), (hi, False), (lo, False)]:
        out, wall = _timed(runs[key][1])
        cards.setdefault(key, out)
        walls.setdefault(key, []).append(wall)
    for (n, tagged), card in cards.items():
        label, spec, w = "faults" if tagged else "clean", runs[(n, tagged)][0], walls[(n, tagged)]
        _same_stream(f"sparse stream ({label}) on the card n={n} C={C} T={T}", card[:3],
                     cpu_runs[(n, tagged)])
        st = card[2]
        check(int(st.occ_sum.sum()) == C * T and int(st.comp.sum()) == (
            int(st.kind_count[0]) if tagged else T),
              f"sparse stream ({label}) n={n}: the class occupancy sums to C at every step "
              f"(Palm sum {int(st.occ_sum.sum())} == C x T), completions counted once")
        eps[(n, label)] = T * len(w) / sum(w)
        print(f"sparse stream ({label}) n={n} m={spec.m} C={C} T={T}: "
              f"{' and '.join(f'{x:.3f}' for x in w)} s on the card, {eps[(n, label)]:.1f} "
              "events/s" + (f", kinds {st.kind_count.tolist()}" if tagged else ""))
    t_cmp = time.perf_counter() - t0
    # the laws, on the card at n = 10^6: SPARSE_LAW_CELLS cells on the cell axis
    n = SPARSE_NS[-1]
    spec, mu_m, p_m = build_class_spec(_two_class_mu(n))
    spec_g = sd._spec_on(spec, dev)
    mu_g = torch.tensor(mu_m, dtype=f32, device=dev)
    p_g = torch.tensor(p_m, dtype=f32, device=dev)
    B, L = SPARSE_LAW_CELLS, SPARSE_LAW_T
    draws = [sd.draw_sparse_uniforms(100 + b, spec_g, C, L, p_g, device=dev) for b in range(B)]
    nb, urb, ueb, udb, umb = (torch.stack(a) for a in zip(*draws))
    Kb = sd.sample_dispatch_classes(p_g.expand(B, -1), spec_g, udb, umb)
    (_, _, stl, state), wall_l = _timed(lambda: sd.sparse_scan_draws(
        mu_g, spec_g, nb, urb, ueb, Kb, emit_events=False))
    t_s = sd.kahan_value(state.t, state.t_c)
    occ = (sd.kahan_value(stl.occ_tw, stl.occ_tw_c) / t_s[:, None]).mean(0)
    delay = float(sd.kahan_value(stl.delay_sum, stl.delay_sum_c).sum()) / (B * L)
    md, _ = sd.mva_throughput_delays(torch.tensor(mu_m), torch.tensor(p_m), C,
                                     counts=tuple(int(c) for c in spec.counts))
    occ_mva = np.asarray(spec.counts) * p_m * md.numpy() * C / (C - 1.0)
    rel = float(np.max(np.abs(occ - occ_mva) / occ_mva))
    check(abs(occ.sum() - C) <= 1e-5 * C and abs(delay - (C - 1)) < 0.5 * np.sqrt(C)
          and rel <= 0.05,
          f"sparse stream laws n={n}, {B} cells x {L} events on the card: time-averaged "
          f"occupancy sums to {occ.sum():.6f} = C, mean delay {delay:.3f} within "
          f"{0.5 * np.sqrt(C):.1f} of C - 1 = {C - 1}, class occupancy {occ.round(3).tolist()} "
          f"within {rel:.4f} <= 5% of the class-collapsed MVA's {occ_mva.round(3).tolist()} "
          f"({wall_l:.3f} s, {B * L / wall_l:.1f} events/s summed over cells)")
    ratio = eps[(lo, "clean")] / eps[(hi, "clean")]
    check(ratio <= 2.0, f"sparse stream per-event time at n={hi} is {ratio:.3f}x that at n={lo} "
          f"(<= 2: flat in n; two warm timed runs at each n; under faults "
          f"{eps[(lo, 'faults')] / eps[(hi, 'faults')]:.3f}x)")
    # one chunk under the sync check, faults on (the widest race, the pools)
    fr = sd.resolve_fault_rates_classes(FaultConfig(**ROBUST_FAULT), spec, dev)
    L = SPARSE_CHUNK
    nodes, ur, ue, ud, um, ub = sd.draw_sparse_uniforms(1, spec_g, C, L, p_g, device=dev,
                                                        fault=True)
    state, _ = sd.sparse_stream_init(nodes[None], spec_g, C, fault=True)
    stats = sd.sparse_stats_init(spec.m, C, fault=True, cells=1, device=dev)
    cst = sd._Consts((1,), C, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        Kc = sd.sample_dispatch_classes(p_g[None], spec_g, ud[None], um[None])
        sd._advance(state, stats, mu_g[None], -torch.log1p(-ue[None]), ur[None], Kc, 0, cst,
                    fr=fr, spec=spec_g, u_bit=ub[None])
        synced = False
    except RuntimeError as e:
        synced = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(synced is False, f"a chunk of {L} sparse stream events (faults, n={n}) makes no host "
          f"sync (set_sync_debug_mode('error')){'' if synced is False else ': ' + synced[:200]}")
    print(f"sparse stream events/s on the card: "
          + ", ".join(f"n={k[0]} {k[1]} {v:.1f}" for k, v in eps.items())
          + f"; the card-against-CPU runs {t_cmp:.1f} s, (a) {time.perf_counter() - t0:.1f} s")
    return eps


def _sparse_control(dev) -> None:
    """21 (b): the class-collapsed MVA on the card at n = 10^6 against the
    numpy float64 MVA; the milliseconds of one ``ctrl_refresh(counts=)``."""
    from repro_torch.core import stream_device as sd
    from repro_torch.core.classes import build_class_spec
    from repro_torch.core.sampling import _mva_delays_f64
    from repro_torch.core.theory import BoundConstants

    n, C = SPARSE_NS[-1], SPARSE_C
    spec, mu_m, p_m = build_class_spec(_two_class_mu(n))
    counts = tuple(int(c) for c in spec.counts)
    mu_g = torch.tensor(mu_m, dtype=torch.float32, device=dev)
    p_g = torch.tensor(p_m, dtype=torch.float32, device=dev)
    m, lam = sd.mva_throughput_delays(mu_g, p_g, C, counts=counts)
    want, lam64 = _mva_delays_f64(mu_m, p_m, np.asarray(spec.counts), C)
    rel = float(np.max(np.abs(m.cpu().double().numpy() - want) / np.abs(want)))
    rl = abs(float(lam) / lam64 - 1.0)
    check(rel <= 1e-5 and rl <= 1e-5, f"class-collapsed MVA on the card n={n} m={spec.m} C={C} "
          f"vs the numpy float64 MVA: delays {rel:.2e}, throughput {rl:.2e} <= 1e-5 relative")
    comp = torch.tensor([4000, 9000], device=dev)
    busy = torch.tensor([3900.0, 3700.0], dtype=torch.float32, device=dev)
    k = BoundConstants(C=C, T=SPARSE_T)
    ms = []
    for _ in range(4):
        _, wall = _timed(lambda: sd.ctrl_refresh(p_g, comp, busy, k, counts=counts))
        ms.append(wall * 1e3)
    out = sd.ctrl_refresh(p_g, comp, busy, k, counts=counts)
    mass = float((out.double() * torch.tensor(counts, dtype=torch.float64, device=dev)).sum())
    check(bool(torch.isfinite(out).all()) and abs(mass - 1.0) <= 1e-5,
          f"ctrl_refresh(counts=) on the card: a finite class-level p, class masses summing to "
          f"{mass:.7f}")
    print(f"ctrl_refresh(counts=) n={n} m={spec.m} C={C} (4 exponentiated-gradient steps "
          f"through the class MVA): {float(np.median(ms[1:])):.3f} ms (median of 3 after one "
          f"warm-up; first {ms[0]:.3f} ms)")


def _sparse_fault(n: int):
    """Phase 18's faults (`ROBUST_FAULT`) for a population of n clients: the
    crash and timeout rates as they are, the availability flip rates scaled
    by 256 / n, so that the n nodes flip as often in all as phase 18's 256
    (the same stationary availability, 5/6).  Unscaled, at n = 50,000 the
    idle nodes' flips were 97.3% of the events (26 completions in 1000:
    PERF.md section 6)."""
    from repro_torch.core import FaultConfig

    scale = 256 / n
    return FaultConfig(**dict(ROBUST_FAULT, off_rate=ROBUST_FAULT["off_rate"] * scale,
                              on_rate=ROBUST_FAULT["on_rate"] * scale))


def _build_sparse_shards(n: int, seed: int, m: int) -> float:
    """Phase 21's MLP shards, in a CPU-only child process: `FederatedClassification`
    's ``device_shards(m)`` for n clients, saved under `SPARSE_SHARDS`;
    returns the seconds it took."""
    from repro_torch.data.pipeline import FederatedClassification

    os.nice(10)  # below the lanes, which wait for these shards much later
    t0 = time.perf_counter()
    xs, ys = FederatedClassification(n_clients=n, seed=seed).device_shards(m)
    SPARSE_SHARDS.parent.mkdir(parents=True, exist_ok=True)
    np.save(f"{SPARSE_SHARDS}_x.npy", xs)
    np.save(f"{SPARSE_SHARDS}_y.npy", ys)
    return time.perf_counter() - t0


def _sparse_mlp(dev, launches: dict) -> None:
    """21 (c): the slice's path, the full-width MLP at n = `SPARSE_MLP_N` on
    the sparse stream: ``run_experiment`` (plain update), K1 per event on
    the same draws, K1 under phase 18's faults (flips scaled to n,
    `_sparse_fault`), the plain update under those faults and phase 18's
    guard (the reference takes the guard on the plain update only); one
    chunk of the sparse fused runner under the faults and the guard
    (importance-weighted, adaptive) under the sync check."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import stream_device as sd
    from repro_torch.core.async_sgd import (ServerConfig, _device_grad_fn,
                                            run_generalized_async_sgd)
    from repro_torch.core.classes import build_class_spec
    from repro_torch.core.engine_scan import make_fused_runner
    from repro_torch.data.pipeline import FederatedClassification, make_client_speeds
    from repro_torch.fl.engine import ClassificationTask, _cached_fl_setup, run_experiment, \
        sampling_for
    from repro_torch.kernels import weighted_update as wu

    n, C, T, every = SPARSE_MLP_N, SPARSE_C, SPARSE_MLP_T, SPARSE_MLP_EVAL
    flc = FLConfig(n_clients=n, concurrency=C, server_steps=T, engine="scan", stream="device",
                   sparse="auto", device=dev.type)
    task = ClassificationTask(shard_size=SPARSE_SHARD)
    t0 = time.perf_counter()
    data = FederatedClassification(n_clients=n, seed=flc.seed)
    # the shards a CPU-only worker built beside the build, as `device_shards` builds them
    secs = _cpu_refs("sparse_shards")
    xs, ys = (np.load(f"{SPARSE_SHARDS}_{k}.npy") for k in ("x", "y"))
    for k in ("x", "y"):
        os.remove(f"{SPARSE_SHARDS}_{k}.npy")
    data.device_shards = lambda m: (xs, ys) if m == SPARSE_SHARD else None
    print(f"sparse MLP: the {n} client shards were built in a CPU-only worker beside the build "
          f"in {secs:.1f} s (FederatedClassification.device_shards)")
    setup = _cached_fl_setup(data, flc.seed, task, n_clients=n, device=dev)
    mu = make_client_speeds(n, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
    p = sampling_for(flc, mu)
    spec, mu_m, p_m = build_class_spec(mu, p)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    print(f"sparse MLP n={n} C={C} T={T} (cut from shard 1024 to {SPARSE_SHARD} and T 2000 to "
          f"{T}): set-up (the data, the clients' shards on the card, the model, p) "
          f"{t_setup:.1f} s; m = {spec.m} classes of sizes {spec.counts.tolist()}")
    check(spec.m == 2, f"sparse MLP: the paper's two clusters with 'optimal' p give m = {spec.m} "
          "== 2 classes")
    r, wall = _timed(lambda: run_experiment(flc, "gen_async", eval_every=every, data=data,
                                            task=task))
    accs = {"run_experiment (plain update)": (list(r.eval_acc), T / wall)}
    base = ServerConfig(n=n, C=C, T=T, eta=0.05, mu=mu, p=p, seed=flc.seed, eval_every=every,
                        engine="scan", stream="device", weighting="importance", device=dev.type)
    run = lambda c: run_generalized_async_sgd(setup.params, setup.clients, c,  # noqa: E731
                                              eval_fn=setup.eval_fn)
    path = launches.setdefault("sparse_mlp", {"weighted_update": 0})
    wu.reset_launches()
    (w_k1, tr), wall = _timed(lambda: run(replace(base, update="pallas")))
    _k1_counts(path, "sparse MLP per event", T, 6)
    accs["per event K1"] = (tr.eval_values, T / wall)
    ql = np.asarray(tr.mean_queue_lengths)
    check(ql.shape == (n,) and bool(np.all(ql > 0)) and abs(ql.sum() - C) <= 1e-3 * C,
          f"sparse MLP: the run took the sparse stream (every client's mean queue length is its "
          f"class's share, > 0; sum {ql.sum():.4f} == C)")
    gap = _tree_gap(w_k1, r.final_params)
    check(gap <= 1e-5, f"sparse MLP: K1 vs run_experiment's plain update on the same draws, max "
          f"weight gap {gap:.3e} <= 1e-5")
    # phase 18's faults with the availability flips scaled to the population
    # (`_sparse_fault`): K1 per event, then the plain update under the guard
    fault, guard = _sparse_fault(n), _robust_settings(C)[1]
    wu.reset_launches()
    (w_f, tr_f), wall = _timed(lambda: run(replace(base, faults=fault, update="pallas")))
    _k1_counts(path, "sparse MLP per event under faults", T, 6)
    accs["per event K1, faults"] = (tr_f.eval_values, T / wall)
    kc = tr_f.extras["kind_count"]
    check(int(kc.sum()) == T and int(kc[3]) > 0 and all(
        bool(torch.isfinite(v).all()) for v in w_f.values()),
          f"sparse MLP under faults: kind_count {kc.tolist()} sums to T = {T}, flips included; "
          "weights finite")
    (w_g, tr_g), wall = _timed(lambda: run(replace(base, faults=fault, guard=guard)))
    accs["per event, faults + guard"] = (tr_g.eval_values, T / wall)
    kc, ex = tr_g.extras["kind_count"], tr_g.extras
    check(int(kc.sum()) == T and int(kc[3]) > 0 and all(
        bool(torch.isfinite(v).all()) for v in w_g.values()),
          f"sparse MLP under faults and the guard (plain update): kind_count {kc.tolist()} sums "
          f"to T = {T}, flips included; guard rejects {int(ex['guard_rejects'])}, stale drops "
          f"{int(ex['stale_drops'])}; weights finite")
    for label, (acc, eps) in accs.items():
        print(f"sparse MLP {label}: {eps:.1f} events/s, acc {acc}")
        check(len(acc) == T // every and bool(np.isfinite(acc).all()) and acc[-1] > acc[0],
              f"sparse MLP {label}: accuracy rises {acc[0]:.4f} -> {acc[-1]:.4f}")
    small = replace(base, update="pallas", T=SPARSE_PROFILE_T, eval_every=0)
    _print_profile(f"sparse MLP per-event K1, n={n}, T={SPARSE_PROFILE_T}", lambda: run(small),
                   SPARSE_PROFILE_T)
    # one chunk of the sparse fused runner under the sync check: under the
    # faults and the guard, importance-weighted and adaptive
    L = SPARSE_CHUNK
    fused = make_fused_runner(_device_grad_fn(setup.clients), n, C, L, weighting="importance",
                              adaptive=True, refresh_every=L, classes=spec, fault=fault,
                              guard=guard)
    mu_g = torch.tensor(mu_m, dtype=torch.float32, device=dev)
    p_g = torch.tensor(p_m, dtype=torch.float32, device=dev)
    nodes, ur, ue, ud, um, ub = sd.draw_sparse_uniforms(5, spec, C, L, p_g, device=dev,
                                                        fault=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w_c, _, ex_c = fused.from_draws(setup.params, mu_g, p_g, 0.05, nodes, ur, ue, ud, u_mem=um,
                                        u_bit=ub)
        synced = False
    except RuntimeError as e:
        synced = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ok = synced is False and all(bool(torch.isfinite(v).all()) for v in w_c.values())
    kinds = ex_c["kind_count"].tolist() if ok else None
    check(ok and tuple(ex_c["p_traj"].shape) == (1, spec.m) and sum(kinds) == L,
          f"one chunk of the sparse fused runner ({L} events at n={n}, importance-weighted, "
          "adaptive, under the faults and the guard: class draws, the idle pools, slot scales, "
          "the MLP's per-event replay and the guard, ctrl_refresh(counts=)) makes no host sync "
          f"(set_sync_debug_mode('error')); kinds {kinds}, guard rejects "
          f"{int(ex_c['guard_rejects']) if ok else None}, stale drops "
          f"{int(ex_c['stale_drops']) if ok else None}{'' if synced is False else ': ' + synced[:200]}")
    del w_k1, w_f, w_g, w_c, setup, data
    print(f"sparse MLP part: set-up {t_setup:.1f} s of {time.perf_counter() - t0:.1f} s")


def phase_sparse(dev, launches: dict) -> None:
    """21. The sparse O(C) stream and the class-collapsed control plane (see
    the module docstring); adds K1's launches to ``launches`` under
    "sparse_mlp"."""
    t0 = time.perf_counter()
    _sparse_card(dev)
    _sparse_control(dev)
    t1 = time.perf_counter()
    with _card_memory(3, "21 (c): the MLP at n = 50,000"):
        _sparse_mlp(dev, launches)
    t2 = time.perf_counter()
    print(f"phase 21 times: stream and control plane {t1 - t0:.1f} s, MLP {t2 - t1:.1f} s; "
          f"phase 21 {t2 - t0:.1f} s")


# ------------------------------------------------------------------ #
# 22. the serving plane: the merged stream, the known-good read path,
# decode and the serving driver
# ------------------------------------------------------------------ #
def _serve_inputs(mu, p, n: int, C: int, T: int, seed: int, cells: int | None = None):
    """`stream_device.scan_draws`'s positional inputs for the merged stream,
    drawn on the CPU (seed ``seed``, or ``seed + b`` for cell b)."""
    from repro_torch.core import stream_device as sd

    f32 = torch.float32
    seeds = [seed] if cells is None else [seed + b for b in range(cells)]
    draws = [sd.draw_uniforms(s, n, C, T, p, device="cpu") for s in seeds]
    nodes, ur, ue, ud = (torch.stack(a) for a in zip(*draws))
    K = sd.tree_sample(sd.tree_build(torch.tensor(p, dtype=f32).expand(len(seeds), n)), ud)
    args = (torch.tensor(mu, dtype=f32).expand(len(seeds), n), nodes, ur, ue, K)
    return tuple(a[0] for a in args) if cells is None else args


def _serve_cpu_refs():
    """22 (a)'s CPU runs: the merged stream at the MLP slice's network under
    each serving configuration (`_serve_inputs`, seed 0)."""
    from repro_torch.core import stream_device as sd
    from repro_torch.core.serving import ServingConfig
    from repro_torch.data.pipeline import make_client_speeds
    from repro_torch.fl.engine import sampling_for

    flc = _mlp_flc(torch.device("cpu"))
    mu = make_client_speeds(flc.n_clients, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
    p = sampling_for(flc, mu)
    args = _serve_inputs(mu, p, STREAM_N, STREAM_C, SERVE_T, 0)
    return {name: sd.scan_draws(*args, serving=ServingConfig(**kw))
            for name, kw in (("overload", SERVE_OVERLOAD), ("cli", SERVE_CLI))}


def _same_served(label: str, card, cpu) -> None:
    """Two `scan_draws(serving=)` results: the events (J, K, slot, delay,
    kind) and the integer statistics equal, the serving table and its
    integer counters and histograms equal, times and float statistics
    within 1e-6 relative."""
    (_, ea, sa, (va, ta)), (_, eb, sb, (vb, tb)) = card, cpu
    same = lambda x, y: torch.equal(x.cpu(), y.cpu())  # noqa: E731
    ints = (all(same(ea[i], eb[i]) for i in (0, 1, 3, 4, 5))
            and all(same(getattr(sa, f), getattr(sb, f)) for f in ("occ_sum", "comp", "slot_step"))
            and all(same(getattr(va, f), getattr(vb, f))
                    for f in ("stt", "seq", "attempt", "next_seq", "depth", "cdf"))
            and all(same(getattr(ta, f), getattr(tb, f))
                    for f in ("arrivals", "served", "shed", "timed_out", "retried", "qdepth_max",
                              "sojourn_hist")))
    pairs = [(ea[2], eb[2])] + [(getattr(sa, f), getattr(sb, f))
                                for f in ("occ_tw", "busy_t", "delay_sum")]
    pairs += [(va.t_arr, vb.t_arr), (va.tokens, vb.tokens), (ta.sojourn - ta.sojourn_c,
                                                             tb.sojourn - tb.sojourn_c),
              (ta.qdepth_tw - ta.qdepth_tw_c, tb.qdepth_tw - tb.qdepth_tw_c)]
    rel = max(float(((x.cpu().double() - y.cpu().double()).abs()
                     / y.cpu().double().abs().clamp_min(1e-30)).max()) for x, y in pairs)
    n_serve = int((eb[5] == 4).sum())
    check(ints and rel <= 1e-6,
          f"{label}: J, K, slot, delay, kind ({n_serve} serve events), the integer statistics, "
          f"the request table and its counters and histograms equal the CPU's on the same "
          f"draws; times and float statistics within {rel:.2e} <= 1e-6 relative")


def _serve_counts(x: dict) -> tuple[int, int, int, int, int]:
    return tuple(int(x[f"serve_{k}"]) for k in ("arrivals", "served", "shed", "timed_out",
                                                "pending"))


def _serve_conserved(label: str, x: dict) -> None:
    arr, srv, shed, tmo, pend = _serve_counts(x)
    check(arr == srv + shed + tmo + pend and arr > 0,
          f"{label}: requests conserved exactly: arrivals {arr} == served {srv} + shed {shed} + "
          f"timed out {tmo} + pending {pend}")


def _serve_card(dev) -> None:
    """22 (a): the merged stream on the card against the CPU under both
    serving configurations; the law against the host oracle; a chunk under
    the sync check."""
    from repro_torch.core import stream_device as sd
    from repro_torch.core.serving import (ServeLoop, ServingConfig, serve_init,
                                          serve_stats_init, simulate_serving_host)
    from repro_torch.data.pipeline import make_client_speeds
    from repro_torch.fl.engine import sampling_for

    flc = _mlp_flc(dev)
    mu = make_client_speeds(flc.n_clients, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
    p = sampling_for(flc, mu)
    args = _serve_inputs(mu, p, STREAM_N, STREAM_C, SERVE_T, 0)
    refs = _cpu_refs("serve")
    for name, kw in (("overload", SERVE_OVERLOAD), ("cli", SERVE_CLI)):
        cfg = ServingConfig(**kw)
        card, wall = _timed(lambda: sd.scan_draws(*(a.to(dev) for a in args), serving=cfg))
        _same_served(f"merged stream ({name}) on the card n={STREAM_N} C={STREAM_C} "
                     f"T={SERVE_T}", card, refs[name])
        print(f"merged stream ({name}) on the card: {wall:.3f} s, {SERVE_T / wall:.1f} events/s")
    # the serving marginal's law against the host oracle (the reference's
    # test_device_matches_host_oracle_law: its configuration, network and bars)
    cfg = ServingConfig(**SERVE_LAW)
    n, C, T, B = SERVE_LAW_N, SERVE_LAW_C, SERVE_LAW_T, SERVE_LAW_CELLS
    mu8 = np.linspace(0.5, 2.0, n)
    argsb = _serve_inputs(mu8, np.full(n, 1.0 / n), n, C, T, 3000, cells=B)
    (_, ev, _, (sv, st)), wall = _timed(lambda: sd.scan_draws(*(a.to(dev) for a in argsb),
                                                              serving=cfg))
    t_end = ev[2][:, -1].double().cpu().numpy()
    arr, srv, shed = (int(getattr(st, f).sum()) for f in ("arrivals", "served", "shed"))
    tmo = int(st.timed_out.sum()) + int((sv.stt != 0).sum())
    sojourn = float((st.sojourn.double() - st.sojourn_c.double()).sum())
    horizon = float(t_end.mean())
    host = dict(arrivals=0, served=0, shed=0, timed_out=0)
    sjs = []
    for seed in range(20):
        h = simulate_serving_host(cfg, horizon, seed=seed)
        for k in host:
            host[k] += h[k]
        sjs += h["sojourns"]
    rate = arr / float(t_end.sum())
    fr = {k: (v / arr, host[k] / host["arrivals"]) for k, v in
          (("served", srv), ("shed", shed), ("timed_out", tmo))}
    w_dev, w_host = sojourn / max(srv, 1), float(np.mean(sjs))
    print(f"merged stream law, {B} cells x {T} events on the card ({wall:.3f} s): arrival rate "
          f"{rate:.4f} (lambda {cfg.arrival_rate}); fractions (card, host) "
          f"{ {k: (round(a, 4), round(b, 4)) for k, (a, b) in fr.items()} }; mean sojourn "
          f"{w_dev:.4f} vs host {w_host:.4f}")
    check(abs(rate / cfg.arrival_rate - 1.0) <= 0.15
          and all(abs(a - b) < 0.06 for a, b in fr.values())
          and abs(w_dev / w_host - 1.0) <= 0.25,
          "merged stream law against simulate_serving_host: arrival rate within 15%, outcome "
          "fractions within 0.06, mean sojourn within 25% (the reference's bars)")
    # a chunk of the merged stream under the sync check
    state, _ = sd.stream_init(argsb[1].to(dev), n, C)
    stats = sd.stats_init(n, C, cells=B, device=dev)
    loop = ServeLoop(cfg, serve_init(cfg, cells=B, device=dev), serve_stats_init(cells=B,
                                                                                  device=dev))
    mu_g, ur, ue, K = (argsb[i][:, :200].to(dev) if i else argsb[0].to(dev) for i in (0, 2, 3, 4))
    cst = sd._Consts((B,), C, dev, n=n)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sd._advance(state, stats, mu_g, -torch.log1p(-ue), ur, K, 0, cst, serve=loop)
        ok = True
    except RuntimeError as e:
        ok = False
        print(f"     {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(ok, "a chunk of the merged stream (200 events, 8 cells) makes no host sync")


def _serve_mlp(dev, data) -> None:
    """22 (b): the full-width MLP through ``run_experiment(stream="device",
    serving=)`` under the 2x overload, checkpointed every 250 events,
    truncated after its second save and resumed; the spiking gradient under
    the guard and unguarded; a chunk under the sync check and a profile."""
    from repro_torch.core.async_sgd import _device_grad_fn, run_generalized_async_sgd
    from repro_torch.core.serving import ServingConfig
    from repro_torch.core.engine_scan import make_fused_runner
    from repro_torch.core import stream_device as sd
    from repro_torch.fl.engine import run_experiment

    cfg = ServingConfig(**SERVE_OVERLOAD)
    flc = replace(_mlp_flc(dev), stream="device", server_steps=SERVE_T)
    shutil.rmtree(SERVE_CKPT_ROOT, ignore_errors=True)
    d = str(SERVE_CKPT_ROOT / "mlp")
    run = lambda **kw: run_experiment(flc, "gen_async", eval_every=SERVE_EVAL, data=data,  # noqa: E731
                                      serving=cfg, ckpt_dir=d, ckpt_every=SERVE_CKPT_EVERY, **kw)
    r, wall = _timed(run)
    x = r.extras
    acc = [round(float(a), 4) for a in r.eval_acc]
    print(f"MLP under the 2x overload, run_experiment(stream='device', serving=), T={SERVE_T}, "
          f"checkpointed every {SERVE_CKPT_EVERY}: {wall:.3f} s, {SERVE_T / wall:.1f} events/s; "
          f"accuracy {acc}; serve counters {_serve_counts(x)}, retried "
          f"{int(x['serve_retried'])}, qdepth max {int(x['serve_qdepth_max'])}, known-good step "
          f"{int(x['serve_kg_step'])}, checksum {float(x['serve_checksum']):.6g}, sojourn "
          f"buckets {x['serve_sojourn_hist'].tolist()}")
    _serve_conserved("MLP under the 2x overload", x)
    check(int(x["serve_qdepth_max"]) <= cfg.queue_cap and int(x["serve_shed"]) > 0,
          f"MLP under the 2x overload: qdepth max {int(x['serve_qdepth_max'])} <= queue cap "
          f"{cfg.queue_cap}, {int(x['serve_shed'])} shed")
    check(np.isfinite(float(x["serve_checksum"])) and int(x["serve_kg_step"]) > 0
          and int(x["serve_stale_hist"].sum()) == int(x["serve_served"]),
          "MLP under the 2x overload: the read path's checksum finite, the known-good step "
          "moved, every serve's staleness histogrammed")
    check(len(acc) == SERVE_T // SERVE_EVAL and acc[-1] > acc[0],
          f"MLP under the 2x overload: accuracy rises {acc[0]} -> {acc[-1]}")
    left = _truncate_ckpts(d, 2 * SERVE_CKPT_EVERY)
    r2, wall2 = _timed(lambda: run(resume=True))
    names = sorted(k for k in x if k.startswith("serve_"))
    bitwise = (all(torch.equal(r.final_params[k], r2.final_params[k]) for k in r.final_params)
               and all(np.array_equal(x[k], r2.extras[k]) for k in names)
               and r.eval_acc.tolist() == r2.eval_acc.tolist())
    print(f"     truncated to steps {left}, resumed in {wall2:.3f} s")
    check(bitwise and len(names) == 16,
          "MLP with serving, checkpointed, truncated after its second save and resumed: "
          "weights, eval curve and the 16 serve_* extras bitwise the uninterrupted run")
    shutil.rmtree(SERVE_CKPT_ROOT, ignore_errors=True)

    setup, base = _mlp_setup(dev, data)
    _, guard = _robust_settings(STREAM_C)
    sbase = replace(base, stream="device", serving=cfg, eval_every=0)
    nan_step = 333
    spiky = _Spiky(setup.clients, nan_step)
    (w_g, tr_g), wall = _timed(lambda: run_generalized_async_sgd(
        setup.params, spiky, replace(sbase, T=SERVE_SPIKE_T, guard=guard)))
    xg = tr_g.extras
    finite_w = all(bool(torch.isfinite(v).all()) for v in w_g.values())
    print(f"MLP under the overload with a gradient that spikes every {ROBUST_SPIKE_EVERY}th step "
          f"and is NaN at step {nan_step}, guarded, T={SERVE_SPIKE_T}: {wall:.3f} s; rejects "
          f"{int(xg['guard_rejects'])}, serve counters {_serve_counts(xg)}, checksum "
          f"{float(xg['serve_checksum']):.6g}")
    _serve_conserved("MLP spiking gradient under the guard", xg)
    check(int(xg["guard_rejects"]) > 0 and int(xg["serve_served"]) > 0 and finite_w
          and np.isfinite(float(xg["serve_checksum"])),
          "MLP spiking gradient under the guard: rejected updates never served (the checksum "
          "of the served rows finite), the weights finite")
    (_, tr_u), _ = _timed(lambda: run_generalized_async_sgd(setup.params, spiky,
                                                            replace(sbase, T=SERVE_CONTROL_T)))
    check(not np.isfinite(float(tr_u.extras["serve_checksum"])),
          f"MLP spiking gradient unguarded, T={SERVE_CONTROL_T} (the control): the poison "
          f"reaches the served rows (checksum {float(tr_u.extras['serve_checksum'])})")

    # a chunk of the fused runner with serving and the guard under the sync check
    n, C, T = STREAM_N, STREAM_C, SERVE_CHUNK_T
    fused = make_fused_runner(_device_grad_fn(setup.clients), n, C, T, serving=cfg, guard=guard)
    draws = sd.draw_uniforms(5, n, C, T, base.p, device=dev)
    mu_g, p_g = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (base.mu, base.p))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused.from_draws(setup.params, mu_g, p_g, 0.05, *draws)
        ok = True
    except RuntimeError as e:
        ok = False
        print(f"     {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(ok, f"a chunk of the fused runner with serving and the guard on the MLP ({T} events) "
          "makes no host sync")
    _print_profile(f"MLP with serving and the guard (fused runner, {T} events)",
                   lambda: fused.from_draws(setup.params, mu_g, p_g, 0.05, *draws), T)
    del setup, w_g


def _decode_gap(cfg, params, dev, B: int, S: int, seed: int) -> tuple[float, bool]:
    """Decode of S random tokens from the empty cache against the port's own
    full-sequence forward at each position: ``(largest gap over the largest
    |logit|, logits finite)``."""
    from repro_torch.launch.serve import materialize_cache
    from repro_torch.models import api

    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))).to(dev)
    with torch.no_grad():
        full, _ = api.forward(params, {"tokens": toks}, cfg)
        cache = materialize_cache(api.init_cache(cfg, B, S), dev)
        steps = []
        for t in range(S):
            lg, cache = api.decode_step(params, cache, {"tokens": toks[:, t:t + 1]}, cfg)
            steps.append(lg)
        dec = torch.stack(steps, dim=1)
    gap = max_err(dec, full) / max(float(full.float().abs().max()), 1e-30)
    return gap, bool(torch.isfinite(dec.float()).all())


def _decode_vs_forward(label: str, arch: str, cfg, params, dev) -> None:
    """22 (c)-(d): decode against the full-sequence forward at full width and
    depth, in the run's bf16 (`SERVE_DECODE_BF16_TOL`) and with the same
    weights in fp32 (`SERVE_DECODE_FP32_TOL`: the decode path itself)."""
    from repro_torch.tree import tree_map

    B, S = SERVE_DECODE_B, SERVE_DECODE_PROMPT + SERVE_DECODE_STEPS
    gap, finite = _decode_gap(cfg, params, dev, B, S, 1)
    tol = SERVE_DECODE_BF16_TOL[arch]
    check(finite and gap <= tol, f"{label}: bf16 decode of {S} tokens x {B} through the cache "
          f"against the full-sequence forward at each position: gap {gap:.3e} of the largest "
          f"logit <= {tol}, logits finite {finite}")
    p32 = tree_map(lambda w: w.float(), params)
    S32 = SERVE_DECODE_FP32_S
    gap, finite = _decode_gap(cfg.replace(dtype="float32"), p32, dev, B, S32, 2)
    check(finite and gap <= SERVE_DECODE_FP32_TOL,
          f"{label}: the same weights in fp32, decode of {S32} tokens x {B} against the forward: "
          f"gap {gap:.3e} of the largest logit <= {SERVE_DECODE_FP32_TOL}")
    del p32
    torch.cuda.empty_cache()


def _decode_report(label: str, r: dict) -> None:
    print(f"{label} decode (B={SERVE_DECODE_B}, prompt {SERVE_DECODE_PROMPT}, "
          f"{SERVE_DECODE_STEPS} steps): prefill {r['prefill_s'] * 1e3:.1f} ms, decode "
          f"{r['decode_s'] * 1e3:.1f} ms, {r['tok_per_s']:.1f} tokens/s, "
          f"{r['decode_s'] * 1e3 / SERVE_DECODE_STEPS:.3f} ms/step")


def _profile_decode(label: str, cfg, params, dev, steps: int = 4) -> None:
    """A profile of ``steps`` decode steps of B tokens (an "event" a step)."""
    from repro_torch.launch.serve import materialize_cache
    from repro_torch.models import api

    B = SERVE_DECODE_B
    tok = torch.zeros((B, 1), dtype=torch.int64, device=dev)

    def run():
        cache = materialize_cache(api.init_cache(cfg, B, steps), dev)
        with torch.no_grad():
            for _ in range(steps):
                _, cache = api.serve_step(params, cache, {"tokens": tok}, cfg)

    _print_profile(f"{label} decode (B={B}, a step an event)", run, steps)


def _serve_mamba(dev, launches: dict) -> None:
    """22 (c): Mamba2-130M at full width and depth through the driver's
    training plane under the CLI's traffic (K4 in every gradient), then
    decode from those weights."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.launch import serve as t_serve

    part = _Part("Mamba2 serving (phase 22)")
    args = t_serve._parser().parse_args(SERVE_MAMBA_ARGS + ["--device", dev.type])
    cfg = get_config(MAMBA_ARCH).replace(use_pallas=True, remat="none")  # pinned
    path = launches.setdefault("serve_mamba2", {"ssd_scan": 0})
    k4.reset_launches()
    (params, x), wall = _timed(lambda: t_serve._train_under_traffic(cfg, args))
    n4 = k4.launches["ssd_scan"]
    path["ssd_scan"] += n4
    T = args.train_steps
    print(f"Mamba2-130M training plane under the CLI's traffic (n={args.clients}, "
          f"C={args.concurrency}, T={T} merged events, LMTask(batch 2, seq 16)): {wall:.3f} s, "
          f"{T / wall:.3f} events/s, K4 launches {n4}; serve counters {_serve_counts(x)}, "
          f"known-good step {int(x['serve_kg_step'])}")
    check(n4 == cfg.num_layers * T, f"Mamba2 serving: K4 launches {n4} == {cfg.num_layers} x "
          f"{T} gradients (serve events compute one too)")
    _serve_conserved("Mamba2 serving", x)
    check(int(x["serve_kg_step"]) > 0 and np.isfinite(float(x["serve_checksum"])),
          f"Mamba2 serving: known-good step {int(x['serve_kg_step'])} > 0, checksum finite")
    short = t_serve._parser().parse_args(SERVE_MAMBA_ARGS + ["--device", dev.type,
                                                             "--train-steps", "2"])
    _print_profile("Mamba2-130M training plane under traffic (T=2, incl. set-up)",
                   lambda: t_serve._train_under_traffic(cfg, short), 2)
    r = t_serve._decode(cfg, params, args)
    check(r["logits_finite"] and r["generated"].shape == (SERVE_DECODE_B, SERVE_DECODE_STEPS),
          "Mamba2 decode from the trained weights: logits finite, ids (4, 32)")
    _decode_report("Mamba2-130M", r)
    _profile_decode("Mamba2-130M", cfg, params, dev)
    _decode_vs_forward("Mamba2-130M (trained weights, K4 in the forward)", MAMBA_ARCH, cfg, params,
                       dev)
    del params
    part.end()
    torch.cuda.empty_cache()


def _serve_granite(dev) -> None:
    """22 (d): Granite-3.0-2B decode at full width and depth (bf16, random
    weights from the seed)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as t_serve
    from repro_torch.models import api
    from repro_torch.models.module import init_params

    part = _Part("Granite-3.0-2B decode (phase 22)")
    cfg = get_config(LM_ARCH)
    params = init_params(api.model_meta(cfg), 0, dev)
    args = t_serve._parser().parse_args(["--batch", str(SERVE_DECODE_B), "--prompt-len",
                                         str(SERVE_DECODE_PROMPT), "--steps",
                                         str(SERVE_DECODE_STEPS), "--device", dev.type])
    r, _ = _timed(lambda: t_serve._decode(cfg, params, args))
    check(r["logits_finite"], "Granite-3.0-2B decode: logits finite")
    _decode_report("Granite-3.0-2B (40 layers)", r)
    _decode_vs_forward("Granite-3.0-2B", LM_ARCH, cfg, params, dev)
    del params
    part.end()
    torch.cuda.empty_cache()


def _serve_moe(dev, launches: dict) -> None:
    """22 (e): Qwen1.5-MoE-A2.7B decode at full width, depth `MOE_LAYERS`,
    under the sort dispatch: K5 (``use_pallas``) against the plain experts
    on the same tokens, on the tokens routed to the same experts in both."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_gmm as k5
    from repro_torch.launch.serve import materialize_cache
    from repro_torch.models import api
    from repro_torch.models import layers as L
    from repro_torch.models.module import init_params

    part = _Part("Qwen1.5-MoE decode (phase 22)")
    cfg = get_config(MOE_ARCH).replace(num_layers=MOE_LAYERS, moe_dispatch="sort")
    params = init_params(api.model_meta(cfg), 0, dev)
    B, S = SERVE_DECODE_B, SERVE_DECODE_PROMPT + SERVE_DECODE_STEPS
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S))).to(dev)
    router, seen = L._router, []

    def spy(p, xg, c):  # every routed token's experts and its top-k margin
        probs, g, idx = router(p, xg, c)
        top = torch.topk(probs, c.num_experts_per_tok + 1, dim=-1).values
        seen.append((torch.sort(idx, dim=-1).values, top[:, -2] - top[:, -1]))
        return probs, g, idx

    def decode(c):
        cache = materialize_cache(api.init_cache(c, B, S), dev)
        out = []
        with torch.no_grad():
            for t in range(S):
                lg, cache = api.decode_step(params, cache, {"tokens": toks[:, t:t + 1]}, c)
                out.append(lg)
        torch.cuda.synchronize()
        return torch.stack(out, dim=1)

    path = launches.setdefault("serve_decode_moe", {"moe_gmm": 0})
    L._router = spy
    try:
        k5.reset_launches()
        kern, wall_k = _timed(lambda: decode(cfg.replace(use_pallas=True)))
        n5 = k5.launches["moe_gmm"]
        plain, wall_p = _timed(lambda: decode(cfg.replace(use_pallas=False)))
    finally:
        L._router = router
    path["moe_gmm"] += n5
    # per step MOE_LAYERS router calls of B tokens: the kernel run, then the plain
    idx = torch.stack([i for i, _ in seen]).view(2, S, MOE_LAYERS, B, -1)
    margin = torch.stack([m for _, m in seen]).view(2, S, MOE_LAYERS, B)
    same = (idx[0] == idx[1]).all(-1).all(1).t()  # (B, S): the same experts at every layer
    near = (margin.amin(dim=(0, 2)).t() <= SERVE_ROUTER_TIE)
    scale = float(plain.float().abs().max())
    gaps = (kern.float() - plain.float()).abs().amax(-1) / scale
    err = float(gaps[same].max()) if bool(same.any()) else float("nan")
    print(f"Qwen1.5-MoE decode ({MOE_LAYERS} layers, B={B}, {S} steps, sort dispatch): K5 "
          f"{wall_k:.3f} s ({B * S / wall_k:.1f} tokens/s), plain experts {wall_p:.3f} s "
          f"({B * S / wall_p:.1f} tokens/s); K5 "
          f"launches {n5}; {int(near.sum())} of {B * S} tokens within {SERVE_ROUTER_TIE} of a "
          f"router tie (random init: a near-uniform router), {int((~same).sum())} routed to "
          f"other experts with and without K5")
    check(n5 == 3 * MOE_LAYERS * S, f"Qwen1.5-MoE decode: K5 launches {n5} == 3 x {MOE_LAYERS} "
          f"layers x {S} steps")
    check(bool(torch.isfinite(kern.float()).all()) and int(same.sum()) >= B * S // 2
          and err <= TOL[torch.bfloat16],
          f"Qwen1.5-MoE decode, K5 against the plain experts on the {int(same.sum())} tokens "
          f"routed alike: gap {err:.3e} of the largest logit <= {TOL[torch.bfloat16]} (bf16)")
    del params, kern, plain
    part.end()
    torch.cuda.empty_cache()


def _serve_driver(dev) -> None:
    """22 (f): the serving driver's command line on the card
    (`tests/test_serve_driver.py`'s arguments, the default device)."""
    from repro_torch.launch.serve import run_serve

    r, wall = _timed(lambda: run_serve(SERVE_DRIVER_ARGS + ["--device", dev.type]))
    x = {k: v for k, v in r.items() if k.startswith("serve_")}
    print(f"run_serve({' '.join(SERVE_DRIVER_ARGS)}) on the card: {wall:.3f} s, "
          f"{r['tok_per_s']:.1f} tokens/s, serve counters {_serve_counts(x)}")
    _serve_conserved("run_serve on the card", x)
    check(r["logits_finite"] and r["generated"].shape == (2, 4)
          and int(x["serve_kg_step"]) > 0 and np.isfinite(float(x["serve_checksum"])),
          "run_serve on the card: logits finite, ids (2, 4), known-good step moved, checksum "
          "finite")


def phase_serve(dev, launches: dict) -> None:
    """22. The serving plane (see the module docstring); adds K4's launches
    to ``launches`` under "serve_mamba2" and K5's under "serve_decode_moe"."""
    from repro_torch.data.pipeline import FederatedClassification

    t0 = time.perf_counter()
    _serve_card(dev)
    t1 = time.perf_counter()
    flc = _mlp_flc(dev)
    _serve_mlp(dev, FederatedClassification(n_clients=flc.n_clients, seed=flc.seed))
    t2 = time.perf_counter()
    with _card_memory(10, "22 (c): Mamba2-130M under traffic, decode"):
        _serve_mamba(dev, launches)
    t3 = time.perf_counter()
    with _card_memory(24, "22 (d): Granite-3.0-2B decode"):
        _serve_granite(dev)
    with _card_memory(20, "22 (e): Qwen1.5-MoE decode"):
        _serve_moe(dev, launches)
    t4 = time.perf_counter()
    _serve_driver(dev)
    t5 = time.perf_counter()
    print(f"phase 22 times: merged stream {t1 - t0:.1f} s, MLP {t2 - t1:.1f} s, Mamba2 training "
          f"and decode {t3 - t2:.1f} s, Granite and MoE decode {t4 - t3:.1f} s, the driver "
          f"{t5 - t4:.1f} s; phase 22 {t5 - t0:.1f} s")


def _lm_weights(n: int) -> list:
    """A few importance weights 1/(n p_j) of the LM slice's network (its
    speeds and optimal sampling vector, `run_lm`'s), for the train steps."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.pipeline import make_client_speeds
    from repro_torch.fl.engine import sampling_for

    flc = FLConfig(n_clients=LM_N, concurrency=LM_C, speed_ratio=10.0, sampling="optimal")
    mu = make_client_speeds(LM_N, flc.frac_fast, flc.speed_ratio, seed=0)
    p = sampling_for(flc, mu)
    return [float(1.0 / (LM_N * p[j])) for j in (0, LM_N - 1, 1, LM_N - 2)][:n]


def _peak_gib() -> float:
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def _train_steps(cfg, box: list, batch, opt, weights: list, steps: int):
    """``steps`` `api.train_step`s from the params in ``box`` (taken out, so
    that the caller holds no reference to the first step's old params), the
    sampling weight cycling over ``weights`` (0-d fp32 tensors on the card):
    ``(params, state, [metrics])``."""
    from repro_torch.models import api

    params = box.pop()
    state = opt.init(params)
    out = []
    for i in range(steps):
        w = weights[i % len(weights)]
        params, state, m = api.train_step(params, state, batch, cfg, opt, w)
        out.append(m)
    return params, state, out


def _optim_mamba(dev, launches: dict) -> dict:
    """23 (a) Mamba2-130M at full width and depth, K4, AdamW; (b) its first
    step with the plain SSD.  Returns the step's ms, tokens/s and peak."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.launch.dryrun import optimizer_for
    from repro_torch.models import api
    from repro_torch.models.module import init_params
    from repro_torch.optim import make_optimizer

    part = _Part("Mamba2-130M train_step (phase 23)")
    cfg = get_config(MAMBA_ARCH).replace(use_pallas=True, remat="none")  # pinned
    params0 = init_params(api.model_meta(cfg), 0, dev)
    batch = _lm_batch(cfg, LM_BATCH, LM_SEQ, 0, dev)
    opt = make_optimizer(optimizer_for(cfg))
    weights = [torch.tensor(w, dtype=torch.float32, device=dev) for w in _lm_weights(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k4.reset_launches()
    # the first step alone (held to the plain SSD in (b)), then the warm-up
    (first, state, m0), wall0 = _timed(lambda: api.train_step(params0, opt.init(params0), batch,
                                                              cfg, opt, weights[0]))
    print(f"Mamba2-130M train_step: the first step (set-up of its kernels and the "
          f"optimizer state included) {wall0:.3f} s")
    params, metrics = first, [m0]
    for i in range(1, OPTIM_WARM):
        params, state, m = api.train_step(params, state, batch, cfg, opt, weights[i % 4])
        metrics.append(m)

    def timed_steps():
        nonlocal params, state
        for i in range(OPTIM_STEPS):
            params, state, m = api.train_step(params, state, batch, cfg, opt,
                                              weights[(OPTIM_WARM + i) % 4])
            metrics.append(m)

    _, wall = _timed(timed_steps)
    n4 = k4.launches["ssd_scan"]
    peak = _peak_gib()
    path = launches.setdefault("optim_mamba2", {"ssd_scan": 0})
    path["ssd_scan"] += n4
    steps = OPTIM_WARM + OPTIM_STEPS
    ms = wall * 1e3 / OPTIM_STEPS
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    print(f"Mamba2-130M train_step (full width and depth, K4, AdamW fp32 moments, batch "
          f"{LM_BATCH} x {LM_SEQ}): {ms:.3f} ms a step over {OPTIM_STEPS} timed, "
          f"{LM_BATCH * LM_SEQ * 1e3 / ms:.1f} tokens/s, peak {peak:.3f} GiB; loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}, grad_norm {norms[0]:.4f} -> {norms[-1]:.4f}; "
          f"K4 launches {n4}")
    check(n4 == cfg.num_layers * steps,
          f"Mamba2 train_step: K4 launches {n4} == {cfg.num_layers} layers x {steps} steps")
    check(losses[-1] < losses[0], f"Mamba2 train_step: loss falls {losses[0]:.5f} -> "
          f"{losses[-1]:.5f} over {steps} steps on one batch")
    check(all(np.isfinite(norms)), "Mamba2 train_step: every grad_norm finite")
    check(int(state["count"]) == steps and state["count"].dtype == torch.int32,
          f"Mamba2 train_step: count {int(state['count'])} == {steps}, int32")
    check(all(t.dtype == torch.float32 for k in ("m", "v") for t in _leaves(state[k])),
          "Mamba2 train_step: AdamW's moments are fp32")
    _print_profile("Mamba2-130M train_step (one step, K4)", lambda: api.train_step(
        params, state, batch, cfg, opt, weights[0]), 1)
    # (b) the same first step with the plain SSD
    plain_cfg = cfg.replace(use_pallas=False)
    p_plain, _, m_plain = api.train_step(params0, opt.init(params0), batch, plain_cfg, opt,
                                         weights[0])
    scale = max(float(t.float().abs().max()) for t in _leaves(p_plain))
    gap = max(max_err(a, b) for a, b in zip(_leaves(first), _leaves(p_plain)))
    dloss = abs(float(m0["loss"]) - float(m_plain["loss"]))
    print(f"Mamba2 first step, K4 vs the plain SSD: new params gap {gap:.3e} (largest "
          f"{scale:.3f}), loss {float(m0['loss']):.6f} vs {float(m_plain['loss']):.6f}")
    check(gap <= TOL[torch.bfloat16] * scale and dloss <= TOL[torch.bfloat16] * abs(
        float(m_plain["loss"])), f"Mamba2 first step K4 vs plain SSD: params gap {gap:.3e} <= "
          f"2e-2 x {scale:.3f}, loss gap {dloss:.3e} <= 2e-2 of the loss")
    del params0, first, params, state, p_plain
    part.end()
    torch.cuda.empty_cache()
    return {"ms": ms, "tokens_s": LM_BATCH * LM_SEQ * 1e3 / ms, "peak_gib": peak, "cfg": cfg}


def _leaves(tree) -> list:
    from repro_torch.tree import tree_leaves

    return tree_leaves(tree)


def _ulp_bf16(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |x| (8 significant bits; the smallest normal's
    ulp below it)."""
    a = x.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _optim_update(dev) -> None:
    """23 (c) each optimizer's update alone on the card against the same
    update on CPU copies of the same grads, state and params, 3 steps."""
    from repro_torch.configs.base import OptimConfig
    from repro_torch.optim import make_optimizer

    gen = torch.Generator().manual_seed(23)
    params = {"w32": torch.randn((1024, 384), generator=gen),
              "w16": torch.randn((1024, 384), generator=gen).to(torch.bfloat16),
              "b": torch.randn((384,), generator=gen) * 0.1}
    grads = [{k: (torch.randn(v.shape, generator=gen) * 0.3).to(v.dtype) for k, v in
              params.items()} for _ in range(3)]
    worst = {}
    for name in ("sgd", "momentum", "adamw"):
        for sdt in ("float32", "bfloat16"):
            opt = make_optimizer(OptimConfig(name=name, lr=0.05, weight_decay=0.01,
                                             state_dtype=sdt))
            pc, pd = params, {k: v.to(dev) for k, v in params.items()}
            sc, sd_ = opt.init(pc), opt.init(pd)
            for i, g in enumerate(grads):
                scale = (0.7, 1.9, 0.4)[i]
                pc, sc = opt.update(g, sc, pc, scale=scale)
                pd, sd_ = opt.update({k: v.to(dev) for k, v in g.items()}, sd_, pd, scale=scale)
                trees = [(pc, pd)] + [(sc[k], sd_[k]) for k in sc if k != "count"]
                for a_tree, b_tree in trees:
                    for cpu, card in zip(_leaves(a_tree), _leaves(b_tree)):
                        card = card.cpu()
                        d = (card.float() - cpu.float()).abs()
                        if cpu.dtype == torch.bfloat16:
                            key = (name, sdt, "bf16 ulps")
                            err = float((d / _ulp_bf16(cpu)).max())
                        else:
                            key = (name, sdt, "fp32 rel")
                            err = float(d.max()) / max(float(cpu.abs().max()), 1e-30)
                        worst[key] = max(worst.get(key, 0.0), err)
            check(int(sd_["count"]) == 3 and sd_["count"].device.type == "cuda",
                  f"optimizer {name} / {sdt}: count 3 on the card")
            if name != "sgd":
                want = torch.bfloat16 if sdt == "bfloat16" else torch.float32
                check(all(t.dtype == want for t in _leaves(sd_["m"])),
                      f"optimizer {name} / {sdt}: m kept in {want}")
    for (name, sdt, unit), err in sorted(worst.items()):
        limit = 1.0 if unit == "bf16 ulps" else OPTIM_F32_REL
        print(f"optimizer {name} / {sdt} state, card vs CPU over 3 steps: {unit} {err:.3e}")
        check(err <= limit, f"optimizer {name} / {sdt}: card vs CPU {unit} {err:.3e} <= {limit}")
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import optimizer_for

    ocfg = optimizer_for(get_config("arctic-480b"))
    opt = make_optimizer(ocfg)
    st = opt.init({"w": torch.zeros((8,), dtype=torch.bfloat16, device=dev)})
    check(ocfg.name == "momentum" and st["m"]["w"].dtype == torch.bfloat16,
          "Arctic's optimizer_for: momentum with m kept in bf16")


def _optim_moe(dev, launches: dict) -> dict:
    """23 (d) Qwen1.5-MoE-A2.7B, depth MOE_LAYERS, sort dispatch, K3 + K5,
    AdamW: OPTIM_MOE_STEPS steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import moe_gmm as k5
    from repro_torch.launch.dryrun import optimizer_for
    from repro_torch.models import api
    from repro_torch.models.module import init_params
    from repro_torch.optim import make_optimizer

    part = _Part("Qwen1.5-MoE train_step (phase 23)")
    cfg = get_config(MOE_ARCH).replace(num_layers=MOE_LAYERS, moe_dispatch="sort",
                                       use_pallas=True)
    params = init_params(api.model_meta(cfg), 0, dev)
    batch = _lm_batch(cfg, LM_BATCH, LM_SEQ, 0, dev)
    opt = make_optimizer(optimizer_for(cfg))
    weights = [torch.tensor(w, dtype=torch.float32, device=dev) for w in _lm_weights(4)]
    loss0 = float(api.loss_fn(params, batch, cfg)[0])
    box = [params]
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k3.reset_launches()
    k5.reset_launches()
    (params, state, metrics), wall = _timed(
        lambda: _train_steps(cfg, box, batch, opt, weights, OPTIM_MOE_STEPS))
    n3, n5 = k3.launches["flash_attention"], k5.launches["moe_gmm"]
    peak = _peak_gib()
    reserved = torch.cuda.max_memory_reserved() / 2**30
    path = launches.setdefault("optim_moe", {"flash_attention": 0, "moe_gmm": 0})
    path["flash_attention"] += n3
    path["moe_gmm"] += n5
    ms = wall * 1e3 / OPTIM_MOE_STEPS
    losses = [float(m["loss"]) for m in metrics]
    aux = [float(m["moe_aux"]) for m in metrics]
    print(f"Qwen1.5-MoE train_step ({MOE_LAYERS} of 24 layers, sort dispatch, K3 + K5, AdamW "
          f"fp32 moments, batch {LM_BATCH} x {LM_SEQ}): {ms:.3f} ms a step over "
          f"{OPTIM_MOE_STEPS}, {LM_BATCH * LM_SEQ * 1e3 / ms:.1f} tokens/s, peak {peak:.3f} GiB "
          f"({reserved:.3f} reserved); "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, moe_aux {aux[0]:.5f} -> {aux[-1]:.5f}; "
          f"K3 launches {n3}, K5 {n5}")
    passes = _passes(cfg, "moe_gmm")  # remat "full": K3 and K5 twice a gradient
    check(n3 == passes * MOE_LAYERS * OPTIM_MOE_STEPS
          and n5 == passes * 3 * MOE_LAYERS * OPTIM_MOE_STEPS,
          f"Qwen1.5-MoE train_step (remat {cfg.remat}): K3 launches {n3} == {passes} x "
          f"{MOE_LAYERS} x {OPTIM_MOE_STEPS}, K5 {n5} == {passes} x 3 x {MOE_LAYERS} x "
          f"{OPTIM_MOE_STEPS}")
    check(losses[-1] < losses[0], f"Qwen1.5-MoE train_step: loss falls {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}")
    check(all(np.isfinite(a) and a > 0 for a in aux), "Qwen1.5-MoE train_step: moe_aux finite, > 0")
    check(losses[0] == loss0, f"Qwen1.5-MoE train_step: the first step's loss {losses[0]!r} "
          f"equals api.loss_fn's on the same params {loss0!r}")
    del params, state
    part.end()
    torch.cuda.empty_cache()
    return {"ms": ms, "tokens_s": LM_BATCH * LM_SEQ * 1e3 / ms, "peak_gib": peak, "cfg": cfg}


def _optim_dryrun(runs: dict) -> None:
    """23 (e) the dry run of (a)'s and (d)'s steps at the card's own shape,
    against the card's peak and ms a step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import run_pair
    from repro_torch.models import api
    from repro_torch.models.module import param_count

    shape = ShapeConfig("smoke", LM_SEQ, LM_BATCH, "train")
    for label, r in runs.items():
        cfg = r["cfg"]
        rec = run_pair(label, shape, out_dir=str(OPTIM_DRYRUN_ROOT), cfg=cfg)
        check(bool(rec.get("ok")), f"dry run of {label}: ok ({rec.get('error', '')[:200]})")
        if not rec.get("ok"):
            continue
        arg = rec["memory"]["argument_bytes"]
        flops = rec["hlo_flops_total"]
        print(f"dry run of {label} at {LM_BATCH} x {LM_SEQ} (meta device, {rec['wall_s']} s): "
              f"argument bytes {arg} ({arg / 2**30:.3f} GiB), output bytes "
              f"{rec['memory']['output_bytes']}; counted FLOPs {flops:.4e} at remat "
              f"{rec['remat']} ({rec['hlo_flops_remat_none']:.4e} at none) against "
              f"model_flops_total (6 N D) {rec['model_flops_total']:.4e} (ratio "
              f"{rec['useful_flops_ratio']:.4f}; {rec['useful_flops_ratio_remat_none']:.4f} at "
              f"none); bytes {rec['bytes_per_device']:.4e}, dominant "
              f"{rec['dominant']}; the card's peak {r['peak_gib']:.3f} GiB; achieved "
              f"{flops / (r['ms'] * 1e-3) / 1e12:.3f} TFLOP/s at {r['ms']:.3f} ms a step "
              f"({_SHARED.get('smi', 'card not queried')})")
        check(rec["params"] == param_count(api.model_meta(cfg)),
              f"dry run of {label}: params {rec['params']} == param_count")
        check(r["peak_gib"] * 2**30 >= arg, f"dry run of {label}: the card's peak "
              f"{r['peak_gib']:.3f} GiB >= argument bytes {arg / 2**30:.3f} GiB")
    shutil.rmtree(OPTIM_DRYRUN_ROOT, ignore_errors=True)


class _DuckTask:
    """A task that is neither `ClassificationTask` nor `LMTask`: the
    reference's duck typing (``cache_key()``, ``build(data, seed,
    n_clients)``), its build wrapping `ClassificationTask`'s on the card."""

    def __init__(self):
        from repro_torch.fl.engine import ClassificationTask

        self.inner = ClassificationTask()

    def cache_key(self):
        return ("duck",) + tuple(self.inner.cache_key())

    def build(self, data, seed, n_clients, device="cuda"):
        return self.inner.build(data, seed, n_clients, device=device)


def _optim_duck(dev, launches: dict) -> None:
    """23 (f) a duck-typed task through `run_experiment` (scan), the K1
    replay of its setup and `run_matrix` over 2 cells with K1 across them,
    bitwise the same runs with `ClassificationTask`."""
    from repro_torch.core.async_sgd import ServerConfig, run_generalized_async_sgd
    from repro_torch.data.pipeline import FederatedClassification, make_client_speeds
    from repro_torch.fl.engine import ClassificationTask, _cached_fl_setup, run_experiment
    from repro_torch.fl.engine import run_matrix, sampling_for
    from repro_torch.kernels import weighted_update as wu

    flc = _mlp_flc(dev).replace(server_steps=OPTIM_DUCK_T)
    path = launches.setdefault("optim_duck", {})
    out = {}
    for name, task in (("duck", _DuckTask()), ("classification", ClassificationTask())):
        data = FederatedClassification(n_clients=flc.n_clients, seed=flc.seed)
        r = run_experiment(flc, "gen_async", eval_every=100, data=data, task=task)
        setup = _cached_fl_setup(data, flc.seed, task, n_clients=flc.n_clients, device=dev)
        mu = make_client_speeds(flc.n_clients, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
        cfg = ServerConfig(n=flc.n_clients, C=flc.concurrency, T=flc.server_steps, eta=0.05,
                           mu=mu, p=sampling_for(flc, mu), seed=flc.seed, eval_every=100,
                           engine="scan", weighting="importance", update="pallas",
                           device=dev.type)
        wu.reset_launches()
        w_k1, _ = run_generalized_async_sgd(setup.params, setup.clients, cfg,
                                            eval_fn=setup.eval_fn)
        if name == "duck":
            _k1_counts(path, "duck-typed task", flc.server_steps, len(MLP_LEAVES))
        wu.reset_launches()
        m = run_matrix(flc, seeds=(0, 1), policies=("optimal",), eval_every=100, data=data,
                       task=task, kernel="pallas")
        if name == "duck":
            n1 = wu.launches["weighted_update"]
            path["weighted_update"] += n1
            check(n1 >= flc.server_steps and n1 % flc.server_steps == 0,
                  f"duck-typed matrix over 2 cells: K1 launches {n1}, a whole number a step "
                  f"of the {flc.server_steps}")
        out[name] = (r, w_k1, m)
    (r_d, w_d, m_d), (r_c, w_c, m_c) = out["duck"], out["classification"]
    same = (all(torch.equal(r_d.final_params[k], r_c.final_params[k]) for k in r_c.final_params)
            and np.array_equal(r_d.eval_acc, r_c.eval_acc)
            and all(torch.equal(w_d[k], w_c[k]) for k in w_c)
            and np.array_equal(m_d.eval_acc, m_c.eval_acc)
            and np.array_equal(m_d.final_acc, m_c.final_acc))
    print(f"duck-typed task on the card (T={flc.server_steps}): run_experiment acc "
          f"{r_d.eval_acc.tolist()}, K1 replay, run_matrix over 2 cells final acc "
          f"{m_d.final_acc.ravel().tolist()}")
    check(same, "duck-typed task: run_experiment, the K1 replay and run_matrix bitwise the "
          "same runs with ClassificationTask")


def _optim_quickstart():
    """23 (g) `examples/torch/quickstart.py` in a child process on the card,
    on a thread beside the phase's other parts (its process start-up and
    host simulation hold the card little); the caller joins it."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))

    def child():
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(root / "examples" / "torch" / "quickstart.py")],
                             capture_output=True, text=True, timeout=300, env=env, cwd=root)
        return res, time.perf_counter() - t0

    return ThreadPoolExecutor(1).submit(child)


def _optim_quickstart_check(job) -> None:
    res, wall = job.result()
    tail = res.stdout.strip().splitlines()[-3:]
    print(f"examples/torch/quickstart.py: exit {res.returncode} in {wall:.1f} s (beside the "
          f"phase's other parts); {tail}")
    if res.returncode:
        print(res.stderr[-3000:])
    check(res.returncode == 0, "examples/torch/quickstart.py exits 0 on the card")


def phase_optim(dev, launches: dict) -> None:
    """23. The optimizer step (see `OPTIM_WARM`): adds K4's launches to
    ``launches`` under "optim_mamba2", K3's and K5's under "optim_moe", K1's
    under "optim_duck"."""
    t0 = time.perf_counter()
    quickstart = _optim_quickstart()
    with _card_memory(12, "23 (a)-(b): Mamba2-130M train_step"):
        mamba = _optim_mamba(dev, launches)
    _optim_update(dev)
    t1 = time.perf_counter()
    with _card_memory(62, "23 (d): Qwen1.5-MoE train_step"):
        moe = _optim_moe(dev, launches)
    t2 = time.perf_counter()
    _optim_dryrun({MAMBA_ARCH: mamba, MOE_ARCH: moe})
    t3 = time.perf_counter()
    _optim_duck(dev, launches)
    t4 = time.perf_counter()
    _optim_quickstart_check(quickstart)
    t5 = time.perf_counter()
    print(f"phase 23 times: Mamba2 and the update {t1 - t0:.1f} s, MoE {t2 - t1:.1f} s, the dry "
          f"run {t3 - t2:.1f} s, the duck-typed task {t4 - t3:.1f} s, waiting for the "
          f"quickstart {t5 - t4:.1f} s; phase 23 {t5 - t0:.1f} s")


def _leaf_gaps(names: list, got: list, ref: list) -> tuple:
    """``(max gap / max|ref|, the 3 leaves with the largest gaps as (name,
    gap / max|ref|, gap / the leaf's own max|ref|, the gap's flat index,
    the leaf's shape))`` over a gradient tree's leaves."""
    gmax = max(float(r.abs().max()) for r in ref)
    rows = []
    for n, a, b in zip(names, got, ref):
        d = (a - b).abs()
        gap = float(d.max())
        rows.append((n, gap / gmax, gap / max(float(b.abs().max()), 1e-30),
                     int(d.argmax()), tuple(b.shape)))
    rows.sort(key=lambda r: -r[1])
    return rows[0][1], rows[:3]


def _card_context(dev) -> None:
    """Measure what a process holds on the card beside its allocator's
    reserve (the CUDA context, cuBLAS's handle, the loaded modules) while
    this process is alone on the card, after one bf16 product, and write it
    to `LANE_DIR` for phase 25's check (a rank's memory is its reserved peak
    plus this)."""
    a = torch.ones((64, 64), device=dev, dtype=torch.bfloat16)
    (a @ a).sum().item()
    free, total = torch.cuda.mem_get_info()
    gib = ((total - free) - torch.cuda.memory_reserved()) / 2**30
    LANE_DIR.mkdir(parents=True, exist_ok=True)
    (LANE_DIR / "card_context.json").write_text(json.dumps({"gib": gib}))
    print(f"card: a process's CUDA context and modules {gib:.3f} GiB (alone on the card; "
          f"{torch.cuda.memory_reserved() / 2**20:.0f} MiB reserved)")


def _sharded_rank(rank: int, world: int, device: str, t_spawn: float) -> dict:
    """One rank of phase 25.  First the one-rank steps the sharded ones are
    held to, one dtype a rank (`SHARDED_REF_RANK`, side by side, each
    through `SHARDED_REF_KERNEL`'s attention; bf16 twice, the second
    timed); the fp32 rank then takes one bf16 step through K3 and compares
    it with its fp32 one (the gap bf16 alone makes).  Then for bf16 and
    fp32, on each of `SHARDED_MESHES`, the sharded step (`api.train_step`
    on DTensor parameters under `shardings.activate_rules`): one step
    counted by `op_analysis.OpCounter` (the rank's FLOPs and collective
    bytes) and held against the one-rank step (loss; the new first moment
    m = 0.1 g, gathered whole; a bf16 step also against the fp32 one-rank
    step), then in bf16 `SHARDED_STEPS` timed steps.  K3's count is zeroed
    just before each mesh's steps and read just after; each part's seconds
    are recorded, and the rank's reserved peak."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.models import api
    from repro_torch.models.module import _map_with_path, init_params
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    opt = make_optimizer(OptimConfig(name="adamw", state_dtype="float32"))
    weight = torch.tensor(0.7, device=dev)
    out: dict = {"parts_s": {"start-up": round(time.time() - t_spawn, 3)}}
    t_part = time.perf_counter()
    reserved = 0  # the rank's reserved peak across the parts' resets

    def part(name: str) -> None:
        nonlocal t_part
        torch.cuda.synchronize()
        out["parts_s"][name] = round(time.perf_counter() - t_part, 3)
        t_part = time.perf_counter()

    def reset_peak() -> None:
        nonlocal reserved
        reserved = max(reserved, torch.cuda.max_memory_reserved())
        torch.cuda.reset_peak_memory_stats()

    def setup(dtype: str) -> tuple:
        """(cfg, meta, weights, batch) of a dtype, made anew where needed
        (the same from the seed), so that a rank holds one dtype's at a time."""
        cfg = get_config(SHARDED_ARCH).replace(num_layers=SHARDED_LAYERS, dtype=dtype,
                                               use_pallas=True, remat="none")
        meta = api.model_meta(cfg)
        return cfg, meta, init_params(meta, 0, dev), _lm_batch(cfg, LM_BATCH, LM_SEQ, 1, dev)

    names = tree_leaves(_map_with_path(lambda path, _: path, api.model_meta(
        get_config(SHARDED_ARCH).replace(num_layers=SHARDED_LAYERS))))

    def one_rank(dtype: str, kernel: bool):
        cfg, _, params, batch = setup(dtype)
        cfg = cfg.replace(use_pallas=kernel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, s1, m1 = api.train_step(params, opt.init(params), batch, cfg, opt, weight)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return float(m1["loss"]), [m.float() for m in tree_leaves(s1["m"])], ms

    refs = {}
    for dtype, owner in SHARDED_REF_RANK.items():
        if rank != owner:
            continue
        for i in range(2 if dtype == "bfloat16" else 1):  # the last one timed
            loss, grads, ms = one_rank(dtype, SHARDED_REF_KERNEL[dtype])
            if i == 0:
                out[f"{dtype}_first_step_ms"] = ms
            out[f"{dtype}_one_rank_ms"] = ms
        refs[dtype] = (loss, grads)
    part("one-rank steps")
    if "float32" in refs:  # the gap bf16 alone makes, on one rank
        loss, grads, _ = one_rank("bfloat16", True)
        ref_loss, ref_m = refs["float32"]
        out["bf16_vs_fp32_loss_rel"] = abs(loss - ref_loss) / abs(ref_loss)
        out["bf16_vs_fp32_grad_gap"], out["bf16_vs_fp32_leaves"] = _leaf_gaps(names, grads, ref_m)
        del grads
        part("one-rank bf16 against fp32")
    for dtype in SHARDED_REF_RANK:
        cfg, meta, params, batch = setup(dtype)
        part(f"{dtype} weights")
        for data, model, rules_name in SHARDED_MESHES:
            key = f"{dtype}_{data}x{model}"
            mesh = make_debug_mesh(data, model)
            rules = SH.filter_rules(SH.RULE_SETS[rules_name], mesh)
            dp = SH.distribute_params(params, mesh, rules, meta)
            db = {k: SH.distribute_like(v, mesh, SH.logical_to_pspec(
                ("batch", "seq"), {**rules, "seq": None}, tuple(v.shape), mesh))
                for k, v in batch.items()}

            def step(p):
                st = opt.init(p)
                st = {"count": SH.distribute_like(st["count"], mesh, ()), "m": st["m"],
                      "v": st["v"]}
                with SH.activate_rules(rules, mesh):
                    return api.train_step(p, st, db, cfg, opt, weight)

            reset_peak()
            fa.reset_launches()
            counter = OpCounter()
            with counter:
                _, s2, m2 = step(dp)
            counted = counter.result()
            steps = 1
            part(f"{key} counted step")
            loss = float(m2["loss"].full_tensor())
            grads = [m.full_tensor().float() for m in tree_leaves(s2["m"])]
            del s2, m2
            row = {"collective_bytes": counted["collectives"]["total"],
                   "collectives": counted["collectives"],
                   "flops": counted["flops"], "loss": loss,
                   "embed_shard": tuple(dp["embed"].to_local().shape)}
            if dtype in refs:
                ref_loss, ref_m = refs[dtype]
                row["loss_rel"] = abs(loss - ref_loss) / abs(ref_loss)
                row["grad_gap"], row["leaves"] = _leaf_gaps(names, grads, ref_m)
            if dtype == "bfloat16" and "float32" in refs:
                ref_loss, ref_m = refs["float32"]
                row["vs_fp32_loss_rel"] = abs(loss - ref_loss) / abs(ref_loss)
                row["vs_fp32_grad_gap"], row["vs_fp32_leaves"] = _leaf_gaps(names, grads, ref_m)
            del grads
            part(f"{key} gathered and compared")
            if dtype == "bfloat16":  # the counted step warmed it up
                t0 = time.perf_counter()
                for _ in range(SHARDED_STEPS):
                    step(dp)
                torch.cuda.synchronize()
                row["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / SHARDED_STEPS
                steps += SHARDED_STEPS
                part(f"{key} timed steps")
            row["steps"] = steps
            row["launches"] = fa.launches["flash_attention"]
            row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            out[key] = row
            del dp, db
        refs.pop(dtype, None)  # the fp32 one stays through the bf16 meshes
        del params, batch
        torch.cuda.empty_cache()
    reset_peak()
    torch.cuda.synchronize()
    out["reserved_peak_gib"] = reserved / 2**30
    return out


def phase_sharded(dev, launches: dict) -> None:
    """25. The model-sharded train step (`_sharded_rank`) on 2 gloo ranks
    sharing the card (`launch.lanes.run_lanes`; NCCL needs a card a rank):
    each dtype's comparison on the rank that ran its one-rank step, the
    loss equal on both ranks, K3 launches == layers a step on
    every rank (the attention of each rank's local heads, through
    ``local_map``), ms a step, collective bytes and peak GiB a rank, the
    leaves that set the bf16 gaps, and the ranks' card memory within
    `SHARDED_GIB`."""
    from repro_torch.launch.lanes import run_lanes

    t0 = time.perf_counter()
    ranks = run_lanes(_sharded_rank, 2, (dev.type, t0 + time.time() - time.perf_counter()),
                      timeout=600)
    print(f"25: the sharded {SHARDED_ARCH} step ({SHARDED_LAYERS} layers, batch {LM_BATCH} x "
          f"{LM_SEQ}, AdamW), 2 gloo ranks on one card: {time.perf_counter() - t0:.1f} s with "
          f"the ranks' start; card {_SHARED.get('smi')}; the parts' seconds, rank 0 "
          f"{ranks[0]['parts_s']}, rank 1 {ranks[1]['parts_s']}")

    def leaves(rows):
        return "; ".join(f"{n} {g:.3e} of max|g| ({own:.3e} of its own max, at flat index "
                         f"{i} of {shape})" for n, g, own, i, shape in rows)

    for dtype, owner in SHARDED_REF_RANK.items():
        loss_tol, grad_tol = SHARDED_TOL[dtype]
        print(f"25 {dtype}: one-rank step ({'K3' if SHARDED_REF_KERNEL[dtype] else 'plain'} "
              f"attention) {ranks[owner][f'{dtype}_one_rank_ms']:.1f} ms, the rank's first step "
              f"{ranks[owner][f'{dtype}_first_step_ms']:.1f} ms (rank {owner})")
        for data, model, rules_name in SHARDED_MESHES:
            key = f"{dtype}_{data}x{model}"
            r0 = ranks[owner][key]
            for rank, res in enumerate(ranks):
                r = res[key]
                print(f"25 {dtype} mesh (data {data}, model {model}) rules {rules_name} rank "
                      f"{rank}: {r.get('ms_per_step', float('nan')):.1f} ms a step, collective "
                      f"bytes {r['collective_bytes']:.0f} {r['collectives']}, FLOPs "
                      f"{r['flops']:.4g}, peak {r['peak_gib']:.3f} GiB, embed shard "
                      f"{r['embed_shard']}, K3 launches {r['launches']} in {r['steps']} steps")
                check(r["launches"] == SHARDED_LAYERS * r["steps"],
                      f"25 {key} rank {rank}: K3 launches {r['launches']} == {SHARDED_LAYERS} "
                      f"x {r['steps']} steps")
                check(r["collective_bytes"] > 0, f"25 {key} rank {rank}: collective bytes "
                      f"{r['collective_bytes']:.0f} > 0")
                check(r["loss"] == r0["loss"], f"25 {key} rank {rank}: loss {r['loss']!r} "
                      f"== rank {owner}'s")
                launches[f"sharded_{key}_rank{rank}"] = {"flash_attention": r["launches"]}
            check(r0["loss_rel"] <= loss_tol and r0["grad_gap"] <= grad_tol,
                  f"25 {key}: against the one-rank step (rank {owner}), loss relative gap "
                  f"{r0['loss_rel']:.3e} <= {loss_tol}, gradients {r0['grad_gap']:.3e} <= "
                  f"{grad_tol} x max|g|")
            print(f"25 {key}: the largest gradient gaps against the one-rank step: "
                  f"{leaves(r0['leaves'])}")
            if dtype == "bfloat16":
                r1 = ranks[SHARDED_REF_RANK["float32"]][key]
                print(f"25 {key} against the fp32 one-rank step: loss relative gap "
                      f"{r1['vs_fp32_loss_rel']:.3e}, gradients {r1['vs_fp32_grad_gap']:.3e} "
                      f"x max|g|: {leaves(r1['vs_fp32_leaves'])}")
    r1 = ranks[SHARDED_REF_RANK["float32"]]
    print(f"25 one rank, bf16 (K3) against fp32 (plain): loss relative gap "
          f"{r1['bf16_vs_fp32_loss_rel']:.3e}, gradients {r1['bf16_vs_fp32_grad_gap']:.3e} x "
          f"max|g|: {leaves(r1['bf16_vs_fp32_leaves'])}")
    # each rank: its reserved peak plus a process's CUDA context, as phase 1
    # measured it alone on the card (`_card_context`)
    ctx_file = LANE_DIR / "card_context.json"
    check(ctx_file.exists(), f"25: phase 1's reading of a CUDA context ({ctx_file}) exists")
    context = json.loads(ctx_file.read_text())["gib"] if ctx_file.exists() else float("nan")
    peaks = [r["reserved_peak_gib"] for r in ranks]
    total = sum(peaks) + len(ranks) * context
    check(total <= SHARDED_GIB, f"25: the ranks' reserved peaks {[round(g, 3) for g in peaks]} "
          f"GiB and {len(ranks)} contexts of {context:.3f} GiB, {total:.3f} GiB <= the declared "
          f"{SHARDED_GIB} GiB")


GROUPS = KERNEL_GROUPS + LM_LANE + MLP_LANE


def _kernel_phases(dev, groups: set, done) -> dict:
    """2. and 11. The kernels of ``groups`` against their plain versions, in
    this process; their rows of the kernels line."""
    gen = torch.Generator().manual_seed(0)
    rows = {}
    if "k1k2k6" in groups:
        rows.update(phase_kernels(dev, gen))
    if "fa" in groups:
        rows.update(phase_flash_attention(dev))
    if "ssd" in groups:
        rows.update(phase_ssd_scan(dev))
    if "gmm" in groups:
        rows.update(phase_moe_gmm(dev))
    if rows:
        done("2, 11")
        torch.cuda.empty_cache()
    return rows


def _lm_lane(dev, groups: set, launches: dict, done) -> None:
    """The LM lane's phases of ``groups``, in this process: the Mamba2
    matrix first (see `phase_matrix_mamba`), each part inside its
    declaration of card memory."""
    if "matrix_mamba" in groups:
        with _card_memory(48, "17: the Mamba2-130M matrix"):
            phase_matrix_mamba(dev, launches)
        done("17 (Mamba2)")
    if "zamba" in groups:  # 24. the hybrid's training run
        with _card_memory(ZAMBA_GIB, "24: Zamba2-2.7B"):
            phase_zamba(dev, launches)
        done("24")
    if "granite" in groups:  # 7.-8. the dense LM slice
        with _card_memory(58, "7-8: Granite-3.0-2B"):
            phase_grad_check(dev, LM_ARCH)
            phase_lm(dev, launches)
        done("7-8")
    if "ssm" in groups:  # 9.-10. the SSM and hybrid slice
        with _card_memory(40, "9-10: Mamba2-130M and Zamba2-2.7B"):
            phase_grad_check(dev, MAMBA_ARCH)
            phase_grad_check(dev, "zamba2-2.7b")
            phase_mamba(dev, launches)
        done("9-10")
    if "moe" in groups:  # 12.-13. the MoE slice
        with _card_memory(52, "12-13: Qwen1.5-MoE-A2.7B"):
            phase_grad_check(dev, MOE_ARCH, num_layers=MOE_LAYERS)
            phase_moe_lm(dev, launches)
        done("12-13")
    if "serve" in groups:  # 22. the serving plane (its parts declare their memory)
        phase_serve(dev, launches)
        done("22")
    if "optim" in groups:  # 23. the optimizer step, the dry run, the examples
        phase_optim(dev, launches)
        done("23")


def _mlp_lane(dev, groups: set, launches: dict, done) -> None:
    """The MLP lane's phases of ``groups``, in this process."""
    blocked = None
    if "mlp" in groups:  # 3.-6. the MLP slice, each kernel path's launches counted per path
        blocked = phase_mlp(dev, launches)
        done("3-6")
    if "lanes" in groups:  # 14.-16. FedBuff, the lane-sharded MLP, the FL launcher, FedAvg, FAVANO
        phase_lanes(dev, launches, blocked)
        done("14-16")
    if "matrix" in groups:  # 17. the paper's 27-cell matrix
        phase_matrix(dev, launches)
        done("17 (MLP)")
    if "robust" in groups:  # 18. faults, the guard, scenarios, checkpoints, host stream
        phase_robust(dev, launches)
        done("18 (MLP)")
    if "stream" in groups:  # 19. the device event stream, control plane, adaptive sampling
        phase_stream(dev, launches)
        done("19")
    if "stream_robust" in groups:  # 20. faults, the guard, checkpoints on the device stream
        phase_stream_robust(dev, launches)
        done("20")
    if "sparse" in groups:  # 21. the sparse O(C) stream and the class-collapsed control plane
        phase_sparse(dev, launches)
        done("21")
    if "robust_mamba" in groups:  # 18., Mamba2-130M under faults, checkpointed
        with _card_memory(38, "18: Mamba2-130M under faults, checkpointed"):
            phase_robust_mamba(dev, launches)
        done("18 (Mamba2)")
    if "sharded" in groups:  # 25. the model-sharded train step on 2 gloo ranks
        with _card_memory(SHARDED_GIB, "25: the sharded Granite-3.0-2B step"):
            phase_sharded(dev, launches)
        done("25")


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma list of phase groups to run after the build (default: all "
                         f"of {', '.join(GROUPS)}); 'lanes' implies 'mlp'.  A partial run "
                         "prints no kernels line and no result line")
    ap.add_argument("--robust-child", nargs=2, metavar=("DIR", "MODE"),
                    help=argparse.SUPPRESS)  # phases 18 and 20's kill-and-resume child
    ap.add_argument("--lane-out", help=argparse.SUPPRESS)  # the MLP lane's process: its results
    ap.add_argument("--t-start", type=float, help=argparse.SUPPRESS)  # the run's start, epoch s
    ap.add_argument("--memory-history", action="store_true",
                    help="record the allocator's history around phase 17's blocked Mamba2 "
                         "matrix and print the owners of the live memory at K2's plain-version "
                         "entry (ROADMAP Queue 3); slows that run")
    args = ap.parse_args(argv)
    _SHARED["memory_history"] = args.memory_history
    groups = set(args.only.split(","))
    unknown = groups - set(GROUPS)
    if unknown:
        ap.error(f"unknown phase groups {sorted(unknown)}")
    if "lanes" in groups:
        groups.add("mlp")
    t_start = time.time() if args.t_start is None else args.t_start

    def done(phases: str) -> None:
        print(f"phases {phases} done at {time.time() - t_start:.1f} s (this process's CPU "
              f"{time.process_time():.1f} s, load average {os.getloadavg()[0]:.2f} on "
              f"{len(os.sched_getaffinity(0))} cores)", flush=True)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    if args.robust_child:
        return _robust_child(*args.robust_child, torch.device("cuda"))
    if args.lane_out:
        _die_with_parent()
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")
    _SHARED["smi"] = smi

    # 1. build every kernel source of the checkout, one nvcc each, in parallel
    t0 = time.perf_counter()
    srcs = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(srcs)) as pool:
        list(pool.map(lambda name: build.build(name, verbose=True), srcs))
    for name in srcs:
        build.load(name)
    print(f"build: {srcs} in {time.perf_counter() - t0:.2f} s")
    if not args.lane_out:  # the first process on the card, alone there
        _card_context(dev)
    done("1")

    launches: dict = {}
    if args.lane_out:  # a lane's process: its groups, then its results to the file
        _start_cpu_references(groups)
        rows = _kernel_phases(dev, groups, done)
        _lm_lane(dev, groups, launches, done)
        _mlp_lane(dev, groups, launches, done)
        _collect_cpu_references()
        Path(args.lane_out).write_text(json.dumps(
            {"failures": failures, "launches": launches, "rows": rows}))
        return 1 if failures else 0

    kern = [g for g in KERNEL_GROUPS if g in groups]
    lm = groups & set(LM_LANE)
    mlp = sorted(groups & set(MLP_LANE), key=MLP_LANE.index)
    LANE_DIR.mkdir(parents=True, exist_ok=True)
    (LANE_DIR / "card_memory.json").unlink(missing_ok=True)
    lane = None
    try:
        # 2. and 11. first and alone, in a process of their own when the run
        # has other phases (a profiler that has traced none of them)
        if kern and (lm or mlp):
            lane = _start_lane("kernel", kern, t_start)
            rows = _join_lane(lane, launches)
            done("2, 11 (the kernel lane)")
        else:
            rows = _kernel_phases(dev, groups, done)
        # the two lanes: the MLP lane in a second process when both run
        if lm and mlp:
            lane = _start_lane("MLP", mlp, t_start)
        _start_cpu_references(lm if lm and mlp else groups)
        _lm_lane(dev, groups, launches, done)
        if not (lm and mlp):
            _mlp_lane(dev, groups, launches, done)
        else:
            _join_lane(lane, launches)
            done("of the MLP lane")
    finally:
        if lane is not None and lane[2].poll() is None:
            _kill_tree(lane[2].pid)
    _collect_cpu_references()

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
        return 1
    if groups != set(GROUPS):
        print(f"chip_smoke: every check of {sorted(groups)} passed; a partial run, so no "
              "kernels line and no result line")
        return 0
    csrc = "src/repro_torch/kernels/csrc/"
    meta = {
        "weighted_update": ("weighted_update.cu", "src/repro/kernels/weighted_update.py:112"),
        "weighted_update_momentum": ("weighted_update.cu", "src/repro/kernels/weighted_update.py:96"),
        "block_prefix_update": ("weighted_update.cu", "src/repro/kernels/weighted_update.py:166"),
        "block_scatter_rows": ("weighted_update.cu", "src/repro/kernels/weighted_update.py:229"),
        "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:103"),
        "ssd_scan": ("ssd_scan.cu", "src/repro/kernels/ssd_scan.py:85"),
        "moe_gmm": ("moe_gmm.cu", "src/repro/kernels/moe_gmm.py:54"),
    }
    kernels = []
    for name, row in rows.items():
        by_path = {path: c[name] for path, c in launches.items() if name in c}
        extra = {}
        if name == "weighted_update":  # one launch an event: the leaves each covered
            extra["leaves_by_path"] = {path: c["weighted_update_leaves"]
                                       for path, c in launches.items()
                                       if "weighted_update_leaves" in c}
        if name == "block_scatter_rows":  # across cells: the cells each launch scattered
            extra["cells_by_path"] = {path: c["cells"] for path, c in launches.items()
                                      if name in c and "cells" in c}
        kernels.append(dict(name=name, route="cuda", source=csrc + meta[name][0],
                            replaces=meta[name][1], launches=sum(by_path.values()),
                            launches_by_path=by_path, **extra, **row))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
