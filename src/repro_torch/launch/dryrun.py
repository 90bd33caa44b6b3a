"""Dry run: trace every (arch × shape) step on the meta device and write its
cost terms, with no card and no memory allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun            # every arch × shape
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --multi-pod --rules tp_only

The counterpart of `repro.launch.dryrun`, which lowers and compiles each
step on a 512-device fake host mesh.  Here the step (`api.train_step` with
`optimizer_for`'s optimizer, `api.forward` for prefill, `api.serve_step`
for decode) runs once on meta tensors (`abstract_params`, the optimizer
state from ``opt.init``, `input_specs`, the decode cache): shapes and dtypes
flow through every operation, no storage is allocated, and
`launch.op_analysis` counts each aten operation's FLOPs and bytes.  That is
the meta device's nature, as fake devices are the reference's, so this runs
on any machine and hides no card.  On meta every kernel takes its plain
route: the trace clears ``use_pallas``.

Without a mesh flag the record is one card's (mesh ``1xH100``).  With
``--multi-pod`` (the 2x16x16 mesh), ``--both-meshes`` (16x16, then
2x16x16) or ``--rules NAME`` (a `shardings.RULE_SETS` entry; on the 16x16
mesh unless a mesh flag says otherwise) the step runs as rank 0 of a fake
process group of 256 or 512 ranks (`mesh.fake_world`) on
`mesh.make_production_mesh`: parameters, optimizer state (``count``
replicated, ``m`` / ``v`` as the parameters), batch and decode cache are
DTensors at the rules' placements (`build_step`), the step runs under
`shardings.activate_rules`, and the counter counts the rank's local
operations and the collectives' bytes.  Every rank runs the same program
on its shards, so rank 0's counts are the per-device counts.

One JSON record a pair goes to ``artifacts/dryrun_torch/`` (never the
reference's ``artifacts/dryrun/``), with the reference's keys wherever they
mean the same thing.  The roofline terms are one H100 SXM's (80 GB HBM3):
989 TFLOP/s dense bf16, 3.35 TB/s HBM; ``collective_s`` divides each
collective's bytes by the link its process group crosses (`link_bw`):
NVLink 4 within an 8-GPU node, the node's NIC for a group that spans
nodes (every 16-wide axis of the production meshes does).  The compiled
program's ``temp_bytes`` and ``peak_bytes`` have no meta-device
counterpart and are left out: the card measures the peak (``chip_smoke.py``'s
optimizer and sharded-step phases).  Under ``cfg.remat`` "full" or "dots"
the traced backward runs the blocks' recompute (`models.remat`), so its
FLOPs include it, as the reference's HLO count does; a one-card train
record also carries the count of the same step at remat "none"
(``hlo_flops_remat_none``) and the ratio of the model FLOPs (6·N·D) to
each count.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from ..configs import SHAPES, ARCH_IDS, batch_logical_axes, for_shape, get_config, input_specs
from ..configs.base import ModelConfig, OptimConfig, ShapeConfig
from ..models import api
from ..models.module import abstract_params, param_count
from ..optim import make_optimizer
from ..tree import tree_leaves
from . import shardings as SH
from .op_analysis import OpCounter, analyze, nbytes

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "NIC_BW", "NODE_GPUS", "optimizer_for",
           "model_flops_estimate", "tree_bytes", "link_bw", "build_step", "run_pair", "main"]

# H100 SXM (80 GB HBM3), per card
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # bytes/s
MESH = "1xH100"
# links, bytes/s one way a GPU: NVLink 4 (900 GB/s both ways, the H100 SXM
# datasheet) within a node of 8 (DGX H100); one 400 Gb/s ConnectX-7 NIC a
# GPU between nodes (the DGX H100 user guide)
NVLINK_BW = 450e9
NIC_BW = 50e9
NODE_GPUS = 8


def optimizer_for(cfg: ModelConfig) -> OptimConfig:
    # >100B-param models: bf16-momentum SGD keeps optimizer state in budget
    if cfg.name == "arctic_480b":
        return OptimConfig(name="momentum", state_dtype="bfloat16")
    return OptimConfig(name="adamw", state_dtype="float32")


def model_flops_estimate(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); D = processed tokens."""
    n_params = param_count(api.model_meta(cfg))
    if cfg.family == "moe":
        # subtract inactive expert params
        e_all = 3 * cfg.d_model * cfg.d_ff_expert * cfg.num_experts
        e_act = 3 * cfg.d_model * cfg.d_ff_expert * cfg.num_experts_per_tok
        n_params = n_params - cfg.num_layers * (e_all - e_act)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_params * tokens


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors on this rank (meta tensors included; a
    DTensor's local shard)."""
    return sum(nbytes(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def link_bw(mesh) -> dict:
    """``{process group name: bytes/s}`` for each mesh dimension's group:
    NVLink when the group's ranks share a node of `NODE_GPUS` (ranks laid
    out in the mesh's row-major order, node = rank // NODE_GPUS), else the
    NIC."""
    out = {}
    stride = 1
    for i in reversed(range(mesh.ndim)):
        size = mesh.size(i)
        out[mesh.get_group(i).group_name] = NVLINK_BW if (size - 1) * stride < NODE_GPUS \
            else NIC_BW
        stride *= size
    return out


def _meta_cache(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """`api.init_cache`'s spec as meta tensors (no storage)."""
    return {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
            for k, s in api.init_cache(cfg, batch, seq_len).items()}


def _opt_state_shardings(opt_cfg: OptimConfig, state: dict, mesh, frules: dict, pmeta) -> dict:
    """The optimizer state as DTensors: ``count`` replicated, ``m`` / ``v``
    at the parameters' placements (the reference's `_opt_state_shardings`)."""
    out = {"count": SH.distribute_like(state["count"], mesh, ())}
    for k in ("m", "v"):
        if k in state:
            out[k] = SH.distribute_params(state[k], mesh, frules, pmeta)
    return out


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None, rules: dict | None = None):
    """``(fn, args)``: the pair's step and its meta-device arguments.  With
    a ``mesh`` the arguments are DTensors at ``rules``' placements (default
    `shardings.DEFAULT_RULES`) and the step runs under them."""
    cfg = cfg.replace(use_pallas=False)  # on meta every kernel takes its plain route
    pmeta = api.model_meta(cfg)
    aparams = abstract_params(pmeta)
    batch = input_specs(cfg, shape)
    ctx = contextlib.nullcontext
    if mesh is not None:
        frules = SH.filter_rules(SH.DEFAULT_RULES if rules is None else rules, mesh)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        n_batch = 1
        for a in SH.BATCH_AXES:
            n_batch *= sizes.get(a, 1)
        if shape.global_batch % n_batch:  # the reference's b_ok
            frules["batch"] = None
        baxes = batch_logical_axes(cfg, shape)
        batch = {k: SH.distribute_like(
            v, mesh, SH.logical_to_pspec(baxes[k], {**frules, "seq": None}, v.shape, mesh))
            for k, v in batch.items()}
        params = SH.distribute_params(aparams, mesh, frules, pmeta)

        def ctx():
            return SH.activate_rules(frules, mesh)
    else:
        params = aparams
    if shape.kind == "train":
        opt_cfg = optimizer_for(cfg)
        opt = make_optimizer(opt_cfg)
        state = opt.init(aparams)
        if mesh is not None:
            state = _opt_state_shardings(opt_cfg, state, mesh, frules, pmeta)

        def train_step(params, opt_state, batch, sampling_weight):
            with ctx():
                return api.train_step(params, opt_state, batch, cfg, opt, sampling_weight)

        weight = torch.empty((), dtype=torch.float32, device="meta")
        return train_step, (params, state, batch, weight)
    if shape.kind == "prefill":

        def prefill_step(params, batch):
            with ctx():
                return api.forward(params, batch, cfg)[0]

        return prefill_step, (params, batch)

    cache = _meta_cache(cfg, shape.global_batch, shape.seq_len)
    if mesh is not None:
        caxes = api.cache_logical_axes(cfg)
        cache = {k: SH.distribute_like(v, mesh,
                                       SH.logical_to_pspec(caxes[k], frules, v.shape, mesh))
                 for k, v in cache.items()}

    def serve_step(params, cache, batch):
        with ctx():
            return api.serve_step(params, cache, batch, cfg)

    return serve_step, (params, cache, batch)


def _record(cfg: ModelConfig, shape: ShapeConfig, rec: dict, t0: float,
            multi_pod: bool | None = None, rules_name: str = "default") -> None:
    """Trace the step on meta tensors and add its per-device terms to
    ``rec``: on one card (``multi_pod`` None), else as rank 0 of the
    production mesh's fake world under ``RULE_SETS[rules_name]``."""
    from .mesh import fake_world, make_production_mesh

    n = 1 if multi_pod is None else 512 if multi_pod else 256
    with contextlib.nullcontext() if n == 1 else fake_world(n):
        mesh = None if n == 1 else make_production_mesh(multi_pod=multi_pod)
        fn, args = build_step(cfg, shape, mesh,
                              None if mesh is None else dict(SH.RULE_SETS[rules_name]))
        counter = OpCounter()
        with counter:
            out = fn(*args)
        bw = {} if mesh is None else link_bw(mesh)
        hlo = counter.result()
        arg_bytes, out_bytes = tree_bytes(args), tree_bytes(out)
    t_trace = time.time()
    flops, bytes_acc, coll = hlo["flops"], hlo["bytes"], hlo["collectives"]
    # one card sends nothing; a group no mesh dimension names (none on the
    # production meshes) takes the NIC
    coll_s = sum((b / bw.get(g, NIC_BW) for g, b in hlo["collectives_by_group"].items()), 0.0)
    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": bytes_acc / HBM_BW,
             "collective_s": coll_s}
    mf = model_flops_estimate(cfg, shape)
    rec.update(
        ok=True,
        trace_s=round(t_trace - t0, 2),
        flops_per_device=flops,
        bytes_per_device=bytes_acc,
        collective_bytes_per_device=coll["total"] if n > 1 else 0.0,
        **({"collectives": coll} if n > 1 else {}),
        memory={"argument_bytes": arg_bytes, "output_bytes": out_bytes},
        roofline=terms,
        dominant=max(terms, key=terms.get).replace("_s", ""),
        model_flops_total=mf,
        remat=cfg.remat,
        hlo_flops_total=flops * n,
        useful_flops_ratio=(mf / (flops * n)) if flops > 0 else None,
    )
    if n == 1:
        flops_none = flops
        if cfg.remat != "none" and shape.kind == "train":
            # the same step without the recompute: the count a model-FLOPs
            # utilisation divides by when it names remat "none"
            fn_none, args_none = build_step(cfg.replace(remat="none"), shape)
            flops_none = analyze(fn_none, *args_none)[1]["flops"]
        rec.update(hlo_flops_remat_none=flops_none,
                   useful_flops_ratio_remat_none=(mf / flops_none) if flops_none > 0 else None)
    rec.update(devices=sorted(counter.devices), off_meta_bytes=counter.off_meta_bytes,
               by_op=hlo["by_op"])


def run_pair(arch: str, shape: str | ShapeConfig, out_dir: str = "artifacts/dryrun_torch",
             overrides: dict | None = None, tag_suffix: str = "",
             cfg: ModelConfig | None = None, multi_pod: bool | None = None,
             rules_name: str = "default") -> dict:
    """Trace one (arch × shape) step on meta and write its record.  ``cfg``
    (default: the arch's config for the shape, then ``overrides``) picks
    another config of the arch, e.g. a smoke or depth-cut one.
    ``multi_pod`` None traces one card; False / True the 16x16 / 2x16x16
    production mesh under ``RULE_SETS[rules_name]``."""
    t0 = time.time()
    if isinstance(shape, str):
        shape_name, shape = shape, SHAPES[shape]
    else:
        shape_name = shape.name
    if cfg is None:
        cfg = for_shape(get_config(arch), shape)
    if overrides:
        cfg = cfg.replace(**overrides)
    on_mesh = multi_pod is not None
    rec: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": ("2x16x16" if multi_pod else "16x16") if on_mesh else MESH,
        "chips": (512 if multi_pod else 256) if on_mesh else 1,
        **({"rules": rules_name} if on_mesh else {}),
        "kind": shape.kind,
        "sliding_window": cfg.sliding_window,
        "params": param_count(api.model_meta(cfg)),
    }
    try:
        _record(cfg, shape, rec, t0, multi_pod, rules_name)
    except Exception as e:  # noqa: BLE001 - the record says what failed, and main exits non-zero
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 2)
    os.makedirs(out_dir, exist_ok=True)
    if on_mesh:
        tag = f"{arch}__{shape_name}__{'multipod' if multi_pod else 'singlepod'}__{rules_name}"
    else:
        tag = f"{arch}__{shape_name}__{MESH}"
    if tag_suffix:
        tag += "__" + tag_suffix
        rec["variant"] = tag_suffix
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK " if rec.get("ok") else "FAIL"
    if not rec.get("ok"):
        detail = rec.get("error", "")[:200]
    elif on_mesh:
        detail = (f"dom={rec['dominant']} flops/device={rec['flops_per_device']:.6g} "
                  f"collective bytes/device={rec['collective_bytes_per_device']:.6g}")
    else:
        detail = (f"dom={rec.get('dominant')} flops={rec['hlo_flops_total']:.6g} "
                  f"(remat {rec['remat']}) flops_remat_none={rec['hlo_flops_remat_none']:.6g}")
    print(f"[{status}] {tag} wall={rec['wall_s']}s {detail}", flush=True)
    return rec


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 (pod, data, model) mesh")
    ap.add_argument("--both-meshes", action="store_true", help="16x16, then 2x16x16")
    ap.add_argument("--rules", default=None, choices=sorted(SH.RULE_SETS),
                    help="partition rules (default: 'default'); on the 16x16 mesh unless a "
                         "mesh flag says otherwise")
    ap.add_argument("--out-dir", default="artifacts/dryrun_torch")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (hillclimb variants)")
    ap.add_argument("--tag", default="")
    return ap


def main(argv: list[str] | None = None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        key, val = kv.split("=", 1)
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except ValueError:
                continue
        overrides[key] = val
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    if args.both_meshes:
        meshes = [False, True]
    elif args.multi_pod or args.rules is not None:
        meshes = [args.multi_pod]
    else:
        meshes = [None]
    n_fail = 0
    for arch in archs:
        for shp in shapes:
            for mp in meshes:
                rec = run_pair(arch, shp, args.out_dir, overrides=overrides or None,
                               tag_suffix=args.tag, multi_pod=mp,
                               rules_name=args.rules or "default")
                n_fail += 0 if rec.get("ok") else 1
    if n_fail:
        raise SystemExit(f"{n_fail} dry-run pair(s) failed")


if __name__ == "__main__":
    main()
