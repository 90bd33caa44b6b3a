"""Dry run: trace every (arch × shape) step on the meta device and write its
cost terms, with no card and no memory allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun            # every arch × shape

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

One JSON record a pair goes to ``artifacts/dryrun_torch/`` (never the
reference's ``artifacts/dryrun/``), with the reference's keys wherever they
mean the same thing.  The roofline terms are one H100 SXM's (80 GB HBM3):
989 TFLOP/s dense bf16, 3.35 TB/s HBM, no collectives on one card
(``collective_s`` 0).  The compiled program's ``temp_bytes`` and
``peak_bytes`` have no meta-device counterpart and are left out: the card
measures the peak (``chip_smoke.py``'s optimizer phase).  Under
``cfg.remat`` "full" or "dots" the traced backward runs the blocks'
recompute (`models.remat`), so its FLOPs include it, as the reference's
HLO count does; a train record also carries the count of the same step at
remat "none" (``hlo_flops_remat_none``) and the ratio of the model FLOPs
(6·N·D) to each count.  The reference's
``--multi-pod``, ``--both-meshes`` and ``--rules`` pick an XLA device mesh
and its partition rules, which the port does not have: they exit with an
error.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs import SHAPES, ARCH_IDS, for_shape, get_config, input_specs
from ..configs.base import ModelConfig, OptimConfig, ShapeConfig
from ..models import api
from ..models.module import abstract_params, param_count
from ..optim import make_optimizer
from ..tree import tree_leaves
from .op_analysis import OpCounter, analyze, nbytes

__all__ = ["PEAK_FLOPS", "HBM_BW", "optimizer_for", "model_flops_estimate", "tree_bytes",
           "build_step", "run_pair", "main"]

# H100 SXM (80 GB HBM3), per card
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # bytes/s
MESH = "1xH100"


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
    """The bytes of a tree's tensors (meta tensors included)."""
    return sum(nbytes(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _meta_cache(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """`api.init_cache`'s spec as meta tensors (no storage)."""
    return {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
            for k, s in api.init_cache(cfg, batch, seq_len).items()}


def build_step(cfg: ModelConfig, shape: ShapeConfig):
    """``(fn, args)``: the pair's step and its meta-device arguments."""
    cfg = cfg.replace(use_pallas=False)  # on meta every kernel takes its plain route
    aparams = abstract_params(api.model_meta(cfg))
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        opt = make_optimizer(optimizer_for(cfg))

        def train_step(params, opt_state, batch, sampling_weight):
            return api.train_step(params, opt_state, batch, cfg, opt, sampling_weight)

        weight = torch.empty((), dtype=torch.float32, device="meta")
        return train_step, (aparams, opt.init(aparams), batch, weight)
    if shape.kind == "prefill":

        def prefill_step(params, batch):
            return api.forward(params, batch, cfg)[0]

        return prefill_step, (aparams, batch)

    def serve_step(params, cache, batch):
        return api.serve_step(params, cache, batch, cfg)

    return serve_step, (aparams, _meta_cache(cfg, shape.global_batch, shape.seq_len), batch)


def run_pair(arch: str, shape: str | ShapeConfig, out_dir: str = "artifacts/dryrun_torch",
             overrides: dict | None = None, tag_suffix: str = "",
             cfg: ModelConfig | None = None) -> dict:
    """Trace one (arch × shape) step on meta and write its record.  ``cfg``
    (default: the arch's config for the shape, then ``overrides``) picks
    another config of the arch, e.g. a smoke or depth-cut one."""
    t0 = time.time()
    if isinstance(shape, str):
        shape_name, shape = shape, SHAPES[shape]
    else:
        shape_name = shape.name
    if cfg is None:
        cfg = for_shape(get_config(arch), shape)
    if overrides:
        cfg = cfg.replace(**overrides)
    rec: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": MESH,
        "chips": 1,
        "kind": shape.kind,
        "sliding_window": cfg.sliding_window,
        "params": param_count(api.model_meta(cfg)),
    }
    try:
        fn, args = build_step(cfg, shape)
        counter = OpCounter()
        with counter:
            out = fn(*args)
        t_trace = time.time()
        hlo = counter.result()
        flops, bytes_acc = hlo["flops"], hlo["bytes"]
        mf = model_flops_estimate(cfg, shape)
        flops_none = flops
        if cfg.remat != "none" and shape.kind == "train":
            # the same step without the recompute: the count a model-FLOPs
            # utilisation divides by when it names remat "none"
            fn_none, args_none = build_step(cfg.replace(remat="none"), shape)
            flops_none = analyze(fn_none, *args_none)[1]["flops"]
        terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": bytes_acc / HBM_BW,
                 "collective_s": 0.0}
        dominant = max(terms, key=terms.get)
        rec.update(
            ok=True,
            trace_s=round(t_trace - t0, 2),
            flops_per_device=flops,
            bytes_per_device=bytes_acc,
            collective_bytes_per_device=0.0,
            memory={"argument_bytes": tree_bytes(args), "output_bytes": tree_bytes(out)},
            roofline=terms,
            dominant=dominant.replace("_s", ""),
            model_flops_total=mf,
            remat=cfg.remat,
            hlo_flops_total=flops,
            useful_flops_ratio=(mf / flops) if flops > 0 else None,
            hlo_flops_remat_none=flops_none,
            useful_flops_ratio_remat_none=(mf / flops_none) if flops_none > 0 else None,
            devices=sorted(counter.devices),
            off_meta_bytes=counter.off_meta_bytes,
            by_op=hlo["by_op"],
        )
    except Exception as e:  # noqa: BLE001 - the record says what failed, and main exits non-zero
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 2)
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape_name}__{MESH}"
    if tag_suffix:
        tag += "__" + tag_suffix
        rec["variant"] = tag_suffix
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK " if rec.get("ok") else "FAIL"
    print(f"[{status}] {tag} wall={rec['wall_s']}s "
          + (f"dom={rec.get('dominant')} flops={rec['hlo_flops_total']:.6g} "
             f"(remat {rec['remat']}) flops_remat_none={rec['hlo_flops_remat_none']:.6g}"
             if rec.get("ok") else rec.get("error", "")[:200]),
          flush=True)
    return rec


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out-dir", default="artifacts/dryrun_torch")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (hillclimb variants)")
    ap.add_argument("--tag", default="")
    for flag in ("--multi-pod", "--both-meshes"):
        ap.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rules", default=None, help=argparse.SUPPRESS)
    return ap


def main(argv: list[str] | None = None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)
    for flag, given in (("--multi-pod", args.multi_pod), ("--both-meshes", args.both_meshes),
                        ("--rules", args.rules is not None)):
        if given:
            ap.error(f"{flag} picks an XLA device mesh or its partition rules; there is no XLA "
                     "mesh in the port (one card, mesh 1xH100)")
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
    n_fail = 0
    for arch in archs:
        for shp in shapes:
            rec = run_pair(arch, shp, args.out_dir, overrides=overrides or None,
                           tag_suffix=args.tag)
            n_fail += 0 if rec.get("ok") else 1
    if n_fail:
        raise SystemExit(f"{n_fail} dry-run pair(s) failed")


if __name__ == "__main__":
    main()
