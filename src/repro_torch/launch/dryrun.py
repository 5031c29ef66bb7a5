"""Multi-pod dry-run on the ``meta`` device: every (arch x shape x mesh)
cell's step traced for shapes, FLOPs, bytes and per-device memory.

The port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell's step on 512 placeholder CPU devices and reads XLA's memory and
cost analyses.  The port has no compiler, so each cell's step runs on
``meta`` tensors (shapes only: no storage, no card, no process group):

  * **per-device argument bytes** from ``dist/sharding.param_specs`` with
    the production mesh's axis sizes (data 16 x model 16, plus pod 2 for
    ``multi``): the params (and for a train cell the AdamW master, m, v
    and step), the batch (its leading axis on the DP axes when they divide
    it), and for a decode cell the token, the cache by
    ``cache_spec(cache_kinds)`` and the cache length; outputs likewise;
  * **FLOPs** from ``torch.utils.flop_counter.FlopCounterMode`` over the
    step (the train step — forward, backward with the model's per-layer
    remat, AdamW — or prefill, or one decode step), on the reference's
    unrolled L=1 and L=2 probes extrapolated to L layers (total = nonloop
    + L x delta).  The counter sees matmuls, convolutions and attention
    only, where XLA counts every op; the record says so
    (``flops_counted_by``).  Of ``analytic.inner_scan_correction`` the
    WKV and SSM terms are added: the eager port runs every step of those
    scans, and the counter sees only their einsum readouts.  The
    attention term is not, because the counter already sees the whole
    attention of every layer.
  * **HBM bytes** from a ``TorchDispatchMode`` over the same probes that
    adds up, for every aten op, the bytes of its inputs and outputs (in
    an eager port each op is one kernel); views move nothing
    (``hbm_bytes_model``).
  * **Temporary memory and collective bytes have no counterpart**: no
    compiler reports temporaries, and no runtime shards these steps by
    the specs yet.  Both are recorded as ``None`` with the reason, and the
    bottleneck is chosen between compute and memory.

All work terms are the whole step's, divided by the mesh's device count
(work fully distributed across DP x TP).  Variants, as the reference's:
``serve_tp`` (decode: no FSDP on params), ``kv8`` (decode, transformer
family: the int8 cache), ``mbN`` (train: N microbatches).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
        --shape train_4k --mesh single [--variant serve_tp]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, cells, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.dist import sharding as shd
from repro_torch.dist._comm import AbstractMesh
from repro_torch.models import api
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import adamw_init

from .analytic import inner_scan_correction, rwkv_correction, ssm_correction
from .roofline import HBM_BW, PEAK_FLOPS, roofline_terms

FLOPS_COUNTED_BY = (
    "torch.utils.flop_counter.FlopCounterMode on the meta device: matmuls, "
    "convolutions and attention only (XLA's cost analysis counts every "
    "op); plus analytic WKV and SSM scan terms")
HBM_BYTES_MODEL = (
    "every aten op reads each input and writes each output once (an eager "
    "op is one kernel); views move nothing; broadcast dims count once")
NULL_REASONS = {
    "temp_gb": "no compiler reports temporary memory for an eager step",
    "collectives": "no runtime shards these steps by dist/sharding's specs "
                   "yet, so there are no collective ops to count",
}
_NO_FSDP_SIZES = {"model": 16, "data": 1 << 62, "pod": 1 << 62}


def production_mesh(multi_pod: bool) -> AbstractMesh:
    """The 16x16 pod or 2x16x16 pods: axis names and sizes only."""
    return AbstractMesh({"pod": 2, "data": 16, "model": 16} if multi_pod
                        else {"data": 16, "model": 16})


def _model_flops(cfg, cell) -> float:
    n_active = cfg.active_param_count() - cfg.vocab * cfg.d_model  # non-embed
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * n_active * tokens


# ------------------------------------------------------------- memory

def _dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in shd.dp_axes(mesh))


def shard_bytes(shape, dtype, spec, mesh) -> int:
    """Bytes of one device's shard of a leaf placed by ``spec``."""
    n = 1
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= dim // math.prod(mesh.shape[a] for a in axes)
    return n * dtype.itemsize


def _batch_bytes(leaves, mesh) -> int:
    """Leading axis on the DP axes when they divide it, the rest whole."""
    dp = shd.dp_axes(mesh)
    total = 0
    for t in leaves:
        lead = dp if t.shape[0] % _dp_size(mesh) == 0 else None
        total += shard_bytes(t.shape, t.dtype, (lead,), mesh)
    return total


def _param_bytes(model, mesh, axis_sizes=None, dtype=None) -> int:
    specs = shd.param_specs(model, axis_sizes=axis_sizes or dict(mesh.shape))
    return sum(shard_bytes(shape, dtype or dt, specs[path], mesh)
               for path, (shape, dt) in shd.stacked_shapes(model).items())


def _cache_bytes(cfg, cache, mesh, b, quant) -> int:
    kinds = api.cache_kinds(cfg, quant=quant)
    return sum(shard_bytes(t.shape, t.dtype,
                           shd.cache_spec(mesh, b, kind=kinds[name]), mesh)
               for name, t in cache.items())


def _logits_bytes(logits, mesh) -> int:
    spec = shd.act_specs(mesh)["logits"]
    b, v = logits.shape[0], logits.shape[-1]
    spec = (spec[0] if b % _dp_size(mesh) == 0 else None, None,
            spec[2] if v % mesh.shape.get("model", 1) == 0 else None)
    return shard_bytes(logits.shape, logits.dtype, spec, mesh)


def cell_memory(cfg, cell, mesh, variant="base") -> dict:
    """Per-device argument and output bytes of the cell's step."""
    model = api.model_class(cfg)(cfg, device="meta")
    b = cell.global_batch
    kv_quant = "kv8" in variant
    if cell.kind == "train":
        state = (_param_bytes(model, mesh)
                 + 3 * _param_bytes(model, mesh, dtype=torch.float32) + 4)
        args = state + _batch_bytes(
            api.input_specs(cfg, cell).values(), mesh)
        out = state + 4 * 4                   # loss, lr, grad_norm, ce
    else:
        params = _param_bytes(model, mesh, axis_sizes=(
            _NO_FSDP_SIZES if "serve_tp" in variant else None))
        cache = api.cache_specs(cfg, b, cell.seq_len, quant=kv_quant)
        logits = torch.empty((b, 1, cfg.padded_vocab), device="meta",
                             dtype=model.embed.dtype)
        out = (_logits_bytes(logits, mesh)
               + _cache_bytes(cfg, cache, mesh, b, kv_quant))
        if cell.kind == "prefill":
            args = params + _batch_bytes(
                api.input_specs(cfg, cell).values(), mesh)
        else:
            tok = torch.empty((b, 1), dtype=torch.int32, device="meta")
            args = (params + _batch_bytes([tok], mesh)
                    + _cache_bytes(cfg, cache, mesh, b, kv_quant) + 4)
    return {"args_bytes": args, "out_bytes": out}


def _microbatches(cfg, cell, mesh, variant) -> int:
    """The reference's activation-checkpoint bound (<= ~4 GiB a device)."""
    per = cell.global_batch // _dp_size(mesh)
    act_bytes = per * cell.seq_len * cfg.d_model * cfg.n_layers * 2
    micro = max(1, min(per, -(-act_bytes // (4 * 2**30))))
    while per % micro:
        micro += 1
    if variant.startswith("mb"):
        micro = int(variant[2:])
    return micro


# ------------------------------------------------------------- work

def _unique_bytes(t: torch.Tensor) -> int:
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class HbmBytes(TorchDispatchMode):
    """Adds up the bytes every aten op reads and writes (:data:`HBM_BYTES_MODEL`)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if not _is_view(func) and not name.startswith("empty"):
            self.bytes += sum(_unique_bytes(t) for t in
                              tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def _run_step(cfg, cell, variant):
    """One step of ``cfg`` (already cut to its probe depth) on ``meta``."""
    model = api.model_class(cfg)(cfg, device="meta")
    b = cell.global_batch
    if cell.kind == "train":
        state = {"model": model.trainable(True),
                 "opt": adamw_init(model.named_parameters())}
        make_train_step(cfg)(state, api.input_specs(cfg, cell))
    elif cell.kind == "prefill":
        api.prefill(cfg, model, api.input_specs(cfg, cell))
    else:
        cache = {k: torch.zeros_like(v) for k, v in api.cache_specs(
            cfg, b, cell.seq_len, quant="kv8" in variant).items()}
        tok = torch.zeros((b, 1), dtype=torch.int32, device="meta")
        api.decode_step(cfg, model, tok, cache, cell.seq_len - 1)


def probe_cost(cfg, cell, n_layers, variant="base") -> dict:
    """FLOPs and HBM bytes of the step at ``n_layers`` layers."""
    pcfg = dataclasses.replace(
        cfg, n_layers=n_layers,
        n_enc_layers=(n_layers if cfg.n_enc_layers else 0))
    with FlopCounterMode(display=False) as fc, HbmBytes() as hb:
        _run_step(pcfg, cell, variant)
    return {"flops": float(fc.get_total_flops()), "hbm_bytes": float(hb.bytes)}


def _extrapolate(c1, c2, n_layers) -> dict:
    out = {}
    for key in ("flops", "hbm_bytes"):
        delta = max(0.0, c2[key] - c1[key])
        out[key] = max(c1[key] - delta, 0.0) + n_layers * delta
    return out


def cell_roofline(cfg, cell, n_devices, variant="base") -> tuple:
    """``(raw, corrected)`` roofline dicts, per device: the counters over
    the L=1/L=2 probes, then with the unseen WKV/SSM scan terms."""
    total = _extrapolate(probe_cost(cfg, cell, 1, variant),
                         probe_cost(cfg, cell, 2, variant), cfg.n_layers)
    mf = _model_flops(cfg, cell)
    raw = roofline_terms(total["flops"] / n_devices,
                         total["hbm_bytes"] / n_devices, n_devices,
                         model_flops=mf).as_dict()
    unseen = sum(fn(cfg, cell)["flops"]
                 for fn in (rwkv_correction, ssm_correction))
    corrected = roofline_terms((total["flops"] + unseen) / n_devices,
                               total["hbm_bytes"] / n_devices, n_devices,
                               model_flops=mf).as_dict()
    return raw, corrected


# ------------------------------------------------------------- the CLI

def _write(rec, out_dir, arch, shape, mesh_name, variant) -> None:
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if variant == "base" else f"_{variant}"
    path = os.path.join(out_dir, f"{arch}_{shape}_{mesh_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             variant: str = "base") -> dict:
    cfg = get_config(arch)
    cell = SHAPES[shape]
    mesh_name = "multi" if multi_pod else "single"
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "variant": variant,
           "status": "ok"}
    for sh, skip in cells(arch):
        if sh.name == shape and skip:
            rec.update(status="skip", reason=skip)
            print(json.dumps(rec))
            _write(rec, out_dir, arch, shape, mesh_name, variant)
            return rec

    mesh = production_mesh(multi_pod)
    n_dev = math.prod(mesh.shape.values())
    t0 = time.time()
    try:
        mem = cell_memory(cfg, cell, mesh, variant)
        raw, corrected = cell_roofline(cfg, cell, n_dev, variant)
        corr = inner_scan_correction(cfg, cell)
        rec.update(
            trace_s=round(time.time() - t0, 1),
            microbatches=(_microbatches(cfg, cell, mesh, variant)
                          if cell.kind == "train" else None),
            mem=dict(args_gb=round(mem["args_bytes"] / 2**30, 3),
                     temp_gb=None,
                     out_gb=round(mem["out_bytes"] / 2**30, 3)),
            collectives=None,
            null_reasons=NULL_REASONS,
            flops_counted_by=FLOPS_COUNTED_BY,
            hbm_bytes_model=HBM_BYTES_MODEL,
            inner_scan=corr,
            peaks={"flops": PEAK_FLOPS, "hbm_bw": HBM_BW},
            roofline_raw=raw,
            # the roofline table is single-pod only, as the reference's
            roofline=None if multi_pod else corrected,
        )
        c = corrected
        print(f"== {arch} x {shape} x {mesh_name} ==")
        print(f"memory: arg={rec['mem']['args_gb']}GiB "
              f"out={rec['mem']['out_gb']}GiB (temp: not known)")
        print(f"counted: flops/device={raw['flops']:.3e} "
              f"bytes/device={raw['hbm_bytes']:.3e}")
        if not multi_pod:
            print(f"roofline(H100): compute={c['t_compute']*1e3:.2f}ms "
                  f"memory={c['t_memory']*1e3:.2f}ms "
                  f"-> {c['bottleneck']}-bound; "
                  f"useful={c['useful_ratio']:.2f}")
    except Exception as e:
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        print(f"== {arch} x {shape} x {mesh_name} == FAIL {e}", file=sys.stderr)

    _write(rec, out_dir, arch, shape, mesh_name, variant)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    combos = ([(a, s) for a in ARCHS for s in SHAPES] if args.all
              else [(args.arch, args.shape)])
    n_fail = 0
    for arch, shape in combos:
        for mp in meshes:
            rec = run_cell(arch, shape, mp, args.out, args.variant)
            n_fail += rec["status"] == "fail"
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
