"""The port's dry-run tooling against the reference's.

  * ``models/api``'s ``input_specs``, ``cache_specs`` and ``cache_kinds``
    (tensors on ``meta``) against the reference's ``ShapeDtypeStruct``s:
    keys, shapes and dtypes, all ten archs x four shape cells x both
    ``quant`` values;
  * ``launch/analytic`` exactly against the reference's for every cell.
    The port's attention constants differ: on the card attention is one
    flash kernel at every length with 128-row query tiles, where the
    reference scans 512-row blocks from 2048 on.  So the reference is
    held with its constants set to the port's (exact), and with its own
    (FLOPs exact; the attention term's bytes differ by the block);
  * ``launch/dryrun._model_flops``, exact, and the per-device argument
    bytes against the reference's ``param_specs`` on ``jax.eval_shape``
    with the same axis sizes, exact;
  * three kv8 decode steps on a dense smoke config against the
    reference's quantised-cache branch: logits within 2e-5 of their
    largest magnitude, the int8 caches exact, the scales within 1e-6
    relative;
  * the reference's two dry-run cases (whisper-tiny ``decode_32k`` ok,
    qwen1.5-32b ``long_500k`` skipped) and granite-moe-3b-a800m
    ``train_4k``, which takes the MoE router's radix selection on
    ``meta``, each in a subprocess.
"""

import importlib
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.dist import sharding as ref_shd
from repro.launch import analytic as ref_analytic
from repro.models import api as ref_api
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import analytic, dryrun
from repro_torch.models import api, convert

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _ref_dryrun():
    """The reference's dry-run module, imported without letting its
    import-time ``XLA_FLAGS`` (512 forced devices) reach this process."""
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


def _sig(tree):
    """name -> (shape, dtype name) of a spec dict of either package."""
    return {k: (tuple(v.shape), str(np.dtype(v.dtype)) if not isinstance(
        v, torch.Tensor) else str(v.dtype).removeprefix("torch."))
        for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for name, cell in SHAPES.items():
        rcell = REF_SHAPES[name]
        got = api.input_specs(cfg, cell)
        assert all(t.is_meta for t in got.values())
        assert _sig(got) == _sig(ref_api.input_specs(rcfg, rcell)), name
        for quant in (False, True):
            got = api.cache_specs(cfg, cell.global_batch, cell.seq_len,
                                  quant=quant)
            want = ref_api.cache_specs(rcfg, rcell.global_batch,
                                       rcell.seq_len, quant=quant)
            assert all(t.is_meta for t in got.values())
            assert _sig(got) == _sig(want), (name, quant)
            assert api.cache_kinds(cfg, quant=quant) == \
                ref_api.cache_kinds(rcfg, quant=quant)


def test_analytic_matches_reference(monkeypatch):
    from repro_torch.models import blocks
    assert (blocks.FLASH_BLOCK, blocks.FLASH_MIN_SEQ) == (128, 1)
    assert (ref_analytic.FLASH_BLOCK, ref_analytic.FLASH_MIN_SEQ) == \
        (512, 2048)
    cells = [(arch, name) for arch in ARCHS for name in SHAPES]
    # with the reference's own constants: the FLOPs of every term agree
    for arch, name in cells:
        cfg, rcfg = get_config(arch), ref_config(arch)
        got = analytic.inner_scan_correction(cfg, SHAPES[name])
        want = ref_analytic.inner_scan_correction(rcfg, REF_SHAPES[name])
        assert got["flops"] == want["flops"], (arch, name)
    # with the port's constants in the reference: every term, exactly
    monkeypatch.setattr(ref_analytic, "FLASH_BLOCK", blocks.FLASH_BLOCK)
    monkeypatch.setattr(ref_analytic, "FLASH_MIN_SEQ", blocks.FLASH_MIN_SEQ)
    for arch, name in cells:
        cfg, rcfg = get_config(arch), ref_config(arch)
        for fn in ("attention_correction", "rwkv_correction",
                   "ssm_correction", "inner_scan_correction"):
            assert getattr(analytic, fn)(cfg, SHAPES[name]) == \
                getattr(ref_analytic, fn)(rcfg, REF_SHAPES[name]), \
                (arch, name, fn)


def test_model_flops_match_reference():
    ref_dry = _ref_dryrun()
    for arch in ARCHS:
        for name in SHAPES:
            assert dryrun._model_flops(get_config(arch), SHAPES[name]) == \
                ref_dry._model_flops(ref_config(arch), REF_SHAPES[name])


_NO_FSDP = {"model": 16, "data": 1 << 62, "pod": 1 << 62}


def _ref_arg_bytes(rcfg, cell, shape: dict, variant: str) -> int:
    """The reference dry-run's arguments, per device, from its own specs
    (``build_cell``: params, AdamW state, batch; token, cache, length)."""
    mesh = jax.sharding.AbstractMesh(
        tuple(shape.values()), tuple(shape),
        axis_types=(jax.sharding.AxisType.Auto,) * len(shape))
    dp = ref_shd.dp_axes(mesh)
    dp_size = math.prod(shape[a] for a in dp)

    def nbytes(leaf, spec, dtype=None):
        n = 1
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * 8):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= dim // math.prod(shape[a] for a in axes)
        return n * np.dtype(dtype or leaf.dtype).itemsize

    def tree_bytes(tree, specs, dtype=None):
        return sum(nbytes(leaf, spec, dtype) for leaf, spec in zip(
            jax.tree.leaves(tree),
            jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))))

    def batch_bytes(leaves):
        return sum(nbytes(t, P(dp if t.shape[0] % dp_size == 0 else None))
                   for t in leaves)

    params_s = jax.eval_shape(lambda: ref_api.init(rcfg, jax.random.key(0)))
    if cell.kind == "train":
        pspec = ref_shd.param_specs(params_s)
        return (tree_bytes(params_s, pspec)
                + 3 * tree_bytes(params_s, pspec, np.float32) + 4
                + batch_bytes(ref_api.input_specs(rcfg, cell).values()))
    pspec = ref_shd.param_specs(
        params_s, axis_sizes=_NO_FSDP if "serve_tp" in variant else None)
    b = cell.global_batch
    quant = "kv8" in variant
    cache = ref_api.cache_specs(rcfg, b, cell.seq_len, quant=quant)
    kinds = ref_api.cache_kinds(rcfg, quant=quant)
    return (tree_bytes(params_s, pspec)
            + batch_bytes([jax.ShapeDtypeStruct((b, 1), jnp.int32)])
            + sum(nbytes(leaf, ref_shd.cache_spec(mesh, b, kind=kinds[k]))
                  for k, leaf in cache.items()) + 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for multi in (False, True):
        mesh = dryrun.production_mesh(multi)
        for name, variant in (("train_4k", "base"), ("decode_32k", "base"),
                              ("decode_32k", "serve_tp_kv8")):
            got = dryrun.cell_memory(cfg, SHAPES[name], mesh, variant)
            want = _ref_arg_bytes(rcfg, REF_SHAPES[name], mesh.shape, variant)
            assert got["args_bytes"] == want, (multi, name, variant)


def test_kv8_decode_matches_reference():
    arch = "deepseek-coder-33b"               # dense, full attention
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    params = ref_api.init(rcfg, jax.random.key(0))
    model = convert.from_reference(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    b, t = 2, 8
    rcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          ref_api.cache_specs(rcfg, b, t, quant=True))
    cache = {k: torch.zeros_like(v, device="cpu")
             for k, v in api.cache_specs(cfg, b, t, quant=True).items()}
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (3, b, 1))
    for step in range(3):
        rl, rcache = ref_api.decode_step(
            rcfg, params, jnp.asarray(toks[step], jnp.int32), rcache,
            jnp.int32(step))
        pl, cache = api.decode_step(
            cfg, model, torch.as_tensor(toks[step], dtype=torch.int32),
            cache, step)
        rl = np.asarray(rl, np.float32)
        assert np.abs(pl.numpy() - rl).max() <= 2e-5 * np.abs(rl).max(), step
        for name in ("k", "v"):
            assert np.array_equal(cache[name].numpy(),
                                  np.asarray(rcache[name])), (step, name)
        for name in ("k_scale", "v_scale"):
            want = np.asarray(rcache[name])
            assert np.abs(cache[name].numpy() - want).max() <= \
                1e-6 * np.abs(want).max(), (step, name)
    assert int(cache["k"].abs().max()) == 127          # absmax-quantised


def _dryrun(tmp_path, arch, shape, timeout):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=timeout, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads((tmp_path / f"{arch}_{shape}_single.json").read_text())


def test_dryrun_cell_whisper_decode(tmp_path):
    rec = _dryrun(tmp_path, "whisper-tiny", "decode_32k", 300)
    assert rec["status"] == "ok"
    rl = rec["roofline"]
    assert rl["flops"] > 0 and rl["hbm_bytes"] > 0
    assert rl["bottleneck"] in ("compute", "memory")
    assert rec["mem"]["args_gb"] > 0
    assert rec["mem"]["temp_gb"] is None and rec["collectives"] is None
    assert set(rec["null_reasons"]) == {"temp_gb", "collectives"}
    assert "FlopCounterMode" in rec["flops_counted_by"]


def test_dryrun_skip_cell_records_reason(tmp_path):
    rec = _dryrun(tmp_path, "qwen1.5-32b", "long_500k", 120)
    assert rec["status"] == "skip"
    assert "full-attention" in rec["reason"]


def test_dryrun_moe_train_cell_on_meta(tmp_path):
    rec = _dryrun(tmp_path, "granite-moe-3b-a800m", "train_4k", 300)
    assert rec["status"] == "ok", rec.get("error")
    rl = rec["roofline"]
    assert rl["flops"] > 0 and rl["hbm_bytes"] > 0
    assert rl["bottleneck"] in ("compute", "memory")
    assert rl["model_flops"] == dryrun._model_flops(
        get_config("granite-moe-3b-a800m"), SHAPES["train_4k"])
    assert rec["microbatches"] >= 1 and rec["mem"]["args_gb"] > 0
