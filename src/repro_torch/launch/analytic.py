"""Analytic (napkin-math) terms for the work inside a layer's inner scans.

The port of ``repro/launch/analytic.py``: the same arithmetic on the
port's configs, windows and attention constants.  The reference adds
these terms to XLA's cost analysis, which counts a while-loop body once
whatever its trip count: flash attention's block scan, the RWKV-6 WKV
recurrence and the Mamba SSM scan.  The port's attention model is the
card's flash kernel (``models/blocks.FLASH_BLOCK``/``FLASH_MIN_SEQ``: a
query tile of 128 rows, at every length), so its attention bytes differ
from the reference's 512-row blocks from 2048 on; its FLOPs do not.

All quantities are GLOBAL (whole step, all devices); the dry-run divides
by mesh size to get the per-device roofline terms (work is fully
distributed across DP x TP for every corrected term).  Backward-pass
multipliers assume the model's remat policy: per-layer checkpointing =>
fwd + 1 recompute + ~2x-fwd backward = 4x fwd FLOPs, ~3x fwd bytes.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelCfg, ShapeCell
from repro_torch.models import hymba
from repro_torch.models.blocks import FLASH_BLOCK, FLASH_MIN_SEQ
from repro_torch.models.transformer import layer_windows as tf_windows


def _train_mults(kind: str):
    """(flops_mult, bytes_mult) vs a single forward pass."""
    if kind == "train":
        return 4.0, 3.0
    return 1.0, 1.0


def attention_correction(cfg: ModelCfg, cell: ShapeCell) -> dict:
    """Flash attention over the prompt (only when s >= FLASH_MIN_SEQ)."""
    s = cell.seq_len
    b = cell.global_batch
    if cell.kind == "decode" or s < FLASH_MIN_SEQ or s % FLASH_BLOCK:
        return {"flops": 0.0, "bytes": 0.0}
    if cfg.n_heads == 0 or cfg.family == "ssm":
        return {"flops": 0.0, "bytes": 0.0}
    if cfg.family == "hybrid":
        windows = hymba.layer_windows(cfg)
    elif cfg.family == "encdec":
        windows = [0] * cfg.n_layers      # decoder self-attn, full causal
    else:
        windows = tf_windows(cfg)
    fm, bm = _train_mults(cell.kind)
    h, dh, kv = cfg.n_heads, cfg.head_dim, cfg.n_kv
    dt = 2  # bf16
    flops = 0.0
    bytes_ = 0.0
    for w in windows:
        w_eff = s / 2 if w == 0 else min(w, s)
        flops += 4.0 * b * h * s * w_eff * dh * fm      # qk^T and pv matmuls
        # K/V streamed once per q-chunk (blockwise), Q/out once
        kv_read = (s / FLASH_BLOCK) * s * kv * dh * 2 * dt * b
        q_out = 2 * b * s * h * dh * dt
        bytes_ += (kv_read + q_out) * bm
    return {"flops": flops, "bytes": bytes_}


def rwkv_correction(cfg: ModelCfg, cell: ShapeCell) -> dict:
    """WKV time recurrence: per step ~5 fused (hd x hd) head ops + state RW."""
    if cfg.family != "ssm" or cell.kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}
    s, b = cell.seq_len, cell.global_batch
    fm, bm = _train_mults(cell.kind)
    h, hd = cfg.n_heads, cfg.head_dim
    flops = 5.0 * b * s * h * hd * hd * cfg.n_layers * fm
    bytes_ = 2.0 * b * h * hd * hd * 4 * s * cfg.n_layers * bm  # fp32 state RW
    return {"flops": flops, "bytes": bytes_}


def ssm_correction(cfg: ModelCfg, cell: ShapeCell) -> dict:
    """Mamba selective scan: per step 4*B*di*n flops + fp32 state RW."""
    if cfg.family != "hybrid" or cell.kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}
    s, b = cell.seq_len, cell.global_batch
    fm, bm = _train_mults(cell.kind)
    di = cfg.ssm.expand * cfg.d_model
    n = cfg.ssm.state_dim
    flops = 4.0 * b * s * di * n * cfg.n_layers * fm
    bytes_ = 2.0 * b * di * n * 4 * s * cfg.n_layers * bm
    return {"flops": flops, "bytes": bytes_}


def inner_scan_correction(cfg: ModelCfg, cell: ShapeCell) -> dict:
    out = {"flops": 0.0, "bytes": 0.0}
    for fn in (attention_correction, rwkv_correction, ssm_correction):
        c = fn(cfg, cell)
        out["flops"] += c["flops"]
        out["bytes"] += c["bytes"]
    return out
