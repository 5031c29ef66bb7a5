"""Config registry: --arch <id> -> ModelCfg (+ reduced smoke variant).

A copy of the reference's ``repro/configs`` (stdlib dataclasses only), so
that the port imports no part of ``repro``; the two must stay equal.
"""

from importlib import import_module

from .base import LONG_CTX_OK, SHAPES, ModelCfg, ShapeCell, smoke_variant

_MODULES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "gemma3-4b": "gemma3_4b",
    "qwen1.5-32b": "qwen15_32b",
    "command-r-35b": "command_r_35b",
    "whisper-tiny": "whisper_tiny",
    "rwkv6-1.6b": "rwkv6_1b6",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "hymba-1.5b": "hymba_1b5",
}
ARCHS = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelCfg:
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; options: {ARCHS}")
    mod = import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def cells(arch: str):
    """The (arch x shape) dry-run cells, with skip reasons."""
    out = []
    cfg = get_config(arch)
    for sh in SHAPES.values():
        skip = None
        if sh.name == "long_500k" and arch not in LONG_CTX_OK:
            skip = "pure full-attention arch: no sub-quadratic 500k mechanism"
        out.append((sh, skip))
    return out
