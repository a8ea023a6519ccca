"""Registry of assigned architectures and benchmark input shapes."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "smollm-135m": "smollm_135m",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "internvl2-76b": "internvl2_76b",
    "mamba2-2.7b": "mamba2_2p7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen3-4b": "qwen3_4b",
    "zamba2-7b": "zamba2_7b",
    "granite-20b": "granite_20b",
    "minicpm-2b": "minicpm_2b",
    "musicgen-medium": "musicgen_medium",
}

ARCHS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    cfg: ArchConfig = mod.CONFIG
    cfg.validate()
    return cfg


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
