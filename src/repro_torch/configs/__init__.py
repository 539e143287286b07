"""Architecture registry of the port: ``get(name)`` -> the published
ModelConfig, ``get_smoke(name)`` -> the reduced same-family config of the
CPU tests.  The port serves all ten archs of the JAX package: qwen3-8b,
qwen1.5-4b and chatglm3-6b (dense attention, K6), mamba2-130m (Mamba-2
SSD, K7), gemma3-12b (local and global attention, K6), recurrentgemma-9b
(RG-LRU and local attention, K6), phi3.5-moe and arctic-480b (routed
experts; arctic with a dense residual FFN), llava-next-mistral-7b (a VLM:
projected patches before the text) and seamless-m4t-medium
(encoder-decoder with cross-attention)."""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig, ShapeCfg

ARCH_IDS = ("qwen3_8b", "mamba2_130m", "gemma3_12b", "recurrentgemma_9b",
            "qwen1_5_4b", "chatglm3_6b", "llava_next_mistral_7b",
            "seamless_m4t_medium", "phi3_5_moe", "arctic_480b")

ALIASES = {"qwen3-8b": "qwen3_8b", "mamba2-130m": "mamba2_130m",
           "gemma3-12b": "gemma3_12b",
           "recurrentgemma-9b": "recurrentgemma_9b",
           "qwen1.5-4b": "qwen1_5_4b", "chatglm3-6b": "chatglm3_6b",
           "llava-next-mistral-7b": "llava_next_mistral_7b",
           "seamless-m4t-medium": "seamless_m4t_medium",
           "phi3.5-moe": "phi3_5_moe", "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
           "arctic-480b": "arctic_480b"}


def _module(name: str):
    key = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; the port knows "
                       f"{list(ARCH_IDS)}")
    return importlib.import_module(f"{__name__}.{key}")


def get(name: str) -> ModelConfig:
    """The published config of ``name``."""
    return _module(name).config()


def get_smoke(name: str) -> ModelConfig:
    """The reduced config of ``name`` for CPU smoke tests."""
    return _module(name).smoke()


def all_configs() -> dict[str, ModelConfig]:
    """Every arch the port serves, by id."""
    return {a: get(a) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "ALIASES", "get", "get_smoke", "all_configs",
           "ModelConfig", "ShapeCfg"]
