"""Architecture registry — ``--arch <id>`` resolution, with the JAX
package's names.  The configs themselves are copies of the reference's
(``repro_torch/configs/*.py``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_LM_MODULES = {
    "llava-next-34b": "llava_next_34b",
    "mamba2-130m": "mamba2_130m",
    "gemma2-27b": "gemma2_27b",
    "olmo-1b": "olmo_1b",
    "llama3-405b": "llama3_405b",
    "gemma3-27b": "gemma3_27b",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "seamless-m4t-large-v2": "seamless_m4t_v2",
    "zamba2-2.7b": "zamba2_2p7b",
}

CNN_ARCHS = ("alexnet", "vgg16")
ARCH_IDS = tuple(_LM_MODULES) + CNN_ARCHS


def get_config(arch: str) -> ModelConfig:
    if arch not in _LM_MODULES:
        raise KeyError(f"unknown LM arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_LM_MODULES[arch]}")
    return mod.CONFIG


def all_lm_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in _LM_MODULES}
