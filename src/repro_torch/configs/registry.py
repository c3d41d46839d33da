"""Architecture registry — ``--arch <id>`` resolution, with the JAX
package's names.  The configs themselves are copies of the reference's
(``repro_torch/configs/*.py``)."""
from __future__ import annotations

import importlib
from dataclasses import dataclass

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


# ---------------------------------------------------------------------------
# CNN zoo models — the multi-tenant serving registry.  Each entry names one
# *compiled-model variant* the ModelZooServer can hold: the network spec
# (repro_torch.models.cnn.NETWORKS key), the weight dtype it serves with, and the
# native input resolution.  Zoo models resolve by name exactly like the LM
# configs above resolve by arch id.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ZooModelSpec:
    """One servable model variant of the zoo: ``net`` is the CNN spec key,
    ``weight_dtype`` the serving weight format (``"float32"`` or
    ``"int8"`` — int8 params are per-channel QTensors the kernels consume
    un-dequantized), ``in_res`` the native input resolution."""
    name: str
    net: str
    weight_dtype: str
    in_res: int

    @property
    def weight_bytes(self) -> int:
        return 1 if self.weight_dtype == "int8" else 4


ZOO_MODELS: dict[str, ZooModelSpec] = {
    "alexnet": ZooModelSpec("alexnet", "alexnet", "float32", 227),
    "vgg16": ZooModelSpec("vgg16", "vgg16", "float32", 224),
    "alexnet-int8": ZooModelSpec("alexnet-int8", "alexnet", "int8", 227),
}


def get_zoo_model(name: str) -> ZooModelSpec:
    """Resolve one zoo model by name (the serving twin of
    :func:`get_config`)."""
    if name not in ZOO_MODELS:
        raise KeyError(f"unknown zoo model {name!r}; "
                       f"known: {tuple(ZOO_MODELS)}")
    return ZOO_MODELS[name]
