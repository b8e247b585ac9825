"""Architecture config registry: ``--arch <id>`` resolution.

Knows the architectures the port supports.  The other ids of ``repro``'s
registry need model families that are not ported yet and are refused with
a clear error rather than reported unknown.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (deepseek_7b, deepseek_v3, gemma2_2b, gemma_2b, jamba_1_5_large,
               phi3_5_moe_42b, phi3_mini, rwkv6_7b)
from .common import smoke_reduce

_MODULES = (phi3_mini, gemma_2b, gemma2_2b, deepseek_7b, rwkv6_7b, phi3_5_moe_42b,
            jamba_1_5_large, deepseek_v3)

ARCH_IDS: tuple[str, ...] = tuple(m.ARCH_ID for m in _MODULES)
_BY_ID = {m.ARCH_ID: m for m in _MODULES}

# ids of ``repro.configs`` whose families (audio, VLM) wait for later slices
NOT_PORTED = ("musicgen-large", "internvl2-2b")


def get_config(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        raise NotImplementedError(f"arch {arch!r} is not ported yet; "
                                  f"ported: {list(ARCH_IDS)}")
    if arch not in _BY_ID:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_BY_ID)}")
    return _BY_ID[arch].config()


def get_smoke_config(arch: str) -> ModelConfig:
    return smoke_reduce(get_config(arch))
