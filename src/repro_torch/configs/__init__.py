"""Architecture registry of the port: ``--arch <id>`` resolves here.

Slice 1 ports tinyllama-1.1b only; the other families of the reference
follow in later slices (ROADMAP A6).
"""

from __future__ import annotations

from repro_torch.configs import tinyllama_1_1b
from repro_torch.configs.base import ArchConfig  # noqa: F401

_MODULES = {"tinyllama-1.1b": tinyllama_1_1b}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, **over) -> ArchConfig:
    return _MODULES[arch_id].config(**over)


def get_smoke(arch_id: str, **over) -> ArchConfig:
    return _MODULES[arch_id].smoke(**over)
