"""Architecture registry: ``--arch`` lookup for the configs this port serves.

The port carries the dense transformer configs, RWKV6 and Hymba so far; the
other families of ``repro.configs`` join when their models are ported.
"""
from __future__ import annotations

from .base import ArchConfig
from .granite_8b import CONFIG as _granite
from .hymba_1_5b import CONFIG as _hymba
from .phi4_mini_3_8b import CONFIG as _phi4
from .rwkv6_7b import CONFIG as _rwkv6

ARCHS: dict[str, ArchConfig] = {c.name: c for c in (_phi4, _granite, _rwkv6, _hymba)}


def get(arch: str) -> ArchConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}") from None
