"""IC generator registry. Counterpart of `parallelnbody_tpu/models/registry.py`."""

from __future__ import annotations

from typing import Callable

IC_REGISTRY: dict[str, Callable] = {}


def register_ic(name: str):
    def deco(fn):
        IC_REGISTRY[name] = fn
        return fn

    return deco


def get_ic(name: str) -> Callable:
    try:
        return IC_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown IC {name!r}; options: {sorted(IC_REGISTRY)}")
