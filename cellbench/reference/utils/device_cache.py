# Frozen copy of mppiisaac_tpu_torch/utils/device_cache.py, part of the benchmark's yardstick.
"""Host tables copied to a device once.

A control step captured in a CUDA graph may copy nothing from host memory,
so every constant table a step reads (scene tables, index arrays, masks,
command maps) is copied to its device at its first use and kept there.
`DeviceCache` is that one decision, shared by the modules that hold such
tables."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


class DeviceCache:
    """Tensors made from host arrays, one per (name, dtype, device), each
    made at its first `get` and kept."""

    def __init__(self):
        self._t: Dict[Tuple[str, torch.dtype, torch.device], torch.Tensor] = {}
        self._make: Dict[str, Callable] = {}

    def get(self, name: str, make: Callable, dtype: torch.dtype, device) -> torch.Tensor:
        """The host array `make()` as a tensor of `dtype` on `device`."""
        key = (name, dtype, torch.device(device))
        t = self._t.get(key)
        if t is None:
            t = self._t[key] = torch.as_tensor(make(), dtype=dtype, device=device)
            self._make.setdefault(name, make)
        return t

    def refresh(self, name: Optional[str] = None):
        """Make every copy (of `name`, or of all) anew from its host array
        and write it in place, in stream order: a captured graph that reads
        the copy sees the new value."""
        for (n, dtype, _), t in self._t.items():
            if name is None or n == name:
                t.copy_(torch.as_tensor(self._make[n](), dtype=dtype))


def cached(owner, name: str, make: Callable, dtype: torch.dtype, device) -> torch.Tensor:
    """`make()` as a tensor of `dtype` on `device`, kept in the DeviceCache
    that `owner` (a scene's tables, an objective) holds as `_dev`, made at
    the first call."""
    cache = owner.__dict__.get("_dev")
    if cache is None:
        cache = owner.__dict__["_dev"] = DeviceCache()
    return cache.get(name, make, dtype, device)


def refresh_cached(owner):
    """Write `owner`'s cached tensors anew from their host values, in place
    (after the owner's attributes changed)."""
    cache = owner.__dict__.get("_dev")
    if cache is not None:
        cache.refresh()
