"""Host tables copied to a device once.

A control step captured in a CUDA graph may copy nothing from host memory,
so every constant table a step reads (scene tables, index arrays, masks,
command maps) is copied to its device at its first use and kept there.
`DeviceCache` is that one decision, shared by the modules that hold such
tables."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


class DeviceCache:
    """Tensors made from host arrays, one per (name, dtype, device), each
    made at its first `get` and kept."""

    def __init__(self):
        self._t: Dict[Tuple[str, torch.dtype, torch.device], torch.Tensor] = {}

    def get(self, name: str, make: Callable, dtype: torch.dtype, device) -> torch.Tensor:
        """The host array `make()` as a tensor of `dtype` on `device`."""
        key = (name, dtype, torch.device(device))
        t = self._t.get(key)
        if t is None:
            t = self._t[key] = torch.as_tensor(make(), dtype=dtype, device=device)
        return t

    def refill(self, name: str, value):
        """Write the host array `value` into every copy of `name` in place,
        in stream order: a captured graph that reads the copy sees it."""
        for (n, dtype, _), t in self._t.items():
            if n == name:
                t.copy_(torch.as_tensor(value, dtype=dtype))
