"""Tensor byte transport in the `torch.save` format: the bytes of the
reference's `mppiisaac/utils/transport.py` and of the JAX package's
`runtime/transport.py`, so a world process written against either talks to
this planner unchanged."""
from __future__ import annotations

import io

import numpy as np
import torch


def torch_to_bytes(t) -> bytes:
    """A tensor (any device) or a numpy array → `torch.save` bytes of it on
    the CPU."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    buf = io.BytesIO()
    torch.save(t.detach().cpu(), buf)
    return buf.getvalue()


def bytes_to_torch(b: bytes, device=None) -> torch.Tensor:
    """`torch.save` bytes → the tensor, loaded on the CPU with
    `weights_only=True`, then moved to `device` when one is given."""
    t = torch.load(io.BytesIO(b), weights_only=True, map_location="cpu")
    return t if device is None else t.to(device)
