# Frozen copy of mppiisaac_tpu_torch/physics/linalg.py, part of the benchmark's yardstick.
"""Small batched SPD solves for the engine (parity: the JAX package's
`physics/linalg.py`).

The articulation mass matrices are SPD and tiny (nv ≤ ~18, static), so the
factor is `math3d.cholesky_factor`: unrolled over the columns, vectorized
over the batch, its pivot clamped to `eps` before the root as the JAX
package's is. Nothing here reads a value on the host, so a captured step
can run it.
"""
from __future__ import annotations

import torch

from .math3d import cholesky_factor, cholesky_solve_factored


def solve_psd(M: torch.Tensor, b: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Solve M x = b for SPD M. M: (..., n, n), b: (..., n)."""
    return cholesky_solve_factored(cholesky_factor(M, eps), b)


def solve_psd_multi(M: torch.Tensor, B: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Solve M X = B for SPD M with several right-hand sides: M (..., n, n),
    B (..., n, m) → X (..., n, m), one factor for every column."""
    return cholesky_solve_factored(cholesky_factor(M, eps), B)
