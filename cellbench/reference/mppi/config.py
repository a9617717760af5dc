# Frozen copy of mppiisaac_tpu_torch/mppi/config.py, part of the benchmark's yardstick.
"""MPPI solver configuration — field-for-field parity with the reference's
external solver dep `mppi_torch` (contract dumped at
the reference's `benchmarks/point_robot/setup/mppi.yaml:6-38` plus extras in
`conf/mppi/omnipanda_effort.yaml:29-31`; SURVEY §2.2).

The port reads the shared conf as it is. `device` stays a parity field that
nothing reads: the port's device is an explicit argument of each entry point."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np


@dataclass
class MPPIConfig:
    num_samples: int = 100                    # K
    horizon: int = 15                         # H
    mppi_mode: str = "halton-spline"          # halton-spline | simple
    sampling_method: str = "halton"           # halton | random
    noise_sigma: Any = None                   # (nu,nu) covariance (list-of-lists)
    noise_mu: Any = None                      # (nu,) mean, default 0
    device: str = "tpu"                       # parity field, not read by the port
    lambda_: float = 0.05                     # temperature
    update_lambda: bool = False
    update_cov: bool = False
    u_min: Any = None                         # scalar or (nu,)
    u_max: Any = None
    u_init: Any = 0.0                         # refill value when shifting U
    U_init: Any = None                        # (H,nu) warm start
    u_scale: float = 1.0
    u_per_command: int = 1
    rollout_var_discount: float = 0.95
    sample_null_action: bool = False
    noise_abs_cost: bool = False
    filter_u: bool = False
    use_priors: bool = False
    eta_u_bound: float = 10.0
    eta_l_bound: float = 5.0
    seed_val: int = 42
    # extensions absent in the reference
    knot_scale: int = 4                       # halton-spline: H / knot_scale knots
    spline_degree: int = 2
    # planner-model fidelity knobs for the fused rollout kernel (the world sim
    # always runs full fidelity; the reference has no such split because its
    # rollouts ARE the same PhysX sim). "world": rollouts reproduce the world
    # step's exact contact treatment (vector friction cone + persistent-λ warm
    # start — required for grasp-hold prediction, panda_pick/omni_panda_pick).
    # "fast": scalar accumulated-cone friction, no λ carry (~20% faster).
    rollout_fidelity: str = "world"           # world | fast
    rollout_substeps: Optional[int] = None    # None = match the world sim
    rollout_sweeps: int = 2                   # GS impulse sweeps per substep
    # "reduced": fast-fidelity rollouts sample box-box pairs with corners only
    # (8 vs 14 bbc samples, ~40% fewer narrowphase+swept candidates); the
    # world sim and world-fidelity rollouts always keep the full manifold.
    rollout_manifold: str = "full"            # full | reduced
    # tape-prior sampling-mean blend (biased MPPI): sample around
    # (1-a)·U + a·tape instead of U. 0 = off (tape rides one sample only).
    # Rhythmic priors (quadruped gait) need the blend — a single tape sample
    # among K cannot hold phase coherence in the weighted average.
    prior_blend: float = 0.0

    def resolved(self, nu: int) -> "MPPIConfig":
        """Normalize list/scalar fields to numpy arrays of the right shape."""
        c = MPPIConfig(**{**self.__dict__})
        c.noise_sigma = (
            np.asarray(self.noise_sigma, dtype=np.float64)
            if self.noise_sigma is not None
            else np.eye(nu)
        )
        if c.noise_sigma.ndim == 0:
            c.noise_sigma = np.eye(nu) * float(c.noise_sigma)
        assert c.noise_sigma.shape == (nu, nu), c.noise_sigma.shape
        c.noise_mu = (
            np.asarray(self.noise_mu, dtype=np.float64)
            if self.noise_mu is not None
            else np.zeros(nu)
        )

        def vec(x, default):
            if x is None:
                return np.full(nu, default)
            a = np.asarray(x, dtype=np.float64).reshape(-1)
            if a.size == 1:
                return np.full(nu, a[0])
            assert a.size == nu, (a, nu)
            return a

        c.u_min = vec(self.u_min, -np.inf)
        c.u_max = vec(self.u_max, np.inf)
        c.u_init = vec(self.u_init, 0.0)
        if self.U_init is not None:
            c.U_init = np.asarray(self.U_init, dtype=np.float64).reshape(self.horizon, nu)
        return c
