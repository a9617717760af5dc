# Frozen copy of mppiisaac_tpu_torch/physics/types.py, part of the benchmark's yardstick.
"""State types for the simulator: dataclasses of tensors.

Same fields as the JAX package's `physics/types.py` `SimState` /
`ModelParams`, with the reference's tensor views (`root_state`,
`dof_state`, `rigid_body_state`). Every field is per-env; a batch of envs or
of MPPI samples carries a leading axis on every field. Instances are treated
as values: `replace` returns a new state and leaves the old one untouched.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

SIM_STATE_FIELDS = (
    "root_pos", "root_quat", "root_linvel", "root_angvel", "q", "qd",
    "dof_target", "body_pos", "body_quat", "body_linvel", "body_angvel",
    "net_contact_force", "contact_lam",
)


@dataclass
class SimState:
    # --- integrated state ---
    root_pos: torch.Tensor        # (A,3)
    root_quat: torch.Tensor       # (A,4) xyzw
    root_linvel: torch.Tensor     # (A,3) world-frame velocity of the root link origin
    root_angvel: torch.Tensor     # (A,3) world frame
    q: torch.Tensor               # (D,)
    qd: torch.Tensor              # (D,)
    # --- command state (set by apply_*_cmd, consumed by step) ---
    dof_target: torch.Tensor      # (D,)
    # --- derived caches (refreshed by step / refresh) ---
    body_pos: torch.Tensor        # (B,3)
    body_quat: torch.Tensor       # (B,4)
    body_linvel: torch.Tensor     # (B,3)
    body_angvel: torch.Tensor     # (B,3)
    net_contact_force: torch.Tensor  # (B,3)
    # persistent-contact impulse cache (n_con,4); None = caching off
    contact_lam: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "SimState":
        return dataclasses.replace(self, **changes)

    def map(self, fn) -> "SimState":
        """Apply fn to every tensor field (None stays None)."""
        return SimState(**{
            f: (None if getattr(self, f) is None else fn(getattr(self, f)))
            for f in SIM_STATE_FIELDS
        })

    def tensors(self):
        return [getattr(self, f) for f in SIM_STATE_FIELDS if getattr(self, f) is not None]

    # ------------------------------------------------------------------
    # reference-layout views
    # ------------------------------------------------------------------
    @property
    def root_state(self) -> torch.Tensor:
        """(...,A,13) = pos + quat_xyzw + linvel + angvel (Isaac layout)."""
        return torch.cat(
            [self.root_pos, self.root_quat, self.root_linvel, self.root_angvel], dim=-1
        )

    @property
    def dof_state(self) -> torch.Tensor:
        """(...,D,2) interleaved (q, qd) per DOF (Isaac layout)."""
        return torch.stack([self.q, self.qd], dim=-1)

    @property
    def rigid_body_state(self) -> torch.Tensor:
        """(...,B,13)."""
        return torch.cat(
            [self.body_pos, self.body_quat, self.body_linvel, self.body_angvel], dim=-1
        )

    def with_dof_state(self, dof_state: torch.Tensor) -> "SimState":
        return self.replace(q=dof_state[..., 0], qd=dof_state[..., 1])

    def with_root_state(self, root_state: torch.Tensor) -> "SimState":
        return self.replace(
            root_pos=root_state[..., 0:3],
            root_quat=root_state[..., 3:7],
            root_linvel=root_state[..., 7:10],
            root_angvel=root_state[..., 10:13],
        )


@dataclass
class ModelParams:
    """Per-env-randomizable physical parameters (domain randomization)."""

    body_mass_scale: torch.Tensor    # (B,)
    geom_friction: torch.Tensor      # (G,) friction scale per geom

    @staticmethod
    def default(nbody: int, ngeom: int, geom_friction, device="cuda") -> "ModelParams":
        """Unit mass scales and the given per-geom friction (the JAX
        package's `ModelParams.default`), float32 on `device`."""
        return ModelParams(
            body_mass_scale=torch.ones(nbody, dtype=torch.float32, device=device),
            geom_friction=torch.as_tensor(np.asarray(geom_friction, np.float32), device=device),
        )

    def map(self, fn) -> "ModelParams":
        return ModelParams(fn(self.body_mass_scale), fn(self.geom_friction))
