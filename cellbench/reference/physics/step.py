# Frozen copy of mppiisaac_tpu_torch/physics/step.py, part of the benchmark's yardstick.
"""The simulator step: (SimState, ModelParams) → SimState, batched over a
leading env axis (parity: the JAX package's `physics/step.py` `Engine`).

`Engine.step` advances every env of a batch one control dt — `substeps`
calls of `stacked_substep` (physics/stacked.py) with the contact forces of
`compute_contact_forces` and the impulse pass of physics/contact.py — and
ends with the body-cache refresh: the JAX package's XLA engine, whose
`vmap(engine.step)` becomes one call on (N, ...) tensors. The fused kernels
(ops/fused_rollout) are another model of the same physics (their impulse
sweeps differ, see tests/test_impulse_parity.py); `SimConfig.fused_world`
and the planner's `use_fused` choose between them.
"""
from __future__ import annotations

from typing import Optional

import torch

from .contact import build_contact_tables, compute_contact_forces
from .scene_model import SceneModel
from .stacked import build_stacked, refresh_stacked, stacked_substep
from .types import ModelParams, SimState


class Engine:
    """Static scene data; `step` and `refresh` are functions of their inputs.

    use_impulse: layer the free-body impulse pass over the penalty model (the
    world fidelity); False gives the penalty-only model."""

    def __init__(self, scene: SceneModel, use_impulse: bool = True):
        self.use_impulse = use_impulse
        self.scene = scene
        self.stacked = build_stacked(scene)
        self.tables = build_contact_tables(scene)
        # refine until the substep dt is small enough for the compliant
        # contact model (≤ ~12.5 ms), keeping the configured dt/substeps
        # semantics otherwise
        has_contacts = (
            len(self.tables.cp_geom) or len(self.tables.bp_geom)
            or len(self.tables.cc_a) or len(self.tables.cb_cap)
            or len(self.tables.bb_a) or len(self.tables.bbc_a)
        )
        n = scene.substeps
        while has_contacts and scene.dt / n > 0.0126:
            n += 1
        self.substeps = n
        self.dt_sub = scene.dt / n

    def default_params(self, n: int = 1, device="cpu") -> ModelParams:
        """Unit mass and friction scales for n envs."""
        s = self.scene
        return ModelParams(torch.ones(n, s.nbody, dtype=torch.float32, device=device),
                           torch.ones(n, s.ngeom, dtype=torch.float32, device=device))

    def initial_state(self, device="cpu") -> SimState:
        s = self.scene

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        def ident(n):
            q = z(n, 4)
            q[:, 3] = 1.0
            return q

        return SimState(
            root_pos=z(s.nactor, 3), root_quat=ident(s.nactor),
            root_linvel=z(s.nactor, 3), root_angvel=z(s.nactor, 3),
            q=z(s.ndof), qd=z(s.ndof), dof_target=z(s.ndof),
            body_pos=z(s.nbody, 3), body_quat=ident(s.nbody),
            body_linvel=z(s.nbody, 3), body_angvel=z(s.nbody, 3),
            net_contact_force=z(s.nbody, 3),
            contact_lam=z(self.tables.n_con, 4),
        )

    def _contact_fn(self, dt_sub):
        scene, tables = self.scene, self.tables

        def fn(body_pos, body_quat, body_linvel, body_angvel, geom_friction):
            return compute_contact_forces(scene, tables, body_pos, body_quat, body_linvel,
                                          body_angvel, geom_friction, dt_sub)

        return fn

    def refresh(self, state: SimState) -> SimState:
        """Recompute derived body caches without stepping."""
        return refresh_stacked(self.stacked, state)

    def step(self, state: SimState, params: Optional[ModelParams] = None) -> SimState:
        """Advance every env of the batch (leading axis N of each field) one
        control dt — all substeps — and refresh the body caches. params:
        (N, ...) scales, unit scales when None."""
        if params is None:
            params = self.default_params(state.root_pos.shape[0], state.root_pos.device)
        contact_fn = self._contact_fn(self.dt_sub)
        for _ in range(self.substeps):
            state = stacked_substep(self.stacked, state, params, self.dt_sub, contact_fn,
                                    self.tables, use_impulse=self.use_impulse)
        return self.refresh(state)
