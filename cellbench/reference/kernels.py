"""The two kernels' plain versions, as the benchmark's yardstick.

`rollout_plain` and `world_step_plain` are frozen copies of the port's
plain versions of K1 (the K-sample, H-step rollout) and K2 (one world dt) in
`mppiisaac_tpu_torch/ops/fused_rollout.py`; `Rollout` and `WorldStep` pack a
state into their row layout as the port's wrappers do. Everything here runs
on the frozen copies under this package and imports nothing of the port.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.fused_physics import (KernelScene, command_targets, fk, free_cand_indices,
                                rows_to_state, state_dict_to_rows, state_to_rows, substep,
                                task_cost)
from .physics.contact import build_contact_tables
from .physics.types import SimState


def lam_rows(ks: KernelScene, fc_idx: torch.Tensor, lam: Optional[torch.Tensor], lead, device):
    """The λ rows of `contact_lam` (…, n_con, 4) at the swept candidates,
    zeros where the state carries no matching cache. → (…, n_fc, 4)."""
    if lam is not None and lam.shape[-2] == ks.n_con and lam.shape[-1] == 4:
        return lam[..., fc_idx.to(lam.device), :].to(torch.float32)
    return torch.zeros(lead + (ks.n_fc, 4), dtype=torch.float32, device=device)


def stored(x, store):
    """x rounded through the dtype `store` (None: x itself): a value kept in
    that dtype where it passes from one stage to the next."""
    if store is None:
        return x
    if isinstance(x, dict):
        return {k: stored(v, store) for k, v in x.items()}
    return x.to(store).to(x.dtype)


def rollout_plain(ks: KernelScene, rows, V, mass, fric, H: int, substeps: int,
                  dt_sub: float, vis_body: int, sweeps: int, world_fidelity: bool = True):
    """K1: rows (NS + 4·n_fc, K) state and λ rows (fast fidelity: NS), V
    (H,nu,K) controls already rounded through bf16, mass (B,K), fric (G,K)
    → costs (K,H), vis (H,K,3) rounded through bf16."""
    st = rows_to_state(ks, rows)
    mass_k, fric_k = mass.T, fric.T
    costs, vis = [], []
    for t in range(H):
        tgt = command_targets(ks, V[t].T, st["q"])
        for _ in range(substeps):
            st = substep(ks, st, tgt, mass_k, fric_k, dt_sub, sweeps, world_fidelity)
        pos, quat, _, _, _ = fk(ks, st)
        costs.append(task_cost(ks, st, pos, quat))
        if vis_body >= 0:
            vis.append(pos[vis_body].to(torch.bfloat16).to(pos[vis_body].dtype))
        else:
            vis.append(torch.zeros_like(pos[0]))
    return torch.stack(costs, 1), torch.stack(vis, 0)


def world_step_plain(ks: KernelScene, rows, tgt, mass, fric, substeps: int, dt_sub: float,
                     sweeps: int):
    """K2: rows (NS + 4·n_fc, N) of N envs, tgt (N, D), mass (N, B), fric
    (N, G) → rows one control dt later, each env on its own."""
    st = rows_to_state(ks, rows)
    for _ in range(substeps):
        st = substep(ks, st, tgt, mass, fric, dt_sub, sweeps)
    return state_dict_to_rows(st)


class Rollout:
    """K1's reference over one scene: the port's FusedRollout set-up (its
    tables, substeps and fidelity) with `rollout_plain` in place of the
    kernel."""

    def __init__(self, built, engine, cost, H: int, K: int, vis_body: Optional[int],
                 substeps: Optional[int], impulse_sweeps: int, world_fidelity: bool,
                 manifold: str):
        tables = engine.tables
        if manifold == "reduced" and not world_fidelity:
            tables = build_contact_tables(built.scene, bbc_samples=8)
        self.world_fidelity = bool(world_fidelity)
        self.ks = KernelScene.build(built, engine, cost, tables=tables)
        self.fc_idx = torch.as_tensor(free_cand_indices(built.scene, tables))
        self.H, self.K = int(H), int(K)
        self.vis_body = -1 if vis_body is None else int(vis_body)
        self.substeps = engine.substeps if substeps is None else int(substeps)
        self.dt_sub = engine.scene.dt / self.substeps
        self.impulse_sweeps = int(impulse_sweeps)
        self.store = None

    def pack(self, sim_state_K: SimState, params_K, V_khn: torch.Tensor):
        """→ rows (NS + 4·n_fc, K), V (H,nu,K) rounded through bf16 and back,
        mass (B,K), fric (G,K)."""
        K = sim_state_K.q.shape[0]
        lam = lam_rows(self.ks, self.fc_idx, sim_state_K.contact_lam, (K,),
                       sim_state_K.q.device) if self.world_fidelity else None
        rows = state_to_rows(self.ks, sim_state_K.root_state, sim_state_K.q, sim_state_K.qd, lam)
        V = V_khn.to(torch.bfloat16).permute(1, 2, 0).to(torch.float32).contiguous()
        mass = params_K.body_mass_scale.to(torch.float32).T.contiguous()
        fric = params_K.geom_friction.to(torch.float32).T.contiguous()
        return rows, V, mass, fric

    def run(self, rows, V, mass, fric, H=None):
        """→ costs (K, H), vis (H, K, 3); `H` fewer steps than the horizon.
        With `store`, the state rows come in and the costs go out in that
        dtype."""
        costs, vis = rollout_plain(self.ks, stored(rows, self.store), V, mass, fric,
                                   self.H if H is None else H, self.substeps, self.dt_sub,
                                   self.vis_body, self.impulse_sweeps, self.world_fidelity)
        return stored(costs, self.store), vis


class WorldStep:
    """K2's reference over the world's scene (unit mass and friction
    scales, as the world runs)."""

    def __init__(self, built, engine, impulse_sweeps: int):
        self.ks = KernelScene.build(built, engine, None)
        self.fc_idx = torch.as_tensor(free_cand_indices(built.scene, engine.tables))
        self.substeps = engine.substeps
        self.dt_sub = engine.dt_sub
        self.impulse_sweeps = int(impulse_sweeps)
        self.store = None

    def rows(self, state: SimState) -> torch.Tensor:
        """SimState of N envs → its K2 rows (NS + 4·n_fc, N)."""
        N = state.q.shape[0]
        lam = lam_rows(self.ks, self.fc_idx, state.contact_lam, (N,), state.q.device)
        return state_to_rows(self.ks, state.root_state, state.q, state.qd, lam)

    def out_rows(self, state: SimState) -> torch.Tensor:
        """The rows K2 writes for a stepped SimState of N envs: its state
        rows with the net contact forces, then its λ rows."""
        N = state.q.shape[0]
        rows = self.rows(state)
        NS = self.ks.n_state_rows
        ncf = state.net_contact_force.reshape(N, -1).T.to(torch.float32)
        return torch.cat([rows[: NS - ncf.shape[0]], ncf, rows[NS:]], 0)

    def step_rows(self, rows, tgt):
        """rows (NS + 4·n_fc, N), tgt (N, D) → rows one dt later."""
        N = rows.shape[1]
        ks = self.ks
        mass = torch.ones(N, ks.nbody, dtype=torch.float32, device=rows.device)
        fric = torch.ones(N, ks.ngeom, dtype=torch.float32, device=rows.device)
        out = world_step_plain(ks, stored(rows, self.store), stored(tgt, self.store), mass, fric,
                               self.substeps, self.dt_sub, self.impulse_sweeps)
        return stored(out, self.store)


def table_bytes(ks: KernelScene) -> int:
    """The bytes of a scene's tables as a kernel reads them once: every
    array of the KernelScene at four bytes an element."""
    n = 0
    for v in vars(ks).values():
        if isinstance(v, np.ndarray):
            n += 4 * v.size
    return n
