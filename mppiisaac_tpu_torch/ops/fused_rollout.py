"""Kernel wrappers: the fused MPPI rollout (K1) and the fused world step (K2).

Counterparts of the JAX package's `ops/pallas/fused_rollout.py`
`FusedRollout` and `FusedWorldStep`. Each wrapper packs the state into the
kernels' (rows, K) structure-of-arrays layout, checks its inputs, and then

* on CUDA tensors launches its hand-written kernel (csrc/fused_rollout.cu,
  built at first use by ops/native.py) on the current stream, or raises;
* on CPU tensors runs the kernel's plain PyTorch version (`rollout_plain` /
  `world_step_plain` below, on the device-code twin of ops/fused_physics).

Rows per sample: the state rows (13 per actor root, q, qd, 3 net-force per
body), then 4 λ rows [λ_n, λ_t·3] per swept contact candidate in batched
block order (`free_cand_indices`): the persistent contact impulses, seeded
from and scattered back to `SimState.contact_lam`.

Each wrapper class keeps a plain integer `launches`, raised by one where it
launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from ..physics.types import ModelParams, SimState
from .fused_physics import (
    TASK_PANDA_PICK,
    TASK_PANDA_REACH,
    CostSpec,
    KernelScene,
    command_targets,
    fk,
    free_cand_indices,
    rows_to_state,
    state_dict_to_rows,
    state_to_rows,
    substep,
    task_cost,
)

# compile-time bounds of csrc/scene_tables.cuh, in the order max_bounds()
# reports them (checked against the library)
MAX_ACTORS, MAX_BODIES, MAX_DOFS, MAX_NU = 8, 32, 16, 16
MAX_GEOMS, MAX_BLK, MAX_CAND, MAX_SC, MAX_PSI, MAX_BIN, MAX_S = 64, 48, 160, 1024, 16, 4, 16
BOUNDS = (MAX_ACTORS, MAX_BODIES, MAX_DOFS, MAX_NU, MAX_GEOMS, MAX_BLK, MAX_CAND, MAX_SC,
          MAX_PSI, MAX_BIN, MAX_S)


def _arr(ctype, n):
    return ctype * n


class _SceneTablesC(ctypes.Structure):
    """Mirror of `struct SceneTables` in csrc/scene_tables.cuh."""
    _fields_ = [
        *[(n, ctypes.c_int) for n in (
            "nactor", "nbody", "ndof", "ngeom", "nu", "nblk", "n_fc", "nbin", "task", "ee_body",
            "goal_actor", "vis_body", "block_actor", "force_body0", "force_nbody")],
        *[(n, ctypes.c_float) for n in (
            "gravity_z", "eps_v", "max_depth", "max_root_linvel", "max_root_angvel",
            "w_dist", "w_ori", "w_block", "w_force")],
        *[(n, _arr(ctypes.c_int, MAX_ACTORS)) for n in (
            "actor_body0", "actor_nbody", "actor_dof0", "actor_ndof", "actor_dynamic",
            "actor_gravity")],
        ("actor_invm", _arr(ctypes.c_float, MAX_ACTORS)),
        ("actor_iinv", _arr(ctypes.c_float, MAX_ACTORS * 9)),
        *[(n, _arr(ctypes.c_int, MAX_BODIES)) for n in (
            "body_parent", "body_actor", "body_jtype", "body_dof", "body_dofmask", "body_psi")],
        ("body_jpos", _arr(ctypes.c_float, MAX_BODIES * 3)),
        ("body_jquat", _arr(ctypes.c_float, MAX_BODIES * 4)),
        ("body_jaxis", _arr(ctypes.c_float, MAX_BODIES * 3)),
        ("body_mass", _arr(ctypes.c_float, MAX_BODIES)),
        ("body_com", _arr(ctypes.c_float, MAX_BODIES * 3)),
        ("body_inertia", _arr(ctypes.c_float, MAX_BODIES * 9)),
        ("dof_body", _arr(ctypes.c_int, MAX_DOFS)),
        ("dof_mode", _arr(ctypes.c_int, MAX_DOFS)),
        *[(n, _arr(ctypes.c_float, MAX_DOFS)) for n in (
            "dof_kp", "dof_kd", "dof_effort", "dof_maxvel", "dof_damping", "dof_friction",
            "dof_armature", "dof_lower", "dof_upper")],
        ("dof_anc", _arr(ctypes.c_int, MAX_DOFS * MAX_DOFS)),
        ("cmd_W", _arr(ctypes.c_float, MAX_DOFS * MAX_NU)),
        ("bin_dof", _arr(ctypes.c_int, MAX_BIN)),
        ("bin_src", _arr(ctypes.c_int, MAX_BIN)),
        *[(n, _arr(ctypes.c_float, MAX_BIN)) for n in (
            "bin_lo", "bin_hi", "bin_th", "bin_band", "bin_uhi", "bin_ulo", "bin_qopen")],
        ("geom_body", _arr(ctypes.c_int, MAX_GEOMS)),
        ("geom_type", _arr(ctypes.c_int, MAX_GEOMS)),
        ("geom_pos", _arr(ctypes.c_float, MAX_GEOMS * 3)),
        ("geom_quat", _arr(ctypes.c_float, MAX_GEOMS * 4)),
        ("geom_size", _arr(ctypes.c_float, MAX_GEOMS * 3)),
        *[(n, _arr(ctypes.c_int, MAX_BLK)) for n in (
            "blk_kind", "blk_ga", "blk_gb", "blk_ba", "blk_bb", "blk_S", "blk_sc", "blk_c0",
            "blk_flags", "blk_ob")],
        *[(n, _arr(ctypes.c_float, MAX_BLK)) for n in (
            "blk_thr", "blk_kn", "blk_kn_a", "blk_kn_b", "blk_mu0", "blk_m_oth", "blk_npts")],
        ("sconst", _arr(ctypes.c_float, MAX_SC)),
    ]


_TABLE_ARRAYS = (
    "actor_body0", "actor_nbody", "actor_dof0", "actor_ndof", "actor_dynamic", "actor_gravity",
    "actor_invm", "actor_iinv",
    "body_parent", "body_actor", "body_jtype", "body_dof", "body_dofmask", "body_psi",
    "body_jpos", "body_jquat", "body_jaxis", "body_mass", "body_com", "body_inertia",
    "dof_body", "dof_mode", "dof_kp", "dof_kd", "dof_effort", "dof_maxvel", "dof_damping",
    "dof_friction", "dof_armature", "dof_lower", "dof_upper",
    "bin_dof", "bin_src", "bin_lo", "bin_hi", "bin_th", "bin_band", "bin_uhi", "bin_ulo",
    "bin_qopen",
    "geom_body", "geom_type", "geom_pos", "geom_quat", "geom_size",
    "blk_kind", "blk_ga", "blk_gb", "blk_ba", "blk_bb", "blk_S", "blk_sc", "blk_c0", "blk_flags",
    "blk_ob", "blk_thr", "blk_kn", "blk_kn_a", "blk_kn_b", "blk_mu0", "blk_m_oth", "blk_npts",
    "sconst",
)


def check_bounds(ks: KernelScene) -> None:
    """Raise where the scene exceeds the kernels' compile-time bounds."""
    S = int(ks.blk_S.max()) if ks.nblk else 0
    for what, n, cap in (("actors", ks.nactor, MAX_ACTORS), ("bodies", ks.nbody, MAX_BODIES),
                         ("dofs", ks.ndof, MAX_DOFS), ("controls", ks.nu, MAX_NU),
                         ("geoms", ks.ngeom, MAX_GEOMS), ("pair blocks", ks.nblk, MAX_BLK),
                         ("swept candidates", ks.n_fc, MAX_CAND),
                         ("box-sample constants", len(ks.sconst), MAX_SC),
                         ("couple contact links", int((ks.body_psi >= 0).sum()), MAX_PSI),
                         ("binarized dofs", len(ks.bin_dof), MAX_BIN),
                         ("samples per block", S, MAX_S)):
        if n > cap:
            raise ValueError(f"scene has {n} {what}; the CUDA kernels take at most {cap}")


def pack_tables(ks: KernelScene, vis_body: int = -1) -> bytes:
    """KernelScene → the bytes of `struct SceneTables`."""
    check_bounds(ks)
    t = _SceneTablesC()
    c = ks.cost or CostSpec(0, -1, -1, 0.0, 0.0)
    for n, v in (("nactor", ks.nactor), ("nbody", ks.nbody), ("ndof", ks.ndof),
                 ("ngeom", ks.ngeom), ("nu", ks.nu), ("nblk", ks.nblk), ("n_fc", ks.n_fc),
                 ("nbin", len(ks.bin_dof)), ("task", c.task), ("ee_body", c.ee_body),
                 ("goal_actor", c.goal_actor), ("vis_body", vis_body),
                 ("block_actor", c.block_actor), ("force_body0", c.force_body0),
                 ("force_nbody", c.force_nbody),
                 ("gravity_z", ks.gravity_z), ("eps_v", ks.eps_v), ("max_depth", ks.max_depth),
                 ("max_root_linvel", ks.max_root_linvel), ("max_root_angvel", ks.max_root_angvel),
                 ("w_dist", c.w_dist), ("w_ori", c.w_ori), ("w_block", c.w_block),
                 ("w_force", c.w_force)):
        setattr(t, n, v)
    for n in _TABLE_ARRAYS:
        flat = np.asarray(getattr(ks, n)).reshape(-1)
        getattr(t, n)[: len(flat)] = flat.tolist()
    # row-major (MAX_DOFS, MAX_DOFS) and (MAX_DOFS, MAX_NU) tables
    anc = np.zeros((MAX_DOFS, MAX_DOFS), np.int32)
    anc[: ks.ndof, : ks.ndof] = ks.dof_anc
    t.dof_anc[:] = anc.reshape(-1).tolist()
    W = np.zeros((MAX_DOFS, MAX_NU), np.float32)
    W[: ks.ndof, : ks.nu] = ks.cmd_W
    t.cmd_W[:] = W.reshape(-1).tolist()
    return bytes(t)


def _library():
    from .native import load_library

    lib = load_library()
    size = lib.scene_tables_size()
    if size != ctypes.sizeof(_SceneTablesC):
        raise RuntimeError(
            f"SceneTables layout mismatch: library {size} B, wrapper {ctypes.sizeof(_SceneTablesC)} B")
    bounds = (ctypes.c_int * len(BOUNDS))()
    lib.max_bounds(ctypes.cast(bounds, ctypes.c_void_p))
    if tuple(bounds) != BOUNDS:
        raise RuntimeError(f"kernel bounds {tuple(bounds)} differ from the wrapper's {BOUNDS}")
    return lib


def _check(name, x: torch.Tensor, shape, dtype, device):
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


class _Tables:
    """Packed scene tables, copied once to each device that asks for them."""

    def __init__(self, ks: KernelScene, vis_body: int):
        self._bytes = pack_tables(ks, vis_body)
        self._dev: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._dev.get(device)
        if t is None:
            t = torch.frombuffer(bytearray(self._bytes), dtype=torch.uint8).to(device)
            self._dev[device] = t
        return t


def _require_cuda(device: torch.device):
    if device.type != "cuda":
        raise RuntimeError(f"the fused kernels run on CUDA tensors (or their plain "
                           f"version on CPU tensors), not on {device}")


def _lam_rows(ks: KernelScene, fc_idx, lam: Optional[torch.Tensor], lead, device):
    """The λ rows of `contact_lam` (…, n_con, 4) at the swept candidates,
    zeros where the state carries no matching cache. → (…, n_fc, 4)."""
    if lam is not None and lam.shape[-2] == ks.n_con and lam.shape[-1] == 4:
        return lam[..., torch.as_tensor(fc_idx, device=lam.device), :].to(torch.float32)
    return torch.zeros(lead + (ks.n_fc, 4), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# the kernels' plain PyTorch versions (the device code's twin in
# ops/fused_physics.py, driven the way each kernel drives it)
# ---------------------------------------------------------------------------

def rollout_plain(ks: KernelScene, rows, V, mass, fric, H: int, substeps: int,
                  dt_sub: float, vis_body: int, sweeps: int):
    """Plain version of the rollout kernel (K1).

    rows (NS + 4·n_fc, K) state and λ rows (λ carried across the whole
    H × substeps trajectory); V (H,nu,K) controls (already rounded through
    bf16); mass (B,K), fric (G,K). → costs (K,H), vis (H,K,3) rounded through
    bf16 (-1 vis_body: zeros)."""
    st = rows_to_state(ks, rows)
    mass_k, fric_k = mass.T, fric.T
    costs, vis = [], []
    for t in range(H):
        tgt = command_targets(ks, V[t].T, st["q"])
        for _ in range(substeps):
            st = substep(ks, st, tgt, mass_k, fric_k, dt_sub, sweeps)
        pos, quat, _, _, _ = fk(ks, st)
        costs.append(task_cost(ks, st, pos, quat))
        if vis_body >= 0:
            vis.append(pos[vis_body].to(torch.bfloat16).to(pos[vis_body].dtype))
        else:
            vis.append(torch.zeros_like(pos[0]))
    return torch.stack(costs, 1), torch.stack(vis, 0)


def world_step_plain(ks: KernelScene, rows, tgt, mass, fric, substeps: int, dt_sub: float,
                     sweeps: int):
    """Plain version of the world-step kernel (K2): rows (NS + 4·n_fc,) state
    and λ rows of one env, tgt (D,), mass (B,), fric (G,) → rows one control
    dt later."""
    st = rows_to_state(ks, rows[:, None])
    for _ in range(substeps):
        st = substep(ks, st, tgt[None], mass[None], fric[None], dt_sub, sweeps)
    return state_dict_to_rows(st)[:, 0]


class FusedRollout:
    """K1: the whole K-sample, H-step MPPI rollout in one kernel launch.

    Per step: dof targets = W @ u with the gripper binarize, `substeps`
    physics substeps at world fidelity (λ carried across the trajectory,
    seeded from the world's contact_lam), then FK and the task cost on the
    post-step state, plus the position of one body for visualization."""

    launches = 0

    def __init__(self, built, engine, cost: CostSpec, H: int, K: int,
                 vis_body: Optional[int] = None, substeps: Optional[int] = None,
                 impulse_sweeps: int = 2, world_fidelity: bool = True, manifold: str = "full"):
        if cost is None or cost.task not in (TASK_PANDA_REACH, TASK_PANDA_PICK):
            raise NotImplementedError(f"no CUDA cost for task spec {cost}")
        if not world_fidelity:
            raise NotImplementedError(
                "fast-fidelity rollouts (rollout_fidelity: fast, no λ carry or snap, and "
                "its reduced manifold) are not ported")
        # `manifold` changes nothing at world fidelity (the rollout shares the
        # world's λ rows, indexed by the world tables), as in the JAX package
        self.ks = KernelScene.build(built, engine, cost)
        self.fc_idx = free_cand_indices(built.scene, engine.tables)
        self.H, self.K = int(H), int(K)
        self.nu = self.ks.nu
        self.vis_body = -1 if vis_body is None else int(vis_body)
        self.substeps = engine.substeps if substeps is None else int(substeps)
        self.dt_sub = engine.scene.dt / self.substeps
        self.impulse_sweeps = int(impulse_sweeps)
        self._tables = _Tables(self.ks, self.vis_body)

    def pack(self, sim_state_K: SimState, params_K: ModelParams, V_khn: torch.Tensor):
        """→ the kernel inputs: rows (NS + 4·n_fc, K) f32, V (H,nu,K) bf16 (the
        rounding the TPU kernel applies to its controls), mass (B,K), fric
        (G,K)."""
        lam = _lam_rows(self.ks, self.fc_idx, sim_state_K.contact_lam, (self.K,),
                        sim_state_K.q.device)
        rows = state_to_rows(self.ks, sim_state_K.root_state, sim_state_K.q, sim_state_K.qd, lam)
        V = V_khn.to(torch.bfloat16).permute(1, 2, 0).contiguous()
        mass = params_K.body_mass_scale.to(torch.float32).T.contiguous()
        fric = params_K.geom_friction.to(torch.float32).T.contiguous()
        return rows, V, mass, fric

    def rollout(self, sim_state_K: SimState, params_K: ModelParams, V_khn: torch.Tensor):
        """sim_state_K: SimState with leading K; params_K: ModelParams (K,·);
        V_khn: (K, H, nu). → (costs (K,H), vis (H,K,3))."""
        return self.run(*self.pack(sim_state_K, params_K, V_khn))

    def _check_inputs(self, rows, V, mass, fric):
        ks, K, dev = self.ks, self.K, rows.device
        _check("rows", rows, (ks.n_rows, K), torch.float32, dev)
        _check("V", V, (self.H, self.nu, K), torch.bfloat16, dev)
        _check("mass", mass, (ks.nbody, K), torch.float32, dev)
        _check("fric", fric, (ks.ngeom, K), torch.float32, dev)

    def plain(self, rows, V, mass, fric):
        """The kernel's plain PyTorch version, on any device."""
        self._check_inputs(rows, V, mass, fric)
        return rollout_plain(self.ks, rows, V.to(torch.float32), mass, fric, self.H,
                             self.substeps, self.dt_sub, self.vis_body, self.impulse_sweeps)

    def run(self, rows, V, mass, fric):
        """Packed inputs → (costs (K,H), vis (H,K,3)): the CUDA kernel on CUDA
        tensors, its plain version on CPU tensors."""
        if rows.device.type == "cpu":
            return self.plain(rows, V, mass, fric)
        _require_cuda(rows.device)
        self._check_inputs(rows, V, mass, fric)
        lib = _library()
        costs = torch.empty(self.K, self.H, dtype=torch.float32, device=rows.device)
        vis = torch.empty(self.H, self.K, 3, dtype=torch.float32, device=rows.device)
        with torch.cuda.device(rows.device):
            rc = lib.fused_rollout_launch(
                self._tables.on(rows.device).data_ptr(), rows.data_ptr(), V.data_ptr(),
                mass.data_ptr(), fric.data_ptr(), costs.data_ptr(), vis.data_ptr(),
                self.K, self.H, self.substeps, self.dt_sub, self.impulse_sweeps,
                torch.cuda.current_stream(rows.device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"fused_rollout_kernel launch failed: cudaError {rc}")
        type(self).launches += 1
        return costs, vis


class FusedWorldStep:
    """K2: one env advanced one control dt (every substep, `impulse_sweeps`
    sweeps each) in one launch. `step` seeds the λ rows from
    SimState.contact_lam, scatters them back, and refreshes the body caches
    with the engine's torch refresh."""

    launches = 0

    def __init__(self, built, engine, impulse_sweeps: int = 16):
        self.engine = engine
        self.ks = KernelScene.build(built, engine, None)
        self.fc_idx = free_cand_indices(built.scene, engine.tables)
        self.substeps = engine.substeps
        self.dt_sub = engine.dt_sub
        self.impulse_sweeps = int(impulse_sweeps)
        self._tables = _Tables(self.ks, -1)

    def _check_inputs(self, rows, tgt, mass, fric):
        ks, dev = self.ks, rows.device
        _check("rows", rows, (ks.n_rows,), torch.float32, dev)
        _check("tgt", tgt, (ks.ndof,), torch.float32, dev)
        _check("mass", mass, (ks.nbody,), torch.float32, dev)
        _check("fric", fric, (ks.ngeom,), torch.float32, dev)

    def plain(self, rows, tgt, mass, fric):
        self._check_inputs(rows, tgt, mass, fric)
        return world_step_plain(self.ks, rows, tgt, mass, fric, self.substeps, self.dt_sub,
                                self.impulse_sweeps)

    def step_rows(self, rows, tgt, mass, fric):
        """rows (NS + 4·n_fc,), tgt (D,), mass (B,), fric (G,) → rows one dt
        later."""
        if rows.device.type == "cpu":
            return self.plain(rows, tgt, mass, fric)
        _require_cuda(rows.device)
        self._check_inputs(rows, tgt, mass, fric)
        lib = _library()
        out = torch.empty_like(rows)
        with torch.cuda.device(rows.device):
            rc = lib.fused_world_step_launch(
                self._tables.on(rows.device).data_ptr(), rows.data_ptr(), tgt.data_ptr(),
                mass.data_ptr(), fric.data_ptr(), out.data_ptr(), self.substeps, self.dt_sub,
                self.impulse_sweeps, torch.cuda.current_stream(rows.device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"fused_world_step_kernel launch failed: cudaError {rc}")
        type(self).launches += 1
        return out

    def pack(self, state: SimState) -> torch.Tensor:
        lam = _lam_rows(self.ks, self.fc_idx, state.contact_lam, (), state.q.device)
        return state_to_rows(self.ks, state.root_state[None], state.q[None], state.qd[None],
                             lam[None])[:, 0]

    def step(self, state: SimState, params: ModelParams) -> SimState:
        """SimState of one env (no leading axis) → SimState one control dt
        later, body caches refreshed, λ rows scattered into contact_lam."""
        A, D, B = self.ks.nactor, self.ks.ndof, self.ks.nbody
        NS = self.ks.n_state_rows
        out = self.step_rows(
            self.pack(state).contiguous(), state.dof_target.to(torch.float32).contiguous(),
            params.body_mass_scale.to(torch.float32).contiguous(),
            params.geom_friction.to(torch.float32).contiguous(),
        )
        st = state.with_root_state(out[: 13 * A].reshape(A, 13))
        st = st.replace(
            q=out[13 * A: 13 * A + D],
            qd=out[13 * A + D: 13 * A + 2 * D],
            net_contact_force=out[13 * A + 2 * D: NS].reshape(B, 3),
        )
        lam = state.contact_lam
        if self.ks.n_fc and lam is not None and tuple(lam.shape) == (self.ks.n_con, 4):
            lam = lam.clone()
            lam[torch.as_tensor(self.fc_idx, device=lam.device)] = out[NS:].reshape(-1, 4)
            st = st.replace(contact_lam=lam)
        return self.engine.refresh(st)
