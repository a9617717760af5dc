# Frozen copy of mppiisaac_tpu_torch/physics/stacked.py, part of the benchmark's yardstick.
"""Whole-scene articulation tables (host), the body-cache refresh and the
engine substep (torch).

`build_stacked` is the JAX package's `physics/stacked.py` builder carried
over unchanged (numpy). `refresh_stacked` recomputes the derived body caches
of a SimState — poses by forward kinematics and body velocities from the
generalized velocities — with the same algorithm as the JAX refresh
(pointer-doubling FK, world-frame motion subspaces, one ancestry-masked
contraction), batched over any leading axes. `stacked_substep` is the JAX
package's semi-implicit substep of the whole scene (composite inertias,
bias forces, drives, the padded per-actor velocity solve, the implicit
couple-contact terms and the impulse pass), batched over a leading env
axis: every per-env index the JAX code takes from a static numpy array is a
gather on a device tensor cached by `StackedModel.on`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..utils.device_cache import DeviceCache
from .math3d import (cholesky_factor, cholesky_solve_factored, cross, quat_from_axis_angle,
                     quat_integrate, quat_mul, quat_normalize, quat_rotate, quat_to_matrix)
from .model import (DRIVE_EFFORT, DRIVE_POSITION, DRIVE_VELOCITY, JOINT_PRISMATIC,
                    JOINT_REVOLUTE)
from .scene_model import SceneModel
from .types import ModelParams, SimState

_F32 = np.float32

# couple-contact damper cap margin (see stacked_substep implicit couple
# terms): kd_eff ≤ DAMP_CAP_BETA · m_free / (dt · n_pts)
DAMP_CAP_BETA = 4.0
# effort-finger spindle stiction coefficient: implicit resistance μ_s·|u|
# against back-driving, as a fraction of the commanded axial load (see
# drive_terms_stacked). 0.3 ⇒ a −6 N squeeze resists ~1.8 N of lateral walk.
MU_SPINDLE = 0.3


@dataclass
class StackedModel:
    scene: SceneModel
    # global body arrays (B,)
    B: int
    NV: int                     # total generalized velocity coords
    D: int                      # actuated joint dofs (== scene.ndof)
    parent: np.ndarray          # (B,) -1 for actor roots
    body_actor: np.ndarray      # (B,)
    jtype: np.ndarray           # (B,)
    jpos: np.ndarray            # (B,3)
    jquat: np.ndarray           # (B,4)
    jaxis: np.ndarray           # (B,3)
    body_jdof: np.ndarray       # (B,) actuated dof id in [0,D) or -1
    mass: np.ndarray            # (B,)
    com: np.ndarray             # (B,3)
    inertia: np.ndarray         # (B,3,3)
    grav_mask: np.ndarray       # (B,) 1.0 unless actor disables gravity or is static
    depth_passes: int
    parent_chain: List[np.ndarray]  # static pointer-doubling index chains
    # generalized-coordinate maps
    dofc_body: np.ndarray       # (NV,) body owning each velocity coordinate
    dofc_is_joint: np.ndarray   # (NV,) bool
    dofc_jdof: np.ndarray       # (NV,) actuated dof id or -1
    jd_coord: np.ndarray        # (D,) coordinate index of each actuated dof
    base_S: np.ndarray          # (NV,6) constant rows for base coords (identity), 0 for joint rows
    # masks
    anc_dof: np.ndarray         # (B,NV) float: coord j ancestor-or-self of body b
    subtree: np.ndarray         # (NV,B) float: body in subtree of coord j's joint
    # dynamic-actor padded solve tables
    A_dyn: int
    nv_max: int
    act_coords: np.ndarray      # (A_dyn, nv_max) indices into NV, padded with NV
    act_pad: np.ndarray         # (A_dyn, nv_max) 1.0 where real coord
    act_anc: np.ndarray         # (A_dyn, nv_max, nv_max) ancestry mask for CRBA
    act_actor: np.ndarray       # (A_dyn,) actor index
    act_floating: np.ndarray    # (A_dyn,) bool
    # actuated-dof parameter arrays (D,)
    dof_lower: np.ndarray
    dof_upper: np.ndarray
    dof_effort: np.ndarray
    dof_maxvel: np.ndarray
    dof_damping: np.ndarray
    dof_friction: np.ndarray
    dof_armature: np.ndarray
    drive_mode: np.ndarray
    drive_kp: np.ndarray
    drive_kd: np.ndarray
    # static pick/scatter matrices (one-hot constants)
    base_pick: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), _F32))
    joint_pick: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), _F32))
    uscatter: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), _F32))
    body_jdof_clipped: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    dof_gate_body: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    # effort-mode FINGER dofs (D,): 1.0 where the raw-effort command drives a
    # gripper finger. These get the implicit motor curve τ = u − (|u|/v_max)qd⁺
    # instead of a bare constant force (see drive_terms_stacked).
    finger_motor: np.ndarray = field(default_factory=lambda: np.zeros(0, _F32))

    def __post_init__(self):
        # the tables below on each device, copied at their first use (a
        # refresh inside a captured CUDA graph copies nothing from the host)
        self._dev = DeviceCache()

    def on(self, name: str, make, dtype, device) -> torch.Tensor:
        """The table `make()` as a tensor of `dtype` on `device`."""
        return self._dev.get(name, make, dtype, device)


def build_stacked(scene: SceneModel) -> StackedModel:
    B = scene.nbody
    D = scene.ndof
    parent = np.full(B, -1, np.int32)
    jtype = np.zeros(B, np.int32)
    jpos = np.zeros((B, 3))
    jquat = np.tile([0.0, 0, 0, 1.0], (B, 1))
    jaxis = np.tile([1.0, 0, 0], (B, 1))
    body_jdof = np.full(B, -1, np.int32)
    mass = np.zeros(B)
    com = np.zeros((B, 3))
    inertia = np.zeros((B, 3, 3))
    grav_mask = np.ones(B)

    coords: List[tuple] = []   # (body, kind, jdof)  kind: 0..5 base, 6 joint
    act_rows = []              # per dynamic actor: list of coord ids

    for ai, art in enumerate(scene.actors):
        bo = scene.body_offset[ai]
        do = scene.dof_offset[ai]
        static = art.fixed_base and art.ndof == 0
        for i in range(art.nbody):
            g = bo + i
            parent[g] = bo + art.parent[i] if art.parent[i] >= 0 else -1
            jtype[g] = art.jtype[i]
            jpos[g] = art.jpos[i]
            jquat[g] = art.jquat[i]
            jaxis[g] = art.jaxis[i]
            if art.dof_index[i] >= 0:
                body_jdof[g] = do + art.dof_index[i]
            mass[g] = art.mass[i]
            com[g] = art.com[i]
            inertia[g] = art.inertia[i]
            if art.disable_gravity or static:
                grav_mask[g] = 0.0
        row = []
        if not art.fixed_base:
            for k in range(6):
                row.append(len(coords))
                coords.append((bo, k, -1))
        # joint coords in dof order
        order = np.argsort(art.dof_index[art.dof_index >= 0])
        bodies_with_dof = [i for i in range(art.nbody) if art.dof_index[i] >= 0]
        bodies_sorted = sorted(bodies_with_dof, key=lambda i: art.dof_index[i])
        for i in bodies_sorted:
            row.append(len(coords))
            coords.append((bo + i, 6, do + art.dof_index[i]))
        if row:
            act_rows.append((ai, row, not art.fixed_base))

    NV = len(coords)
    dofc_body = np.array([c[0] for c in coords], np.int32) if NV else np.zeros(0, np.int32)
    dofc_kind = np.array([c[1] for c in coords], np.int32) if NV else np.zeros(0, np.int32)
    dofc_jdof = np.array([c[2] for c in coords], np.int32) if NV else np.zeros(0, np.int32)
    dofc_is_joint = dofc_kind == 6
    jd_coord = np.zeros(D, np.int32)
    for j, c in enumerate(coords):
        if c[2] >= 0:
            jd_coord[c[2]] = j
    base_S = np.zeros((NV, 6))
    for j in range(NV):
        if dofc_kind[j] < 6:
            base_S[j, dofc_kind[j]] = 1.0

    # body ancestry within actors
    anc_body = np.zeros((B, B), bool)
    for b in range(B):
        x = b
        while x >= 0:
            anc_body[b, x] = True   # x is ancestor-or-self of b
            x = parent[x]
    anc_dof = np.zeros((B, NV), _F32)
    subtree = np.zeros((NV, B), _F32)
    for j in range(NV):
        jb = dofc_body[j]
        same_actor = scene.body_actor == scene.body_actor[jb]
        desc = anc_body[:, jb] & same_actor      # bodies having jb as ancestor
        anc_dof[desc, j] = 1.0
        subtree[j, desc] = 1.0

    # depth for pointer doubling
    depth = np.zeros(B, np.int64)
    for b in range(B):
        x, d = b, 0
        while parent[x] >= 0:
            x = parent[x]
            d += 1
        depth[b] = d
    max_depth = int(depth.max()) if B else 0
    passes = max(1, int(np.ceil(np.log2(max_depth + 1)))) if max_depth > 0 else 0
    # precompute the pointer-doubling chains host-side: runtime-computed
    # indices would hit XLA's dynamic-gather slow path (they can't be
    # constant-folded through gathers)
    P0 = np.where(parent < 0, B, parent).astype(np.int32)
    P0 = np.concatenate([P0, np.asarray([B], np.int32)])
    parent_chain = []
    Pk = P0
    for _ in range(passes):
        parent_chain.append(Pk)
        Pk = Pk[Pk]

    # padded per-actor solve tables
    dyn = act_rows
    A_dyn = len(dyn)
    nv_max = max((len(r[1]) for r in dyn), default=1)
    act_coords = np.full((A_dyn, nv_max), NV, np.int32)
    act_pad = np.zeros((A_dyn, nv_max), _F32)
    act_anc = np.zeros((A_dyn, nv_max, nv_max), _F32)
    act_actor = np.zeros(A_dyn, np.int32)
    act_floating = np.zeros(A_dyn, bool)
    for r, (ai, row, floating) in enumerate(dyn):
        n = len(row)
        act_coords[r, :n] = row
        act_pad[r, :n] = 1.0
        act_actor[r] = ai
        act_floating[r] = floating
        for x in range(n):
            for y in range(n):
                jx, jy = row[x], row[y]
                bx, by = dofc_body[jx], dofc_body[jy]
                if anc_body[by, bx]:          # bx ancestor-or-self of by
                    if bx != by:
                        act_anc[r, x, y] = 1.0
                    else:
                        act_anc[r, x, y] = 1.0 if x <= y else 0.0

    # static pick/scatter matrices — all runtime index math becomes matmuls
    # with one-hot constants (dynamic gathers/scatters are a TPU slow path)
    A = scene.nactor
    base_pick = np.zeros((NV, A * 6), _F32)     # u_base = base_pick @ base6.flat
    joint_pick = np.zeros((NV, max(D, 1)), _F32)  # u_joint = joint_pick @ qd
    for j, (jb, kind, jd) in enumerate(coords):
        if kind < 6:
            base_pick[j, scene.body_actor[jb] * 6 + kind] = 1.0
        else:
            joint_pick[j, jd] = 1.0
    uscatter = np.zeros((NV, A_dyn * nv_max), _F32)  # u_new = uscatter @ u_new_a.flat
    for r in range(A_dyn):
        for x in range(nv_max):
            cidx = act_coords[r, x]
            if cidx < NV:
                uscatter[cidx, r * nv_max + x] = 1.0
    # clipped jdof for fk gather (no runtime clip)
    body_jdof_clipped = np.where(body_jdof >= 0, body_jdof, 0).astype(np.int32)

    # gripper force gate: finger dofs (by joint name) stop closing when their
    # link's net contact force exceeds scene.grip_force_gate. VELOCITY-drive
    # fingers only: the `target < 0` closing test is velocity semantics —
    # position targets are never negative, and gating effort-mode fingers
    # would zero the sustained squeeze an effort grasp depends on (the
    # reference applies no such gate in effort mode).
    from .model import DRIVE_VELOCITY as _DRV

    dof_gate_body = np.full(D, -1, np.int32)
    # effort-mode fingers: implicit motor-curve drive (see drive_terms_stacked).
    # A raw constant force on a 15 g finger slams it at the ±v_max clamp and
    # bang-bangs on contact — the closing pads then juggle/eject a caged block
    # (the omni_panda_pick 0/5 root cause, r5): two constant-force fingers give
    # the finger+block system an UNDAMPED free-translation mode along the
    # closing axis, and every re-contact injects energy. A real gripper motor
    # (and PhysX's drive+maxJointVelocity solve) delivers u at stall and
    # nothing at the velocity limit — implicitly: τ(qd⁺) = u − (|u|/v_max)·qd⁺,
    # which is ~30 N·s/m of drive-side damping for the Franka finger. Joint-
    # space damping is transport-safe (unlike contact-side damping, which
    # phantom-forces a swept grasp — the r4 slip bug).
    from .model import DRIVE_EFFORT as _DRE

    finger_motor = np.zeros(D, _F32)
    for ai, art in enumerate(scene.actors):
        for k, jn in enumerate(art.dof_names):
            if "finger" in jn and int(art.drive_mode[k]) == _DRE:
                finger_motor[scene.dof_offset[ai] + k] = 1.0
            if "finger" in jn and int(art.drive_mode[k]) == _DRV:
                for i in range(art.nbody):
                    if art.dof_index[i] == k:
                        dof_gate_body[scene.dof_offset[ai] + k] = scene.body_offset[ai] + i

    # actuated dof params stacked across actors
    def cat(field):
        vals = [getattr(a, field) for a in scene.actors]
        return np.concatenate(vals) if vals else np.zeros(0)

    return StackedModel(
        scene=scene,
        B=B, NV=NV, D=D,
        parent=parent,
        body_actor=np.asarray(scene.body_actor, np.int32),
        jtype=jtype, jpos=jpos, jquat=jquat, jaxis=jaxis,
        body_jdof=body_jdof,
        mass=mass, com=com, inertia=inertia, grav_mask=grav_mask,
        depth_passes=passes,
        parent_chain=parent_chain,
        dofc_body=dofc_body, dofc_is_joint=dofc_is_joint, dofc_jdof=dofc_jdof,
        jd_coord=jd_coord, base_S=base_S,
        anc_dof=anc_dof, subtree=subtree,
        A_dyn=A_dyn, nv_max=nv_max,
        act_coords=act_coords, act_pad=act_pad, act_anc=act_anc,
        act_actor=act_actor, act_floating=act_floating,
        dof_lower=cat("dof_lower"), dof_upper=cat("dof_upper"),
        dof_effort=cat("dof_effort"), dof_maxvel=cat("dof_maxvel"),
        dof_damping=cat("dof_damping"), dof_friction=cat("dof_friction"),
        dof_armature=cat("dof_armature"),
        drive_mode=cat("drive_mode").astype(np.int32),
        drive_kp=cat("drive_kp"), drive_kd=cat("drive_kd"),
        base_pick=base_pick, joint_pick=joint_pick, uscatter=uscatter,
        body_jdof_clipped=body_jdof_clipped,
        dof_gate_body=dof_gate_body,
        finger_motor=finger_motor,
    )


# ---------------------------------------------------------------------------
# body-cache refresh (torch, batched over leading axes)
# ---------------------------------------------------------------------------

def fk_stacked(m: StackedModel, root_pos, root_quat, q):
    """→ (body_pos (...,B,3), body_quat (...,B,4), axis_w (...,B,3))."""
    dev, dt_ = root_pos.device, root_pos.dtype
    B = m.B
    lead = root_pos.shape[:-2]
    jq = m.on("jquat", lambda: m.jquat, dt_, dev)
    jp = m.on("jpos", lambda: m.jpos, dt_, dev)
    ax = m.on("jaxis", lambda: m.jaxis, dt_, dev)
    if m.D:
        has = m.on("has_dof", lambda: m.body_jdof >= 0, torch.bool, dev)
        qb = torch.where(has, q[..., m.on("jdof", lambda: m.body_jdof_clipped, torch.long, dev)],
                         0.0)
    else:
        qb = torch.zeros(lead + (B,), dtype=dt_, device=dev)
    is_rev = m.on("is_rev", lambda: m.jtype == JOINT_REVOLUTE, torch.bool, dev)
    is_prism = m.on("is_prism", lambda: m.jtype == JOINT_PRISMATIC, torch.bool, dev)
    rotq = quat_from_axis_angle(ax, torch.where(is_rev, qb, 0.0))
    L_quat = quat_mul(jq, rotq)
    L_pos = jp + torch.where(is_prism[:, None], quat_rotate(jq, ax * qb[..., None]), 0.0)
    is_root = m.on("is_root", lambda: m.parent < 0, torch.bool, dev)
    ba = m.on("body_actor", lambda: m.body_actor, torch.long, dev)
    L_pos = torch.where(is_root[:, None], root_pos[..., ba, :], L_pos)
    L_quat = torch.where(is_root[:, None], root_quat[..., ba, :], L_quat)
    # pointer doubling with a virtual identity node at index B
    T_pos = torch.cat([L_pos, torch.zeros(lead + (1, 3), dtype=dt_, device=dev)], -2)
    ident = m.on("ident", lambda: [0.0, 0.0, 0.0, 1.0], dt_, dev).expand(lead + (1, 4))
    T_quat = torch.cat([L_quat, ident], -2)
    for k, Pk in enumerate(m.parent_chain):
        idx = m.on(f"chain{k}", lambda: Pk, torch.long, dev)
        pp = T_pos[..., idx, :]
        pq = T_quat[..., idx, :]
        T_pos = pp + quat_rotate(pq, T_pos)
        T_quat = quat_mul(pq, T_quat)
    body_pos = T_pos[..., :B, :]
    body_quat = quat_normalize(T_quat[..., :B, :])
    axis_w = quat_rotate(body_quat, ax)
    return body_pos, body_quat, axis_w


def motion_subspace_stacked(m: StackedModel, body_pos, axis_w):
    """(...,NV,6) world-frame Plücker motion subspaces."""
    dev = body_pos.device
    cb = m.on("dofc_body", lambda: m.dofc_body, torch.long, dev)
    a = axis_w[..., cb, :]
    p = body_pos[..., cb, :]
    is_rev = m.on("dofc_rev", lambda: (m.jtype[m.dofc_body] == JOINT_REVOLUTE) & m.dofc_is_joint,
                  torch.bool, dev)
    is_prism = m.on("dofc_prism",
                    lambda: (m.jtype[m.dofc_body] == JOINT_PRISMATIC) & m.dofc_is_joint,
                    torch.bool, dev)
    S_rev = torch.cat([a, cross(p, a)], -1)
    S_prism = torch.cat([torch.zeros_like(a), a], -1)
    S = m.on("base_S", lambda: m.base_S, body_pos.dtype, dev).expand(S_rev.shape)
    S = torch.where(is_rev[:, None], S_rev, S)
    return torch.where(is_prism[:, None], S_prism, S)


def generalized_velocities(m: StackedModel, state: SimState):
    """u (...,NV) from root velocities (as Plücker) + qd."""
    dev, dt_ = state.root_pos.device, state.root_pos.dtype
    w = state.root_angvel
    v_o = state.root_linvel - cross(w, state.root_pos)
    base6 = torch.cat([w, v_o], -1)
    base6 = base6.reshape(base6.shape[:-2] + (-1,))
    u = base6 @ m.on("base_pick", lambda: m.base_pick, dt_, dev).T
    if m.D:
        u = u + state.qd @ m.on("joint_pick", lambda: m.joint_pick, dt_, dev).T
    return u


# ---------------------------------------------------------------------------
# the engine substep (torch, batched over a leading env axis)
# ---------------------------------------------------------------------------

def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _crm(v, w):
    a, b = v[..., :3], v[..., 3:]
    c, d = w[..., :3], w[..., 3:]
    return torch.cat([cross(a, c), cross(a, d) + cross(b, c)], -1)


def _crf(v, f):
    a, b = v[..., :3], v[..., 3:]
    n, ff = f[..., :3], f[..., 3:]
    return torch.cat([cross(a, n) + cross(b, ff), cross(a, ff)], -1)


def spatial_inertias(m: StackedModel, body_pos, body_quat, mass_scale):
    """(..., B, 6, 6) world-frame spatial inertias about the origin."""
    dev, dt_ = body_pos.device, body_pos.dtype
    mass = m.on("mass", lambda: m.mass, dt_, dev) * mass_scale
    R = quat_to_matrix(body_quat)
    I_com = m.on("inertia", lambda: m.inertia, dt_, dev) * mass_scale[..., None, None]
    c = body_pos + torch.einsum("...bij,bj->...bi", R, m.on("com", lambda: m.com, dt_, dev))
    Iw_rot = torch.einsum("...bij,...bjk,...blk->...bil", R, I_com, R)
    C = _skew(c)
    mC = mass[..., None, None] * C
    top = torch.cat([Iw_rot + mC @ C.transpose(-1, -2), mC], -1)
    bot = torch.cat([mC.transpose(-1, -2),
                     mass[..., None, None] * m.on("eye3", lambda: np.eye(3), dt_, dev)], -1)
    return torch.cat([top, bot], -2)


def drive_terms_stacked(m: StackedModel, q, qd, dof_target, dt):
    """Drive torques and their implicit damping per actuated dof (..., D)."""
    dev, dt_ = q.device, q.dtype

    def on(name, make):
        return m.on(name, make, dt_, dev)

    mode = m.on("drive_mode", lambda: m.drive_mode, torch.long, dev)
    kp = on("drive_kp", lambda: m.drive_kp)
    kd = on("drive_kd", lambda: m.drive_kd)
    effort = on("dof_effort", lambda: m.dof_effort)
    # force-limited implicit velocity drive: kd_eff = min(kd, F/|Δv|) keeps
    # the implicit torque within the effort limit
    kd_eff = torch.minimum(kd, effort / torch.clamp(torch.abs(dof_target - qd), min=1e-6))
    vel_tau = kd_eff * dof_target
    vel_d = kd_eff
    kp_eff = torch.minimum(kp, effort / torch.clamp(torch.abs(dof_target - q), min=1e-6))
    pos_tau = kp_eff * (dof_target - q)
    pos_d = kp_eff * dt + kd
    eff_tau = torch.clamp(dof_target, -effort, effort)
    # effort-mode finger dofs: motor-curve damping |u|/v_max plus
    # load-proportional spindle stiction μ_s·|u|, both implicit
    eff_d = kd + on("finger_motor", lambda: m.finger_motor) * torch.abs(eff_tau) * (
        1.0 / torch.clamp(on("dof_maxvel", lambda: m.dof_maxvel), min=1e-6)
        + MU_SPINDLE / (torch.abs(qd) + 0.02)
    )
    tau = torch.where(mode == DRIVE_VELOCITY, vel_tau,
                      torch.where(mode == DRIVE_POSITION, pos_tau,
                                  torch.where(mode == DRIVE_EFFORT, eff_tau, 0.0)))
    d_imp = torch.where(mode == DRIVE_VELOCITY, vel_d,
                        torch.where(mode == DRIVE_POSITION, pos_d,
                                    torch.where(mode == DRIVE_EFFORT, eff_d, 0.0)))
    d_imp = d_imp + on("dof_damping", lambda: m.dof_damping)
    # Coulomb joint friction, implicit: damping f/(|qd| + v_eps)
    d_imp = d_imp + on("dof_friction", lambda: m.dof_friction) / (torch.abs(qd) + 0.02)
    # joint limits
    below = torch.clamp(on("dof_lower", lambda: m.dof_lower) - q, min=0.0)
    above = torch.clamp(q - on("dof_upper", lambda: m.dof_upper), min=0.0)
    viol = (below > 0) | (above > 0)
    tau = tau + 1.0e3 * (below - above) - torch.where(viol, 1.0e2 * qd, 0.0)
    return tau, d_imp


def _set_rows(x, idx, value):
    """x with rows idx (a long tensor) of its second-to-last axis replaced."""
    return x.index_copy(x.dim() - 2, idx, value)


def _couple_groups(m: StackedModel, tables):
    """Per articulated contact body b: its couple candidates C (a side, then
    b side), their signs e, the other (free) bodies and b's actor row r.
    Static, cached on the model."""
    cached = m.__dict__.get("_cpl")
    if cached is not None and cached[0] is tables:
        return cached[1]
    scene = m.scene
    ba_all = scene.geom_body[tables.con_geom_a]
    fbidx = np.where(tables.con_geom_b >= 0, tables.con_geom_b, tables.con_geom_a)
    bb_all = scene.geom_body[fbidx]
    groups = []
    for b in tables.art_bodies:
        Ca = np.where((tables.a_art > 0) & (ba_all == b))[0]
        Cb = np.where((tables.b_art > 0) & (bb_all == b))[0]
        C = np.concatenate([Ca, Cb]).astype(np.int64)
        if not len(C):
            continue
        e = np.concatenate([np.ones(len(Ca)), -np.ones(len(Cb))]).astype(np.float32)
        other = np.concatenate([bb_all[Ca], ba_all[Cb]]).astype(np.int64)
        groups.append((int(b), _actor_row(m, b), C, e, other))
    m.__dict__["_cpl"] = (tables, groups)
    return groups


def _actor_row(m: StackedModel, b: int) -> int:
    return int(np.where(m.act_actor == int(m.body_actor[b]))[0][0])


def _phi_table(m: StackedModel, bodies):
    """For bodies b: their actor rows r, the coordinates of those rows and
    the ancestry mask Φ_b keeps of them (coord ancestor-or-self of b)."""
    rows = np.asarray([_actor_row(m, b) for b in bodies], np.int64)
    coords = m.act_coords[rows]                                    # (nb, nv)
    anc = np.stack([np.concatenate([m.anc_dof[b], [0.0]])[m.act_coords[r]]
                    for b, r in zip(bodies, rows)])                # (nb, nv)
    onehot = np.zeros((m.A_dyn, len(bodies)), np.float32)
    onehot[rows, np.arange(len(bodies))] = 1.0
    return rows, coords, anc, onehot


def stacked_substep(
    m: StackedModel,
    state: SimState,
    params: ModelParams,
    dt: float,
    contact_fn,
    tables=None,
    use_impulse: bool = True,
):
    """One semi-implicit substep of the whole scene for a batch of envs
    (every state field with a leading env axis, params likewise).
    contact_fn(body_pos, body_quat, body_linvel, body_angvel, geom_friction)
    → (f_ext (...,B,6), net_cf (...,B,3), contact geometry or None)."""
    from .contact import _free_body_mask, impulse_contact_pass

    dev, dt_ = state.root_pos.device, state.root_pos.dtype
    lead = state.root_pos.shape[:-2]
    scene = m.scene

    def on(name, make, dtype=dt_):
        return m.on(name, make, dtype, dev)

    def idx(name, make):
        return m.on(name, lambda: np.asarray(make(), np.int64), torch.long, dev)

    body_pos, body_quat, axis_w = fk_stacked(m, state.root_pos, state.root_quat, state.q)
    S = motion_subspace_stacked(m, body_pos, axis_w)
    u = generalized_velocities(m, state)

    anc = on("anc_dof", lambda: m.anc_dof)
    Su = S * u[..., None]
    v_b = anc @ Su                                                 # (...,B,6) Plücker
    w_b = v_b[..., :3]
    lin_b = v_b[..., 3:] + cross(w_b, body_pos)

    f_ext, net_cf, cgeom = contact_fn(body_pos, body_quat, lin_b, w_b, params.geom_friction)

    Iw = spatial_inertias(m, body_pos, body_quat, params.body_mass_scale)

    # bias: a = grav_freefall + anc @ crm(v_body(j), S_j u_j)
    a0 = on("a0", lambda: np.concatenate([np.zeros(3), -np.asarray(scene.gravity)]))
    vj = v_b[..., idx("dofc_body", lambda: m.dofc_body), :]
    a_b = on("grav_mask", lambda: m.grav_mask)[:, None] * a0 + anc @ _crm(vj, Su)
    Iv = torch.einsum("...bij,...bj->...bi", Iw, v_b)
    f_net = torch.einsum("...bij,...bj->...bi", Iw, a_b) + _crf(v_b, Iv) - f_ext
    sub = on("subtree", lambda: m.subtree)
    C = torch.sum(S * (sub @ f_net), -1)                          # (...,NV)

    # composite inertias at dof bodies → F = Ic S
    Ic = (sub @ Iw.reshape(lead + (m.B, 36))).reshape(lead + (m.NV, 6, 6))
    F = torch.einsum("...vij,...vj->...vi", Ic, S)

    # drives on actuated dofs, scattered to coords. Gripper force gate: a
    # finger dof closing (target < 0) against contact stops (target → 0)
    dof_target = state.dof_target
    if m.D and (m.dof_gate_body >= 0).any():
        gdofs = idx("gate_dofs", lambda: np.where(m.dof_gate_body >= 0)[0])
        gbodies = idx("gate_bodies", lambda: m.dof_gate_body[m.dof_gate_body >= 0])
        fmag = torch.linalg.norm(state.net_contact_force[..., gbodies, :], dim=-1)
        tg = dof_target[..., gdofs]
        gated = (fmag > scene.grip_force_gate) & (tg < 0.0)
        dof_target = dof_target.index_copy(dof_target.dim() - 1, gdofs,
                                           torch.where(gated, 0.0, tg))
    tau_j, d_imp_j = drive_terms_stacked(m, state.q, state.qd, dof_target, dt)
    if m.D:
        jpick_T = on("joint_pick_T", lambda: m.joint_pick.T)
        tau = tau_j @ jpick_T
        d_imp = (d_imp_j + on("dof_armature", lambda: m.dof_armature)) @ jpick_T
    else:
        tau = torch.zeros(lead + (m.NV,), dtype=dt_, device=dev)
        d_imp = torch.zeros(lead + (m.NV,), dtype=dt_, device=dev)

    # per-actor padded blocks (row NV is the zero padding row)
    z6 = torch.zeros(lead + (1, 6), dtype=dt_, device=dev)
    z1 = torch.zeros(lead + (1,), dtype=dt_, device=dev)
    Sz = torch.cat([S, z6], -2)
    Fz = torch.cat([F, z6], -2)
    uz, tz, Cz, dz = (torch.cat([x, z1], -1) for x in (u, tau, C, d_imp))
    ac = idx("act_coords", lambda: m.act_coords)
    Sa = Sz[..., ac, :]                                           # (...,A,nv,6)
    Fa = Fz[..., ac, :]
    Mfull = Sa @ Fa.transpose(-1, -2)                             # S_x · F_y
    eye = on("eye_nv", lambda: np.eye(m.nv_max))
    Mm = Mfull * on("act_anc", lambda: m.act_anc)                 # ancestor(-or-self) half
    M0 = Mm + Mm.transpose(-1, -2) - Mm * eye                     # symmetric mass matrix
    pad = on("act_pad", lambda: m.act_pad)
    ua = uz[..., ac] * pad
    rhs = (M0 @ ua[..., None])[..., 0] + dt * (tz[..., ac] - Cz[..., ac]) * pad
    # implicit drive damping + padding identity on the solve matrix only
    M = M0 + eye * (dt * dz[..., ac] + (1.0 - pad) + 1e-8)[..., None, :]

    # ---- implicit couple-contact terms (articulated↔free, grasping): the
    # contact enters the velocity solve implicitly (Baraff):
    #   M += dt(kd+κ)·JᵀJ,  rhs += dt·Jᵀ(e·kn·d + (kd+κ)·v_other·n),  κ = dt·kn
    cpl = []
    if tables is not None and cgeom is not None and len(tables.art_bodies):
        tau_c = max(2.0 * dt, 1e-3)
        depth_all = torch.clamp(cgeom["depth"], max=float(np.float32(scene.max_contact_depth)))
        Ms, rhss = list(M.unbind(-3)), list(rhs.unbind(-2))
        for b, r, Cn, e, other in _couple_groups(m, tables):
            g = f"cpl{b}_"
            Ct = idx(g + "C", lambda: Cn)
            ot = idx(g + "other", lambda: other)
            anc_pad = on(g + "anc", lambda: np.concatenate([m.anc_dof[b], [0.0]])[m.act_coords[r]])
            Phi = Sz[..., idx(g + "coords", lambda: m.act_coords[r]), :] * anc_pad[:, None]
            p_c = cgeom["point"][..., Ct, :]
            n_c = cgeom["normal"][..., Ct, :]
            d_c = depth_all[..., Ct]
            act_c = (cgeom["depth"][..., Ct] > 0.0).to(dt_)
            X = torch.cat([cross(p_c, n_c), n_c], -1)                 # (...,nc,6)
            J = X @ Phi.transpose(-1, -2)                             # (...,nc,nv)
            kn_c = on(g + "kn", lambda: tables.kn_base[Cn] / (tau_c * tau_c))
            kd_c = on(g + "kd", lambda: 2.0 * tables.kn_base[Cn] / tau_c)
            # damper cap at the free side's momentum-transfer scale:
            # kd_eff ≤ β·m_oth/(dt·n_pts); the implicit spring κ stays uncapped
            m_oth_s = on(g + "m_oth", lambda: m.mass[other]) * params.body_mass_scale[..., ot]
            kd_cap = DAMP_CAP_BETA * m_oth_s / (dt * on(g + "npts", lambda: tables.n_pts[Cn]))
            kd_c = torch.minimum(kd_c, kd_cap)
            kap = dt * kn_c
            v_oth = lin_b[..., ot, :] + cross(w_b[..., ot, :], p_c - body_pos[..., ot, :])
            v_oth_n = torch.sum(v_oth * n_c, -1)
            e_j = on(g + "e", lambda: e)
            coefM = dt * (kd_c + kap) * act_c
            coefR = dt * (e_j * kn_c * torch.clamp(d_c, min=0.0) + (kd_c + kap) * v_oth_n) * act_c
            Ms[r] = Ms[r] + J.transpose(-1, -2) @ (coefM[..., None] * J)
            rhss[r] = rhss[r] + (coefR[..., None, :] @ J)[..., 0, :]
            cpl.append((b, r, Ct, e_j, J, kn_c, kd_c, kap, d_c, act_c, n_c, v_oth_n))
        M = torch.stack(Ms, -3)
        rhs = torch.stack(rhss, -2)

    Lf = cholesky_factor(M)                            # one factor for every solve below
    u_new_a = cholesky_solve_factored(Lf, rhs) * pad   # (...,A,nv)

    # post-solve implicit contact forces: seed the impulse friction cones and
    # expose the grip force on the arm's net_cf (the gate)
    if cpl:
        fn_seed = cgeom["fn_stiff"]
        for b, r, Ct, e_j, J, kn_c, kd_c, kap, d_c, act_c, n_c, v_oth_n in cpl:
            vn_plus = e_j * ((J @ u_new_a[..., r, :, None])[..., 0] - v_oth_n)
            fn_star = torch.clamp(kn_c * torch.clamp(d_c, min=0.0) - (kd_c + kap) * vn_plus,
                                  min=0.0) * act_c
            fn_seed = fn_seed.index_copy(fn_seed.dim() - 1, Ct, fn_star)
            add = torch.sum((e_j * fn_star)[..., None] * n_c, -2)
            net_cf = net_cf.index_add(net_cf.dim() - 2, idx(f"cpl{b}_b", lambda: [b]),
                                      add[..., None, :])
        cgeom = dict(cgeom)
        cgeom["fn_stiff"] = fn_seed

    # ---- velocity-impulse contact resolution (free bodies + two-way
    # articulated coupling) on the post-solve velocities; articulated links
    # take part through Ψ_b = Φ_b M⁻¹ Φ_bᵀ (the same damped M), and their
    # accumulated impulses fold back as ΔU = M⁻¹ Φᵀ Y
    free_rows = _free_body_mask(scene)
    run_impulse = (
        use_impulse and tables is not None and cgeom is not None
        and bool(free_rows.any() or tables.a_sta.any() or tables.b_sta.any())
    )
    usc_T = on("uscatter_T", lambda: m.uscatter.T)
    lin2 = ang2 = lam_out = None
    if run_impulse:
        u_post = u_new_a.reshape(lead + (-1,)) @ usc_T
        v_post = anc @ (S * u_post[..., None])
        w_post = v_post[..., :3]
        lin_post = v_post[..., 3:] + cross(w_post, body_pos)

        art_bodies = list(tables.art_bodies)
        psi = art_apply = None
        if art_bodies:
            cached = m.__dict__.get("_phi")
            if cached is None or cached[0] is not tables:
                cached = m.__dict__["_phi"] = (tables, _phi_table(m, art_bodies))
            rows, coords, anc_ab, onehot = cached[1]
            ab = idx("art_bodies", lambda: art_bodies)
            Phi = Sz[..., idx("ab_coords", lambda: coords), :] \
                * on("ab_anc", lambda: anc_ab)[..., None]            # (...,nab,nv,6)
            X = cholesky_solve_factored(Lf[..., idx("ab_rows", lambda: rows), :, :], Phi)
            psi = torch.zeros(lead + (m.B, 6, 6), dtype=dt_, device=dev).index_copy(
                len(lead), ab, Phi.transpose(-1, -2) @ X)
            R1 = on("ab_onehot", lambda: onehot)

            def gen_rhs(Y):
                """Φᵀ Y of every articulated body, summed into its actor row."""
                per = (Phi @ Y[..., ab, :, None])[..., 0]             # (...,nab,nv)
                return torch.einsum("ak,...kv->...av", R1, per)

            def art_apply(Y_iter):
                """Exact generalized response: ΔU = M⁻¹ΦᵀY → body ΔV (...,B,6)."""
                duY = cholesky_solve_factored(Lf, gen_rhs(Y_iter)) * pad
                uY = duY.reshape(lead + (-1,)) @ usc_T
                return anc @ (S * uY[..., None])

        cache_ok = state.contact_lam is not None \
            and tuple(state.contact_lam.shape[-2:]) == (tables.n_con, 4)
        lin2, ang2, ncf_imp, Y_tot, lam_out = impulse_contact_pass(
            scene, tables, cgeom, body_pos, body_quat, lin_post, w_post,
            params.body_mass_scale, dt, psi=psi, art_apply=art_apply,
            lam_warm=state.contact_lam if cache_ok else None,
        )
        net_cf = net_cf + ncf_imp
        if art_bodies:
            u_new_a = u_new_a + cholesky_solve_factored(Lf, gen_rhs(Y_tot)) * pad

    u_new = u_new_a.reshape(lead + (-1,)) @ usc_T

    # integrate joints
    q, qd = state.q, state.qd
    if m.D:
        maxvel = on("dof_maxvel", lambda: m.dof_maxvel)
        qd = torch.clamp(u_new[..., idx("jd_coord", lambda: m.jd_coord)], -maxvel, maxvel)
        q = torch.clamp(q + dt * qd, on("dof_lower", lambda: m.dof_lower) - 1e-3,
                        on("dof_upper", lambda: m.dof_upper) + 1e-3)

    # integrate floating roots
    root_pos, root_quat = state.root_pos, state.root_quat
    root_linvel, root_angvel = state.root_linvel, state.root_angvel
    floats = [r for r in range(m.A_dyn) if m.act_floating[r]]
    if floats:
        ai = idx("float_actors", lambda: m.act_actor[floats])
        base6 = u_new_a[..., idx("float_rows", lambda: floats), :6]   # (...,nf,6) [ω, v_O]
        w_new = base6[..., :3]
        p_r = root_pos[..., ai, :]
        v_r = base6[..., 3:] + cross(w_new, p_r)
        # stability caps (PhysX clamps likewise)
        w_new = torch.clamp(w_new, -scene.max_root_angvel, scene.max_root_angvel)
        v_r = torch.clamp(v_r, -scene.max_root_linvel, scene.max_root_linvel)
        root_linvel = _set_rows(root_linvel, ai, v_r)
        root_angvel = _set_rows(root_angvel, ai, w_new)
        if run_impulse:
            # free single rigid bodies take their impulse-corrected velocities
            rows = np.where(free_rows > 0)[0]
            if len(rows):
                rt = idx("free_rows", lambda: rows)
                b_act = idx("free_actors", lambda: scene.body_actor[rows])
                root_linvel = _set_rows(root_linvel, b_act, lin2[..., rt, :])
                root_angvel = _set_rows(root_angvel, b_act, ang2[..., rt, :])
            v_r, w_new = root_linvel[..., ai, :], root_angvel[..., ai, :]
        root_pos = _set_rows(root_pos, ai, p_r + dt * v_r)
        root_quat = _set_rows(root_quat, ai, quat_integrate(root_quat[..., ai, :], w_new, dt))

    cache_out = state.contact_lam
    if run_impulse and state.contact_lam is not None \
            and tuple(state.contact_lam.shape[-2:]) == (tables.n_con, 4):
        cache_out = lam_out
    return state.replace(
        root_pos=root_pos, root_quat=root_quat, root_linvel=root_linvel, root_angvel=root_angvel,
        q=q, qd=qd, net_contact_force=net_cf, contact_lam=cache_out,
    )


def refresh_stacked(m: StackedModel, state: SimState) -> SimState:
    body_pos, body_quat, axis_w = fk_stacked(m, state.root_pos, state.root_quat, state.q)
    S = motion_subspace_stacked(m, body_pos, axis_w)
    u = generalized_velocities(m, state)
    anc = m.on("anc_dof", lambda: m.anc_dof, body_pos.dtype, body_pos.device)
    v_b = anc @ (S * u[..., None])
    w_b = v_b[..., :3]
    lin_b = v_b[..., 3:] + cross(w_b, body_pos)
    return state.replace(
        body_pos=body_pos, body_quat=body_quat, body_linvel=lin_b, body_angvel=w_b
    )
