"""Whole-scene articulation tables (host) and the body-cache refresh (torch).

`build_stacked` is the JAX package's `physics/stacked.py` builder carried
over unchanged (numpy). `refresh_stacked` recomputes the derived body caches
of a SimState — poses by forward kinematics and body velocities from the
generalized velocities — with the same algorithm as the JAX refresh
(pointer-doubling FK, world-frame motion subspaces, one ancestry-masked
contraction), batched over any leading axes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..utils.device_cache import DeviceCache
from .math3d import cross, quat_from_axis_angle, quat_mul, quat_normalize, quat_rotate
from .model import JOINT_PRISMATIC, JOINT_REVOLUTE
from .scene_model import SceneModel
from .types import SimState

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
