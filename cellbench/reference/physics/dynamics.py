# Frozen copy of mppiisaac_tpu_torch/physics/dynamics.py, part of the benchmark's yardstick.
"""Articulated rigid-body dynamics of one actor, the naive per-link engine of
the JAX package's `physics/dynamics.py`: world-frame (Plücker) CRBA and
RNEA, implicit drives, one velocity update.

* `build_actor_masks` — the per-actor topology masks (host-side numpy),
  which the fused physics consumes too.
* `spatial_inertia_world`, `crm`, `crf`, `motion_subspaces`,
  `body_spatial_velocity`, `mass_matrix`, `bias_and_external`,
  `drive_terms`, `joint_limit_torque`, `solve_velocity_update` — plain
  torch, batched over a leading axis K (the JAX functions take one env and
  are vmapped), every constant made on the device and in the dtype of the
  inputs. No control path uses them: the stacked engine (physics/stacked.py)
  and the kernels' twin (ops/fused_physics) solve every actor at once. They
  stay as the readable reference the unit tests hold those against.

Spatial vectors: motion [ω; v_O], force [n_O; f], both about the world
origin; v_O = linvel − ω×pos for a body whose origin moves at linvel. The
solve uses the port's one Cholesky (math3d.cholesky_factor), where the JAX
package calls a general solve on the same SPD matrix.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .math3d import cholesky_factor, cholesky_solve_factored, cross, quat_to_matrix
from .model import (
    DRIVE_EFFORT,
    DRIVE_POSITION,
    DRIVE_VELOCITY,
    JOINT_REVOLUTE,
    Articulation,
)


class ActorMasks(NamedTuple):
    """Static (numpy) topology masks for one articulation."""
    nv: int                      # generalized velocity dim (6·floating + ndof)
    base_dofs: int               # 6 if floating else 0
    dof_body: np.ndarray         # (nv,) body index owning each velocity coordinate
    ancestor: np.ndarray         # (nv,nv) bool: [i,j] = i is ancestor-or-self dof of j
    subtree: np.ndarray          # (nv,nbody) bool: body b in subtree rooted at dof i's body


def build_actor_masks(art: Articulation) -> ActorMasks:
    base = 0 if art.fixed_base else 6
    nv = base + art.ndof
    dof_body = np.zeros(nv, dtype=np.int32)
    body_dofs = [[] for _ in range(art.nbody)]  # dofs "at" each body (inboard joint)
    if base:
        dof_body[:6] = 0
        body_dofs[0] = list(range(6))
    for i in range(art.nbody):
        k = int(art.dof_index[i])
        if k >= 0:
            dof_body[base + k] = i
            body_dofs[i].append(base + k)

    # body ancestry (incl. self)
    anc_body = np.zeros((art.nbody, art.nbody), dtype=bool)
    for b in range(art.nbody):
        x = b
        while x >= 0:
            anc_body[x, b] = True
            x = int(art.parent[x])

    ancestor = np.zeros((nv, nv), dtype=bool)
    for i in range(nv):
        for j in range(nv):
            bi, bj = dof_body[i], dof_body[j]
            if anc_body[bi, bj]:
                if bi != bj:
                    ancestor[i, j] = True
                else:
                    # same body: floating-base block, or identical dof
                    ancestor[i, j] = i <= j
    subtree = np.zeros((nv, art.nbody), dtype=bool)
    for i in range(nv):
        subtree[i] = anc_body[dof_body[i]]
    return ActorMasks(nv=nv, base_dofs=base, dof_body=dof_body, ancestor=ancestor, subtree=subtree)


def _const(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)


def _skew(v):
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def spatial_inertia_world(mass, com_world, R, I_com_body):
    """6×6 spatial inertia about the world origin: mass (...), com_world
    (...,3), R (...,3,3), I_com_body (...,3,3) → (...,6,6)."""
    Iw = R @ I_com_body @ R.transpose(-1, -2)
    C = _skew(com_world)
    mC = mass[..., None, None] * C
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    top = torch.cat([Iw + mC @ C.transpose(-1, -2), mC], -1)
    bot = torch.cat([mC.transpose(-1, -2), mass[..., None, None] * eye], -1)
    return torch.cat([top, bot], -2)


def crm(v, m):
    """Motion cross motion: v × m."""
    w, vo = v[..., :3], v[..., 3:]
    mw, mv = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, mw), cross(w, mv) + cross(vo, mw)], -1)


def crf(v, f):
    """Motion cross force: v ×* f."""
    w, vo = v[..., :3], v[..., 3:]
    n, fv = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(vo, fv), cross(w, fv)], -1)


class DynInputs(NamedTuple):
    pos: torch.Tensor       # (K,nb,3) body origins, world
    quat: torch.Tensor      # (K,nb,4)
    linvel: torch.Tensor    # (K,nb,3)
    angvel: torch.Tensor    # (K,nb,3)
    anchors: torch.Tensor   # (K,nb,3) inboard joint anchor, world
    axes: torch.Tensor      # (K,nb,3) inboard joint axis, world


def motion_subspaces(art: Articulation, masks: ActorMasks, din: DynInputs):
    """(K,nv,6) Plücker motion subspaces, world frame: a floating base's
    6 unit vectors, then one row per dof in dof order."""
    K = din.pos.shape[0]
    base = masks.base_dofs
    rows = list(torch.eye(6, dtype=din.pos.dtype, device=din.pos.device).expand(K, 6, 6).unbind(1)
                if base else [])
    joint = {}
    for i in range(art.nbody):
        k = int(art.dof_index[i])
        if k < 0:
            continue
        a = din.axes[:, i]
        if int(art.jtype[i]) == JOINT_REVOLUTE:
            joint[k] = torch.cat([a, cross(din.anchors[:, i], a)], -1)
        else:
            joint[k] = torch.cat([torch.zeros_like(a), a], -1)
    return torch.stack(rows + [joint[k] for k in sorted(joint)], 1)


def body_spatial_velocity(din: DynInputs):
    """(K,nb,6) Plücker velocities from FK's outputs."""
    w = din.angvel
    return torch.cat([w, din.linvel - cross(w, din.pos)], -1)


def mass_matrix(art: Articulation, masks: ActorMasks, S, Iw):
    """CRBA by the ancestry-masked contraction: S (K,nv,6), Iw (K,nb,6,6)
    → M (K,nv,nv)."""
    Ic = list(Iw.unbind(1))
    for i in range(art.nbody - 1, 0, -1):
        p = int(art.parent[i])
        Ic[p] = Ic[p] + Ic[i]
    Ic = torch.stack(Ic, 1)                                       # (K,nb,6,6)
    IcS = torch.einsum("kvab,kvb->kva", Ic[:, torch.as_tensor(masks.dof_body, dtype=torch.long,
                                                               device=S.device)], S)
    Mfull = torch.einsum("kia,kja->kij", S, IcS)                  # M_ij = S_i · Ic S_j
    Mm = torch.where(torch.as_tensor(masks.ancestor, device=S.device), Mfull, 0.0)
    return Mm + Mm.transpose(-1, -2) - torch.diag_embed(torch.diagonal(Mm, dim1=-2, dim2=-1))


def bias_and_external(art: Articulation, masks: ActorMasks, S, Iw, v_b, qd_joint, f_ext, gravity):
    """RNEA with qdd = 0: the generalized bias forces C(q,qd)·qd + g − Qext,
    so that M u̇ = τ − C. v_b (K,nb,6) body velocities, qd_joint (K,ndof),
    f_ext (K,nb,6) Plücker external forces (world, about the origin),
    gravity (3,). → (K,nv)."""
    K = v_b.shape[0]
    g_sp = torch.zeros(K, 6, dtype=v_b.dtype, device=v_b.device)
    if not art.disable_gravity:
        g_sp[:, 3:] = -_const(gravity, v_b)
    base = masks.base_dofs
    # forward pass: accelerations with a_root = −g (the free-fall trick)
    a = [g_sp]
    for i in range(1, art.nbody):
        p, k = int(art.parent[i]), int(art.dof_index[i])
        ai = a[p]
        if k >= 0:
            ai = ai + crm(v_b[:, i], S[:, base + k] * qd_joint[:, k, None])
        a.append(ai)
    a = torch.stack(a, 1)
    f = (torch.einsum("kbij,kbj->kbi", Iw, a)
         + crf(v_b, torch.einsum("kbij,kbj->kbi", Iw, v_b)) - f_ext)
    # backward: C_i = S_i · Σ over the subtree of body(i)
    fsub = torch.einsum("vb,kbi->kvi", _const(masks.subtree, f), f)
    return (S * fsub).sum(-1)


def drive_terms(art: Articulation, q, qd, dof_target, dt):
    """The implicit PD drives: (tau_explicit (K,ndof), d_implicit (K,ndof))
    with the drive torque τ = tau_explicit − d_implicit · qd_next, qd_next the
    post-step velocity. Force-limited (kd_eff = min(kd, F/|Δv|), likewise
    kp); the effort drive clamps its target; passive damping is implicit, the
    smooth Coulomb friction explicit."""
    if art.ndof == 0:
        z = q.new_zeros(q.shape[0], 0)
        return z, z
    mode = torch.as_tensor(np.asarray(art.drive_mode), device=q.device)
    kp, kd = _const(art.drive_kp, q), _const(art.drive_kd, q)
    effort = _const(art.dof_effort, q)
    kd_eff = torch.minimum(kd, effort / torch.clamp(torch.abs(dof_target - qd), min=1e-6))
    kp_eff = torch.minimum(kp, effort / torch.clamp(torch.abs(dof_target - q), min=1e-6))
    tau = torch.where(mode == DRIVE_VELOCITY, kd_eff * dof_target,
                      torch.where(mode == DRIVE_POSITION, kp_eff * (dof_target - q),
                                  torch.where(mode == DRIVE_EFFORT,
                                              torch.clamp(dof_target, -effort, effort), 0.0)))
    d_imp = torch.where(mode == DRIVE_VELOCITY, kd_eff,
                        torch.where(mode == DRIVE_POSITION, kp_eff * dt + kd,
                                    torch.where(mode == DRIVE_EFFORT, kd, 0.0)))
    d_imp = d_imp + _const(art.dof_damping, q)
    tau = tau - _const(art.dof_friction, q) * torch.tanh(qd / 0.02)
    return tau, d_imp


JOINT_LIMIT_KP = 1.0e3
JOINT_LIMIT_KD = 1.0e2


def joint_limit_torque(art: Articulation, q, qd):
    """The joint-limit penalty (K,ndof): a spring past each limit and a
    damper while past it."""
    if art.ndof == 0:
        return q.new_zeros(q.shape[0], 0)
    below = torch.clamp(_const(art.dof_lower, q) - q, min=0.0)
    above = torch.clamp(q - _const(art.dof_upper, q), min=0.0)
    viol = (below > 0) | (above > 0)
    return JOINT_LIMIT_KP * (below - above) - torch.where(viol, JOINT_LIMIT_KD * qd, 0.0)


def solve_velocity_update(art: Articulation, masks: ActorMasks, din: DynInputs, q, qd,
                          dof_target, f_ext, gravity, dt, mass_scale=None):
    """One implicit velocity update of one articulation. q, qd, dof_target
    (K,ndof); f_ext (K,nb,6) Plücker world forces; mass_scale (K,nb) or None.
    → u_new (K,nv): the new generalized velocities, a floating base's
    [ω, v_O] first, the dofs' clamped to their max velocity."""
    base, nv = masks.base_dofs, masks.nv
    mass = _const(art.mass, q).expand(q.shape[0], -1)
    I_com = _const(art.inertia, q).expand(q.shape[0], -1, -1, -1)
    if mass_scale is not None:
        mass = mass * mass_scale
        I_com = I_com * mass_scale[..., None, None]
    R = quat_to_matrix(din.quat)
    com_world = din.pos + torch.einsum("kbij,bj->kbi", R, _const(art.com, q))
    Iw = spatial_inertia_world(mass, com_world, R, I_com)
    S = motion_subspaces(art, masks, din)
    v_b = body_spatial_velocity(din)
    M = mass_matrix(art, masks, S, Iw)
    C = bias_and_external(art, masks, S, Iw, v_b, qd, f_ext, gravity)
    tau = q.new_zeros(q.shape[0], nv)
    u = torch.cat([v_b[:, 0], qd], -1) if base else qd
    diag = q.new_zeros(q.shape[0], nv)
    if art.ndof:
        tau_d, d_imp = drive_terms(art, q, qd, dof_target, dt)
        tau[:, base:] = tau_d + joint_limit_torque(art, q, qd)
        # the implicit drive and armature terms go into the solve's matrix only
        diag[:, base:] = dt * d_imp + _const(art.dof_armature, q)
    rhs = (M @ u[..., None])[..., 0] + dt * (tau - C)
    M = M + torch.diag_embed(diag)
    M = M + torch.eye(nv, dtype=q.dtype, device=q.device) * 1e-9   # Tikhonov, as the JAX solve
    u_new = cholesky_solve_factored(cholesky_factor(M), rhs)
    if art.ndof:
        maxvel = _const(art.dof_maxvel, q)
        u_new = torch.cat([u_new[:, :base], torch.clamp(u_new[:, base:], -maxvel, maxvel)], -1)
    return u_new
