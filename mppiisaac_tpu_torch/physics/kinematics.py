"""Forward kinematics of one articulation, link by link: the naive per-link
engine of the JAX package's `physics/kinematics.py`, batched over a leading
axis K (the JAX functions take one env and are vmapped).

No control path uses it: the stacked engine (physics/stacked.py) and the
kernels' twin (ops/fused_physics.fk) run FK over all actors at once. It
stays as the small, readable reference the unit tests hold them against.
Every constant is made on the device and in the dtype of the inputs.
"""
from __future__ import annotations

import torch

from .math3d import cross, quat_from_axis_angle, quat_mul, quat_rotate
from .model import JOINT_PRISMATIC, JOINT_REVOLUTE, Articulation


def _const(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def fk_actor(art: Articulation, root_pos, root_quat, root_linvel, root_angvel, q, qd):
    """World-frame pose and velocity of every link of one articulation.

    root_* (K,3) / (K,4), q and qd (K, ndof) for this actor. → (pos (K,nb,3),
    quat (K,nb,4), linvel (K,nb,3), angvel (K,nb,3)); linvel is the velocity
    of each link-frame origin (the reference's rigid-body-state layout)."""
    pos, quat, linvel, angvel = [root_pos], [root_quat], [root_linvel], [root_angvel]
    for i in range(1, art.nbody):
        p = int(art.parent[i])
        jp, jq, axis = (_const(art.jpos[i], root_pos), _const(art.jquat[i], root_pos),
                        _const(art.jaxis[i], root_pos))
        # the joint frame on the parent, and its origin's velocity
        fp = pos[p] + quat_rotate(quat[p], jp)
        fq = quat_mul(quat[p], jq.expand_as(quat[p]))
        v_f = linvel[p] + cross(angvel[p], fp - pos[p])
        w_f = angvel[p]
        jt, k = int(art.jtype[i]), int(art.dof_index[i])
        if jt == JOINT_REVOLUTE:
            bq = quat_mul(fq, quat_from_axis_angle(axis, q[:, k]))
            bp = fp
            bw = w_f + quat_rotate(fq, axis) * qd[:, k, None]
            bv = v_f
        elif jt == JOINT_PRISMATIC:
            axis_w = quat_rotate(fq, axis)
            bp = fp + axis_w * q[:, k, None]
            bq = fq
            bw = w_f
            # the origin's offset turns with the parent too
            bv = v_f + cross(w_f, bp - fp) + axis_w * qd[:, k, None]
        else:
            bp, bq, bw, bv = fp, fq, w_f, v_f
        pos.append(bp)
        quat.append(bq)
        linvel.append(bv)
        angvel.append(bw)
    return (torch.stack(pos, 1), torch.stack(quat, 1), torch.stack(linvel, 1),
            torch.stack(angvel, 1))


def joint_world_frames(art: Articulation, pos, quat):
    """World anchor of each body's inboard joint and its world axis, from
    fk_actor's pos (K,nb,3) and quat (K,nb,4). → (anchor (K,nb,3), axis_w
    (K,nb,3)); the root's anchor is its position and its axis is x. A
    revolute or prismatic joint's anchor is the child's origin."""
    axes = [_const([1.0, 0.0, 0.0], pos).expand_as(pos[:, 0])]
    for i in range(1, art.nbody):
        p = int(art.parent[i])
        fq = quat_mul(quat[:, p], _const(art.jquat[i], quat).expand_as(quat[:, p]))
        axes.append(quat_rotate(fq, _const(art.jaxis[i], pos)))
    return pos, torch.stack(axes, 1)
