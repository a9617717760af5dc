"""Contacts of the fused physics substep, plain PyTorch twin of
csrc/contacts.cuh, batched over a leading sample axis K.

Counterpart of the JAX package's `ops/pallas/fused_physics.py` `block_gate`,
`block_geometry` and `contacts_lanes`, for the pair-block kinds this port
has: cp (capsule–plane), bp (box–plane), cb (capsule–box) and bbc (box
corners and face centres against a box). Every block is read from the flat
tables of `KernelScene` (the same tables the CUDA kernels read).

The TPU kernel gated a block on "any lane of the tile is possibly in
contact"; here the gate is per sample. A gated-off block contributes exact
zeros either way, and the NaN rule is kept: the gate is written as
~(separated), so a diverged sample keeps its blocks live.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..physics.math3d import cross, dot, point_to_box, quat_mul, quat_rotate, quat_rotate_inv, segment_closest
from ..physics.urdf import GEOM_CAPSULE

# pair-block kinds of the kernel tables (csrc/contacts.cuh KIND_*)
KIND_CP, KIND_BP, KIND_CB, KIND_BBC = 0, 1, 2, 3
KIND_NAMES = {"cp": KIND_CP, "bp": KIND_BP, "cb": KIND_CB, "bbc": KIND_BBC}

# per-block flag bits (csrc/contacts.cuh F_*)
F_HAS_B, F_EMIT_A, F_EMIT_B, F_SWEPT = 1, 2, 4, 8
F_A_FREE, F_B_FREE, F_A_ART, F_B_ART = 16, 32, 64, 128
F_SLAB = 256          # b side is an unrotated box: exact slab gate

# broadphase gate margin (fused_physics.block_gate)
GATE_MARGIN = 1e-3


def _c(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


class SweptGeo(NamedTuple):
    """One swept block's contact geometry for the impulse pass: (K,S,3)
    point and normal, (K,S) depth, all zero where the gate is off, and the
    (K,) gate itself."""
    blk: int
    point: torch.Tensor
    normal: torch.Tensor
    depth: torch.Tensor
    live: torch.Tensor


def geom_pose(ks, g: int, pos, quat):
    b = int(ks.geom_body[g])
    gp = pos[b] + quat_rotate(quat[b], _c(ks.geom_pos[g], pos[b]))
    gq = quat_mul(quat[b], _c(ks.geom_quat[g], quat[b]).expand_as(quat[b]))
    return gp, gq


def geom_segment(ks, g: int, pos, quat):
    """Capsule (or sphere) axis end points and radius."""
    gp, gq = geom_pose(ks, g, pos, quat)
    r = float(ks.geom_size[g][0])
    hl = float(ks.geom_size[g][1]) if int(ks.geom_type[g]) == GEOM_CAPSULE else 0.0
    axis = quat_rotate(gq, _c([0.0, 0.0, 1.0], gp))
    return gp + axis * (-hl), gp + axis * hl, r


def block_gate(ks, bi: int, pos, quat) -> torch.Tensor:
    """(K,) "possibly in contact" per sample: a bounding-sphere test on the
    bodies' origins (plane blocks: height against z = 0), or the exact
    point-to-slab distance when the b side is an unrotated box."""
    flags = int(ks.blk_flags[bi])
    ca = pos[int(ks.blk_ba[bi])]
    thr = float(ks.blk_thr[bi])
    if not flags & F_HAS_B:
        return ~(ca[:, 2] > thr)
    bb = int(ks.blk_bb[bi])
    if flags & F_SLAB:
        gb = int(ks.blk_gb[bi])
        db = quat_rotate_inv(quat[bb], ca - pos[bb])
        e = torch.clamp((db - _c(ks.geom_pos[gb], db)).abs() - _c(ks.geom_size[gb], db), min=0.0)
        d2 = e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2]
        return ~(d2 > thr)
    d = ca - pos[bb]
    return ~(dot(d, d) > thr)


def _block_samples(ks, bi: int, like: torch.Tensor) -> torch.Tensor:
    """(S,3) box-sample offsets of a block from the sconst table."""
    o, S = int(ks.blk_sc[bi]), int(ks.blk_S[bi])
    sc = ks.sconst
    return _c([[sc[o + i * S + s] for i in range(3)] for s in range(S)], like)


def block_geometry(ks, bi: int, pos, quat):
    """(point (K,S,3), normal (K,S,3) or (3,), depth (K,S)) of one block's S
    manifold samples (block_geometry of the JAX package)."""
    kind = int(ks.blk_kind[bi])
    ga, gb = int(ks.blk_ga[bi]), int(ks.blk_gb[bi])
    ref = pos[0]
    ez = _c([0.0, 0.0, 1.0], ref)
    if kind == KIND_CP:
        p0, p1, r = geom_segment(ks, ga, pos, quat)
        pend = torch.stack([p0, p1], 1)                              # (K,2,3)
        point = torch.stack([pend[..., 0], pend[..., 1], pend[..., 2] - r], -1)
        return point, ez, r - pend[..., 2]
    if kind == KIND_BP:
        gp, gq = geom_pose(ks, ga, pos, quat)
        samp = _block_samples(ks, bi, ref)
        pt = gp[:, None] + quat_rotate(gq[:, None].expand(-1, samp.shape[0], -1),
                                       samp.expand(gp.shape[0], -1, -1))
        return pt, ez, -pt[..., 2]
    if kind == KIND_CB:
        p0, p1, r = geom_segment(ks, ga, pos, quat)
        gp_b, gq_b = geom_pose(ks, gb, pos, quat)
        sp2, _ = segment_closest(p0, p1, gp_b, gp_b)
        sp = torch.stack([p0, p1, sp2], 1)                           # (K,3,3)
        n_w, depth_c, surf = point_to_box(sp, gp_b[:, None], gq_b[:, None],
                                          [float(v) for v in ks.geom_size[gb]])
        return surf, n_w, depth_c + r
    if kind == KIND_BBC:
        gp_a, gq_a = geom_pose(ks, ga, pos, quat)
        gp_b, gq_b = geom_pose(ks, gb, pos, quat)
        samp = _block_samples(ks, bi, ref)
        S = samp.shape[0]
        pt = gp_a[:, None] + quat_rotate(gq_a[:, None].expand(-1, S, -1),
                                         samp.expand(gp_a.shape[0], -1, -1))
        n_w, depth_c, surf = point_to_box(pt, gp_b[:, None], gq_b[:, None],
                                          [float(v) for v in ks.geom_size[gb]])
        return surf, n_w, depth_c
    raise NotImplementedError(f"pair-block kind {kind}")


def _point_vel(linv, angv, pos, point):
    return linv[:, None] + cross(angv[:, None], point - pos[:, None])


def contacts(ks, pos, quat, linv, angv, fric, dt_sub):
    """Broadphase gate, narrowphase and the side-asymmetric penalty law of
    every block (contacts_lanes). fric: (K,G) geom friction scale.
    → per-body lists of Plücker torque, force and reported net contact force
    (K,3), and the swept blocks' geometry ([SweptGeo]) for the impulse pass."""
    B = ks.nbody
    zero3 = torch.zeros_like(pos[0])
    plk_n: List = [zero3] * B
    plk_f: List = [zero3] * B
    net_cf: List = [zero3] * B
    swept: List[SweptGeo] = []
    tau_c = max(2.0 * dt_sub, 1e-3)
    zeta = 1.0
    for bi in range(ks.nblk):
        flags = int(ks.blk_flags[bi])
        emit_a, emit_b = bool(flags & F_EMIT_A), bool(flags & F_EMIT_B)
        is_swept = bool(flags & F_SWEPT)
        if not (emit_a or emit_b or is_swept):
            continue
        ba, bb = int(ks.blk_ba[bi]), int(ks.blk_bb[bi])
        has_b = bool(flags & F_HAS_B)
        live = block_gate(ks, bi, pos, quat)
        point, normal, depth = block_geometry(ks, bi, pos, quat)
        lv = live[:, None]
        if emit_a or emit_b:
            fa = fric[:, int(ks.blk_ga[bi])]
            fb = fric[:, int(ks.blk_gb[bi])] if has_b else fa
            mu = (float(ks.blk_mu0[bi]) * 0.5 * (fa + fb))[:, None]
            va = _point_vel(linv[ba], angv[ba], pos[ba], point)
            v_rel = va - _point_vel(linv[bb], angv[bb], pos[bb], point) if has_b else va
            vn = dot(v_rel, normal)
            vt = v_rel - normal * vn[..., None]
            vt_norm = torch.sqrt(dot(vt, vt))
            active = depth > 0.0
            depth_cl = torch.clamp(depth, max=ks.max_depth)

            def force_with(kn_base):
                kn = kn_base / (tau_c * tau_c)
                kd = 2.0 * zeta * kn_base / tau_c
                fn = torch.where(active, torch.clamp(kn * depth_cl - kd * vn, min=0.0), 0.0)
                ft_s = -(mu * fn / torch.clamp(vt_norm, min=ks.eps_v))
                return normal * fn[..., None] + vt * ft_s[..., None]

            kn_a, kn_b = float(ks.blk_kn_a[bi]), float(ks.blk_kn_b[bi])
            force_a = force_with(kn_a)
            if emit_a:
                fA = torch.where(lv, force_a.sum(1), 0.0)
                nA = torch.where(lv, cross(point, force_a).sum(1), 0.0)
                plk_n[ba] = plk_n[ba] + nA
                plk_f[ba] = plk_f[ba] + fA
                net_cf[ba] = net_cf[ba] + fA
            if emit_b:
                force_b = force_a if kn_b == kn_a else force_with(kn_b)
                fB = torch.where(lv, force_b.sum(1), 0.0)
                nB = torch.where(lv, cross(point, force_b).sum(1), 0.0)
                plk_n[bb] = plk_n[bb] - nB
                plk_f[bb] = plk_f[bb] - fB
                net_cf[bb] = net_cf[bb] - fB
        if is_swept:
            K, S = depth.shape
            normal = normal.expand(K, S, 3)
            static_n = int(ks.blk_kind[bi]) in (KIND_CP, KIND_BP)
            swept.append(SweptGeo(
                bi,
                torch.where(lv[..., None], point, 0.0),
                normal if static_n else torch.where(lv[..., None], normal, 0.0),
                torch.where(lv, depth, 0.0),
                live,
            ))
    return plk_n, plk_f, net_cf, swept


def block_live_or(live: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x where the block's gate is on, exact zeros elsewhere (x: (K,...))."""
    return torch.where(live.reshape(live.shape + (1,) * (x.dim() - 1)), x, 0.0)
