# Frozen copy of mppiisaac_tpu_torch/physics/contact.py, part of the benchmark's yardstick.
"""Compliant contact engine: static candidate tables (host-side numpy) and
the engine's narrowphase, force law and impulse pass (torch).

The table builder of the JAX package's `physics/contact.py`, carried over
unchanged so that the candidate order — and with it every pair block and
persistent-λ row — is the same in both packages. `compute_contact_forces`
and `impulse_contact_pass` are that module's runtime, batched over a leading
env/sample axis: the engine (`physics/step.Engine.step`) runs them. The
kernels' narrowphase and force law live in `ops/fused_physics.py` (their
plain twin) and in the CUDA kernels.

Force law per contact point (normal n from B→A, depth d > 0 penetrating):
    kn = m_eff / (τ² · n_pts),  kd = 2 ζ m_eff / (τ · n_pts)
    f_n = max(0, kn·d − kd·v_n),  f_t = −μ f_n · v_t/(‖v_t‖ + ε_v)
with τ tied to the substep dt (MuJoCo solref-style).

Every static index array and per-candidate constant is a tensor cached on
the tables object per device (`utils.device_cache.cached`): a step captured
in a CUDA graph copies nothing from the host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..utils.device_cache import cached
from .linalg import solve_psd
from .math3d import cross, point_to_box, quat_mul, quat_rotate, quat_to_matrix, segment_closest
from .scene_model import SceneModel
from .stacked import _skew
from .urdf import GEOM_BOX, GEOM_CAPSULE


@dataclass
class ContactTables:
    """Static narrowphase work lists (numpy). Group fields drive the runtime
    narrowphase; the flat per-candidate fields drive force assembly."""
    # groups (geom indices)
    cp_geom: np.ndarray          # capsuloid vs plane (2 endpoint contacts each)
    bp_geom: np.ndarray          # box vs plane (8 corners each)
    cc_a: np.ndarray             # capsuloid vs capsuloid (1 contact)
    cc_b: np.ndarray
    cb_cap: np.ndarray           # capsuloid vs box (3 contacts)
    cb_box: np.ndarray
    bb_a: np.ndarray             # box vs box, FULL 2×26-sample manifold (rare)
    bb_b: np.ndarray
    # box vs box, reduced DIRECTIONAL manifold: corners of bbc_a sampled
    # against box bbc_b (8 candidates). Directions where the sampled box is
    # far larger than the host (table corners vs a block) are dropped at
    # table-build time — they cannot produce meaningful contact and were the
    # bulk of the fused kernel's sweep workload (a full pair costs 52
    # candidates; a typical reduced pair costs 8-16)
    bbc_a: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    bbc_b: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    # per-table bbc sample count: the WORLD tables use the full 14-sample
    # reduced manifold (corners + face centers); a planner-model table may be
    # built with 8 (corners only) — the fast-fidelity fused rollout trades the
    # face-face support patch for ~40% fewer swept candidates
    bbc_samples: int = 14
    # flat candidate tables, in the exact order the runtime concatenates
    n_con: int = 0
    con_geom_a: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    con_geom_b: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))  # -1 = plane
    kn_base: np.ndarray = field(default_factory=lambda: np.zeros(0))   # m_eff / n_pts
    n_pts: np.ndarray = field(default_factory=lambda: np.zeros(0))     # manifold divisor per candidate
    mu_base: np.ndarray = field(default_factory=lambda: np.zeros(0))
    kn_base_soft: np.ndarray = field(default_factory=lambda: np.zeros(0))  # mass-scaled (stable on free bodies)
    a_free: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    b_free: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    # two-way impulse coupling (grasping): side is on a dynamic ARTICULATED
    # actor and the other side is free → the articulated side joins the
    # impulse pass through its joint-space effective mass J M⁻¹ Jᵀ
    a_art: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    b_art: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    # articulated STICTION contacts (locomotion): side is on a FLOATING-base
    # articulated actor and the other side is static (plane / fixed actor).
    # The smoothed Coulomb penalty alone lets feet creep (viscous below
    # friction_smoothing_vel — a standing quadruped skates ~1 cm/s); these
    # candidates join the impulse pass FRICTION-ONLY (normal stays penalty)
    a_sta: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    b_sta: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    art_bodies: tuple = ()       # body indices needing an operational-space Ψ
    acc_a: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.float32))  # (B, n_con) +1 one-hot
    acc_b: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.float32))  # (B, n_con) +1 one-hot (0 for plane)


def _body_mass_for_contact(scene: SceneModel, gi: int) -> float:
    b = int(scene.geom_body[gi])
    ai = int(scene.body_actor[b])
    art = scene.actors[ai]
    if art.fixed_base and art.ndof == 0:
        return np.inf
    if art.ndof > 0:
        # articulated: a contact link carries a share of the whole robot.
        # Geometric mean of link and total mass: pure link mass sags under the
        # chassis, pure total mass over-stiffens the light wheel's local modes
        local_m = float(art.mass[b - scene.body_offset[ai]])
        total_m = float(np.sum(art.mass))
        return max(np.sqrt(max(local_m, 1e-3) * max(total_m, 1e-3)), 1e-3)
    local = b - scene.body_offset[ai]
    return max(float(art.mass[local]), 1e-3)


def _pair_meff(scene: SceneModel, gi: int, gj: int) -> float:
    ma, mb = _body_mass_for_contact(scene, gi), _body_mass_for_contact(scene, gj)
    if np.isinf(ma) and np.isinf(mb):
        return 1.0
    if np.isinf(ma):
        return mb
    if np.isinf(mb):
        return ma
    return ma * mb / (ma + mb)


# A box samples its points against a partner box only when its volume is
# within this factor of the partner's — beyond it (a table vs a block) the
# bigger box's sample points cannot produce contact and the direction is
# dropped
BB_DROP_VOL_RATIO = 64.0

# Reduced per-direction sample set: corners + face centers
# (_BOX_SAMPLES[:14]). Corners alone miss face-face contacts whenever
# neither box's corners enter the other's interior (a wide pusher against a
# narrower block: the pusher's corners pass outside, the block's corners
# slide along the pusher's boundary planes at zero depth) — the face-center
# samples carry exactly that configuration. Edge midpoints (the remaining
# 12 of the full 26) only matter for edge-edge crossings and are dropped.
N_BBC_SAMPLES = 14


def build_contact_tables(scene: SceneModel,
                         bbc_samples: int = N_BBC_SAMPLES) -> ContactTables:
    gt = scene.geom_type
    cp_g, bp_g = [], []
    cc_a, cc_b = [], []
    cb_c, cb_bx = [], []
    bb_a, bb_b = [], []

    for gi in scene.plane_geoms:
        gi = int(gi)
        if np.isinf(_body_mass_for_contact(scene, gi)):
            continue
        (bp_g if gt[gi] == GEOM_BOX else cp_g).append(gi)

    bbc_a_l: List[int] = []
    bbc_b_l: List[int] = []

    def _box_vol(g):
        s = scene.geom_size[g]
        return max(float(s[0] * s[1] * s[2]), 1e-12)

    for gi, gj in zip(scene.pair_a, scene.pair_b):
        gi, gj = int(gi), int(gj)
        a_box, b_box = gt[gi] == GEOM_BOX, gt[gj] == GEOM_BOX
        if a_box and b_box:
            # reduced directional manifold: corners of X against box Y, with
            # the direction dropped when X is far bigger than Y (X's corners
            # cannot reach into Y in any pose the solver should care about).
            # Corner-only sampling keeps ≥4-point support patches for
            # face-face contact (stacking, finger-pad squeezes) at 8
            # candidates/direction vs the full manifold's 26
            va, vb = _box_vol(gi), _box_vol(gj)
            if va <= BB_DROP_VOL_RATIO * vb:
                bbc_a_l.append(gi); bbc_b_l.append(gj)
            if vb <= BB_DROP_VOL_RATIO * va:
                bbc_a_l.append(gj); bbc_b_l.append(gi)
        elif a_box:
            cb_c.append(gj); cb_bx.append(gi)
        elif b_box:
            cb_c.append(gi); cb_bx.append(gj)
        else:
            cc_a.append(gi); cc_b.append(gj)

    # flat candidate enumeration — ORDER MUST MATCH the runtime concatenation:
    # cp (2 endpoints, endpoint-major), bp (8 corners, corner-major),
    # cc (1), cb (3 sample points, point-major), bb (2×26 box samples,
    # sample-major, A-in-B then B-in-A), bbc (8 corners of a in b,
    # corner-major)
    ga_l: List[int] = []
    gb_l: List[int] = []
    npts_l: List[float] = []

    def emit(ga, gb, npts):
        ga_l.append(ga); gb_l.append(gb); npts_l.append(npts)

    for _ in range(2):
        for g in cp_g:
            emit(g, -1, 2.0)
    for _ in range(8):
        for g in bp_g:
            emit(g, -1, 4.0)
    for a, b in zip(cc_a, cc_b):
        emit(a, b, 1.0)
    for _ in range(3):
        for a, b in zip(cb_c, cb_bx):
            emit(a, b, 2.0)
    for _ in range(2 * N_BOX_SAMPLES):
        for a, b in zip(bb_a, bb_b):
            emit(a, b, 4.0)
    for _ in range(int(bbc_samples)):
        for a, b in zip(bbc_a_l, bbc_b_l):
            emit(a, b, 4.0)

    n = len(ga_l)
    ga_arr = np.asarray(ga_l, np.int32)
    gb_arr = np.asarray(gb_l, np.int32)
    npts = np.asarray(npts_l)
    meff = np.asarray([
        _pair_meff(scene, a, b) if b >= 0 else _body_mass_for_contact(scene, a)
        for a, b in zip(ga_l, gb_l)
    ])
    # articulated↔free couple pairs: fixed stiffness on the ARTICULATED side
    # (so actuators stall on light objects instead of passing through); the
    # free side keeps the mass-scaled (stable) stiffness — its fidelity comes
    # from the impulse pass
    free = _free_body_mask(scene)
    art = _articulated_body_mask(scene)
    meff_soft = meff.copy()
    tau_ref = max(2.0 * (scene.dt / max(scene.substeps, 1)), 1e-3)
    a_free_l = np.zeros(n, np.float32)
    b_free_l = np.zeros(n, np.float32)
    a_art_l = np.zeros(n, np.float32)
    b_art_l = np.zeros(n, np.float32)
    a_sta_l = np.zeros(n, np.float32)
    b_sta_l = np.zeros(n, np.float32)
    art_bodies: set = set()
    # floating-base articulated bodies (legged/mobile robots) get stiction
    # impulses against STATIC geometry — a fixed-base arm doesn't need them
    floating = np.zeros(scene.nbody, np.float32)
    for ai, a_ in enumerate(scene.actors):
        if not a_.fixed_base and (a_.ndof > 0 or a_.nbody > 1):
            o = scene.body_offset[ai]
            floating[o : o + a_.nbody] = 1.0
    static = 1.0 - np.maximum(free, art)      # fixed actors (planes are b<0)
    for c, (a, b) in enumerate(zip(ga_l, gb_l)):
        ba_ = scene.geom_body[a]
        a_free_l[c] = free[ba_]
        if b >= 0:
            b_free_l[c] = free[scene.geom_body[b]]
        fa_ = free[ba_] > 0
        fb_ = b >= 0 and free[scene.geom_body[b]] > 0
        if fa_ != fb_:
            # kn = kn_base/τ² at runtime → bake τ² back in for a fixed value
            meff[c] = scene.couple_stiffness * tau_ref * tau_ref
        # articulated↔free: the articulated side is solved TWO-WAY in the
        # impulse pass (J M⁻¹ Jᵀ effective mass) — the grasping fix
        if fb_ and art[ba_] > 0:
            a_art_l[c] = 1.0
            art_bodies.add(int(ba_))
        if fa_ and b >= 0 and art[scene.geom_body[b]] > 0:
            b_art_l[c] = 1.0
            art_bodies.add(int(scene.geom_body[b]))
        # articulated↔static: friction-only stiction impulses (foot-skating
        # fix) for floating-base robots against planes / fixed actors
        other_static = (b < 0) or static[scene.geom_body[b]] > 0
        if floating[ba_] > 0 and art[ba_] > 0 and other_static:
            a_sta_l[c] = 1.0
            art_bodies.add(int(ba_))
        if b >= 0 and floating[scene.geom_body[b]] > 0 and art[scene.geom_body[b]] > 0 \
                and static[ba_] > 0:
            b_sta_l[c] = 1.0
            art_bodies.add(int(scene.geom_body[b]))
    mu = np.asarray([
        0.5 * (scene.geom_friction[a] + scene.geom_friction[b]) if b >= 0
        else scene.geom_friction[a]
        for a, b in zip(ga_l, gb_l)
    ])

    B = scene.nbody
    acc_a = np.zeros((B, n), np.float32)
    acc_b = np.zeros((B, n), np.float32)
    for c, (a, b) in enumerate(zip(ga_l, gb_l)):
        acc_a[scene.geom_body[a], c] = 1.0
        if b >= 0:
            acc_b[scene.geom_body[b], c] = 1.0

    def arr(x):
        return np.asarray(x, np.int32)

    return ContactTables(
        cp_geom=arr(cp_g), bp_geom=arr(bp_g),
        cc_a=arr(cc_a), cc_b=arr(cc_b),
        cb_cap=arr(cb_c), cb_box=arr(cb_bx),
        bb_a=arr(bb_a), bb_b=arr(bb_b),
        bbc_a=arr(bbc_a_l), bbc_b=arr(bbc_b_l),
        n_con=n,
        con_geom_a=ga_arr, con_geom_b=gb_arr,
        kn_base=meff / npts, n_pts=npts, kn_base_soft=meff_soft / npts, mu_base=mu,
        a_free=a_free_l, b_free=b_free_l,
        a_art=a_art_l, b_art=b_art_l,
        a_sta=a_sta_l, b_sta=b_sta_l,
        art_bodies=tuple(sorted(art_bodies)),
        acc_a=acc_a, acc_b=acc_b,
        bbc_samples=int(bbc_samples),
    )


# box-box sampling: corners alone miss edge-face and face-face contacts (a
# narrow gripper finger pressing a wider block face has NO vertex inside the
# other box); add face centers + edge midpoints → 26 sample points
_BOX_SAMPLES = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    + [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]
    + [[0, sy, sz] for sy in (-1, 1) for sz in (-1, 1)]
    + [[sx, 0, sz] for sx in (-1, 1) for sz in (-1, 1)]
    + [[sx, sy, 0] for sx in (-1, 1) for sy in (-1, 1)],
    dtype=np.float32,
)  # (26,3)
N_BOX_SAMPLES = len(_BOX_SAMPLES)


def _free_body_mask(scene: SceneModel) -> np.ndarray:
    """(B,) 1.0 where the body is a free single-rigid-body actor."""
    mask = np.zeros(scene.nbody, np.float32)
    for ai, a in enumerate(scene.actors):
        if a.ndof == 0 and not a.fixed_base:
            mask[scene.body_offset[ai]] = 1.0
    return mask


def _articulated_body_mask(scene: SceneModel) -> np.ndarray:
    """(B,) 1.0 where the body belongs to a DYNAMIC articulated actor (one
    that participates in the generalized solve and is not a free single rigid
    body) — these sides can join the impulse pass via J M⁻¹ Jᵀ."""
    mask = np.zeros(scene.nbody, np.float32)
    for ai, a in enumerate(scene.actors):
        if a.ndof > 0 or (not a.fixed_base and a.nbody > 1):
            o = scene.body_offset[ai]
            mask[o : o + a.nbody] = 1.0
    return mask


def full_box_manifold(tables):
    """Tables of a scene with one box–box pair, moved from its two reduced
    (bbc) directions to the full 2×26-sample manifold (bb_a / bb_b), which
    `build_contact_tables` declares but never emits.

    The bb rows take the bbc section's place at the end of the candidate
    order, A-in-B then B-in-A, each emitted as the pair (a, b) with 4 points
    as the first bbc row is, so they carry that row's per-candidate
    constants. Returns a new tables object of the same class (the JAX
    package's ContactTables has the same fields), so that both packages can
    be given the same full-manifold scene."""
    import dataclasses

    if len(tables.bbc_a) != 2 or len(tables.bb_a) != 0:
        raise ValueError("full_box_manifold takes tables with exactly one box pair, in bbc form")
    o = tables.n_con - 2 * tables.bbc_samples                 # the bbc section's start
    a, b = int(tables.bbc_a[0]), int(tables.bbc_b[0])
    rows = np.r_[np.arange(o), np.full(2 * N_BOX_SAMPLES, o)]
    per = ("con_geom_a", "con_geom_b", "kn_base", "n_pts", "mu_base", "kn_base_soft", "a_free",
           "b_free", "a_art", "b_art", "a_sta", "b_sta")
    return dataclasses.replace(
        tables, bb_a=np.array([a], np.int32), bb_b=np.array([b], np.int32),
        bbc_a=np.zeros(0, np.int32), bbc_b=np.zeros(0, np.int32), n_con=len(rows),
        acc_a=tables.acc_a[:, rows], acc_b=tables.acc_b[:, rows],
        **{f: np.asarray(getattr(tables, f))[rows] for f in per})


# ---------------------------------------------------------------------------
# runtime (torch, batched over a leading env/sample axis)
# ---------------------------------------------------------------------------

_BOX_CORNERS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], dtype=np.float32,
)  # (8,3)


def _capsuloid_segment(r, hl, pos, quat, zaxis):
    """Segment endpoints and radius of sphere/capsule geoms: radii r (n,),
    half lengths hl (n,) (0 for a sphere), batched poses (..., n, 3/4).
    Capsule axis = local z."""
    axis = quat_rotate(quat, zaxis.expand(pos.shape))
    return pos - axis * hl[..., None], pos + axis * hl[..., None], r


def _box_points(pts, pos, quat):
    """Box points pts (n,s,3) (a sample table times each box's half extents)
    in the world → (..., n, s, 3)."""
    return pos[..., None, :] + quat_rotate(quat[..., None, :], pts)


def _contact_consts(scene: SceneModel, tables: ContactTables, dt_sub: float) -> dict:
    """The per-candidate constants and static masks of the force law (host
    numpy, float64 where the JAX package computes them in float64)."""
    tau_c = max(2.0 * dt_sub, 1e-3)
    zeta = 1.0
    free_np = _free_body_mask(scene)
    art_np = _articulated_body_mask(scene)
    sta_np = 1.0 - np.maximum(free_np, art_np)
    fb_idx = np.where(tables.con_geom_b >= 0, tables.con_geom_b, tables.con_geom_a)
    ba = scene.geom_body[tables.con_geom_a]
    bb = scene.geom_body[fb_idx]
    return dict(
        kn=tables.kn_base / (tau_c * tau_c),
        kd=2.0 * zeta * tables.kn_base * tau_c / (tau_c * tau_c),
        kn_soft=tables.kn_base_soft / (tau_c * tau_c),
        kd_soft=2.0 * zeta * (tables.kn_base_soft / tau_c).astype(np.float32),
        fb_idx=fb_idx, ba=ba, bb=bb,
        has_b=(tables.con_geom_b >= 0).astype(np.float32),
        rep_a=(sta_np[ba] > 0) & (tables.b_free > 0),
        rep_b=(sta_np[bb] > 0) & (tables.a_free > 0) & (tables.con_geom_b >= 0),
        couple=(((tables.a_free > 0) != (tables.b_free > 0)) & (tables.con_geom_b >= 0))
        | (tables.a_sta > 0) | (tables.b_sta > 0),
    )


def compute_contact_forces(
    scene: SceneModel,
    tables: ContactTables,
    body_pos,
    body_quat,
    body_linvel,
    body_angvel,
    geom_friction_scale,
    dt_sub: float,
):
    """All contact forces of a batch of envs: body poses and velocities
    (N, B, 3/4), friction scales (N, G) → (f_ext (N,B,6) Plücker world,
    net_cf (N,B,3), the contact geometry dict of (N, n_con, ...) tensors, or
    None without candidates)."""
    dev, dt_ = body_pos.device, body_pos.dtype
    lead = body_pos.shape[:-2]
    nb = scene.nbody
    if tables.n_con == 0:
        return (torch.zeros(lead + (nb, 6), dtype=dt_, device=dev),
                torch.zeros(lead + (nb, 3), dtype=dt_, device=dev), None)
    key = f"cc@{dt_sub!r}"
    consts = tables.__dict__.get(key)
    if consts is None:
        consts = tables.__dict__[key] = _contact_consts(scene, tables, dt_sub)

    def T(name, make, dtype=dt_):
        return cached(tables, name, make, dtype, dev)

    def idx(name, arr):
        return T(name, lambda: np.asarray(arr, np.int64), torch.long)

    gb_idx = idx("geom_body", scene.geom_body)
    bq = body_quat[..., gb_idx, :]
    gp = body_pos[..., gb_idx, :] + quat_rotate(bq, T("geom_pos", lambda: scene.geom_pos))
    gq = quat_mul(bq, T("geom_quat", lambda: scene.geom_quat))

    pts, nrms, dpths = [], [], []
    gtypes = scene.geom_type
    sizes = np.asarray(scene.geom_size, np.float32)

    def sel(name, g):
        i = idx(name, g)
        return gp[..., i, :], gq[..., i, :]

    def half(name, g):
        return T(name, lambda: sizes[g])

    zaxis = T("zaxis", lambda: [0.0, 0.0, 1.0])

    def caps(name, g):
        r = T(name + "_r", lambda: sizes[g][:, 0])
        hl = T(name + "_hl", lambda: np.where(gtypes[g] == GEOM_CAPSULE, sizes[g][:, 1], 0.0))
        return _capsuloid_segment(r, hl, *sel(name, g), zaxis)

    def box_pts(name, table, g):
        """The sample `table` (s,3) of boxes g, scaled by their half extents."""
        return T(name + "_pts", lambda: table[None, :, :] * sizes[g][:, None, :])

    # ---- capsuloid vs plane (endpoint-major: all p0 then all p1) ----
    if len(tables.cp_geom):
        g = tables.cp_geom
        p0, p1, r = caps("cp", g)
        for pend in (p0, p1):
            dpths.append(r - pend[..., 2])
            nrms.append(zaxis.expand(pend.shape))
            pts.append(torch.cat([pend[..., :2], pend[..., 2:] - r[:, None]], -1))

    # ---- box vs plane (corner-major) ----
    if len(tables.bp_geom):
        g = tables.bp_geom
        corners = _box_points(box_pts("bp", _BOX_CORNERS, g), *sel("bp", g))   # (...,n,8,3)
        for ci in range(8):
            pt = corners[..., ci, :]
            dpths.append(-pt[..., 2])
            nrms.append(zaxis.expand(pt.shape))
            pts.append(pt)

    # ---- capsuloid vs capsuloid ----
    if len(tables.cc_a):
        ga, gb = tables.cc_a, tables.cc_b
        pa0, pa1, ra = caps("cc_a", ga)
        pb0, pb1, rb = caps("cc_b", gb)
        ca, cb = segment_closest(pa0, pa1, pb0, pb1)
        delta = ca - cb
        dist = torch.linalg.norm(delta, dim=-1)
        normal = delta / torch.clamp(dist, min=1e-9)[..., None]
        depth = (ra + rb) - dist
        pts.append(cb + normal * (rb - 0.5 * torch.clamp(depth, min=0.0))[..., None])
        nrms.append(normal)
        dpths.append(depth)

    # ---- capsuloid vs box (point-major: p0, p1, closest) ----
    if len(tables.cb_cap):
        gc, gx = tables.cb_cap, tables.cb_box
        p0, p1, r = caps("cb_cap", gc)
        bc, bqx = sel("cb_box", gx)
        hx = half("cb_half", gx)
        cp_seg, _ = segment_closest(p0, p1, bc, bc)
        for sp in (p0, p1, cp_seg):
            n_w, depth_c, surf = point_to_box(sp, bc, bqx, hx)
            pts.append(surf)
            nrms.append(n_w)
            dpths.append(depth_c + r)

    # ---- box vs box (sample-major, A-in-B then B-in-A) ----
    if len(tables.bb_a):
        ga, gb = tables.bb_a, tables.bb_b
        pa, qa = sel("bb_a", ga)
        pb, qb = sel("bb_b", gb)
        ha, hb = half("bb_ha", ga), half("bb_hb", gb)
        ca = _box_points(box_pts("bb_a", _BOX_SAMPLES, ga), pa, qa)
        cb = _box_points(box_pts("bb_b", _BOX_SAMPLES, gb), pb, qb)
        for ci in range(N_BOX_SAMPLES):
            n_w, depth_c, surf = point_to_box(ca[..., ci, :], pb, qb, hb)
            pts.append(surf); nrms.append(n_w); dpths.append(depth_c)
        for ci in range(N_BOX_SAMPLES):
            n_w, depth_c, surf = point_to_box(cb[..., ci, :], pa, qa, ha)
            pts.append(surf); nrms.append(-n_w); dpths.append(depth_c)

    # ---- box vs box, reduced directional manifold (sample-major): samples
    # of bbc_a against bbc_b, normal out of the host box, +force on geom a ----
    if len(tables.bbc_a):
        ga, gb = tables.bbc_a, tables.bbc_b
        pa, qa = sel("bbc_a", ga)
        pb, qb = sel("bbc_b", gb)
        hb = half("bbc_hb", gb)
        ca = _box_points(box_pts("bbc_a", _BOX_SAMPLES, ga), pa, qa)
        for ci in range(tables.bbc_samples):
            n_w, depth_c, surf = point_to_box(ca[..., ci, :], pb, qb, hb)
            pts.append(surf); nrms.append(n_w); dpths.append(depth_c)

    point = torch.cat(pts, -2)                     # (..., n_con, 3)
    normal = torch.cat(nrms, -2)
    depth = torch.cat(dpths, -1)

    c = consts
    kn = T("kn", lambda: c["kn"])
    kd = T("kd", lambda: c["kd"])
    fa = geom_friction_scale[..., idx("con_geom_a", tables.con_geom_a)]
    fb = geom_friction_scale[..., idx("fb_idx", c["fb_idx"])]
    mu = T("mu_base", lambda: tables.mu_base) * 0.5 * (fa + fb)

    ba = idx("ba", c["ba"])
    bb = idx("bb", c["bb"])
    has_b = T("has_b", lambda: c["has_b"])

    def point_vel(bidx, p):
        return body_linvel[..., bidx, :] + cross(body_angvel[..., bidx, :], p - body_pos[..., bidx, :])

    v_rel = point_vel(ba, point) - point_vel(bb, point) * has_b[:, None]
    vn = torch.sum(v_rel * normal, -1)
    vt = v_rel - vn[..., None] * normal
    vt_norm = torch.linalg.norm(vt, dim=-1)

    active = depth > 0.0
    depth_c = torch.clamp(depth, max=float(np.float32(scene.max_contact_depth)))
    eps_v = float(np.float32(scene.friction_smoothing_vel))

    def force_with(kn_arr, kd_arr):
        fn = torch.where(active, torch.clamp(kn_arr * depth_c - kd_arr * vn, min=0.0), 0.0)
        ft = -(mu * fn / torch.clamp(vt_norm, min=eps_v))[..., None] * vt
        return fn[..., None] * normal + ft, fn

    # side-asymmetric penalty: the stiff (couple) stiffness felt by fixed
    # bodies, the mass-scaled stiffness felt by free bodies; the dynamic
    # articulated side of a couple contact gets no explicit force here (its
    # reaction enters the articulated velocity solve implicitly, in
    # stacked_substep)
    force_stiff, fn_stiff = force_with(kn, kd)
    force_soft, _ = force_with(T("kn_soft", lambda: c["kn_soft"]), T("kd_soft", lambda: c["kd_soft"]))
    af = T("a_free", lambda: tables.a_free)[:, None] > 0
    bf = T("b_free", lambda: tables.b_free)[:, None] > 0
    a_cpl = T("a_art", lambda: tables.a_art)[:, None] > 0
    b_cpl = T("b_art", lambda: tables.b_art)[:, None] > 0
    force_a = torch.where(af, force_soft, torch.where(a_cpl, 0.0, force_stiff))
    force_b = torch.where(bf, force_soft, torch.where(b_cpl, 0.0, force_stiff))
    plk_a = torch.cat([cross(point, force_a), force_a], -1)
    plk_b = torch.cat([cross(point, force_b), force_b], -1)
    acc_a = T("acc_a", lambda: tables.acc_a)
    acc_b = T("acc_b", lambda: tables.acc_b)
    f_ext = acc_a @ plk_a - acc_b @ plk_b
    # reported net contact force: the static side of a free↔static pair
    # mirrors the free side's soft force (the reaction of what is applied)
    rep_a = torch.where(T("rep_a", lambda: c["rep_a"], torch.bool)[:, None], force_soft, force_a)
    rep_b = torch.where(T("rep_b", lambda: c["rep_b"], torch.bool)[:, None], force_soft, force_b)
    net_cf = acc_a @ rep_a - acc_b @ rep_b
    # fn_stiff rides along for couple candidates and art↔static stiction
    # candidates (the impulse pass seeds their friction cones with it)
    couple = T("couple", lambda: c["couple"])
    contact_geom = {"point": point, "normal": normal, "depth": depth, "mu": mu,
                    "fn_stiff": fn_stiff * couple}
    return f_ext, net_cf, contact_geom


def _impulse_consts(scene: SceneModel, tables: ContactTables, two_way: bool) -> dict:
    """The impulse pass's static routing (host numpy)."""
    free = _free_body_mask(scene)
    ba = scene.geom_body[tables.con_geom_a]
    fb_idx = np.where(tables.con_geom_b >= 0, tables.con_geom_b, tables.con_geom_a)
    bb = scene.geom_body[fb_idx]
    has_b = (tables.con_geom_b >= 0).astype(np.float32)
    a_free = free[ba]
    b_free = free[bb] * has_b
    if two_way:
        a_art = np.maximum(tables.a_art, tables.a_sta)
        b_art = np.maximum(tables.b_art, tables.b_sta)
        is_sta = np.maximum(tables.a_sta, tables.b_sta)
    else:
        a_art = np.zeros_like(a_free)
        b_art = np.zeros_like(b_free)
        is_sta = np.zeros_like(a_free)
    touched = (a_free + b_free + a_art + b_art) > 0
    B = scene.nbody
    inv_m = np.zeros(B, np.float32)
    I_loc = np.zeros((B, 3, 3), np.float32)
    for ai, a in enumerate(scene.actors):
        if a.ndof == 0 and not a.fixed_base:
            b = scene.body_offset[ai]
            inv_m[b] = 1.0 / max(float(a.mass[0]), 1e-6)
            I_loc[b] = np.linalg.inv(a.inertia[0] + np.eye(3) * 1e-9)
    # articulated mass-splitting counts per ACTOR (feet share a base)
    art_act_idx = np.zeros(tables.n_con, np.int64)
    A_act = np.zeros((scene.nactor, tables.n_con), np.float32)
    for c_ in range(tables.n_con):
        if a_art[c_] > 0:
            aid_ = int(scene.body_actor[ba[c_]])
        elif b_art[c_] > 0:
            aid_ = int(scene.body_actor[bb[c_]])
        else:
            continue
        art_act_idx[c_] = aid_
        A_act[aid_, c_] = 1.0
    # stiction snap routing (couple contacts: which side is the free body)
    couple_a = (a_free > 0) & (b_art > 0)
    couple_b = (b_free > 0) & (a_art > 0)
    couple = couple_a | couple_b
    body_free = np.where(couple_a, ba, bb)
    O_snap = np.zeros((B, tables.n_con), np.float32)
    O_snap[body_free[couple], np.arange(tables.n_con)[couple]] = 1.0
    sta2 = 1.0 - np.maximum(free, _articulated_body_mask(scene))
    a_sta_rep = ((sta2[ba] > 0) & (b_free > 0)).astype(np.float32)
    b_sta_rep = ((sta2[bb] > 0) & (a_free > 0) & (tables.con_geom_b >= 0)).astype(np.float32)
    return dict(
        free=free, ba=ba, bb=bb, has_b=has_b, a_free=a_free, b_free=b_free, a_art=a_art,
        b_art=b_art, is_sta=is_sta, touched=touched, inv_m=inv_m, I_loc=I_loc,
        art_act_idx=art_act_idx, A_act=A_act, art_any=np.maximum(a_art, b_art),
        snap=bool(two_way and (a_art + b_art).any()), couple=couple, O_snap=O_snap,
        e_snap=np.where(couple_a, 1.0, -1.0).astype(np.float32), couple_a=couple_a,
        acc_a_rep=tables.acc_a * (a_free + a_art + a_sta_rep)[None, :],
        acc_b_rep=tables.acc_b * (b_free + b_art + b_sta_rep)[None, :],
    )


def impulse_contact_pass(
    scene: SceneModel,
    tables: ContactTables,
    contact_geom,
    body_pos,
    body_quat,
    body_linvel,        # (N,B,3) post-solve velocities
    body_angvel,
    mass_scale,         # (N,B) randomization multipliers
    dt: float,
    iters: int = 16,
    beta: float = 0.2,
    slop: float = 2e-3,
    psi=None,           # (N,B,6,6) articulated operational-space inverse inertia
    art_apply=None,     # Y (N,B,6) → ΔV (N,B,6): the exact generalized response
    lam_warm=None,      # (N,n_con,4) [λ_n, λ_t] persistent-contact warm start
):
    """Velocity-impulse contact resolution for free rigid bodies, with the
    optional two-way coupling of articulated actors (`psi`, `art_apply`) and
    the warm start from the previous substep's impulses (`lam_warm`): Jacobi
    sweeps with mass splitting, Baumgarte stabilization, a friction cone and
    the stiction snap of couple contacts — the JAX package's pass, batched
    over the leading axis.

    Returns (new_linvel (N,B,3), new_angvel (N,B,3), net_cf (N,B,3),
    Y_total (N,B,6), lam_out (N,n_con,4))."""
    dev, dt_ = body_pos.device, body_pos.dtype
    lead = body_pos.shape[:-2]
    B = scene.nbody

    def nothing():
        return (body_linvel, body_angvel, torch.zeros_like(body_pos),
                torch.zeros(lead + (B, 6), dtype=dt_, device=dev),
                torch.zeros(lead + (tables.n_con, 4), dtype=dt_, device=dev))

    if contact_geom is None or tables.n_con == 0:
        return nothing()
    two_way = psi is not None
    key = f"imp@{two_way}"
    c = tables.__dict__.get(key)
    if c is None:
        c = tables.__dict__[key] = _impulse_consts(scene, tables, two_way)
    if not c["touched"].any():
        return nothing()
    pfx = f"imp{int(two_way)}_"

    def T(name, make, dtype=dt_):
        return cached(tables, pfx + name, make, dtype, dev)

    def idx(name):
        return T(name, lambda: np.asarray(c[name], np.int64), torch.long)

    ba, bb = idx("ba"), idx("bb")
    point = contact_geom["point"]
    normal = contact_geom["normal"]
    depth = torch.clamp(contact_geom["depth"], max=float(np.float32(scene.max_contact_depth)))
    mu = contact_geom["mu"]
    fn_seed = contact_geom["fn_stiff"]
    active = (depth > 0.0) & T("touched", lambda: c["touched"], torch.bool)
    act_f = active.to(dt_)

    inv_m_t = T("inv_m", lambda: c["inv_m"]) / torch.clamp(mass_scale, min=1e-6)
    R = quat_to_matrix(body_quat)
    inv_I_w = torch.einsum("...bij,bjk,...blk->...bil", R, T("I_loc", lambda: c["I_loc"]), R) \
        / torch.clamp(mass_scale, min=1e-6)[..., None, None]

    r_a = point - body_pos[..., ba, :]
    r_b = point - body_pos[..., bb, :]
    amask = T("a_free", lambda: c["a_free"])
    bmask = T("b_free", lambda: c["b_free"])
    amask_art = T("a_art", lambda: c["a_art"])
    bmask_art = T("b_art", lambda: c["b_art"])
    iIa = inv_I_w[..., ba, :, :]
    iIb = inv_I_w[..., bb, :, :]
    psi_a = psi[..., ba, :, :] if two_way else None
    psi_b = psi[..., bb, :, :] if two_way else None

    def k_dir(d):
        """Effective inverse mass along direction d (..., n, 3)."""
        xa, xb = cross(r_a, d), cross(r_b, d)
        ka = inv_m_t[..., ba] + torch.einsum("...ni,...nij,...nj->...n", xa, iIa, xa)
        kb = inv_m_t[..., bb] + torch.einsum("...ni,...nij,...nj->...n", xb, iIb, xb)
        k = amask * ka + bmask * kb
        if two_way:
            # articulated side: XᵀΨX with X = (p×d, d) about the world origin
            X = torch.cat([cross(point, d), d], -1)
            k = k + amask_art * torch.einsum("...ni,...nij,...nj->...n", X, psi_a, X)
            k = k + bmask_art * torch.einsum("...ni,...nij,...nj->...n", X, psi_b, X)
        return k

    k_n = torch.clamp(k_dir(normal), min=1e-9)
    # depenetration velocity cap
    target = torch.clamp(beta * torch.clamp(depth - slop, min=0.0) / dt, max=0.5)

    acc_a = T("acc_a", lambda: tables.acc_a)
    acc_b = T("acc_b", lambda: tables.acc_b)
    A_a = T("A_a", lambda: tables.acc_a * c["a_free"][None, :])
    A_b = T("A_b", lambda: tables.acc_b * c["b_free"][None, :])
    A_a_art = T("A_a_art", lambda: tables.acc_a * c["a_art"][None, :])
    A_b_art = T("A_b_art", lambda: tables.acc_b * c["b_art"][None, :])
    relax = 0.9
    Y_total = torch.zeros(lead + (B, 6), dtype=dt_, device=dev)

    def apply_imp(imp, lin, ang, Y_total):
        """Per-candidate world impulses (..., n, 3) at `point` onto the free
        bodies (A +imp, B −imp) and the articulated links (two-way)."""
        dlin = (A_a @ imp - A_b @ imp) * inv_m_t[..., None]
        dang_t = A_a @ cross(r_a, imp) + A_b @ cross(r_b, -imp)
        dang = torch.einsum("...bij,...bj->...bi", inv_I_w, dang_t)
        lin = lin + dlin
        ang = ang + dang
        if two_way:
            Yimp = torch.cat([cross(point, imp), imp], -1)
            Y_iter = A_a_art @ Yimp - A_b_art @ Yimp
            Y_total = Y_total + Y_iter
            if art_apply is not None:
                dV = art_apply(Y_iter)
            else:
                dV = torch.einsum("...bij,...bj->...bi", psi, Y_iter)
            dw = dV[..., :3]
            lin = lin + dV[..., 3:] + cross(dw, body_pos)
            ang = ang + dw
        return lin, ang, Y_total

    lin, ang = body_linvel, body_angvel
    if lam_warm is not None:
        lam_n = lam_warm[..., 0] * act_f
        lam_t = lam_warm[..., 1:4] * act_f[..., None]
        lin, ang, Y_total = apply_imp(normal * lam_n[..., None] + lam_t, lin, ang, Y_total)
    else:
        lam_n = torch.zeros(lead + (tables.n_con,), dtype=dt_, device=dev)
        lam_t = torch.zeros(lead + (tables.n_con, 3), dtype=dt_, device=dev)

    has_b = T("has_b", lambda: c["has_b"])[:, None]
    # mass-splitting counts: the active set is fixed over the sweeps
    count = act_f @ acc_a.T + act_f @ acc_b.T                         # (..., B)
    count_act = act_f @ T("A_act", lambda: c["A_act"]).T             # (..., A)
    n_eff = torch.clamp(amask * count[..., ba] + bmask * count[..., bb]
                        + T("art_any", lambda: c["art_any"]) * count_act[..., idx("art_act_idx")],
                        min=1.0)
    # art↔static stiction candidates are friction-only
    normal_on = active & (T("is_sta", lambda: c["is_sta"]) == 0.0)
    cap_seed = fn_seed * dt
    for _ in range(iters):
        va = lin[..., ba, :] + cross(ang[..., ba, :], r_a)
        vb = lin[..., bb, :] + cross(ang[..., bb, :], r_b)
        v_rel = va - vb * has_b
        vn = torch.sum(v_rel * normal, -1)
        d_lam = torch.where(normal_on, -(vn - target) / (k_n * n_eff) * relax, 0.0)
        new_lam = torch.clamp(lam_n + d_lam, min=0.0)
        imp = normal * (new_lam - lam_n)[..., None]
        lam_n = new_lam
        # friction: tangential impulse, cone-projected against λ_n
        vt = v_rel - vn[..., None] * normal
        k_t = torch.clamp(k_dir(vt / torch.clamp(torch.linalg.norm(vt, dim=-1, keepdim=True), min=1e-9)),
                          min=1e-9)
        jt = torch.where(active[..., None], -vt / (k_t * n_eff)[..., None], 0.0)
        lam_t_new = lam_t + jt
        lt_norm = torch.linalg.norm(lam_t_new, dim=-1)
        cap = mu * (lam_n + cap_seed)
        scale = torch.clamp(cap / torch.clamp(lt_norm, min=1e-9), max=1.0)
        lam_t_new = lam_t_new * scale[..., None]
        imp = imp + (lam_t_new - lam_t)
        lam_t = lam_t_new
        lin, ang, Y_total = apply_imp(imp, lin, ang, Y_total)

    if c["snap"]:
        # stiction snap (couple contacts): one 6×6 least-squares per free
        # body matching its rigid motion to the articulated side at all
        # sticking couple points
        va = lin[..., ba, :] + cross(ang[..., ba, :], r_a)
        vb_ = lin[..., bb, :] + cross(ang[..., bb, :], r_b)
        v_rel = va - vb_ * has_b
        lt_norm = torch.linalg.norm(lam_t, dim=-1)
        cap = mu * (lam_n + cap_seed)
        stick = (lt_norm < 0.98 * cap) & active
        w = torch.where(stick & T("couple", lambda: c["couple"], torch.bool), 1.0, 0.0)
        r_free = torch.where(T("couple_a", lambda: c["couple_a"], torch.bool)[:, None], r_a, r_b)
        eye3 = T("eye3", lambda: np.eye(3))
        X_snap = torch.cat([-_skew(r_free), eye3.expand(r_free.shape[:-1] + (3, 3))], -1)  # (...,n,3,6)
        P = eye3 - normal[..., :, None] * normal[..., None, :]
        XP = torch.einsum("...nij,...nik->...njk", X_snap, P)
        A_c = torch.einsum("...njk,...nkl->...njl", XP, X_snap)
        b_c = -torch.einsum("...njk,...nk->...nj", XP, T("e_snap", lambda: c["e_snap"])[:, None] * v_rel)
        Ow = T("O_snap", lambda: c["O_snap"]) * w[..., None, :]          # (...,B,n)
        A_acc = torch.einsum("...bn,...njk->...bjk", Ow, A_c)
        b_acc = torch.einsum("...bn,...nj->...bj", Ow, b_c)
        nstick = torch.sum(Ow, -1)
        A_reg = A_acc + T("eye6", lambda: np.eye(6)) * 1e-4
        xi = solve_psd(A_reg, b_acc)
        gate = (nstick > 0).to(dt_)[..., None] * T("free", lambda: c["free"])[:, None]
        # the snap only finishes convergence: clamped hard
        xi = torch.clamp(xi, -0.05, 0.05) * gate
        ang = ang + xi[..., :3]
        lin = lin + xi[..., 3:]

    lin = torch.clamp(lin, -scene.max_root_linvel, scene.max_root_linvel)
    ang = torch.clamp(ang, -scene.max_root_angvel, scene.max_root_angvel)
    imp_tot = normal * lam_n[..., None] + lam_t
    # static bodies also report the reaction of the impulses their free
    # partner received
    net_cf_imp = (T("acc_a_rep", lambda: c["acc_a_rep"]) @ imp_tot
                  - T("acc_b_rep", lambda: c["acc_b_rep"]) @ imp_tot) / dt
    lam_out = torch.cat([lam_n[..., None], lam_t], -1)
    return lin, ang, net_cf_imp, Y_total, lam_out
