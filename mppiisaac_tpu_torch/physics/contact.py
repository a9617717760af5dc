"""Static contact candidate tables (host-side numpy).

The table builder of the JAX package's `physics/contact.py`, carried over
unchanged so that the candidate order — and with it every pair block and
persistent-λ row — is the same in both packages. The runtime narrowphase
and force law live in `ops/fused_physics.py` (the plain twin) and in the
CUDA kernels.

Force law per contact point (normal n from B→A, depth d > 0 penetrating):
    kn = m_eff / (τ² · n_pts),  kd = 2 ζ m_eff / (τ · n_pts)
    f_n = max(0, kn·d − kd·v_n),  f_t = −μ f_n · v_t/(‖v_t‖ + ε_v)
with τ tied to the substep dt (MuJoCo solref-style).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from .scene_model import SceneModel
from .urdf import GEOM_BOX


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
