# Frozen copy of mppiisaac_tpu_torch/ops/fused_physics.py, part of the benchmark's yardstick.
"""The fused physics substep: host contact plan, kernel scene tables, and the
plain PyTorch twin of the CUDA device code.

Counterpart of the JAX package's `ops/pallas/fused_physics.py`:

* `build_pair_blocks` / `pair_blocks` / `swept_blocks` / `free_cand_indices`
  — the static pair-block contact plan, carried over unchanged (numpy), so
  the block and candidate order match the JAX package by construction.
* `KernelScene` — the plan and the articulation packed into flat per-actor,
  per-body, per-dof, per-geom and per-block tables. The CUDA kernels
  (csrc/*.cu, *.cuh) read exactly these tables, and so does the twin: one
  table-driven build serves every scene. Where the scene needs a feature that
  this port does not have yet, `KernelScene.build` raises NotImplementedError
  naming it; it never substitutes another computation.
* `fk`, `dynamics`, `substep`, `task_cost`, `command_targets` — the plain
  twin of the kernels' device code, batched over a leading sample axis K. It
  mirrors `fk_lanes` and `dynamics_lanes` at world and fast fidelity (RNEA bias, CRBA,
  drives, fixed and floating bases, free single bodies, Cholesky, deferred
  integration); the contacts are in `fused_contacts`, the couple terms,
  impulse sweeps and stiction snap in `fused_impulse`. The CPU path of the
  kernel wrappers runs it, and the kernels are held against it on the card.

The articulated solves are indexed by velocity coordinate: an actor's nv
coordinates are its 6 base coordinates (a floating base: the root body's
Plücker velocity (ω, v_O)) and then its dofs, and the actors' coordinates
follow one another (`actor_v0`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..physics.contact import _BOX_SAMPLES, N_BOX_SAMPLES, _articulated_body_mask, _free_body_mask
from ..physics.dynamics import build_actor_masks
from ..physics.math3d import (
    cholesky_factor,
    cholesky_solve_factored,
    cross,
    dot,
    euler_zyx_atan2,
    qintegrate,
    quat_from_axis_angle,
    quat_mul,
    quat_rotate,
    quat_to_matrix,
    quat_to_yaw,
)
from ..physics.model import (
    DRIVE_EFFORT,
    DRIVE_NONE,
    DRIVE_POSITION,
    DRIVE_VELOCITY,
    JOINT_FIXED,
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
)
from ..physics.stacked import MU_SPINDLE
from ..physics.urdf import GEOM_BOX, GEOM_CAPSULE
from .fused_contacts import (
    F_A_ART,
    F_A_FREE,
    F_A_STA,
    F_B_ART,
    F_B_FREE,
    F_B_STA,
    F_EMIT_A,
    F_EMIT_B,
    F_HAS_B,
    F_SLAB,
    F_SWEPT,
    GATE_MARGIN,
    KIND_CP,
    KIND_NAMES,
    SweptGeo,
    contacts,
)
from .fused_impulse import couple_terms, impulse_pass, psi_blocks

# task ids of the kernels' cost hook (csrc/fused_rollout.cu task_cost)
TASK_PANDA_REACH = 1
TASK_PANDA_PICK = 2
TASK_MOBILE_REACH = 3
TASK_MOBILE_PUSH = 4
TASK_POINT_ROBOT = 5
TASK_MULTI_ROBOT = 6
TASK_STICK_PUSH = 7
TASK_OMNI_PICK = 8
TASK_ALBERT = 9
TASK_ANYMAL = 10
TASKS = (TASK_PANDA_REACH, TASK_PANDA_PICK, TASK_MOBILE_REACH, TASK_MOBILE_PUSH,
         TASK_POINT_ROBOT, TASK_MULTI_ROBOT, TASK_STICK_PUSH, TASK_OMNI_PICK, TASK_ALBERT,
         TASK_ANYMAL)
MAX_XY = 4          # obstacles or robots of a cost (CostSpec.xy_*)
N_POSE = 9          # pose constants of TASK_OMNI_PICK (7 arm + 2 finger)
MAX_HT = 8          # height terms of TASK_ANYMAL (CostSpec.ht_*)


def _t3(a):
    return (float(a[0]), float(a[1]), float(a[2]))


def _geom_bound(scene, g) -> float:
    """Host-side bounding-sphere radius of geom g about its BODY origin."""
    gt = int(scene.geom_type[g])
    s = np.asarray(scene.geom_size[g], np.float32)
    off = float(np.linalg.norm(np.asarray(scene.geom_pos[g], np.float32)))
    if gt == GEOM_BOX:
        r = float(np.linalg.norm(s[:3]))
    elif gt == GEOM_CAPSULE:
        r = float(s[0]) + float(s[1])
    else:
        r = float(s[0])
    return off + r


# ---------------------------------------------------------------------------
# host contact plan (unchanged from the JAX package)
# ---------------------------------------------------------------------------

def build_pair_blocks(scene, tables):
    """Static contact plan: one block per (kind, geom-pair), each covering the
    S manifold samples of that pair. Table row indices per block follow the
    flat candidate order of physics/contact.py (sample-major within kinds), so
    kn/mu/flags can be read off the flat tables — they are constant within a
    block by construction (same pair → same bodies/materials).

    Returns (blocks, sconst): box-sample local offsets packed into one flat
    f32 table `sconst` (per block: [x·S, y·S, z·S] at blk["sc_off"])."""
    blocks: List[dict] = []
    sconst: List[float] = []
    o = 0
    ncp = len(tables.cp_geom)
    nbp = len(tables.bp_geom)
    ncc = len(tables.cc_a)
    ncb = len(tables.cb_cap)
    nbb = len(tables.bb_a)
    nbbc = len(tables.bbc_a)
    free_np = _free_body_mask(scene)
    art_np = _articulated_body_mask(scene)

    def add(kind, ga, gb, S, rows):
        rows = np.asarray(rows, np.int64)
        r0 = int(rows[0])
        if not (np.allclose(tables.kn_base[rows], tables.kn_base[r0])
                and np.allclose(tables.mu_base[rows], tables.mu_base[r0])):
            raise ValueError(f"pair block {kind} ({ga},{gb}) mixes materials")
        ga_geom = int(tables.con_geom_a[r0])
        gb_geom = int(tables.con_geom_b[r0])
        has_b = gb_geom >= 0
        ba = int(scene.geom_body[ga_geom])
        bb = int(scene.geom_body[gb_geom]) if has_b else -1
        blk = dict(
            kind=kind, ga=int(ga), gb=int(gb), S=int(S), rows=rows,
            ga_geom=ga_geom, gb_geom=gb_geom, ba=ba, bb=bb, has_b=has_b,
            kn=float(tables.kn_base[r0]),
            kn_soft=float(tables.kn_base_soft[r0]),
            mu0=float(tables.mu_base[r0]),
            a_free=bool(tables.a_free[r0] > 0),
            b_free=bool(has_b and tables.b_free[r0] > 0),
            a_art=bool(tables.a_art[r0] > 0),
            b_art=bool(has_b and tables.b_art[r0] > 0),
            a_sta=bool(tables.a_sta[r0] > 0),
            b_sta=bool(has_b and tables.b_sta[r0] > 0),
            npts=float(tables.n_pts[r0]) if len(tables.n_pts) else 4.0,
        )
        blk["swept"] = blk["a_free"] or blk["b_free"] or blk["a_sta"] or blk["b_sta"]
        # STATIC (fixed, non-articulated) side flags: its net_cf report for a
        # free partner mirrors the free side's soft force
        blk["a_static"] = bool(free_np[ba] == 0 and art_np[ba] == 0)
        blk["b_static"] = bool(has_b and free_np[bb] == 0 and art_np[bb] == 0)
        # free-side body mass for couple blocks — the damper cap scale
        if blk["a_art"] or blk["b_art"]:
            ob = bb if blk["a_art"] else ba
            ai_o = int(scene.body_actor[ob])
            blk["m_oth"] = float(scene.actors[ai_o].mass[ob - scene.body_offset[ai_o]])
            blk["ob"] = ob
        # box-sample offset table rows (bp/bbA/bbc sample ga's box; bbB gb's)
        if kind in ("bp", "bbA", "bbB", "bbc"):
            host = ga if kind != "bbB" else gb
            sg = _BOX_SAMPLES[:S] * np.asarray(_t3(scene.geom_size[host]), np.float32)
            blk["sc_off"] = len(sconst)
            for i in range(3):
                sconst.extend(float(v) for v in sg[:, i])
        blocks.append(blk)

    for p, g in enumerate(tables.cp_geom.tolist()):
        add("cp", g, -1, 2, [o + w * ncp + p for w in range(2)])
    o += 2 * ncp
    for p, g in enumerate(tables.bp_geom.tolist()):
        add("bp", g, -1, 8, [o + ci * nbp + p for ci in range(8)])
    o += 8 * nbp
    for p, (ga, gb) in enumerate(zip(tables.cc_a.tolist(), tables.cc_b.tolist())):
        add("cc", ga, gb, 1, [o + p])
    o += ncc
    for p, (ga, gb) in enumerate(zip(tables.cb_cap.tolist(), tables.cb_box.tolist())):
        add("cb", ga, gb, 3, [o + w * ncb + p for w in range(3)])
    o += 3 * ncb
    for p, (ga, gb) in enumerate(zip(tables.bb_a.tolist(), tables.bb_b.tolist())):
        add("bbA", ga, gb, N_BOX_SAMPLES, [o + ci * nbb + p for ci in range(N_BOX_SAMPLES)])
    o += N_BOX_SAMPLES * nbb
    for p, (ga, gb) in enumerate(zip(tables.bb_a.tolist(), tables.bb_b.tolist())):
        add("bbB", ga, gb, N_BOX_SAMPLES, [o + ci * nbb + p for ci in range(N_BOX_SAMPLES)])
    o += N_BOX_SAMPLES * nbb
    for p, (ga, gb) in enumerate(zip(tables.bbc_a.tolist(), tables.bbc_b.tolist())):
        add("bbc", ga, gb, tables.bbc_samples,
            [o + ci * nbbc + p for ci in range(tables.bbc_samples)])
    o += tables.bbc_samples * nbbc
    if o != tables.n_con:
        raise ValueError(f"pair blocks cover {o} candidates, tables hold {tables.n_con}")
    return blocks, np.asarray(sconst, np.float32)


def pair_blocks(scene, tables):
    """Cached build_pair_blocks (the plan is static per tables instance)."""
    cached = getattr(tables, "_pair_blocks", None)
    if cached is None:
        cached = build_pair_blocks(scene, tables)
        tables._pair_blocks = cached
    return cached


def swept_blocks(scene, tables):
    """Pair blocks participating in the impulse pass, in batched block order."""
    return [blk for blk in pair_blocks(scene, tables)[0] if blk["swept"]]


def free_cand_indices(scene, tables) -> np.ndarray:
    """Flat contact-table indices of the impulse-pass candidates, in batched
    block order (concatenated per-block sample rows): the map from the world
    step's persistent-λ rows onto SimState.contact_lam."""
    out: List[int] = []
    for blk in swept_blocks(scene, tables):
        out.extend(blk["rows"].tolist())
    return np.asarray(out, np.int64)


def n_free_cands(scene, tables) -> int:
    """Impulse-pass candidates of the scene: its λ rows per sample / 4."""
    return len(free_cand_indices(scene, tables))


# ---------------------------------------------------------------------------
# kernel scene tables
# ---------------------------------------------------------------------------

@dataclass
class CostSpec:
    """The kernels' task cost: which `task_cost` branch, and its constants.

    TASK_PANDA_REACH: w_dist·‖ee − goal‖ + w_ori·‖(pitch, yaw)‖.
    TASK_PANDA_PICK: w_dist·‖ee − block‖ + w_block·‖block − goal‖
    + w_force·F + w_ori·‖(pitch, yaw)‖.
    TASK_MOBILE_REACH: w_dist·‖xy − (goal_x, goal_y)‖ + w_force·F, xy the
    root position of actor xy_actor or, when xy_dof ≥ 0, q[xy_dof : xy_dof+2].
    TASK_MOBILE_PUSH: w_dist·‖ee − block‖ + w_block·‖goal − block‖
    + w_ori·|yaw(block) − goal_yaw| + w_align·(cos∠(ee − block, goal − block) + 1)
    + w_force·F + w_vel·‖v_block‖, all in the xy plane.
    TASK_POINT_ROBOT: w_dist·‖xy − (goal_x, goal_y)‖ + w_pair·Σ_i 1 /
    max(‖xy − p_i‖, 1e-3) + w_force·F, xy = q[xy_dof : xy_dof+2], p_i the root
    xy of obstacle actor xy_actors[i].
    TASK_MULTI_ROBOT: Σ_i w_dist·‖xy_i − xy_goals[i]‖ + Σ_{i<j} w_pair·
    max(min_sep − ‖xy_i − xy_j‖, 0), xy_i = q[xy_dofs[i] : +2] where
    xy_dofs[i] ≥ 0, else the root xy of actor xy_actors[i].
    TASK_STICK_PUSH: w_dist·‖ee − block‖ + w_block·‖goal − block‖ + w_force·F
    + w_ori·‖(pitch, yaw)‖ + w_height·|ee_z − block_z| + w_align·(cos∠(ee −
    block, goal − block) + 1), the angle in the xy plane.
    TASK_OMNI_PICK: w_dist·‖ee − block‖ + w_block·‖block − goal‖ + w_force·F
    + w_ori·‖(pitch, yaw)‖ + w_base_vel·Σ_{i<3} qd_i² + w_arm_vel·Σ_{3≤i<10}
    qd_i² + w_pose·Σ_{i<7} (q_{3+i} − pose[i])² + w_grip·Σ_{i<2} (q_{10+i} −
    pose[7+i])² + w_height·max(height_floor − ee_z, 0), dof i of the actor
    whose first dof is dof0 (3 base, 7 arm, 2 finger dofs).
    TASK_ALBERT: w_dist·‖ee − goal‖ + w_ori·‖(roll, pitch)‖ (the EE's yaw
    follows the base, so it is left free).
    TASK_ANYMAL: w_dist·‖ee − goal‖ + Σ_i ht_w[i]·|z(ht_body[i]) − ht_z[i]|,
    ee the base body, the sum over up to MAX_HT (body, height, weight) rows.
    The goal of the 3-D costs is the root of goal_actor. F sums |F_i|,
    i < force_dims, of the net contact force F of each force group: bodies
    force_body0 .. force_body0 + force_nbody − 1, and force2_body0 ..
    force2_body0 + force2_nbody − 1."""
    task: int
    ee_body: int
    goal_actor: int
    w_dist: float
    w_ori: float
    block_actor: int = -1
    force_body0: int = -1
    force_nbody: int = 0
    w_block: float = 0.0
    w_force: float = 0.0
    force2_body0: int = -1
    force2_nbody: int = 0
    force_dims: int = 3
    xy_actor: int = -1
    xy_dof: int = -1
    goal_x: float = 0.0
    goal_y: float = 0.0
    goal_yaw: float = 0.0
    w_align: float = 0.0
    w_vel: float = 0.0
    xy_actors: Tuple[int, ...] = ()             # ≤ MAX_XY
    xy_dofs: Tuple[int, ...] = ()
    xy_goals: Tuple[Tuple[float, float], ...] = ()
    w_pair: float = 0.0
    min_sep: float = 0.0
    w_height: float = 0.0
    height_floor: float = 0.0
    dof0: int = 0
    w_base_vel: float = 0.0
    w_arm_vel: float = 0.0
    w_pose: float = 0.0
    w_grip: float = 0.0
    pose: Tuple[float, ...] = ()                # N_POSE
    ht_body: Tuple[int, ...] = ()               # ≤ MAX_HT
    ht_z: Tuple[float, ...] = ()
    ht_w: Tuple[float, ...] = ()


# actor kinds of the kernel tables (actor_dynamic)
ACTOR_STATIC, ACTOR_ARTICULATED, ACTOR_FREE = 0, 1, 2


@dataclass
class KernelScene:
    """Flat tables of one scene for the fused kernels and their twin."""
    nactor: int
    nbody: int
    ndof: int
    ngeom: int
    nu: int
    gravity_z: float                 # -scene.gravity[2]
    eps_v: float                     # friction smoothing velocity
    max_depth: float                 # penetration cap of the force law
    max_root_linvel: float
    max_root_angvel: float
    grip_force_gate: float           # the finger force gate's threshold
    mu_spindle: float                # effort-finger spindle stiction (physics/stacked.py)
    # actors
    actor_body0: np.ndarray
    actor_nbody: np.ndarray
    actor_dof0: np.ndarray
    actor_ndof: np.ndarray
    actor_dynamic: np.ndarray        # ACTOR_STATIC / _ARTICULATED / _FREE (single body)
    actor_gravity: np.ndarray        # 1: gravity acts on the actor
    actor_invm: np.ndarray           # free bodies: 1 / mass
    actor_iinv: np.ndarray           # (A,9) free bodies: body-frame inverse inertia
    actor_base: np.ndarray           # articulated: 6 floating base, 0 fixed base
    actor_v0: np.ndarray             # articulated: first velocity coordinate
    actor_nv: np.ndarray             # articulated: velocity coordinates (base + ndof)
    # bodies (global indices)
    body_parent: np.ndarray          # -1 for roots
    body_actor: np.ndarray
    body_jtype: np.ndarray
    body_dof: np.ndarray             # global dof of the inboard joint, -1 none
    body_jpos: np.ndarray            # (B,3)
    body_jquat: np.ndarray           # (B,4)
    body_jaxis: np.ndarray           # (B,3)
    body_mass: np.ndarray
    body_com: np.ndarray             # (B,3)
    body_inertia: np.ndarray         # (B,3,3)
    body_vmask: np.ndarray           # bit v set: velocity coordinate v moves the body
    body_psi: np.ndarray             # Ψ slot of a couple or stiction contact link, -1 none
    # velocity coordinates
    v_body: np.ndarray               # global body owning each coordinate
    v_anc: np.ndarray                # (V,V) 1: coordinate i ancestor-or-self of j
    # dofs (global)
    dof_mode: np.ndarray
    dof_kp: np.ndarray
    dof_kd: np.ndarray
    dof_effort: np.ndarray
    dof_maxvel: np.ndarray
    dof_damping: np.ndarray
    dof_friction: np.ndarray
    dof_armature: np.ndarray
    dof_lower: np.ndarray
    dof_upper: np.ndarray
    dof_motor: np.ndarray            # 1: effort-mode finger (motor curve, spindle stiction)
    dof_gate_body: np.ndarray        # velocity-driven finger: its link (force gate), -1 none
    cmd_W: np.ndarray               # (D,nu) command map
    # gripper binarize (cmd_map.binarize_dofs), thresholds precomputed
    bin_dof: np.ndarray
    bin_src: np.ndarray
    bin_lo: np.ndarray               # closed target
    bin_hi: np.ndarray               # open target
    bin_th: np.ndarray               # plain threshold (band 0)
    bin_band: np.ndarray
    bin_uhi: np.ndarray              # th + band: open above
    bin_ulo: np.ndarray              # th − band: close below
    bin_qopen: np.ndarray            # lo + 0.75 (hi − lo): finger counts as open
    # geoms
    geom_body: np.ndarray
    geom_type: np.ndarray
    geom_pos: np.ndarray             # (G,3) in the body frame
    geom_quat: np.ndarray            # (G,4)
    geom_size: np.ndarray            # (G,3)
    # pair blocks, in build_pair_blocks order (fused_contacts KIND_*, F_*)
    blk_kind: np.ndarray
    blk_ga: np.ndarray               # geoms
    blk_gb: np.ndarray               # -1: the ground plane
    blk_ba: np.ndarray               # bodies
    blk_bb: np.ndarray
    blk_S: np.ndarray                # manifold samples
    blk_sc: np.ndarray               # offset of the box samples in sconst
    blk_c0: np.ndarray               # first swept candidate (λ row / 4), -1 not swept
    blk_flags: np.ndarray
    blk_ob: np.ndarray               # couple blocks: the free side's body
    blk_thr: np.ndarray              # gate threshold (squared for two-body tests)
    blk_kn: np.ndarray               # kn_base
    blk_kn_a: np.ndarray             # penalty kn_base felt by side a
    blk_kn_b: np.ndarray             # ... by side b
    blk_mu0: np.ndarray
    blk_m_oth: np.ndarray            # couple blocks: free side's mass
    blk_npts: np.ndarray
    sconst: np.ndarray               # box-sample offsets, [x·S, y·S, z·S] per block
    n_fc: int                        # swept candidates (λ rows = 4·n_fc)
    n_con: int                       # contact candidates (rows of SimState.contact_lam)
    cost: Optional[CostSpec] = None

    @property
    def nblk(self) -> int:
        return len(self.blk_kind)

    @property
    def nv(self) -> int:
        return len(self.v_body)

    @property
    def ncp(self) -> int:
        return int(np.sum(self.blk_kind == KIND_CP))

    @property
    def n_state_rows(self) -> int:
        """Rows per sample: 13 per actor root, q, qd, 3 net-force per body."""
        return 13 * self.nactor + 2 * self.ndof + 3 * self.nbody

    @property
    def n_rows(self) -> int:
        """State rows plus 4 λ rows [λ_n, λ_t·3] per swept candidate."""
        return self.n_state_rows + 4 * self.n_fc

    @staticmethod
    def build(built, engine, cost: Optional[CostSpec] = None, tables=None) -> "KernelScene":
        """Pack a BuiltScene + Engine (and the contact tables: the engine's,
        unless `tables` gives others, as the rollout's reduced manifold
        does); raise NotImplementedError on any feature the ported kernels
        lack."""
        scene = built.scene
        tables = engine.tables if tables is None else tables
        blocks, sconst = pair_blocks(scene, tables)
        A = scene.nactor
        actor_dynamic = np.zeros(A, np.int32)
        actor_gravity = np.zeros(A, np.int32)
        actor_invm = np.zeros(A, np.float32)
        actor_iinv = np.zeros((A, 9), np.float32)
        actor_base = np.zeros(A, np.int32)
        for ai, art in enumerate(scene.actors):
            name = scene.actor_names[ai]
            actor_gravity[ai] = 0 if art.disable_gravity else 1
            if art.fixed_base and art.ndof == 0:
                continue                      # static actor
            if not art.fixed_base:
                if art.ndof == 0:
                    if art.nbody > 1:
                        raise NotImplementedError(
                            f"floating actors of several bodies and no joints are not "
                            f"ported (actor {name!r})")
                    actor_dynamic[ai] = ACTOR_FREE
                    actor_invm[ai] = 1.0 / max(float(art.mass[0]), 1e-6)
                    actor_iinv[ai] = np.linalg.inv(art.inertia[0] + np.eye(3) * 1e-9).reshape(9)
                    continue
                actor_base[ai] = 6
            if any(int(art.parent[i]) >= i for i in range(1, art.nbody)) or art.parent[0] >= 0:
                raise NotImplementedError("articulations whose bodies are not in parent-first order")
            actor_dynamic[ai] = ACTOR_ARTICULATED
        st = engine.stacked
        B = scene.nbody
        masks = {ai: build_actor_masks(art) for ai, art in enumerate(scene.actors)
                 if actor_dynamic[ai] == ACTOR_ARTICULATED}
        actor_v0 = np.zeros(A, np.int32)
        actor_nv = np.zeros(A, np.int32)
        NV = 0
        for ai, m in masks.items():
            actor_v0[ai], actor_nv[ai] = NV, m.nv
            NV += m.nv
        v_body = np.zeros(NV, np.int32)
        v_anc = np.zeros((NV, NV), np.int32)
        body_vmask = np.zeros(B, np.int64)
        for ai, m in masks.items():
            bo, v0 = scene.body_offset[ai], actor_v0[ai]
            for j in range(m.nv):
                v_body[v0 + j] = bo + int(m.dof_body[j])
                for k in range(m.nv):
                    v_anc[v0 + j, v0 + k] = int(m.ancestor[j, k])
                for lb in range(scene.actors[ai].nbody):
                    if m.subtree[j, lb]:
                        body_vmask[bo + lb] |= 1 << int(v0 + j)
        # Ψ per articulated contact link of a couple (art↔free) or stiction
        # (floating base↔static) block
        art_bodies = sorted({b["ba"] if (b["a_art"] or b["a_sta"]) else b["bb"]
                             for b in blocks
                             if b["swept"] and (b["a_art"] or b["b_art"] or b["a_sta"] or b["b_sta"])})
        body_psi = np.full(B, -1, np.int32)
        for slot, b in enumerate(art_bodies):
            body_psi[b] = slot

        def f32(x, shape=None):
            a = np.asarray(x, np.float32)
            return a.reshape(shape) if shape is not None else a

        def i32(x):
            return np.asarray(x, np.int32)

        def gate_thr(b):
            ra = _geom_bound(scene, b["ga_geom"])
            if not b["has_b"]:
                return ra + GATE_MARGIN
            if _slab(scene, b):
                return (ra + GATE_MARGIN) * (ra + GATE_MARGIN)
            thr = ra + _geom_bound(scene, b["gb_geom"]) + GATE_MARGIN
            return thr * thr

        def flags(b):
            f = 0
            for bit, on in ((F_HAS_B, b["has_b"]), (F_EMIT_A, not b["a_art"]),
                            (F_EMIT_B, b["has_b"] and not b["b_art"]), (F_SWEPT, b["swept"]),
                            (F_A_FREE, b["a_free"]), (F_B_FREE, b["b_free"]),
                            (F_A_ART, b["a_art"]), (F_B_ART, b["b_art"]), (F_SLAB, _slab(scene, b)),
                            (F_A_STA, b["a_sta"]), (F_B_STA, b["b_sta"])):
                f |= bit if on else 0
            return f

        c0, n_fc = [], 0
        for b in blocks:
            c0.append(n_fc if b["swept"] else -1)
            n_fc += b["S"] if b["swept"] else 0
        a_soft = [b["a_free"] or (b["a_static"] and b["b_free"]) for b in blocks]
        b_soft = [b["b_free"] or (b["b_static"] and b["a_free"]) for b in blocks]
        bz = built.cmd_map.binarize_dofs
        return KernelScene(
            nactor=A, nbody=B, ndof=scene.ndof, ngeom=scene.ngeom, nu=built.cmd_map.nu,
            gravity_z=float(-scene.gravity[2]),
            eps_v=float(scene.friction_smoothing_vel),
            max_depth=float(scene.max_contact_depth),
            max_root_linvel=float(scene.max_root_linvel),
            max_root_angvel=float(scene.max_root_angvel),
            grip_force_gate=float(scene.grip_force_gate), mu_spindle=float(MU_SPINDLE),
            actor_body0=i32(scene.body_offset), actor_nbody=i32([a.nbody for a in scene.actors]),
            actor_dof0=i32(scene.dof_offset), actor_ndof=i32([a.ndof for a in scene.actors]),
            actor_dynamic=actor_dynamic, actor_gravity=actor_gravity,
            actor_invm=actor_invm, actor_iinv=actor_iinv,
            actor_base=actor_base, actor_v0=actor_v0, actor_nv=actor_nv,
            body_parent=i32(st.parent), body_actor=i32(st.body_actor),
            body_jtype=i32(st.jtype), body_dof=i32(st.body_jdof),
            body_jpos=f32(st.jpos), body_jquat=f32(st.jquat), body_jaxis=f32(st.jaxis),
            body_mass=f32(st.mass), body_com=f32(st.com), body_inertia=f32(st.inertia),
            body_vmask=body_vmask, body_psi=body_psi, v_body=v_body, v_anc=v_anc,
            dof_mode=i32(st.drive_mode),
            dof_kp=f32(st.drive_kp), dof_kd=f32(st.drive_kd), dof_effort=f32(st.dof_effort),
            dof_maxvel=f32(st.dof_maxvel), dof_damping=f32(st.dof_damping),
            dof_friction=f32(st.dof_friction), dof_armature=f32(st.dof_armature),
            dof_lower=f32(st.dof_lower), dof_upper=f32(st.dof_upper),
            dof_motor=i32(st.finger_motor > 0), dof_gate_body=i32(st.dof_gate_body),
            cmd_W=f32(built.cmd_map.W, (scene.ndof, built.cmd_map.nu)),
            bin_dof=i32([z[0] for z in bz]), bin_src=i32([z[1] for z in bz]),
            bin_lo=f32([z[2] for z in bz]), bin_hi=f32([z[3] for z in bz]),
            bin_th=f32([z[4] for z in bz]), bin_band=f32([z[5] for z in bz]),
            bin_uhi=f32([z[4] + z[5] for z in bz]), bin_ulo=f32([z[4] - z[5] for z in bz]),
            bin_qopen=f32([z[2] + 0.75 * (z[3] - z[2]) for z in bz]),
            geom_body=i32(scene.geom_body), geom_type=i32(scene.geom_type),
            geom_pos=f32(scene.geom_pos, (-1, 3)), geom_quat=f32(scene.geom_quat, (-1, 4)),
            geom_size=f32(scene.geom_size, (-1, 3)),
            blk_kind=i32([KIND_NAMES[b["kind"]] for b in blocks]),
            blk_ga=i32([b["ga_geom"] for b in blocks]),
            blk_gb=i32([b["gb_geom"] for b in blocks]),
            blk_ba=i32([b["ba"] for b in blocks]), blk_bb=i32([b["bb"] for b in blocks]),
            blk_S=i32([b["S"] for b in blocks]),
            blk_sc=i32([b.get("sc_off", 0) for b in blocks]),
            blk_c0=i32(c0), blk_flags=i32([flags(b) for b in blocks]),
            blk_ob=i32([b.get("ob", -1) for b in blocks]),
            blk_thr=f32([gate_thr(b) for b in blocks]),
            blk_kn=f32([b["kn"] for b in blocks]),
            blk_kn_a=f32([b["kn_soft"] if s else b["kn"] for b, s in zip(blocks, a_soft)]),
            blk_kn_b=f32([b["kn_soft"] if s else b["kn"] for b, s in zip(blocks, b_soft)]),
            blk_mu0=f32([b["mu0"] for b in blocks]),
            blk_m_oth=f32([b.get("m_oth", 0.0) for b in blocks]),
            blk_npts=f32([b["npts"] for b in blocks]),
            sconst=f32(sconst), n_fc=n_fc, n_con=int(tables.n_con),
            cost=cost,
        )


def _slab(scene, b) -> bool:
    """The b side is an unrotated box: the gate tests the exact slab."""
    gb = b["gb_geom"]
    return bool(b["has_b"] and int(scene.geom_type[gb]) == GEOM_BOX
                and np.allclose(np.asarray(scene.geom_quat[gb]), [0, 0, 0, 1], atol=1e-6))


# ---------------------------------------------------------------------------
# state rows: (rows, K) structure-of-arrays, the kernels' layout
# ---------------------------------------------------------------------------

def state_to_rows(ks: KernelScene, root_state, q, qd, lam=None) -> torch.Tensor:
    """(K,A,13), (K,D), (K,D) [, (K,n_fc,4) λ] → (rows, K) with zero
    net-force rows; λ rows follow the state rows when `lam` is given."""
    K = q.shape[0]
    z = torch.zeros(K, 3 * ks.nbody, dtype=q.dtype, device=q.device)
    parts = [root_state.reshape(K, 13 * ks.nactor), q, qd, z]
    if lam is not None:
        parts.append(lam.reshape(K, 4 * ks.n_fc))
    return torch.cat(parts, dim=1).T.contiguous()


def rows_to_state(ks: KernelScene, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(rows, K) → dict of (K, ...) tensors (the twin's state); "lam"
    (K,n_fc,4) when the rows carry λ."""
    A, D, B = ks.nactor, ks.ndof, ks.nbody
    NS = ks.n_state_rows
    x = rows.T
    root = x[:, : 13 * A].reshape(-1, A, 13)
    st = {
        "root_pos": root[..., 0:3], "root_quat": root[..., 3:7],
        "root_linvel": root[..., 7:10], "root_angvel": root[..., 10:13],
        "q": x[:, 13 * A: 13 * A + D], "qd": x[:, 13 * A + D: 13 * A + 2 * D],
        "net_cf": x[:, 13 * A + 2 * D: NS].reshape(-1, B, 3),
    }
    if rows.shape[0] > NS:
        st["lam"] = x[:, NS:].reshape(-1, ks.n_fc, 4)
    return st


def state_dict_to_rows(st: Dict[str, torch.Tensor]) -> torch.Tensor:
    K = st["q"].shape[0]
    root = torch.cat([st["root_pos"], st["root_quat"], st["root_linvel"], st["root_angvel"]], -1)
    parts = [root.reshape(K, -1), st["q"], st["qd"], st["net_cf"].reshape(K, -1)]
    if "lam" in st:
        parts.append(st["lam"].reshape(K, -1))
    return torch.cat(parts, 1).T


# ---------------------------------------------------------------------------
# plain twin of the device code, batched over K
# ---------------------------------------------------------------------------

def _c(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def fk(ks: KernelScene, st) -> Tuple[List, List, List, List, List]:
    """Per-body (K,3)/(K,4) lists: pos, quat, linvel, angvel, world joint axis
    (fk_lanes: revolute, prismatic and fixed joints)."""
    B = ks.nbody
    pos: List = [None] * B
    quat: List = [None] * B
    linv: List = [None] * B
    angv: List = [None] * B
    axis_w: List = [None] * B
    ref = st["root_pos"][:, 0]
    x_axis = _c([1.0, 0.0, 0.0], ref).expand(ref.shape[0], 3)
    for g in range(B):
        p = int(ks.body_parent[g])
        if p < 0:
            a = int(ks.body_actor[g])
            pos[g] = st["root_pos"][:, a]
            quat[g] = st["root_quat"][:, a]
            linv[g] = st["root_linvel"][:, a]
            angv[g] = st["root_angvel"][:, a]
            axis_w[g] = x_axis
            continue
        jp = _c(ks.body_jpos[g], ref)
        jq = _c(ks.body_jquat[g], ref)
        ax = _c(ks.body_jaxis[g], ref)
        fpos = pos[p] + quat_rotate(quat[p], jp)
        fq = quat_mul(quat[p], jq.expand_as(quat[p]))
        vf = linv[p] + cross(angv[p], fpos - pos[p])
        jt = int(ks.body_jtype[g])
        k = int(ks.body_dof[g])
        if jt == JOINT_REVOLUTE:
            rotq = quat_from_axis_angle(ax, st["q"][:, k])
            aw = quat_rotate(fq, ax)
            pos[g] = fpos
            quat[g] = quat_mul(fq, rotq)
            angv[g] = angv[p] + aw * st["qd"][:, k, None]
            linv[g] = vf
            axis_w[g] = aw
        elif jt == JOINT_PRISMATIC:
            aw = quat_rotate(fq, ax)
            bp = fpos + aw * st["q"][:, k, None]
            pos[g] = bp
            quat[g] = fq
            angv[g] = angv[p]
            linv[g] = vf + cross(angv[p], bp - fpos) + aw * st["qd"][:, k, None]
            axis_w[g] = aw
        elif jt == JOINT_FIXED:
            pos[g] = fpos
            quat[g] = fq
            angv[g] = angv[p]
            linv[g] = vf
            axis_w[g] = x_axis
        else:
            raise NotImplementedError(f"joint type {jt}")
    return pos, quat, linv, angv, axis_w


def _crm6(v, m):
    w, vo = v[..., :3], v[..., 3:]
    return torch.cat([cross(w, m[..., :3]), cross(w, m[..., 3:]) + cross(vo, m[..., :3])], -1)


def _crf6(v, f):
    w, vo = v[..., :3], v[..., 3:]
    return torch.cat([cross(w, f[..., :3]) + cross(vo, f[..., 3:]), cross(w, f[..., 3:])], -1)


def _skew(r):
    z = torch.zeros_like(r[..., 0])
    return torch.stack([
        torch.stack([z, -r[..., 2], r[..., 1]], -1),
        torch.stack([r[..., 2], z, -r[..., 0]], -1),
        torch.stack([-r[..., 1], r[..., 0], z], -1),
    ], -2)


def _spatial_inertia(mass, com_w, R, I_com, mscale):
    """(K,6,6) spatial inertia about the world origin."""
    m = mass * mscale                                       # (K,)
    Iw = R @ _c(I_com, R) @ R.transpose(-1, -2) * mscale[:, None, None]
    C = _skew(com_w)
    top = torch.cat([Iw + m[:, None, None] * (C @ C.transpose(-1, -2)), m[:, None, None] * C], -1)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    bot = torch.cat([m[:, None, None] * C.transpose(-1, -2), m[:, None, None] * eye], -1)
    return torch.cat([top, bot], -2)


def _body_inertia(ks, g, pos, quat, mass):
    com_w = pos[g] + quat_rotate(quat[g], _c(ks.body_com[g], pos[g]))
    return _spatial_inertia(float(ks.body_mass[g]), com_w, quat_to_matrix(quat[g]),
                            ks.body_inertia[g], mass[:, g])


def _free_velocity(ks, ai, st, pos, quat, linv, angv, plk_n, plk_f, mass, dt):
    """Velocity solve of a free single body (the 6-dof base of
    dynamics_lanes): → clamped (root linvel, angvel)."""
    g = int(ks.actor_body0[ai])
    K = pos[g].shape[0]
    Iw = _body_inertia(ks, g, pos, quat, mass)
    vb = torch.cat([angv[g], linv[g] - cross(angv[g], pos[g])], -1)
    gz = ks.gravity_z if ks.actor_gravity[ai] else 0.0
    a0 = _c([0.0, 0.0, 0.0, 0.0, 0.0, gz], vb).expand(K, 6)
    f = (Iw @ a0[..., None])[..., 0] + _crf6(vb, (Iw @ vb[..., None])[..., 0]) \
        - torch.cat([plk_n[g], plk_f[g]], -1)
    M = torch.triu(Iw) + torch.triu(Iw, 1).transpose(-1, -2)
    rhs = [(M[:, i] * vb).sum(-1) + dt * (0.0 - f[:, i]) for i in range(6)]
    Ms = M + 1e-8 * torch.eye(6, dtype=M.dtype, device=M.device)
    u = cholesky_solve_factored(cholesky_factor(Ms), torch.stack(rhs, -1)).unbind(-1)
    w = torch.stack(u[0:3], -1)
    v = torch.stack(u[3:6], -1) + cross(w, st["root_pos"][:, ai])
    wcap, vcap = ks.max_root_angvel, ks.max_root_linvel
    return [torch.clamp(v, -vcap, vcap), torch.clamp(w, -wcap, wcap)]


def _integrate_dofs(ks, st, new_q, new_qd, do, nd, u, dt):
    for k in range(nd):
        dg = do + k
        mv = float(ks.dof_maxvel[dg])
        qd_k = torch.clamp(u[k], -mv, mv)
        qk = st["q"][:, dg] + dt * qd_k
        qk = torch.clamp(qk, float(ks.dof_lower[dg]) - 1e-3, float(ks.dof_upper[dg]) + 1e-3)
        new_q[:, dg] = qk
        new_qd[:, dg] = qd_k


def _integrate_base(ks, st, ai, w, v_o, dt):
    """Root of a floating base from its Plücker velocity (ω, v_O):
    v_r = v_O + ω×p_root, both clamped, then position and orientation.
    → (pos, quat, linvel, angvel)."""
    p_r = st["root_pos"][:, ai]
    v_r = v_o + cross(w, p_r)
    wcap, vcap = ks.max_root_angvel, ks.max_root_linvel
    w = torch.clamp(w, -wcap, wcap)
    v_r = torch.clamp(v_r, -vcap, vcap)
    return p_r + v_r * dt, qintegrate(st["root_quat"][:, ai], w, dt), v_r, w


def _art_side(ks, bi: int) -> int:
    """The articulated body of a couple or stiction block."""
    return int(ks.blk_ba[bi]) if int(ks.blk_flags[bi]) & (F_A_ART | F_A_STA) else int(ks.blk_bb[bi])


def _unit6(k: int, like: torch.Tensor) -> torch.Tensor:
    e = [0.0] * 6
    e[k] = 1.0
    return _c(e, like).expand(like.shape[0], 6)


def dynamics(ks: KernelScene, st, pos, quat, linv, angv, axis_w, plk_n, plk_f,
             tgt, mass_scale, fric, dt, swept: List[SweptGeo] = (), sweeps: int = 2,
             world_fidelity: bool = True, two_way_sweeps: bool = True):
    """Implicit velocity update of every dynamic actor, the impulse pass, and
    the integration (dynamics_lanes). tgt (K,D), mass_scale (K,B), fric
    (K,G). At world fidelity the impulse pass starts from st["lam"] and
    returns the λ rows in the new state; at fast fidelity it starts from
    zero and keeps no λ. two_way_sweeps: see `impulse_pass`. → the new
    state dict."""
    new_q = st["q"].clone()
    new_qd = st["qd"].clone()
    ref = st["root_pos"][:, 0]
    K = ref.shape[0]
    couple: Dict[int, List[SweptGeo]] = {}
    for geo in swept:
        if int(ks.blk_flags[geo.blk]) & (F_A_ART | F_B_ART):
            couple.setdefault(int(ks.body_actor[_art_side(ks, geo.blk)]), []).append(geo)
    free_vel: Dict[int, list] = {}
    art_ctx: Dict[int, dict] = {}
    roots: Dict[int, tuple] = {}
    for ai in range(ks.nactor):
        kind = int(ks.actor_dynamic[ai])
        if kind == ACTOR_FREE:
            free_vel[ai] = _free_velocity(ks, ai, st, pos, quat, linv, angv, plk_n, plk_f,
                                          mass_scale, dt)
            continue
        if kind != ACTOR_ARTICULATED:
            continue
        bo, nb = int(ks.actor_body0[ai]), int(ks.actor_nbody[ai])
        do, nd = int(ks.actor_dof0[ai]), int(ks.actor_ndof[ai])
        v0, nv, base = int(ks.actor_v0[ai]), int(ks.actor_nv[ai]), int(ks.actor_base[ai])
        # spatial inertias + composite
        Iw = [_body_inertia(ks, bo + i, pos, quat, mass_scale) for i in range(nb)]
        Ic = list(Iw)
        for i in range(nb - 1, 0, -1):
            p = int(ks.body_parent[bo + i]) - bo
            Ic[p] = Ic[p] + Ic[i]
        # motion subspaces (world Plücker) per velocity coordinate: the base's
        # unit vectors, then one per dof
        S = [_unit6(k, ref) for k in range(base)]
        for k in range(nd):
            g = int(ks.v_body[v0 + base + k])
            a = axis_w[g]
            if int(ks.body_jtype[g]) == JOINT_REVOLUTE:
                S.append(torch.cat([a, cross(pos[g], a)], -1))
            else:
                S.append(torch.cat([torch.zeros_like(a), a], -1))
        v_b = [torch.cat([angv[bo + i], linv[bo + i] - cross(angv[bo + i], pos[bo + i])], -1)
               for i in range(nb)]
        u = [v_b[0][:, k] for k in range(base)] + [st["qd"][:, do + k] for k in range(nd)]
        # bias forces (RNEA with qdd = 0; gravity as base acceleration)
        gz = ks.gravity_z if ks.actor_gravity[ai] else 0.0
        a_sp = [None] * nb
        a_sp[0] = _c([0.0, 0.0, 0.0, 0.0, 0.0, gz], ref).expand(K, 6)
        for i in range(1, nb):
            p = int(ks.body_parent[bo + i]) - bo
            a_i = a_sp[p]
            kd_ = int(ks.body_dof[bo + i])
            if kd_ >= 0:
                a_i = a_i + _crm6(v_b[i], S[base + kd_ - do] * st["qd"][:, kd_, None])
            a_sp[i] = a_i
        f_sub = []
        for i in range(nb):
            g = bo + i
            Ia = (Iw[i] @ a_sp[i][..., None])[..., 0]
            Iv = (Iw[i] @ v_b[i][..., None])[..., 0]
            f_sub.append(Ia + _crf6(v_b[i], Iv) - torch.cat([plk_n[g], plk_f[g]], -1))
        for i in range(nb - 1, 0, -1):
            p = int(ks.body_parent[bo + i]) - bo
            f_sub[p] = f_sub[p] + f_sub[i]
        C = []
        F = []
        for j in range(nv):
            bj = int(ks.v_body[v0 + j]) - bo
            C.append((S[j] * f_sub[bj]).sum(-1))
            F.append((Ic[bj] @ S[j][..., None])[..., 0])
        M = [[torch.zeros(K, dtype=ref.dtype, device=ref.device)] * nv for _ in range(nv)]
        for i in range(nv):
            for j in range(nv):
                if ks.v_anc[v0 + i, v0 + j]:
                    val = (S[i] * F[j]).sum(-1)
                    M[i][j] = val
                    M[j][i] = val
        # drives (force-limited implicit gains, effort drives with the finger
        # motor curve), damping, Coulomb friction, joint-limit penalty;
        # nothing drives the base coordinates
        zero = torch.zeros_like(ref[:, 0])
        tau, d_imp = [zero] * base, [zero] * base
        for k in range(nd):
            dg = do + k
            mode = int(ks.dof_mode[dg])
            kp, kd = float(ks.dof_kp[dg]), float(ks.dof_kd[dg])
            effort = float(ks.dof_effort[dg])
            qk, qdk, tg = st["q"][:, dg], st["qd"][:, dg], tgt[:, dg]
            gb = int(ks.dof_gate_body[dg])
            if gb >= 0:
                # the finger force gate: a velocity-driven finger stops closing
                # once its link's net contact force (the last substep's
                # report) exceeds grip_force_gate
                f = st["net_cf"][:, gb]
                fmag = torch.sqrt((f * f).sum(-1))
                tg = torch.where((fmag > ks.grip_force_gate) & (tg < 0.0), 0.0, tg)
            if mode == DRIVE_EFFORT:
                tk = torch.clamp(tg, -effort, effort)
                dk = torch.full_like(qk, kd)
                if ks.dof_motor[dg]:
                    # the effort finger's motor curve |τ|/v_max and its
                    # load-proportional spindle stiction, both implicit
                    dk = dk + tk.abs() * (1.0 / max(float(ks.dof_maxvel[dg]), 1e-6)
                                          + ks.mu_spindle / (qdk.abs() + 0.02))
            elif mode == DRIVE_VELOCITY:
                kd_eff = torch.clamp(effort / torch.clamp((tg - qdk).abs(), min=1e-6), max=kd)
                tk = kd_eff * tg
                dk = kd_eff
            elif mode == DRIVE_POSITION:
                kp_eff = torch.clamp(effort / torch.clamp((tg - qk).abs(), min=1e-6), max=kp)
                tk = kp_eff * (tg - qk)
                dk = kp_eff * dt + kd
            elif mode == DRIVE_NONE:
                tk = torch.zeros_like(qk)
                dk = torch.zeros_like(qk)
            else:
                raise NotImplementedError(f"drive mode {mode}")
            dk = dk + float(ks.dof_damping[dg])
            dk = dk + float(ks.dof_friction[dg]) / (qdk.abs() + 0.02)
            below = torch.clamp(float(ks.dof_lower[dg]) - qk, min=0.0)
            above = torch.clamp(qk - float(ks.dof_upper[dg]), min=0.0)
            viol = (below > 0) | (above > 0)
            tk = tk + 1.0e3 * (below - above) - torch.where(viol, 1.0e2 * qdk, 0.0)
            tau.append(tk)
            d_imp.append(dk + float(ks.dof_armature[dg]))
        rhs = []
        Ms = torch.stack([torch.stack(row, -1) for row in M], -2)      # (K,nv,nv)
        for i in range(nv):
            acc = M[i][0] * u[0]
            for j in range(1, nv):
                acc = acc + M[i][j] * u[j]
            rhs.append(acc + dt * (tau[i] - C[i]))
        Ms = Ms + torch.diag_embed(torch.stack(d_imp, -1) * dt + 1e-8)
        bodies = [b for b in range(ks.nbody) if ks.body_psi[b] >= 0 and int(ks.body_actor[b]) == ai]
        if bodies:
            # couple contacts enter the solve implicitly; for them and for the
            # stiction contacts the factor, the subspaces and Ψ stay live for
            # the impulse sweeps, and the integration waits until after them
            if ai in couple:
                couple_terms(ks, couple[ai], S, v0, nv, pos, linv, angv, mass_scale, dt, rhs, Ms)
            Lc = cholesky_factor(Ms)
            u = list(cholesky_solve_factored(Lc, torch.stack(rhs, -1)).unbind(-1))
            art_ctx[ai] = dict(S=S, L=Lc, u=u, v0=v0, nv=nv,
                               base=base, do=do, nd=nd, bodies=bodies,
                               psi=psi_blocks(ks, bodies, S, Lc, v0, nv))
            continue
        u_new = cholesky_solve_factored(cholesky_factor(Ms), torch.stack(rhs, -1)).unbind(-1)
        if base:
            roots[ai] = _integrate_base(ks, st, ai, torch.stack(u_new[0:3], -1),
                                        torch.stack(u_new[3:6], -1), dt)
        _integrate_dofs(ks, st, new_q, new_qd, do, nd, u_new[base:], dt)

    out = dict(st)
    if swept and sweeps > 0 and (free_vel or art_ctx):
        lam = impulse_pass(ks, list(swept), st, pos, linv, angv, mass_scale, fric, dt, sweeps,
                           free_vel, art_ctx, st["lam"] if world_fidelity else None,
                           two_way_sweeps)
        if world_fidelity:
            out["lam"] = lam
    for ai, ctx in art_ctx.items():
        u, base = ctx["u"], ctx["base"]
        if base:
            roots[ai] = _integrate_base(ks, st, ai, torch.stack(u[0:3], -1),
                                        torch.stack(u[3:6], -1), dt)
        _integrate_dofs(ks, st, new_q, new_qd, ctx["do"], ctx["nd"], u[base:], dt)
    for ai, (v, w) in free_vel.items():
        roots[ai] = (st["root_pos"][:, ai] + v * dt, qintegrate(st["root_quat"][:, ai], w, dt), v, w)
    if roots:
        rp, rq = st["root_pos"].clone(), st["root_quat"].clone()
        rlv, rav = st["root_linvel"].clone(), st["root_angvel"].clone()
        for ai, (p, q, v, w) in roots.items():
            rp[:, ai], rq[:, ai], rlv[:, ai], rav[:, ai] = p, q, v, w
        out.update(root_pos=rp, root_quat=rq, root_linvel=rlv, root_angvel=rav)
    out["q"], out["qd"] = new_q, new_qd
    return out


def substep(ks: KernelScene, st, tgt, mass_scale, fric, dt, sweeps: int = 2,
            world_fidelity: bool = True, skip_contacts: bool = False,
            skip_dynamics: bool = False, two_way_sweeps: bool = True,
            broadphase_gate: bool = True):
    """One substep of the twin: FK → contacts → velocity solves → impulse
    pass → integration. Returns the new state dict with this substep's
    reported net contact forces (and, at world fidelity, λ rows). Fast
    fidelity (world_fidelity False: the rollout's `rollout_fidelity: fast`)
    leaves out the λ warm start, the λ rows and the stiction snap.

    The profiling ablations of the JAX package's `substep_lanes` and of its
    module switches TWO_WAY_SWEEPS and BROADPHASE_GATE, off by default, timing only (the kernels' ablation
    library, csrc/scene_tables.cuh AB_*): skip_contacts (zero forces, no
    swept block, no impulse pass: the λ rows stay), skip_dynamics (no
    velocity solve: every root moves by its velocity, dofs and velocities
    stay), two_way_sweeps=False (`impulse_pass`), broadphase_gate=False
    (`contacts`: every block live, the same outputs)."""
    pos, quat, linv, angv, axis_w = fk(ks, st)
    if skip_contacts:
        zero3 = torch.zeros_like(pos[0])
        plk_n, plk_f, net_cf, swept = [zero3] * ks.nbody, [zero3] * ks.nbody, [zero3] * ks.nbody, []
    else:
        plk_n, plk_f, net_cf, swept = contacts(ks, pos, quat, linv, angv, fric, dt,
                                               broadphase_gate)
    if swept and world_fidelity and "lam" not in st:
        st = dict(st, lam=torch.zeros(pos[0].shape[0], ks.n_fc, 4, dtype=pos[0].dtype,
                                      device=pos[0].device))
    if skip_dynamics:
        out = dict(st, root_pos=st["root_pos"] + st["root_linvel"] * dt)
    else:
        out = dynamics(ks, st, pos, quat, linv, angv, axis_w, plk_n, plk_f, tgt, mass_scale,
                       fric, dt, swept, sweeps, world_fidelity, two_way_sweeps)
    out["net_cf"] = torch.stack(net_cf, 1)
    return out


def _force_term(c: CostSpec, st) -> torch.Tensor:
    """Σ over the force groups of |F_i|, i < force_dims, F the group's summed
    net contact force."""
    out = 0.0
    for b0, n in ((c.force_body0, c.force_nbody), (c.force2_body0, c.force2_nbody)):
        if n <= 0:
            continue
        f = st["net_cf"][:, b0]
        for b in range(b0 + 1, b0 + n):
            f = f + st["net_cf"][:, b]
        for i in range(c.force_dims):
            out = out + f[:, i].abs()
    return out


def task_cost(ks: KernelScene, st, pos, quat) -> torch.Tensor:
    """The kernels' per-step task cost on the post-step state."""
    c = ks.cost
    if c is None or c.task not in TASKS:
        raise NotImplementedError(f"no kernel cost for task spec {c}")
    if c.task == TASK_MOBILE_REACH:
        xy = st["q"][:, c.xy_dof:c.xy_dof + 2] if c.xy_dof >= 0 else st["root_pos"][:, c.xy_actor, 0:2]
        dx, dy = xy[:, 0] - c.goal_x, xy[:, 1] - c.goal_y
        return c.w_dist * torch.sqrt(dx * dx + dy * dy + 1e-12) + c.w_force * _force_term(c, st)
    if c.task == TASK_MOBILE_PUSH:
        r, block = pos[c.ee_body], st["root_pos"][:, c.block_actor]
        bv = st["root_linvel"][:, c.block_actor]
        rbx, rby = r[:, 0] - block[:, 0], r[:, 1] - block[:, 1]
        bgx, bgy = c.goal_x - block[:, 0], c.goal_y - block[:, 1]
        d_rb = torch.sqrt(rbx * rbx + rby * rby + 1e-12)
        d_bg = torch.sqrt(bgx * bgx + bgy * bgy + 1e-12)
        yaw = quat_to_yaw(st["root_quat"][:, c.block_actor])
        align = (rbx * bgx + rby * bgy) / torch.clamp(d_rb * d_bg, min=1e-6) + 1.0
        vel = torch.sqrt(bv[:, 0] * bv[:, 0] + bv[:, 1] * bv[:, 1] + 1e-12)
        return (c.w_dist * d_rb + c.w_block * d_bg + c.w_ori * (yaw - c.goal_yaw).abs()
                + c.w_align * align + c.w_force * _force_term(c, st) + c.w_vel * vel)
    if c.task == TASK_POINT_ROBOT:
        x, y = st["q"][:, c.xy_dof], st["q"][:, c.xy_dof + 1]
        dx, dy = x - c.goal_x, y - c.goal_y
        cost = c.w_dist * torch.sqrt(dx * dx + dy * dy + 1e-12)
        for a in c.xy_actors:
            o = st["root_pos"][:, a]
            ox, oy = x - o[:, 0], y - o[:, 1]
            cost = cost + c.w_pair / torch.clamp(torch.sqrt(ox * ox + oy * oy + 1e-12), min=1e-3)
        return cost + c.w_force * _force_term(c, st)
    if c.task == TASK_MULTI_ROBOT:
        dofs = c.xy_dofs or (-1,) * len(c.xy_actors)
        xys = [st["q"][:, d:d + 2] if d >= 0 else st["root_pos"][:, a, 0:2]
               for a, d in zip(c.xy_actors, dofs)]
        cost = 0.0
        for xy, (gx, gy) in zip(xys, c.xy_goals):
            dx, dy = xy[:, 0] - gx, xy[:, 1] - gy
            cost = cost + c.w_dist * torch.sqrt(dx * dx + dy * dy + 1e-12)
        for i in range(len(xys)):
            for j in range(i + 1, len(xys)):
                dx, dy = xys[i][:, 0] - xys[j][:, 0], xys[i][:, 1] - xys[j][:, 1]
                d = torch.sqrt(dx * dx + dy * dy + 1e-12)
                cost = cost + c.w_pair * torch.clamp(c.min_sep - d, min=0.0)
        return cost
    ro, p, y = euler_zyx_atan2(quat[c.ee_body])
    ori = torch.sqrt(y * y + p * p + 1e-12)
    r = pos[c.ee_body]
    goal = st["root_pos"][:, c.goal_actor]
    if c.task in (TASK_PANDA_REACH, TASK_ALBERT, TASK_ANYMAL):
        d = r - goal
        cost = c.w_dist * torch.sqrt((d * d).sum(-1) + 1e-12)
        if c.task == TASK_PANDA_REACH:
            return cost + c.w_ori * ori
        if c.task == TASK_ALBERT:
            return cost + c.w_ori * torch.sqrt(ro * ro + p * p + 1e-12)
        for b, z, w in zip(c.ht_body, c.ht_z, c.ht_w):
            cost = cost + w * (pos[b][:, 2] - z).abs()
        return cost
    block = st["root_pos"][:, c.block_actor]
    d_rb = torch.sqrt(dot(r - block, r - block) + 1e-12)
    d_bg = torch.sqrt(dot(block - goal, block - goal) + 1e-12)
    cost = c.w_dist * d_rb + c.w_block * d_bg + c.w_force * _force_term(c, st) + c.w_ori * ori
    if c.task == TASK_STICK_PUSH:
        rbx, rby = r[:, 0] - block[:, 0], r[:, 1] - block[:, 1]
        bgx, bgy = goal[:, 0] - block[:, 0], goal[:, 1] - block[:, 1]
        d2 = torch.sqrt(rbx * rbx + rby * rby + 1e-12) * torch.sqrt(bgx * bgx + bgy * bgy + 1e-12)
        align = (rbx * bgx + rby * bgy) / torch.clamp(d2, min=1e-6) + 1.0
        return cost + c.w_height * (r[:, 2] - block[:, 2]).abs() + c.w_align * align
    if c.task == TASK_OMNI_PICK:
        q, qd, d0 = st["q"], st["qd"], c.dof0
        base_vel = sum(qd[:, d0 + i] * qd[:, d0 + i] for i in range(3))
        arm_vel = sum(qd[:, d0 + i] * qd[:, d0 + i] for i in range(3, 10))
        arm_pose = sum((q[:, d0 + 3 + i] - c.pose[i]) ** 2 for i in range(7))
        grip = sum((q[:, d0 + 10 + i] - c.pose[7 + i]) ** 2 for i in range(2))
        return (cost + c.w_base_vel * base_vel + c.w_arm_vel * arm_vel + c.w_pose * arm_pose
                + c.w_grip * grip + c.w_height * torch.clamp(c.height_floor - r[:, 2], min=0.0))
    return cost


def command_targets(ks: KernelScene, u: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """dof targets = W @ u, summing the nonzero entries of W in order, then
    the gripper binarize (latching from the current finger q when its band
    is > 0, as CommandMap.apply)."""
    K = u.shape[0]
    tgt = []
    for d in range(ks.ndof):
        acc = torch.zeros(K, dtype=u.dtype, device=u.device)
        for j in range(ks.nu):
            w = float(ks.cmd_W[d, j])
            if w != 0.0:
                acc = acc + u[:, j] * w
        tgt.append(acc)
    for i in range(len(ks.bin_dof)):
        dof, uc = int(ks.bin_dof[i]), u[:, int(ks.bin_src[i])]
        lo, hi = float(ks.bin_lo[i]), float(ks.bin_hi[i])
        if float(ks.bin_band[i]) > 0.0:
            cur_open = q[:, dof] > float(ks.bin_qopen[i])
            tgt[dof] = torch.where(uc > float(ks.bin_uhi[i]), hi,
                                   torch.where(uc < float(ks.bin_ulo[i]), lo,
                                               torch.where(cur_open, hi, lo))).to(u.dtype)
        else:
            tgt[dof] = torch.where(uc > float(ks.bin_th[i]), hi, lo).to(u.dtype)
    return torch.stack(tgt, -1) if tgt else u.new_zeros(K, 0)
