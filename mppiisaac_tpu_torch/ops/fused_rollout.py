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

`profile={...}` (as the JAX wrappers take it) turns on the profiling
ablations: `skip_contacts`, `skip_dynamics`, `zero_cost` (K1 only) and
`two_way_sweeps=False`, `broadphase_gate=False` (K1 and K2). Timing only:
all but the last give physically wrong states on purpose. On the card such a
wrapper launches its mask's instantiation in the ablation library
(ops/native.py `ABLATE`), counted per mask in `ablated_launches`; a mask the
library does not instantiate, or a failed build or launch, raises. On the CPU
the plain versions take the same switches. No entry point of the port passes
`profile`; `mppiisaac_tpu_torch.profile_kernel` does.

The kernels run one warp per sample (K2: one warp for the world's sample).
`pack_tables` appends to the scene tables the lane orders the warp needs
(bodies by tree level, 32-lane chunks of whole pair blocks, the block of each
swept candidate, the body of each Ψ slot) and the layout of one sample's
region of shared memory, sized to the scene's own counts; `warps_per_block`
picks, once per device, the warps per block (at most 8) that spread K samples
over the card's SMs and fit beside the tables in 227 KB.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..physics.contact import build_contact_tables
from ..physics.types import ModelParams, SimState
from ..utils.device_cache import DeviceCache
from ..utils.profiling import span
from .fused_contacts import (F_A_ART, F_A_FREE, F_A_STA, F_B_ART, F_B_FREE, F_B_STA, F_EMIT_A,
                             F_EMIT_B, F_SWEPT)
from .fused_physics import (
    ACTOR_ARTICULATED,
    MAX_HT,
    MAX_XY,
    N_POSE,
    TASKS,
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
MAX_GEOMS, MAX_BLK, MAX_CAND, MAX_SC, MAX_PSI, MAX_BIN, MAX_S = 64, 48, 160, 1024, 16, 4, 26
MAX_V = 24      # velocity coordinates (base + dofs) of all articulated actors
MAX_CHUNKS = 48  # 32-lane chunks of whole pair blocks

# the per-warp layout (enum Layout of csrc/scene_tables.cuh, in its order):
# name → words, from the scene's counts. The first five are the state rows in
# row order; DYN_* and IMP_* share one area.
LAYOUT = (
    "ROOT", "Q", "QD", "NCF", "LAM", "POS", "QUAT", "LINV", "ANGV", "AXW", "PLKN", "PLKF",
    "PT", "NRM", "DEPTH", "LIVE", "S", "L", "U", "PSI", "FV", "DEF",
    "TGT", "TG", "UCMD", "NEWQ", "NEWQD", "BSUM", "FVS",
    "IC", "VB", "ASP", "FSUB", "RHS", "C", "DIMP", "UU", "COEF", "COL",
    "INVM", "INVIW", "CNTB", "CNTA", "ACT", "MUB", "KC", "KNC", "FLOOR", "NEFF",
    "DP", "DT", "Y", "V6", "SA", "SB", "USED", "SSUM",
)
_DYN0, _IMP0 = LAYOUT.index("IC"), LAYOUT.index("INVM")
BOUNDS = (MAX_ACTORS, MAX_BODIES, MAX_DOFS, MAX_NU, MAX_GEOMS, MAX_BLK, MAX_CAND, MAX_SC,
          MAX_PSI, MAX_BIN, MAX_S, MAX_V, MAX_CHUNKS, len(LAYOUT))
SMEM_BYTES = 227 * 1024    # shared memory a block can use on the H100
MAX_WARPS = 8

# the profiling ablations (csrc/scene_tables.cuh AB_*): switch → (its value
# when the ablation is on, mask bit)
ABLATIONS = {"skip_contacts": (True, 1), "skip_dynamics": (True, 2), "zero_cost": (True, 4),
             "two_way_sweeps": (False, 8), "broadphase_gate": (False, 16)}
# the masks the ablation library instantiates (AB_K1_MASKS, AB_K2_MASKS):
# nocost, nocontact, fkonly, one-way sweeps, no gate
K1_MASKS = (4, 1, 1 | 2 | 4, 8, 16)
K2_MASKS = (8, 16)
K2_SWITCHES = ("two_way_sweeps", "broadphase_gate")


def ablation(profile: Optional[dict], switches=tuple(ABLATIONS)):
    """profile → (every switch's value, the kernels' mask). A switch the
    profile leaves out is not ablated: only `profile` turns an ablation on."""
    profile = dict(profile or {})
    unknown = set(profile) - set(switches)
    if unknown:
        raise ValueError(f"profile: unknown switches {sorted(unknown)}; known {list(switches)}")
    values = {k: bool(profile.get(k, not ABLATIONS[k][0])) for k in switches}
    mask = 0
    for k, v in values.items():
        if v == ABLATIONS[k][0]:
            mask |= ABLATIONS[k][1]
    return values, mask


def _arr(ctype, n):
    return ctype * n


class _SceneTablesC(ctypes.Structure):
    """Mirror of `struct SceneTables` in csrc/scene_tables.cuh."""
    _fields_ = [
        *[(n, ctypes.c_int) for n in (
            "nactor", "nbody", "ndof", "ngeom", "nu", "nblk", "n_fc", "nbin", "nv", "task",
            "ee_body", "goal_actor", "vis_body", "block_actor", "force_body0", "force_nbody",
            "force2_body0", "force2_nbody", "force_dims", "xy_actor", "xy_dof", "n_xy", "dof0",
            "n_ht")],
        ("xy_actors", _arr(ctypes.c_int, MAX_XY)),
        ("xy_dofs", _arr(ctypes.c_int, MAX_XY)),
        *[(n, ctypes.c_float) for n in (
            "gravity_z", "eps_v", "max_depth", "max_root_linvel", "max_root_angvel",
            "grip_force_gate", "mu_spindle", "w_dist", "w_ori", "w_block", "w_force", "w_align",
            "w_vel", "goal_x", "goal_y", "goal_yaw", "w_pair", "min_sep", "w_height",
            "height_floor", "w_base_vel", "w_arm_vel", "w_pose", "w_grip")],
        ("xy_gx", _arr(ctypes.c_float, MAX_XY)),
        ("xy_gy", _arr(ctypes.c_float, MAX_XY)),
        ("pose_c", _arr(ctypes.c_float, N_POSE)),
        ("ht_body", _arr(ctypes.c_int, MAX_HT)),
        ("ht_z", _arr(ctypes.c_float, MAX_HT)),
        ("ht_w", _arr(ctypes.c_float, MAX_HT)),
        *[(n, _arr(ctypes.c_int, MAX_ACTORS)) for n in (
            "actor_body0", "actor_nbody", "actor_dof0", "actor_ndof", "actor_dynamic",
            "actor_gravity", "actor_base", "actor_v0", "actor_nv")],
        ("actor_invm", _arr(ctypes.c_float, MAX_ACTORS)),
        ("actor_iinv", _arr(ctypes.c_float, MAX_ACTORS * 9)),
        *[(n, _arr(ctypes.c_int, MAX_BODIES)) for n in (
            "body_parent", "body_actor", "body_jtype", "body_dof", "body_vmask", "body_psi")],
        ("body_jpos", _arr(ctypes.c_float, MAX_BODIES * 3)),
        ("body_jquat", _arr(ctypes.c_float, MAX_BODIES * 4)),
        ("body_jaxis", _arr(ctypes.c_float, MAX_BODIES * 3)),
        ("body_mass", _arr(ctypes.c_float, MAX_BODIES)),
        ("body_com", _arr(ctypes.c_float, MAX_BODIES * 3)),
        ("body_inertia", _arr(ctypes.c_float, MAX_BODIES * 9)),
        ("v_body", _arr(ctypes.c_int, MAX_V)),
        ("v_anc", _arr(ctypes.c_int, MAX_V * MAX_V)),
        *[(n, _arr(ctypes.c_int, MAX_DOFS)) for n in ("dof_mode", "dof_motor", "dof_gate_body")],
        *[(n, _arr(ctypes.c_float, MAX_DOFS)) for n in (
            "dof_kp", "dof_kd", "dof_effort", "dof_maxvel", "dof_damping", "dof_friction",
            "dof_armature", "dof_lower", "dof_upper")],
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
        *[(n, ctypes.c_int) for n in ("n_lvl", "n_ck", "n_sw", "n_psi")],
        ("lvl_start", _arr(ctypes.c_int, MAX_BODIES + 1)),
        ("lvl_body", _arr(ctypes.c_int, MAX_BODIES)),
        ("ck_blk", _arr(ctypes.c_ubyte, MAX_CHUNKS * 32)),
        ("sw_blk", _arr(ctypes.c_ubyte, MAX_CHUNKS * 32)),
        ("blk_lane0", _arr(ctypes.c_int, MAX_BLK)),
        ("blk_swlane0", _arr(ctypes.c_int, MAX_BLK)),
        ("cand_blk", _arr(ctypes.c_int, MAX_CAND)),
        ("psi_body", _arr(ctypes.c_int, MAX_PSI)),
        ("cb_start", _arr(ctypes.c_int, MAX_BODIES + 1)),
        ("cb_ent", _arr(ctypes.c_int, 2 * MAX_BLK)),
        ("ab_start", _arr(ctypes.c_int, MAX_ACTORS + 1)),
        ("ab_ent", _arr(ctypes.c_int, 2 * MAX_BLK)),
        ("pb_start", _arr(ctypes.c_int, MAX_PSI + 1)),
        ("pb_ent", _arr(ctypes.c_int, MAX_BLK)),
        ("lay", _arr(ctypes.c_int, len(LAYOUT))),
        ("warp_words", ctypes.c_int),
    ]


_TABLE_ARRAYS = (
    "actor_body0", "actor_nbody", "actor_dof0", "actor_ndof", "actor_dynamic", "actor_gravity",
    "actor_base", "actor_v0", "actor_nv", "actor_invm", "actor_iinv",
    "body_parent", "body_actor", "body_jtype", "body_dof", "body_vmask", "body_psi",
    "body_jpos", "body_jquat", "body_jaxis", "body_mass", "body_com", "body_inertia",
    "v_body", "dof_mode", "dof_motor", "dof_gate_body", "dof_kp", "dof_kd", "dof_effort",
    "dof_maxvel", "dof_damping", "dof_friction", "dof_armature", "dof_lower", "dof_upper",
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
                         ("velocity coordinates", ks.nv, MAX_V),
                         ("geoms", ks.ngeom, MAX_GEOMS), ("pair blocks", ks.nblk, MAX_BLK),
                         ("swept candidates", ks.n_fc, MAX_CAND),
                         ("box-sample constants", len(ks.sconst), MAX_SC),
                         ("couple and stiction contact links", int((ks.body_psi >= 0).sum()),
                          MAX_PSI),
                         ("binarized dofs", len(ks.bin_dof), MAX_BIN),
                         ("samples per block", S, MAX_S)):
        if n > cap:
            raise ValueError(f"scene has {n} {what}; the CUDA kernels take at most {cap}")


def _chunks(ks: KernelScene, blocks):
    """Pack whole blocks, in order, into 32-lane chunks. → (block of every
    lane, 255 idle; first lane of each block), MAX_CHUNKS × 32 and MAX_BLK."""
    lanes = np.full((MAX_CHUNKS, 32), 255, np.uint8)
    lane0 = np.zeros(MAX_BLK, np.int32)
    ch, cur = 0, 0
    for bi in blocks:
        S = int(ks.blk_S[bi])
        if cur + S > 32:
            ch, cur = ch + 1, 0
        lanes[ch, cur:cur + S] = bi
        lane0[bi] = cur
        cur += S
    return lanes, lane0, (ch + 1 if len(blocks) else 0)


def layout(ks: KernelScene):
    """The per-warp region: (offsets in words by LAYOUT, words per sample)."""
    A, B, D, nv, F, nb = ks.nactor, ks.nbody, ks.ndof, ks.nv, ks.n_fc, ks.nblk
    npsi = int(ks.body_psi.max()) + 1 if (ks.body_psi >= 0).any() else 0
    art = [int(ks.actor_nbody[a]) for a in range(A) if ks.actor_dynamic[a] == ACTOR_ARTICULATED]
    anb = max(art or [0])
    size = dict(
        ROOT=13 * A, Q=D, QD=D, NCF=3 * B, LAM=4 * F, POS=3 * B, QUAT=4 * B, LINV=3 * B,
        ANGV=3 * B, AXW=3 * B, PLKN=3 * B, PLKF=3 * B, PT=3 * F, NRM=3 * F, DEPTH=F, LIVE=nb,
        S=6 * nv, L=nv * nv, U=nv, PSI=36 * npsi, FV=6 * A, DEF=A, TGT=D, TG=D, UCMD=ks.nu,
        NEWQ=D, NEWQD=D, BSUM=12 * nb, FVS=72 * A,
        IC=36 * anb, VB=6 * anb, ASP=6 * anb, FSUB=6 * anb, RHS=nv, C=nv, DIMP=nv, UU=nv,
        COEF=64, COL=32 * nv,
        INVM=A, INVIW=9 * A, CNTB=A, CNTA=A, ACT=F, MUB=nb, KC=6 * F, KNC=F, FLOOR=nb, NEFF=nb,
        DP=3 * A, DT=3 * A, Y=6 * npsi, V6=6 * npsi, SA=36 * A, SB=6 * A, USED=A,
        SSUM=27 * nb)
    off, at = [0] * len(LAYOUT), 0
    for i, name in enumerate(LAYOUT[:_DYN0]):
        off[i], at = at, at + size[name]
    ends = []
    for lo, hi in ((_DYN0, _IMP0), (_IMP0, len(LAYOUT))):
        a2 = at
        for i in range(lo, hi):
            off[i], a2 = a2, a2 + size[LAYOUT[i]]
        ends.append(a2)
    return off, max(ends)


def region_bytes(ks: KernelScene) -> int:
    """Bytes of one sample's region of shared memory; raises where one
    region does not fit beside the tables in SMEM_BYTES."""
    nbytes = 4 * layout(ks)[1]
    room = SMEM_BYTES - ctypes.sizeof(_SceneTablesC)
    if nbytes > room:
        raise ValueError(f"one sample's state and temporaries take {nbytes} B of shared "
                         f"memory; beside the {ctypes.sizeof(_SceneTablesC)} B of tables a "
                         f"block has {room} B")
    return nbytes


def warps_per_block(nbytes: int, K: int, n_sm: int) -> int:
    """Enough warps that K samples spread over the n_sm SMs one block each,
    at most MAX_WARPS and as many regions of nbytes as fit beside the
    tables in SMEM_BYTES."""
    fit = (SMEM_BYTES - ctypes.sizeof(_SceneTablesC)) // nbytes
    return min(MAX_WARPS, fit, max(1, -(-int(K) // n_sm)))


def launch_geometry(ks: KernelScene, K: int, n_sm: int):
    """→ (warps per block, bytes of one sample's region) of K1 at K samples
    on a card of n_sm SMs."""
    nbytes = region_bytes(ks)
    return warps_per_block(nbytes, K, n_sm), nbytes


def pack_tables(ks: KernelScene, vis_body: int = -1) -> bytes:
    """KernelScene → the bytes of `struct SceneTables`."""
    check_bounds(ks)
    t = _SceneTablesC()
    c = ks.cost or CostSpec(0, -1, -1, 0.0, 0.0)
    for n, v in (("nactor", ks.nactor), ("nbody", ks.nbody), ("ndof", ks.ndof),
                 ("ngeom", ks.ngeom), ("nu", ks.nu), ("nblk", ks.nblk), ("n_fc", ks.n_fc),
                 ("nbin", len(ks.bin_dof)), ("nv", ks.nv), ("vis_body", vis_body),
                 ("gravity_z", ks.gravity_z), ("eps_v", ks.eps_v), ("max_depth", ks.max_depth),
                 ("max_root_linvel", ks.max_root_linvel), ("max_root_angvel", ks.max_root_angvel),
                 ("grip_force_gate", ks.grip_force_gate), ("mu_spindle", ks.mu_spindle)):
        setattr(t, n, v)
    for n in ("task", "ee_body", "goal_actor", "block_actor", "force_body0", "force_nbody",
              "force2_body0", "force2_nbody", "force_dims", "xy_actor", "xy_dof", "w_dist",
              "w_ori", "w_block", "w_force", "w_align", "w_vel", "goal_x", "goal_y", "goal_yaw",
              "w_pair", "min_sep", "w_height", "height_floor", "dof0", "w_base_vel", "w_arm_vel",
              "w_pose", "w_grip"):
        setattr(t, n, getattr(c, n))
    n_xy, n_ht = len(c.xy_actors), len(c.ht_body)
    if n_xy > MAX_XY or len(c.pose) > N_POSE or n_ht > MAX_HT:
        raise ValueError(f"cost has {n_xy} obstacles or robots, {len(c.pose)} pose constants "
                         f"and {n_ht} height terms; the CUDA kernels take at most {MAX_XY}, "
                         f"{N_POSE} and {MAX_HT}")
    t.n_xy = n_xy
    t.xy_actors[:n_xy] = list(c.xy_actors)
    t.xy_dofs[:n_xy] = list(c.xy_dofs) if c.xy_dofs else [-1] * n_xy
    t.xy_gx[:len(c.xy_goals)] = [g[0] for g in c.xy_goals]
    t.xy_gy[:len(c.xy_goals)] = [g[1] for g in c.xy_goals]
    t.pose_c[:len(c.pose)] = list(c.pose)
    t.n_ht = n_ht
    t.ht_body[:n_ht] = list(c.ht_body)
    t.ht_z[:n_ht] = list(c.ht_z)
    t.ht_w[:n_ht] = list(c.ht_w)
    for n in _TABLE_ARRAYS:
        flat = np.asarray(getattr(ks, n)).reshape(-1)
        getattr(t, n)[: len(flat)] = flat.tolist()
    # row-major (MAX_V, MAX_V) and (MAX_DOFS, MAX_NU) tables
    anc = np.zeros((MAX_V, MAX_V), np.int32)
    anc[: ks.nv, : ks.nv] = ks.v_anc
    t.v_anc[:] = anc.reshape(-1).tolist()
    W = np.zeros((MAX_DOFS, MAX_NU), np.float32)
    W[: ks.ndof, : ks.nu] = ks.cmd_W
    t.cmd_W[:] = W.reshape(-1).tolist()
    # lane orders: bodies by tree level, then the chunks
    level = np.zeros(ks.nbody, np.int32)
    for g in range(ks.nbody):
        p = int(ks.body_parent[g])
        level[g] = 0 if p < 0 else level[p] + 1
    order = np.argsort(level, kind="stable")
    t.n_lvl = int(level.max()) + 1 if ks.nbody else 0
    t.lvl_body[: ks.nbody] = order.tolist()
    t.lvl_start[: t.n_lvl + 1] = np.searchsorted(level[order], np.arange(t.n_lvl + 1)).tolist()
    flags = ks.blk_flags.astype(np.int64)
    contact = [bi for bi in range(ks.nblk) if flags[bi] & (F_EMIT_A | F_EMIT_B | F_SWEPT)]
    swept = [bi for bi in range(ks.nblk) if flags[bi] & F_SWEPT]
    # contact chunks hold blocks of one kind together (lanes of one chunk take
    # one narrowphase branch); swept chunks stay in block order (the couple
    # terms sum blocks in that order)
    by_kind = sorted(contact, key=lambda bi: (int(ks.blk_kind[bi]), bi))
    for lanes_name, lane0_name, count, blocks in (("ck_blk", "blk_lane0", "n_ck", by_kind),
                                                   ("sw_blk", "blk_swlane0", "n_sw", swept)):
        lanes, lane0, n = _chunks(ks, blocks)
        if n > MAX_CHUNKS:
            raise ValueError(f"scene needs {n} chunks of 32 lanes; the CUDA kernels take at "
                             f"most {MAX_CHUNKS}")
        getattr(t, lanes_name)[:] = lanes.reshape(-1).tolist()
        getattr(t, lane0_name)[:] = lane0.tolist()
        setattr(t, count, n)
    for bi in swept:
        c0 = int(ks.blk_c0[bi])
        t.cand_blk[c0:c0 + int(ks.blk_S[bi])] = [bi] * int(ks.blk_S[bi])
    # the sides of blocks acting on each body, free actor and Ψ slot
    actor = ks.body_actor
    art_a = flags & (F_A_ART | F_A_STA) != 0
    lists = (
        ("cb", ks.nbody, [(int(ks.blk_ba[bi]), 2 * bi) for bi in range(ks.nblk) if flags[bi] & F_EMIT_A]
         + [(int(ks.blk_bb[bi]), 2 * bi + 1) for bi in range(ks.nblk) if flags[bi] & F_EMIT_B]),
        ("ab", ks.nactor, [(int(actor[ks.blk_ba[bi]]), 2 * bi) for bi in swept if flags[bi] & F_A_FREE]
         + [(int(actor[ks.blk_bb[bi]]), 2 * bi + 1) for bi in swept if flags[bi] & F_B_FREE]),
        ("pb", MAX_PSI, [(int(ks.body_psi[ks.blk_ba[bi] if art_a[bi] else ks.blk_bb[bi]]),
                          2 * bi + (0 if art_a[bi] else 1)) for bi in swept
                         if flags[bi] & (F_A_ART | F_B_ART | F_A_STA | F_B_STA)]))
    for name, n, pairs in lists:
        pairs = sorted(pairs)                     # by owner, then block
        owners = np.array([o for o, _ in pairs], np.int64)
        getattr(t, f"{name}_start")[: n + 1] = np.searchsorted(owners, np.arange(n + 1)).tolist()
        getattr(t, f"{name}_ent")[: len(pairs)] = [e for _, e in pairs]
    psi = [(int(ks.body_psi[b]), b) for b in range(ks.nbody) if ks.body_psi[b] >= 0]
    t.n_psi = max(sl for sl, _ in psi) + 1 if psi else 0
    for sl, b in psi:
        t.psi_body[sl] = b
    off, t.warp_words = layout(ks)
    t.lay[:] = off
    return bytes(t)


def _library(variant=None):
    from .native import load_library

    lib = load_library(variant)
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


class _DeviceTables:
    """A kernel's packed scene tables and the λ-row index of its swept
    candidates, each copied once to each device that asks for it (so a
    captured CUDA graph copies nothing from the host)."""

    def __init__(self, ks: KernelScene, vis_body: int, fc_idx):
        self.vis_body = vis_body
        self.fc_idx = np.asarray(fc_idx)
        self._bytes = pack_tables(ks, vis_body)
        self._dev = DeviceCache()

    def tables(self, device: torch.device) -> torch.Tensor:
        return self._dev.get("tables", self._host, torch.uint8, device)

    def _host(self) -> np.ndarray:
        return np.frombuffer(bytearray(self._bytes), np.uint8)

    def fc(self, device: torch.device) -> torch.Tensor:
        return self._dev.get("fc_idx", lambda: self.fc_idx, torch.long, device)

    def repack(self, ks: KernelScene):
        """Pack the tables anew (same scene, other constants) and copy the
        bytes into each device's buffer in place, in stream order."""
        self._bytes = pack_tables(ks, self.vis_body)
        self._dev.refresh("tables")


def _require_cuda(device: torch.device):
    if device.type != "cuda":
        raise RuntimeError(f"the fused kernels run on CUDA tensors (or their plain "
                           f"version on CPU tensors), not on {device}")


def _lam_rows(ks: KernelScene, dev_tables: _DeviceTables, lam: Optional[torch.Tensor], lead, device):
    """The λ rows of `contact_lam` (…, n_con, 4) at the swept candidates,
    zeros where the state carries no matching cache. → (…, n_fc, 4)."""
    if lam is not None and lam.shape[-2] == ks.n_con and lam.shape[-1] == 4:
        return lam[..., dev_tables.fc(lam.device), :].to(torch.float32)
    return torch.zeros(lead + (ks.n_fc, 4), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# the kernels' plain PyTorch versions (the device code's twin in
# ops/fused_physics.py, driven the way each kernel drives it)
# ---------------------------------------------------------------------------

def rollout_plain(ks: KernelScene, rows, V, mass, fric, H: int, substeps: int,
                  dt_sub: float, vis_body: int, sweeps: int, world_fidelity: bool = True,
                  skip_contacts: bool = False, skip_dynamics: bool = False,
                  zero_cost: bool = False, two_way_sweeps: bool = True,
                  broadphase_gate: bool = True):
    """Plain version of the rollout kernel (K1).

    rows (NS + 4·n_fc, K) state and λ rows (λ carried across the whole
    H × substeps trajectory), or at fast fidelity (NS, K) state rows alone;
    V (H,nu,K) controls (already rounded through bf16); mass (B,K), fric
    (G,K). → costs (K,H), vis (H,K,3) rounded through bf16 (-1 vis_body:
    zeros). The ablations: `substep`'s, and zero_cost (no post-step FK or
    cost: the cost is q[0], or the root x of actor 0 without dofs, and vis
    is the sum of the actors' root positions, unrounded, where the JAX
    kernel writes zeros: an output that every substep's integration reaches,
    so that a hold of the ablated kernel sees the substeps)."""
    st = rows_to_state(ks, rows)
    mass_k, fric_k = mass.T, fric.T
    costs, vis = [], []
    for t in range(H):
        tgt = command_targets(ks, V[t].T, st["q"])
        for _ in range(substeps):
            st = substep(ks, st, tgt, mass_k, fric_k, dt_sub, sweeps, world_fidelity,
                         skip_contacts, skip_dynamics, two_way_sweeps, broadphase_gate)
        if zero_cost:
            costs.append(st["q"][:, 0] if ks.ndof else st["root_pos"][:, 0, 0])
            root = st["root_pos"]
            v = root[:, 0]
            for a in range(1, ks.nactor):           # the device code's order
                v = v + root[:, a]
            vis.append(v)
            continue
        pos, quat, _, _, _ = fk(ks, st)
        costs.append(task_cost(ks, st, pos, quat))
        if vis_body >= 0:
            vis.append(pos[vis_body].to(torch.bfloat16).to(pos[vis_body].dtype))
        else:
            vis.append(torch.zeros_like(pos[0]))
    return torch.stack(costs, 1), torch.stack(vis, 0)


def world_step_plain(ks: KernelScene, rows, tgt, mass, fric, substeps: int, dt_sub: float,
                     sweeps: int, two_way_sweeps: bool = True, broadphase_gate: bool = True):
    """Plain version of the world-step kernel (K2): rows (NS + 4·n_fc,) state
    and λ rows of one env, tgt (D,), mass (B,), fric (G,) → rows one control
    dt later. Envs side by side (rows (NS + 4·n_fc, N), tgt (N, D), mass
    (N, B), fric (N, G)) step together, each on its own. The ablations:
    `substep`'s two_way_sweeps and broadphase_gate."""
    one = rows.dim() == 1
    if one:
        rows, tgt, mass, fric = rows[:, None], tgt[None], mass[None], fric[None]
    st = rows_to_state(ks, rows)
    for _ in range(substeps):
        st = substep(ks, st, tgt, mass, fric, dt_sub, sweeps, two_way_sweeps=two_way_sweeps,
                     broadphase_gate=broadphase_gate)
    out = state_dict_to_rows(st)
    return out[:, 0] if one else out


class FusedRollout:
    """K1: the whole K-sample, H-step MPPI rollout in one kernel launch.

    Per step: dof targets = W @ u with the gripper binarize, `substeps`
    physics substeps, then FK and the task cost on the post-step state, plus
    the position of one body for visualization. At world fidelity the λ rows
    are carried across the trajectory, seeded from the world's contact_lam;
    at fast fidelity (`world_fidelity=False`) each substep's impulse sweeps
    start from zero, with no stiction snap and no λ rows, and
    `manifold="reduced"` gives the rollout contact tables of its own with 8
    corner samples per box–box direction."""

    launches = 0
    ablated_launches: Dict[int, int] = {}   # mask → launches of the ablation library

    def __init__(self, built, engine, cost: CostSpec, H: int, K: int,
                 vis_body: Optional[int] = None, substeps: Optional[int] = None,
                 impulse_sweeps: int = 2, world_fidelity: bool = True, manifold: str = "full",
                 profile: Optional[dict] = None):
        if cost is None or cost.task not in TASKS:
            raise NotImplementedError(f"no CUDA cost for task spec {cost}")
        self.profile, self.mask = ablation(profile)
        if manifold not in ("full", "reduced"):
            raise ValueError(f"rollout manifold {manifold!r}: 'full' or 'reduced'")
        # the reduced manifold only serves fast fidelity: at world fidelity the
        # rollout shares the world's λ rows, indexed by the world's tables
        tables = engine.tables
        if manifold == "reduced" and not world_fidelity:
            tables = build_contact_tables(built.scene, bbc_samples=8)
        self.world_fidelity = bool(world_fidelity)
        self.manifold = manifold
        self.tables = tables
        self.ks = KernelScene.build(built, engine, cost, tables=tables)
        self.fc_idx = free_cand_indices(built.scene, tables)
        self.n_rows = self.ks.n_rows if self.world_fidelity else self.ks.n_state_rows
        self.H, self.K = int(H), int(K)
        self.nu = self.ks.nu
        self.vis_body = -1 if vis_body is None else int(vis_body)
        self.substeps = engine.substeps if substeps is None else int(substeps)
        self.dt_sub = engine.scene.dt / self.substeps
        self.impulse_sweeps = int(impulse_sweeps)
        self._tables = _DeviceTables(self.ks, self.vis_body, self.fc_idx)
        self.warp_bytes = region_bytes(self.ks)
        self._warps: Dict[int, int] = {}  # device index → warps per block

    def set_cost(self, cost: CostSpec):
        """Take another cost for the same scene (new weights, goal or
        objective): re-pack the cost constants into the scene tables and
        copy them to the device, with no new build. The cost indexes this
        scene's actors, bodies and dofs: a changed scene needs a new
        FusedRollout, with the cost from `kernel_cost(new_built)`."""
        if cost is None or cost.task not in TASKS:
            raise NotImplementedError(f"no CUDA cost for task spec {cost}")
        self.ks = dataclasses.replace(self.ks, cost=cost)
        self._tables.repack(self.ks)

    def warps(self, device: torch.device) -> int:
        """Warps (samples) per block of the launches on a CUDA device."""
        W = self._warps.get(device.index)
        if W is None:
            n_sm = torch.cuda.get_device_properties(device).multi_processor_count
            W = self._warps[device.index] = warps_per_block(self.warp_bytes, self.K, n_sm)
        return W

    def pack(self, sim_state_K: SimState, params_K: ModelParams, V_khn: torch.Tensor):
        """→ the kernel inputs: rows (NS + 4·n_fc, K) f32 (fast fidelity: NS),
        V (H,nu,K) bf16 (the rounding the TPU kernel applies to its
        controls), mass (B,K), fric (G,K)."""
        lam = _lam_rows(self.ks, self._tables, sim_state_K.contact_lam, (self.K,),
                        sim_state_K.q.device) if self.world_fidelity else None
        rows = state_to_rows(self.ks, sim_state_K.root_state, sim_state_K.q, sim_state_K.qd, lam)
        V = V_khn.to(torch.bfloat16).permute(1, 2, 0).contiguous()
        mass = params_K.body_mass_scale.to(torch.float32).T.contiguous()
        fric = params_K.geom_friction.to(torch.float32).T.contiguous()
        return rows, V, mass, fric

    def rollout(self, sim_state_K: SimState, params_K: ModelParams, V_khn: torch.Tensor):
        """sim_state_K: SimState with leading K; params_K: ModelParams (K,·);
        V_khn: (K, H, nu). → (costs (K,H), vis (H,K,3))."""
        with span("k1.pack"):
            packed = self.pack(sim_state_K, params_K, V_khn)
        with span("k1.launch"):
            return self.run(*packed)

    @staticmethod
    def psi_columns():
        """(solved, held): K1's Ψ columns since its library was loaded, over
        every launch's samples and substeps: those solved (the Ψ slots with a
        live block) and those the actors' Ψ slots hold. Waits for the device.
        None without CUDA (the plain version counts none)."""
        if not torch.cuda.is_available():
            return None
        out = (ctypes.c_ulonglong * 2)()
        rc = _library().psi_columns(ctypes.cast(out, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"psi_columns failed: error {rc}")
        return int(out[0]), int(out[1])

    def _check_inputs(self, rows, V, mass, fric):
        ks, K, dev = self.ks, self.K, rows.device
        _check("rows", rows, (self.n_rows, K), torch.float32, dev)
        _check("V", V, (self.H, self.nu, K), torch.bfloat16, dev)
        _check("mass", mass, (ks.nbody, K), torch.float32, dev)
        _check("fric", fric, (ks.ngeom, K), torch.float32, dev)

    def plain(self, rows, V, mass, fric):
        """The kernel's plain PyTorch version, on any device."""
        self._check_inputs(rows, V, mass, fric)
        return rollout_plain(self.ks, rows, V.to(torch.float32), mass, fric, self.H,
                             self.substeps, self.dt_sub, self.vis_body, self.impulse_sweeps,
                             self.world_fidelity, **self.profile)

    def run(self, rows, V, mass, fric):
        """Packed inputs → (costs (K,H), vis (H,K,3)): the CUDA kernel on CUDA
        tensors, its plain version on CPU tensors."""
        if rows.device.type == "cpu":
            return self.plain(rows, V, mass, fric)
        _require_cuda(rows.device)
        self._check_inputs(rows, V, mass, fric)
        if self.mask and self.mask not in K1_MASKS:
            raise NotImplementedError(f"profile {self.profile}: mask {self.mask} is not one of "
                                      f"the ablation library's K1 masks {K1_MASKS}")
        lib = _library("ablate" if self.mask else None)
        costs = torch.empty(self.K, self.H, dtype=torch.float32, device=rows.device)
        vis = torch.empty(self.H, self.K, 3, dtype=torch.float32, device=rows.device)
        args = (self._tables.tables(rows.device).data_ptr(), rows.data_ptr(), V.data_ptr(),
                mass.data_ptr(), fric.data_ptr(), costs.data_ptr(), vis.data_ptr(),
                self.K, self.H, self.substeps, self.dt_sub, self.impulse_sweeps,
                int(self.world_fidelity), self.warps(rows.device), self.warp_bytes,
                torch.cuda.current_stream(rows.device).cuda_stream)
        with torch.cuda.device(rows.device):
            rc = (lib.fused_rollout_launch_ablate(self.mask, *args) if self.mask
                  else lib.fused_rollout_launch(*args))
        if rc != 0:
            raise RuntimeError(f"fused_rollout_kernel (ablation mask {self.mask}) launch "
                               f"failed: error {rc}")
        if self.mask:
            n = FusedRollout.ablated_launches
            n[self.mask] = n.get(self.mask, 0) + 1
        else:
            type(self).launches += 1
        return costs, vis


class FusedWorldStep:
    """K2: N ≥ 1 envs, each advanced one control dt (every substep,
    `impulse_sweeps` sweeps each), in one launch of one warp per env. `step`
    seeds each env's λ rows from its SimState.contact_lam, scatters them
    back, and takes the body caches of the stepped state from K2's epilogue
    on the card, from the engine's torch refresh on the CPU (the reference
    the kernel is held to), counted in `torch_refreshes`."""

    launches = 0
    torch_refreshes = 0                     # world steps whose caches came from engine.refresh
    ablated_launches: Dict[int, int] = {}   # mask → launches of the ablation library

    def __init__(self, built, engine, impulse_sweeps: int = 16, profile: Optional[dict] = None):
        self.profile, self.mask = ablation(profile, K2_SWITCHES)
        self.engine = engine
        self.ks = KernelScene.build(built, engine, None)
        self.fc_idx = free_cand_indices(built.scene, engine.tables)
        self.substeps = engine.substeps
        self.dt_sub = engine.dt_sub
        self.impulse_sweeps = int(impulse_sweeps)
        self._tables = _DeviceTables(self.ks, -1, self.fc_idx)
        self.warp_bytes = region_bytes(self.ks)
        self._warps: Dict[tuple, int] = {}  # (device index, N) → warps per block

    def warps(self, device: torch.device, N: int = 1) -> int:
        """Warps (envs) per block of a launch over N envs on a CUDA device
        (1 at N = 1)."""
        W = self._warps.get((device.index, N))
        if W is None:
            n_sm = torch.cuda.get_device_properties(device).multi_processor_count
            W = self._warps[(device.index, N)] = warps_per_block(self.warp_bytes, N, n_sm)
        return W

    def _check_inputs(self, rows, tgt, mass, fric) -> int:
        """The kernel's layout, env-fastest: rows (NS + 4·n_fc, N), tgt (D, N),
        mass (B, N), fric (G, N); one env may drop the N axis. → N."""
        ks, dev = self.ks, rows.device
        lead = tuple(rows.shape[1:2])
        if rows.dim() not in (1, 2) or lead == (0,):
            raise ValueError(f"rows: shape {tuple(rows.shape)}, expected ({ks.n_rows},) or "
                             f"({ks.n_rows}, N ≥ 1)")
        _check("rows", rows, (ks.n_rows,) + lead, torch.float32, dev)
        _check("tgt", tgt, (ks.ndof,) + lead, torch.float32, dev)
        _check("mass", mass, (ks.nbody,) + lead, torch.float32, dev)
        _check("fric", fric, (ks.ngeom,) + lead, torch.float32, dev)
        return lead[0] if lead else 1

    def plain(self, rows, tgt, mass, fric):
        """The kernel's plain PyTorch version, on any device, in the
        kernel's layout."""
        self._check_inputs(rows, tgt, mass, fric)
        if rows.dim() == 2:                     # world_step_plain takes envs first
            tgt, mass, fric = tgt.T, mass.T, fric.T
        return world_step_plain(self.ks, rows, tgt, mass, fric, self.substeps, self.dt_sub,
                                self.impulse_sweeps, **self.profile).contiguous()

    def step_rows(self, rows, tgt, mass, fric, body: Optional[torch.Tensor] = None):
        """rows (NS + 4·n_fc, N), tgt (D, N), mass (B, N), fric (G, N) → rows
        one dt later (one env: the same without the N axis). On the card,
        `body` (13·B, N) takes the body caches of the stepped state (K2's
        epilogue; the layout of csrc/fused_rollout.cu `write_bodies`)."""
        if rows.device.type == "cpu":
            if body is not None:
                raise ValueError("body: the plain version writes no body caches; "
                                 "engine.refresh computes them on the CPU")
            return self.plain(rows, tgt, mass, fric)
        _require_cuda(rows.device)
        N = self._check_inputs(rows, tgt, mass, fric)
        if body is not None:
            _check("body", body, (13 * self.ks.nbody,) + tuple(rows.shape[1:2]), torch.float32,
                   rows.device)
        if self.mask and self.mask not in K2_MASKS:
            raise NotImplementedError(f"profile {self.profile}: mask {self.mask} is not one of "
                                      f"the ablation library's K2 masks {K2_MASKS}")
        lib = _library("ablate" if self.mask else None)
        out = torch.empty_like(rows)
        args = (self._tables.tables(rows.device).data_ptr(), rows.data_ptr(), tgt.data_ptr(),
                mass.data_ptr(), fric.data_ptr(), out.data_ptr(),
                None if body is None else body.data_ptr(), N, self.substeps, self.dt_sub,
                self.impulse_sweeps, self.warps(rows.device, N), self.warp_bytes,
                torch.cuda.current_stream(rows.device).cuda_stream)
        with torch.cuda.device(rows.device):
            rc = (lib.fused_world_step_launch_ablate(self.mask, *args) if self.mask
                  else lib.fused_world_step_launch(*args))
        if rc != 0:
            raise RuntimeError(f"fused_world_step_kernel (ablation mask {self.mask}) launch "
                               f"failed: error {rc}")
        if self.mask:
            n = FusedWorldStep.ablated_launches
            n[self.mask] = n.get(self.mask, 0) + 1
        else:
            type(self).launches += 1
        return out

    def pack(self, state: SimState) -> torch.Tensor:
        """→ the rows of `state`: (NS + 4·n_fc, N) for N envs, (NS + 4·n_fc,)
        for one env without the leading axis."""
        if state.q.dim() == 1:
            return self.pack(state.map(lambda x: x[None]))[:, 0]
        lead = tuple(state.q.shape[:1])
        lam = _lam_rows(self.ks, self._tables, state.contact_lam, lead, state.q.device)
        return state_to_rows(self.ks, state.root_state, state.q, state.qd, lam)

    def unpack(self, state: SimState, out: torch.Tensor,
               body: Optional[torch.Tensor] = None) -> SimState:
        """`state` of N envs (leading axis N) and K2's rows of it one dt
        later, out (NS + 4·n_fc, N), → the stepped SimState: λ rows
        scattered into contact_lam, the body caches from K2's body rows
        (13·B, N); without them the caches are `state`'s, for
        `engine.refresh` to compute."""
        B, N = self.ks.nbody, state.q.shape[0]
        # the fields as views of one contiguous (N, rows) buffer
        rs = rows_to_state(self.ks, out.T.contiguous().T)
        fc_lam = rs.pop("lam", None)
        st = state.replace(net_contact_force=rs.pop("net_cf"), **rs)
        lam = state.contact_lam
        if self.ks.n_fc and lam is not None and tuple(lam.shape[1:]) == (self.ks.n_con, 4):
            lam = lam.clone()
            lam[:, self._tables.fc(lam.device)] = fc_lam
            st = st.replace(contact_lam=lam)
        if body is not None:
            bt = body.T.contiguous()
            return st.replace(body_pos=bt[:, : 3 * B].reshape(N, B, 3),
                              body_quat=bt[:, 3 * B: 7 * B].reshape(N, B, 4),
                              body_linvel=bt[:, 7 * B: 10 * B].reshape(N, B, 3),
                              body_angvel=bt[:, 10 * B:].reshape(N, B, 3))
        return st

    def step(self, state: SimState, params: ModelParams) -> SimState:
        """SimState of N envs (leading axis N; params (N, B) and (N, G)), or
        of one env without it → the same one control dt later, body caches
        refreshed, λ rows scattered into contact_lam."""
        if state.q.dim() == 1:
            one = self.step(state.map(lambda x: x[None]), params.map(lambda x: x[None]))
            return one.map(lambda x: x[0])
        dev, N = state.q.device, state.q.shape[0]
        with span("k2.pack"):
            packed = (self.pack(state).contiguous(),
                      state.dof_target.to(torch.float32).T.contiguous(),
                      params.body_mass_scale.to(torch.float32).T.contiguous(),
                      params.geom_friction.to(torch.float32).T.contiguous())
        with span("k2.launch"):
            body = (None if dev.type == "cpu"
                    else torch.empty(13 * self.ks.nbody, N, dtype=torch.float32, device=dev))
            out = self.step_rows(*packed, body=body)
        with span("k2.unpack"):
            st = self.unpack(state, out, body)
        if body is not None:
            return st
        type(self).torch_refreshes += 1
        with span("world.refresh"):
            return self.engine.refresh(st)
