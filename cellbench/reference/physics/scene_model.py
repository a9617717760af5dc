# Frozen copy of mppiisaac_tpu_torch/physics/scene_model.py, part of the benchmark's yardstick.
"""Scene-level static model: a set of articulations + global index maps +
flattened geometry tables for the contact engine."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .model import Articulation


@dataclass
class SceneModel:
    actors: List[Articulation]
    actor_names: List[str]
    gravity: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, -9.8]))
    ground: bool = True                      # world plane z=0
    dt: float = 0.05
    substeps: int = 2

    # contact material defaults (tunable; reference hard-codes PhysX TGS with
    # contact_offset=0.01/rest_offset=0 — isaacgym_wrapper.py:30-36)
    contact_stiffness: float = 2.0e4
    contact_damping: float = 2.0e3
    friction_smoothing_vel: float = 0.05     # regularized Coulomb transition (m/s)
    contact_offset: float = 0.01
    # stability clamps (PhysX-style max depenetration / velocity caps)
    max_contact_depth: float = 0.04          # cap on penetration used by the force law
    max_root_linvel: float = 8.0
    max_root_angvel: float = 25.0
    # articulated↔free coupling stiffness: the penalty on the ARTICULATED side
    # of a pair whose free side is impulse-solved. Fixed (not mass-scaled) so
    # strong actuators feel light objects — a gripper must stall on a block
    couple_stiffness: float = 1.0e4
    # gripper force gate: finger dofs stop closing once their link feels this
    # much contact force (models a force-controlled gripper; PhysX stalls
    # fingers via contact constraints, explicit penalties cannot)
    grip_force_gate: float = 10.0

    # derived (filled in __post_init__)
    body_offset: List[int] = field(default_factory=list)
    dof_offset: List[int] = field(default_factory=list)
    nbody: int = 0
    ndof: int = 0
    body_actor: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    # flattened geom tables
    geom_body: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))   # global body idx
    geom_type: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    geom_size: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    geom_pos: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    geom_quat: np.ndarray = field(default_factory=lambda: np.zeros((0, 4)))
    geom_friction: np.ndarray = field(default_factory=lambda: np.zeros(0))
    geom_collision: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    # contact pair list (global geom indices), static
    pair_a: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    pair_b: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    plane_geoms: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))

    collision_enabled: Optional[List[bool]] = None   # per actor

    def __post_init__(self):
        self.finalize()

    def finalize(self):
        bo, do = [], []
        b = d = 0
        body_actor = []
        for ai, a in enumerate(self.actors):
            bo.append(b)
            do.append(d)
            body_actor += [ai] * a.nbody
            b += a.nbody
            d += a.ndof
        self.body_offset, self.dof_offset = bo, do
        self.nbody, self.ndof = b, d
        self.body_actor = np.asarray(body_actor, dtype=np.int32)

        if self.collision_enabled is None:
            self.collision_enabled = [True] * len(self.actors)

        gb, gt, gs, gp, gq, gf, gc = [], [], [], [], [], [], []
        geom_local_body = []  # (actor_idx, local body) for adjacency filtering
        for ai, a in enumerate(self.actors):
            for g in a.geoms:
                gb.append(self.body_offset[ai] + g.body)
                geom_local_body.append((ai, g.body))
                gt.append(g.gtype)
                gs.append(g.size)
                gp.append(g.pos)
                gq.append(g.quat)
                gf.append(g.friction)
                gc.append(self.collision_enabled[ai])
        n = len(gb)
        self.geom_body = np.asarray(gb, dtype=np.int32)
        self.geom_type = np.asarray(gt, dtype=np.int32)
        self.geom_size = np.asarray(gs).reshape(n, 3)
        self.geom_pos = np.asarray(gp).reshape(n, 3)
        self.geom_quat = np.asarray(gq).reshape(n, 4)
        self.geom_friction = np.asarray(gf)
        self.geom_collision = np.asarray(gc, dtype=bool)

        # static broadphase: all cross-actor pairs + same-actor non-adjacent
        # pairs, collision-enabled only. (The reference gets per-env isolation
        # via PhysX collision groups — isaacgym_wrapper.py:441; here envs are
        # separate by construction under vmap.)
        pa, pb = [], []
        for i in range(n):
            if not self.geom_collision[i]:
                continue
            ai, bi_local = geom_local_body[i]
            for j in range(i + 1, n):
                if not self.geom_collision[j]:
                    continue
                aj, bj_local = geom_local_body[j]
                if self.geom_body[i] == self.geom_body[j]:
                    continue
                if ai == aj:
                    art = self.actors[ai]
                    # intra-actor collision is OPT-IN (default off, matching
                    # the reference's filter-less create_actor — see
                    # model.Articulation.self_collision)
                    if not getattr(art, "self_collision", False):
                        continue
                    # skip parent-child adjacency (connected by a joint)
                    if (
                        art.parent[bj_local] == bi_local
                        or art.parent[bi_local] == bj_local
                    ):
                        continue
                    # skip fixed-base robots' internal chains beyond
                    # grandparent to avoid spurious self-collision chatter
                    if (
                        art.parent[bj_local] >= 0
                        and art.parent[art.parent[bj_local]] == bi_local
                    ) or (
                        art.parent[bi_local] >= 0
                        and art.parent[art.parent[bi_local]] == bj_local
                    ):
                        continue
                pa.append(i)
                pb.append(j)
        self.pair_a = np.asarray(pa, dtype=np.int32)
        self.pair_b = np.asarray(pb, dtype=np.int32)

        # geoms that collide with the ground plane: skip geoms on fixed root
        # bodies (tables/walls are modeled as fixed actors; their plane contact
        # would be inert anyway)
        pg = []
        if self.ground:
            for i in range(n):
                if not self.geom_collision[i]:
                    continue
                ai, bl = geom_local_body[i]
                if self.actors[ai].fixed_base and self.actors[ai].ndof == 0:
                    continue
                pg.append(i)
        self.plane_geoms = np.asarray(pg, dtype=np.int32)

    # ------------------------------------------------------------------
    # name-based lookups (serving the reference's named getter surface,
    # `isaacgym_wrapper.py:298-356`)
    # ------------------------------------------------------------------
    def actor_index(self, name: str) -> int:
        return self.actor_names.index(name)

    def body_index(self, link_name: str, actor_name: Optional[str] = None) -> int:
        """Global rigid-body index for a link name (optionally scoped to actor)."""
        for ai, a in enumerate(self.actors):
            if actor_name is not None and self.actor_names[ai] != actor_name:
                continue
            if link_name in a.link_names:
                return self.body_offset[ai] + a.link_names.index(link_name)
        raise KeyError(link_name)

    def actor_dof_slice(self, name: str) -> slice:
        ai = self.actor_index(name)
        return slice(self.dof_offset[ai], self.dof_offset[ai] + self.actors[ai].ndof)

    @property
    def nactor(self) -> int:
        return len(self.actors)

    @property
    def ngeom(self) -> int:
        return len(self.geom_body)
