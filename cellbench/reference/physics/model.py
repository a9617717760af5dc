# Frozen copy of mppiisaac_tpu_torch/physics/model.py, part of the benchmark's yardstick.
"""Numeric articulation + scene model (static data for the physics step).

Capability parity with the reference's asset/actor pipeline
(the reference's `isaacgym_wrapper.py:429-508`, `isaacgym_utils.py:14-58`) but
as plain numpy arrays: built once on the host, closed over as constants by the
physics step. No handles, no acquire/refresh — state lives in
:class:`mppiisaac_tpu_torch.physics.types.SimState`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .urdf import (
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_SPHERE,
    JOINT_FIXED,
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    RobotSpec,
)

# DOF drive modes (parity: reference `isaacgym_wrapper.py:491-507`)
DRIVE_NONE = 0
DRIVE_VELOCITY = 1    # stiffness 0, damping 600
DRIVE_POSITION = 2    # stiffness 80, damping 0
DRIVE_EFFORT = 3      # stiffness 0, passive damping 10

DRIVE_VELOCITY_KD = 600.0
DRIVE_POSITION_KP = 80.0
DRIVE_EFFORT_KD = 10.0


@dataclass
class GeomSpec:
    body: int                 # local body index within the articulation
    gtype: int
    size: np.ndarray          # (3,)
    pos: np.ndarray           # (3,) local offset in body frame
    quat: np.ndarray          # (4,) xyzw
    friction: float = 1.0
    torsion_friction: float = 0.005
    rolling_friction: float = 0.0


@dataclass
class Articulation:
    """One actor's kinematic/dynamic description. Bodies are topologically
    ordered (parent index < child index), body 0 = root link."""

    name: str
    nbody: int
    ndof: int
    fixed_base: bool
    parent: np.ndarray        # (nbody,) int, -1 for root
    jtype: np.ndarray         # (nbody,) int (joint connecting body to parent)
    jaxis: np.ndarray         # (nbody,3)
    jpos: np.ndarray          # (nbody,3) joint origin in parent frame
    jquat: np.ndarray         # (nbody,4)
    dof_index: np.ndarray     # (nbody,) int, -1 for fixed joints
    mass: np.ndarray          # (nbody,)
    com: np.ndarray           # (nbody,3) in body frame
    inertia: np.ndarray       # (nbody,3,3) about com, body frame
    dof_lower: np.ndarray     # (ndof,)
    dof_upper: np.ndarray
    dof_effort: np.ndarray
    dof_maxvel: np.ndarray
    dof_damping: np.ndarray   # passive (URDF <dynamics>)
    dof_friction: np.ndarray
    dof_armature: np.ndarray
    drive_mode: np.ndarray    # (ndof,) int
    drive_kp: np.ndarray      # (ndof,)
    drive_kd: np.ndarray      # (ndof,)
    geoms: List[GeomSpec] = field(default_factory=list)
    link_names: List[str] = field(default_factory=list)
    dof_names: List[str] = field(default_factory=list)
    disable_gravity: bool = False
    # intra-actor (self) collision. Default OFF, matching the reference:
    # Isaac Gym's create_actor is called without a collision filter
    # (`isaacgym_wrapper.py:437-442`), which masks off all within-actor
    # collision — objective weights were tuned against that behavior, and
    # the self-collision pairs were ~40% of the contact-candidate table
    self_collision: bool = False

    def link_index(self, name: str) -> int:
        return self.link_names.index(name)

    def dof_id(self, joint_name: str) -> int:
        return self.dof_names.index(joint_name)


def build_articulation(
    spec: RobotSpec,
    fixed_base: bool = False,
    dof_mode: str = "velocity",
    friction: float = 1.0,
    disable_gravity: bool = False,
    armature: float = 0.0,
) -> Articulation:
    """RobotSpec (parsed URDF) → numeric Articulation.

    DOF order = URDF joint document order restricted to movable joints — the
    convention the reference inherits from Isaac Gym's importer and that its
    command layout depends on (`isaacgym_wrapper.py:524-572`).
    """
    # topological order: root first, children following their parents,
    # tie-broken by joint document order
    order: List[str] = [spec.root_link]
    joint_of_child = {}
    placed = {spec.root_link}
    while True:
        grew = False
        for j in spec.joints:
            if j.parent in placed and j.child not in placed:
                order.append(j.child)
                joint_of_child[j.child] = j
                placed.add(j.child)
                grew = True
        if not grew:
            break
    if len(order) != len(spec.links):
        missing = set(spec.links) - placed
        raise ValueError(f"{spec.name}: disconnected links {missing}")

    nb = len(order)
    idx = {n: i for i, n in enumerate(order)}
    parent = np.full(nb, -1, dtype=np.int32)
    jtype = np.zeros(nb, dtype=np.int32)
    jaxis = np.tile(np.array([1.0, 0, 0]), (nb, 1))
    jpos = np.zeros((nb, 3))
    jquat = np.tile(np.array([0.0, 0, 0, 1.0]), (nb, 1))
    dof_index = np.full(nb, -1, dtype=np.int32)
    mass = np.zeros(nb)
    com = np.zeros((nb, 3))
    inertia = np.zeros((nb, 3, 3))

    # movable joints in document order define dof ids
    movable = [j for j in spec.joints if j.jtype != JOINT_FIXED]
    dof_of_joint = {j.name: k for k, j in enumerate(movable)}
    ndof = len(movable)

    dof_lower = np.full(ndof, -1e9)
    dof_upper = np.full(ndof, 1e9)
    dof_effort = np.full(ndof, 1e9)
    dof_maxvel = np.full(ndof, 1e9)
    dof_damping = np.zeros(ndof)
    dof_friction = np.zeros(ndof)
    dof_names = [j.name for j in movable]

    for ln, i in idx.items():
        link = spec.links[ln]
        mass[i] = link.mass
        com[i] = link.com
        inertia[i] = link.inertia
        if i == 0:
            continue
        j = joint_of_child[ln]
        parent[i] = idx[j.parent]
        jtype[i] = j.jtype
        jaxis[i] = j.axis
        jpos[i] = j.origin_pos
        jquat[i] = j.origin_quat
        if j.jtype != JOINT_FIXED:
            k = dof_of_joint[j.name]
            dof_index[i] = k
            dof_lower[k] = j.lower
            dof_upper[k] = j.upper
            dof_effort[k] = j.effort
            dof_maxvel[k] = j.velocity
            dof_damping[k] = j.damping
            dof_friction[k] = j.friction

    # drive config (reference defaults, isaacgym_wrapper.py:491-507)
    if dof_mode == "velocity":
        kp, kd, mode = 0.0, DRIVE_VELOCITY_KD, DRIVE_VELOCITY
    elif dof_mode == "position":
        kp, kd, mode = DRIVE_POSITION_KP, 0.0, DRIVE_POSITION
    elif dof_mode == "effort":
        kp, kd, mode = 0.0, DRIVE_EFFORT_KD, DRIVE_EFFORT
    elif dof_mode == "none":
        kp, kd, mode = 0.0, 0.0, DRIVE_NONE  # passive joints (tests)
    else:
        raise ValueError(f"invalid dof_mode {dof_mode!r}")

    drive_mode_arr = np.full(ndof, mode, dtype=np.int32)
    drive_kp_arr = np.full(ndof, kp)
    drive_kd_arr = np.full(ndof, kd)
    # gripper finger DOFs always use force-limited POSITION drives regardless
    # of the actor's dof_mode (the reference likewise sets gripper DOFs to
    # DOF_MODE_POS and binarizes targets, `isaacgym_wrapper.py:493-507,
    # 561-565`). A velocity/damping drive has no positional memory: held at a
    # zero-velocity target it resists only with damping, so the off-finger's
    # push ratchets the grip open and a grasped block walks out. kp must stay
    # UNSATURATED at grip (force < effort limit at typical pad-to-target
    # error): a saturated constant-force clamp has zero centering stiffness
    # (neutral equilibrium — the grip wanders along the clamp axis), while an
    # unsaturated spring pair centers the object at ~2·kp stiffness.
    # EXCEPTION: effort-mode robots keep effort-driven fingers — the reference
    # fills ALL DOFs with DOF_MODE_EFFORT (isaacgym_wrapper.py:493-507) and
    # its gripper binarize never fires for the omnipanda (it string-matches
    # actor name 'panda_gripper', examples' omni actor is 'omnipanda'), so
    # omni_panda_pick's fingers are raw ±6 N efforts shaped by the
    # comfy_gripper_state cost term.
    if dof_mode != "effort":
        for k, jn in enumerate(dof_names):
            if "finger" in jn:
                drive_mode_arr[k] = DRIVE_POSITION
                drive_kp_arr[k] = 600.0
                drive_kd_arr[k] = 30.0

    geoms: List[GeomSpec] = []
    for ln, i in idx.items():
        for g in spec.links[ln].geoms:
            geoms.append(
                GeomSpec(
                    body=i,
                    gtype=g.gtype,
                    size=np.asarray(g.size, dtype=np.float64),
                    pos=np.asarray(g.pos, dtype=np.float64),
                    quat=np.asarray(g.quat, dtype=np.float64),
                    friction=friction,
                )
            )

    return Articulation(
        name=spec.name,
        nbody=nb,
        ndof=ndof,
        fixed_base=fixed_base,
        parent=parent,
        jtype=jtype,
        jaxis=jaxis,
        jpos=jpos,
        jquat=jquat,
        dof_index=dof_index,
        mass=mass,
        com=com,
        inertia=inertia,
        dof_lower=dof_lower,
        dof_upper=dof_upper,
        dof_effort=dof_effort,
        dof_maxvel=dof_maxvel,
        dof_damping=dof_damping,
        dof_friction=dof_friction,
        dof_armature=np.full(ndof, armature),
        drive_mode=drive_mode_arr,
        drive_kp=drive_kp_arr,
        drive_kd=drive_kd_arr,
        geoms=geoms,
        link_names=list(order),
        dof_names=dof_names,
        disable_gravity=disable_gravity,
    )


def _box_inertia(m: float, half: np.ndarray) -> np.ndarray:
    hx, hy, hz = half * 2.0
    return np.diag(
        [
            m / 12.0 * (hy * hy + hz * hz),
            m / 12.0 * (hx * hx + hz * hz),
            m / 12.0 * (hx * hx + hy * hy),
        ]
    )


def _sphere_inertia(m: float, r: float) -> np.ndarray:
    return np.eye(3) * (0.4 * m * r * r)


def primitive_articulation(
    name: str,
    gtype: int,
    size,
    mass: float = 1.0,
    fixed: bool = False,
    friction: float = 1.0,
    disable_gravity: bool = False,
) -> Articulation:
    """Single rigid body (sphere/box obstacle, block, goal marker...) as a
    0-DOF articulation — parity with the reference's non-robot actor types
    (`isaacgym_wrapper.py:42-47`)."""
    size = np.asarray(size, dtype=np.float64)
    if gtype == GEOM_SPHERE:
        I = _sphere_inertia(mass, size[0])
        gsize = np.array([size[0], 0.0, 0.0])
    elif gtype == GEOM_BOX:
        half = size / 2.0
        I = _box_inertia(mass, half)
        gsize = half
    elif gtype == GEOM_CAPSULE:
        I = _sphere_inertia(mass, size[0])
        gsize = np.array([size[0], size[1], 0.0])
    else:
        raise ValueError(f"bad gtype {gtype}")
    return Articulation(
        name=name,
        nbody=1,
        ndof=0,
        fixed_base=fixed,
        parent=np.array([-1], dtype=np.int32),
        jtype=np.zeros(1, dtype=np.int32),
        jaxis=np.array([[1.0, 0, 0]]),
        jpos=np.zeros((1, 3)),
        jquat=np.array([[0.0, 0, 0, 1.0]]),
        dof_index=np.array([-1], dtype=np.int32),
        mass=np.array([mass]),
        com=np.zeros((1, 3)),
        inertia=I[None],
        dof_lower=np.zeros(0),
        dof_upper=np.zeros(0),
        dof_effort=np.zeros(0),
        dof_maxvel=np.zeros(0),
        dof_damping=np.zeros(0),
        dof_friction=np.zeros(0),
        dof_armature=np.zeros(0),
        drive_mode=np.zeros(0, dtype=np.int32),
        drive_kp=np.zeros(0),
        drive_kd=np.zeros(0),
        geoms=[
            GeomSpec(
                body=0,
                gtype=gtype,
                size=gsize,
                pos=np.zeros(3),
                quat=np.array([0.0, 0, 0, 1.0]),
                friction=friction,
            )
        ],
        link_names=[name],
        dof_names=[],
        disable_gravity=disable_gravity,
    )
