# Frozen copy of mppiisaac_tpu_torch/scene/robots.py, part of the benchmark's yardstick.
"""Procedurally-authored robot URDF library.

The reference ships ~420 URDF/mesh asset files (SURVEY §2 'Assets'); the
contact-relevant geometry is primitives (SURVEY §7.1). Here every robot of the
reference's suite is regenerated programmatically from public kinematic
parameters (Franka panda DH/frame values from franka_description; simple
mobile bases) with primitive collision shapes — nothing is copied from the
reference tree, and the generated URDFs also serve as parser test vectors.

Registry: `robot_urdf(name) -> URDF XML string`.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# tiny URDF emitter
# ---------------------------------------------------------------------------


class U:
    def __init__(self, name: str):
        self.name = name
        self.parts = [f'<robot name="{name}">']

    def link(self, name, mass=0.0, com=(0, 0, 0), inertia=None, geoms=()):
        """geoms: list of (kind, params, xyz, rpy); kind ∈ sphere/box/cylinder/capsule."""
        s = [f'  <link name="{name}">']
        if mass > 0:
            if inertia is None:
                i = 0.02 * mass
                inertia = (i, i, i)
            ix, iy, iz = inertia
            s.append(
                f'    <inertial><origin xyz="{com[0]} {com[1]} {com[2]}"/>'
                f'<mass value="{mass}"/>'
                f'<inertia ixx="{ix}" iyy="{iy}" izz="{iz}" ixy="0" ixz="0" iyz="0"/></inertial>'
            )
        for kind, params, xyz, rpy in geoms:
            if kind == "sphere":
                g = f'<sphere radius="{params[0]}"/>'
            elif kind == "box":
                g = f'<box size="{params[0]} {params[1]} {params[2]}"/>'
            elif kind == "cylinder":
                g = f'<cylinder radius="{params[0]}" length="{params[1]}"/>'
            else:
                g = f'<capsule radius="{params[0]}" length="{params[1]}"/>'
            s.append(
                f'    <collision><origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}" '
                f'rpy="{rpy[0]} {rpy[1]} {rpy[2]}"/><geometry>{g}</geometry></collision>'
            )
        s.append("  </link>")
        self.parts.append("\n".join(s))

    def joint(self, name, jtype, parent, child, xyz=(0, 0, 0), rpy=(0, 0, 0),
              axis=(0, 0, 1), lower=None, upper=None, effort=100.0, velocity=10.0,
              damping=0.0, friction=0.0):
        s = [f'  <joint name="{name}" type="{jtype}">']
        s.append(f'    <parent link="{parent}"/><child link="{child}"/>')
        s.append(f'    <origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}" rpy="{rpy[0]} {rpy[1]} {rpy[2]}"/>')
        if jtype != "fixed":
            s.append(f'    <axis xyz="{axis[0]} {axis[1]} {axis[2]}"/>')
            lo = -1e9 if lower is None else lower
            hi = 1e9 if upper is None else upper
            if jtype == "continuous":
                s.append(f'    <limit effort="{effort}" velocity="{velocity}"/>')
            else:
                s.append(f'    <limit lower="{lo}" upper="{hi}" effort="{effort}" velocity="{velocity}"/>')
            if damping or friction:
                s.append(f'    <dynamics damping="{damping}" friction="{friction}"/>')
        s.append("  </joint>")
        self.parts.append("\n".join(s))

    def xml(self) -> str:
        return "\n".join(self.parts + ["</robot>"])


# ---------------------------------------------------------------------------
# planar holonomic bases (point_robot, heijn): world → x → y → yaw, fixed base
# ---------------------------------------------------------------------------


def _planar_base(u: U, prefix="", effort=87.0, chassis_geoms=None, extent=50.0,
                 mass=10.0, inertia=(1.0, 1.0, 1.0)):
    u.link("world")
    u.link(f"{prefix}base_link_x", mass=1.0)
    u.link(f"{prefix}base_link_y", mass=1.0)
    u.link(
        f"{prefix}base_link",
        mass=mass,
        inertia=inertia,
        geoms=chassis_geoms or [],
    )
    u.joint(f"{prefix}mobile_joint_x", "prismatic", "world", f"{prefix}base_link_x",
            xyz=(0, 0, 0.05), axis=(1, 0, 0), lower=-extent, upper=extent,
            effort=effort, velocity=2.175)
    u.joint(f"{prefix}mobile_joint_y", "prismatic", f"{prefix}base_link_x", f"{prefix}base_link_y",
            axis=(0, 1, 0), lower=-extent, upper=extent, effort=effort, velocity=2.175)
    u.joint(f"{prefix}mobile_joint_theta", "revolute", f"{prefix}base_link_y", f"{prefix}base_link",
            axis=(0, 0, 1), lower=-extent * 100, upper=extent * 100, effort=effort, velocity=2.175)


def point_robot() -> str:
    u = U("point_robot")
    _planar_base(
        u,
        effort=87.0,
        chassis_geoms=[("cylinder", (0.2, 0.1), (0, 0, 0), (0, 0, 0))],
    )
    u.link("lidar_link", mass=1.0)
    u.joint("robot_lidar", "fixed", "base_link", "lidar_link", xyz=(0, 0, 0.1))
    return u.xml()


def heijn() -> str:
    """Omnidirectional base with an elongated chassis (front + rear capsules)."""
    u = U("heijn")
    _planar_base(
        u,
        effort=300.0,
        chassis_geoms=[
            ("box", (0.6, 0.35, 0.12), (0, 0, 0.05), (0, 0, 0)),
            ("capsule", (0.06, 0.23), (0.33, 0, 0.05), (0, 1.5707963, 0)),
        ],
    )
    u.link("front_link", mass=0.1)
    u.joint("front_link_joint", "fixed", "base_link", "front_link", xyz=(0.4, 0, 0.05))
    return u.xml()


# ---------------------------------------------------------------------------
# differential-drive bases (boxer, jackal, albert base)
# ---------------------------------------------------------------------------


def _diff_drive_base(u: U, wheel_radius=0.08, wheel_sep=0.494, chassis=(0.55, 0.40, 0.16),
                     chassis_mass=35.0, link_prefix="", top_link_z=None):
    """Floating chassis + 2 driven wheels (+x forward, wheels axis +y) + 2
    zero-friction caster spheres. Joint/link names match the reference actor
    configs (`conf/actors/boxer.yaml`: wheel_left_joint / rotacastor_*_link)."""
    cx, cy, cz = chassis
    u.link(
        f"{link_prefix}chassis_link",
        mass=chassis_mass,
        com=(0, 0, 0.12),
        inertia=(chassis_mass * 0.02, chassis_mass * 0.025, chassis_mass * 0.03),
        geoms=[("box", chassis, (0, 0, 0.065 + cz / 2), (0, 0, 0))],
    )
    for side, sy in (("left", +1), ("right", -1)):
        u.link(
            f"{link_prefix}wheel_{side}_link",
            mass=2.0,
            inertia=(0.005, 0.005, 0.005),
            geoms=[("capsule", (wheel_radius, 0.01), (0, 0, 0), (1.5707963, 0, 0))],
        )
        u.joint(
            f"{link_prefix}wheel_{side}_joint", "continuous",
            f"{link_prefix}chassis_link", f"{link_prefix}wheel_{side}_link",
            xyz=(0.157, sy * wheel_sep / 2, wheel_radius),
            axis=(0, 1, 0), effort=10000.0, velocity=1000.0,
        )
        u.link(
            f"{link_prefix}rotacastor_{side}_link",
            mass=0.5,
            geoms=[("sphere", (0.043,), (0, 0, 0), (0, 0, 0))],
        )
        u.joint(
            f"{link_prefix}rotacastor_{side}_joint", "fixed",
            f"{link_prefix}chassis_link", f"{link_prefix}rotacastor_{side}_link",
            xyz=(-0.274, sy * 0.177, 0.043),
        )


def boxer() -> str:
    u = U("boxer")
    _diff_drive_base(u)
    u.link("ee_link", mass=0.01)
    u.joint("ee_joint", "fixed", "chassis_link", "ee_link", xyz=(0.3, 0, 0.1))
    return u.xml()


def jackal() -> str:
    """4-wheel skid-steer (wheel_count 4): both wheels per side share a command."""
    u = U("jackal")
    cx, cy, cz = 0.42, 0.31, 0.18
    u.link(
        "chassis_link", mass=17.0, com=(0, 0, 0.15),
        inertia=(0.3, 0.4, 0.45),
        geoms=[("box", (cx, cy, cz), (0, 0, 0.092 + cz / 2), (0, 0, 0))],
    )
    r = 0.098
    for side, sy in (("left", 1), ("right", -1)):
        for fr, sx in (("front", 1), ("rear", -1)):
            ln = f"{fr}_{side}_wheel_link"
            u.link(ln, mass=0.5, inertia=(0.002, 0.002, 0.002),
                   geoms=[("capsule", (r, 0.02), (0, 0, 0), (1.5707963, 0, 0))])
            u.joint(f"{fr}_{side}_wheel_joint", "continuous", "chassis_link", ln,
                    xyz=(sx * 0.131, sy * 0.37795 / 2 * 2, r), axis=(0, 1, 0),
                    effort=10000.0, velocity=1000.0)
    u.link("ee_link", mass=0.01)
    u.joint("ee_joint", "fixed", "chassis_link", "ee_link", xyz=(0.25, 0, 0.2))
    return u.xml()


def husky() -> str:
    """Clearpath Husky A200: 4-wheel skid-steer (public spec: 46.7 kg chassis,
    0.165 m wheels, 0.555 m track, 0.512 m wheelbase). Completes the
    reference's asset library (`assets/urdf/husky_description/husky.urdf` —
    shipped but unused by any task; available here for user scenes)."""
    u = U("husky")
    cx, cy, cz = 0.99, 0.67, 0.39
    u.link(
        "base_link", mass=46.7, com=(-0.09, 0, 0.24),
        inertia=(2.2, 5.5, 6.1),
        geoms=[("box", (cx, cy, cz), (0, 0, 0.165 + cz / 2), (0, 0, 0))],
    )
    r = 0.165
    for side, sy in (("left", 1), ("right", -1)):
        for fr, sx in (("front", 1), ("rear", -1)):
            ln = f"{fr}_{side}_wheel_link"
            u.link(ln, mass=2.6, inertia=(0.02, 0.02, 0.04),
                   geoms=[("capsule", (r, 0.05), (0, 0, 0), (1.5707963, 0, 0))])
            u.joint(f"{fr}_{side}_wheel_joint", "continuous", "base_link", ln,
                    xyz=(sx * 0.512 / 2, sy * 0.555 / 2, r), axis=(0, 1, 0),
                    effort=10000.0, velocity=1000.0)
    u.link("ee_link", mass=0.01)
    u.joint("ee_joint", "fixed", "base_link", "ee_link", xyz=(0.5, 0, 0.3))
    return u.xml()


# ---------------------------------------------------------------------------
# Franka panda arm (public franka_description kinematics, primitive collisions)
# ---------------------------------------------------------------------------

_PI = float(np.pi)
_PANDA_JOINTS = [
    # (xyz, rpy, lower, upper, effort, velocity)
    ((0, 0, 0.333), (0, 0, 0), -2.8973, 2.8973, 87, 2.1750),
    ((0, 0, 0), (-_PI / 2, 0, 0), -1.7628, 1.7628, 87, 2.1750),
    ((0, -0.316, 0), (_PI / 2, 0, 0), -2.8973, 2.8973, 87, 2.1750),
    ((0.0825, 0, 0), (_PI / 2, 0, 0), -3.0718, -0.0698, 87, 2.1750),
    ((-0.0825, 0.384, 0), (-_PI / 2, 0, 0), -2.8973, 2.8973, 12, 2.6100),
    ((0, 0, 0), (_PI / 2, 0, 0), -0.0175, 3.7525, 12, 2.6100),
    ((0.088, 0, 0), (_PI / 2, 0, 0), -2.8973, 2.8973, 12, 2.6100),
]
_PANDA_MASSES = [4.97, 0.6469, 3.2286, 3.5879, 1.2259, 1.6666, 0.7355]
# capsule collision per link: (radius, half-ish length, z-offset, rpy)
_PANDA_CAPS = [
    (0.06, 0.14, (0, 0, -0.1), (0, 0, 0)),
    (0.06, 0.12, (0, -0.07, 0), (_PI / 2, 0, 0)),
    (0.055, 0.10, (0, 0, -0.07), (0, 0, 0)),
    (0.055, 0.10, (-0.06, 0.02, 0), (0, _PI / 2, 0)),
    (0.05, 0.16, (0, 0.05, -0.11), (0, 0, 0)),
    (0.05, 0.08, (0.02, 0, 0), (0, _PI / 2, 0)),
    (0.045, 0.06, (0, 0, 0.035), (0, 0, 0)),
]


def _panda_arm(u: U, prefix="panda", root_parent=None, root_xyz=(0, 0, 0), joint_damping=1.0):
    u.link(f"{prefix}_link0", mass=2.9,
           geoms=[("capsule", (0.07, 0.08), (-0.04, 0, 0.08), (0, _PI / 2, 0))])
    if root_parent is not None:
        u.joint(f"{prefix}_mount", "fixed", root_parent, f"{prefix}_link0", xyz=root_xyz)
    for i, (xyz, rpy, lo, hi, eff, vel) in enumerate(_PANDA_JOINTS, start=1):
        r, hl, off, crpy = _PANDA_CAPS[i - 1]
        u.link(
            f"{prefix}_link{i}",
            mass=_PANDA_MASSES[i - 1],
            com=(off[0] * 0.5, off[1] * 0.5, off[2] * 0.5),
            inertia=tuple(0.3 * _PANDA_MASSES[i - 1] * (r * r + hl * hl / 3) for _ in range(3)),
            geoms=[("capsule", (r, hl), off, crpy)],
        )
        u.joint(
            f"{prefix}_joint{i}", "revolute",
            f"{prefix}_link{i-1}", f"{prefix}_link{i}",
            xyz=xyz, rpy=rpy, axis=(0, 0, 1),
            lower=lo, upper=hi, effort=eff, velocity=vel, damping=joint_damping,
        )
    u.link(f"{prefix}_link8", mass=0.01)
    u.joint(f"{prefix}_joint8", "fixed", f"{prefix}_link7", f"{prefix}_link8",
            xyz=(0, 0, 0.107))


def panda(variant: str = "bare", prefix: str = "panda") -> str:
    """variant ∈ bare | stick | gripper (reference's franka_panda{,_stick,_gripper})."""
    u = U(f"panda_{variant}" if variant != "bare" else "panda")
    _panda_arm(u, prefix=prefix)
    if variant == "bare":
        u.link(f"{prefix}_ee", mass=0.01)
        u.joint(f"{prefix}_ee_joint", "fixed", f"{prefix}_link8", f"{prefix}_ee",
                rpy=(0, 0, -_PI / 4))
    elif variant == "stick":
        # rigid stick for non-prehensile pushing. Geometry matches the
        # reference's franka_panda_stick.urdf panda_ee_finger: r=0.01 cylinder,
        # length 0.29 centered at z=0.16 past the flange (collision spans
        # z∈[0.015,0.305]), tip frame at z=0.29. The earlier 0.12-long capsule
        # with the tip at 0.25 was 4 cm short AND left a collision gap
        # z∈[0.195,0.23] the block could slip through.
        u.link(f"{prefix}_stick", mass=0.1,
               geoms=[("capsule", (0.01, 0.29), (0, 0, 0.16), (0, 0, 0))])
        u.joint(f"{prefix}_stick_joint", "fixed", f"{prefix}_link8", f"{prefix}_stick",
                rpy=(0, 0, -_PI / 4))
        u.link(f"{prefix}_ee_tip", mass=0.01,
               geoms=[("sphere", (0.01,), (0, 0, 0), (0, 0, 0))])
        u.joint(f"{prefix}_ee_tip_joint", "fixed", f"{prefix}_stick", f"{prefix}_ee_tip",
                xyz=(0, 0, 0.29))
    elif variant == "gripper":
        u.link(f"{prefix}_hand", mass=0.73,
               geoms=[("box", (0.06, 0.2, 0.08), (0, 0, 0.03), (0, 0, 0))])
        u.joint(f"{prefix}_hand_joint", "fixed", f"{prefix}_link8", f"{prefix}_hand",
                rpy=(0, 0, -_PI / 4))
        for fi, sy in (("1", 1), ("2", -1)):
            # finger pad INNER face flush with the grasp plane (real Franka
            # finger collision extends outward from the joint plane): a
            # CENTERED 14 mm box leaves only 2q−14 mm between the pads — at
            # the pick tasks' straddle/comfy grips that is LESS than the 4 cm
            # block, so caging was geometrically impossible (r4 omni root
            # cause; see conf/actors/omnipanda_effort.yaml comfy 0.025)
            u.link(f"{prefix}_finger{fi}", mass=0.015,
                   geoms=[("box", (0.034, 0.014, 0.05), (0, sy * 0.007, 0.028), (0, 0, 0))])
            u.joint(f"{prefix}_finger_joint{fi}", "prismatic",
                    f"{prefix}_hand", f"{prefix}_finger{fi}",
                    xyz=(0, sy * 0.0, 0.0584), axis=(0, sy, 0),
                    lower=0.0, upper=0.04, effort=20, velocity=0.2)
        u.link(f"{prefix}_ee", mass=0.001)
        u.joint(f"{prefix}_ee_joint", "fixed", f"{prefix}_hand", f"{prefix}_ee",
                xyz=(0, 0, 0.1034))
    else:
        raise ValueError(variant)
    return u.xml()


def omni_panda() -> str:
    """Holonomic base (x, y, yaw) + panda arm + gripper: 12 actuated DOFs
    (reference omniPandaWithGripper, `conf/actors/omnipanda.yaml`)."""
    u = U("omni_panda")
    _planar_base(
        u, effort=300.0,
        # reference omniPandaWithGripper.urdf base_link collision: cylinder
        # r=0.2 l=0.3 centered at the base frame (joint chain puts it at world
        # z=0.15 → spans z∈[0, 0.3]). The r1-r3 chassis was a 0.5×0.5 box
        # whose 0.354 m corner reach jammed into the table 75% farther out
        # than the reference's 0.2 m cylinder — near-table approach cost a
        # violent repulsive kick (scripts/probe_omni_contact.py: 978 N spike)
        # and MPPI learned to hover instead of reaching the block.
        chassis_geoms=[("cylinder", (0.2, 0.3), (0, 0, 0.10), (0, 0, 0))],
        extent=50.0,
        # reference omniPandaWithGripper.urdf base_link: 20 kg, izz=0.4 —
        # effort-mode base response (±80 N / sigma 20) depends on this inertia
        mass=20.0, inertia=(0.2933, 0.2933, 0.4),
    )
    _panda_arm(u, prefix="panda", root_parent="base_link", root_xyz=(0, 0, 0.3))
    # gripper
    u.link("panda_hand", mass=0.73,
           geoms=[("box", (0.06, 0.2, 0.08), (0, 0, 0.03), (0, 0, 0))])
    u.joint("panda_hand_joint", "fixed", "panda_link8", "panda_hand", rpy=(0, 0, -_PI / 4))
    for fi, sy in (("1", 1), ("2", -1)):
        # pad inner face flush with the grasp plane — see _panda_arm gripper
        u.link(f"panda_finger{fi}", mass=0.015,
               geoms=[("box", (0.034, 0.014, 0.05), (0, sy * 0.007, 0.028), (0, 0, 0))])
        u.joint(f"panda_finger_joint{fi}", "prismatic", "panda_hand", f"panda_finger{fi}",
                xyz=(0, 0, 0.0584), axis=(0, sy, 0),
                lower=0.0, upper=0.04, effort=20, velocity=0.2)
    u.link("panda_ee_tip", mass=0.001)
    u.joint("panda_ee_tip_joint", "fixed", "panda_hand", "panda_ee_tip", xyz=(0, 0, 0.1034))
    return u.xml()


def albert() -> str:
    """Mobile manipulator: boxer diff-drive base + panda arm + gripper
    (reference albert.urdf; arm links named mmrobot_linkN per
    `conf/actors/albert.yaml` visualize_link)."""
    u = U("albert")
    _panda_arm(u, prefix="mmrobot", root_parent=None)
    # reference albert = diff-drive base + 7-DOF arm, NO fingers (9 controls:
    # v, ω + 7 arm — conf/mppi/albert.yaml is 9-dim). Joint doc order: arm
    # first (dof ids 0-6, matching init_joint_pose), wheels last.
    _diff_drive_base(u)
    # arm sits on the chassis
    u.joint("arm_mount", "fixed", "chassis_link", "mmrobot_link0", xyz=(0.0, 0, 0.3))
    return u.xml()


def anymal() -> str:
    """ANYmal-C-like quadruped: floating trunk + 4 × (HAA, HFE, KFE)
    (reference anymal_c assets; emergent-gait task `examples/anymal/planner.py`)."""
    u = U("anymal")
    u.link("base", mass=25.0, com=(0, 0, 0), inertia=(0.9, 1.9, 2.1),
           geoms=[("box", (0.75, 0.34, 0.2), (0, 0, 0), (0, 0, 0))])
    hip_x, hip_y = 0.36, 0.17
    # X-stance REST POSE baked into the joint frames (like the anymal_c URDF
    # zero pose): at q=0 the legs stand bent with base at the objective's
    # 0.65 target and knees at 0.28 — BELOW the objective's 0.35 knee target
    # (`examples/anymal/planner.py:31,42`). That gap is the gait engine: the
    # knee term exerts constant "lift your knees" pressure that standing can
    # never satisfy, while the body term punishes crouching — the tradeoff
    # pumps the legs and stepping emerges, exactly the reference's shaping
    # ("high knee costs"). A straight-legged zero is kinematically singular
    # and MPPI freezes in it because every bend first drops the body.
    bend = 0.4
    thigh_l = 0.37 / float(np.cos(bend))            # rest knee at 0.65-0.37=0.28
    shank_l = (0.28 - 0.035) / float(np.cos(bend))  # foot ball on the ground
    for leg, sx, sy in (("LF", 1, 1), ("RF", 1, -1), ("LH", -1, 1), ("RH", -1, -1)):
        u.link(f"{leg}_HIP", mass=2.0, inertia=(0.01, 0.01, 0.01))
        u.joint(f"{leg}_HAA", "revolute", "base", f"{leg}_HIP",
                xyz=(sx * hip_x, sy * hip_y, 0), axis=(1, 0, 0),
                lower=-0.7, upper=0.7, effort=80, velocity=10, damping=1.0)
        u.link(f"{leg}_THIGH", mass=2.2, com=(0, 0, -thigh_l / 2),
               inertia=(0.02, 0.02, 0.005),
               geoms=[("capsule", (0.05, thigh_l / 2 - 0.05), (0, 0, -thigh_l / 2), (0, 0, 0))])
        u.joint(f"{leg}_HFE", "revolute", f"{leg}_HIP", f"{leg}_THIGH",
                xyz=(0, sy * 0.09, 0), axis=(0, 1, 0), rpy=(0, sx * bend, 0),
                lower=-3.0, upper=3.0, effort=80, velocity=10, damping=1.0)
        # shank link named {leg}_KFE so its origin IS the knee position
        # (the reference objective reads knee links by that name,
        # `examples/anymal/planner.py:36-41`)
        u.link(f"{leg}_KFE", mass=0.9, com=(0, 0, -shank_l / 2),
               inertia=(0.01, 0.01, 0.002),
               geoms=[("capsule", (0.03, shank_l / 2 - 0.04), (0, 0, -shank_l / 2), (0, 0, 0))])
        u.joint(f"{leg}_KFE_joint", "revolute", f"{leg}_THIGH", f"{leg}_KFE",
                xyz=(0, 0, -thigh_l), axis=(0, 1, 0), rpy=(0, -2 * sx * bend, 0),
                lower=-3.0, upper=3.0, effort=80, velocity=10, damping=1.0)
        u.link(f"{leg}_FOOT", mass=0.1,
               geoms=[("sphere", (0.035,), (0, 0, 0), (0, 0, 0))])
        u.joint(f"{leg}_foot_joint", "fixed", f"{leg}_KFE", f"{leg}_FOOT",
                xyz=(0, 0, -shank_l))
    for face, fx in (("face_front", 0.4), ("face_rear", -0.4)):
        u.link(face, mass=0.01)
        u.joint(f"{face}_joint", "fixed", "base", face, xyz=(fx, 0, 0))
    return u.xml()


def mini_gripper() -> str:
    """Minimal 2-DOF parallel gripper (fixed hand + two prismatic box
    fingers) — a test vector for articulated↔free grasp coupling that keeps
    interpret-mode candidate counts small (pair a SPHERE object with it)."""
    u = U("mini_gripper")
    u.link("hand", mass=0.5,
           geoms=[("box", (0.04, 0.1, 0.03), (0, 0, 0.1), (0, 0, 0))])
    for fi, sy in (("1", 1), ("2", -1)):
        u.link(f"finger{fi}", mass=0.015,
               geoms=[("box", (0.03, 0.012, 0.04), (0, 0, -0.04), (0, 0, 0))])
        u.joint(f"finger_joint{fi}", "prismatic", "hand", f"finger{fi}",
                xyz=(0, sy * 0.0, 0.07), axis=(0, sy, 0),
                lower=0.0, upper=0.05, effort=20, velocity=0.2)
    return u.xml()


def mini_gripper_rail() -> str:
    """mini_gripper on a prismatic x-rail (3 DOF): the smallest scene that can
    GRASP AND TRANSPORT a free object — the grasp-parity test vector for the
    fused kernel (interpret-mode candidate counts stay tiny)."""
    u = U("mini_gripper_rail")
    u.link("world")
    u.link("carriage", mass=2.0, inertia=(0.01, 0.01, 0.01))
    u.joint("rail_x", "prismatic", "world", "carriage", xyz=(0, 0, 0),
            axis=(1, 0, 0), lower=-2.0, upper=2.0, effort=200.0, velocity=2.0)
    u.link("hand", mass=0.5,
           geoms=[("box", (0.04, 0.1, 0.03), (0, 0, 0.1), (0, 0, 0))])
    u.joint("hand_joint", "fixed", "carriage", "hand")
    for fi, sy in (("1", 1), ("2", -1)):
        u.link(f"finger{fi}", mass=0.015,
               geoms=[("box", (0.03, 0.012, 0.04), (0, 0, -0.04), (0, 0, 0))])
        u.joint(f"finger_joint{fi}", "prismatic", "hand", f"finger{fi}",
                xyz=(0, sy * 0.0, 0.07), axis=(0, sy, 0),
                lower=0.0, upper=0.05, effort=20, velocity=0.2)
    return u.xml()


ROBOTS = {
    "point_robot": point_robot,
    "mini_gripper": mini_gripper,
    "mini_gripper_rail": mini_gripper_rail,
    "heijn": heijn,
    "boxer": boxer,
    "jackal": jackal,
    "husky": husky,
    "panda": lambda: panda("bare"),
    "panda_stick": lambda: panda("stick"),
    "panda_gripper": lambda: panda("gripper"),
    "omni_panda": omni_panda,
    "albert": albert,
    "anymal": anymal,
}


def robot_urdf(name: str) -> str:
    """Resolve a urdf_file-ish name to URDF XML. Accepts registry names and
    reference-style paths (e.g. 'panda_isaac/robots/franka_panda.urdf')."""
    if name in ROBOTS:
        return ROBOTS[name]()
    # map reference-style paths onto the registry
    lowered = name.lower()
    if "franka_panda_gripper" in lowered:
        return ROBOTS["panda_gripper"]()
    if "franka_panda_stick" in lowered:
        return ROBOTS["panda_stick"]()
    if "franka_panda" in lowered or "panda_bullet" in lowered:
        return ROBOTS["panda"]()
    if "omni" in lowered and "panda" in lowered:
        return ROBOTS["omni_panda"]()
    for key in ("point_robot", "boxer", "heijn", "jackal", "albert", "anymal"):
        if key in lowered:
            return ROBOTS[key]()
    raise KeyError(f"unknown robot asset {name!r}")
