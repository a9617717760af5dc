# Frozen copy of mppiisaac_tpu_torch/physics/urdf.py, part of the benchmark's yardstick.
"""URDF → articulation spec parser (host-side, pure Python / numpy).

Replaces the reference's asset loading through Isaac Gym's C++ URDF importer
(`mppiisaac/utils/isaacgym_utils.py:14-58` of the reference). Parsing happens
once at scene-build time; everything downstream is static numpy handed to the
physics step.

Collision geometry supports the primitive set the contact engine understands:
sphere / box / cylinder (treated as a capsule for contacts) / capsule. ``mesh``
collision elements are approximated by a bounding primitive fit from the mesh
file when available, otherwise skipped (objectives in the reference workload
consume only net contact forces of primitive-dominated scenes — SURVEY §7.1).
"""
from __future__ import annotations

import io
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

GEOM_SPHERE = 0
GEOM_BOX = 1
GEOM_CAPSULE = 2

JOINT_FIXED = 0
JOINT_REVOLUTE = 1
JOINT_PRISMATIC = 2


@dataclass
class UrdfGeom:
    gtype: int
    size: np.ndarray          # sphere: [r,0,0]; box: half-extents; capsule: [r, half_len, 0]
    pos: np.ndarray
    quat: np.ndarray          # xyzw


@dataclass
class UrdfLink:
    name: str
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    geoms: List[UrdfGeom] = field(default_factory=list)


@dataclass
class UrdfJoint:
    name: str
    jtype: int
    parent: str
    child: str
    origin_pos: np.ndarray
    origin_quat: np.ndarray
    axis: np.ndarray
    lower: float = -1e9
    upper: float = 1e9
    effort: float = 1e9
    velocity: float = 1e9
    damping: float = 0.0
    friction: float = 0.0


@dataclass
class RobotSpec:
    name: str
    links: Dict[str, UrdfLink]
    joints: List[UrdfJoint]          # movable + fixed, document order
    root_link: str


def _floats(s: Optional[str], n: int, default=0.0) -> np.ndarray:
    if s is None:
        return np.full(n, default, dtype=np.float64)
    vals = [float(x) for x in s.split()]
    return np.asarray(vals, dtype=np.float64)


def _rpy_to_quat(rpy: np.ndarray) -> np.ndarray:
    """URDF rpy (extrinsic XYZ = intrinsic ZYX) → quat xyzw."""
    r, p, y = rpy
    cr, sr = np.cos(r / 2), np.sin(r / 2)
    cp, sp = np.cos(p / 2), np.sin(p / 2)
    cy, sy = np.cos(y / 2), np.sin(y / 2)
    return np.array(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ]
    )


def _parse_origin(el: Optional[ET.Element]) -> Tuple[np.ndarray, np.ndarray]:
    if el is None:
        return np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0])
    xyz = _floats(el.get("xyz"), 3)
    rpy = _floats(el.get("rpy"), 3)
    return xyz, _rpy_to_quat(rpy)


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _parse_geometry(geo: ET.Element, pos: np.ndarray, quat: np.ndarray) -> Optional[UrdfGeom]:
    sphere = geo.find("sphere")
    if sphere is not None:
        r = float(sphere.get("radius"))
        return UrdfGeom(GEOM_SPHERE, np.array([r, 0.0, 0.0]), pos, quat)
    box = geo.find("box")
    if box is not None:
        size = _floats(box.get("size"), 3)
        return UrdfGeom(GEOM_BOX, size / 2.0, pos, quat)
    cyl = geo.find("cylinder")
    if cyl is not None:
        r = float(cyl.get("radius"))
        l = float(cyl.get("length"))
        if l >= 2.0 * r:
            # elongated: capsule along local z, half-length reduced so the
            # total reach matches the cylinder
            hl = max(l / 2.0 - r, 1e-4)
            return UrdfGeom(GEOM_CAPSULE, np.array([r, hl, 0.0]), pos, quat)
        # squat (puck-like, e.g. robot bases): box approximation — a capsule
        # would inflate the vertical extent by the radius
        return UrdfGeom(GEOM_BOX, np.array([r * 0.85, r * 0.85, l / 2.0]), pos, quat)
    cap = geo.find("capsule")
    if cap is not None:
        r = float(cap.get("radius"))
        l = float(cap.get("length"))
        return UrdfGeom(GEOM_CAPSULE, np.array([r, l / 2.0, 0.0]), pos, quat)
    mesh = geo.find("mesh")
    if mesh is not None:
        return None  # resolved by caller via mesh fitting, if a file is present
    return None


def _geom_mass_inertia(g: UrdfGeom, density: float):
    """(mass, COM-frame inertia tensor, COM in link frame) of one collision
    primitive at uniform density — the Isaac Gym importer's behavior for links
    without an ``<inertial>`` element (reference franka_panda.urdf ships none;
    loader `mppiisaac/utils/isaacgym_utils.py:14-58` relies on it)."""
    if g.gtype == GEOM_SPHERE:
        r = float(g.size[0])
        m = density * (4.0 / 3.0) * np.pi * r**3
        i = 0.4 * m * r * r
        I = np.diag([i, i, i])
    elif g.gtype == GEOM_BOX:
        hx, hy, hz = [float(v) for v in g.size]
        m = density * 8.0 * hx * hy * hz
        I = np.diag([
            m / 3.0 * (hy * hy + hz * hz),
            m / 3.0 * (hx * hx + hz * hz),
            m / 3.0 * (hx * hx + hy * hy),
        ])
    else:  # capsule: cylinder (length 2·hl) + two hemispherical caps, axis z
        r, hl = float(g.size[0]), float(g.size[1])
        mc = density * np.pi * r * r * (2.0 * hl)
        mh = density * (2.0 / 3.0) * np.pi * r**3          # one hemisphere
        m = mc + 2.0 * mh
        izz = mc * r * r / 2.0 + 2.0 * mh * (2.0 / 5.0) * r * r
        # hemisphere about its own COM (83/320 m r²), COM at hl + 3r/8
        d = hl + 3.0 * r / 8.0
        ixx = (
            mc * (r * r / 4.0 + hl * hl / 3.0)
            + 2.0 * (mh * (83.0 / 320.0) * r * r + mh * d * d)
        )
        I = np.diag([ixx, ixx, izz])
    R = _quat_to_mat(g.quat)
    return m, R @ I @ R.T, np.asarray(g.pos, dtype=np.float64)


def derive_inertial_from_geoms(link: UrdfLink, density: float = 1000.0) -> None:
    """Fill link mass/COM/inertia from its collision primitives (in place)."""
    if not link.geoms:
        return
    parts = [_geom_mass_inertia(g, density) for g in link.geoms]
    m_tot = sum(p[0] for p in parts)
    if m_tot <= 0:
        return
    com = sum(p[0] * p[2] for p in parts) / m_tot
    I = np.zeros((3, 3))
    for m, Ic, c in parts:
        d = c - com
        I += Ic + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    link.mass, link.com, link.inertia = float(m_tot), com, I


def parse_urdf(source: str, mesh_fit=None, default_density: float = 1000.0) -> RobotSpec:
    """Parse a URDF file path or XML string into a RobotSpec.

    mesh_fit: optional callable (filename, scale) -> UrdfGeom-params fitting a
    bounding primitive to the mesh (provided by scene.assets, optionally backed
    by the native C++ mesh loader).
    """
    if os.path.exists(source):
        tree = ET.parse(source)
        base_dir = os.path.dirname(source)
    else:
        tree = ET.parse(io.StringIO(source))
        base_dir = "."
    robot = tree.getroot()
    name = robot.get("name", "robot")

    links: Dict[str, UrdfLink] = {}
    for lel in robot.findall("link"):
        link = UrdfLink(name=lel.get("name"))
        inertial = lel.find("inertial")
        if inertial is not None:
            mass_el = inertial.find("mass")
            link.mass = float(mass_el.get("value")) if mass_el is not None else 0.0
            opos, oquat = _parse_origin(inertial.find("origin"))
            link.com = opos
            iel = inertial.find("inertia")
            if iel is not None:
                ixx = float(iel.get("ixx", 0))
                iyy = float(iel.get("iyy", 0))
                izz = float(iel.get("izz", 0))
                ixy = float(iel.get("ixy", 0))
                ixz = float(iel.get("ixz", 0))
                iyz = float(iel.get("iyz", 0))
                I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
                # rotate inertia from the inertial frame into the link frame
                R = _quat_to_mat(oquat)
                link.inertia = R @ I @ R.T
        for cel in lel.findall("collision"):
            cpos, cquat = _parse_origin(cel.find("origin"))
            geo = cel.find("geometry")
            if geo is None:
                continue
            g = _parse_geometry(geo, cpos, cquat)
            if g is None and mesh_fit is not None:
                mesh = geo.find("mesh")
                if mesh is not None:
                    g = mesh_fit(
                        os.path.join(base_dir, mesh.get("filename", "")),
                        _floats(mesh.get("scale"), 3, default=1.0),
                        cpos,
                        cquat,
                    )
            if g is not None:
                link.geoms.append(g)
        if inertial is None and link.geoms:
            derive_inertial_from_geoms(link, default_density)
        links[link.name] = link

    joints: List[UrdfJoint] = []
    children = set()
    for jel in robot.findall("joint"):
        jt = jel.get("type")
        tmap = {
            "fixed": JOINT_FIXED,
            "revolute": JOINT_REVOLUTE,
            "continuous": JOINT_REVOLUTE,
            "prismatic": JOINT_PRISMATIC,
        }
        if jt not in tmap:
            raise ValueError(f"unsupported joint type {jt!r} in {name}")
        opos, oquat = _parse_origin(jel.find("origin"))
        axis_el = jel.find("axis")
        axis = _floats(axis_el.get("xyz"), 3) if axis_el is not None else np.array([1.0, 0, 0])
        nrm = np.linalg.norm(axis)
        axis = axis / nrm if nrm > 0 else np.array([1.0, 0, 0])
        j = UrdfJoint(
            name=jel.get("name"),
            jtype=tmap[jt],
            parent=jel.find("parent").get("link"),
            child=jel.find("child").get("link"),
            origin_pos=opos,
            origin_quat=oquat,
            axis=axis,
        )
        limit = jel.find("limit")
        if limit is not None:
            j.lower = float(limit.get("lower", -1e9))
            j.upper = float(limit.get("upper", 1e9))
            j.effort = float(limit.get("effort", 1e9))
            j.velocity = float(limit.get("velocity", 1e9))
        if jt == "continuous":
            j.lower, j.upper = -1e9, 1e9
        dyn = jel.find("dynamics")
        if dyn is not None:
            j.damping = float(dyn.get("damping", 0.0))
            j.friction = float(dyn.get("friction", 0.0))
        joints.append(j)
        children.add(j.child)

    roots = [ln for ln in links if ln not in children]
    if len(roots) != 1:
        raise ValueError(f"URDF {name}: expected exactly one root link, got {roots}")
    return RobotSpec(name=name, links=links, joints=joints, root_link=roots[0])
