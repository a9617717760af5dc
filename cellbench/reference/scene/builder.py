# Frozen copy of mppiisaac_tpu_torch/scene/builder.py, part of the benchmark's yardstick.
"""Scene builder: List[ActorSpec] → SceneModel + initial SimState + command map.

Capability parity with the reference's `start_sim`/`_create_actor` pipeline
(`isaacgym_wrapper.py:124-236, 429-508`): asset loading, actor creation,
collision config, DOF drive setup, initial poses, plus the command assembly of
`apply_robot_cmd` (524-572) — precomputed into one static linear map + a
binarize mask, so applying a command is a single (D,nu) matvec.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..physics.model import (
    Articulation,
    build_articulation,
    primitive_articulation,
)
from ..physics.scene_model import SceneModel
from ..physics.types import SimState
from ..physics.urdf import GEOM_BOX, GEOM_SPHERE, parse_urdf
from ..utils.device_cache import DeviceCache
from .actor import ActorSpec
from .assets import mesh_fit
from .robots import robot_urdf


@dataclass
class SimConfig:
    """Parity with reference `IsaacGymConfig` (`isaacgym_wrapper.py:10-18`)."""
    dt: float = 0.05
    substeps: int = 2
    use_gpu_pipeline: bool = True     # parity field (always on-device here)
    num_client_threads: int = 0       # parity field
    viewer: bool = False
    num_obstacles: int = 10
    spacing: float = 6.0              # parity field (envs are implicit under vmap)
    # parity field of the JAX package's world-path switch; the port always
    # steps a world through the fused world-step kernel
    fused_world: Optional[bool] = None
    # impulse sweeps in the fused world step. 16 = the XLA engine's
    # impulse_contact_pass iteration count: since the r4 pair-block
    # restructure both paths run the same mass-splitting Jacobi, so matching
    # counts makes them converge identically (paid once per control dt)
    fused_world_sweeps: int = 16


@dataclass
class CommandMap:
    """dof_target = W @ u, then binarized gripper overrides."""
    nu: int
    W: np.ndarray                                 # (ndof, nu)
    # (dof, u_src, close_target, open_target, open_threshold, hysteresis):
    # finger dofs are POSITION-driven (model.py build_articulation) and
    # binarize to fully-closed / fully-open position targets from the source
    # command (reference `apply_robot_cmd`, `isaacgym_wrapper.py:561-565`).
    # hysteresis > 0 makes the flip LATCHING: open only on u > th+hyst, close
    # only on u < th-hyst, otherwise hold the current side (decided from the
    # finger's position q). The reference's own binarize chain leaves the
    # fingers permanently closing — drop-free transport but no deliberate
    # opening; hysteresis keeps both while killing MPPI's open/close dither.
    binarize_dofs: List[Tuple[int, int, float, float, float, float]] = field(default_factory=list)

    def __post_init__(self):
        self._dev = DeviceCache()   # W on each device, copied at its first use

    def apply(self, u: torch.Tensor, q: Optional[torch.Tensor] = None) -> torch.Tensor:
        """u (..., nu) → dof targets (..., ndof). q (..., ndof) enables the
        hysteresis hold branch (without it the flip is a plain threshold)."""
        tgt = u @ self._dev.get("W", lambda: self.W, u.dtype, u.device).T
        for dof, src, lo, hi, th, band in self.binarize_dofs:
            uc = u[..., src]
            if band > 0.0 and q is not None:
                cur_open = q[..., dof] > lo + 0.75 * (hi - lo)
                val = torch.where(
                    uc > th + band, hi,
                    torch.where(uc < th - band, lo, torch.where(cur_open, hi, lo)),
                )
            else:
                val = torch.where(uc > th, hi, lo)
            tgt = tgt.clone()
            tgt[..., dof] = val
        return tgt


@dataclass
class BuiltScene:
    scene: SceneModel
    init_state_template: Dict[str, np.ndarray]
    cmd_map: CommandMap
    specs: List[ActorSpec]
    robot_names: List[str]
    visualize_bodies: List[int]       # global body indices of visualize_links

    def initial_state(self, engine, device="cpu") -> SimState:
        st = engine.initial_state(device)
        t = self.init_state_template

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        st = st.replace(
            root_pos=f32(t["root_pos"]), root_quat=f32(t["root_quat"]),
            q=f32(t["q"]), qd=f32(t["qd"]),
        )
        return engine.refresh(st)


def resolve_urdf_path(name: str) -> Optional[str]:
    """Resolve a urdf_file value to an on-disk file: absolute/relative paths
    and names under the repo `assets/urdf/` library (reference analog:
    `mppiisaac/utils/isaacgym_utils.py:14-58` loads from `assets/urdf`).
    Returns None for registry names served procedurally."""
    if not name.endswith(".urdf"):
        return None
    cands = [name]
    # the repository root: cellbench/reference/scene/ is one level deeper than the port's scene/
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    cands.append(os.path.join(here, "assets", "urdf", name))
    for c in cands:
        if os.path.exists(c):
            return c
    return None


def _actor_to_articulation(spec: ActorSpec, rng: Optional[np.random.RandomState]) -> Articulation:
    if spec.type == "robot":
        name = spec.urdf_file or spec.name
        path = resolve_urdf_path(name)
        if path is not None:
            # on-disk URDF: mesh collision elements fit to primitives
            rspec = parse_urdf(path, mesh_fit=mesh_fit)
        else:
            rspec = parse_urdf(robot_urdf(name))
        art = build_articulation(
            rspec,
            fixed_base=spec.fixed,
            dof_mode=spec.dof_mode,
            friction=spec.friction,
            disable_gravity=not spec.gravity,
            armature=spec.armature,
        )
        art.name = spec.name
        art.self_collision = spec.self_collision
        if spec.caster_links:
            for g in art.geoms:
                if art.link_names[g.body] in spec.caster_links:
                    g.friction = 0.0       # reference zeroes caster friction
                    g.torsion_friction = 0.0
        return art
    size = np.asarray(spec.size, dtype=np.float64)
    if spec.noise_sigma_size is not None and rng is not None:
        size = size + rng.randn(*size.shape) * np.asarray(spec.noise_sigma_size)[: size.size]
        size = np.maximum(size, 1e-3)
    if spec.type == "sphere":
        art = primitive_articulation(
            spec.name, GEOM_SPHERE, size[:1], mass=spec.mass, fixed=spec.fixed,
            friction=spec.friction, disable_gravity=not spec.gravity,
        )
    elif spec.type in ("box", "axis"):
        art = primitive_articulation(
            spec.name, GEOM_BOX, size[:3], mass=spec.mass, fixed=spec.fixed,
            friction=spec.friction, disable_gravity=not spec.gravity,
        )
    else:
        raise ValueError(f"unsupported actor type {spec.type!r}")
    return art


def _build_cmd_map(specs: List[ActorSpec], actors: List[Articulation], dof_offsets) -> CommandMap:
    ndof = sum(a.ndof for a in actors)
    cols: List[np.ndarray] = []
    binarize: List[Tuple[int, int]] = []
    u_idx = 0
    for spec, art, off in zip(specs, actors, dof_offsets):
        if spec.type != "robot" or art.ndof == 0:
            continue
        wheel_joints = set((spec.left_wheel_joints or []) + (spec.right_wheel_joints or []))
        if spec.differential_drive:
            r = spec.wheel_radius
            L = spec.wheel_base
            # (v, ω) columns — the reference's diff-drive IK (`_ik`,
            # `isaacgym_wrapper.py:510-522`): u_l = v/r − Lω/2r, u_r = v/r + Lω/2r
            col_v = np.zeros(ndof)
            col_w = np.zeros(ndof)
            for j, jn in enumerate(art.dof_names):
                if jn in (spec.left_wheel_joints or []):
                    col_v[off + j] = 1.0 / r
                    col_w[off + j] = -L / (2 * r)
                elif jn in (spec.right_wheel_joints or []):
                    col_v[off + j] = 1.0 / r
                    col_w[off + j] = L / (2 * r)
            cols.append(col_v)
            cols.append(col_w)
            u_idx += 2
        for j, jn in enumerate(art.dof_names):
            if jn in wheel_joints:
                continue
            col = np.zeros(ndof)
            col[off + j] = 1.0
            cols.append(col)
            this_u = u_idx
            u_idx += 1
            if spec.gripper_binarize or spec.name == "panda_gripper":
                pass  # handled below by dof name
        # gripper binarization: both finger dofs follow the sign of the LAST
        # u entry of this actor (reference `apply_robot_cmd`,
        # `isaacgym_wrapper.py:561-565`)
        if spec.gripper_binarize:
            finger_js = [j for j, jn in enumerate(art.dof_names) if "finger" in jn]
            if finger_js:
                src = u_idx - 1
                for j in finger_js:
                    binarize.append((
                        off + j, src,
                        float(art.dof_lower[j]), float(art.dof_upper[j]),
                        float(spec.gripper_open_threshold),
                        float(spec.gripper_hysteresis),
                    ))
    W = np.stack(cols, axis=1) if cols else np.zeros((ndof, 0))
    return CommandMap(nu=u_idx, W=W, binarize_dofs=binarize)


def build_scene(
    specs: List[ActorSpec],
    sim_cfg: Optional[SimConfig] = None,
    init_positions: Optional[List[List[float]]] = None,
    seed: Optional[int] = None,
) -> BuiltScene:
    sim_cfg = sim_cfg or SimConfig()
    rng = np.random.RandomState(seed) if seed is not None else None

    specs = list(specs)
    robots = [s for s in specs if s.type == "robot"]
    if init_positions is not None:
        assert len(robots) == len(init_positions)
        for pos, s in zip(init_positions, robots):
            s.init_pos = list(pos)

    actors = [_actor_to_articulation(s, rng) for s in specs]
    scene = SceneModel(
        actors=actors,
        actor_names=[s.name for s in specs],
        dt=sim_cfg.dt,
        substeps=sim_cfg.substeps,
        collision_enabled=[bool(s.collision) for s in specs],
    )

    # initial state template
    A = len(actors)
    root_pos = np.zeros((A, 3))
    root_quat = np.tile([0.0, 0, 0, 1.0], (A, 1))
    q = np.zeros(scene.ndof)
    qd = np.zeros(scene.ndof)
    for ai, (s, art) in enumerate(zip(specs, actors)):
        root_pos[ai] = np.asarray(s.init_pos, dtype=np.float64)
        root_quat[ai] = np.asarray(s.init_ori, dtype=np.float64)
        if s.init_joint_pose and art.ndof:
            ijp = np.asarray(s.init_joint_pose, dtype=np.float64)
            pairs = ijp.reshape(-1, 2)[: art.ndof]
            off = scene.dof_offset[ai]
            q[off : off + len(pairs)] = pairs[:, 0]
            qd[off : off + len(pairs)] = pairs[:, 1]

    cmd_map = _build_cmd_map(specs, actors, scene.dof_offset)

    vis_bodies = []
    for ai, s in enumerate(specs):
        if s.visualize_link:
            try:
                vis_bodies.append(scene.body_index(s.visualize_link))
            except KeyError:
                pass

    return BuiltScene(
        scene=scene,
        init_state_template={"root_pos": root_pos, "root_quat": root_quat, "q": q, "qd": qd},
        cmd_map=cmd_map,
        specs=specs,
        robot_names=[s.name for s in robots],
        visualize_bodies=vis_bodies,
    )
