# Frozen copy of mppiisaac_tpu_torch/scene/actor.py, part of the benchmark's yardstick.
"""ActorSpec — declarative per-actor scene configuration.

Field-for-field parity with the reference's `ActorWrapper` dataclass
(`isaacgym_wrapper.py:49-77`): same names, same semantics, so reference actor
YAMLs load unchanged. Extensions of the JAX package are grouped at the bottom.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, List, Optional

from ..utils.confsys import load_yaml


@dataclass
class ActorSpec:
    type: str                                   # robot | sphere | box | axis
    name: str
    dof_mode: str = "velocity"                  # velocity | position | effort
    init_pos: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    init_ori: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0, 1.0])
    size: List[float] = field(default_factory=lambda: [0.1, 0.1, 0.1])
    mass: float = 1.0
    color: List[float] = field(default_factory=lambda: [1.0, 1.0, 1.0])
    fixed: bool = False
    collision: bool = True
    friction: float = 1.0
    handle: Optional[int] = None                # parity field (unused)
    flip_visual: bool = False                   # parity field (visual-only)
    urdf_file: Optional[str] = None
    visualize_link: Optional[str] = None
    gravity: bool = True
    differential_drive: bool = False
    init_joint_pose: Optional[List[float]] = None   # interleaved (q, qd) pairs
    wheel_radius: Optional[float] = None
    wheel_base: Optional[float] = None
    wheel_count: Optional[float] = None
    left_wheel_joints: Optional[List[str]] = None
    right_wheel_joints: Optional[List[str]] = None
    caster_links: Optional[List[str]] = None
    noise_sigma_size: Optional[List[float]] = None
    noise_percentage_mass: float = 0.0
    noise_percentage_friction: float = 0.0
    # --- extensions (absent in the reference) ---
    gripper_binarize: bool = False              # panda_gripper behavior
    # opt-in intra-actor collision (the reference's create_actor masks
    # self-collision off — see physics/model.Articulation.self_collision)
    self_collision: bool = False
    # open only on a decisively positive command (u > threshold); at 0 the
    # binarize is symmetric. The reference's gripper effectively CANNOT open
    # under planner control (its `apply_robot_cmd` override chain at
    # `isaacgym_wrapper.py:561-565` leaves finger 1 always closing), which is
    # what makes its picks drop-free; a threshold keeps deliberate opening
    # possible while removing MPPI's open/close dither mid-transport.
    gripper_open_threshold: float = 0.0
    # latching band around the threshold: open needs u > th+hyst, close needs
    # u < th-hyst, anything between HOLDS the current side (from finger q) —
    # capture stays possible (decisive open), transport stays drop-free
    # (dither can't reopen a closed grip). See CommandMap.apply.
    gripper_hysteresis: float = 0.12
    armature: float = 0.0

    @staticmethod
    def from_dict(d: dict) -> "ActorSpec":
        d = dict(d)
        d.pop("handle", None)
        known = {f for f in ActorSpec.__dataclass_fields__}
        extra = {k: v for k, v in d.items() if k not in known}
        if extra:
            raise ValueError(f"unknown ActorSpec fields: {sorted(extra)}")
        return ActorSpec(**d)


def load_actor_yaml(path: str) -> ActorSpec:
    return ActorSpec.from_dict(load_yaml(path))


def load_actor_cfgs(names: List[str], conf_dir: str) -> List[ActorSpec]:
    """Load actor specs by name from a conf/actors directory (parity:
    reference `isaacgym_utils.py:70-78`)."""
    return [load_actor_yaml(os.path.join(conf_dir, f"{n}.yaml")) for n in names]
