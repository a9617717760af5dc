# Frozen copy of mppiisaac_tpu_torch/utils/config_store.py, part of the benchmark's yardstick.
"""ExampleConfig schema + loaders (parity: the reference package's
`utils/config_store.py`), composed by the port's own reader (utils.confsys)."""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, List, Optional

from ..mppi.config import MPPIConfig
from ..scene.builder import SimConfig
from . import confsys

CONF_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))), "conf")


@dataclass
class ExampleConfig:
    render: bool = True
    n_steps: int = 100
    mppi: MPPIConfig = field(default_factory=MPPIConfig)
    isaacgym: SimConfig = field(default_factory=SimConfig)   # name kept for parity
    goal: Any = None
    nx: int = 0
    actors: List[str] = field(default_factory=list)
    initial_actor_positions: Optional[List[List[float]]] = None

    @property
    def sim(self) -> SimConfig:
        return self.isaacgym


def _to_dataclass(cls, d: dict):
    fields = cls.__dataclass_fields__
    return cls(**{k: v for k, v in (d or {}).items() if k in fields})


def config_from_dict(d: dict) -> ExampleConfig:
    return ExampleConfig(
        render=d.get("render", True),
        n_steps=d.get("n_steps", 100),
        mppi=_to_dataclass(MPPIConfig, d.get("mppi", {})),
        isaacgym=_to_dataclass(SimConfig, d.get("isaacgym", d.get("sim", {}))),
        goal=d.get("goal"),
        nx=d.get("nx", 0),
        actors=list(d.get("actors", [])),
        initial_actor_positions=d.get("initial_actor_positions"),
    )


def load_config(task: str, overrides: Optional[List[str]] = None, root: str = CONF_ROOT) -> ExampleConfig:
    """Compose a task config from the shared conf tree."""
    return config_from_dict(confsys.compose(root, task, overrides))


def actors_conf_dir(root: str = CONF_ROOT) -> str:
    return os.path.join(root, "actors")
