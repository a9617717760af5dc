"""Shared objective terms."""
from __future__ import annotations

import torch

from ..physics.math3d import quat_to_euler_zyx, quat_to_yaw
from ..utils.device_cache import cached


def const(owner, name: str, make, like: torch.Tensor) -> torch.Tensor:
    """The host value `make()` as a tensor of `like`'s dtype on its device,
    made once and cached on `owner` (an objective): a cost evaluated inside
    a captured control step copies nothing from the host. The planner's
    `update_objective`/`update_weights` write it anew from `make()`."""
    return cached(owner, name, make, like.dtype, like.device)


def norm(x, dim=-1):
    return torch.linalg.norm(x, dim=dim)


def ee_upright_cost(quat):
    """‖(yaw, pitch)‖ of an EE quaternion — the reference's ZYX-euler[:, :2]
    term (`examples/panda/planner.py:30-33`)."""
    _, p, y = quat_to_euler_zyx(quat)
    return torch.sqrt(y * y + p * p + 1e-12)


def contact_force_mag(view, actor: str, dims: int = 3):
    """|F|₁ of an actor's net contact force (its 'box' link or root body)."""
    f = view.get_actor_contact_forces_by_name(actor, "box")
    return torch.sum(torch.abs(f[..., :dims]), dim=-1)


def push_align_cost(robot_to_block, block_to_goal):
    """Cosine alignment term (+1 offset) — reference
    `examples/heijn_push/planner.py:45-49`."""
    num = torch.sum(robot_to_block * block_to_goal, dim=-1)
    den = norm(robot_to_block) * norm(block_to_goal)
    return num / torch.clamp(den, min=1e-6) + 1.0


def yaw_of(quat):
    return quat_to_yaw(quat)


def run_objective_task(task_name, objective_cls, overrides=None, success_fn=None, **kw):
    """One episode of conf/tasks/<task_name> with objective_cls(cfg) (the
    JAX package's `run_objective_task`); kw goes to `run_task` (device=,
    n_steps=, device_steps=, ...)."""
    from ..runtime.loop import run_task
    from ..utils.config_store import load_config

    cfg = load_config(f"tasks/{task_name}", overrides)
    return run_task(cfg, objective_cls(cfg), success_fn=success_fn, **kw)


def split_cli(argv, defaults):
    """Hydra-style `key=value` arguments → (the config overrides, the values
    of the keys in `defaults`, each defaulting to its entry there)."""
    from ..utils.confsys import parse_cli

    opts = dict(defaults)
    rest = []
    for a in parse_cli(argv):
        key, eq, val = a.partition("=")
        if eq and key in defaults:
            opts[key] = val
        else:
            rest.append(a)
    return rest, opts


def fused_opt(val):
    """The planner's `use_fused` from a command-line value: true, false or
    none (the planner's choice)."""
    if val is None or isinstance(val, bool):
        return val
    return {"true": True, "false": False, "none": None}[str(val).lower()]
