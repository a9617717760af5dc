"""Shared objective terms."""
from __future__ import annotations

import torch

from ..physics.math3d import quat_to_euler_zyx


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
