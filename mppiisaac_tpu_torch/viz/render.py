"""Host-side visualization of the port's Simulation (the twin of the JAX
package's `viz/render.py`): headless matplotlib drawings of state and
trajectory buffers copied from the device, in place of the reference's
PhysX/Vulkan viewer (rollout line drawing, `isaacgym_wrapper.py:760-774`;
interactive goal teleop, 621-637).

* `render_scene(...)`: top-down and 3D views of one env's actors (primitive
  footprints), with the K visualize-link trajectories of the last MPPI
  command as green lines (`rollouts`, parity with `draw_lines`);
* `save_episode_gif(...)`: frames of an episode into a GIF;
* `InteractiveGoal`: keyboard goal teleop from stdin.

matplotlib and pillow are imported when a function needs them.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..physics.urdf import GEOM_BOX, GEOM_SPHERE


def host(x) -> np.ndarray:
    """A tensor on any device, or an array → numpy on the host."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _require_mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def actor_color(spec, default=(0.5, 0.5, 0.5)):
    return tuple(np.clip(spec.color, 0, 1)) if spec.color else default


def render_scene(
    sim,
    rollouts=None,                              # (H, K, 3), tensor or array
    path: str = "scene.png",
    env: int = 0,
    elev: float = 35.0,
    azim: float = -60.0,
):
    """Render env `env` of a Simulation (actors as primitives) and the
    rollout lines into `path`. → path."""
    plt = _require_mpl()
    scene = sim.scene
    fig = plt.figure(figsize=(12, 6))
    ax3 = fig.add_subplot(1, 2, 1, projection="3d")
    ax2 = fig.add_subplot(1, 2, 2)

    body_pos = host(sim.state.body_pos[env])
    for ai, art in enumerate(scene.actors):
        col = actor_color(sim.built.specs[ai])
        for g in art.geoms:
            p = body_pos[scene.body_offset[ai] + g.body] + np.asarray(g.pos)
            if g.gtype == GEOM_SPHERE:
                r = g.size[0]
                ax2.add_patch(plt_circle(plt, p[:2], r, col))
                ax3.scatter(*p, s=(r * 200) ** 2 * 0.5, c=[col], alpha=0.6)
            elif g.gtype == GEOM_BOX:
                hx, hy, hz = g.size
                ax2.add_patch(plt.Rectangle((p[0] - hx, p[1] - hy), 2 * hx, 2 * hy,
                                            color=col, alpha=0.5))
                ax3.scatter(*p, s=60, c=[col], marker="s", alpha=0.6)
            else:
                r = g.size[0]
                ax2.add_patch(plt_circle(plt, p[:2], r, col))
                ax3.scatter(*p, s=40, c=[col], alpha=0.6)

    if rollouts is not None:
        ro = host(rollouts)                     # (H, K, 3)
        if ro.size > 3:
            step = max(1, ro.shape[1] // 64)    # subsample lines
            for k in range(0, ro.shape[1], step):
                ax2.plot(ro[:, k, 0], ro[:, k, 1], color="green", alpha=0.15, lw=0.7)
                ax3.plot(ro[:, k, 0], ro[:, k, 1], ro[:, k, 2], color="green", alpha=0.12,
                         lw=0.6)

    ax2.set_aspect("equal")
    ax2.set_xlim(-3, 3)
    ax2.set_ylim(-3, 3)
    ax2.grid(alpha=0.2)
    ax3.view_init(elev=elev, azim=azim)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plt_circle(plt, center, r, color):
    return plt.Circle(center, r, color=color, alpha=0.5)


def save_episode_gif(frames: List[str], path: str = "episode.gif", fps: int = 10) -> Optional[str]:
    """Assemble saved PNG frames into a GIF; None where pillow is missing."""
    try:
        from PIL import Image
    except ImportError:
        return None
    imgs = [Image.open(f) for f in frames]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=1000 // fps, loop=0)
    return path


class InteractiveGoal:
    """Keyboard goal teleop: the reference's WASD/QE viewer keys
    (`isaacgym_wrapper.py:116-122, 621-637`) read from a non-blocking stdin."""

    KEYMAP = {
        "a": (+0.1, 0.0, 0.0), "d": (-0.1, 0.0, 0.0),
        "w": (0.0, -0.1, 0.0), "s": (0.0, +0.1, 0.0),
        "q": (0.0, 0.0, +0.1), "e": (0.0, 0.0, -0.1),
    }

    def __init__(self, sim, goal_actor: str = "goal"):
        self.sim = sim
        self.goal_actor = goal_actor

    def poll(self) -> bool:
        """Apply the keys waiting on stdin; → whether the goal moved."""
        import select
        import sys

        moved = False
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1).lower()
            if ch in self.KEYMAP:
                pos = host(self.sim.get_actor_position_by_name(self.goal_actor)[0])
                self.sim.set_actor_position_by_name(self.goal_actor,
                                                    pos + np.asarray(self.KEYMAP[ch]))
                moved = True
        return moved
