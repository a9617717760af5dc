"""Live viewer with keyboard goal teleop (the twin of the JAX package's
`viz/live.py`).

The reference's Vulkan viewer loop (online rollout-line drawing,
`isaacgym_wrapper.py:760-774`; WASD/QE goal moving, 116-122 and 621-637),
drawn on the host from state and trajectory buffers copied from the device.
A matplotlib window (TkAgg or Qt where a display exists) redraws the
top-down scene each control step; a key moves the "goal" actor through
`set_actor_position_by_name`, which the next command reads, as the
reference's `interactive_goal_update` does.

Without a display (matplotlib's Agg), `update()` still draws, and can save
each frame for `save_episode_gif`, so one loop runs everywhere.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .render import InteractiveGoal, actor_color, host, plt_circle


class LiveViewer:
    KEYMAP = InteractiveGoal.KEYMAP

    def __init__(self, sim, goal_actor: str = "goal", frame_dir: Optional[str] = None,
                 lim: float = 3.0):
        import matplotlib

        self.sim = sim
        self.goal_actor = goal_actor
        self.frame_dir = frame_dir
        self.frames = []
        self.lim = lim
        self.interactive = matplotlib.get_backend().lower() != "agg"
        import matplotlib.pyplot as plt

        self.plt = plt
        self.fig, self.ax = plt.subplots(figsize=(6, 6))
        if self.interactive:
            self.fig.canvas.mpl_connect("key_press_event", self._on_key)
            plt.ion()
            self.fig.show()

    # -- teleop ------------------------------------------------------------
    def _on_key(self, event):
        d = self.KEYMAP.get((event.key or "").lower())
        if d is None or not any(s.name == self.goal_actor for s in self.sim.built.specs):
            return
        pos = host(self.sim.get_actor_position_by_name(self.goal_actor)[0])
        self.sim.set_actor_position_by_name(self.goal_actor, pos + np.asarray(d))

    # -- drawing -----------------------------------------------------------
    def update(self, step: int, rollouts=None):
        """Draw env 0 and the rollout lines (H, K, 3) of step `step`."""
        from ..physics.urdf import GEOM_BOX

        ax, plt = self.ax, self.plt
        ax.clear()
        scene = self.sim.scene
        body_pos = host(self.sim.state.body_pos[0])
        for ai, art in enumerate(scene.actors):
            col = actor_color(self.sim.built.specs[ai], (0.4, 0.4, 0.8))
            for g in art.geoms:
                p = body_pos[scene.body_offset[ai] + g.body] + np.asarray(g.pos)
                if g.gtype == GEOM_BOX:
                    hx, hy, _ = g.size
                    ax.add_patch(plt.Rectangle((p[0] - hx, p[1] - hy), 2 * hx, 2 * hy,
                                               color=col, alpha=0.6))
                else:
                    ax.add_patch(plt_circle(plt, p[:2], max(float(g.size[0]), 0.02), col))
        if rollouts is not None:
            ro = host(rollouts)
            if ro.ndim == 3 and ro.size:
                stride = max(1, ro.shape[1] // 48)
                for k in range(0, ro.shape[1], stride):
                    ax.plot(ro[:, k, 0], ro[:, k, 1], color="green", alpha=0.2, lw=0.8)
        ax.set_xlim(-self.lim, self.lim)
        ax.set_ylim(-self.lim, self.lim)
        ax.set_aspect("equal")
        ax.set_title(f"step {step}  (wasd/qe move goal)" if self.interactive else f"step {step}")
        if self.interactive:
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()
        elif self.frame_dir is not None:
            import os

            os.makedirs(self.frame_dir, exist_ok=True)
            path = f"{self.frame_dir}/frame_{step:05d}.png"
            self.fig.savefig(path, dpi=80)
            self.frames.append(path)

    def close(self):
        self.plt.close(self.fig)
