"""Tape priors biasing MPPI sampling (parity: the JAX package's
`planner/priors.py` `QuadrupedGaitPrior`).

A tape prior is evaluated once per command, from the measured 1-env world
state and the global control-step clock, and gives a whole (H, nu) control
tape (`mppi/solver.py` injects it as one sample and, with `prior_blend`,
shifts the sampling mean toward it). It runs in plain torch before the
rollout kernel and never enters it.

The JAX package's closed-loop priors (`PointNavigationPrior`,
`ArmJacobianPrior`, a `compute_command(view)` per rollout step) run only
inside its XLA rollout, which the fused kernels replace; the port does not
take them (the solver raises naming that reason). No shipped conf uses one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..physics.math3d import quat_to_yaw
from ..utils.device_cache import DeviceCache
from .observables import SimView


def _nan_guard(u: torch.Tensor) -> torch.Tensor:
    """Zero the command if anything went non-finite (reference
    `fabrics_point.py:56-57`)."""
    return torch.where(torch.isfinite(u).all(), u, torch.zeros_like(u))


class QuadrupedGaitPrior:
    """Rhythmic trot tape for quadrupeds (anymal), a time-indexed prior.

    Once per command this emits the next H steps of a diagonal-trot
    velocity-target tape, phase-locked to the global control-step clock and
    steered toward the goal from the measured base pose; MPPI samples around
    it, and replanning supplies the balance feedback an open-loop trot lacks.

    Joint layout: (HAA, HFE, KFE) × (LF, RF, LH, RH), velocity drive. Stance
    half: HFE pushes the body forward; swing half: HFE returns and KFE lifts,
    then lowers, the foot. A posture PD pulls every joint toward the rest
    pose q = 0 (open-loop velocity gaits otherwise drift until the body
    grounds).
    """

    def __init__(self, robot: str = "anymal", goal_actor: str = "goal", H: int = 12,
                 dt: float = 0.1, freq: float = 1.0, push: float = 0.8, lift: float = 1.5,
                 k_turn: float = 0.8, stop_radius: float = 0.4, duty: float = 0.5, phases=None,
                 posture_gain: float = 2.0):
        self.robot = robot
        self.goal_actor = goal_actor
        self.H = int(H)
        self.dt = float(dt)
        self.freq = float(freq)
        self.push = float(push)          # stance HFE velocity target (rad/s)
        self.lift = float(lift)          # swing KFE velocity target
        self.k_turn = float(k_turn)      # differential-stride steering gain
        self.stop_radius = float(stop_radius)   # taper the stride to zero inside it
        self.duty = float(duty)          # stance fraction (0.5 trot … 0.75 crawl)
        self.posture_gain = float(posture_gain)
        # per-leg phase offsets (LF, RF, LH, RH): the diagonal trot by default
        self._phase = np.asarray(phases if phases is not None else [0.0, 0.5, 0.5, 0.0],
                                 np.float32)
        self._left = np.array([1.0, 0.0, 1.0, 0.0], np.float32)   # LF and LH are left
        # the tape's constants on each device, copied at their first use (a
        # tape inside a captured command copies nothing from the host)
        self._dev = DeviceCache()

    def tape(self, view: SimView, t0) -> torch.Tensor:
        """view: a SimView of one env (no leading axis); t0: the world control
        steps executed so far (an int, or the solver carry's 0-d int64
        tensor). → (H, 12) velocity targets."""
        base = view.link_position("base", self.robot)
        dev = base.device
        side = self._dev.get("side", lambda: np.where(self._left > 0, -1.0, 1.0), torch.float32, dev)
        phase = self._dev.get("phase", lambda: self._phase, torch.float32, dev)
        rate = self._dev.get("rate", lambda: self.dt * self.freq, torch.float32, dev)
        steps = self._dev.get("steps", lambda: np.arange(self.H), torch.int32, dev)
        goal = view.actor_position(self.goal_actor)
        yaw = quat_to_yaw(view.actor_orientation(self.robot))
        to_goal = goal[..., :2] - base[..., :2]
        dist = torch.linalg.norm(to_goal)
        hdg_err = torch.atan2(to_goal[..., 1], to_goal[..., 0]) - yaw
        hdg_err = torch.atan2(torch.sin(hdg_err), torch.cos(hdg_err))          # wrap to ±π

        stride = torch.clamp(dist / self.stop_radius, 0.0, 1.0)
        fwd = stride * torch.clamp(torch.cos(hdg_err), 0.0, 1.0)                # gate on facing
        turn = stride * self.k_turn * torch.sin(hdg_err)
        # left legs shorten their stride when turning left (turn > 0)
        leg_gain = fwd[None] + turn[None] * side                               # (4,)

        t = (t0 + steps).to(torch.float32)
        ph = torch.remainder(t[:, None] * rate + phase[None], 1.0)
        d = self.duty
        in_stance = ph < d
        sw = torch.clamp((ph - d) / (1 - d), 0.0, 1.0)                          # swing progress
        # swing HFE returns faster than stance pushes, so the thigh angle is
        # periodic: push·duty == ret·(1 − duty)
        ret = self.push * d / (1 - d)
        hfe = torch.where(in_stance, self.push, -ret) * leg_gain[None]
        kfe = torch.where(in_stance, 0.0, torch.where(sw < 0.5, self.lift, -self.lift)) \
            * torch.maximum(leg_gain.abs()[None], 0.2 * stride)
        u = torch.stack([torch.zeros_like(hfe), hfe, kfe], -1).reshape(self.H, 12)
        u = u + self.posture_gain * (-view.actor_q(self.robot))[None, :]
        return _nan_guard(u)
