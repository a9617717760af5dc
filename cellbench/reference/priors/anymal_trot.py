# Frozen copy of QuadrupedGaitPrior.tape and _nan_guard of
# mppiisaac_tpu_torch/planner/priors.py, part of the benchmark's yardstick.
"""anymal's diagonal-trot velocity-target tape.

Once per command: the next H steps of the trot, phase-locked to the world's
control-step clock and steered toward the goal from the measured base pose,
plus a posture PD toward the rest pose q = 0. Joint layout (HAA, HFE, KFE) ×
(LF, RF, LH, RH). The tape reads the base link's position from the state's
body rows, the goal's root position, the robot's root orientation and q,
as the port's `SimView` reads them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..physics.math3d import quat_to_yaw
from ..utils.device_cache import DeviceCache


# the port's defaults, which `tasks/anymal.gait_prior` keeps
FREQ, PUSH, LIFT, K_TURN, STOP_RADIUS, DUTY, POSTURE_GAIN = 1.0, 0.8, 1.5, 0.8, 0.4, 0.5, 2.0
PHASE = np.asarray([0.0, 0.5, 0.5, 0.0], np.float32)     # LF, RF, LH, RH: the diagonal trot
LEFT = np.array([1.0, 0.0, 1.0, 0.0], np.float32)        # LF and LH are left


def _nan_guard(u: torch.Tensor) -> torch.Tensor:
    """The whole tape zeroed if anything in it is not finite."""
    return torch.where(torch.isfinite(u).all(), u, torch.zeros_like(u))


class TrotTape:
    def __init__(self, built, H: int, dt: float):
        scene = built.scene
        self.base = scene.body_index("base", "anymal")
        self.goal = scene.actor_index("goal")
        self.robot = scene.actor_index("anymal")
        self.dofs = scene.actor_dof_slice("anymal")
        self.H = int(H)
        self.dt = float(dt)
        self._dev = DeviceCache()

    def __call__(self, state, t0) -> torch.Tensor:
        """state: the 1-env world SimState (a leading env axis of 1); t0:
        the world control steps executed so far (an int or a 0-d int64
        tensor). → (H, 12) velocity targets."""
        base = state.body_pos[0, self.base]
        dev = base.device
        side = self._dev.get("side", lambda: np.where(LEFT > 0, -1.0, 1.0), torch.float32, dev)
        phase = self._dev.get("phase", lambda: PHASE, torch.float32, dev)
        rate = self._dev.get("rate", lambda: self.dt * FREQ, torch.float32, dev)
        steps = self._dev.get("steps", lambda: np.arange(self.H), torch.int32, dev)
        goal = state.root_pos[0, self.goal]
        yaw = quat_to_yaw(state.root_quat[0, self.robot])
        to_goal = goal[..., :2] - base[..., :2]
        dist = torch.linalg.norm(to_goal)
        hdg_err = torch.atan2(to_goal[..., 1], to_goal[..., 0]) - yaw
        hdg_err = torch.atan2(torch.sin(hdg_err), torch.cos(hdg_err))          # wrap to ±π

        stride = torch.clamp(dist / STOP_RADIUS, 0.0, 1.0)
        fwd = stride * torch.clamp(torch.cos(hdg_err), 0.0, 1.0)                # gate on facing
        turn = stride * K_TURN * torch.sin(hdg_err)
        leg_gain = fwd[None] + turn[None] * side                               # (4,)

        t = (t0 + steps).to(torch.float32)
        ph = torch.remainder(t[:, None] * rate + phase[None], 1.0)
        in_stance = ph < DUTY
        sw = torch.clamp((ph - DUTY) / (1 - DUTY), 0.0, 1.0)                    # swing progress
        ret = PUSH * DUTY / (1 - DUTY)                  # the thigh angle is periodic
        hfe = torch.where(in_stance, PUSH, -ret) * leg_gain[None]
        kfe = torch.where(in_stance, 0.0, torch.where(sw < 0.5, LIFT, -LIFT)) \
            * torch.maximum(leg_gain.abs()[None], 0.2 * stride)
        u = torch.stack([torch.zeros_like(hfe), hfe, kfe], -1).reshape(self.H, 12)
        u = u + POSTURE_GAIN * (-state.q[0, self.dofs])[None, :]
        return _nan_guard(u)


def tape_prior(built, cfg):
    """The trot tape the configuration asks for (mppi.use_priors), else None."""
    if not cfg.mppi.use_priors:
        return None
    return TrotTape(built, H=cfg.mppi.horizon, dt=cfg.isaacgym.dt)
