"""Priors biasing MPPI sampling (parity: the JAX package's
`planner/priors.py`), in two forms:

* a tape prior (`QuadrupedGaitPrior.tape`) is evaluated once per command,
  from the measured 1-env world state and the global control-step clock,
  and gives a whole (H, nu) control tape (`mppi/solver.py` injects it as one
  sample and, with `prior_blend`, shifts the sampling mean toward it). It
  runs in plain torch before the rollout and never enters it, so it works
  with the fused rollout too;
* a closed-loop prior (`PointNavigationPrior`, `ArmJacobianPrior`:
  `compute_command(view) → (K, nu)`) is evaluated at every rollout step on
  the K-batched view, and sample K−2 applies its clipped command: the
  unfused rollout only (the capability of the reference's fabrics priors).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..physics.linalg import solve_psd
from ..physics.math3d import cross, quat_rotate, quat_to_yaw
from ..utils.device_cache import DeviceCache
from .observables import SimView


def _nan_guard(u: torch.Tensor, per_sample: bool = False) -> torch.Tensor:
    """Zero the command if anything went non-finite (reference
    `fabrics_point.py:56-57`): the whole tape, or with per_sample each
    sample's command (the last axis) on its own."""
    ok = torch.isfinite(u).all(-1, keepdim=True) if per_sample else torch.isfinite(u).all()
    return torch.where(ok, u, torch.zeros_like(u))


class PointNavigationPrior:
    """Velocity-field prior for planar holonomic robots (nu = 3: vx, vy, ω):
    attraction to the goal plus repulsion from obstacles within `influence`,
    capped at `max_speed`."""

    def __init__(self, robot: str = "point_robot", goal_actor: str = "goal",
                 obstacle_actors: Sequence[str] = (), k_attract: float = 1.0,
                 k_repel: float = 0.4, influence: float = 1.0, max_speed: float = 1.0):
        self.robot = robot
        self.goal_actor = goal_actor
        self.obstacles = list(obstacle_actors)
        self.k_attract = k_attract
        self.k_repel = k_repel
        self.influence = influence
        self.max_speed = max_speed

    def compute_command(self, view: SimView) -> torch.Tensor:
        """→ (..., 3) velocity commands of the K-batched view."""
        pos = view.actor_q(self.robot)[..., :2]
        goal = view.actor_position(self.goal_actor)[..., :2]
        v = self.k_attract * (goal - pos)
        for ob in self.obstacles:
            d = pos - view.actor_position(ob)[..., :2]
            dist = torch.linalg.norm(d, dim=-1, keepdim=True)
            rep = self.k_repel * d / torch.clamp(dist, min=1e-3) ** 2
            v = v + torch.where(dist < self.influence, rep, 0.0)
        speed = torch.linalg.norm(v, dim=-1, keepdim=True)
        v = v * torch.clamp(self.max_speed / torch.clamp(speed, min=1e-6), max=1.0)
        return _nan_guard(torch.cat([v, torch.zeros_like(v[..., :1])], -1), per_sample=True)


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


class ArmJacobianPrior:
    """Jacobian-transpose end-effector attraction for fixed-base arms
    (velocity mode), from the engine's own forward kinematics (the body
    poses of the view): damped least squares qdot = Jᵀ(JJᵀ + λ²I)⁻¹ v toward
    the goal, plus repulsion of the end effector from obstacles, clipped to
    ±max_joint_vel. Gripper (finger) dofs are left out of the arm's chain."""

    def __init__(self, built, robot: str = "panda", ee_link: str = "panda_ee_tip",
                 goal_actor: str = "goal", gain: float = 2.0, max_joint_vel: float = 1.0,
                 nu: Optional[int] = None, obstacle_actors: Sequence[str] = (),
                 k_repel: float = 0.3, influence: float = 0.5):
        self.built = built
        self.robot = robot
        self.ee_link = ee_link
        self.goal_actor = goal_actor
        self.gain = gain
        self.max_joint_vel = max_joint_vel
        self.obstacles = list(obstacle_actors)
        self.k_repel = k_repel
        self.influence = influence
        scene = built.scene
        ai = scene.actor_index(robot)
        art = scene.actors[ai]
        bo = scene.body_offset[ai]
        # the chain: the body owning each arm dof, its local axis and joint
        # type, in dof order
        self._dof_bodies = sorted(
            (int(art.dof_index[i]), bo + i, np.asarray(art.jaxis[i]), int(art.jtype[i]))
            for i in range(art.nbody)
            if art.dof_index[i] >= 0 and "finger" not in art.dof_names[int(art.dof_index[i])]
        )
        self.nu = nu or len(self._dof_bodies)
        self._dev = DeviceCache()

    def _jacobian(self, view: SimView):
        """→ (ee (...,3), J (...,3,n))."""
        ee = view.link_position(self.ee_link, self.robot)
        dev = ee.device
        cols = []
        for k, body, axis, jtype in self._dof_bodies:
            axis_w = quat_rotate(view.state.body_quat[..., body, :],
                                 self._dev.get(f"axis{k}", lambda: axis, torch.float32, dev))
            if jtype == 1:      # revolute: axis × (ee − joint)
                cols.append(cross(axis_w, ee - view.state.body_pos[..., body, :]))
            else:               # prismatic
                cols.append(axis_w)
        return ee, torch.stack(cols, -1)

    def compute_command(self, view: SimView) -> torch.Tensor:
        """→ (..., nu) joint velocity commands of the K-batched view."""
        ee, J = self._jacobian(view)
        v_des = self.gain * (view.actor_position(self.goal_actor) - ee)   # task-space velocity
        for ob in self.obstacles:
            d = ee - view.actor_position(ob)
            dist = torch.linalg.norm(d, dim=-1, keepdim=True)
            rep = self.k_repel * d / torch.clamp(dist, min=1e-3) ** 2
            v_des = v_des + torch.where(dist < self.influence, rep, 0.0)
        # damped least squares; the 3×3 solve is an unrolled Cholesky (no
        # host check, so a captured rollout can run it)
        eye = self._dev.get("eye3", lambda: np.eye(3), torch.float32, ee.device)
        JJt = J @ J.transpose(-1, -2) + 0.01 * eye
        y = solve_psd(JJt, v_des)
        u = torch.clamp((J.transpose(-1, -2) @ y[..., None])[..., 0],
                        -self.max_joint_vel, self.max_joint_vel)
        if self.nu > u.shape[-1]:
            u = torch.cat([u, u.new_zeros(u.shape[:-1] + (self.nu - u.shape[-1],))], -1)
        return _nan_guard(u, per_sample=True)
