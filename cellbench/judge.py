"""The comparison that decides `correct`.

The reference (`reference/controller.Reference`) works out again, from the
configuration file and the seed, everything the port derived: the scenes,
their tables, the per-sample mass and friction scales, the noise of each
command. It follows the port stage by stage from the port's own state. At
each judged step it takes the world state and the solver's carry the port
had before the step, and

* runs K1 over the whole horizon for all K samples from the carry's noise;
* works out the command (the action and the carry's new U) from the noise
  and the costs the port's K1 gave, and again from its own K1's costs;
* runs K2 from the world state under the port's action.

The numbers compared, each against its limit in `limits/<cell>.json`
(every number but `command_own_gap` in every cell):

* `start_gap`: the largest difference between the port's goal-placed
  initial world state and first carry and the reference's (an episode's
  start, which following the port's state skips);
* `cost_gap`: over all judged samples, the 95th percentile of a sample's
  difference from the reference in K1's cost at the first horizon step,
  relative to that cost;
* `horizon_cost_gap`: over all judged samples, the median of a sample's
  difference in K1's cost summed over the horizon, relative to that sum;
* `command_gap`: the largest difference of the action or the new U, over
  the control range (u_max − u_min), the update worked out from the port's
  K1 costs;
* `command_own_gap`: the same with the update worked out from the
  reference's own K1 costs: the whole command. Compared only where the
  cell's limits file lists it: under contact the softmax over costs that
  float32 rounding moves can move the command across its whole range;
* `pose_gap`: over the judged steps, the largest difference in K2's poses
  one control dt later (every actor's root position and quaternion, every
  joint position).

Under contact a sample's rollout parts from itself under float32 rounding
within a few horizon steps, so the horizon is held by its median sample and
the tail by the first step (PERF.md gives the readings). A number that is
not finite fails.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

NUMBERS = ("start_gap", "cost_gap", "horizon_cost_gap", "command_gap", "command_own_gap",
           "pose_gap")
OPTIONAL = ("command_own_gap",)
COST_Q, HORIZON_Q = 0.95, 0.5


@contextlib.contextmanager
def float32_products():
    """Matrix products in float32, not TF32, inside the block (the
    reference's precision), restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def to_host(x):
    """A record's tensors copied to the host, recursively."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_host(v) for v in x]
    return x


def reference(config: dict, device, store=None):
    """The reference of a configuration file: its "conf", its "cost" and,
    where it names one, its "reference_prior"."""
    from .reference.controller import Reference

    return Reference(config["conf"], config["cost"], device, store=store,
                     prior=config.get("reference_prior"))


def _carry(ref, c: dict):
    from .reference.mppi.solver import MppiCarry

    dev = ref.device
    return MppiCarry(U=c["U"].to(dev), lambda_=c["lambda_"].to(dev), sigma=c["sigma"].to(dev),
                     t0=c["t0"].to(dev), key=np.asarray(c["key"], np.uint32))


def _finite_max(x: torch.Tensor) -> float:
    if x.numel() == 0:
        return 0.0
    v = float(x.max())
    return v if np.isfinite(v) and bool(torch.isfinite(x).all()) else float("inf")


def start_gap(ref, start: dict, episode_seed: int) -> float:
    gaps = [_finite_max((v.to(ref.device) - getattr(ref.initial_world, name)).abs())
            for name, v in start["state"].items()]
    c0, c = ref.initial_carry(episode_seed), start["carry"]
    for name in ("U", "lambda_", "sigma"):
        gaps.append(_finite_max((c[name].to(ref.device) - getattr(c0, name)).abs()))
    if int(c["t0"]) != int(c0.t0) or not np.array_equal(np.asarray(c["key"], np.uint32), c0.key):
        gaps.append(float("inf"))
    return max(gaps)


def steps_of(ref, records: List[dict]) -> List[dict]:
    from .reference.controller import state_from

    return [{"state": state_from(r["before"], ref.device), "carry": _carry(ref, r["carry"])}
            for r in records]


def outputs(ref, records: List[dict]) -> List[dict]:
    """The reference's outputs at the judged steps: K1's costs (K, H) and
    the noise it was given, the action and the new U from the port's K1
    costs and from its own, and K2's rows after the step under the port's
    action."""
    steps = steps_of(ref, records)
    with torch.no_grad():
        costs, eps = ref.costs(steps)
        out = []
        for s, e, c, r in zip(steps, eps, costs, records):
            action, U, _ = ref.update(s["carry"], e, r["costs"].to(ref.device, torch.float32))
            own_action, own_U, _ = ref.update(s["carry"], e, c)
            out.append({"costs": c, "eps": e, "action": action, "U": U,
                        "own_action": own_action, "own_U": own_U})
        rows = ref.world_steps([s["state"] for s in steps],
                               [r["action"].to(ref.device) for r in records])
    for i, o in enumerate(out):
        o["rows"] = rows[:, i]
    return out


def relative(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got − want| / |want| (floored at 1e-6), inf where not finite."""
    g = (got - want).abs() / want.abs().clamp_min(1e-6)
    return torch.where(torch.isfinite(g), g, torch.full_like(g, float("inf")))


def quantile(g: List[torch.Tensor], q: float) -> float:
    if not g:
        return 0.0
    g = torch.cat(g).double().cpu()
    return float(torch.quantile(g, q)) if bool(torch.isfinite(g).all()) else float("inf")


def pose_rows(ks) -> torch.Tensor:
    """The K2 rows of the poses: each actor's root position and quaternion,
    then the joint positions."""
    idx = [13 * a + j for a in range(ks.nactor) for j in range(7)]
    idx += list(range(13 * ks.nactor, 13 * ks.nactor + ks.ndof))
    return torch.as_tensor(idx)


def numbers(ref, records: List[dict], expected: List[dict], u_range: float,
            per_step: bool = False) -> Dict[str, float]:
    """cost_gap, horizon_cost_gap, command_gap, command_own_gap and
    pose_gap of the port's records against the reference's outputs at the same steps (`per_step`:
    also each step's pose difference, "pose_steps"). A record's world state
    after the step is `after` (SimState fields) or `after_rows` (K2's
    rows)."""
    from .reference.controller import state_from

    poses = pose_rows(ref.world_step.ks).to(ref.device)
    first, horizon, command, own, pose = [], [], [0.0], [0.0], []
    for r, e in zip(records, expected):
        c_p = r["costs"].to(ref.device, torch.float32)
        first.append(relative(c_p[:, 0], e["costs"][:, 0]))
        horizon.append(relative(c_p.sum(1), e["costs"].sum(1)))
        action, U = r["action"].to(ref.device, torch.float32), r["U"].to(ref.device, torch.float32)
        for gaps, a, u in ((command, e["action"], e["U"]), (own, e["own_action"], e["own_U"])):
            gaps.append(max(_finite_max((action - a).abs()), _finite_max((U - u).abs())) / u_range)
        if "after_rows" in r:
            got = r["after_rows"].to(ref.device)
        else:
            got = ref.world_step.out_rows(state_from(r["after"], ref.device))[:, 0]
        pose.append(_finite_max((got[poses] - e["rows"][poses]).abs()))
    out = {"cost_gap": quantile(first, COST_Q), "horizon_cost_gap": quantile(horizon, HORIZON_Q),
           "command_gap": max(command), "command_own_gap": max(own),
           "pose_gap": max(pose, default=0.0)}
    if per_step:
        out["pose_steps"] = pose
    return out


def u_range(ref) -> float:
    c = ref.solver.cfg
    return float(np.max(np.asarray(c.u_max) - np.asarray(c.u_min)))


def verdict(values: Dict[str, float], limits: Dict[str, float]):
    """→ (correct, [(name, value, limit)]): each number that `limits` lists
    within its limit."""
    rows = [(n, float(values[n]), float(limits[n])) for n in NUMBERS if n in limits]
    return all(v <= lim for _, v, lim in rows), rows
