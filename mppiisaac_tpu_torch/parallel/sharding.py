"""K-sharding of the MPPI command over a `torch.distributed` process group
(parity: the JAX package's `parallel/sharding.py`, whose shard_map over a
device mesh becomes one process per rank here).

Rollouts are independent per sample, so each rank rolls out its own K/n
samples, with its own solver over K/n samples (`fused_factory(K // n)`, or
the unfused rollout), and the only communication of a command is the
softmax: β = min S is an all-reduce MIN, η = Σ exp and Σ w ε (and the
covariance update's Σ w ε εᵀ) are all-reduce SUMs. With Halton sampling each
rank takes its slice of the global K-point table, shifted by the same
Cranley–Patterson draw (the same key on every rank), and the special samples
(the null action in K−1, the tape or the prior in K−2) go on the last rank
only, so the sharded sample set is the one-device one. With random sampling
rank r draws from `fold_in(key, r)`, as the JAX shards do. Every rank
returns the same action and carry, and the key advances once.

The caller starts the ranks and the default group
(`torch.distributed.init_process_group(init_method="tcp://localhost:<port>",
rank=r, world_size=n)`); `make_group` picks the backend. NCCL needs a card
per rank; with one card the ranks share it over gloo.

`python -m mppiisaac_tpu_torch.parallel.sharding task=panda_pick ranks=2
[device=cuda|cpu] [use_fused=true|false] [reps=5] [out=result.json]
[mppi.num_samples=... other overrides]` runs the sharded command of a
task's planner from its initial world state on `ranks` local processes
(gloo) beside the one-device command of the same carry and state, and
prints (and writes to `out`) both actions, the per-sample costs' largest
difference, both command times and each rank's rollout-kernel launches.
"""
from __future__ import annotations

import copy
import dataclasses
import importlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..mppi import prng
from ..mppi.sampling import halton
from ..mppi.solver import MPPIPlanner


def make_group(backend: Optional[str] = None):
    """A process group over every rank of the default group. backend None:
    "nccl" where every rank has a card of its own, else "gloo"."""
    n = dist.get_world_size()
    if backend is None:
        own_card = torch.cuda.is_available() and torch.cuda.device_count() >= n
        backend = "nccl" if own_card and dist.is_nccl_available() else "gloo"
    return dist.new_group(ranks=list(range(n)), backend=backend)


def _rows(state0, lo: int, hi: int, K: int):
    """Rows lo:hi of the K-wide rollout state (SimState_K, ModelParams_K);
    a state of this rank's rows already is returned as it is."""
    return tuple(x.map(lambda t: t[lo:hi] if t.shape[0] == K else t) for x in state0)


def sharded_command(planner_mppi: MPPIPlanner, group=None, fused_factory=None):
    """The command of `planner_mppi` (a `mppi.solver.MPPIPlanner` over K
    samples) sharded over the ranks of `group` (the default group when
    None). → run(carry, state0) → (action, carry, info): state0 is the
    K-wide rollout state (each rank takes its rows) or this rank's K/n rows;
    info["costs"] holds all K per-sample costs, gathered. fused_factory:
    ``K_shard -> FusedRollout`` (MPPIisaacPlanner.fused_factory), or None for
    the unfused rollout of the planner's closures."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    cfg = planner_mppi.cfg
    K = cfg.num_samples
    if K % n:
        raise ValueError(f"num_samples {K} is not a multiple of the {n} ranks")
    Kl = K // n
    shard_cfg = copy.copy(cfg)
    shard_cfg.num_samples = Kl
    local = MPPIPlanner(
        shard_cfg, planner_mppi.nx,
        fused=fused_factory(Kl) if fused_factory is not None else None,
        device=planner_mppi.device, tape_prior=planner_mppi.tape_prior,
        dynamics=planner_mppi.dynamics, running_cost=planner_mppi.running_cost,
        prior=planner_mppi.prior, vis_fn=planner_mppi.vis_fn,
    )
    local.group = group if group is not None else dist.group.WORLD
    local.rank, local.n_shards = rank, n
    lo, hi = rank * Kl, (rank + 1) * Kl
    if cfg.sampling_method == "halton":
        # this rank's slice of the global K-point table: the union of the
        # ranks' rows is one low-discrepancy set
        table = halton(K, local._sample_dims, skip=1)[lo:hi]
        local._halton_base = torch.as_tensor(np.asarray(table, np.float32), device=local.device)

    def run(carry, state0):
        carry_l = carry
        if cfg.sampling_method != "halton":
            carry_l = dataclasses.replace(carry, key=prng.fold_in(carry.key, rank))
        action, new_carry, info = local._command_impl(carry_l, _rows(state0, lo, hi, K))
        parts = [torch.empty_like(info["costs"]) for _ in range(n)]
        dist.all_gather(parts, info["costs"].contiguous(), group=local.group)
        info = dict(info, costs=torch.cat(parts), local_costs=info["costs"])
        # the key advances once, globally
        return action, dataclasses.replace(new_carry, key=prng.split(carry.key)[0]), info

    run.local = local
    return run


# ---------------------------------------------------------------------------
# the command-line run: one process per rank on this machine
# ---------------------------------------------------------------------------

def _objective_class(task: str):
    mod = importlib.import_module(f"mppiisaac_tpu_torch.tasks.{task}")
    found = [v for k, v in vars(mod).items()
             if k.endswith("Objective") and getattr(v, "__module__", "") == mod.__name__
             and not k.startswith("_")]
    if len(found) != 1:
        raise ValueError(f"tasks.{task} has no single objective class: {found}")
    return found[0]


def _median_ms(fn, device, reps):
    times = []
    out = None
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def _worker(rank: int, n: int, port: int, opts: dict, overrides):
    from ..ops.fused_rollout import FusedRollout
    from ..planner.mppi_isaac import MPPIisaacPlanner
    from ..runtime.loop import goal_world
    from ..utils.config_store import load_config

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=n)
    device = torch.device(opts["device"])
    if device.type == "cpu":
        torch.set_num_threads(1)          # the ranks share the machine's cores
    group = make_group("gloo")
    task = opts["task"]
    cfg = load_config(f"tasks/{task}", overrides)
    world = goal_world(cfg, device)
    planner = MPPIisaacPlanner(cfg, _objective_class(task)(cfg), device=device,
                               use_fused=opts["use_fused"])
    planner.reset_rollout_from_state(world.state)
    state0 = (planner.sim.state, planner._params_K)
    carry = planner.mppi.carry
    reps = int(opts["reps"])
    result = {}
    if rank == 0:
        # the one-device command of the same carry and state
        FusedRollout.launches = 0
        ms_one, (a1, _, i1) = _median_ms(
            lambda: planner.mppi._command_impl(carry, state0), device, reps)
        result.update(action_one=a1.cpu().numpy().tolist(), ms_one=ms_one,
                      k1_launches_one=FusedRollout.launches)
        costs_one = i1["costs"].cpu()
    dist.barrier(group)
    factory = planner.fused_factory() if planner.use_fused else None
    run = sharded_command(planner.mppi, group, fused_factory=factory)
    FusedRollout.launches = 0
    ms, (a, c, info) = _median_ms(lambda: run(carry, state0), device, reps)
    launches = [None] * n
    dist.all_gather_object(launches, FusedRollout.launches, group=group)
    actions = [None] * n
    dist.all_gather_object(actions, a.cpu().numpy().tolist(), group=group)
    if rank == 0:
        costs = info["costs"].cpu()
        a1 = np.asarray(result["action_one"])
        result.update(
            task=task, ranks=n, K=cfg.mppi.num_samples, K_rank=cfg.mppi.num_samples // n,
            H=cfg.mppi.horizon, device=str(device), use_fused=planner.use_fused,
            action=a.cpu().numpy().tolist(), ms_sharded=ms, k1_launches_per_rank=launches,
            same_action_on_every_rank=all(x == actions[0] for x in actions),
            costs_bit_equal=bool(torch.equal(costs, costs_one)),
            costs_max_abs_diff=float((costs - costs_one).abs().max()),
            costs_max_abs=float(costs_one.abs().max()),
            action_max_rel_diff=float(np.abs(np.asarray(result["action_one"]) - a.cpu().numpy()).max()
                                      / max(np.abs(a1).max(), 1e-12)),
            key_after=[int(x) for x in c.key], t0_after=int(c.t0),
            costs=costs.numpy().tolist(), costs_one=costs_one.numpy().tolist(),
        )
        if opts["out"]:
            with open(opts["out"], "w") as fh:
                json.dump(result, fh)
        summary = {k: v for k, v in result.items() if k not in ("costs", "costs_one")}
        print(json.dumps(summary), flush=True)
    dist.barrier(group)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(ranks: int, argv, timeout: float = 600.0) -> int:
    """Run this module's worker in `ranks` processes (one per rank) with the
    command-line arguments argv; every process is stopped on return. →
    the first non-zero exit code, or 0."""
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen([sys.executable, "-m", "mppiisaac_tpu_torch.parallel.sharding",
                               f"_rank={r}", f"_port={port}", f"ranks={ranks}"] + list(argv),
                              env=env)
             for r in range(ranks)]
    rc = 0
    try:
        deadline = time.time() + timeout
        for p in procs:
            code = p.wait(timeout=max(deadline - time.time(), 1.0))
            rc = rc or code
    except subprocess.TimeoutExpired:
        rc = 124
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


def main(argv=None):
    from ..tasks.common import fused_opt, split_cli

    argv = list(sys.argv[1:] if argv is None else argv)
    rest, opts = split_cli(argv, {"task": "panda_pick", "ranks": 2, "device": "cuda", "reps": 5,
                                  "out": "", "timeout": 600, "use_fused": None, "_rank": None,
                                  "_port": None})
    opts["use_fused"] = fused_opt(opts["use_fused"])
    if opts["_rank"] is None:
        sys.exit(launch(int(opts["ranks"]), argv, float(opts["timeout"])))
    _worker(int(opts["_rank"]), int(opts["ranks"]), int(opts["_port"]), opts, rest)


if __name__ == "__main__":
    main()
