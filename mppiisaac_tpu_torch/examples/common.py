"""The two-process layout of the reference (a planner process and a world
process over TCP), shared by the examples: `serve` builds the K-sample
planner and serves it; `run_world` steps a 1-env world in real time, each
step sending `dof_state[0]` and `root_state[0]` as transport bytes and
applying the action that comes back."""
from __future__ import annotations

import signal
import sys
from typing import Callable, Optional

import torch

from ..ops.fused_rollout import FusedRollout
from ..planner.mppi_isaac import MPPIisaacPlanner
from ..runtime.loop import LoopMetrics, goal_world, run_steps
from ..runtime.server import Client, Server
from ..runtime.transport import bytes_to_torch, torch_to_bytes
from ..tasks.common import split_cli
from ..utils.config_store import load_config

DEFAULT_ENDPOINT = "tcp://127.0.0.1:4242"


def serve(task: str, make_objective: Callable, argv=None, device="cuda",
          endpoint=DEFAULT_ENDPOINT):
    """Build the planner of conf `tasks/<task>` (overrides and `device=`,
    `endpoint=` from argv) and serve it until the process is stopped. Port 0
    serves on a free port; the line "planner serving on tcp://host:port"
    tells which. Stopped by SIGTERM, it prints how many times it launched
    the rollout kernel (0 on CPU tensors, which run its plain version)."""
    rest, opts = split_cli(list(sys.argv[1:] if argv is None else argv),
                           {"device": device, "endpoint": endpoint})
    cfg = load_config(f"tasks/{task}", rest)
    planner = MPPIisaacPlanner(cfg, make_objective(cfg), device=opts["device"])
    srv = Server(planner).bind(opts["endpoint"])

    def stopped(signum, frame):
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        print(f"planner stopped: fused_rollout_kernel launches {FusedRollout.launches}",
              flush=True)
        sys.exit(0)

    signal.signal(signal.SIGTERM, stopped)
    host = opts["endpoint"].rsplit(":", 1)[0]
    print(f"planner serving on {host}:{srv.port}", flush=True)
    srv.run()


def run_world(task: str, argv=None, device="cuda", endpoint=DEFAULT_ENDPOINT,
              make_success: Optional[Callable] = None, observer: Optional[Callable] = None,
              verbose: bool = True) -> LoopMetrics:
    """The world process's loop on conf `tasks/<task>` (overrides and
    `device=`, `endpoint=`, `n_steps=` from argv; the conf's n_steps by
    default): `runtime/loop.run_steps` paced to the control period, with
    the planner process as its action source, until the task's success
    test `make_success(cfg)(world)` holds. observer(step, world, action).
    solver_time holds each step's RPC round trip (state out, action back)."""
    rest, opts = split_cli(list(sys.argv[1:] if argv is None else argv),
                           {"device": device, "endpoint": endpoint, "n_steps": None})
    cfg = load_config(f"tasks/{task}", rest)
    dev = torch.device(opts["device"])
    world = goal_world(cfg, dev)
    n = cfg.n_steps if opts["n_steps"] is None else int(opts["n_steps"])
    success_fn = None if make_success is None else make_success(cfg)
    planner = Client().connect(opts["endpoint"])

    def act(state):
        return bytes_to_torch(planner.compute_action_tensor(
            torch_to_bytes(state.dof_state[0]), torch_to_bytes(state.root_state[0])), dev)

    try:
        metrics = run_steps(world, act, n, cfg.isaacgym.dt, success_fn=success_fn,
                            observer=observer, verbose=verbose, real_time=True)
    finally:
        planner.close()
    if verbose:
        print(metrics.summary(), flush=True)
    return metrics
