"""Benchmark of the port: MPPI control rate and rollout throughput on the
flagship workload (the twin of the JAX package's `bench.py`).

panda_pick at K=1000 samples and H=30 steps, world fidelity, the rollout's
substeps matched to the world, 1 impulse sweep, the reduced manifold (it
only changes fast fidelity). The reference's implied sustained throughput is
300k env-steps/s: Isaac Gym at 25 Hz × K·H = 12,000 (BASELINE.md). Prints
ONE JSON line

  {"metric": ..., "value": N, "unit": "env-steps/s", "vs_baseline": N,
   "control_hz": ..., "substeps_per_env_step": ..., "rollout_sweeps": ...,
   "rollout_fidelity": ..., "device": ..., "power_limit": ...}

and its auxiliary lines on stderr. Timing: after a warm-up (one batch, then
one unpipelined command), ITERS batches of CHUNK `_command_impl` calls from
one fixed (rollout state, params), the carry chained; on CUDA each batch is
one replay of a CUDA graph of the CHUNK commands, with the batch's noise
draws made ahead on the host and copied in before the replay (as
`runtime/loop.DeviceChunk` makes them); the clock stops after a host read.
Then the unpipelined latency of one command, each host-synced, over 5 calls.

    python -m mppiisaac_tpu_torch.bench [K=1000] [H=30] [iters=20] [chunk=10] [device=cuda]

Overrides through the environment, as `bench.py`: BENCH_FIDELITY=world|fast,
BENCH_SUBSTEPS=N, BENCH_SWEEPS=N, BENCH_MANIFOLD=full|reduced. On the CPU
(device=cpu, small K, H, iters and chunk) the batches run the plain K1
eagerly, as DeviceChunk does there.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

from .mppi.solver import MppiCarry, MPPIPlanner
from .planner.mppi_isaac import MPPIisaacPlanner
from .runtime.loop import _add_counts, _counts
from .tasks.common import split_cli
from .tasks.panda_pick import PandaPickObjective
from .utils.config_store import load_config

K, H = 1000, 30
ITERS, CHUNK = 20, 10
LATENCY_CALLS = 5
REF_ENV_STEPS_PER_SEC = 300_000.0   # the reference's implied sustained rate (BASELINE.md)


class CommandBatch:
    """`chunk` MPPI commands from one fixed `state0`, each from the carry the
    one before left, on static buffers: the carry (U, λ, Σ, t0), the
    batch's draws and the sums of its actions. On CUDA the batch is captured
    once as a CUDA graph (after an eager warm-up batch on a side stream, which
    builds the kernels' library and copies their tables) and replayed; a
    replay makes no Python call, so the counts the capture recorded are added
    once per replay. On CPU tensors the batch runs eagerly."""

    def __init__(self, mppi: MPPIPlanner, state0, chunk: int):
        self.mppi, self.state0, self.n = mppi, state0, int(chunk)
        self.device = mppi.device
        c = mppi.carry
        self._U, self._lam = c.U.clone(), c.lambda_.clone()
        self._sigma, self._t0 = c.sigma.clone(), c.t0.clone()
        _, d = mppi.draws(c.key, 1)
        self._draws = torch.empty((self.n,) + d.shape[1:], dtype=torch.float32,
                                  device=self.device)
        self._asum = torch.zeros(self.n, dtype=torch.float32, device=self.device)
        self.key = c.key
        self._graph = None
        self._delta = (0, 0, 0)

    def _batch(self):
        for i in range(self.n):
            carry = MppiCarry(U=self._U, lambda_=self._lam, sigma=self._sigma, t0=self._t0)
            action, new, _ = self.mppi._command_impl(carry, self.state0, draw=self._draws[i])
            self._asum[i] = action.sum()
            self._U.copy_(new.U)
            self._lam.copy_(new.lambda_)
            self._sigma.copy_(new.sigma)
            self._t0.copy_(new.t0)

    def run(self):
        """One batch: its draws made ahead and copied in, then the commands
        (a graph replay on CUDA). Returns without waiting for the device."""
        self.key, draws = self.mppi.draws(self.key, self.n)
        self._draws.copy_(torch.from_numpy(draws))
        if self.device.type != "cuda":
            self._batch()
        elif self._graph is None:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._batch()                      # the warm-up batch, for real
            torch.cuda.current_stream(self.device).wait_stream(side)
            before = _counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._batch()
            self._delta = tuple(a - b for a, b in zip(_counts(), before))
            _add_counts(self._delta, -1)           # the capture itself launched nothing
            self._graph = graph
        else:
            self._graph.replay()
            _add_counts(self._delta)

    @property
    def carry(self) -> MppiCarry:
        return MppiCarry(U=self._U.clone(), lambda_=self._lam.clone(), sigma=self._sigma.clone(),
                         t0=self._t0.clone(), key=self.key)

    def action_sum(self) -> float:
        """The host read that ends a timed region."""
        return float(self._asum.sum().item())


def _settings():
    """bench.py's planner-model knobs, from the environment."""
    return (os.environ.get("BENCH_FIDELITY", "world"), os.environ.get("BENCH_SUBSTEPS", ""),
            os.environ.get("BENCH_SWEEPS", "1"), os.environ.get("BENCH_MANIFOLD", "reduced"))


def config(K: int = K, H: int = H):
    """The benchmark's panda_pick conf at K samples and horizon H."""
    fidelity, substeps_o, sweeps_o, manifold = _settings()
    over = [f"mppi.num_samples={K}", f"mppi.horizon={H}", f"mppi.rollout_fidelity={fidelity}"]
    if substeps_o:
        over.append(f"mppi.rollout_substeps={substeps_o}")
    if sweeps_o:
        over.append(f"mppi.rollout_sweeps={sweeps_o}")
    if manifold:
        over.append(f"mppi.rollout_manifold={manifold}")
    return load_config("tasks/panda_pick", over)


def main(K: int = K, H: int = H, iters: int = ITERS, chunk: int = CHUNK, device="cuda") -> dict:
    """Run the benchmark; print its JSON record and return it, with the
    per-command and latency ms unrounded and the planner it ran."""
    device = torch.device(device)
    fidelity, _, _, manifold = _settings()
    cfg = config(K, H)
    t0 = time.perf_counter()
    planner = MPPIisaacPlanner(cfg, PandaPickObjective(cfg), randomize=True, device=device)
    state0 = (planner.sim.state, planner._params_K)
    print(f"build: {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    batch = CommandBatch(planner.mppi, state0, chunk)
    t0 = time.perf_counter()
    batch.run()
    batch.action_sum()
    print(f"capture+warmup: {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        batch.run()
    batch.action_sum()
    dt = (time.perf_counter() - t0) / (iters * chunk)

    # per-command latency (independent calls, each host-synced): what a
    # control loop that waits for every command sees
    carry = batch.carry
    a_l, _, _ = planner.mppi._command_impl(carry, state0)       # outside the clock
    float(a_l.sum())
    t0 = time.perf_counter()
    for _ in range(LATENCY_CALLS):
        a_l, _, _ = planner.mppi._command_impl(carry, state0)
        float(a_l.sum())
    lat_ms = (time.perf_counter() - t0) / LATENCY_CALLS * 1e3
    print(f"per-command latency (unpipelined, host-synced): {lat_ms:.3f} ms", file=sys.stderr)

    fused = planner.mppi.fused
    substeps, sweeps = fused.substeps, fused.impulse_sweeps
    control_hz = 1.0 / dt
    env_steps = K * H / dt                  # control-dt env steps per second
    print(f"control rate: {control_hz:.1f} Hz | env-steps/s: {env_steps / 1e6:.3f}M "
          f"(x{substeps} substeps -> {env_steps * substeps / 1e6:.3f}M physics substeps/s) | "
          f"per-command: {dt * 1e3:.3f} ms", file=sys.stderr)
    if device.type == "cuda":
        from .utils.profiling import card

        where = card()
        how = f"a CUDA graph of {chunk} commands per replay like the device_steps control loop"
    else:
        where = {"device": "cpu", "power_limit": None}
        how = f"eager batches of {chunk} commands"
    record = {
        "metric": (f"panda_pick rollout env-steps/sec on {where['device']} "
                   f"(K={K}, H={H}, fidelity={fidelity}, substeps={substeps}, sweeps={sweeps}"
                   f"{', manifold=' + manifold if manifold else ''}, {how})"),
        "value": round(env_steps, 0),
        "unit": "env-steps/s",
        "vs_baseline": round(env_steps / REF_ENV_STEPS_PER_SEC, 2),
        "control_hz": round(control_hz, 1),
        "substeps_per_env_step": substeps,
        "rollout_sweeps": sweeps,
        "rollout_fidelity": fidelity,
        **where,
    }
    print(json.dumps(record), flush=True)
    return dict(record, per_command_ms=dt * 1e3, latency_ms=lat_ms, planner=planner)


if __name__ == "__main__":
    rest, opts = split_cli(sys.argv[1:], {"K": K, "H": H, "iters": ITERS, "chunk": CHUNK,
                                          "device": "cuda"})
    if rest:
        sys.exit(f"unknown arguments {rest} (usage: python -m mppiisaac_tpu_torch.bench "
                 "[K=1000] [H=30] [iters=20] [chunk=10] [device=cuda])")
    main(int(opts["K"]), int(opts["H"]), int(opts["iters"]), int(opts["chunk"]), opts["device"])
