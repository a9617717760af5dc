"""Single-process control loop: world sim + MPPI planner in one process
(parity with the JAX package's `runtime/loop.py` `run_task` and
`run_task_episodes`).

Each control step: one planner command from the world state, the action
through the command map, one world step. Two paths, as in the JAX package:

* the per-step loop (`run_steps`): the host drives every step;
* the chunked loop (`device_steps` > 1, `DeviceChunk`): up to N control steps
  per host round trip. On CUDA one control step is captured once as a CUDA
  graph (the JAX package jits a `lax.scan` over N steps) and replayed N
  times; the host copies the chunk's noise draws in once and fetches the
  post-step world states and actions as one buffer once, then replays
  `success_fn` step by step. On the CPU the same step body runs eagerly.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..mppi import prng
from ..mppi.solver import MppiCarry, MPPIPlanner
from ..ops.fused_rollout import FusedRollout, FusedWorldStep
from ..physics.types import SIM_STATE_FIELDS, SimState
from ..planner.mppi_isaac import MPPIisaacPlanner
from ..utils.config_store import ExampleConfig
from ..utils.profiling import graph_nodes, paused, span, take_tape_nodes
from .sim import Simulation


@dataclass
class LoopMetrics:
    fps: List[float] = field(default_factory=list)
    rt_factor: List[float] = field(default_factory=list)
    solver_time: List[float] = field(default_factory=list)
    path_length: float = 0.0
    steps: int = 0
    success_step: Optional[int] = None
    final_state_finite: bool = True
    # control steps the device ran: `steps`, plus those a chunk ran past
    # the success step
    commands: int = 0
    # the chunked loop on CUDA: the nodes of the captured control step by
    # type (utils/profiling.graph_nodes), and under "tape" those of the
    # solver's tape prior (0 without one)
    graph_nodes: Optional[dict] = None

    def summary(self) -> dict:
        return {
            "steps": self.steps,
            "mean_fps": float(np.mean(self.fps)) if self.fps else 0.0,
            "mean_rt": float(np.mean(self.rt_factor)) if self.rt_factor else 0.0,
            "mean_solver_time_ms": float(np.mean(self.solver_time) * 1e3) if self.solver_time else 0.0,
            "path_length": self.path_length,
            "success_step": self.success_step,
            "time2goal": self.success_step,
        }


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def goal_world(cfg: ExampleConfig, device) -> Simulation:
    """The 1-env world of a task, with the goal marker placed from cfg.goal
    (keeping the marker's configured height when cfg.goal is 2D)."""
    world = Simulation(
        cfg=cfg.isaacgym,
        actors=cfg.actors,
        init_positions=cfg.initial_actor_positions,
        num_envs=1,
        device=device,
    )
    if getattr(cfg, "goal", None) is not None and "goal" in [s_.name for s_ in world.built.specs]:
        gp = world.get_actor_position_by_name("goal")[0].cpu().numpy().astype(np.float64)
        g = np.asarray(cfg.goal, dtype=np.float64).reshape(-1)
        gp[: len(g)] = g[:3]
        world.set_actor_position_by_name("goal", gp)
    return world


def run_steps(world: Simulation, act: Callable, n: int, dt: float,
              success_fn=None, observer=None, verbose=False, real_time=False) -> LoopMetrics:
    """One episode of up to n control steps from the world's current state:
    each step the action `act(world.state)` (an in-process planner, or the
    planner process over RPC), then one world step. solver_time holds each
    step's `act`; fps and rt_factor come from the step's own time, before
    the real-time sleep."""
    device = world.device
    metrics = LoopMetrics()
    prev_pos = None
    for step in range(n):
        with span("loop.step"):
            t0 = time.perf_counter()
            action = act(world.state)
            _sync(device)
            t1 = time.perf_counter()
            world.apply_robot_cmd(action)
            world.step()
            with span("loop.readback"):
                rp = world.state.root_pos[0, 0].cpu().numpy()
            t2 = time.perf_counter()

            metrics.solver_time.append(t1 - t0)
            actual = t2 - t0
            metrics.fps.append(1.0 / max(actual, 1e-9))
            metrics.rt_factor.append(dt / max(actual, 1e-9))
            metrics.steps = metrics.commands = step + 1
            if prev_pos is not None:
                metrics.path_length += float(np.linalg.norm(rp - prev_pos))
            prev_pos = rp

            if observer is not None:
                observer(step, world, action)
            if verbose:
                print(
                    f"step {step}: FPS {metrics.fps[-1]:8.1f}  RT {metrics.rt_factor[-1]:6.2f}  "
                    f"solver {metrics.solver_time[-1]*1e3:7.2f} ms"
                )
            if success_fn is not None and metrics.success_step is None and success_fn(world):
                metrics.success_step = step
                break
        if real_time and actual < dt:
            time.sleep(dt - actual)
    metrics.final_state_finite = bool(all(torch.isfinite(t).all() for t in world.state.tensors()))
    return metrics


def run_task(
    cfg: ExampleConfig,
    objective,
    prior=None,
    n_steps: Optional[int] = None,
    real_time: bool = False,
    success_fn: Optional[Callable] = None,
    observer: Optional[Callable] = None,
    verbose: bool = False,
    randomize: bool = True,
    device="cuda",
    device_steps: int = 1,
    chunk_observer: Optional[Callable] = None,
    use_fused: Optional[bool] = None,
    recorder: Optional["CommandRecorder"] = None,
) -> LoopMetrics:
    """success_fn(world: Simulation) -> bool; observer(step, world, action);
    prior: a tape or closed-loop prior for the planner, use_fused: its
    rollout (MPPIisaacPlanner). real_time: sleep out each control period.
    device: "cuda" (the kernels; the default) or "cpu" (their plain
    versions).

    device_steps > 1 runs up to that many control steps per host round trip
    (`DeviceChunk`), as the JAX package's chunked loop; success stays exact,
    replayed on the fetched post-step states. chunk_observer(step, world,
    action) sees each of them (`world` pinned to that step's state, on the
    host). A per-step observer, real-time pacing or a `recorder` (one
    episode, under `cfg.mppi.seed_val`) takes the per-step loop, as in the
    JAX package."""
    device = torch.device(device)
    world = goal_world(cfg, device)
    planner = MPPIisaacPlanner(cfg, objective, prior, randomize=randomize, device=device,
                               use_fused=use_fused)
    n = n_steps if n_steps is not None else cfg.n_steps
    if device_steps > 1 and observer is None and not real_time and recorder is None:
        return _run_chunked(DeviceChunk(world, planner, device_steps), n, cfg.isaacgym.dt,
                            success_fn=success_fn, verbose=verbose,
                            chunk_observer=chunk_observer)
    act = planner.compute_action_from_state
    if recorder is not None:
        act, observer = recorder.episode(int(cfg.mppi.seed_val), planner, observer)
    m = run_steps(world, act, n, cfg.isaacgym.dt, success_fn=success_fn, observer=observer,
                  verbose=verbose, real_time=real_time)
    if recorder is not None:
        recorder.end(m)
    return m


def run_task_episodes(
    cfg: ExampleConfig,
    objective,
    seeds,
    prior=None,
    n_steps: Optional[int] = None,
    success_fn: Optional[Callable] = None,
    device_steps: int = 16,
    randomize: bool = True,
    verbose: bool = False,
    device="cuda",
    use_fused: Optional[bool] = None,
    start: Optional[Callable] = None,
    recorder: Optional["CommandRecorder"] = None,
) -> Dict[int, LoopMetrics]:
    """Seeded episodes on one build: the world, the planner (with their
    FusedRollout and FusedWorldStep) and, for device_steps > 1, the chunk
    (its CUDA graph) are built once; each seed then runs a fresh episode
    from the initial world state (goal marker placed), which
    `start(seed, world)` may then change through the world's setters, with
    the solver carry re-keyed by
    `prng.prng_key(seed)` (JAX's `PRNGKey(seed)`). device_steps=1 or a
    `recorder` runs the per-step loop. → {seed: LoopMetrics}."""
    device = torch.device(device)
    world = goal_world(cfg, device)
    initial = world.state
    planner = MPPIisaacPlanner(cfg, objective, prior, randomize=randomize, device=device,
                               use_fused=use_fused)
    per_step = device_steps <= 1 or recorder is not None
    chunk = None if per_step else DeviceChunk(world, planner, device_steps)
    n = n_steps if n_steps is not None else cfg.n_steps
    results = {}
    for seed in seeds:
        world.state = initial
        if start is not None:
            start(seed, world)
        planner.mppi.carry = dataclasses.replace(planner.mppi.init_carry(),
                                                 key=prng.prng_key(int(seed)))
        if chunk is None:
            act, observer = planner.compute_action_from_state, None
            if recorder is not None:
                act, observer = recorder.episode(int(seed), planner)
            results[seed] = run_steps(world, act, n, cfg.isaacgym.dt, success_fn=success_fn,
                                      observer=observer)
            if recorder is not None:
                recorder.end(results[seed])
        else:
            results[seed] = _run_chunked(chunk, n, cfg.isaacgym.dt, success_fn=success_fn)
        if verbose:
            print(f"seed {seed}: {results[seed].summary()}", flush=True)
    return results


def _counts():
    return (FusedRollout.launches, FusedWorldStep.launches, MPPIPlanner.tape_injections)


def _add_counts(d, times=1):
    FusedRollout.launches += d[0] * times
    FusedWorldStep.launches += d[1] * times
    MPPIPlanner.tape_injections += d[2] * times


class DeviceChunk:
    """Up to N control steps (plan → command map → world step) per host
    round trip, on one build of the world and the planner.

    Static buffers hold the solver carry (U, λ, Σ, t0), the 1-env world
    state as one flat float32 buffer of X values, the chunk's N noise
    draws, a step slot and the (N, X + nu) output: each step's post-step
    world state in the flat buffer's layout, then its action. `_view` alone
    knows that layout; it turns a flat buffer, or rows of them, into a
    SimState of views. One step reads the buffers, writes its row into the
    output at the slot, copies the row's state back into the flat buffer
    in one copy, and its results into the carry.

    On CUDA the step is captured once as a CUDA graph and replayed: the
    first step of the first chunk runs on a side stream as the capture's
    warm-up (it builds the kernels' library, copies their tables and sets
    their launch attributes, all of which a capture refuses), and every
    later step is a replay. A capture or replay that fails raises; there is
    no eager fallback. On CPU tensors (the caller asked for the CPU) the
    same step runs eagerly.

    The step is the planner's, fused or unfused: the unfused rollout's
    thousands of small launches (the engine's substeps over the horizon) are
    captured into the same one graph.

    A replay makes no Python call, so the kernels' launch counters and the
    solver's tape injections are raised by the counts the capture recorded,
    once per replay. The tables of `update_weights` and `update_objective`
    are written in place and seen by the graph; a changed solver config, and
    for the unfused rollout a changed objective or weights (its cost reads
    them as constants), are captured anew; a new solver or FusedRollout (a
    structural `update_mppi_params`, `add_to_env`) makes `run` raise.

    The noise draws depend only on the carry's key and the solver's config,
    so `run` draws the next chunk's (`min(N, n_steps - k)` commands) while
    this chunk's replays run, before its fetch, and the next `run` uses them
    when its carry's key, its count and the config are the ones they were
    drawn for; otherwise (a new episode's key, a carry set by the caller, a
    changed config) it draws them itself. The copy into the draw buffer
    stays in the next run's load, after this run's fetch has synchronised.
    `draws_ahead_hits` and `draws_ahead_misses` count the runs of each.

    While spans record, and the solver rolls out with K1 on the card, the
    `chunk.fetch` span carries the Ψ columns that the chunk's replays solved
    and held (`psi_solved`, `psi_held`: `FusedRollout.psi_columns` read
    before the replays and after the fetch's wait); nothing is read
    otherwise."""

    def __init__(self, world, planner: MPPIisaacPlanner, device_steps: int):
        if int(device_steps) < 1:
            raise ValueError(f"device_steps must be ≥ 1, got {device_steps}")
        if world.device != planner.device:
            raise ValueError(f"world on {world.device}, planner on {planner.device}")
        self.world, self.planner = world, planner
        self.n = int(device_steps)
        self.device = world.device
        self._mppi, self._fused = planner.mppi, planner.mppi.fused
        self._stepper = world._world_step
        self._layout, X = [], 0            # (field, offset, size, shape) in the flat state
        for f in SIM_STATE_FIELDS:
            t = getattr(world.state, f)
            if t is not None:
                self._layout.append((f, X, t.numel(), tuple(t.shape)))
                X += t.numel()
        dev = self.device
        self._flat = torch.empty(X, dtype=torch.float32, device=dev)
        self._state = self._view(self._flat)
        c = self._mppi.carry
        self._U, self._lam = torch.empty_like(c.U), torch.empty_like(c.lambda_)
        self._sigma, self._t0 = torch.empty_like(c.sigma), torch.empty_like(c.t0)
        _, d = self._mppi.draws(c.key, 1)
        self._draws = torch.empty((self.n,) + d.shape[1:], dtype=torch.float32, device=dev)
        self._slot = torch.zeros(1, dtype=torch.long, device=dev)
        self._out = torch.empty(self.n, X + planner.mppi.nu, dtype=torch.float32, device=dev)
        self._graph = None
        self._signature = None
        self._delta = (0, 0, 0)
        self._info = None
        self.captures = 0
        self.nodes = None           # the captured step's graph nodes by type, and the tape's
        self._ahead = None          # ((count, config, key), key after, draws) drawn ahead
        self.draws_ahead_hits = self.draws_ahead_misses = 0

    # ------------------------------------------------------------------
    def _view(self, buf: torch.Tensor) -> SimState:
        """A flat state buffer (X,), or rows (k, X) of them (trailing values
        past X, such as an output row's action, are ignored) → the SimState
        of its views, with the leading k axis when given."""
        lead = tuple(buf.shape[:-1])
        return SimState(**{f: buf[..., o: o + n].view(lead + sh)
                           for f, o, n, sh in self._layout})

    def _step(self):
        """One control step on the static buffers (captured on CUDA)."""
        planner, world = self.planner, self.world
        carry = MppiCarry(U=self._U, lambda_=self._lam, sigma=self._sigma, t0=self._t0)
        draw = self._draws.index_select(0, self._slot)[0]
        action, new, info = planner._full(carry, self._state, draw=draw)
        # the first command of the action, as `apply_robot_cmd` takes it
        state = world.stepped(world.commanded(self._state, action[0].expand(1, -1)))
        row = torch.cat([t.reshape(-1) for t in state.tensors()]
                        + [action[0].reshape(-1).to(torch.float32)])
        self._out.index_copy_(0, self._slot, row[None])
        self._slot += 1
        self._flat.copy_(row[: self._flat.numel()])
        self._U.copy_(new.U)
        self._lam.copy_(new.lambda_)
        self._sigma.copy_(new.sigma)
        self._t0.copy_(new.t0)
        return info

    def _capture(self):
        """The warm-up step on a side stream (a real step of the run), then
        the capture of the step."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        take_tape_nodes()                  # what earlier captures counted
        with paused(), torch.cuda.graph(graph):
            self._info = self._step()
        after = _counts()
        self._delta = tuple(a - b for a, b in zip(after, before))
        _add_counts(self._delta, -1)       # the capture itself launched nothing
        self.nodes = dict(graph_nodes(graph.raw_cuda_graph()), tape=take_tape_nodes())
        graph.instantiate()
        self._graph = graph
        self.captures += 1
        return warm

    # ------------------------------------------------------------------
    def run(self, n_steps: int):
        """Up to min(N, n_steps) control steps from `world.state` and the
        solver's carry, and the draws of the next min(N, n_steps - k) made
        ahead. Leaves the carry and `world.state` at the last step run. →
        (post-step SimStates on the host, actions (k, nu) numpy)."""
        planner, world, mppi = self.planner, self.world, self.planner.mppi
        if mppi is not self._mppi or mppi.fused is not self._fused \
                or world._world_step is not self._stepper:
            raise RuntimeError("the planner or the world was rebuilt (a structural "
                               "update_mppi_params or add_to_env) after this chunk was built: "
                               "build a new DeviceChunk")
        k = min(self.n, int(n_steps))
        cfg_sig = repr(mppi.cfg)
        ahead, self._ahead = self._ahead, None
        hit = ahead is not None and ahead[0] == (k, cfg_sig, mppi.carry.key.tobytes())
        with span("chunk.draws", ahead=int(hit)):
            key, draws = ahead[1:] if hit else mppi.draws(mppi.carry.key, k)
        if hit:
            self.draws_ahead_hits += 1
        else:
            self.draws_ahead_misses += 1
        start = world.state
        with span("chunk.load"):
            torch.cat([t.reshape(-1) for t in start.tensors()], out=self._flat)
            c = mppi.carry
            self._U.copy_(c.U)
            self._lam.copy_(c.lambda_)
            self._sigma.copy_(c.sigma)
            self._t0.copy_(c.t0)
            self._draws[:k].copy_(torch.from_numpy(draws))
            self._slot.zero_()
        if self.device.type == "cuda":
            sig = cfg_sig
            if mppi.fused is None:
                obj = planner.objective
                sig += f"|{id(obj)}|{getattr(obj, 'weights', None)!r}"
            todo, info = k, self._info
            if self._graph is None or sig != self._signature:
                with span("chunk.capture"):
                    info = self._capture()
                self._signature = sig
                todo -= 1
            with span("chunk.replay") as sp:
                psi0 = FusedRollout.psi_columns() \
                    if sp is not None and isinstance(mppi.fused, FusedRollout) else None
                for _ in range(todo):
                    self._graph.replay()
            _add_counts(self._delta, todo)
            if todo:
                info = self._info          # the graph's outputs, from the last replay
        else:
            psi0 = None
            with span("chunk.replay"):     # the same steps, run eagerly
                for _ in range(k):
                    info = self._step()
        nxt = min(self.n, int(n_steps) - k)
        if nxt:
            with span("chunk.ahead"):      # the next chunk's draws, while the replays run
                self._ahead = ((nxt, cfg_sig, key.tobytes()), *mppi.draws(key, nxt))
        with span("chunk.fetch") as sp:
            packed = self._out[:k].to("cpu", copy=True).numpy()      # the one fetch
            if psi0 is not None and sp is not None:                   # the chunk's Ψ columns
                solved, held = FusedRollout.psi_columns()
                sp.set(psi_solved=solved - psi0[0], psi_held=held - psi0[1])
        with span("chunk.store"):
            mppi.carry = MppiCarry(U=self._U.clone(), lambda_=self._lam.clone(),
                                   sigma=self._sigma.clone(), t0=self._t0.clone(), key=key)
            world.state = self._view(self._flat.clone())
            mppi.last_info = {n: v.clone() for n, v in info.items()}
            planner._last_vis = mppi.last_info.get("vis")
        with span("chunk.unpack"):
            states = [self._view(row) for row in torch.from_numpy(packed)]
            actions = packed[:, self._flat.numel():]
        # the rollout sim as the last command left it: K-wide, the state the
        # command planned from, still in the output on the device
        with span("chunk.rebroadcast"):
            last_from = start if k == 1 else self._view(self._out[k - 2].clone())
            planner.reset_rollout_from_state(last_from)
        return states, actions


def _run_chunked(chunk: DeviceChunk, n: int, dt: float, success_fn=None, verbose=False,
                 chunk_observer=None) -> LoopMetrics:
    """One episode of up to n control steps through `chunk`, from the
    world's state and the solver's carry: once per chunk, `objective.reset()`,
    the chunk, one fetch, then per step the metrics (each step's time is the
    chunk's over its steps), `chunk_observer` and `success_fn` on the
    fetched state; at a success the world is rewound to that step's state."""
    world, planner = chunk.world, chunk.planner
    metrics = LoopMetrics()
    step = 0
    prev_pos = None
    while step < n:
        with span("loop.chunk", steps=min(chunk.n, n - step)):
            t0 = time.perf_counter()
            planner.objective.reset()
            states, actions = chunk.run(n - step)
            t1 = time.perf_counter()
            k = len(states)
            metrics.commands += k
            per = (t1 - t0) / k
            with span("loop.observe"):
                for i in range(k):
                    metrics.solver_time.append(per)
                    metrics.fps.append(1.0 / max(per, 1e-9))
                    metrics.rt_factor.append(dt / max(per, 1e-9))
                    metrics.steps = step + 1
                    rp = states[i].root_pos[0, 0].numpy()
                    if prev_pos is not None:
                        metrics.path_length += float(np.linalg.norm(rp - prev_pos))
                    prev_pos = rp
                    if chunk_observer is not None:
                        chunk_observer(step, _StateProxy(world, states[i]), actions[i])
                    if success_fn is not None and metrics.success_step is None \
                            and success_fn(_StateProxy(world, states[i])):
                        metrics.success_step = step
                        # rewind the live world to the success step
                        world.state = states[i].map(lambda x: x.to(world.device))
                        break
                    step += 1
        if verbose:
            print(f"chunk @{metrics.steps}: {per * 1e3:7.2f} ms/step  RT {dt / max(per, 1e-9):6.2f}")
        if metrics.success_step is not None:
            break
    metrics.graph_nodes = chunk.nodes
    metrics.final_state_finite = bool(all(torch.isfinite(t).all() for t in world.state.tensors()))
    return metrics


class _StateProxy:
    """Simulation look-alike pinned to one fetched state (the success replay
    and the chunk observer): the world's getters and views read `state`."""

    def __init__(self, world, state):
        self._world = world
        self.state = state
        self.built = world.built

    def __getattr__(self, name):
        attr = getattr(type(self._world), name, None)
        if isinstance(attr, property):
            return attr.fget(self)
        if callable(attr):
            return attr.__get__(self)
        return getattr(self._world, name)


RECORD_EVERY = 50      # CommandRecorder: every this many steps of an episode
RECORD_LAST = 10       # ... and the last this many of an episode without success


def _host_state(state: SimState) -> Dict[str, np.ndarray]:
    return {f: getattr(state, f).detach().cpu().numpy() for f in SIM_STATE_FIELDS
            if getattr(state, f) is not None}


class CommandRecorder:
    """Records the control steps of per-step episodes, so that a command and
    a world step can be replayed elsewhere from exactly their inputs (on the
    CPU against the JAX package: `scripts/jackal_commands_jax.py`).

    Every step keeps the 1-env world state after its world step (the
    episode's trajectory). The steps an episode keeps in full are every
    RECORD_EVERY-th and, when it ends without success, its last RECORD_LAST:
    for each, the world state before the step, the solver carry before the
    command (U, λ, Σ, key, t0), what the command gave (the per-sample costs
    S (K,), the rollout's costs (K, H), the new carry's U, the action) and
    the world state after the world step. `save(path)` writes one .npz."""

    def __init__(self, every: int = RECORD_EVERY, last: int = RECORD_LAST):
        self.every, self.last = int(every), int(last)
        self.records: List[dict] = []
        self.episodes: List[tuple] = []        # (seed, success step or −1, steps run)
        self.trajectories: List[dict] = []     # per episode: {field: (steps, 1, ...)}
        self.meta: dict = {}
        self._cur = None

    def episode(self, seed: int, planner: MPPIisaacPlanner, observer: Optional[Callable] = None):
        """→ (act, observer) of run_steps for one episode of `seed`."""
        if not self.meta:
            pm = planner._params_K
            self.meta = {"params.body_mass_scale": pm.body_mass_scale.cpu().numpy(),
                         "params.geom_friction": pm.geom_friction.cpu().numpy(),
                         "params_seed": int(planner.cfg.mppi.seed_val),
                         "K": int(planner.cfg.mppi.num_samples),
                         "H": int(planner.cfg.mppi.horizon),
                         "device": (torch.cuda.get_device_name(planner.device)
                                    if planner.device.type == "cuda" else "cpu")}
        steps: List[dict] = []
        self._cur = (int(seed), steps)

        def act(state):
            c = planner.mppi.carry
            rec = {"before": _host_state(state), "carry.U": c.U.cpu().numpy(),
                   "carry.lambda": np.float32(c.lambda_.item()),
                   "carry.sigma": c.sigma.cpu().numpy(),
                   "carry.key": np.array(c.key, np.uint32), "carry.t0": int(c.t0)}
            action = planner.compute_action_from_state(state)
            info = planner.mppi.last_info
            rec.update({"card.S": info["costs"].cpu().numpy(),
                        "card.costs": info["rollout_costs"].cpu().numpy(),
                        "card.U": planner.mppi.carry.U.cpu().numpy(),
                        "card.action": action.reshape(-1).cpu().numpy()})
            steps.append(rec)
            return action

        def observe(step, world, action):
            steps[-1]["after"] = _host_state(world.state)
            if observer is not None:
                observer(step, world, action)

        return act, observe

    def end(self, metrics: LoopMetrics):
        """Close the episode that `episode` opened, with its metrics."""
        seed, steps = self._cur
        n, ok = len(steps), metrics.success_step
        keep = set(range(0, n, self.every))
        if ok is None:
            keep |= set(range(max(0, n - self.last), n))
        for i in sorted(keep):
            self.records.append(dict(steps[i], seed=seed, step=i, stalled=ok is None))
        self.episodes.append((seed, -1 if ok is None else int(ok), n))
        self.trajectories.append({f: np.stack([s["after"][f] for s in steps])
                                  for f in steps[0]["after"]})
        self._cur = None

    def arrays(self) -> Dict[str, np.ndarray]:
        """The records as arrays, one row per recorded step: `seed`, `step`,
        `stalled`, `before.<field>` and `after.<field>` (1-env SimState
        fields), `carry.*`, `card.*`; then `params.*` (the rollout's
        per-sample ModelParams) with `params_seed`, `K`, `H`, `device`;
        `episodes` (seed, success step or −1, steps run) and each episode's
        post-step states `traj<e>.<field>`."""
        r = self.records
        out = {"seed": np.array([x["seed"] for x in r], np.int64),
               "step": np.array([x["step"] for x in r], np.int64),
               "stalled": np.array([x["stalled"] for x in r], bool)}
        for side in ("before", "after"):
            for f in r[0][side]:
                out[f"{side}.{f}"] = np.stack([x[side][f] for x in r])
        for k in r[0]:
            if k.startswith(("carry.", "card.")):
                out[k] = np.stack([np.asarray(x[k]) for x in r])
        out.update({k: np.asarray(v) for k, v in self.meta.items()})
        out["episodes"] = np.array(self.episodes, np.int64)
        for e, tr in enumerate(self.trajectories):
            out.update({f"traj{e}.{f}": v for f, v in tr.items()})
        return out

    def save(self, path: str):
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(path, **self.arrays())
