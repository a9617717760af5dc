"""The system under test: the port's closed control loop, driven for a cell.

`Program` builds what `runtime/loop.run_task_episodes` builds (the 1-env
world with its goal placed, the planner with its FusedRollout and the world's
FusedWorldStep, and for the chunked loop one `DeviceChunk`) once, from the
cell's configuration file. `episode(seed)` then runs one fixed-length
episode from the goal-placed initial state with the solver's carry keyed by
`seed`, through the entry the traffic names:

* "per_step": `runtime/loop.run_steps` with `planner.compute_action_from_state`;
* "chunked":  `runtime/loop._run_chunked` over the `DeviceChunk` (no
  success test, so every episode has the same length).

Around those calls, and never inside the program, the benchmark keeps its
own clocks (each per-step control step from the state it planned from to
the world stepped, host-synced; each command, ended by a synchronise) and
copies, at the steps the seed chose (`plan`), what the judge compares: the
world state and the solver's carry before the step, and the rollout's
costs, the new nominal U, the action and the world state after it. A chunk
is judged at its first step: the copies of its costs and U are made on the
device right after that step's graph replay (on the CPU: its eager step).
At the steps in `keep` it copies the same, for the kernels' bounds of a
traced run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time
from typing import Dict, List, Optional

import torch


def state_fields(state) -> Dict[str, torch.Tensor]:
    """A SimState's tensors by field name."""
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if getattr(state, f.name) is not None}


def _copy_state(state) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in state_fields(state).items()}


def _copy_carry(carry) -> dict:
    return {"U": carry.U.clone(), "lambda_": carry.lambda_.clone(), "sigma": carry.sigma.clone(),
            "t0": carry.t0.clone(), "key": carry.key.copy()}


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The port's loop for one cell. config: the configuration file, whose
    "conf" is the task configuration, "objective" the port's "module:Class"
    with `objective_kwargs`, and "prior", where there is one, the port's
    "module:function" that makes the planner's prior from the task
    configuration, as the task's own `run` passes it to `run_task`;
    traffic: the cell's traffic file."""

    def __init__(self, config: dict, traffic: dict, device: torch.device):
        from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
        from mppiisaac_tpu_torch.runtime.loop import DeviceChunk, goal_world
        from mppiisaac_tpu_torch.utils.config_store import config_from_dict

        self.device = device
        self.traffic = traffic
        self.cfg = cfg = config_from_dict(config["conf"])
        mod, cls = config["objective"].split(":")
        self.objective = getattr(importlib.import_module(mod), cls)(
            cfg, **config.get("objective_kwargs", {}))
        self.world = goal_world(cfg, device)
        self.initial = self.world.state
        prior = None
        if "prior" in config:
            mod, fn = config["prior"].split(":")
            prior = getattr(importlib.import_module(mod), fn)(cfg)
        self.planner = MPPIisaacPlanner(cfg, self.objective, prior, device=device)
        self.chunked = traffic["loop"] == "chunked"
        self.steps = int(traffic["episode_steps"])
        self.dt = cfg.isaacgym.dt
        self.chunk = DeviceChunk(self.world, self.planner, int(traffic["device_steps"])) \
            if self.chunked else None
        # the benchmark's clocks and copies
        self.step_s: List[float] = []          # per-step loop: each control step
        self.command_s: List[float] = []       # per-step loop: each command
        self.records: List[dict] = []
        self.plan: set = set()                 # steps of this episode to judge
        self.keep: set = set()                 # steps of this episode to keep for the bounds
        self.episode_index = -1
        self._i = 0
        self._rec: Optional[dict] = None
        self._armed: Optional[dict] = None
        self._t0 = 0.0
        self.span = lambda name: contextlib.nullcontext()
        if self.chunked:
            self._wrap_chunk()

    def enable_spans(self):
        """The benchmark's spans (`cellbench.<name>`) around the command, the
        world step and the chunk, for a traced run."""
        from torch.profiler import record_function

        self.span = lambda name: record_function(f"cellbench.{name}")
        for owner, name in ((self.world, "step"), (self.chunk, "run")):
            if owner is None:
                continue
            fn = getattr(owner, name)

            def spanned(*a, _fn=fn, _name=name, **k):
                with self.span(_name):
                    return _fn(*a, **k)

            setattr(owner, name, spanned)

    # ------------------------------------------------------------------
    def reset(self, seed: int):
        """The goal-placed initial state and a carry keyed by `seed`."""
        from mppiisaac_tpu_torch.mppi import prng

        mppi = self.planner.mppi
        self.world.state = self.initial
        mppi.carry = dataclasses.replace(mppi.init_carry(), key=prng.prng_key(int(seed)))
        self._i = 0

    def start(self) -> dict:
        """The world state and the carry an episode starts from (copies)."""
        return {"state": _copy_state(self.world.state),
                "carry": _copy_carry(self.planner.mppi.carry)}

    def episode(self, seed: int, plan=(), keep=()):
        """One episode of `episode_steps` control steps; copies the steps in
        `plan` and `keep` (chunk starts for the chunked loop)."""
        from mppiisaac_tpu_torch.runtime.loop import _run_chunked, run_steps

        self.episode_index += 1
        self.plan = set(int(p) for p in plan)
        self.keep = set(int(k) for k in keep)
        self.reset(seed)
        if self.chunked:
            _run_chunked(self.chunk, self.steps, self.dt)
        else:
            run_steps(self.world, self._act, self.steps, self.dt, observer=self._observe)

    def warm(self):
        """Three control steps through the cell's entry: they build and load
        the kernels, and the chunked loop captures its graph and replays it."""
        self.reset(0)
        if self.chunked:
            self.chunk.run(3)           # the capture's eager step, then two replays
            if self.device.type == "cuda":
                self._hook_replay()
        else:
            for _ in range(3):
                self.world.apply_robot_cmd(self._act(self.world.state))
                self.world.step()
        _sync(self.device)
        self.step_s.clear()
        self.command_s.clear()
        self.reset(0)

    def _record(self, state) -> Optional[dict]:
        """A record of this step if it is judged or kept: the world state
        and the carry before it."""
        judged, kept = self._i in self.plan, self._i in self.keep
        if not (judged or kept):
            return None
        return {"episode": self.episode_index, "step": self._i, "judged": judged, "kept": kept,
                "before": _copy_state(state), "carry": _copy_carry(self.planner.mppi.carry)}

    # ------------------------------------------------------------------
    # per-step loop
    def _act(self, state):
        mppi = self.planner.mppi
        self._t0 = t0 = time.perf_counter()
        rec = self._record(state)
        with self.span("command"):
            action = self.planner.compute_action_from_state(state)
            _sync(self.device)
        self.command_s.append(time.perf_counter() - t0)
        if rec is not None:
            rec.update(costs=mppi.last_info["rollout_costs"].clone(), U=mppi.carry.U.clone(),
                       action=action.detach().reshape(-1).clone())
        self._rec = rec
        return action

    def _observe(self, step, world, action):
        self.step_s.append(time.perf_counter() - self._t0)
        if self._rec is not None:
            self._rec["after"] = _copy_state(world.state)
            self.records.append(self._rec)
            self._rec = None
        self._i += 1

    # ------------------------------------------------------------------
    # chunked loop
    def _wrap_chunk(self):
        chunk = self.chunk
        run = chunk.run

        def counted_run(n_steps):
            rec = self._armed = self._record(self.world.state)
            states, actions = run(n_steps)
            self._armed = None
            if rec is not None:
                rec["after"] = state_fields(states[0])
                rec["action"] = torch.from_numpy(actions[0].copy())
                self.records.append(rec)
            self._i += len(states)
            return states, actions

        chunk.run = counted_run
        if self.device.type != "cuda":
            step = chunk._step

            def copied_step():
                info = step()
                self._copy_first(info)
                return info

            chunk._step = copied_step

    def _hook_replay(self):
        """On CUDA, once the graph is captured: copy the costs and U of a
        judged chunk's first replay."""
        graph = self.chunk._graph
        replay = graph.replay

        def copied_replay():
            replay()
            self._copy_first(self.chunk._info)

        graph.replay = copied_replay

    def _copy_first(self, info):
        rec = self._armed
        if rec is not None:
            rec["costs"] = info["rollout_costs"].clone()
            rec["U"] = self.chunk._U.clone()
            self._armed = None

    def free(self):
        """Drop the program's state and its device memory."""
        for name in ("chunk", "planner", "world", "initial", "objective"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
