"""Success over seeds: the port's twin of the JAX package's
`scripts/validate.py`.

    python -m mppiisaac_tpu_torch.validate <subcommand> [args] [key=value ...]

Subcommands:
  pick [fast|world] [n_seeds]    panda_pick episodes, seeds 0 .. n_seeds−1
                                 (default world, 5), each capped at 1500
                                 steps; success ‖block − goal‖ < 0.2 m
  omni [fast|world] [n_seeds]    the same for omni_panda_pick
  anymal [n_seeds] [tape|none]   anymal within the conf's steps, with its
                                 gait tape prior or without (default 3, tape)
  jackal [n_seeds]               multi_jackal within the conf's 200 steps;
                                 with perturb=M, then M more episodes of
                                 each seed whose jackals start moved by
                                 ±PERTURB_M in x, y and z (signs drawn from
                                 the seed and the move)
  suite                          one episode of every other task, each at its
                                 conf's seed; a task that raises is recorded
                                 with its error and counted as a failure, the
                                 others still run, and the suite then raises
  one <task> [key=value ...]     one episode of any task at its conf's seed
                                 (a module of tasks/, or panda, panda_effort,
                                 boxer_reach, boxer_push, heijn_reach,
                                 heijn_push, multi_pointbot, multi_jackal)
Options: device=cuda|cpu (default cuda), n_steps=N (cap each episode),
device_steps=N (control steps per host round trip, default 16 as in the JAX
package's sweeps; 1 runs the per-step loop), use_fused=true|false|none (the
planner's rollout, default none: its own choice), results=PATH (default
chiprun_out/validate_torch.json at the repo root), seeds=S,S,... (the
episodes' seeds instead of 0 .. n_seeds−1), record=PATH (run per step and
write the steps of `runtime/loop.CommandRecorder` to PATH as one .npz:
every 50th step's command and world step with their inputs, the last 10
of an episode without success, every step's world state); any other
key=value is a config override (e.g. mppi.num_samples=16).

Every episode of a sweep runs on one build (`runtime/loop.run_task_episodes`:
the carry keyed by `PRNGKey(seed)`, as the JAX package's). Each subcommand
prints one JSON line per episode and a summary, and adds the summary to the
results file under its key, with device_steps and the card's name and power
limit.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .tasks.common import fused_opt
from .utils.profiling import card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PICK_STEPS = 1500
PERTURB_M = 1e-6        # jackal perturb=M: one float32 rounding's order at a 1 m position


def _summ(results):
    ok = [s for s, m in results.items() if m.success_step is not None]
    return {
        "episodes": len(results),
        "successes": len(ok),
        "success_seeds": ok,
        "success_steps": {s: m.success_step for s, m in results.items()},
        "median_ms_per_step": float(np.median(
            [t for m in results.values() for t in m.solver_time] or [0.0])) * 1e3,
        "median_control_ms": float(np.median(
            [1e3 / f for m in results.values() for f in m.fps] or [0.0])),
        "all_finite": all(m.final_state_finite for m in results.values()),
    }


def _card(device) -> dict:
    if torch.device(device).type != "cuda":
        return {"device": "cpu"}
    c = card()
    return {"device": c["device"], "nvidia_smi": c["power_limit"]}


def _record(path, key, summary):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    doc = {}
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
    doc[key] = summary
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"RECORDED {key} -> {path}", flush=True)


def _seeds(opts, n_seeds):
    if opts["seeds"] is not None:
        return [int(x) for x in str(opts["seeds"]).split(",") if x != ""]
    return list(range(int(n_seeds)))


def _recorder(opts):
    from .runtime.loop import CommandRecorder

    return CommandRecorder() if opts["record"] else None


def _save(opts, recorder):
    if recorder is not None:
        recorder.save(opts["record"])
        print(f"RECORDED {len(recorder.records)} steps of {len(recorder.episodes)} episodes "
              f"-> {opts['record']}", flush=True)


def _episodes(key, cfg, obj, seeds, opts, prior=None, success_fn=None, n_steps=None,
              start=None, recorder=None, **extra):
    from .runtime.loop import run_task_episodes

    if opts["n_steps"] is not None:
        n_steps = int(opts["n_steps"])
    t0 = time.perf_counter()
    ds = 1 if recorder is not None else int(opts["device_steps"])
    results = run_task_episodes(cfg, obj, seeds, prior=prior, n_steps=n_steps,
                                success_fn=success_fn, device=opts["device"], device_steps=ds,
                                use_fused=fused_opt(opts["use_fused"]), start=start,
                                recorder=recorder)
    for s, m in results.items():
        print(json.dumps({"key": key, "seed": s, **m.summary(),
                          "finite": m.final_state_finite}), flush=True)
    summ = {**_summ(results), **extra, "device_steps": ds, "use_fused": opts["use_fused"],
            "wall_s": time.perf_counter() - t0, **_card(opts["device"])}
    print("SUMMARY " + json.dumps(summ), flush=True)
    print(f"SUCCESS {summ['successes']}/{summ['episodes']}", flush=True)
    _record(opts["results"], key, summ)
    return summ


def _fidelity(arg):
    if arg not in ("fast", "world"):
        raise SystemExit(f"fidelity must be 'fast' or 'world', got {arg!r}")
    return arg


def pick(opts, overrides, fidelity="world", n_seeds=5, task="panda_pick"):
    from .utils.config_store import load_config

    if task == "panda_pick":
        from .tasks.panda_pick import PandaPickObjective as Obj, success_fn
    else:
        from .tasks.omni_panda_pick import OmniPandaPickObjective as Obj, success_fn
    cfg = load_config(f"tasks/{task}", [f"mppi.rollout_fidelity={_fidelity(fidelity)}"] + overrides)
    rec = _recorder(opts)
    out = _episodes(f"{task}:{fidelity}", cfg, Obj(cfg), _seeds(opts, n_seeds), opts,
                    success_fn=success_fn(), n_steps=PICK_STEPS, recorder=rec, task=task,
                    fidelity=fidelity, overrides=overrides)
    _save(opts, rec)
    return out


def anymal(opts, overrides, n_seeds=3, prior_mode="tape"):
    from .tasks.anymal import AnymalObjective, gait_prior, success_fn
    from .utils.config_store import load_config

    if prior_mode not in ("tape", "none"):
        raise SystemExit(f"anymal prior must be 'tape' or 'none', got {prior_mode!r}")
    over = (["mppi.use_priors=false"] if prior_mode == "none" else []) + overrides
    cfg = load_config("tasks/anymal", over)
    rec = _recorder(opts)
    out = _episodes(f"anymal:{prior_mode}", cfg, AnymalObjective(cfg), _seeds(opts, n_seeds),
                    opts, prior=gait_prior(cfg), success_fn=success_fn(), recorder=rec,
                    task="anymal", prior_mode=prior_mode, overrides=overrides)
    _save(opts, rec)
    return out


def moved_start(move, metres):
    """`run_task_episodes`' start: each jackal's root moved by ±metres in
    x, y and z, the signs drawn from (seed, move)."""
    from .tasks.multi_robot import MultiJackalObjective

    def start(seed, world):
        idx = MultiJackalObjective.robot_actor_indices(world.scene)
        signs = np.random.default_rng([int(seed), int(move)]).choice([-1.0, 1.0], (len(idx), 3))
        rs = world.root_state.clone()
        rs[0, idx, :3] += torch.as_tensor(signs * metres, dtype=rs.dtype, device=rs.device)
        world.set_root_state(rs)

    return start


def jackal(opts, overrides, n_seeds=5):
    """multi_jackal over seeds; with perturb=M, the spread of success
    steps under M moves of the jackals' start per seed."""
    from .tasks.multi_robot import MultiJackalObjective, success_fn
    from .utils.config_store import load_config

    cfg = load_config("tasks/multi_jackal", overrides)
    obj = MultiJackalObjective(cfg)
    seeds, succ = _seeds(opts, n_seeds), success_fn("multi_jackal", obj)
    rec = _recorder(opts)
    out = _episodes("multi_jackal", cfg, obj, seeds, opts, success_fn=succ, recorder=rec,
                    task="multi_jackal", overrides=overrides)
    _save(opts, rec)
    moves, metres = int(opts["perturb"]), PERTURB_M
    if moves:
        spread = {s: {"unmoved": out["success_steps"][s]} for s in seeds}
        for move in range(1, moves + 1):
            m = _episodes(f"multi_jackal:move{move}", cfg, obj, seeds, opts, success_fn=succ,
                          start=moved_start(move, metres), task="multi_jackal", move=move,
                          metres=metres, overrides=overrides)
            for s in seeds:
                spread[s][f"move{move}"] = m["success_steps"][s]
        summ = {"spread": spread, "metres": metres, "moves": moves, "seeds": seeds,
                "n_steps": opts["n_steps"], "device_steps": int(opts["device_steps"]),
                **_card(opts["device"])}
        print("SPREAD " + json.dumps(summ), flush=True)
        _record(opts["results"], "multi_jackal:spread", summ)
    return out


def suite_plan():
    """The suite's tasks: (name, run function, its keywords)."""
    from .tasks import (albert, mobile_push, mobile_reach, multi_robot, panda_reach,
                        panda_stick_push, point_robot)

    return [
        ("point_robot", point_robot.run, {}),
        ("multi_pointbot", multi_robot.run, {}),
        ("panda", panda_reach.run, {}),
        ("heijn_reach", mobile_reach.run, {"robot": "heijn"}),
        ("heijn_push", mobile_push.run, {"robot": "heijn"}),
        ("boxer_reach", mobile_reach.run, {"robot": "boxer"}),
        ("boxer_push", mobile_push.run, {"robot": "boxer"}),
        # the JAX suite's caps: the stick push's conf runs 10000 steps with
        # no success bar, the effort reach creeps under its velocity penalty
        ("panda_stick_push", panda_stick_push.run, {"n_steps": 1500}),
        ("albert", albert.run, {}),
        ("panda_effort", panda_reach.run, {"task": "panda_effort", "n_steps": 500}),
        ("multi_jackal", multi_robot.run, {"task": "multi_jackal"}),
    ]


def _episode(fn, opts, overrides, **kw):
    """One episode of a task's run function → its summary entry."""
    if opts["n_steps"] is not None:
        kw["n_steps"] = int(opts["n_steps"])
    t0 = time.perf_counter()
    m = fn(overrides=list(overrides) or None, device=opts["device"],
           device_steps=int(opts["device_steps"]), use_fused=fused_opt(opts["use_fused"]), **kw)
    return {"success_step": m.success_step, "steps": m.steps, "finite": m.final_state_finite,
            "median_control_ms": float(np.median([1e3 / f for f in m.fps])),
            "wall_s": time.perf_counter() - t0}


def suite(opts, overrides):
    """One episode of every task the other subcommands leave out. A task
    that raises is recorded with its error and counted as a failure; the
    others run on, and the suite raises once the results are recorded."""
    out = {}
    for name, fn, kw in suite_plan():
        try:
            out[name] = _episode(fn, opts, overrides, **kw)
        except Exception as e:  # noqa: BLE001 — recorded, counted, raised below
            out[name] = {"error": repr(e)[:300]}
        print(f"TASK {name}: {json.dumps(out[name])}", flush=True)
    n_ok = sum(1 for v in out.values() if v.get("success_step") is not None)
    print("SUMMARY " + json.dumps(out), flush=True)
    print(f"SUCCESS {n_ok}/{len(out)}", flush=True)
    _record(opts["results"], "suite", {**out, "device_steps": int(opts["device_steps"]),
                                       **_card(opts["device"])})
    failed = [name for name, v in out.items() if "error" in v]
    if failed:
        raise RuntimeError(f"suite: {len(failed)} of {len(out)} tasks raised: {failed}")
    return out


# task names of `one` that are not a module of tasks/: (module, keywords)
ONE_ALIASES = {
    "panda": ("panda_reach", {}),
    "panda_effort": ("panda_reach", {"task": "panda_effort"}),
    "boxer_reach": ("mobile_reach", {"robot": "boxer"}),
    "heijn_reach": ("mobile_reach", {"robot": "heijn"}),
    "boxer_push": ("mobile_push", {"robot": "boxer"}),
    "heijn_push": ("mobile_push", {"robot": "heijn"}),
    "multi_pointbot": ("multi_robot", {"task": "multi_pointbot"}),
    "multi_jackal": ("multi_robot", {"task": "multi_jackal"}),
}


def one(opts, overrides, task=None):
    """One episode of any task with CLI-style overrides (the JAX
    validator's `one`)."""
    import importlib

    if task is None:
        raise SystemExit("usage: python -m mppiisaac_tpu_torch.validate one <task> [key=value ...]")
    modname, kw = ONE_ALIASES.get(task, (task, {}))
    mod = importlib.import_module(f"{__package__}.tasks.{modname}")
    rec = _recorder(opts)
    if rec is not None:
        kw["recorder"] = rec
    out = {"task": task, "overrides": list(overrides), **_episode(mod.run, opts, overrides, **kw),
           "device_steps": int(opts["device_steps"]), "use_fused": opts["use_fused"],
           **_card(opts["device"])}
    _save(opts, rec)
    print("ONE " + json.dumps(out), flush=True)
    _record(opts["results"], f"one:{task}" + (":" + ",".join(overrides) if overrides else ""), out)
    return out


SUBCOMMANDS = {
    "pick": pick,
    "omni": lambda opts, over, *a: pick(opts, over, *a, task="omni_panda_pick"),
    "anymal": anymal,
    "jackal": jackal,
    "suite": suite,
    "one": one,
}


def main(argv=None, device="cuda"):
    from .tasks.common import split_cli

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in SUBCOMMANDS:
        raise SystemExit(f"usage: python -m mppiisaac_tpu_torch.validate "
                         f"{{{'|'.join(SUBCOMMANDS)}}} [args] [key=value ...]")
    sub, rest = argv[0], argv[1:]
    positional = [a for a in rest if "=" not in a]
    overrides, opts = split_cli(
        [a for a in rest if "=" in a],
        {"device": device, "n_steps": None, "device_steps": 16, "use_fused": None,
         "results": os.path.join(REPO, "chiprun_out", "validate_torch.json"), "seeds": None,
         "record": None, "perturb": 0})
    return SUBCOMMANDS[sub](opts, overrides, *positional)


if __name__ == "__main__":
    main()
