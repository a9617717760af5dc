"""The readings the limits of `limits/<cell>.json` are set from.

    python3 -m cellbench.control --workload <name> --seeds 1,2,... --control-seeds 1,2,3
        [--look 1] [--out chiprun_out/control_<name>.json]

On the card, at the cell's own sizes and through its timed path: one
episode per seed, as a run's window runs it, with `checked_steps` steps
judged. Then, with the program's state freed:

* the lower readings: each seed's numbers of the port against the
  reference (`judge.py`), as a run computes them;
* the upper readings: the control, the reference with every value that
  crosses a stage kept in bfloat16 (`Reference(store=torch.bfloat16)`), put
  in the port's place at the same steps of the first `--control-seeds`;
* beside each seed's numbers, the quantiles of the per-sample gaps they
  are taken from;
* `--look`: at the judged steps of the first `--look` seeds, the same
  gaps and the command of the float32 reference against the float64 one,
  and each step's largest pose difference after K2: how far float32
  rounding alone moves each number.

Prints one JSON object and writes it to `--out`. The benchmark's own runs
do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import judge
from .loop import Program
from .reference import kernels
from .reference.controller import state_from
from .run import candidates
from .spec import load_cell


def episode_records(prog, seed: int, m: int, cands):
    """One episode of the port from `seed` with `m` steps copied → (its
    start, its records on the host)."""
    rng = np.random.default_rng(seed)
    plan = rng.choice(cands, size=min(m, len(cands)), replace=False)
    prog.records = []
    prog.reset(seed)
    start = judge.to_host(prog.start())
    prog.episode(seed, plan)
    return start, judge.to_host(prog.records)


def control_records(ctl, records):
    """The control in the port's place at the port's steps: its K1 costs
    over the whole horizon, its command from them, and its world step under
    its own action."""
    steps = judge.steps_of(ctl, records)
    with torch.no_grad():
        costs, eps = ctl.costs(steps)
        out = []
        for s, e, c, r in zip(steps, eps, costs, records):
            action, U, _ = ctl.update(s["carry"], e, c)
            out.append(dict(r, costs=c, action=action, U=U))
        rows = ctl.world_steps([s["state"] for s in steps], [o["action"] for o in out])
    for i, o in enumerate(out):
        o["after_rows"] = rows[:, i]
        o.pop("after", None)
    return out


def control_start(ctl, seed: int):
    c = ctl.initial_carry(seed)
    return {"state": {k: v for k, v in vars(ctl.initial_world).items() if v is not None},
            "carry": {"U": c.U, "lambda_": c.lambda_, "sigma": c.sigma, "t0": c.t0,
                      "key": c.key}}


QS = (0.5, 0.75, 0.9, 0.95, 0.99)


def quantiles(g: torch.Tensor):
    g = g.double().cpu()
    return {q: float(torch.quantile(g, q)) for q in QS} | {"max": float(g.max())}


def spread(records, expected):
    """The quantiles of the per-sample gaps behind cost_gap and
    horizon_cost_gap."""
    first, horizon = [], []
    for r, e in zip(records, expected):
        c_p = r["costs"].to(e["costs"].device, torch.float32)
        first.append(judge.relative(c_p[:, 0], e["costs"][:, 0]))
        horizon.append(judge.relative(c_p.sum(1), e["costs"].sum(1)))
    return {"first": quantiles(torch.cat(first)), "horizon": quantiles(torch.cat(horizon))}


def look(ref, records):
    """The float32 reference against the float64 one at the same steps: each
    sample's gap in K1's first-step cost and in its cost summed over the
    horizon, the command worked out from each one's costs (over the control
    range: command_own_gap's reading under rounding alone), and each step's
    largest pose difference after K2."""
    steps = judge.steps_of(ref, records)
    with torch.no_grad():
        c32, eps = ref.costs(steps)
        packed = [ref.k1_inputs(s["state"], s["carry"]) for s in steps]
        rows, V, mass, fric = (torch.cat([p[i] for p in packed], -1).double() for i in range(4))
        c64, _ = ref.rollout.run(rows, V, mass, fric)
        # K2 under the port's actions, float32 and float64
        states = [s["state"] for s in steps]
        rows = torch.cat([ref.world_step.rows(s) for s in states], 1)
        tgt = torch.cat([ref.world_built.cmd_map.apply(r["action"].reshape(1, -1).to(ref.device),
                                                       s.q) for s, r in zip(states, records)])
        w32 = ref.world_step.step_rows(rows, tgt)
        ks = ref.world_step.ks
        ones = [torch.ones(rows.shape[1], n, dtype=torch.float64, device=ref.device)
                for n in (ks.nbody, ks.ngeom)]
        w64 = kernels.world_step_plain(ks, rows.double(), tgt.double(), *ones,
                                       ref.world_step.substeps, ref.world_step.dt_sub,
                                       ref.world_step.impulse_sweeps)
        K, ur, command = ref.K, judge.u_range(ref), [0.0]
        for i, (s, e, c) in enumerate(zip(steps, eps, c32)):
            a32, U32, _ = ref.update(s["carry"], e, c)
            a64, U64, _ = ref.update(s["carry"], e, c64[i * K:(i + 1) * K].float())
            command.append(max(float((a32 - a64).abs().max()),
                               float((U32 - U64).abs().max())) / ur)
    poses = judge.pose_rows(ks).to(ref.device)
    c32 = torch.cat(c32).double()
    return {"first": quantiles(judge.relative(c64[:, 0], c32[:, 0])),
            "horizon": quantiles(judge.relative(c64.sum(1), c32.sum(1))),
            "command": max(command),
            "pose": (w32[poses].double() - w64[poses]).abs().amax(0).tolist(),
            "steps": [int(r["step"]) for r in records]}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m cellbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--look", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    if not torch.cuda.is_available():
        print("cellbench.control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    m, cands = int(cell.config["checked_steps"]), candidates(cell.traffic)
    t0 = time.perf_counter()
    prog = Program(cell.config, cell.traffic, device)
    prog.warm()
    runs = {s: episode_records(prog, s, m, cands) for s in seeds + [c for c in cseeds
                                                                    if c not in seeds]}
    prog.free()
    del prog
    t_prog = time.perf_counter() - t0

    result = {"workload": cell.name, "card": torch.cuda.get_device_name(device),
              "program_s": t_prog, "program": {}, "control": {}}
    with judge.float32_products():
        ref = judge.reference(cell.config, device)
        ur = judge.u_range(ref)
        for s in seeds:
            start, recs = runs[s]
            t = time.perf_counter()
            v = {"start_gap": judge.start_gap(ref, start, s)}
            expected = judge.outputs(ref, recs)
            v.update(judge.numbers(ref, recs, expected, ur, per_step=True))
            v["judge_s"] = time.perf_counter() - t
            v.update(spread(recs, expected))
            v["steps"] = [int(r["step"]) for r in recs]
            result["program"][s] = v
            print(json.dumps({"program": s, **v}), flush=True)
        if cseeds:
            ctl = judge.reference(cell.config, device, store=torch.bfloat16)
            for s in cseeds:
                _, recs = runs[s]
                t = time.perf_counter()
                crecs = control_records(ctl, recs)
                v = {"start_gap": judge.start_gap(ref, control_start(ctl, s), s)}
                expected = judge.outputs(ref, crecs)
                v.update(judge.numbers(ref, crecs, expected, ur, per_step=True))
                v["control_s"] = time.perf_counter() - t
                v.update(spread(crecs, expected))
                result["control"][s] = v
                print(json.dumps({"control": s, **v}), flush=True)
        result["look"] = {}
        for s in seeds[:args.look]:
            t = time.perf_counter()
            result["look"][s] = look(ref, runs[s][1])
            result["look"][s]["look_s"] = time.perf_counter() - t
            print(json.dumps({"look": s, **result["look"][s]}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
