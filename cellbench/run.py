"""One run of one cell of the port's benchmark.

    python3 -m cellbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (`mppiisaac_tpu_torch`), on a
machine with as many CUDA cards as the cell asks for. The run builds the
world, the planner and (chunked) the chunk once, runs three warm control
steps, then fixed-length closed-loop episodes back to back: the traffic's
episodes, in an order drawn from the seed, in whole rounds until
`--seconds` have passed. It then compares steps of the first round, drawn
from the seed, with the plain reference under `cellbench/reference/`
(`judge.py`), and prints one JSON line last on standard output:

* `--trace 0`: the cell's end-to-end metrics (`BENCHMARK.json`);
* `--trace 1`: its per-layer metrics, read by `metrics/<name>.py` from the
  profile of one episode of the window's first round: always the same
  episode, the traffic's first.

`--rehearse` (tests only) runs the same code on the CPU at tiny sizes and
writes no device metric. Without it a run that finds too few cards exits
with 2 and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mppiisaac_tpu")
# the traced run counts the kernels' operations and bytes at these shares of
# the profiled episode (at pick: approach, grasp, carry), rounded down to a
# chunk's first step
BOUNDED_AT = (0.16, 0.64, 0.88)
# --rehearse: the sizes of a CPU rehearsal
REHEARSAL = {"num_samples": 8, "horizon": 2, "episode_steps": 4, "device_steps": 2,
             "checked_steps": 2}


def forbidden_modules():
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m cellbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def power_limit():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else None


def shrink(cell):
    """The rehearsal's sizes in the cell's configuration and traffic."""
    m = cell.config["conf"]["mppi"]
    m["num_samples"], m["horizon"] = REHEARSAL["num_samples"], REHEARSAL["horizon"]
    cell.config["checked_steps"] = REHEARSAL["checked_steps"]
    cell.traffic["episode_steps"] = REHEARSAL["episode_steps"]
    if "device_steps" in cell.traffic:
        cell.traffic["device_steps"] = REHEARSAL["device_steps"]


def bounded_steps(traffic):
    """The steps of the profiled episode whose kernels' bounds are counted."""
    n, d = int(traffic["episode_steps"]), int(traffic.get("device_steps", 1))
    return sorted({int(f * n) // d * d for f in BOUNDED_AT})


def candidates(traffic):
    """The steps of an episode that can be judged: every step, or the first
    of each chunk."""
    n = int(traffic["episode_steps"])
    return list(range(0, n, int(traffic.get("device_steps", 1))))


def run(args, out=sys.stdout, err=sys.stderr):
    import numpy as np
    import torch

    from . import judge
    from .loop import Program
    from .spec import load_cell

    cell = load_cell(args.workload)
    # one host thread: the host's cores are shared, and idle worker threads
    # that spin take them from the loop
    torch.set_num_threads(1)
    if args.rehearse:
        shrink(cell)
        device = torch.device("cpu")
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < cell.chips:
            print(f"cellbench: the cell {cell.name} needs {cell.chips} CUDA card(s), found {n}",
                  file=err)
            return 2
        device = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    m = int(cell.config["checked_steps"])
    cands = candidates(cell.traffic)

    prog = Program(cell.config, cell.traffic, device)
    prog.warm()
    setup_s = time.perf_counter() - T0
    captures = prog.chunk.captures if prog.chunked else 0

    # the window: rounds of the traffic's episodes, each round in an order
    # drawn from the seed, until --seconds have passed at the end of a round;
    # the judged steps, drawn from the seed, lie in the first round, `m`
    # spread over its episodes
    pool = [int(e) for e in cell.traffic["episodes"]]
    P = len(pool)
    plans = [rng.choice(cands, size=min(m // P + (j < m % P), len(cands)), replace=False)
             for j in range(P)]
    seeds, tr, traced_index = [], None, None
    t0 = time.perf_counter()
    while not seeds or time.perf_counter() - t0 < args.seconds:
        for seed in (pool[i] for i in rng.permutation(P)):
            plan = plans[len(seeds)] if len(seeds) < P else ()
            if not seeds:
                prog.reset(seed)
                start = prog.start()
            if args.trace and len(seeds) < P and seed == pool[0]:
                from .profiling import traced

                prog.enable_spans()
                before = len(prog.command_s)
                with traced(device) as tr:
                    prog.episode(seed, plan, keep=bounded_steps(cell.traffic))
                traced_index, traced_spans = prog.episode_index, prog.command_s[before:]
            else:
                prog.episode(seed, plan)
            seeds.append(seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    steps = len(seeds) * prog.steps
    if prog.chunked and prog.chunk.captures != captures:
        print("cellbench: the chunk captured its graph again inside the window", file=err)
        return 4
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    records = judge.to_host(prog.records)
    start = judge.to_host(start)
    ctx = {"graph_nodes": prog.chunk.nodes if prog.chunked else None,
           "spans": {"command": traced_spans} if tr is not None and not prog.chunked else {},
           "trace": tr}
    step_s, nodes = list(prog.step_s), ctx["graph_nodes"]
    prog.free()
    del prog

    # the comparison, on the run's device, after the program's state is freed
    t_judge = time.perf_counter()
    judged = [r for r in records if r["judged"]]
    with judge.float32_products():
        ref = judge.reference(cell.config, device)
        values = {"start_gap": judge.start_gap(ref, start, seeds[0])}
        expected = judge.outputs(ref, judged)
        values.update(judge.numbers(ref, judged, expected, judge.u_range(ref)))
        if tr is not None:
            ctx["bounds"] = bounds(ref, [r for r in records if r["kept"]
                                         and r["episode"] == traced_index], tr)
    correct, rows = judge.verdict(values, cell.limits)
    judge_s = time.perf_counter() - t_judge

    metrics = {}
    if args.trace:
        for metric in cell.per_layer:
            v = cell.reader(metric)(ctx)
            if v is not None:
                metrics[metric.name] = {"value": float(v), "unit": metric.unit}
    else:
        # an end-to-end metric is the quantity its name holds before the first
        # "." (`step_ms.host_bound` is the step_ms of the cells it names)
        e2e = {"setup_s": setup_s, "step_ms": 1e3 * window_s / steps}
        if step_s:
            e2e["step_p95_ms"] = 1e3 * float(np.quantile(np.asarray(step_s), 0.95))
        for metric in cell.end_to_end:
            v = e2e.get(metric.name.split(".")[0])
            if v is not None:
                metrics[metric.name] = {"value": float(v), "unit": metric.unit}
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell.chips, "memory_peak_bytes": int(memory_peak),
               "power_limit": power_limit()}
    else:
        dev = {"platform": "cpu", "kind": "rehearsal", "count": 0, "memory_peak_bytes": 0}
    traced_on_card = tr is not None and device.type == "cuda"
    if traced_on_card:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    result = {"correct": bool(correct), "attempted": steps,
              "failed": 0 if correct else len(judged), "metrics": metrics, "device": dev}
    if traced_on_card:
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    result["window"] = {"seconds": window_s, "episodes": len(seeds), "steps": steps,
                        "graph_nodes": nodes, "judge_s": judge_s, "judged": len(judged)}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    # last, once everything the run imports is loaded: the judge, the
    # reference, its count and the metric readers
    found = forbidden_modules()
    if found:
        print(f"cellbench: the run loaded {', '.join(found)}", file=err)
        return 3
    print(f"cellbench: {dev['kind']}, power limit {dev.get('power_limit')}", file=err)
    for n, v, lim in rows:
        print(f"check {n} {v!r} limit {lim!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def bounds(ref, records, tr):
    """(least s, measured s) of K1 and K2 at the profiled episode's kept
    steps (`bounded_steps`): each step's launch is the step's place in the
    episode."""
    import torch

    from .judge import _carry
    from .reference import count
    from .reference.controller import state_from

    k1, k2 = tr.kernel("fused_rollout_kernel"), tr.kernel("fused_world_step_kernel")
    out = {"k1": [], "k2": []}
    with torch.no_grad():
        for r in records:
            i = int(r["step"])
            state = state_from(r["before"], ref.device)
            carry = _carry(ref, r["carry"])
            if i < len(k1):
                rows, V, mass, fric = ref.k1_inputs(state, carry)
                out["k1"].append((count.k1_bound(ref.rollout, rows, V, mass, fric)[0], k1[i]))
            if i < len(k2):
                rows = ref.world_step.rows(state)
                tgt = ref.world_built.cmd_map.apply(r["action"].reshape(1, -1).to(ref.device),
                                                    state.q)
                out["k2"].append((count.k2_bound(ref.world_step, rows, tgt)[0], k2[i]))
    return out


def main(argv=None):
    args = parse(sys.argv[1:] if argv is None else argv)
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
