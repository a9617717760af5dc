"""The program's spans over one traced run of a benchmark cell.

    python scripts/span_report.py --workload panda_reach.per_step --seed 5 --seconds 10 \
        [--out spans.json]

Runs `cellbench.run` with `--trace 1` in this process (on the card; with
`--rehearse`, a CPU rehearsal at tiny sizes, which records no span), then
reads the spans the profiled episode recorded (`utils/profiling.spans`)
and prints one JSON line: the run's own result line, and per span name its
count, total and self time in ms (self: the duration less the time its
child spans cover), largest self time first, with the number of roots and
of dropped records. `--out` also writes it to a file.
"""
import argparse
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def self_times(records):
    """{name: {"count", "total_ms", "self_ms"}}, largest self time first."""
    child_ns = [0] * len(records)
    for r in records:
        if r.parent >= 0:
            child_ns[r.parent] += r.end_ns - r.start_ns
    out = {}
    for r, c in zip(records, child_ns):
        d = out.setdefault(r.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        d["count"] += 1
        d["total_ms"] += (r.end_ns - r.start_ns) / 1e6
        d["self_ms"] += (r.end_ns - r.start_ns - c) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["self_ms"]))


def main(argv=None):
    p = argparse.ArgumentParser(prog="python scripts/span_report.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--out")
    a = p.parse_args(argv)

    from cellbench import run
    from mppiisaac_tpu_torch.utils import profiling

    args = ["--workload", a.workload, "--seed", str(a.seed), "--seconds", str(a.seconds),
            "--trace", "1"] + (["--rehearse"] if a.rehearse else [])
    out = io.StringIO()
    rc = run.run(run.parse(args), out=out)
    if rc != 0:
        return rc
    records = profiling.spans()
    report = {"workload": a.workload, "seed": a.seed,
              "result": json.loads(out.getvalue().strip().splitlines()[-1]),
              "roots": sum(r.parent < 0 for r in records), "records": len(records),
              "dropped": profiling.dropped, "spans": self_times(records)}
    line = json.dumps(report)
    print(line, flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
