"""Start and stop a planner example process (`python -m
mppiisaac_tpu_torch.examples.<task>.planner ...`), for the two-process runs
of `chip_smoke.py` and `tests/test_torch_rpc.py`."""
from __future__ import annotations

import queue
import subprocess
import sys
import threading
import time
from typing import Optional


def launch_planner(module: str, args, timeout: float = 600.0, cwd=None, env=None):
    """Start `python -m <module> args` (a planner example; in `cwd` with
    `env`) and wait for its serving line. → (the process, its endpoint). The
    caller stops it (`stop_planner`); a process that exits or stays silent
    raises."""
    proc = subprocess.Popen([sys.executable, "-m", module, *args], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue[Optional[str]]" = queue.Queue()
    log = []

    def pump():
        for line in proc.stdout:
            log.append(line)
            lines.put(line)
        lines.put(None)

    proc.pump = threading.Thread(target=pump, daemon=True)
    proc.pump.start()
    proc.log = log
    deadline = time.monotonic() + timeout
    while True:
        try:
            line = lines.get(timeout=max(deadline - time.monotonic(), 0.0))
        except queue.Empty:
            stop_planner(proc)
            raise TimeoutError(f"{module} did not serve within {timeout} s:\n{''.join(log)}")
        if line is None:
            stop_planner(proc)
            raise RuntimeError(f"{module} exited (rc {proc.returncode}):\n{''.join(log)}")
        if line.startswith("planner serving on "):
            return proc, line.split("planner serving on ", 1)[1].strip()


def stop_planner(proc):
    """Stop a planner process started by launch_planner, wait for it and
    for the last of its output (in `proc.log`). → its exit code."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    proc.pump.join(timeout=10)
    return proc.returncode
