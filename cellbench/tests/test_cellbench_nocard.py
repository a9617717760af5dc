"""The driver's command exits with another code than 0, and prints no
result, without a card and in a checkout without the program."""
import os
import shutil
import subprocess
import sys

from cellbench.spec import ROOT

ARGS = ["-m", "cellbench.run", "--workload", "panda_reach.per_step", "--seed", "7",
        "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable] + ARGS, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "cellbench"), tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable] + ARGS + ["--rehearse"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "mppiisaac_tpu_torch" in out.stderr
