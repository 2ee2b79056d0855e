"""The command as the benchmark's check runs it. Without a card, or without
the program beside it, it prints no result and exits non-zero; on a card
(marked ``cuda``: it skips elsewhere) a short run of the smallest cell is
correct and names the card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from harness_helpers import BENCH, ROOT

CMD = [sys.executable, "benchmark/run.py", "--workload",
       "flagship_radial.b1024_h20", "--seed", str(2 ** 31 + 7), "--seconds",
       "10", "--trace", "0"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(CMD, cwd=ROOT, capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    proc = subprocess.run(CMD, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, proc.stderr[-3000:]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    assert set(line["metrics"]) == {"alive_solves_per_s", "step_ms_p90",
                                    "setup_s"}
    assert list(line)[-1] == "checks"
