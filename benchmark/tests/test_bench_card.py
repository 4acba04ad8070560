"""On the card only (skipped where there is none): a short run of the
orbit cell is correct, its traced run carries `breakdown` and the device's
busy and window seconds, and the TF32 control (the program's matmuls in
TF32, below the float32 the configuration states) is not correct.  Each
run is a process of its own: CUDA graphs captured under one matmul setting
would be replayed under the other.

    python3 -m pytest benchmark/tests/test_bench_card.py -q
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
CELL = "dual-astra.orbit-track"
SMALL = {"device": "cuda", "frames": 60, "warm_frames": 60, "window_frames": 50}


def line(*extra, trace=0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    argv = ["--workload", CELL, "--seed", "2147483999", "--seconds", "1", "--trace", str(trace),
            *extra]
    code = (f"import sys; sys.path.insert(0, {str(BENCH)!r}); import run; "
            f"sys.exit(run.main({argv!r}, test={SMALL!r}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().split("\n")[-1])


@pytest.mark.cuda
def test_short_traced_run_on_the_card():
    r = line(trace=1)
    assert r["correct"], r["checks"]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert {"device_ops", "idle_gaps"} == set(r["breakdown"])


@pytest.mark.cuda
def test_tf32_control_is_not_correct():
    r = line("--control", "tf32")
    assert not r["correct"], r["checks"]
