"""How often `chip_smoke.profiled_device_ms` misses launches on its first try,
with and without the pauses that keep the read launches away from the ends of
the profiler's window, on one NVIDIA GPU.

    python3 tools/torch_profiler_check.py [--n 100]

Measures the `point_sums` kernel at the main path's shape `--n` times without
the pauses, `--n` times with them and `--n` times without again, and prints
for each round how many measurements needed 1, 2 or 3 tries, how many failed
after three, and the least, median and largest `device_ms`.  A kernel of ~2 us
launched 20 times is the hardest case the smoke run has: the whole burst is
shorter than the distance the tracer's two clocks can be apart.
"""

import argparse
import pathlib
import sys
import time
import types

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402  (the clock under test and its inputs)
from multi_orb_slam_tpu_torch.ops import kernels  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100, help="measurements per round")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profiler_check: no CUDA device", file=sys.stderr)
        return 1
    V, inv = chip_smoke.point_sums_inputs(np.random.RandomState(0), 48, 1024, 2048, 4,
                                          torch.device("cuda", 0))

    def call():
        kernels.point_sums(V, inv)

    call()
    torch.cuda.synchronize()
    pauses = []
    clock = chip_smoke.time
    try:
        for label, sleep in (("no pause", pauses.append),
                             ("pause", lambda s: (pauses.append(s), time.sleep(s))),
                             ("no pause", pauses.append)):
            # `profiled_device_ms` sleeps twice a try: count its calls
            chip_smoke.time = types.SimpleNamespace(sleep=sleep, perf_counter=time.perf_counter)
            tries, failed, vals = [], 0, []
            for _ in range(args.n):
                pauses.clear()
                try:
                    vals.append(chip_smoke.profiled_device_ms(call, "point_sums_kernel"))
                except AssertionError:
                    failed += 1
                tries.append(len(pauses) // 2)
            vals.sort()
            print(f"{label}: tries per measurement {{tries: measurements}} "
                  f"{ {k: tries.count(k) for k in sorted(set(tries))} }, failed {failed}, "
                  f"device_ms least {vals[0]:.5f} median {vals[len(vals) // 2]:.5f} "
                  f"largest {vals[-1]:.5f}")
    finally:
        chip_smoke.time = clock
    return 0


if __name__ == "__main__":
    sys.exit(main())
