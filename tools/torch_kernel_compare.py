"""Compare two builds of the port's `window_match`, `fast_score` and
`point_sums` CUDA kernels on one NVIDIA GPU, inside one process, in turns.

    python3 tools/torch_kernel_compare.py --old-csrc DIR [--out REPORT.json]

Builds, each a library of its own:
- `old`: the `*.cu` files of another tree, `--old-csrc DIR` (an earlier
  commit unpacked with `git archive`), which must export the same C entry
  points;
- `new`: the package's `csrc/*.cu`.

Both builds are first held to the plain PyTorch versions (bit-equal) on the
inputs of `chip_smoke.py`: `fast_score` at [16, 480, 640] with the pyramid's
extents, `window_match` at C = 2, Q = 2048, F = 1024 and at the dense shape
of `match_frame_kf_brute` (Q = F = 1024, every gate open), `point_sums` at
the three shapes of its phase there.  Then they are
timed in turns old, new, new, old, with no wrapper in the way: the C entry
point is called directly, and `device_ms` is the kernel's own mean duration
from `torch.profiler` over 20 launches.  The report gives every turn, the
compiler's register / shared-memory / spill lines of each build, and the
card's name and power limit.
"""

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the inputs and the clocks)
from multi_orb_slam_tpu_torch.ops import _build, kernels  # noqa: E402


def launchers(lib, canvas, extents, wm_cases, ps_cases):
    """{case: (call, kernel symbol, out tensor)} of direct C calls into `lib`."""
    B, H, W = canvas.shape
    hs = (ctypes.c_int * B)(*[e[0] for e in extents])
    ws = (ctypes.c_int * B)(*[e[1] for e in extents])
    fs_out = torch.empty_like(canvas)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: cudaError {err}")

    def fast():
        check(lib.fast_score_launch(canvas.data_ptr(), ctypes.addressof(hs), ctypes.addressof(ws),
                                    fs_out.data_ptr(), B, H, W, stream()), "fast_score")

    out = {"fast_score": (fast, "fast_score_kernel", fs_out)}
    for label, a in wm_cases.items():
        Cq, Q = a[1].shape
        F = a[7].shape[1]
        wm_out = torch.empty((4, Cq, Q), dtype=torch.int32, device=canvas.device)
        ptrs = [t.data_ptr() for t in a]
        stride = 0 if a[5].shape[0] == 1 else Q * 8

        def match(ptrs=ptrs, stride=stride, wm_out=wm_out, Cq=Cq, Q=Q, F=F):
            check(lib.window_match_launch(*ptrs[:6], stride, *ptrs[6:], wm_out.data_ptr(),
                                          Cq, Q, F, stream()), "window_match")

        out[label] = (match, "window_match_kernel", wm_out)
    for label, (V, inv) in ps_cases.items():
        LC, F, D = V.shape
        P = inv.shape[1]
        # one tensor for both outputs, so that one comparison holds both
        ps_out = torch.empty(((LC + 1) * P * D,), dtype=V.dtype, device=V.device)

        def sums(V=V, inv=inv, ps_out=ps_out, LC=LC, F=F, P=P, D=D):
            check(lib.point_sums_launch(V.data_ptr(), inv.data_ptr(), ps_out.data_ptr(),
                                        ps_out[P * D:].data_ptr(), LC, F, P, D, stream()),
                  "point_sums")

        out[label] = (sums, "point_sums_kernel", ps_out)
    return out


def ptxas_lines(log):
    """The compiler's lines on the compared kernels:
    which entry, its spills, its registers and shared memory."""
    out, entry = [], None
    for ln in (x.strip() for x in log.splitlines()):
        if "Compiling entry" in ln:
            names = [n for n in ("window_match", "fast_score", "point_sums") if n in ln]
            entry = f"{names[0]} ...{ln.split(chr(39))[1][-28:]}" if names else None
        elif entry and ("bytes spill" in ln or "Used" in ln):
            out.append(f"{entry}: {ln.replace('ptxas info    : ', '')}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", type=pathlib.Path, required=True)
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the report there as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_compare: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}   torch {torch.__version__}  cuda {torch.version.cuda}")

    builds = {"old": sorted(args.old_csrc.glob("*.cu")), "new": _build.sources()}
    libs, ptxas = {}, {}
    for name, srcs in builds.items():
        path = _build.build_library(srcs)
        libs[name] = _build.bind(path)
        ptxas[name] = ptxas_lines(_build.build_log_of(path))
        print(f"build {name}: {path.name}")

    rng = np.random.RandomState(0)
    canvas, extents = chip_smoke.fast_score_inputs(dev, rng)
    wm_args, wm_dense = chip_smoke.window_match_inputs(dev, rng)
    wm_cases = {"window_match": wm_args, "window_match dense": wm_dense}
    ps_cases = {f"point_sums {shape}": chip_smoke.point_sums_inputs(rng, *shape, dev)
                for shape in chip_smoke.POINT_SUMS_SHAPES[:3]}
    want = {"fast_score": kernels.fast_score_plain(canvas, extents)}
    for label, a in wm_cases.items():
        want[label] = torch.stack(kernels.window_match_plain(*a))
    for label, a in ps_cases.items():
        want[label] = torch.cat([t.reshape(-1) for t in kernels.point_sums_plain(*a)])
    calls = {name: launchers(lib, canvas, extents, wm_cases, ps_cases)
             for name, lib in libs.items()}
    for name, cases in calls.items():
        for label, (call, _, out) in cases.items():
            out.fill_(-7)
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want[label]):
                raise AssertionError(f"build {name}: {label} differs from its plain version")
    print("both builds equal the plain versions")

    order = list(calls) + list(reversed(calls))
    rows = []
    for turn, name in enumerate(order):
        for label, (call, symbol, _) in calls[name].items():
            for _ in range(3):
                call()
            row = {"turn": turn, "build": name, "case": label,
                   "device_ms": chip_smoke.profiled_device_ms(call, symbol)}
            rows.append(row)
            print(f"turn {turn} {name:4s} {label:34s} device {row['device_ms']:.5f} ms")
    for name, lines in ptxas.items():
        print(f"ptxas, build {name}:")
        for ln in lines:
            print(f"  {ln}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "torch": torch.__version__, "rows": rows,
                                        "ptxas": ptxas}, indent=1))
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
