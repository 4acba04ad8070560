"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. Device and build: torch / CUDA versions, the card's name and power limit
   (nvidia-smi), and the build of every CUDA kernel of the port from
   `multi_orb_slam_tpu_torch/csrc/`.
2. Kernel vs plain, one phase per kernel, on random inputs at the shapes
   the main path gives it (640x480, 2 cameras, 8 levels, 1024 features per
   camera): `fast_score` and `gather_patches` must be bit-equal to their
   plain PyTorch versions; `window_match` must give equal distances, equal
   indices wherever the best is unique, and the expected hand-made tie rows.
   Kernel and plain version are timed with CUDA events after a warm-up.
3. Main path: the bench's orbit scene (60 frames, 4000 textured squares,
   640x480, the dual ~90-degree rig) through
   `Tracker(calib, cfg, pipelined=True, pipeline_depth=3)` with the default
   `SlamConfig` and no mapping callback.  Every kernel's launch count is set
   to 0 just before and read just after; the run fails unless 60/60 frames
   track, ATE < 0.02 m, no pose is NaN and every kernel launched.
4. A JSON line of per-kernel results, then the last line
   `{"ok": true, "device": {...}}`.

Without a CUDA device the script exits 1 before printing any result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

H, W, C = 480, 640, 2
N_FRAMES = 60
ATE_LIMIT_M = 0.02
REF = "multi_orb_slam_tpu/ops/pallas_kernels.py"
KERNELS = {
    "fast_score": ("multi_orb_slam_tpu_torch/csrc/fast_score.cu", f"{REF}:87"),
    "gather_patches": ("multi_orb_slam_tpu_torch/csrc/gather_patches.cu", f"{REF}:376"),
    "window_match": ("multi_orb_slam_tpu_torch/csrc/window_match.cu", f"{REF}:228"),
}


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device milliseconds per call, by CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_device():
    from multi_orb_slam_tpu_torch.ops import _build

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(f"nvidia-smi: {smi.stdout.strip()}")
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s")
    log = _build.build_log()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line \
                or "build seconds" in line:
            print(f"  ptxas: {line.strip()}")


def phase_fast_score(dev, rng):
    from multi_orb_slam_tpu_torch.ops import kernels, orb

    cfg = orb.ORBConfig(n_features=1024)
    shapes = orb.pyramid_shapes(H, W, cfg)
    extents = [shapes[lvl] for _ in range(C) for lvl in range(cfg.n_levels)]
    canvas = torch.from_numpy(rng.uniform(0, 255, (len(extents), H, W)).astype(np.float32)).to(dev)
    got = kernels.fast_score(canvas, extents)
    want = kernels.fast_score_plain(canvas, extents)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    equal = bool(torch.equal(got, want))
    print(f"fast_score [{len(extents)}, {H}, {W}]: bit-equal {equal}, max |diff| {err}")
    if not equal:
        raise AssertionError("fast_score kernel differs from its plain version")
    ms = cuda_ms(lambda: kernels.fast_score(canvas, extents))
    plain_ms = cuda_ms(lambda: kernels.fast_score_plain(canvas, extents))
    print(f"  kernel {ms:.4f} ms   plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def phase_gather_patches(dev, rng):
    from multi_orb_slam_tpu_torch.ops import kernels

    side, B, N = 45, C * 8, C * 1024
    canvas = torch.from_numpy(rng.uniform(0, 255, (B, H, W)).astype(np.float32)).to(dev)
    idx = np.stack([rng.randint(0, B, N), rng.randint(0, H - side + 1, N),
                    rng.randint(0, W - side + 1, N)], axis=1).astype(np.int32)
    idx = torch.from_numpy(idx).to(dev)
    got = kernels.gather_patches(canvas, idx, side)
    want = kernels.gather_patches_plain(canvas, idx, side)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    equal = bool(torch.equal(got, want))
    print(f"gather_patches [{N}, {side}, {side}] from [{B}, {H}, {W}]: "
          f"bit-equal {equal}, max |diff| {err}")
    if not equal:
        raise AssertionError("gather_patches kernel differs from its plain version")
    ms = cuda_ms(lambda: kernels.gather_patches(canvas, idx, side))
    plain_ms = cuda_ms(lambda: kernels.gather_patches_plain(canvas, idx, side))
    print(f"  kernel {ms:.4f} ms   plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def phase_window_match(dev, rng):
    from multi_orb_slam_tpu_torch.ops import kernels

    Q, F = C * 1024, 1024
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    q_lmin = rng.randint(-1, 7, (C, Q)).astype(np.int32)
    args = (
        T(rng.uniform(0, W, (C, Q, 2)).astype(np.float32)),
        T(np.where(rng.rand(C, Q) < 0.9, rng.uniform(5, 40, (C, Q)), -1.0).astype(np.float32)),
        T(q_lmin), T(q_lmin + 2),
        T(np.where(rng.rand(C, Q) < 0.5, rng.uniform(0, W, (C, Q)), -1e9).astype(np.float32)),
        T(rng.randint(-2**31, 2**31, (1, Q, 8), dtype=np.int64).astype(np.int32)),
        T(rng.uniform(0, W, (C, F, 2)).astype(np.float32)),
        T(np.where(rng.rand(C, F) < 0.7, rng.uniform(0, W, (C, F)), -1).astype(np.float32)),
        T(rng.randint(0, 8, (C, F)).astype(np.int32)),
        T(rng.rand(C, F) < 0.9),
        T(rng.randint(-2**31, 2**31, (C, F, 8), dtype=np.int64).astype(np.int32)),
    )
    got = kernels.window_match(*args)
    want = kernels.window_match_plain(*args)
    torch.cuda.synchronize()
    bi, bd, b2, b2i = got
    rbi, rbd, rb2, rb2i = want
    uniq = rbd < rb2
    err = max(float((bd - rbd).abs().max()), float((b2 - rb2).abs().max()))
    dist_ok = bool(torch.equal(bd, rbd) and torch.equal(b2, rb2))
    idx_ok = bool(torch.equal(bi[uniq], rbi[uniq]))
    all_idx = float(((bi == rbi) & (b2i == rb2i)).float().mean())
    print(f"window_match C={C} Q={Q} F={F}: distances equal {dist_ok}, "
          f"best index equal where unique {idx_ok} "
          f"({int(uniq.sum())} unique rows), all indices equal on "
          f"{all_idx * 100:.2f}% of rows, max |diff| {err}")
    tie = kernels.window_match_tie_rows()
    expected = tie.pop("expected")
    out = kernels.window_match(*(T(tie[k]) for k in (
        "q_uv", "q_rad", "q_lmin", "q_lmax", "q_ur", "q_desc",
        "f_xy", "f_ur", "f_level", "f_mask", "f_desc")))
    tie_got = torch.stack([o[0] for o in out], dim=1).cpu().numpy()
    ties_ok = bool(np.array_equal(tie_got, expected))
    print(f"  tie rows (all-masked, single, equal, displaced best): agree {ties_ok}")
    for row, exp in zip(tie_got.tolist(), expected.tolist()):
        print(f"    got {row} expected {exp}")
    if not (dist_ok and idx_ok and ties_ok):
        raise AssertionError("window_match kernel differs from its plain version")
    ms = cuda_ms(lambda: kernels.window_match(*args))
    plain_ms = cuda_ms(lambda: kernels.window_match_plain(*args))
    print(f"  kernel {ms:.4f} ms   plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def bench_rig(dev):
    from multi_orb_slam_tpu_torch.geometry import camera as cam_mod, se3

    K = torch.tensor([[520.9, 521.0, 320.0, 240.0]] * C, dtype=torch.float32)
    T_rc1 = torch.eye(4)
    T_rc1[:3, :3] = se3.so3_exp(torch.tensor([0.0, np.pi / 2, 0.0]))
    T_rc1[:3, 3] = torch.tensor([0.161, 0.004, -0.071])
    T_rc = torch.stack([torch.eye(4), T_rc1])
    return cam_mod.CameraParams(
        K=K.to(dev), dist=torch.zeros((C, 5), device=dev), T_rc=T_rc.to(dev),
        bf=torch.tensor(40.0, device=dev), width=W, height=H)


def phase_main_path(dev):
    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.geometry import align
    from multi_orb_slam_tpu_torch.io import synthetic
    from multi_orb_slam_tpu_torch.ops import kernels, orb

    cfg = SlamConfig(n_cams=C, width=W, height=H, orb=orb.ORBConfig(n_features=1024))
    calib = bench_rig(dev)
    t0 = time.perf_counter()
    seq = synthetic.make_sequence(
        n_frames=N_FRAMES, K=calib.K[0].cpu().numpy(), T_rc=calib.T_rc.cpu().numpy(),
        height=H, width=W, n_points=4000)
    frames = [(torch.from_numpy(np.asarray(g, np.float32)).to(dev),
               torch.from_numpy(np.asarray(d, np.float32)).to(dev))
              for g, d in zip(seq.grays, seq.depths)]
    torch.cuda.synchronize()
    print(f"orbit scene: {N_FRAMES} frames x {C} cameras at {W}x{H} rendered "
          f"in {time.perf_counter() - t0:.1f} s")

    tracker = tracking.Tracker(calib, cfg, pipelined=True, pipeline_depth=3)
    kernels.reset_launch_counts()
    times = []
    for g, d in frames:
        torch.cuda.synchronize()
        t = time.perf_counter()
        tracker.process(g, d)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    traj = tracker.absolute_trajectory()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)

    n_ok = sum(1 for _, _, _, lost in traj if not lost)
    poses = np.stack([T for _, _, T, _ in traj]).astype(np.float64)
    finite = bool(np.isfinite(poses).all())
    est = torch.from_numpy(np.stack([np.linalg.inv(T)[:3, 3] for T in poses]))
    gt = torch.from_numpy(np.stack([np.linalg.inv(T)[:3, 3]
                                    for T in seq.poses_gt.astype(np.float64)]))
    ate = float(align.ate_rmse(est, gt))
    ms = np.asarray(times) * 1e3
    print(f"main path: Tracker.process median {np.median(ms):.2f} ms/frame "
          f"(first frame {ms[0]:.2f} ms, max {ms.max():.2f} ms, "
          f"median of frames 8-59 {np.median(ms[8:]):.2f} ms)")
    print(f"  frames tracked {n_ok}/{N_FRAMES}, keyframes {int(tracker.map.n_kf)}, "
          f"map points {int(tracker.map.n_mp)}, ATE {ate * 1e3:.3f} mm, "
          f"poses finite {finite}")
    print(f"  kernel launches in the main path: {launches}")
    if n_ok != N_FRAMES:
        raise AssertionError(f"only {n_ok}/{N_FRAMES} frames tracked")
    if not finite:
        raise AssertionError("NaN or inf in a pose")
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"ATE {ate:.4f} m >= {ATE_LIMIT_M} m")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_device()
    rng = np.random.RandomState(0)
    results = {
        "fast_score": phase_fast_score(dev, rng),
        "gather_patches": phase_gather_patches(dev, rng),
        "window_match": phase_window_match(dev, rng),
    }
    launches = phase_main_path(dev)
    rows = []
    for name, (err, ms, plain_ms) in results.items():
        source, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
