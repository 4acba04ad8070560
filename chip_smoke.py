"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. Device and build: torch / CUDA versions, the card's name and power limit
   (nvidia-smi), and the build of every CUDA kernel of the port from
   `multi_orb_slam_tpu_torch/csrc/`.
2. Kernel vs plain, one phase per kernel, on random inputs at the shapes
   the main path gives it (640x480, 2 cameras, 8 levels, 1024 features per
   camera, local-BA windows of 24 to 64 keyframe rows): `fast_score`,
   `gather_patches` and `point_sums` must be bit-equal to their plain
   PyTorch versions (`point_sums` at four shapes, one with a P that no tile
   of points divides, and the same bits on a second launch); `window_match`
   must give equal distances and equal
   best and second indices on every row, at the search shape (C = 2, Q =
   2048, F = 1024) and at the dense shape of `match_frame_kf_brute` (Q = F =
   1024, every gate open), and the expected rows of both hand-made tie sets.
   Three clocks per kernel: `ms`, CUDA events around 20 wrapper calls (what
   a caller that queues calls back to back sees: the slower of host and
   device); `device_ms`, the kernel's own duration on the card, from
   `torch.profiler` by kernel name; `host_us`, the host clock around 200
   wrapper calls with no synchronise, per call.  The plain version is timed
   like `ms`, and beside it the one PyTorch call that computes the same
   function, where there is one.  Each kernel's bound (the least time the
   card could take: bytes over 3.35 TB/s or operations over 67 Top/s, the
   larger) is computed from the phase's inputs and is to be held against
   `device_ms`.
3. Tracking path: the first 20 frames of the bench's orbit scene (4000
   textured squares, 640x480, the dual ~90-degree rig) through
   `Tracker(calib, cfg, pipelined=True, pipeline_depth=3)` with the default
   `SlamConfig` and no mapping callback.
4. Mapping path: all 60 orbit frames through the same tracker with
   `kf_inserted_cb` running `run_mapping_stage` and `covis_kf_count` (the
   next keyframe's window hint), as `bench.py` sets it.  The orbit maps 4
   keyframes and solves 2 local BAs; with no local BA (so no `point_sums`
   launch) the phase fails.
   For each path every kernel's launch count is set to 0 just before and
   read just after; a path fails unless every frame tracks, ATE < 0.02 m,
   no pose or map point is NaN and every kernel of the path launched (the
   mapping path: all four, and every keyframe mapped).
5. System path, `system-reloc`: the 60 orbit frames through
   `System(sensor=DUAL_RGBD, calib=..., cfg=...)` on the card (its defaults:
   unpipelined, mapping and the loop stage on), with 3 frames blanked out
   (grey 100, depth 0) once the vocabulary exists.  The orbit gives 4
   keyframes in 60 frames, so the script builds the `LoopCloser` with
   `vocab_min_descs=1500` instead of 6000 and says so.  The path fails unless
   the state is LOST on the blank frames, a relocalization succeeds with
   `window_match` launched inside it, the state is OK on the last frame, the
   last pose is within 5 cm of ground truth, ATE over the tracked frames is
   under 20 mm and all four kernels launched.  It prints each
   relocalization's time, candidates and host reads, the vocabulary's
   training time, and (from a second, profiled call on a copy of the lost
   frame's inputs, after the counts were read) the time split by stage.
   Then `save_map`, a fresh `System`, `load_map` (it comes back LOST), the
   loaded keyframes indexed again by the script, and one frame found again.
6. System path, `system-loop`: the loop circuit of
   `tests/test_circuit_e2e.py` through `System` with loop closing and
   global BA (a loop closed, the GBA merged, ATE < 0.20 m, every loop role
   of `window_match` launched, the GBA dispatch held under
   `torch.cuda.set_sync_debug_mode("error")`).
7. The stereo path's kernel shapes (before the paths, with the other kernel
   phases): `fast_score` on the [2 x 8, 376, 1241] canvas of a KITTI-size
   stereo pair (1241 is no multiple of 4: the scalar-load path),
   `gather_patches` of 4000 patches from it, `window_match` at C = 1,
   Q = F = 2000, gated and dense: each bit-equal to its plain version.
8. `system-stereo`: 30 rendered KITTI-size stereo pairs (ORB-SLAM2's
   KITTI00-02.yaml settings, the right camera shifted by bf / fx) written
   as a KITTI directory with `io/png.py` and tracked through
   `drivers/stereo_kitti` (its `run`, the body of `main`, which also
   returns the System for the checks): every frame tracked, ATE < 0.05 m, on frame
   0 >= 40% of the valid left keypoints with a stereo depth at a median
   relative error < 5%, the kernels launched; the split of
   `build_frame_stereo` and how full the map's capacities are.
9. `driver-rgbd`: 60 frames of the real rig (`configs/multi.yaml`,
   `configs/calibration.txt`) written in `tools/make_tum_dataset.py`'s
   layout with `io/png.py` and tracked through `drivers/rgbd_tum` (`run`)
   with `--pipelined` (the first `System(pipelined=True)` on the card): 60
   trajectory lines, a keyframe, ATE < 20 mm, all four kernels launched.
   Then the native loader's build is tried once and reported on a JSON line
   of its own (it needs libpng's and libjpeg's headers); where it builds,
   its frames must equal `io/png.py`'s and the single-camera form with
   `--native-loader --pipelined` must track every frame under 20 mm.
   Then the same 60 frames without and with `--pipelined` in turns (off,
   on, on, off), each run's median tracking and whole-frame times on a
   `{"pipelined_ab": [...]}` line; each run must track under 20 mm.
10. `driver-live`: the live driver's self-test, 20 frames streamed through a
   local socket and tracked on the card.  `mono-init`: the two-view
   initializer on the card and on the CPU on the same draws, on a general
   and a planar scene: the same `ok` and model, `is_good` within 1%, R
   within 1e-4.
11. A JSON line of per-kernel results (with `launches_stereo` and
   `launches_driver`, and the stereo path's shapes under `kitti_shapes`),
   then the last line `{"ok": true, "device": {...}}`.

Without a CUDA device the script exits 1 before printing any result.
"""

import collections
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H, W, C = 480, 640, 2
N_FRAMES = 60
N_FRAMES_TRACKING_ONLY = 20
N_FRAMES_CIRCUIT = 160     # `render_scene("circuit")`, for tools/torch_mapping_profile.py
ATE_LIMIT_M = 0.02
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM float32 rate outside the tensor cores;
                            # taken for the integer ALU work too
REF = "multi_orb_slam_tpu/ops/pallas_kernels.py"
KERNELS = {
    "fast_score": ("multi_orb_slam_tpu_torch/csrc/fast_score.cu", f"{REF}:87"),
    "gather_patches": ("multi_orb_slam_tpu_torch/csrc/gather_patches.cu", f"{REF}:376"),
    "window_match": ("multi_orb_slam_tpu_torch/csrc/window_match.cu", f"{REF}:228"),
    "point_sums": ("multi_orb_slam_tpu_torch/csrc/point_sums.cu", f"{REF}:449"),
}
# a part of each kernel's name on the device, as the profiler shows it
KERNEL_SYMBOLS = {"fast_score": "fast_score_kernel", "gather_patches": "gather_patches_kernel",
                  "window_match": "window_match_kernel", "point_sums": "point_sums_kernel"}


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def report(name, err, clocks, plain_ms, library_ms, n_bytes, n_ops):
    bound_ms, bound_by = bound(n_bytes, n_ops)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"  kernel {clocks['ms']:.4f} ms (device {clocks['device_ms']:.4f}, "
          f"host {clocks['host_us']:.1f} us a call)   "
          f"plain {plain_ms:.4f} ms   library {lib}   "
          f"bound {bound_ms:.5f} ms by {bound_by} "
          f"({n_bytes / 1e6:.2f} MB, {n_ops / 1e6:.1f} Mop): device time "
          f"{clocks['device_ms'] / bound_ms:.1f}x the bound")
    return {"max_abs_err": err, **clocks, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds per call, by CUDA events around `reps` calls."""
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


def profiled_device_ms(fn, kernel, reps=20):
    """Mean duration on the card of the device kernels whose name contains
    `kernel`, over `reps` calls of `fn` under `torch.profiler`.

    Tracing takes a while to start and misses launches until then, so `reps`
    calls go to the profiler's warm-up step first and only the next `reps`
    are read.  The tracer also drops records whose device timestamp falls
    outside its window on the host clock, and the two clocks can be a
    millisecond apart, which is longer than 20 launches of a 2 us kernel
    take: the read launches therefore keep a pause away from both ends of
    the window.  A try that still misses launches is made again with a
    longer pause; the mean is taken only from a try that saw them all."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for pause in (0.02, 0.1, 0.5):
        steps = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts, schedule=steps) as prof:
            for active in (False, True):
                if active:
                    time.sleep(pause)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                if active:
                    time.sleep(pause)
                prof.step()
        total_us, count = 0.0, 0
        for avg in prof.key_averages():
            if kernel in avg.key and avg.self_device_time_total > 0:
                total_us += avg.self_device_time_total
                count += avg.count
        if count == reps:
            return total_us / count / 1e3
        seen.append(count)
    raise AssertionError(f"profiler saw {seen} launches of {kernel} in three tries, "
                         f"expected {reps} in each")


def host_us(fn, reps=200):
    """Host microseconds per call: `reps` calls queued with no synchronise."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e6


def read_ranges(prof, prefix, rows):
    """Add one profile's `record_function` ranges named `prefix`* to `rows`
    ({name: calls, host_ms, device_ops, device_ms}): the host time of each
    range, and the device operations (kernels and copies) launched inside it
    with their summed device time, each operation assigned to the range that
    encloses the host call that launched it.  Returns (device ops inside a
    range, device ops in the profile)."""
    cpu = torch.autograd.DeviceType.CPU
    events = list(prof.events())
    ranges = [e for e in events if e.device_type == cpu and e.name.startswith(prefix)]
    for r in ranges:
        row = rows[r.name[len(prefix):]]
        row["calls"] += 1
        row["host_ms"] += r.time_range.elapsed_us() / 1e3
    n_in = n_all = 0
    for e in events:
        if e.device_type != cpu or not e.kernels:
            continue
        n_all += len(e.kernels)
        t = e.time_range.start
        home = [r for r in ranges
                if r.thread == e.thread and r.time_range.start <= t <= r.time_range.end]
        if not home:
            continue
        # stages do not nest; the innermost range would be the shortest
        r = min(home, key=lambda x: x.time_range.elapsed_us())
        row = rows[r.name[len(prefix):]]
        row["device_ops"] += len(e.kernels)
        row["device_ms"] += sum(k.duration for k in e.kernels) / 1e3
        n_in += len(e.kernels)
    return n_in, n_all


def kernel_clocks(fn, name):
    """The wrapper call `fn` of kernel `name` on its three clocks."""
    from multi_orb_slam_tpu_torch.ops import kernels

    before = kernels.LAUNCHES[name]
    clocks = {"ms": cuda_ms(fn), "device_ms": profiled_device_ms(fn, KERNEL_SYMBOLS[name]),
              "host_us": host_us(fn)}
    if kernels.LAUNCHES[name] <= before:
        raise AssertionError(f"{name}: the timed call launched no kernel")
    return clocks


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


def fast_score_inputs(dev, rng):
    """A random canvas with the extents of the main path: 2 cameras x 8
    pyramid levels of a 640x480 image."""
    from multi_orb_slam_tpu_torch.ops import orb

    cfg = orb.ORBConfig(n_features=1024)
    shapes = orb.pyramid_shapes(H, W, cfg)
    extents = [shapes[lvl] for _ in range(C) for lvl in range(cfg.n_levels)]
    canvas = torch.from_numpy(rng.uniform(0, 255, (len(extents), H, W)).astype(np.float32)).to(dev)
    return canvas, extents


def phase_fast_score(dev, rng):
    from multi_orb_slam_tpu_torch.ops import kernels

    canvas, extents = fast_score_inputs(dev, rng)
    got = kernels.fast_score(canvas, extents)
    want = kernels.fast_score_plain(canvas, extents)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    equal = bool(torch.equal(got, want))
    print(f"fast_score [{len(extents)}, {H}, {W}]: bit-equal {equal}, max |diff| {err}")
    if not equal:
        raise AssertionError("fast_score kernel differs from its plain version")
    clocks = kernel_clocks(lambda: kernels.fast_score(canvas, extents), "fast_score")
    plain_ms = cuda_ms(lambda: kernels.fast_score_plain(canvas, extents))
    # reads the live extent of each image, writes the whole canvas; per live
    # pixel the least arithmetic known for the function: 16 differences, the
    # 16 arc minima and the 16 arc maxima from block prefixes and suffixes
    # (44 + 44), 30 to combine them, 1 negation and 1 final maximum
    live = sum(h * w for h, w in extents)
    return report("fast_score", err, clocks, plain_ms, None,
                  4 * live + 4 * canvas.numel(), 136 * live)


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
    clocks = kernel_clocks(lambda: kernels.gather_patches(canvas, idx, side), "gather_patches")
    plain_ms = cuda_ms(lambda: kernels.gather_patches_plain(canvas, idx, side))
    # library form: one advanced-indexing call on ready-made index tensors
    d = torch.arange(side, device=dev)
    ib = idx[:, 0].long()[:, None, None]
    iy = (idx[:, 1].long()[:, None] + d)[:, :, None]
    ix = (idx[:, 2].long()[:, None] + d)[:, None, :]
    library_ms = cuda_ms(lambda: canvas[ib, iy, ix])
    # writes every patch once; reads as much, or the canvas if that is less
    out_bytes = 4 * N * side * side
    return report("gather_patches", err, clocks, plain_ms, library_ms,
                  out_bytes + min(out_bytes, 4 * canvas.numel()) + 4 * idx.numel(), 0)


WINDOW_MATCH_ARGS = ("q_uv", "q_rad", "q_lmin", "q_lmax", "q_ur", "q_desc",
                     "f_xy", "f_ur", "f_level", "f_mask", "f_desc")


def hold_window_match(label, args):
    """The kernel against the plain version on `args`: distances and both
    indices equal on every row.  Returns the largest distance error."""
    from multi_orb_slam_tpu_torch.ops import kernels

    got = kernels.window_match(*args)
    want = kernels.window_match_plain(*args)
    torch.cuda.synchronize()
    (bi, bd, b2, b2i), (rbi, rbd, rb2, rb2i) = got, want
    err = max(float((bd - rbd).abs().max()), float((b2 - rb2).abs().max()))
    dist_ok = bool(torch.equal(bd, rbd) and torch.equal(b2, rb2))
    rows_ok = (bi == rbi) & (b2i == rb2i)
    print(f"window_match {label}: distances equal {dist_ok}, best and second index equal "
          f"on {int(rows_ok.sum())} of {rows_ok.numel()} rows "
          f"({int((rbd < rb2).sum())} with a unique best, {int((rbd >= kernels.BIG).sum())} "
          f"with no candidate), max |diff| {err}")
    if not (dist_ok and bool(rows_ok.all())):
        raise AssertionError(f"window_match {label}: kernel differs from its plain version")
    return err


def window_match_inputs(dev, rng):
    """(args, dense): random arguments at the search shape C = 2, Q = 2048,
    F = 1024, and at the dense shape of `search.match_frame_kf_brute`."""
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
    # the arguments of `search.match_frame_kf_brute`: every gate open
    Fk = 1024
    dense = (
        torch.zeros((C, Fk, 2), device=dev),
        T(np.where(rng.rand(C, Fk) < 0.9, np.inf, -1.0).astype(np.float32)),
        torch.full((C, Fk), -1, dtype=torch.int32, device=dev),
        torch.full((C, Fk), 1 << 30, dtype=torch.int32, device=dev),
        torch.full((C, Fk), -1e9, device=dev),
        T(rng.randint(-2**31, 2**31, (C, Fk, 8), dtype=np.int64).astype(np.int32)),
        torch.zeros((C, F, 2), device=dev), torch.full((C, F), -1.0, device=dev),
        torch.zeros((C, F), dtype=torch.int32, device=dev),
        T(rng.rand(C, F) < 0.9), args[10],
    )
    return args, dense


def window_match_work(a):
    """(bytes, operations) of one `window_match` call on `a`: every (query,
    feature) pair passes ~12 gate operations; only the pairs that pass them
    need the 256-bit distance (8 xor, 8 popcount, 8 adds) and the two
    compares of the running best and second."""
    from multi_orb_slam_tpu_torch.ops import kernels

    n_cand = int(kernels.window_match_candidates(*a[:5], *a[6:10]).sum())
    n_pairs = a[1].numel() * a[7].shape[1]
    n_bytes = sum(t.numel() * t.element_size() for t in a) + 4 * 4 * a[1].numel()
    print(f"  {n_cand} of {n_pairs} pairs pass the gates")
    return n_bytes, 12 * n_pairs + 26 * n_cand


def phase_window_match(dev, rng):
    from multi_orb_slam_tpu_torch.ops import kernels

    T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    args, dense = window_match_inputs(dev, rng)
    (_, Q), (_, Fk), F = args[1].shape, dense[1].shape, args[7].shape[1]
    err = hold_window_match(f"C={C} Q={Q} F={F}", args)
    err = max(err, hold_window_match(f"dense C={C} Q={Fk} F={F}", dense))
    for strided in (False, True):
        tie = kernels.window_match_tie_rows(strided=strided)
        out = kernels.window_match(*(T(tie[k]) for k in WINDOW_MATCH_ARGS))
        tie_got = torch.stack([o[0] for o in out], dim=1).cpu().numpy()
        ties_ok = bool(np.array_equal(tie_got, tie["expected"]))
        print(f"  tie rows, F = {tie['f_ur'].shape[1]}: agree {ties_ok}")
        for row, exp in zip(tie_got.tolist(), tie["expected"].tolist()):
            print(f"    got {row} expected {exp}")
        if not ties_ok:
            raise AssertionError("window_match kernel misses a hand-made tie row")

    work = window_match_work
    print(f"window_match dense C={C} Q={Fk} F={F} (not the table's row):")
    report("window_match", err, kernel_clocks(lambda: kernels.window_match(*dense), "window_match"),
           cuda_ms(lambda: kernels.window_match_plain(*dense)), None, *work(dense))
    loop_shapes = {}
    for role, (label, a) in window_match_loop_inputs(dev, rng).items():
        loop_err = hold_window_match(label, a)
        print(f"window_match {label} (loop role {role}, not the table's row):")
        loop_shapes[role] = report(
            "window_match", loop_err, kernel_clocks(lambda: kernels.window_match(*a), "window_match"),
            cuda_ms(lambda: kernels.window_match_plain(*a)), None, *work(a))
        err = max(err, loop_err)
    print(f"window_match C={C} Q={Q} F={F}:")
    row = report("window_match", err,
                 kernel_clocks(lambda: kernels.window_match(*args), "window_match"),
                 cuda_ms(lambda: kernels.window_match_plain(*args)), None, *work(args))
    return {**row, "loop_shapes": loop_shapes}


def clustered_descriptors(rng, n, centers):
    """[n, 8] int32 descriptor words around the given 256-bit centres."""
    bits = centers[rng.randint(0, len(centers), n)] ^ (rng.rand(n, 256) < 0.08).astype(np.uint8)
    return np.packbits(bits, axis=1).view(np.uint32).view(np.int32)


def window_match_loop_inputs(dev, rng):
    """{role: (label, args)}: the loop closer's three `window_match` calls
    at the shapes of the loop path (two rig keyframes of 2 x 512 features,
    the map's 24576 point slots), built by the loop closer's own argument
    builders where it has them."""
    from multi_orb_slam_tpu_torch.loop import loop_closing
    from multi_orb_slam_tpu_torch.placerec import vocabulary

    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    centers = rng.randint(0, 2, (200, 256)).astype(np.uint8)
    # word-gated: C = 1, Q = F = 1024 (2 cameras x 512), real word ids of a
    # k = 10, depth 4 vocabulary
    voc = vocabulary.build_vocabulary(clustered_descriptors(rng, 6000, centers), k=10, depth=4,
                                      iters=3, device=dev)
    da, db = (T(clustered_descriptors(rng, 1024, centers)) for _ in range(2))
    word = loop_closing.word_match_args(
        da, T(rng.rand(1024) < 0.6), vocabulary.transform_words(voc, da),
        db, T(rng.rand(1024) < 0.6), vocabulary.transform_words(voc, db))
    # search_by_sim3: C = 2 (one direction a row), Q = F = 512; radius 7.5 x
    # 1.2^level, levels [l - 1, l], a third of the landmarks invalid
    Fs = 512
    lvl = rng.randint(0, 8, (2, Fs)).astype(np.int32)
    rad = np.where(rng.rand(2, Fs) < 0.66, 7.5 * 1.2 ** lvl, -1.0).astype(np.float32)
    sim3 = (T(rng.uniform(0, W / 2, (2, Fs, 2)).astype(np.float32)), T(rad), T(lvl - 1), T(lvl),
            torch.full((2, Fs), -1e9, device=dev), T(clustered_descriptors(rng, 2 * Fs, centers)
                                                    .reshape(2, Fs, 8)),
            T(rng.uniform(0, W / 2, (2, Fs, 2)).astype(np.float32)),
            torch.full((2, Fs), -1.0, device=dev), T(rng.randint(0, 8, (2, Fs)).astype(np.int32)),
            T(rng.rand(2, Fs) < 0.66),
            T(clustered_descriptors(rng, 2 * Fs, centers).reshape(2, Fs, 8)))
    # the projection count: C = 1, Q = 24576 map points, F = 512 features of
    # camera 0, radius 8, a fifth of the points projecting usably
    M = 24576
    guided = loop_closing.guided_count_args(
        T(rng.uniform(0, W / 2, (M, 2)).astype(np.float32)), T(rng.rand(M) < 0.2),
        T(clustered_descriptors(rng, M, centers)),
        T(rng.uniform(0, W / 2, (Fs, 2)).astype(np.float32)), T(rng.rand(Fs) < 0.9),
        T(clustered_descriptors(rng, Fs, centers)))
    return {"word_match": ("word-gated C=1 Q=1024 F=1024", word),
            "search_by_sim3": ("search_by_sim3 C=2 Q=512 F=512", sim3),
            "guided_matches": ("projection count C=1 Q=24576 F=512", guided)}


def point_sums_inputs(rng, LC, F, P, D, dev):
    """Each row a random injection of F features into P points, the rest
    -1 (as the reference's test builds it); the last row all -1."""
    V = rng.randn(LC, F, D).astype(np.float32)
    inv = np.full((LC, P), -1, np.int32)
    for r in range(LC - 1):
        inv[r, rng.choice(P, F, replace=False)] = rng.permutation(F)
    return torch.from_numpy(V).to(dev), torch.from_numpy(inv).to(dev)


def point_sums_library(V, inv):
    """The library form: `torch.gather`, `where`, `sum(0)`."""
    LC, F, D = V.shape
    g = torch.gather(V, 1, inv.clamp(0, F - 1).long()[..., None].expand(LC, inv.shape[1], D))
    g = torch.where((inv >= 0)[..., None], g, 0.0)
    return g.sum(0), g


# (LC, F, P, D): the local-BA re-layout at its smallest and largest window,
# the reference kernel's design shape, and a P that no tile of 8 points
# divides with more rows than one chunk of 128; the first is the one reported
POINT_SUMS_SHAPES = ((48, 1024, 2048, 4), (128, 1024, 2048, 4), (48, 1024, 4096, 30),
                     (130, 1024, 2045, 4))


def phase_point_sums(dev, rng):
    from multi_orb_slam_tpu_torch.ops import kernels

    out = None
    for LC, F, P, D in POINT_SUMS_SHAPES:
        V, inv = point_sums_inputs(rng, LC, F, P, D, dev)
        s_k, g_k = kernels.point_sums(V, inv)
        s_2, g_2 = kernels.point_sums(V, inv)
        s_p, g_p = kernels.point_sums_plain(V, inv)
        s_l, g_l = point_sums_library(V, inv)
        torch.cuda.synchronize()
        err = max(float((g_k - g_p).abs().max()), float((s_k - s_p).abs().max()))
        equal = bool(torch.equal(g_k, g_p) and torch.equal(s_k, s_p))
        again = bool(torch.equal(g_k, g_2) and torch.equal(s_k, s_2))
        lib_err = float((s_k - s_l).abs().max())
        print(f"point_sums LC={LC} F={F} P={P} D={D}: gathered and summed bit-equal "
              f"{equal}, max |diff| {err}; the same bits on a second launch {again}; "
              f"last row empty {not bool(g_k[-1].any())}; "
              f"summed vs library sum(0) max |diff| {lib_err:.2e}")
        if not (equal and again) or bool(g_k[-1].any()) or not torch.equal(g_k, g_l):
            raise AssertionError("point_sums kernel differs from its plain version")
        clocks = kernel_clocks(lambda: kernels.point_sums(V, inv), "point_sums")
        plain_ms = cuda_ms(lambda: kernels.point_sums_plain(V, inv))
        library_ms = cuda_ms(lambda: point_sums_library(V, inv))
        n_bytes = 4 * (V.numel() + inv.numel() + LC * P * D + P * D)
        row = report("point_sums", err, clocks, plain_ms, library_ms, n_bytes, LC * P * D)
        out = out or row
    return out


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


def render_scene(name, calib, dev):
    """The bench's scenes, rendered with numpy: (frames on the card, poses_gt)."""
    from multi_orb_slam_tpu_torch.io import synthetic

    Kc, T_rc = calib.K[0].cpu().numpy(), calib.T_rc.cpu().numpy()
    t0 = time.perf_counter()
    if name == "orbit":
        seq = synthetic.make_sequence(n_frames=N_FRAMES, K=Kc, T_rc=T_rc,
                                      height=H, width=W, n_points=4000)
        grays, depths, poses = seq.grays, seq.depths, seq.poses_gt
    else:
        world = synthetic.make_box_world(seed=3, n_points=5000, box=(7.0, 4.0, 7.0))
        poses = synthetic.circuit_trajectory(N_FRAMES_CIRCUIT, radius=2.2, laps=1.1)
        grays, depths = [], []
        for T in poses:
            views = [synthetic.render_rgbd(world, Kc, T_rc[c] @ T, H, W) for c in range(C)]
            grays.append(np.stack([v[0] for v in views]))
            depths.append(np.stack([v[1] for v in views]))
    frames = [(torch.from_numpy(np.asarray(g, np.float32)).to(dev),
               torch.from_numpy(np.asarray(d, np.float32)).to(dev))
              for g, d in zip(grays, depths)]
    torch.cuda.synchronize()
    print(f"{name} scene: {len(frames)} frames x {C} cameras at {W}x{H} rendered "
          f"in {time.perf_counter() - t0:.1f} s")
    return frames, np.asarray(poses, np.float64)


def run_path(name, frames, poses_gt, calib, cfg, mapping):
    """Drive the Tracker over `frames`, with or without the mapping
    callback; returns (launch counts, keyframes mapped, local-BA solves)."""
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.geometry import align
    from multi_orb_slam_tpu_torch.mapping import local_mapping
    from multi_orb_slam_tpu_torch.ops import kernels
    from multi_orb_slam_tpu_torch.optim import local_ba

    tracker = tracking.Tracker(calib, cfg, pipelined=True, pipeline_depth=3)
    map_ms, covis_pending = [], [None]

    def kf_cb(kf_slot):
        # as bench.py sets it: the mapping stage, then the covisible count
        # that the NEXT keyframe's stage takes as its window hint
        torch.cuda.synchronize()
        t = time.perf_counter()
        hint = int(covis_pending[0]) if covis_pending[0] is not None else None
        m = local_mapping.run_mapping_stage(tracker.map, kf_slot, tracker.frame_id,
                                            calib, cfg, covis_hint=hint)
        if cfg.ba_adaptive:
            covis_pending[0] = local_mapping.covis_kf_count(m, kf_slot)
        torch.cuda.synchronize()
        map_ms.append((time.perf_counter() - t) * 1e3)
        return m

    if mapping:
        tracker.kf_inserted_cb = kf_cb
    windows0 = dict(local_mapping.STATS["ba_windows"])
    ba0 = dict(local_ba.STATS)
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

    n = len(frames)
    n_ok = sum(1 for _, _, _, lost in traj if not lost)
    poses = np.stack([T for _, _, T, _ in traj]).astype(np.float64)
    st = tracker.map
    finite = bool(np.isfinite(poses).all()) and bool(
        torch.isfinite(st.mp_pos[st.mp_valid]).all()) and bool(
        torch.isfinite(st.kf_Tcw).all())
    est = torch.from_numpy(np.stack([np.linalg.inv(T)[:3, 3] for T in poses]))
    gt = torch.from_numpy(np.stack([np.linalg.inv(T)[:3, 3] for T in poses_gt[:n]]))
    ate = float(align.ate_rmse(est, gt))
    ms = np.asarray(times) * 1e3
    n_inserted = int(st.next_kf_id) - 1          # keyframes after the first
    windows = {k: v - windows0.get(k, 0)
               for k, v in local_mapping.STATS["ba_windows"].items() if v - windows0.get(k, 0)}
    solves = local_ba.STATS["solves"] - ba0["solves"]
    iters = local_ba.STATS["iterations"] - ba0["iterations"]
    label = f"{name}-{n}" + (" with mapping" if mapping else " tracking only")
    print(f"{label}: Tracker.process median {np.median(ms):.2f} ms/frame "
          f"(first frame {ms[0]:.2f} ms, max {ms.max():.2f} ms, "
          f"median from frame 8 on {np.median(ms[8:]):.2f} ms, total {ms.sum() / 1e3:.2f} s)")
    print(f"  frames tracked {n_ok}/{n}, keyframes {int(st.n_kf)} valid of "
          f"{n_inserted + 1} inserted, map points {int(st.n_mp)}, ATE {ate * 1e3:.3f} mm, "
          f"poses and points finite {finite}")
    if mapping:
        per_kf = np.asarray(map_ms) if map_ms else np.zeros(1)
        print(f"  mapping stages {len(map_ms)}: median {np.median(per_kf):.2f} ms, "
              f"max {per_kf.max():.2f} ms each; local-BA windows (free keyframes: "
              f"solves) {windows}, point_sums rows {[4 * k for k in windows]}; "
              f"LM iterations {iters} in {solves} solves "
              f"({iters / max(solves, 1):.1f} per solve)")
    print(f"  kernel launches: {launches}")
    if n_ok != n:
        raise AssertionError(f"{label}: only {n_ok}/{n} frames tracked")
    if not finite:
        raise AssertionError(f"{label}: NaN or inf in a pose or a map point")
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"{label}: ATE {ate:.4f} m >= {ATE_LIMIT_M} m")
    if mapping and len(map_ms) != n_inserted:
        raise AssertionError(f"{label}: {n_inserted} keyframes inserted, {len(map_ms)} mapped")
    return launches, len(map_ms), solves


def phase_main_paths(dev):
    """The tracking-only path, the path with mapping, then the facade's path
    with a relocalization; returns the launch counts of the three."""
    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.ops import orb

    cfg = SlamConfig(n_cams=C, width=W, height=H, orb=orb.ORBConfig(n_features=1024))
    calib = bench_rig(dev)
    frames, poses_gt = render_scene("orbit", calib, dev)
    tracking, _, _ = run_path("orbit", frames[:N_FRAMES_TRACKING_ONLY], poses_gt,
                              calib, cfg, mapping=False)
    missing = [k for k in ("fast_score", "gather_patches", "window_match")
               if tracking[k] <= 0]
    if missing:
        raise AssertionError(f"tracking path never launched: {missing}")
    mapped, _, solves = run_path("orbit", frames, poses_gt, calib, cfg, mapping=True)
    missing = [k for k, v in mapped.items() if v <= 0]
    if missing or solves == 0 or mapped["point_sums"] != solves:
        raise AssertionError(f"mapping path on the orbit: never launched {missing}; "
                             f"{solves} local-BA solves (none: no local BA was reached, "
                             f"so `point_sums` never ran), {mapped['point_sums']} "
                             f"point_sums launches")
    system = phase_system_reloc(frames, poses_gt, calib, cfg)
    return tracking, mapped, system


N_BLANK = 3                  # blank frames of the system path
BLANK_AFTER_VOCAB = 4        # frames between the vocabulary's training and the blackout
SMOKE_VOCAB_MIN_DESCS = 1500
LAST_POSE_LIMIT_M = 0.05


def map_gauge_centres(poses):
    """Camera centres of world->camera poses, in the gauge of the first."""
    poses = np.asarray(poses, np.float64)
    return np.stack([np.linalg.inv(T @ np.linalg.inv(poses[0]))[:3, 3] for T in poses])


def profile_relocalize(stash):
    """The time split of one relocalization: `relocalize` again on copies of
    the inputs of the call that found the frame, once to warm up and once
    under `torch.profiler`, read by its "reloc/<stage>" ranges."""
    from multi_orb_slam_tpu_torch.reloc import relocalization

    relocalization.relocalize(*stash)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ok, _, _, n = relocalization.relocalize(*stash)
    plain_ms = (time.perf_counter() - t) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    rows = collections.defaultdict(
        lambda: {"calls": 0, "host_ms": 0.0, "device_ops": 0, "device_ms": 0.0})
    with torch.profiler.profile(activities=acts) as prof:
        relocalization.relocalize(*stash)
        torch.cuda.synchronize()
    n_in, n_all = read_ranges(prof, "reloc/", rows)
    print(f"  relocalize again on the same inputs: found {ok} with {n} inliers in "
          f"{plain_ms:.2f} ms unprofiled; under the profiler {n_in} of {n_all} device "
          f"operations inside a stage:")
    print(f"    {'stage':<16}{'calls':>6}{'host ms, profiled':>19}{'device ops':>12}{'device ms':>11}")
    for name, r in rows.items():
        print(f"    {name:<16}{r['calls']:>6}{r['host_ms']:>19.2f}{r['device_ops']:>12}"
              f"{r['device_ms']:>11.3f}")
    print(f"    {'all':<16}{'':>6}{sum(r['host_ms'] for r in rows.values()):>19.2f}"
          f"{sum(r['device_ops'] for r in rows.values()):>12}"
          f"{sum(r['device_ms'] for r in rows.values()):>11.3f}")
    if not ok:
        raise AssertionError("system-reloc: the profiled relocalization did not find the frame")


def phase_system_reloc(frames, poses_gt, calib, cfg):
    """The facade's path: track, lose the scene, be found again; save the
    map, load it in a fresh `System`, be found there.  Returns the launch
    counts of the tracked sequence."""
    from multi_orb_slam_tpu_torch import system as system_mod
    from multi_orb_slam_tpu_torch.frontend.tracking import TrackState
    from multi_orb_slam_tpu_torch.geometry import align
    from multi_orb_slam_tpu_torch.loop import loop_closing
    from multi_orb_slam_tpu_torch.ops import kernels
    from multi_orb_slam_tpu_torch.placerec import database
    from multi_orb_slam_tpu_torch.reloc import relocalization

    def clone(nt):
        return type(nt)(*[v.clone() if isinstance(v, torch.Tensor) else v for v in nt])

    sys_ = system_mod.System(sensor=system_mod.Sensor.DUAL_RGBD, calib=calib, cfg=cfg)
    sys_.loop_closer = loop_closing.LoopCloser(sys_.calib, cfg,
                                               vocab_min_descs=SMOKE_VOCAB_MIN_DESCS)
    print(f"system-reloc: System(DUAL_RGBD) on {sys_.device}, unpipelined, mapping and loop "
          f"stage on; LoopCloser(vocab_min_descs={SMOKE_VOCAB_MIN_DESCS}) instead of "
          f"{loop_closing.VOCAB_MIN_DESCS}: the orbit has 4 keyframes in {len(frames)} frames "
          f"(vocabulary k = {sys_.loop_closer.vocab_k}, depth {sys_.loop_closer.vocab_depth}, "
          f"default SlamConfig otherwise)")
    relocs, stash = [], []
    inner = sys_.tracker.reloc_cb

    def reloc_cb(fr):
        inputs = (sys_.tracker.map, fr, sys_.loop_closer.voc, sys_.loop_closer.db,
                  sys_.calib, cfg)
        if sys_.loop_closer.voc is not None and not stash:
            # copies for the profiled call after the path (the database is
            # written in place by later keyframes)
            kept = tuple(clone(x) if isinstance(x, tuple) else x for x in inputs)
        else:
            kept = None
        s0, l0 = dict(relocalization.STATS), dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(fr)
        torch.cuda.synchronize()
        relocs.append({
            "frame": sys_.tracker.frame_id, "ok": bool(out[0]), "inliers": int(out[3]),
            "ms": (time.perf_counter() - t) * 1e3,
            "candidates": relocalization.STATS["candidates"] - s0["candidates"],
            "host_reads": relocalization.STATS["host_reads"] - s0["host_reads"],
            "window_match": kernels.LAUNCHES["window_match"] - l0["window_match"]})
        if out[0] and kept is not None:
            stash.append(kept)
        return out

    sys_.tracker.reloc_cb = reloc_cb
    blank_g = torch.full_like(frames[0][0], 100.0)
    blank_d = torch.zeros_like(frames[0][1])
    kernels.reset_launch_counts()
    states, times, blank_at, vocab_at = [], [], [], None
    for i, (g, d) in enumerate(frames):
        if vocab_at is None and sys_.loop_closer.voc is not None:
            vocab_at = i
        blank = (vocab_at is not None and len(blank_at) < N_BLANK
                 and i >= vocab_at + BLANK_AFTER_VOCAB)
        if blank:
            blank_at.append(i)
            g, d = blank_g, blank_d
        torch.cuda.synchronize()
        t = time.perf_counter()
        sys_.track_rgbd(g[0], d[0], g[1], d[1], timestamp=i / 30.0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        states.append(sys_.get_tracking_state())
    traj = sys_.tracker.absolute_trajectory()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)

    n = len(frames)
    tracked = [i for i, (*_, lost) in enumerate(traj) if not lost]
    gt_c = map_gauge_centres(poses_gt[:n])
    est_c = np.stack([np.linalg.inv(np.asarray(T, np.float64))[:3, 3] for _, _, T, _ in traj])
    ate = float(align.ate_rmse(torch.from_numpy(est_c[tracked]), torch.from_numpy(gt_c[tracked])))
    last_err = float(np.linalg.norm(est_c[-1] - gt_c[-1]))
    st = sys_.map
    found = [r for r in relocs if r["ok"]]
    ms = np.asarray(times)
    train_s = sys_.loop_closer.vocab_train_seconds
    print(f"  vocabulary of {sys_.loop_closer.voc.n_words if sys_.loop_closer.voc else 0} words "
          f"trained on the host in {train_s if train_s is not None else float('nan'):.2f} s, "
          f"ready before frame {vocab_at}; blank frames {blank_at}")
    print(f"  states {''.join(str(s) for s in states)} (1 OK, 2 LOST); frames tracked "
          f"{len(tracked)}/{n}, keyframes {int(st.n_kf)}, map points {int(st.n_mp)}, "
          f"keyframes indexed {int(sys_.loop_closer.db.has_bow.sum()) if sys_.loop_closer.db else 0}, "
          f"loop candidates verified {len(sys_.loop_closer.verifications)}, "
          f"loops closed {sys_.loop_closer.n_loops_closed}")
    print(f"  track_rgbd median {np.median(ms):.2f} ms/frame (max {ms.max():.2f}, total "
          f"{ms.sum() / 1e3:.2f} s); ATE over the tracked frames {ate * 1e3:.3f} mm; last pose "
          f"{last_err * 1e3:.2f} mm from ground truth")
    for r in relocs:
        print(f"  relocalize at frame {r['frame']}: found {r['ok']}, {r['inliers']} inliers, "
              f"{r['ms']:.2f} ms, {r['candidates']} candidates tried, {r['host_reads']} host "
              f"reads, {r['window_match']} window_match launches")
    print(f"  kernel launches: {launches}")
    for line in sys_.timing_report().splitlines():
        print(f"    {line}")
    if len(blank_at) != N_BLANK:
        raise AssertionError(f"system-reloc: the vocabulary came too late (frame {vocab_at}) "
                             f"for {N_BLANK} blank frames")
    if any(states[i] != TrackState.LOST for i in blank_at):
        raise AssertionError(f"system-reloc: not LOST on every blank frame: {states}")
    if not found or found[0]["window_match"] < 2:
        raise AssertionError(f"system-reloc: no relocalization succeeded with window_match "
                             f"launched inside it: {relocs}")
    if states[-1] != TrackState.OK or sorted(set(range(n)) - set(tracked)) != blank_at:
        raise AssertionError(f"system-reloc: states {states}, tracked {tracked}")
    if not (last_err < LAST_POSE_LIMIT_M and ate < ATE_LIMIT_M):
        raise AssertionError(f"system-reloc: last pose {last_err:.4f} m, ATE {ate:.4f} m")
    if not bool(torch.isfinite(st.mp_pos[st.mp_valid]).all() and torch.isfinite(st.kf_Tcw).all()):
        raise AssertionError("system-reloc: NaN or inf in a keyframe pose or a map point")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"system-reloc never launched: {missing}")
    profile_relocalize(stash[0])

    # save, load in a fresh System, be found again
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/map.ckpt"
        sys_.save_map(path)
        sys2 = system_mod.System(sensor=system_mod.Sensor.DUAL_RGBD, calib=calib, cfg=cfg)
        sys2.load_map(path)
    same = all(torch.equal(getattr(sys2.map, f), getattr(st, f)) for f in st._fields)
    lost = sys2.get_tracking_state() == TrackState.LOST
    # neither package keeps the vocabulary or the database in a checkpoint,
    # and a LOST tracker inserts no keyframe that would train or fill them:
    # the script hands the vocabulary over and indexes the loaded keyframes
    lc2 = sys2.loop_closer
    lc2.voc = sys_.loop_closer.voc
    lc2.db = database.make_empty_db(cfg.max_kf, lc2.voc.n_words)
    slots = torch.nonzero(sys2.map.kf_valid)[:, 0].tolist()
    for k in slots:
        lc2.db = database.add_keyframe(lc2.db, lc2.voc, sys2.map, k)
    probe = n - 8
    g, d = frames[probe]
    s0 = dict(relocalization.STATS)
    T2 = sys2.track_rgbd(g[0], d[0], g[1], d[1])
    err2 = float(np.linalg.norm(np.linalg.inv(np.asarray(T2, np.float64))[:3, 3] - gt_c[probe]))
    print(f"  save_map -> fresh System -> load_map: every map array equal {same}, state LOST "
          f"{lost}; divergence kept from the reference: a checkpoint holds neither the "
          f"vocabulary nor the database, so the script hands over the vocabulary and indexes "
          f"the {len(slots)} loaded keyframes with add_keyframe; then frame {probe}: state "
          f"{sys2.get_tracking_state()}, {sys2.get_tracked_map_points()} inliers, "
          f"{relocalization.STATS['candidates'] - s0['candidates']} candidates tried, "
          f"{err2 * 1e3:.2f} mm from ground truth")
    if not (same and lost and sys2.get_tracking_state() == TrackState.OK
            and err2 < LAST_POSE_LIMIT_M):
        raise AssertionError("system-reloc: the loaded map did not find the frame again")
    return launches


LOOP_FRAMES = 240
LOOP_H, LOOP_W = 240, 320
LOOP_K = (260.0, 260.0, 160.0, 120.0)
LOOP_DRIFT = 0.15
LOOP_ATE_LIMIT_M = 0.20
LOOP_MAX_LOST = 2
LOOP_GBA_OUTER = 9


def loop_scene(dev):
    """`tests/test_circuit_e2e.py`'s scene from the port's own renderer:
    (calib, cfg, frames on the card, poses)."""
    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.geometry import camera as cam_mod
    from multi_orb_slam_tpu_torch.io import synthetic
    from multi_orb_slam_tpu_torch.ops import orb

    rig = bench_rig(dev)
    calib = cam_mod.CameraParams(
        K=torch.tensor([LOOP_K] * C, device=dev), dist=torch.zeros((C, 5), device=dev),
        T_rc=rig.T_rc, bf=torch.tensor(20.0, device=dev), width=LOOP_W, height=LOOP_H)
    cfg = SlamConfig(n_cams=C, max_feat=512, width=LOOP_W, height=LOOP_H, max_frames_kf=12,
                     th_depth=4.0, local_cap=1024, ba_local_cap=2048,
                     orb=orb.ORBConfig(n_features=512))
    t0 = time.perf_counter()
    world = synthetic.make_box_world(seed=3, n_points=5000, box=(7.0, 4.0, 7.0))
    poses = synthetic.circuit_trajectory(LOOP_FRAMES, radius=2.2, laps=1.25)
    Kc, T_rc = np.asarray(LOOP_K, np.float32), calib.T_rc.cpu().numpy()
    frames = []
    for i, T in enumerate(poses):
        s = i / (LOOP_FRAMES - 1)
        views = [synthetic.render_rgbd(world, Kc, T_rc[c] @ T, LOOP_H, LOOP_W) for c in range(C)]
        g = np.stack([v[0] for v in views]).astype(np.float32)
        d = np.stack([v[1] for v in views]).astype(np.float32)
        if 0.08 <= s < 0.60:     # the depth-scale ramp that makes odometry drift
            d = d * (1.0 + LOOP_DRIFT * np.sin(np.pi * (s - 0.08) / 0.52))
        frames.append((torch.from_numpy(g).to(dev), torch.from_numpy(d).to(dev)))
    torch.cuda.synchronize()
    print(f"loop circuit: {LOOP_FRAMES} frames x {C} cameras at {LOOP_W}x{LOOP_H} rendered in "
          f"{time.perf_counter() - t0:.1f} s (the test's 320x240: the bench's 640x480 circuit-160 "
          f"is not tracked to the end by either package)")
    return calib, cfg, frames, np.asarray(poses, np.float64)


def loop_vocabulary(frames, cfg):
    """k = 10, depth 4, 3 iterations from camera-0 ORB of every 8th frame:
    ORB on the card, the k-medians training on the host, as the package
    trains it."""
    from multi_orb_slam_tpu_torch.ops import orb
    from multi_orb_slam_tpu_torch.placerec import vocabulary

    t0 = time.perf_counter()
    feats = [orb.extract_orb(frames[i][0][0], cfg.orb) for i in range(0, len(frames), 8)]
    descs = np.concatenate([f.desc[f.valid].cpu().numpy() for f in feats])
    voc = vocabulary.build_vocabulary(descs, k=10, depth=4, iters=3)
    print(f"  vocabulary of {voc.n_words} words from {len(descs)} descriptors of {len(feats)} "
          f"frames in {time.perf_counter() - t0:.2f} s")
    return voc


def gba_device_ms(state, calib, cfg):
    """Device time of one global BA on `state`, summed over its kernels from
    `torch.profiler`, and the number of device operations."""
    from multi_orb_slam_tpu_torch.optim import global_ba

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        global_ba.dispatch_global_ba(state, calib, cfg, n_outer=LOOP_GBA_OUTER)
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    kernels = [k for e in prof.events() if e.device_type == cpu for k in e.kernels]
    return sum(k.duration for k in kernels) / 1e3, len(kernels)


def phase_system_loop(dev):
    """The loop path: the circuit through `System` with loop closing and
    global BA; returns its launch counts."""
    from multi_orb_slam_tpu_torch import system as system_mod
    from multi_orb_slam_tpu_torch.geometry import align
    from multi_orb_slam_tpu_torch.loop import loop_closing
    from multi_orb_slam_tpu_torch.ops import kernels
    from multi_orb_slam_tpu_torch.optim import global_ba, pose_graph
    from multi_orb_slam_tpu_torch.placerec import database

    calib, cfg, frames, poses_gt = loop_scene(dev)
    print(f"system-loop: System(DUAL_RGBD) on the card, unpipelined, mapping and loop closing "
          f"on, run_gba=True; the test's make_cfg() (512 features, max_frames_kf=12, "
          f"th_depth=4.0, local_cap=1024, ba_local_cap=2048, max_kf {cfg.max_kf}, max_mp "
          f"{cfg.max_mp})")
    voc = loop_vocabulary(frames, cfg)
    sys_ = system_mod.System(sensor=system_mod.Sensor.DUAL_RGBD, calib=calib, cfg=cfg)
    lc = sys_.loop_closer
    lc.voc, lc.db = voc, database.make_empty_db(cfg.max_kf, voc.n_words)

    # host clocks of the loop stages, read per closing keyframe
    stages = collections.defaultdict(list)

    def timed(name, fn, sync_after=True):
        def inner(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            if sync_after:
                torch.cuda.synchronize()
            stages[name].append({"frame": sys_.tracker.frame_id,
                                 "ms": (time.perf_counter() - t) * 1e3})
            return out
        return inner

    enqueue = global_ba.dispatch_global_ba

    def dispatch(*a, **k):
        t = time.perf_counter()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = enqueue(*a, **k)
        e1.record()
        stages["dispatch_global_ba"].append({"frame": sys_.tracker.frame_id, "events": (e0, e1),
                                             "ms": (time.perf_counter() - t) * 1e3})
        return out

    merge = lc.merge_pending_gba

    def merge_timed(state):
        if lc._gba_pending is None:
            return merge(state)
        return timed("merge_pending_gba", merge)(state)

    lc._compute_sim3 = timed("compute_sim3", lc._compute_sim3)
    # host time until it returns: the global BA at its end is only enqueued
    lc._correct_loop = timed("correct_loop", lc._correct_loop, sync_after=False)
    lc.merge_pending_gba = merge_timed
    patched = [(pose_graph, "optimize_essential_graph",
                timed("pose_graph", pose_graph.optimize_essential_graph)),
               (global_ba, "dispatch_global_ba", dispatch)]
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    for mod, name, fn in patched:
        setattr(mod, name, fn)
    roles0 = dict(loop_closing.STATS)
    states, times = [], []
    try:
        kernels.reset_launch_counts()
        for i, (g, d) in enumerate(frames):
            torch.cuda.synchronize()
            t = time.perf_counter()
            sys_.track_rgbd(g[0], d[0], g[1], d[1], timestamp=i / 30.0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            states.append(sys_.get_tracking_state())
        sys_.shutdown()
        traj = sys_.tracker.absolute_trajectory()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    roles = {k: v - roles0[k] for k, v in loop_closing.STATS.items()}

    lost = [i for i, (*_, is_lost) in enumerate(traj) if is_lost]
    fids = [fid for fid, *_ in traj]
    est = np.stack([np.linalg.inv(np.asarray(T, np.float64))[:3, 3] for _, _, T, _ in traj])
    gt = np.stack([np.linalg.inv(poses_gt[min(f, LOOP_FRAMES - 1)])[:3, 3] for f in fids])
    ate = float(align.ate_rmse(torch.from_numpy(est), torch.from_numpy(gt)))
    gt_c = map_gauge_centres(poses_gt)
    last_err = float(np.linalg.norm(est[-1] - gt_c[fids[-1]]))
    st = sys_.map
    ms_ = np.asarray(times)
    print(f"  states {''.join(str(x) for x in states)} (1 OK, 2 LOST)")
    print(f"  frames tracked {len(traj) - len(lost)}/{len(traj)} (lost {lost}), keyframes "
          f"{int(st.n_kf)}, map points {int(st.n_mp)}, loop candidates verified "
          f"{len(lc.verifications)}; track_rgbd median {np.median(ms_):.2f} ms/frame (max "
          f"{ms_.max():.2f}, total {ms_.sum() / 1e3:.2f} s)")
    for v in lc.verifications:
        print(f"  verification at keyframe frame {v['frame']}: kf_a {v['kf_a']} kf_b {v['kf_b']}, "
              f"BoW pairs {v['bow']}, RANSAC inliers {v['ransac']}, LM inliers {v['lm']}, total "
              f"{v['total']}, closed {v['accepted']}")
    gba_ms = []
    for rec in stages["dispatch_global_ba"]:
        e0, e1 = rec.pop("events")
        gba_ms.append(e0.elapsed_time(e1))
    for name in ("compute_sim3", "correct_loop", "pose_graph", "dispatch_global_ba",
                 "merge_pending_gba"):
        rows = stages[name]
        shown = [f"{r['ms']:.2f} at frame {r['frame']}" for r in rows]
        print(f"  host ms of {name}: {', '.join(shown) if shown else 'never called'}")
    print(f"  global BA on the device, events from before its dispatch to after its last "
          f"launch: {', '.join(f'{x:.2f} ms' for x in gba_ms) or 'none'}")
    print(f"  n_loops_closed {lc.n_loops_closed}, n_gba_merged {lc.n_gba_merged} after "
          f"shutdown(); ATE over all {len(traj)} frames {ate:.4f} m, last pose {last_err:.4f} m "
          f"from ground truth")
    print(f"  window_match launches by loop role: {roles}")
    print(f"  kernel launches: {launches}")
    for line in sys_.timing_report().splitlines():
        print(f"    {line}")

    # the dispatch once more on a copy of the final map: no host synchronisation
    copy = type(st)(*[v.clone() for v in st])
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        Tcw_g, pos_g = global_ba.dispatch_global_ba(copy, calib, cfg, n_outer=LOOP_GBA_OUTER)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    done_ms = (time.perf_counter() - t) * 1e3
    finite = bool(torch.isfinite(Tcw_g).all() and torch.isfinite(pos_g[copy.mp_valid]).all())
    dev_ms, n_ops = gba_device_ms(copy, calib, cfg)
    print(f"  dispatch_global_ba under torch.cuda.set_sync_debug_mode('error'): no host "
          f"synchronisation; returned after {host_ms:.2f} ms of host time, done on the device "
          f"{done_ms:.2f} ms after the call; result finite {finite}; under torch.profiler "
          f"{n_ops} device operations, {dev_ms:.3f} ms of device time")

    failures = []
    if len(lost) > LOOP_MAX_LOST:
        failures.append(f"{len(lost)} of {len(traj)} frames lost")
    if lc.n_loops_closed < 1 or lc.n_gba_merged < 1:
        failures.append(f"{lc.n_loops_closed} loops closed, {lc.n_gba_merged} GBAs merged")
    if not ate < LOOP_ATE_LIMIT_M:
        failures.append(f"ATE {ate:.4f} m >= {LOOP_ATE_LIMIT_M} m")
    if any(v <= 0 for v in roles.values()):
        failures.append(f"a loop role never launched window_match: {roles}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        failures.append(f"never launched: {missing}")
    if not (finite and bool(torch.isfinite(st.kf_Tcw).all())):
        failures.append("NaN or inf in a pose or a point")
    if failures:
        raise AssertionError("system-loop: " + "; ".join(failures))
    return launches


# ---------------------------------------------------------------------------
# The stereo sensor at KITTI's size, the drivers, the mono initializer
# ---------------------------------------------------------------------------

KITTI_H, KITTI_W, KITTI_FEATURES = 376, 1241, 2000
KITTI_K = (718.856, 718.856, 607.1928, 185.2157)
KITTI_BF = 386.1448
KITTI_FRAMES = 30
KITTI_BOX, KITTI_POINTS = (12.0, 4.0, 12.0), 16000
STEREO_ATE_LIMIT_M = 0.05
# ORB-SLAM2's Examples/Stereo/KITTI00-02.yaml
KITTI_YAML = """%YAML:1.0
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 1241
Camera.height: 376
Camera.fps: 10.0
Camera.bf: 386.1448
Camera.RGB: 1
ThDepth: 35
ORBextractor.nFeatures: 2000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""
DRIVER_FRAMES = 60
DRIVER_DEPTH_FACTOR = 1000.0       # configs/multi.yaml's DepthMapFactor
LIVE_FRAMES = 20
REPO_DIR = pathlib.Path(__file__).resolve().parent


def phase_kitti_shapes(dev, rng):
    """The three kernels at the stereo path's shapes: `fast_score` on the
    [2 x 8, 376, 1241] canvas (1241 is no multiple of 4: scalar loads),
    `gather_patches` of 4000 patches from it, `window_match` at C = 1,
    Q = F = 2000 (two 1024-feature tiles, the second partial), gated and
    dense.  Each bit-equal to its plain version."""
    from multi_orb_slam_tpu_torch.ops import kernels, orb

    out = {}
    shapes = orb.pyramid_shapes(KITTI_H, KITTI_W, orb.ORBConfig(n_features=KITTI_FEATURES))
    print(f"KITTI pyramid level shapes (H, W): {shapes}")
    extents = shapes * 2
    canvas = torch.from_numpy(rng.uniform(0, 255, (16, KITTI_H, KITTI_W)).astype(np.float32)).to(dev)
    got, want = kernels.fast_score(canvas, extents), kernels.fast_score_plain(canvas, extents)
    torch.cuda.synchronize()
    err, equal = float((got - want).abs().max()), bool(torch.equal(got, want))
    print(f"fast_score [16, {KITTI_H}, {KITTI_W}] (stereo path): bit-equal {equal}, max |diff| {err}")
    if not equal:
        raise AssertionError("fast_score kernel differs from its plain version at the KITTI canvas")
    live = sum(h * w for h, w in extents)
    out["fast_score"] = report(
        "fast_score", err, kernel_clocks(lambda: kernels.fast_score(canvas, extents), "fast_score"),
        cuda_ms(lambda: kernels.fast_score_plain(canvas, extents)), None,
        4 * live + 4 * canvas.numel(), 136 * live)

    side, N = 45, 2 * KITTI_FEATURES
    idx = torch.from_numpy(np.stack([
        rng.randint(0, 16, N), rng.randint(0, KITTI_H - side + 1, N),
        rng.randint(0, KITTI_W - side + 1, N)], axis=1).astype(np.int32)).to(dev)
    got, want = kernels.gather_patches(canvas, idx, side), kernels.gather_patches_plain(canvas, idx, side)
    torch.cuda.synchronize()
    err, equal = float((got - want).abs().max()), bool(torch.equal(got, want))
    print(f"gather_patches [{N}, {side}, {side}] from [16, {KITTI_H}, {KITTI_W}] (stereo path): "
          f"bit-equal {equal}, max |diff| {err}")
    if not equal:
        raise AssertionError("gather_patches kernel differs from its plain version at 4000 patches")
    d = torch.arange(side, device=dev)
    ib, iy = idx[:, 0].long()[:, None, None], (idx[:, 1].long()[:, None] + d)[:, :, None]
    ix = (idx[:, 2].long()[:, None] + d)[:, None, :]
    out_bytes = 4 * N * side * side
    out["gather_patches"] = report(
        "gather_patches", err,
        kernel_clocks(lambda: kernels.gather_patches(canvas, idx, side), "gather_patches"),
        cuda_ms(lambda: kernels.gather_patches_plain(canvas, idx, side)),
        cuda_ms(lambda: canvas[ib, iy, ix]),
        out_bytes + min(out_bytes, 4 * canvas.numel()) + 4 * idx.numel(), 0)

    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    Q = F = KITTI_FEATURES
    q_lmin = rng.randint(-1, 7, (1, Q)).astype(np.int32)
    gated = (
        T(rng.uniform(0, KITTI_W, (1, Q, 2)).astype(np.float32)),
        T(np.where(rng.rand(1, Q) < 0.9, rng.uniform(5, 40, (1, Q)), -1.0).astype(np.float32)),
        T(q_lmin), T(q_lmin + 2),
        T(np.where(rng.rand(1, Q) < 0.5, rng.uniform(0, KITTI_W, (1, Q)), -1e9).astype(np.float32)),
        T(rng.randint(-2**31, 2**31, (1, Q, 8), dtype=np.int64).astype(np.int32)),
        T(rng.uniform(0, KITTI_W, (1, F, 2)).astype(np.float32)),
        T(np.where(rng.rand(1, F) < 0.7, rng.uniform(0, KITTI_W, (1, F)), -1).astype(np.float32)),
        T(rng.randint(0, 8, (1, F)).astype(np.int32)), T(rng.rand(1, F) < 0.9),
        T(rng.randint(-2**31, 2**31, (1, F, 8), dtype=np.int64).astype(np.int32)))
    dense = (
        torch.zeros((1, Q, 2), device=dev),
        T(np.where(rng.rand(1, Q) < 0.9, np.inf, -1.0).astype(np.float32)),
        torch.full((1, Q), -1, dtype=torch.int32, device=dev),
        torch.full((1, Q), 1 << 30, dtype=torch.int32, device=dev),
        torch.full((1, Q), -1e9, device=dev), gated[5],
        torch.zeros((1, F, 2), device=dev), torch.full((1, F), -1.0, device=dev),
        torch.zeros((1, F), dtype=torch.int32, device=dev), gated[9], gated[10])
    out["window_match"] = {}
    for label, a in (("gated", gated), ("dense", dense)):
        e = hold_window_match(f"{label} C=1 Q={Q} F={F} (stereo path)", a)
        out["window_match"][label] = report(
            "window_match", e, kernel_clocks(lambda: kernels.window_match(*a), "window_match"),
            cuda_ms(lambda: kernels.window_match_plain(*a)), None, *window_match_work(a))
    return out


def run_driver(main_fn, argv):
    """`main_fn(argv)` (a driver's `main`, or its `run`, which also returns
    the System) with its standard output captured and echoed; returns (what
    it returned, the output, host seconds)."""
    import contextlib
    import io

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"    | {line}")
    return rc, text, dt


def median_tracking_ms(text, label="median tracking time"):
    """A driver's printed median (`label`: ... seconds), in ms."""
    for line in text.splitlines():
        if line.startswith(label + ":"):
            return float(line.split(":")[1]) * 1e3
    raise AssertionError(f"the driver printed no {label}")


def median_frame_ms(text):
    return median_tracking_ms(text, "median frame time (read + track)")


def centre_ate(est_centres, poses_gt):
    from multi_orb_slam_tpu_torch.geometry import align

    gt = np.stack([np.linalg.inv(np.asarray(T, np.float64))[:3, 3] for T in poses_gt])
    return float(align.ate_rmse(torch.from_numpy(np.asarray(est_centres, np.float64)),
                                torch.from_numpy(gt)))


def write_kitti_sequence(root, n):
    """A KITTI-layout stereo sequence from the port's renderer: `image_0`,
    `image_1` (the right camera shifted by the baseline bf / fx), `times.txt`
    at 10 fps.  Returns (poses, frame 0's rendered depth, render seconds)."""
    import os

    from multi_orb_slam_tpu_torch.io import png, synthetic

    os.makedirs(f"{root}/image_0")
    os.makedirs(f"{root}/image_1")
    world = synthetic.make_box_world(seed=0, n_points=KITTI_POINTS, box=KITTI_BOX)
    poses = synthetic.orbit_trajectory(n)
    K = np.asarray(KITTI_K, np.float32)
    T_lr = np.eye(4, dtype=np.float32)
    T_lr[0, 3] = -KITTI_BF / KITTI_K[0]
    render_s, depth0 = 0.0, None
    for i in range(n):
        t = time.perf_counter()
        gl, dl = synthetic.render_rgbd(world, K, poses[i], KITTI_H, KITTI_W)
        gr, _ = synthetic.render_rgbd(world, K, T_lr @ poses[i], KITTI_H, KITTI_W)
        render_s += time.perf_counter() - t
        depth0 = dl if depth0 is None else depth0
        png.write_png(f"{root}/image_0/{i:06d}.png", np.clip(gl, 0, 255).astype(np.uint8))
        png.write_png(f"{root}/image_1/{i:06d}.png", np.clip(gr, 0, 255).astype(np.uint8))
    with open(f"{root}/times.txt", "w") as f:
        f.write("".join(f"{i / 10.0:.6e}\n" for i in range(n)))
    return poses, depth0, render_s


def stereo_frame_split(root, calib, orb_cfg, depth0):
    """Frame 0 through `build_frame_stereo`'s three parts on the card, each
    timed alone (CUDA synchronise around it, median of 5), and its depth
    against the rendered one.  Returns (fraction of valid left keypoints
    with a depth, median relative depth error)."""
    from multi_orb_slam_tpu_torch.frontend import frame
    from multi_orb_slam_tpu_torch.io import png
    from multi_orb_slam_tpu_torch.ops import orb, stereo

    gl, gr = (torch.from_numpy(png.read_gray(f"{root}/image_{c}/000000.png").astype(np.float32))
              .to(calib.K.device) for c in (0, 1))

    def timed(fn):
        out, ts = None, []
        for _ in range(6):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return out, float(np.median(ts[1:]))

    feats, t_ex = timed(lambda: orb.extract_orb(torch.stack([gl, gr]), orb_cfg))
    fl, fr_ = (orb.Features(*(v[c] for v in feats)) for c in (0, 1))
    (_, ur), t_match = timed(lambda: stereo.stereo_match_depth(fl, fr_, calib.bf, orb_cfg.scale_factor))
    _, t_sub = timed(lambda: stereo.subpixel_refine(gl, gr, fl.xy[:, 0], fl.xy[:, 1], ur, calib.bf))
    fr, t_all = timed(lambda: frame.build_frame_stereo(gl, gr, calib, orb_cfg))
    depth = fr.depth[0].cpu().numpy()
    valid = fr.valid[0].cpu().numpy()
    xy = fr.xy[0].cpu().numpy()
    has = valid & (depth > 0)
    gt = depth0[np.clip(np.round(xy[:, 1]).astype(int), 0, KITTI_H - 1),
                np.clip(np.round(xy[:, 0]).astype(int), 0, KITTI_W - 1)]
    ok = has & (gt > 0)
    rel = float(np.median(np.abs(depth[ok] - gt[ok]) / gt[ok])) if ok.any() else float("inf")
    frac = float(has.sum() / max(valid.sum(), 1))
    print(f"  build_frame_stereo on frame 0, ms (synchronised, median of 5): extraction of both "
          f"images {t_ex:.2f}, stereo match {t_match:.2f}, subpixel {t_sub:.2f}; the whole "
          f"frame {t_all:.2f}")
    print(f"  frame 0: {int(valid.sum())} valid left keypoints, {int(has.sum())} with a stereo "
          f"depth ({frac:.1%}), median relative depth error {rel:.4f} against the rendered depth "
          f"at {int(ok.sum())} of them")
    return frac, rel


def capacity_fill(slam):
    """How full the stereo map's capacities are at the end of the run."""
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.mapping import local_mapping

    st, cfg, kf = slam.map, slam.cfg, slam.tracker.last_kf_slot
    pts = tracking.build_local_points_cache(st, kf, cfg)
    prob = local_mapping.build_local_problem(st, kf, cfg, cfg.ba_free_kfs, cfg.ba_fixed_kfs)
    n_local, n_ba = int(pts.valid.sum()), int((prob.mp_slot >= 0).sum())
    print(f"  capacities at the end: map points {int(st.n_mp)} of max_mp {cfg.max_mp}; keyframes "
          f"{int(st.n_kf)} of {cfg.max_kf}; local-map points of the newest keyframe {n_local} "
          f"(local_cap {cfg.local_cap} kept per frame, {4 * cfg.local_cap} gathered); its "
          f"local-BA window's points {n_ba} of ba_local_cap {cfg.ba_local_cap}"
          f"{' (FULL: truncated)' if n_ba >= cfg.ba_local_cap else ''}")


def phase_system_stereo(dev):
    """The stereo path at KITTI's size through the KITTI driver; returns its
    launch counts."""
    import os

    from multi_orb_slam_tpu_torch.drivers import stereo_kitti
    from multi_orb_slam_tpu_torch.ops import kernels
    from multi_orb_slam_tpu_torch.optim import local_ba

    with tempfile.TemporaryDirectory() as tmp:
        root, settings, out = f"{tmp}/kitti", f"{tmp}/KITTI00-02.yaml", f"{tmp}/traj_kitti.txt"
        poses, depth0, render_s = write_kitti_sequence(root, KITTI_FRAMES)
        print(f"system-stereo: {KITTI_FRAMES} stereo pairs at {KITTI_W}x{KITTI_H} (the orbit in a "
              f"{KITTI_BOX} box of {KITTI_POINTS} squares, baseline {KITTI_BF / KITTI_K[0]:.4f} m) "
              f"rendered in {render_s:.1f} s ({render_s / (2 * KITTI_FRAMES):.3f} s an image) and "
              f"written with io/png.py; settings of ORB-SLAM2's KITTI00-02.yaml")
        with open(settings, "w") as f:
            f.write(KITTI_YAML)
        ba0 = local_ba.STATS["solves"]
        kernels.reset_launch_counts()
        (rc, slam), text, secs = run_driver(stereo_kitti.run, [settings, root, "--out", out])
        launches = dict(kernels.LAUNCHES)
        solves = local_ba.STATS["solves"] - ba0
        frac, rel = stereo_frame_split(root, slam.calib, slam.cfg.orb, depth0)
        rows = [np.array([float(v) for v in line.split()]).reshape(3, 4)
                for line in open(out).read().splitlines() if line.strip()]
        print(f"  the driver's run took {secs:.1f} s; pngs {len(os.listdir(root + '/image_0'))} a side")
    traj = slam.tracker.absolute_trajectory()
    lost = [i for i, (*_, is_lost) in enumerate(traj) if is_lost]
    centres = np.stack([r[:, 3] for r in rows]) if rows else np.zeros((0, 3))
    finite = bool(np.isfinite(centres).all())
    ate = centre_ate(centres, poses) if len(rows) == KITTI_FRAMES else float("inf")
    med = median_tracking_ms(text)
    print(f"  frames tracked {len(traj) - len(lost)}/{KITTI_FRAMES} (lost {lost}), trajectory "
          f"lines {len(rows)}, keyframes {int(slam.map.n_kf)}, local BAs {solves}; ATE "
          f"{ate * 1e3:.3f} mm; track_stereo median {med:.2f} ms/frame, a whole frame (reading "
          f"and decoding both PNGs, then tracking) median {median_frame_ms(text):.2f} ms")
    capacity_fill(slam)
    print(f"  kernel launches: {launches}")
    failures = []
    if rc != 0 or lost or len(rows) != KITTI_FRAMES:
        failures.append(f"rc {rc}, lost {lost}, {len(rows)} trajectory lines")
    if not finite:
        failures.append("NaN in a pose")
    if not ate < STEREO_ATE_LIMIT_M:
        failures.append(f"ATE {ate:.4f} m >= {STEREO_ATE_LIMIT_M} m")
    if not (frac >= 0.40 and rel < 0.05):
        failures.append(f"frame 0: {frac:.1%} of keypoints with depth, median error {rel:.4f}")
    need = ["fast_score", "gather_patches", "window_match"] + (["point_sums"] if solves else [])
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        failures.append(f"never launched: {missing}")
    if failures:
        raise AssertionError("system-stereo: " + "; ".join(failures))
    return launches


def write_tum_rig_sequence(root, n):
    """`tools/make_tum_dataset.py`'s layout for the real rig of
    `configs/calibration.txt`, at `configs/multi.yaml`'s intrinsics: rgb/,
    depth/, rgb2/, depth2/ (depth PNGs at DepthMapFactor 1000),
    associations.txt, associations2.txt.  Returns the rig poses."""
    import os

    from multi_orb_slam_tpu_torch.io import config_io, png, synthetic

    st = config_io.load_settings(str(REPO_DIR / "configs/multi.yaml"), n_cams=1)
    T_cam12 = config_io.load_calibration(str(REPO_DIR / "configs/calibration.txt"))
    T_rc = np.stack([np.eye(4, dtype=np.float32), np.linalg.inv(T_cam12).astype(np.float32)])
    t = time.perf_counter()
    seq = synthetic.make_sequence(n_frames=n, K=st.K[0], T_rc=T_rc, height=st.height,
                                  width=st.width, n_points=4000)
    render_s = time.perf_counter() - t
    t = time.perf_counter()
    assoc = ([], [])
    for sub in ("rgb", "depth", "rgb2", "depth2"):
        os.makedirs(f"{root}/{sub}")
    for i, (grays, depths) in enumerate(zip(seq.grays, seq.depths)):
        ts = seq.timestamps[i]
        name = f"{ts:.6f}.png"
        for c, (rgb, dep) in enumerate((("rgb", "depth"), ("rgb2", "depth2"))):
            png.write_png(f"{root}/{rgb}/{name}", np.clip(grays[c], 0, 255).astype(np.uint8))
            png.write_png(f"{root}/{dep}/{name}", np.clip(
                depths[c] * DRIVER_DEPTH_FACTOR, 0, 65535).astype(np.uint16))
            assoc[c].append(f"{ts:.6f} {rgb}/{name} {ts:.6f} {dep}/{name}")
    for c, fname in enumerate(("associations.txt", "associations2.txt")):
        with open(f"{root}/{fname}", "w") as f:
            f.write("\n".join(assoc[c]) + "\n")
    print(f"driver-rgbd: {n} frames x 2 cameras at {st.width}x{st.height} (configs/multi.yaml's "
          f"K, configs/calibration.txt's rig) rendered in {render_s:.1f} s, written with "
          f"io/png.py in {time.perf_counter() - t:.1f} s")
    return seq.poses_gt


def tum_centres(path):
    from multi_orb_slam_tpu_torch.io import tum

    traj = tum.read_trajectory_tum(path)
    return [Twc[:3, 3] for _, Twc in sorted(traj.items())]


def native_loader_run(root, poses, tmp):
    """The native loader: build it once, report, and if it built, hold its
    frames to io/png.py's and drive the single-camera form with it."""
    from multi_orb_slam_tpu_torch.drivers import rgbd_tum
    from multi_orb_slam_tpu_torch.io import native_loader, png

    t = time.perf_counter()
    built = native_loader.native_available()
    print(json.dumps({"native_loader": {"built": built, "error": native_loader.build_error(),
                                        "seconds": round(time.perf_counter() - t, 2)}}))
    if not built:
        return
    pairs = rgbd_tum.load_assoc_pairs(f"{root}/associations.txt")
    items = [(f"{root}/{r}", f"{root}/{d}") for _, r, _, d in pairs]
    loader = native_loader.AsyncRGBDLoader(items, 480, 640, depth_factor=DRIVER_DEPTH_FACTOR)
    worst, t_png, t_native = 0.0, 0.0, time.perf_counter()
    try:
        for (gray, depth), (r, d) in zip(loader, items):
            t = time.perf_counter()
            g_ref = png.read_gray(r).astype(np.float32)
            d_ref = png.read_png(d).astype(np.float32) * np.float32(1.0 / DRIVER_DEPTH_FACTOR)
            t_png += time.perf_counter() - t
            if not np.array_equal(gray, g_ref):
                raise AssertionError(f"native loader: grey of {r} differs from io/png.py's")
            rel = np.abs(depth - d_ref) / np.maximum(np.abs(d_ref), 1e-30)
            worst = max(worst, float(rel[d_ref > 0].max(initial=0.0)))
            if (depth[d_ref == 0] != 0).any() or worst > 1e-6:
                raise AssertionError(f"native loader: depth of {d} differs by {worst:.2e}")
    finally:
        loader.close()
    t_native = time.perf_counter() - t_native - t_png
    print(f"  native loader: {len(items)} frames equal to io/png.py's (grey exactly, depth within "
          f"{worst:.2e} relative); host s for all frames: native {t_native:.2f} (prefetching), "
          f"io/png.py {t_png:.2f} ({t_png / len(items) * 1e3:.1f} ms a grey + depth pair)")
    out, kf_out = f"{tmp}/native.txt", f"{tmp}/native_kf.txt"
    rc, text, _ = run_driver(rgbd_tum.main, [
        str(REPO_DIR / "configs/multi.yaml"), root, f"{root}/associations.txt", "--native-loader",
        "--pipelined", "--no-realtime", "--out", out, "--kf-out", kf_out])
    centres = tum_centres(out)
    ate = centre_ate(centres, poses) if len(centres) == len(poses) else float("inf")
    print(f"  single camera, native loader, pipelined: {len(centres)}/{len(poses)} frames tracked, "
          f"ATE {ate * 1e3:.3f} mm, median {median_tracking_ms(text):.2f} ms/frame")
    if rc != 0 or "using native async loader" not in text or not ate < ATE_LIMIT_M:
        raise AssertionError(f"driver-rgbd (native loader): rc {rc}, {len(centres)} frames, "
                             f"ATE {ate:.4f} m")


def png_decode_ms(tmp):
    """{filter: host ms} to decode a 640x480 8-bit image of the rendered
    scene written with that row filter for every row, and a 16-bit depth
    image written with Paeth."""
    from multi_orb_slam_tpu_torch.io import png, synthetic

    world = synthetic.make_box_world(seed=0, n_points=4000)
    g, d = synthetic.render_rgbd(world, np.array([522.6, 522.6, 320.0, 240.0], np.float32),
                                 np.eye(4, dtype=np.float32), 480, 640)
    images = {name: (np.clip(g, 0, 255).astype(np.uint8), ft) for name, ft in (
        ("none", png.NONE), ("sub", png.SUB), ("up", png.UP), ("average", png.AVERAGE),
        ("paeth", png.PAETH))}
    images["paeth, 16-bit depth"] = (np.clip(d * DRIVER_DEPTH_FACTOR, 0, 65535).astype(np.uint16),
                                     png.PAETH)
    out = {}
    for name, (img, ft) in images.items():
        path = f"{tmp}/decode.png"
        png.write_png(path, img, ft)
        best = float("inf")
        for _ in range(3):
            t = time.perf_counter()
            back = png.read_png(path)
            best = min(best, (time.perf_counter() - t) * 1e3)
        if not np.array_equal(back, img):
            raise AssertionError(f"io/png.py: the {name} image did not come back")
        out[name] = round(best, 2)
    return out


def phase_driver_rgbd(dev):
    """The TUM driver on the dual rig with `System(pipelined=True)`; returns
    its launch counts."""
    from multi_orb_slam_tpu_torch.drivers import rgbd_tum
    from multi_orb_slam_tpu_torch.io import png
    from multi_orb_slam_tpu_torch.ops import kernels

    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/seq"
        poses = write_tum_rig_sequence(root, DRIVER_FRAMES)
        print(f"  io/png.py, host ms to decode one 640x480 image (the best of 3), every row "
              f"written with the filter named: {png_decode_ms(tmp)}")
        out, kf_out = f"{tmp}/traj.txt", f"{tmp}/kf.txt"
        kernels.reset_launch_counts()
        (rc, slam), text, secs = run_driver(rgbd_tum.run, [
            str(REPO_DIR / "configs/multi.yaml"), root, f"{root}/associations.txt",
            "--assoc2", f"{root}/associations2.txt",
            "--calibration", str(REPO_DIR / "configs/calibration.txt"),
            "--pipelined", "--no-realtime", "--out", out, "--kf-out", kf_out])
        launches = dict(kernels.LAUNCHES)
        centres, kfs = tum_centres(out), tum_centres(kf_out)
        ate = centre_ate(centres, poses) if len(centres) == DRIVER_FRAMES else float("inf")
        med = median_tracking_ms(text)
        print(f"  System(pipelined={slam.tracker.pipelined}): trajectory lines {len(centres)}, "
              f"keyframe lines {len(kfs)}, map points {int(slam.map.n_mp)}, ATE {ate * 1e3:.3f} mm, "
              f"track_rgbd median {med:.2f} ms/frame, a whole frame (reading and decoding four "
              f"PNGs, then tracking) median {median_frame_ms(text):.2f} ms; the driver's run "
              f"{secs:.1f} s")
        print(f"  kernel launches: {launches}")
        for line in slam.timing_report().splitlines():
            print(f"    {line}")
        missing = [k for k, v in launches.items() if v <= 0]
        if (rc != 0 or len(centres) != DRIVER_FRAMES or len(kfs) < 1 or not ate < ATE_LIMIT_M
                or missing or not slam.tracker.pipelined):
            raise AssertionError(f"driver-rgbd: rc {rc}, {len(centres)} frames, {len(kfs)} "
                                 f"keyframes, ATE {ate:.4f} m, never launched {missing}")
        native_loader_run(root, poses, tmp)
        pipelined_ab(root, poses, tmp)
    return launches


def pipelined_ab(root, poses, tmp):
    """The same 60 frames through the TUM driver without and with
    `--pipelined`, in turns (off, on, on, off), after the counted run above
    has warmed the card: each run's median tracking and whole-frame times.
    Every run must track every frame under the ATE limit."""
    from multi_orb_slam_tpu_torch.drivers import rgbd_tum

    runs = []
    for pipelined in (False, True, True, False):
        out = f"{tmp}/ab.txt"
        rc, text, secs = run_driver(rgbd_tum.main, [
            str(REPO_DIR / "configs/multi.yaml"), root, f"{root}/associations.txt",
            "--assoc2", f"{root}/associations2.txt",
            "--calibration", str(REPO_DIR / "configs/calibration.txt"), "--no-realtime",
            "--out", out, "--kf-out", f"{tmp}/ab_kf.txt"] + (["--pipelined"] if pipelined else []))
        centres = tum_centres(out)
        ate = centre_ate(centres, poses) if len(centres) == len(poses) else float("inf")
        runs.append({"pipelined": pipelined, "track_median_ms": round(median_tracking_ms(text), 2),
                     "track_mean_ms": round(median_tracking_ms(text, "mean tracking time"), 2),
                     "frame_median_ms": round(median_frame_ms(text), 2), "run_s": round(secs, 2),
                     "ate_mm": round(ate * 1e3, 3)})
        if rc != 0 or not ate < ATE_LIMIT_M:
            raise AssertionError(f"driver-rgbd, pipelined={pipelined}: rc {rc}, "
                                 f"{len(centres)} frames, ATE {ate:.4f} m")
    print(json.dumps({"pipelined_ab": runs}))


def phase_driver_live(dev):
    from multi_orb_slam_tpu_torch.drivers import live_rgbd

    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/live.txt"
        rc, text, secs = run_driver(live_rgbd.main, ["--selftest", "--out", out])
        n = len(tum_centres(out))
    print(f"driver-live: self-test through a local socket, {n}/{LIVE_FRAMES} frames tracked on "
          f"the card in {secs:.1f} s")
    if rc != 0 or n != LIVE_FRAMES or f"tracked {LIVE_FRAMES} streamed frames" not in text:
        raise AssertionError(f"driver-live: rc {rc}, {n} frames tracked")


def two_views(planar, n=300, noise=0.3, outliers=0.1, seed=0):
    """`tests/test_mono_init.py`'s two-view problems (K 500/500/320/240, a
    general scene or a rough tilted plane, 10% gross outliers)."""
    from multi_orb_slam_tpu_torch.geometry import se3

    K = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
    rng = np.random.RandomState(seed)
    X = rng.uniform([-2, -1.5, 4.0], [2, 1.5, 8.0], (n, 3)).astype(np.float32)
    if planar:
        X[:, 2] = 6.0 + 0.3 * X[:, 0] + 0.1 * X[:, 1] + rng.randn(n).astype(np.float32) * 0.05
    R = se3.so3_exp(torch.tensor([0.02, 0.12, -0.03])).numpy()
    t = np.array([0.4, 0.05, 0.1], np.float32)
    t = t / np.linalg.norm(t)

    def project(R_, t_):
        Xc = X @ R_.T + t_
        return np.stack([K[0] * Xc[:, 0] / Xc[:, 2] + K[2], K[1] * Xc[:, 1] / Xc[:, 2] + K[3]], -1), Xc[:, 2]

    uv1, z1 = project(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    uv2, z2 = project(R, t)
    uv1 += rng.randn(n, 2) * noise
    uv2 += rng.randn(n, 2) * noise
    n_out = int(n * outliers)
    idx = rng.choice(n, n_out, replace=False)
    uv2[idx] += rng.uniform(20, 80, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return (uv1.astype(np.float32), uv2.astype(np.float32), (z1 > 0) & (z2 > 0), K, R)


def phase_mono_init(dev):
    """The two-view initializer on the card and on the CPU, on the same
    draws, on both scenes."""
    from multi_orb_slam_tpu_torch.frontend import initializer

    for planar, seed in ((False, 0), (True, 1)):
        uv1, uv2, mask, K, R_true = two_views(planar)
        idx_h, idx_f = initializer.sample_hypotheses(torch.from_numpy(mask), 256,
                                                     torch.Generator().manual_seed(seed))
        res = {}
        for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
            T = lambda a: torch.from_numpy(np.asarray(a)).to(d)  # noqa: E731
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = initializer.solve_two_view(T(uv1), T(uv2), T(mask), idx_h.to(d), idx_f.to(d), T(K))
            r = type(r)(*[v.cpu() for v in r])
            res[where] = (r, (time.perf_counter() - t) * 1e3)
        (c, c_ms), (g, g_ms) = res["cpu"], res["card"]
        diff_good = float((c.is_good != g.is_good).float().mean())
        dR = float((c.R - g.R).abs().max())
        ang = float(np.degrees(np.arccos(np.clip((np.trace(g.R.numpy() @ R_true.T) - 1) / 2, -1, 1))))
        name = "planar" if planar else "general"
        print(f"mono-init {name}: card ok {bool(g.ok)} homography {bool(g.used_homography)} "
              f"({g_ms:.1f} ms), CPU ok {bool(c.ok)} homography {bool(c.used_homography)} "
              f"({c_ms:.1f} ms); is_good differs on {diff_good:.2%} of {len(mask)}, R within "
              f"{dR:.2e}, rotation error against the truth {ang:.3f} deg")
        if not (bool(g.ok) == bool(c.ok) and bool(g.used_homography) == bool(c.used_homography)
                and bool(g.ok) and bool(g.used_homography) == planar
                and diff_good <= 0.01 and dR < 1e-4):
            raise AssertionError(f"mono-init {name}: the card and the CPU disagree")


T_START = time.perf_counter()


def elapsed(label, t0):
    t = time.perf_counter()
    print(f"[{label}: {t - t0:.1f} s]")
    return t


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
        "point_sums": phase_point_sums(dev, rng),
    }
    kitti = phase_kitti_shapes(dev, rng)
    t = time.perf_counter()
    tracking, mapped, system = phase_main_paths(dev)
    t = elapsed("orbit paths and system-reloc", t)
    loop = phase_system_loop(dev)
    t = elapsed("system-loop", t)
    stereo = phase_system_stereo(dev)
    t = elapsed("system-stereo", t)
    driver = phase_driver_rgbd(dev)
    t = elapsed("driver-rgbd", t)
    phase_driver_live(dev)
    t = elapsed("driver-live", t)
    phase_mono_init(dev)
    elapsed("mono-init", t)
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s since the start")
    rows = []
    for name, res in results.items():
        source, replaces = KERNELS[name]
        extra = {"kitti_shapes": kitti[name]} if name in kitti else {}
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": mapped[name],
                     "launches_tracking_only": tracking[name],
                     "launches_system": system[name], "launches_loop": loop[name],
                     "launches_stereo": stereo[name], "launches_driver": driver[name],
                     **res, **extra})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
