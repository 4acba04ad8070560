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
   The port's counterpart of `jax.jit` is `utils/graphs.graphed`: on the
   card each decorated function (`build_frame`, `build_frame_stereo`, the
   stepwise tracking stages, `insert_keyframe_jit`, `track_frame_fused`,
   the mapping stage; relocalization's stages with `pnp_solve` and
   `optimize_pose`; the loop's word match, `solve_sim3`, `search_by_sim3`,
   `optimize_sim3`, projection count, `optimize_essential_graph`, global
   BA and `merge_gba`) is one CUDA graph replay a call, captured once per
   input signature; `graphs.eager()` calls their bodies instead, which this
   script does only for the references the replays are held to.
3. Tracking path: the first 20 frames of the bench's orbit scene (4000
   textured squares, 640x480, the dual ~90-degree rig) through
   `Tracker(calib, cfg, pipelined=True, pipeline_depth=3)` with the default
   `SlamConfig` and no mapping callback, on graphs (`build_frame` and
   `track_frame_fused` replays).
4. Mapping path: all 60 orbit frames through the same tracker with
   `kf_inserted_cb` running `run_mapping_stage` and `covis_kf_count` (the
   next keyframe's window hint), as `bench.py` sets it, under
   `graphs.eager()`: the eager reference of the graph phases below.  Each
   stage is the body of `_mapping_stage_fused`, which computes its local BA
   (one `point_sums` launch) on every keyframe and takes it once the map
   holds more than 2 keyframes.  The orbit maps 4 keyframes and takes 2
   local BAs; with none taken, or with `point_sums` launched other than
   once a stage, the phase fails.
   For each path every kernel's launch count is set to 0 just before and
   read just after; a path fails unless every frame tracks, ATE < 0.02 m,
   no pose or map point is NaN and every kernel of the path launched (the
   mapping path: all four, and every keyframe mapped).
   Then `fused-orbit`: the same 60 frames and mapping callback through
   `Tracker(pipelined=True, pipeline_depth=3, fuse_extraction=True)`, as
   `bench.py` runs the JAX package: every OK frame one replay of the CUDA
   graph of `track_frame_fused_images`, each replay and its copies out under
   `set_sync_debug_mode("error")`.  It fails unless every frame tracks, ATE
   < 0.02 m, the keyframes of the eager mapping path are inserted and mapped
   on the same frames, every camera centre lies within 1 mm of that run's,
   one capture was made and all four kernels launched (counted through the
   replays).  It prints the capture's ms, the kernels in the graph, eager and
   graph ms a frame, one replay's device ms (`torch.profiler`) and the
   device ms of the two branches computed on every frame, and the frames
   that ran a mapping stage apart from the rest.  Then `mapping-graph`: the
   fused-orbit run's last map and newest keyframe at the default
   `SlamConfig`, each local-BA window bucket (12, 16, 24, 32 free
   keyframes) forced through `covis_hint`: the eager body, then two replays
   of the bucket's graph entry, each under `set_sync_debug_mode("error")` and
   bit-equal to the body in every field; the capture's ms, a replay's ms
   (CUDA events) against the body's, its device ms and operations
   (`torch.profiler`), the live and total LM trips, and a
   `{"mapping_graph": [...]}` line.  Then `mapping-stepwise`: the same map
   and keyframe through `run_mapping_stage` with each of its four stages
   switched off in turn (the stepwise path: each of `cull_map_points`,
   `triangulate_new_points`, `fuse_neighbors`, `build_local_problem`,
   `solve_ba_jit`, `apply_ba_result`, `cull_keyframes` and
   `update_point_geometry` one replay of its own graph entry), under
   `graphs.eager()` and twice on graphs: every field of both graph runs the
   eager run's bits, every launch in a replay; host ms of each run, each
   entry's capture ms and a replay's device ms and operations, and a
   `{"mapping_stepwise": ...}` line.  Then
   `track_frames_scan` over the same frames in chunks of 4 after the first
   (one [4, 8] read back a chunk, the mapping stage between chunks): every
   frame tracked, ATE < 0.02 m; ms a chunk and the keyframes.
   Then `system-graphs`: the 60 orbit frames through
   `System(DUAL_RGBD)` (mapping and loop stage on), stepwise (the default)
   and pipelined (depth 3), each once under `graphs.eager()` and once on
   graphs: ms a frame (median, max, and without a keyframe), host syncs a
   frame (`set_sync_debug_mode("warn")`), the graph entries each run
   called (replays, capture ms), launches, keyframes, camera centres
   against the eager run, ATE, peak memory, and a `{"system_graphs": ...}`
   line.  It fails unless both routes insert the eager run's keyframes,
   every centre lies within 1 mm of the eager run's, every frame tracks,
   ATE < 0.02 m, every kernel launched, and the launches of `fast_score`,
   `gather_patches` and `point_sums` are the replays' calls times their
   captures' counts (`window_match` at least that).
5. System path, `system-reloc`: the 60 orbit frames through
   `System(sensor=DUAL_RGBD, calib=..., cfg=...)` on the card (its defaults:
   unpipelined, mapping and the loop stage on; from here on every path
   runs its graphed functions as replays), with 3 frames blanked out
   (grey 100, depth 0) once the vocabulary exists.  The orbit gives 4
   keyframes in 60 frames, so the script builds the `LoopCloser` with
   `vocab_min_descs=1500` instead of 6000 and says so.  The path fails unless
   the state is LOST on the blank frames, a relocalization succeeds with
   `window_match` launched inside it, the state is OK on the last frame, the
   last pose is within 5 cm of ground truth, ATE over the tracked frames is
   under 20 mm, all four kernels launched (the three that run only inside
   graphs exactly the replays' calls times their captures' counts), and
   the frame is found by its first candidate with 5 host reads.  It prints
   each relocalization's time, candidates and host reads, the vocabulary's
   training time, and, on copies of the found frame's inputs after the
   counts were read: `relocalize` on graphs again against two calls under
   `graphs.eager()` (the same bits, or the phase fails), the time split by
   stage under the profiler, each stage entry's capture ms and one
   replay's device ms and operations, and a `{"reloc_graphs": ...}` line.
   Then `save_map`, a fresh `System`, `load_map` (it comes back LOST), the
   loaded keyframes indexed again by the script, and one frame found again.
6. System path, `system-loop`: the loop circuit of
   `tests/test_circuit_e2e.py` through `System` with loop closing and
   global BA (a loop closed, the GBA merged, ATE < 0.20 m, every loop role
   of `window_match` launched, the GBA dispatch held under
   `torch.cuda.set_sync_debug_mode("error")`, launches against the
   replays as in `system-reloc`); the frames that ran the keyframe stages
   are timed apart from the rest.  Then the loop keyframe's stages again
   on copies of their inputs, on graphs and under `graphs.eager()`: host ms
   of `_compute_sim3`, `_correct_loop`, the pose graph, the GBA dispatch and
   the merge (with the run's first call, which captured), `_compute_sim3`
   and the merge bit-equal, the pose graph and `_correct_loop`'s poses
   within 1e-4, the global BA's poses within 1e-3 and its points within a
   tenth of a sigma in their information metric (1 mm where H_pp's
   smallest eigenvalue is >= 10 m^-2), as the distributed BA's card test
   holds them (two eager calls' spread printed beside), each entry's
   capture and replay, and a `{"loop_graphs": ...}` line.
6a. `determinism`: the loop keyframe's global BA and essential graph each
   replayed 3 times on its inputs, and `_correct_loop` twice from copies of
   one map on fresh `LoopCloser`s: every output the same bits, or the phase
   fails (their sums add in one fixed order, `optim/segments.py`).  For the
   record, both solvers captured once more with their sums as the float
   `index_add_` the port used before (atomics): their spread over 3
   replays, their distance from the fixed-order result, and each replay's
   device ms against the fixed-order replay's, in turns; a
   `{"determinism": ...}` line.
6b. `system-longrun`: `tests/test_longrun.py`'s scene at the bench's width:
   520 frames of an outward circuit of 2.2 laps at 640x480 on the dual rig
   (`bench_rig`), frames 200-279 at half contrast, rendered by parallel
   processes, through `System(DUAL_RGBD)` on graphs with the default
   `SlamConfig` (th_depth 4.0 as the test sets it), loop closing and global
   BA, the vocabulary built as the test builds it.  It prints the states,
   relocalizations, keyframes and cadence, each loop, the GBAs dispatched /
   merged / superseded, the final map, ATE, `track_rgbd` median / p99 / max,
   every frame that captured a graph entry, the entries per function, the
   peak memory at frames 100, 300 and 519, host syncs a frame and the
   launches, and a `{"system_longrun": ...}` line.  It fails unless the
   test's four assertions hold (frames not OK: at most the JAX package's
   own count at this width, LONG_MAX_NOT_OK, since it misses the test's 10
   there, ROADMAP C; a cadence of 26 to 86 keyframes, the low-contrast stretch's rate within 2.5x
   the overall rate + 0.02, no refused allocation and the stores not full),
   a loop closes and a GBA merges, every kernel launched as the replays
   say, no function holds two graph entries at the same shapes and static
   arguments, and the peak memory at frame 519 is within 64 MiB of frame
   300's unless a capture came between.  Then the 520 frames again through
   a fresh `System` in the same process (its graphs already captured): it
   fails unless the second pass gives the first one's row (the frames not
   OK, the keyframes' frames, each loop's frame and keyframe pair, GBAs
   dispatched and merged, n_kf, n_mp) and its final keyframe poses and map
   points to the bit; both passes' ATE and track_rgbd median / p99 ms are
   printed, and the first frame whose pose parts if one does.
   `overflow`: `tests/test_capacity.py`'s run (25 frames, one 320x240
   camera, `max_kf=24, max_mp=768`) through `Tracker` with the mapping stage
   on graphs and under `graphs.eager()`: the same states, `n_mp` and
   `n_alloc_failed`, the final positions bit-equal, the test's bounds; then
   the final map filled over 90% through one mapping stage, on graphs and
   eagerly: relieved to >= M / 10 free slots, every field the same bits.
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
   Then the first AB_FRAMES (30) of those frames without and with
   `--pipelined` in turns (off, on, on, off), each run's median tracking and
   whole-frame times on a `{"pipelined_ab": [...]}` line; each run must
   track under 20 mm.
   `driver-rgbd-degraded`: `tools/make_tum_dataset.py`'s default sequence
   (120 frames, orbit, seed 0, 4000 squares, 640x480, the real rig, its
   settings.yaml and calibration.txt), clean and through
   `degrade_sequence(SensorModel(), seed=7)`, written with `io/png.py` and
   tracked by `drivers/rgbd_tum --pipelined --no-realtime`: each run must
   track 120/120 under 20 mm; printed beside BASELINE_MEASURED.md's ATEs on
   the same frames, with a `{"driver_rgbd_degraded": [...]}` line.
10. `driver-live`: the live driver's self-test, 20 frames streamed through a
   local socket and tracked on the card.  `mono-init`: the two-view
   initializer (`solve_two_view`, a graph entry) on the card and on the CPU
   on the same 256 draws, on a general and a planar scene, at 300 and at
   2000 correspondences (two cameras' worth of 1024 features): the replay
   the eager call's bits, the same `ok` and model on both devices (at 300
   accepted, with the scene's model), `is_good` within 1%, R within 1e-4;
   eager, capture and replay ms.
   `orb-reference`: the reference's per-level extractor
   (`extract_orb_reference`, a graph entry) on a 640x480 orbit frame of
   each camera: the replay the eager call's bits, its keypoints those of
   the CPU run on >= 99% of them; the keypoints it shares with the
   batched CUDA-path `extract_orb` printed, not held; eager, capture and
   replay ms.
11. `distributed` (`multi_orb_slam_tpu_torch/parallel/`): the distributed
   global BA at the default capacity (192 keyframes x 2 cameras x 1024
   slots, 24576 points; `drivers/bench_dist_ba`'s synthetic problem on the
   bench rig, the poses and points started off the truth), 8 outer x 40 CG
   iterations, on a real NCCL process group of one rank (the timed step
   under `set_sync_debug_mode("error")`), on 2 and 4 gloo ranks sharing the
   card (processes, not a scaling measurement) and on the CPU: the cost
   falls, the free poses move toward the truth, the poses within 5e-4 of
   world 1's, 99% of the points within 1 mm, every rank the same bits.
   Then `dryrun_multichip` is the world-1 run above and a world-2 one: each
   rank extracts its own orbit frame (features bit-equal to one process's
   extraction, `fast_score` and `gather_patches` launched on every rank),
   and scores 192 keyframes a rank x 4096 words of 10^6 against the whole
   table (within 1e-6, the query its own best).  The kernels are built by
   phase 1, so the ranks only load them.  A `{"distributed": ...}` line.
12. A `{"graph_entries": [...]}` line (every signature captured in the
   run: calls, warm-up and capture ms), a JSON line of per-kernel results
   (with `launches_stereo`, `launches_driver`, `launches_distributed`,
   `launches_fused`, `launches_scan`, `launches_mapping_graph`,
   `launches_mapping_stepwise`,
   `launches_system_graphs`, `launches_longrun`, `launches_overflow`,
   `launches_degraded` and `launches_degraded_clean`, and the stereo path's
   shapes under
   `kitti_shapes`), then the last line
   `{"ok": true, "device": {...}}`.

Without a CUDA device the script exits 1 before printing any result.
"""

import collections
import contextlib
import json
import pathlib
import subprocess
import sys
import tempfile
import time
import warnings

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


def run_path(name, frames, poses_gt, calib, cfg, mapping, fused=False, info=None,
             eager=False):
    """Drive the Tracker over `frames`, with or without the mapping
    callback (with `fused`, `fuse_extraction=True`: every OK frame one
    replay of the fused step's CUDA graph; with `eager`, every graphed
    function and the mapping stage called eagerly, under `graphs.eager()`:
    the reference the graphs are held to); returns (launch counts,
    keyframes mapped, local-BA solves).  `info`, a dict, receives the
    tracker, the frame times (ms), the camera centres and the frames whose
    keyframe was mapped."""
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.geometry import align
    from multi_orb_slam_tpu_torch.mapping import local_mapping
    from multi_orb_slam_tpu_torch.ops import kernels
    from multi_orb_slam_tpu_torch.optim import local_ba
    from multi_orb_slam_tpu_torch.utils import graphs

    tracker = tracking.Tracker(calib, cfg, pipelined=True, pipeline_depth=3,
                               fuse_extraction=fused)
    map_ms, covis_pending, kf_frames, map_frames = [], [None], [], []

    def kf_cb(kf_slot):
        # as bench.py sets it: the mapping stage, then the covisible count
        # that the NEXT keyframe's stage takes as its window hint
        map_frames.append(len(times))
        torch.cuda.synchronize()
        t = time.perf_counter()
        hint = int(covis_pending[0]) if covis_pending[0] is not None else None
        m = local_mapping.run_mapping_stage(tracker.map, kf_slot, tracker.frame_id,
                                            calib, cfg, covis_hint=hint)
        if cfg.ba_adaptive:
            covis_pending[0] = local_mapping.covis_kf_count(m, kf_slot)
        torch.cuda.synchronize()
        map_ms.append((time.perf_counter() - t) * 1e3)
        kf_frames.append(tracker.last_kf_frame)
        return m

    if mapping:
        tracker.kf_inserted_cb = kf_cb
    windows0, ba0 = local_mapping.BA_WINDOWS.read(), local_ba.STATS.read()
    kernels.reset_launch_counts()
    times = []
    with graphs.eager() if eager else contextlib.nullcontext():
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
               for k, v in local_mapping.BA_WINDOWS.read().items() if v - windows0.get(k, 0)}
    ba = {k: v - ba0.get(k, 0) for k, v in local_ba.STATS.read().items()}
    solves, iters, trips = ba.get("solves", 0), ba.get("iterations", 0), ba.get("trips", 0)
    label = (f"{name}-{n}" + (" with mapping" if mapping else " tracking only")
             + (", fused step as a CUDA graph" if fused else "")
             + (", eager (graphs.eager())" if eager else ", graphed functions as replays"
                if not fused else ""))
    if info is not None:
        info.update(tracker=tracker, ms=ms, centres=est.numpy(), kf_frames=kf_frames,
                    map_frames=map_frames, map_ms=np.asarray(map_ms), ate=ate)
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
              f"({iters / max(solves, 1):.1f} per solve), live of {trips} trips computed "
              f"(a stage computes its local BA's trips on every keyframe)")
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
    with a relocalization; returns the launch counts of the three and the
    first orbit frames (numpy, for the distributed path)."""
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
    eager = {}
    mapped, n_mapped, solves = run_path("orbit", frames, poses_gt, calib, cfg, mapping=True,
                                        info=eager, eager=True)
    missing = [k for k, v in mapped.items() if v <= 0]
    if missing or solves == 0 or mapped["point_sums"] != n_mapped:
        raise AssertionError(f"mapping path on the orbit: never launched {missing}; "
                             f"{solves} local-BA solves (none: no stage reached n_kf > 2), "
                             f"{mapped['point_sums']} point_sums launches in {n_mapped} "
                             f"mapping stages (one a stage's graph)")
    fused, fused_tracker = phase_fused_orbit(frames, poses_gt, calib, cfg, eager)
    graph = phase_mapping_graph(fused_tracker, calib, cfg)
    stepwise = phase_mapping_stepwise(fused_tracker, calib, cfg)
    orb_reference(frames, cfg)
    scan = phase_scan(frames, poses_gt, calib, cfg)
    system_graphs = phase_system_graphs(frames, poses_gt, calib, cfg)
    system = phase_system_reloc(frames, poses_gt, calib, cfg)
    firsts = np.stack([g.cpu().numpy() for g, _ in frames[:DIST_DRYRUN_WORLD]])
    return tracking, mapped, system, firsts, fused, scan, graph, system_graphs, stepwise


FUSED_CENTRE_LIMIT_M = 1e-3   # the graph's camera centres against the eager run's
SCAN_G = 4


def profiled_device(fn, pause=0.1):
    """Device time of one call of `fn` under `torch.profiler`: the summed
    durations of the kernels and copies it traced on the card, and their
    count (a warm-up step first; pauses keep the read call away from the
    window's ends, where the tracer drops records)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    steps = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, schedule=steps) as prof:
        for active in (False, True):
            time.sleep(pause if active else 0.0)
            fn()
            torch.cuda.synchronize()
            time.sleep(pause if active else 0.0)
            prof.step()
    # the kernels, copies and fills; not the ranges (the profiler's step,
    # `record_function`) that the tracer also draws on the device's timeline
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in prof.events() if e.device_type == cuda
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("ProfilerStep")]
    return sum(e.time_range.elapsed_us() for e in dev) / 1e3, len(dev)


def phase_fused_orbit(frames, poses_gt, calib, cfg, eager):
    """`fused-orbit`: the 60 orbit frames through the tracker with
    `fuse_extraction=True` and the mapping stage at every keyframe, as
    `bench.py` runs the JAX package: every OK frame one replay of the
    fused step's CUDA graph (each replay and its copies out under
    `set_sync_debug_mode("error")`, inside the step).  Fails unless every
    frame tracks, ATE < 20 mm, the keyframes of the eager mapping path just
    before were inserted and mapped on the same frames, every camera centre
    lies within 1 mm of that run's, one capture was made and all four
    kernels launched, counted through the replays.  Returns the counts."""
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.utils import graphs

    info = {}
    launches, n_mapped, _ = run_path("orbit", frames, poses_gt, calib, cfg, mapping=True,
                                     fused=True, info=info)
    tr = info["tracker"]
    fs = tr.fused
    n_replays = fs.n_replays
    d_centre = float(np.abs(info["centres"] - eager["centres"]).max())
    e_ms, g_ms = eager["ms"], info["ms"]
    print(f"  fused step: {fs.n_captures} capture (warm-up {fs.warmup_ms:.1f} ms, capture "
          f"{fs.capture_ms:.1f} ms), {n_replays} replays, each under "
          f"set_sync_debug_mode('error'); kernels in the graph {fs.graph_launches}")
    print(f"  ms a frame, eager / graph: median {np.median(e_ms):.2f} / {np.median(g_ms):.2f}, "
          f"max {e_ms.max():.2f} / {g_ms.max():.2f}, median from frame 8 on "
          f"{np.median(e_ms[8:]):.2f} / {np.median(g_ms[8:]):.2f}")
    print(f"  keyframes mapped: eager {eager['kf_frames']}, graph {info['kf_frames']}; "
          f"camera centres within {d_centre * 1e3:.4f} mm of the eager run's")
    kf_ms = g_ms[info["map_frames"]]
    rest = np.delete(g_ms, info["map_frames"] + [0])
    print(f"  frames that ran a mapping stage (replay of its graph; the first of a bucket "
          f"with its capture): {info['map_frames']}, ms {[round(float(x), 2) for x in kf_ms]} "
          f"(the stage itself {[round(float(x), 2) for x in info['map_ms']]}); the other "
          f"frames after the first: median {np.median(rest):.2f} ms")
    # one replay's span on the device, unprofiled (the tracer slows a graph)
    span_ms = cuda_ms(fs.run, reps=3, warmup=0)
    dev_ms, dev_ops = profiled_device(fs.run)
    newest = tracking._newest_kf(tr.map)
    with graphs.eager():     # the branches as the graph holds them, launched one by one
        fb_ms, fb_ops = profiled_device(lambda: tracking.track_reference_kf(
            tr.map, newest, tr.prev_Tcw, tr.prev_frame, tr.calib, cfg))
        ins_ms, ins_ops = profiled_device(lambda: tracking.insert_keyframe_impl(
            tr.map, tr.prev_frame, tr.prev_Tcw, tr.prev_mp, tr.calib, cfg, fs.frame_id))
    print(f"  one replay: {dev_ops} device operations, {dev_ms:.3f} ms of device time "
          f"(torch.profiler); {span_ms:.3f} ms a replay by CUDA events, unprofiled; the branches "
          f"computed on every frame: reference-KF fallback {fb_ms:.3f} ms ({fb_ops} ops), "
          f"keyframe insertion {ins_ms:.3f} ms ({ins_ops} ops)")
    print(json.dumps({"fused_orbit": {
        "frames": len(frames), "ate_m": info["ate"], "centre_vs_eager_m": d_centre,
        "eager_ms_median": float(np.median(e_ms)), "eager_ms_max": float(e_ms.max()),
        "graph_ms_median": float(np.median(g_ms)), "graph_ms_max": float(g_ms.max()),
        "warmup_ms": fs.warmup_ms, "capture_ms": fs.capture_ms, "replays": n_replays,
        "graph_kernels": fs.graph_launches, "replay_device_ms": dev_ms,
        "replay_device_ops": dev_ops, "replay_span_ms": span_ms,
        "fallback_device_ms": fb_ms, "insertion_device_ms": ins_ms,
        "mapping_frames": info["map_frames"], "mapping_frame_ms": [float(x) for x in kf_ms],
        "mapping_stage_ms": [float(x) for x in info["map_ms"]],
        "other_frames_ms_median": float(np.median(rest))}}))
    missing = [k for k, v in launches.items() if v <= 0]
    if fs.n_captures != 1 or n_replays != len(frames) - 1:
        raise AssertionError(f"fused-orbit: {fs.n_captures} captures, {n_replays} replays "
                             f"for {len(frames) - 1} frames after the first")
    if info["kf_frames"] != eager["kf_frames"] or n_mapped != len(eager["kf_frames"]):
        raise AssertionError(f"fused-orbit: keyframes {info['kf_frames']} against the eager "
                             f"run's {eager['kf_frames']}")
    if not d_centre < FUSED_CENTRE_LIMIT_M:
        raise AssertionError(f"fused-orbit: camera centres {d_centre:.6f} m from the eager run's")
    if missing:
        raise AssertionError(f"fused-orbit: never launched {missing}")
    return launches, tr


MAPPING_BUCKET_HINTS = {12: 11, 16: 15, 24: 23, 32: 31}   # window bucket -> covis_hint


def body_split(entry):
    """The device ms and operations of each "mapping/<stage>" range of one
    eager call of a graph entry's body under `torch.profiler` (its launches
    are taken back: they are a measurement's, not a path's)."""
    from multi_orb_slam_tpu_torch.ops import kernels

    counts = dict(kernels.LAUNCHES)
    rows = collections.defaultdict(
        lambda: {"calls": 0, "host_ms": 0.0, "device_ops": 0, "device_ms": 0.0})
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        entry.body()
        torch.cuda.synchronize()
    read_ranges(prof, "mapping/", rows)
    kernels.LAUNCHES.update(counts)
    return dict(rows)


def phase_mapping_graph(tracker, calib, cfg):
    """`mapping-graph`: the mapping stage of the fused-orbit run's last map
    and newest keyframe, at the default `SlamConfig`, with each local-BA
    window bucket forced through `covis_hint`: the eager body once (the
    graphed `_mapping_stage_fused` under `graphs.eager()`), then two calls
    of it, each a replay of the bucket's entry (captured on its first use,
    in the orbit run or here) under `set_sync_debug_mode("error")` and
    each bit-equal to the eager body in every field of the map.  Prints
    per bucket the capture's ms, a replay's ms (CUDA events) against the
    eager body's (host clock), its device ms and operations
    (`torch.profiler`), and the live and total LM trips.  Returns the
    launch counts of the replays."""
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.mapping import local_mapping
    from multi_orb_slam_tpu_torch.ops import kernels
    from multi_orb_slam_tpu_torch.optim import local_ba
    from multi_orb_slam_tpu_torch.utils import graphs

    st = graphs.clone(tracker.map)
    kf = int(tracking._newest_kf(st))
    fid = int(tracker.frame_id)
    print(f"mapping-graph: the fused-orbit map ({int(st.n_kf)} keyframes, {int(st.n_mp)} map "
          f"points; capacities K {cfg.max_kf}, M {cfg.max_mp}, F {cfg.max_feat} x {cfg.n_cams} "
          f"cameras, ba_local_cap {cfg.ba_local_cap}), keyframe slot {kf}, frame {fid}")
    stage = local_mapping._mapping_stage_fused
    # the slot and frame id as `run_mapping_stage` passes them
    kf_t, fid_t = (torch.full((), v, dtype=torch.int32, device=calib.K.device)
                   for v in (kf, fid))
    kernels.reset_launch_counts()
    launches_replays = dict.fromkeys(kernels.LAUNCHES, 0)
    rows, failures = [], []
    for bucket, hint in MAPPING_BUCKET_HINTS.items():
        window = local_mapping._window(st, kf, cfg, hint)
        args = (st, kf_t, fid_t, calib, cfg) + tuple(window)
        entry = stage.entry(*args)
        captured_before = entry.graph is not None
        # the eager body (its launches are a comparison's, not the path's)
        counts = dict(kernels.LAUNCHES)
        with graphs.eager():
            stage(*args)
            torch.cuda.synchronize()
            t = time.perf_counter()
            eager = stage(*args)
            torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t) * 1e3
        kernels.LAUNCHES.update(counts)
        if entry.graph is None:
            entry.capture()
        ba0 = local_ba.STATS.read()
        counts = dict(kernels.LAUNCHES)
        outs = []
        for _ in range(2):
            with graphs.no_host_sync(calib.K.device):
                outs.append(stage(*args))
        torch.cuda.synchronize()
        for k, v in kernels.LAUNCHES.items():
            launches_replays[k] += v - counts[k]
        ba = {k: (v - ba0.get(k, 0)) // 2 for k, v in local_ba.STATS.read().items()}
        equal = [all(torch.equal(a, b) for a, b in zip(graphs.tensors(o), graphs.tensors(eager)))
                 for o in outs]
        replay_ms = cuda_ms(entry.graph.replay, reps=5, warmup=1)
        dev_ms, dev_ops = profiled_device(entry.graph.replay)
        split = body_split(entry)
        live, trips = ba.get("iterations", 0), ba.get("trips", 0)
        solve_ms = split.get("solve", {}).get("device_ms", 0.0)
        dead_ms = solve_ms * (trips - live) / max(trips, 1)
        row = {"bucket": bucket, "n_free": window[0], "phases": window[2],
               "captured_in_orbit_run": captured_before, "warmup_ms": entry.warmup_ms,
               "capture_ms": entry.capture_ms, "eager_ms": eager_ms, "replay_ms": replay_ms,
               "replay_device_ms": dev_ms, "replay_device_ops": dev_ops,
               "lm_live_trips": live, "lm_trips": trips, "dead_trips_device_ms": dead_ms,
               "body_device_ms": {k: r["device_ms"] for k, r in split.items()},
               "graph_kernels": entry.graph_launches, "bit_equal": equal}
        rows.append(row)
        print(f"  bucket {bucket} (phases {window[2]}): capture {entry.capture_ms:.1f} ms "
              f"(warm-up {entry.warmup_ms:.1f} ms{', in the orbit run' if captured_before else ''})"
              f"; replay {replay_ms:.2f} ms (CUDA events) against the eager body's "
              f"{eager_ms:.2f} ms; a replay {dev_ops} device operations, {dev_ms:.3f} ms of "
              f"device time; LM trips live {live} of {trips}, the dead ones ~{dead_ms:.2f} ms "
              f"of device time (the body's solve {solve_ms:.2f} ms over "
              f"{trips} trips); kernels in the graph {entry.graph_launches}; two replays "
              f"bit-equal to the eager body {equal}")
        print("    the eager body's device ms by stage: " + ", ".join(
            f"{k} {r['device_ms']:.2f}" for k, r in split.items()))
        if not all(equal):
            failures.append(f"bucket {bucket}: replays bit-equal {equal}")
        if entry.graph_launches["point_sums"] != 1 or entry.graph_launches["window_match"] < 1:
            failures.append(f"bucket {bucket}: kernels in the graph {entry.graph_launches}")
    print(json.dumps({"mapping_graph": rows}))
    print(f"  kernel launches of the replays: {launches_replays}")
    if failures:
        raise AssertionError("mapping-graph: " + "; ".join(failures))
    return launches_replays


STEPWISE_ENTRIES = ("cull_map_points", "triangulate_new_points", "fuse_neighbors",
                    "build_local_problem", "solve_ba_jit", "apply_ba_result", "cull_keyframes",
                    "update_point_geometry")


def phase_mapping_stepwise(tracker, calib, cfg):
    """`mapping-stepwise`: the fused-orbit run's last map and newest
    keyframe through `run_mapping_stage` with each stage switched off in
    turn, under `graphs.eager()` and twice on graphs (the first call
    captures each entry it meets first); every field of both graph runs
    must be the eager run's bits, and every launch of the graph runs a
    replay's.  Returns the graph runs' launch counts."""
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.mapping import local_mapping
    from multi_orb_slam_tpu_torch.ops import kernels
    from multi_orb_slam_tpu_torch.utils import graphs

    st = graphs.clone(tracker.map)
    kf = int(tracking._newest_kf(st))
    fid = int(tracker.frame_id)
    hint = int(local_mapping.covis_kf_count(st, kf))
    print(f"mapping-stepwise: the fused-orbit map ({int(st.n_kf)} keyframes, {int(st.n_mp)} "
          f"map points), keyframe slot {kf}, frame {fid}, covisible keyframes {hint}")
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    calls0 = entry_calls()
    rows, failures = [], []
    for off in ("do_triangulate", "do_fuse", "do_ba", "do_cull"):
        def run():
            return local_mapping.run_mapping_stage(st, kf, fid, calib, cfg, covis_hint=hint,
                                                   **{off: False})

        counts = dict(kernels.LAUNCHES)
        with graphs.eager():
            eager, eager_ms = host_ms(run)
        kernels.LAUNCHES.update(counts)
        first, first_ms = host_ms(run)
        again, again_ms = host_ms(run)
        for k, v in kernels.LAUNCHES.items():
            launches[k] += v - counts[k]
        equal = [all(torch.equal(a, b) for a, b in zip(o, eager)) for o in (first, again)]
        rows.append({"off": off, "eager_ms": eager_ms, "first_ms": first_ms,
                     "again_ms": again_ms, "bit_equal": equal, "n_kf": int(again.n_kf),
                     "n_mp": int(again.n_mp)})
        print(f"  {off}=False: eager {eager_ms:.2f} ms, on graphs {first_ms:.2f} ms (the "
              f"entries first met here captured) and {again_ms:.2f} ms (replays); both graph "
              f"runs the eager bits in every field {equal}; n_kf {int(again.n_kf)}, n_mp "
              f"{int(again.n_mp)}")
        if not all(equal):
            failures.append(f"{off}=False: graph runs bit-equal {equal}")
    replayed = replayed_launches(calls0)
    print("  the stepwise entries:")
    entries = entry_table(STEPWISE_ENTRIES)
    print(json.dumps({"mapping_stepwise": {"runs": rows, "entries": entries,
                                           "launches": launches}}))
    try:
        check_replayed("mapping-stepwise", launches, replayed)
    except AssertionError as e:
        failures.append(str(e))
    missing = set(STEPWISE_ENTRIES) - {r["entry"].split("[")[0] for r in entries}
    if missing:
        failures.append(f"no graph entry of {sorted(missing)}")
    if failures:
        raise AssertionError("mapping-stepwise: " + "; ".join(failures))
    return launches


def phase_scan(frames, poses_gt, calib, cfg):
    """`track_frames_scan` over the orbit frames in chunks of 4 after the
    first frame (the map initialized by the tracker): each chunk is 4
    replays of one CUDA graph, then one read of its [4, 8] scalars; the
    host runs the mapping stage for each keyframe of the chunk between
    chunks, as `run_path`'s callback does, and rebuilds the local points
    from the mapped map.  Fails unless every frame tracks and ATE < 20 mm.
    Returns the launch counts."""
    from multi_orb_slam_tpu_torch.frontend import fused_graph, tracking
    from multi_orb_slam_tpu_torch.geometry import align
    from multi_orb_slam_tpu_torch.mapping import local_mapping
    from multi_orb_slam_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    tr = tracking.Tracker(calib, cfg, device=calib.K.device)
    tr.process(*frames[0])
    carry = [tr.map, tr.prev_frame, tr.prev_Tcw, tr.prev_mp, tr.velocity,
             torch.tensor([tr.last_kf_frame, tr.ref_kf_tracked, 0], dtype=torch.int32,
                          device=calib.K.device), tr._ensure_local_pts()]
    poses = [tr.prev_Tcw]
    fid, chunk_ms, map_ms, kf_frames, reads = 1, [], [], [], 0
    covis = None
    ok_all = True
    for c0 in range(1, len(frames), SCAN_G):
        chunk = frames[c0:c0 + SCAN_G]
        grays = torch.stack([g for g, _ in chunk])
        depths = torch.stack([d for _, d in chunk])
        torch.cuda.synchronize()
        t = time.perf_counter()
        *carry, outs = tracking.track_frames_scan(*carry, grays, depths, calib, cfg, fid)
        scal = outs[0].cpu().numpy()      # the chunk's one read back
        chunk_ms.append((time.perf_counter() - t) * 1e3)
        reads += 1
        poses.extend(outs[4])
        ok_all &= bool(scal[:, 0].all())
        for g in range(len(chunk)):
            if scal[g, 2]:
                kf_frames.append(fid + g)
                t = time.perf_counter()
                hint = int(covis) if covis is not None else None
                carry[0] = local_mapping.run_mapping_stage(
                    carry[0], int(scal[g, 3]), fid + len(chunk), calib, cfg, covis_hint=hint)
                if cfg.ba_adaptive:
                    covis = local_mapping.covis_kf_count(carry[0], int(scal[g, 3]))
                carry[6] = tracking.build_local_points_cache(carry[0], int(scal[g, 3]), cfg)
                torch.cuda.synchronize()
                map_ms.append((time.perf_counter() - t) * 1e3)
        fid += len(chunk)
    launches = dict(kernels.LAUNCHES)
    Tcw = torch.stack(poses).cpu().numpy().astype(np.float64)
    est = torch.from_numpy(np.stack([np.linalg.inv(T)[:3, 3] for T in Tcw]))
    gt = torch.from_numpy(np.stack([np.linalg.inv(T)[:3, 3] for T in poses_gt[:len(frames)]]))
    ate = float(align.ate_rmse(est, gt))
    fs = fused_graph._SCAN_STEPS[(calib.K.device, cfg, calib.width, calib.height)]
    ms = np.asarray(chunk_ms)
    print(f"scan-{len(frames)}: track_frames_scan in {len(ms)} chunks of <= {SCAN_G} frames "
          f"(G replays of one graph: {fs.n_captures} capture, warm-up {fs.warmup_ms:.1f} ms, "
          f"capture {fs.capture_ms:.1f} ms): ms a chunk median {np.median(ms):.2f}, max "
          f"{ms.max():.2f} (the first with the capture), {np.median(ms) / SCAN_G:.2f} a frame; "
          f"{reads / len(ms):.0f} read back a chunk; keyframes {kf_frames}, mapping stages "
          f"median {np.median(map_ms) if map_ms else 0.0:.2f} ms; ATE {ate * 1e3:.3f} mm; "
          f"launches {launches}")
    if not ok_all:
        raise AssertionError("scan: a frame was not tracked")
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"scan: ATE {ate:.4f} m >= {ATE_LIMIT_M} m")
    return launches


def count_host_syncs(fn):
    """`fn()` under `torch.cuda.set_sync_debug_mode("warn")`: its result, and
    how many of its operations made the host wait on the device (one
    warning each: reads back, copies from pageable memory)."""
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(before)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def entry_label(entry):
    """A graph entry's function and the shape of its first tensor input."""
    from multi_orb_slam_tpu_torch.utils import graphs

    first = graphs.tensors(tuple(entry.inputs.values()))[0]
    return f"{entry.name}{list(first.shape)}"


def system_run(frames, calib, cfg, pipelined, eager):
    """The frames through `System(DUAL_RGBD)` (mapping and loop stage on),
    on graphs or under `graphs.eager()`: frame ms, host syncs a frame,
    states, keyframes, camera centres, launch counts, peak memory, and the
    graph entries the run called (with the calls it made of each)."""
    from multi_orb_slam_tpu_torch import system as system_mod
    from multi_orb_slam_tpu_torch.ops import kernels
    from multi_orb_slam_tpu_torch.utils import graphs

    calls0 = {id(e): (e.n_calls, e.graph is not None) for _, e in graphs.all_entries()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, syncs, states = [], [], []
    with graphs.eager() if eager else contextlib.nullcontext():
        slam = system_mod.System(sensor=system_mod.Sensor.DUAL_RGBD, calib=calib, cfg=cfg,
                                 pipelined=pipelined, pipeline_depth=3 if pipelined else 1)
        for i, (g, d) in enumerate(frames):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, n = count_host_syncs(
                lambda: slam.track_rgbd(g[0], d[0], g[1], d[1], timestamp=i / 30.0))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            syncs.append(n)
            states.append(slam.get_tracking_state())
        traj = slam.tracker.absolute_trajectory()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    st = slam.map
    entries = []
    for _, e in graphs.all_entries():
        n0, had_graph = calls0.get(id(e), (0, False))
        if e.n_calls > n0:
            entries.append({"entry": entry_label(e), "calls": e.n_calls - n0,
                            "captured_in_this_run": not had_graph, "warmup_ms": e.warmup_ms,
                            "capture_ms": e.capture_ms, "graph_kernels": e.graph_launches})
    return {
        "ms": np.asarray(times), "syncs": np.asarray(syncs), "states": states,
        "lost": [lost for *_, lost in traj],
        "centres": np.stack([np.linalg.inv(np.asarray(T, np.float64))[:3, 3]
                             for _, _, T, _ in traj]),
        "keyframes": sorted(int(f) for f, v in zip(st.kf_frame_id.tolist(),
                                                   st.kf_valid.tolist()) if v),
        "inserted": slam.metrics.counters["keyframes_inserted"],
        "launches": launches, "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
        "entries": entries}


def phase_system_graphs(frames, poses_gt, calib, cfg):
    """`system-graphs`: the orbit frames through `System(DUAL_RGBD)`,
    stepwise (unpipelined, the facade's default) and pipelined (depth 3),
    with mapping and the loop stage on, each once under `graphs.eager()` and
    once on graphs (every graphed function one replay a call).  Fails unless
    the graph run inserts the eager run's keyframes, its camera centres lie
    within 1 mm of the eager run's, every frame tracks, ATE < 20 mm, every
    kernel launched, and the launches of `fast_score`, `gather_patches` and
    `point_sums` (only ever launched inside graphs here) are the replays'
    calls times their captures' counts.  Returns the graph runs' launches."""
    from multi_orb_slam_tpu_torch.geometry import align

    n = len(frames)
    gt = torch.from_numpy(np.stack([np.linalg.inv(T)[:3, 3] for T in poses_gt[:n]]))
    total = None
    rows, failures = [], []
    for route, pipelined in (("stepwise", False), ("pipelined", True)):
        eager = system_run(frames, calib, cfg, pipelined, eager=True)
        graph = system_run(frames, calib, cfg, pipelined, eager=False)
        ate = float(align.ate_rmse(torch.from_numpy(graph["centres"]), gt))
        d_centre = float(np.abs(graph["centres"] - eager["centres"]).max())
        ok_frames = [i for i, lost in enumerate(graph["lost"]) if not lost and i > 0]
        kf_frames = set(eager["keyframes"])
        plain = [i for i in ok_frames if i not in kf_frames]
        replayed = collections.Counter()
        for e in graph["entries"]:
            for k, v in e["graph_kernels"].items():
                replayed[k] += v * e["calls"]
        e_ms, g_ms = eager["ms"], graph["ms"]
        row = {
            "route": route, "frames": n, "eager_ms_median": float(np.median(e_ms)),
            "eager_ms_max": float(e_ms.max()), "graph_ms_median": float(np.median(g_ms)),
            "graph_ms_max": float(g_ms.max()),
            "graph_ms_median_no_keyframe": float(np.median(g_ms[plain])),
            "eager_ms_median_no_keyframe": float(np.median(e_ms[plain])),
            "host_syncs_per_ok_frame_median": float(np.median(graph["syncs"][ok_frames])),
            "host_syncs_per_ok_frame_max": int(graph["syncs"][ok_frames].max()),
            "host_syncs_no_keyframe_frame_median": float(np.median(graph["syncs"][plain])),
            "eager_host_syncs_per_ok_frame_median": float(np.median(eager["syncs"][ok_frames])),
            "keyframes": graph["keyframes"], "keyframes_eager": eager["keyframes"],
            "inserted": graph["inserted"], "centre_vs_eager_m": d_centre, "ate_m": ate,
            "peak_mb_eager": eager["peak_mb"], "peak_mb_graph": graph["peak_mb"],
            "launches": graph["launches"], "launches_replayed": dict(replayed),
            "entries": graph["entries"]}
        rows.append(row)
        print(f"system-graphs, {route}: System(DUAL_RGBD, pipelined={pipelined}) over {n} orbit "
              f"frames, mapping and loop stage on; ms a frame eager / graphs: median "
              f"{row['eager_ms_median']:.2f} / {row['graph_ms_median']:.2f}, max "
              f"{row['eager_ms_max']:.2f} / {row['graph_ms_max']:.2f}, frames without a keyframe "
              f"median {row['eager_ms_median_no_keyframe']:.2f} / "
              f"{row['graph_ms_median_no_keyframe']:.2f}")
        print(f"  host syncs (set_sync_debug_mode('warn')) a frame on graphs: median "
              f"{row['host_syncs_per_ok_frame_median']:.0f} over OK frames after the first "
              f"(max {row['host_syncs_per_ok_frame_max']}; frames without a keyframe "
              f"{row['host_syncs_no_keyframe_frame_median']:.0f}), eager "
              f"{row['eager_host_syncs_per_ok_frame_median']:.0f}; keyframes {graph['keyframes']} "
              f"(eager {eager['keyframes']}); camera centres within {d_centre * 1e3:.4f} mm of "
              f"the eager run's; ATE {ate * 1e3:.3f} mm; peak memory eager / graphs "
              f"{eager['peak_mb']:.0f} / {graph['peak_mb']:.0f} MiB")
        for e in graph["entries"]:
            cap = (f"captured here: warm-up {e['warmup_ms']:.1f} ms, capture "
                   f"{e['capture_ms']:.1f} ms" if e["captured_in_this_run"]
                   else "captured in an earlier phase")
            print(f"    {e['entry']}: {e['calls']} replays ({cap}); kernels in the graph "
                  f"{e['graph_kernels']}")
        print(f"  kernel launches {graph['launches']}; of the replays (calls x capture's "
              f"counts) {dict(replayed)}")
        if graph["keyframes"] != eager["keyframes"]:
            failures.append(f"{route}: keyframes {graph['keyframes']} against the eager "
                            f"run's {eager['keyframes']}")
        if not d_centre < FUSED_CENTRE_LIMIT_M:
            failures.append(f"{route}: camera centres {d_centre:.6f} m from the eager run's")
        if any(graph["lost"]) or not ate < ATE_LIMIT_M:
            failures.append(f"{route}: lost {graph['lost'].count(True)} frames, ATE {ate:.4f} m")
        missing = [k for k, v in graph["launches"].items() if v <= 0]
        if missing:
            failures.append(f"{route}: never launched {missing}")
        try:
            check_replayed(route, graph["launches"], dict(replayed))
        except AssertionError as e:
            failures.append(str(e))
        total = graph["launches"] if total is None else {
            k: v + graph["launches"][k] for k, v in total.items()}
    print(json.dumps({"system_graphs": rows}))
    if failures:
        raise AssertionError("system-graphs: " + "; ".join(failures))
    return total


N_BLANK = 3                  # blank frames of the system path
BLANK_AFTER_VOCAB = 4        # frames between the vocabulary's training and the blackout
SMOKE_VOCAB_MIN_DESCS = 1500
LAST_POSE_LIMIT_M = 0.05


def map_gauge_centres(poses):
    """Camera centres of world->camera poses, in the gauge of the first."""
    poses = np.asarray(poses, np.float64)
    return np.stack([np.linalg.inv(T @ np.linalg.inv(poses[0]))[:3, 3] for T in poses])


RELOC_ENTRIES = ("match_stage", "pnp_solve", "pose_ba_inputs", "optimize_pose", "top_up_stage")
LOOP_ENTRIES = ("word_match_stage", "solve_sim3", "search_by_sim3", "optimize_sim3",
                "guided_count_stage", "fuse_into_kfs", "optimize_essential_graph",
                "run_global_ba_arrays", "merge_gba")
LOOP_POSE_TOL = 1e-4         # the pose graph's poses, graphs against eager
GBA_POSE_TOL = 1e-3          # the global BA's, as its card-against-CPU test
GBA_INFO_FLOOR = 10.0        # m^-2: the smallest H_pp eigenvalue of a point held to 1 mm
GBA_MAHALANOBIS = 0.1        # sqrt(dp^T H_pp dp) of every point: a tenth of its own sigma


def host_ms(fn):
    """`fn()` between two synchronisations: its result and its wall ms."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def entry_calls():
    """{id(entry): calls} of every graph entry so far."""
    from multi_orb_slam_tpu_torch.utils import graphs

    return {id(e): e.n_calls for _, e in graphs.all_entries()}


def replayed_launches(before):
    """Kernel launches of the replays since `entry_calls()` gave `before`:
    each entry's calls times its capture's counts."""
    from multi_orb_slam_tpu_torch.utils import graphs

    out = collections.Counter()
    for _, e in graphs.all_entries():
        for k, v in e.graph_launches.items():
            out[k] += v * (e.n_calls - before.get(id(e), 0))
    return dict(out)


def entry_table(names):
    """Each captured entry of the graphed functions `names`: calls, warm-up
    and capture ms, the kernels in its graph, and one replay's device ms and
    operations (`profiled_device` on the entry's own buffers: the functions
    are pure).  Printed, and returned as rows."""
    from multi_orb_slam_tpu_torch.utils import graphs

    rows = []
    for name, e in graphs.all_entries():
        if name not in names or e.graph is None:
            continue
        dev_ms, n_ops = profiled_device(e.graph.replay)
        rows.append({"entry": entry_label(e), "calls": e.n_calls, "warmup_ms": e.warmup_ms,
                     "capture_ms": e.capture_ms, "replay_device_ms": dev_ms,
                     "replay_device_ops": n_ops, "graph_kernels": e.graph_launches})
        print(f"    {entry_label(e)}: {e.n_calls} calls, warm-up {e.warmup_ms:.1f} ms, capture "
              f"{e.capture_ms:.1f} ms; a replay {dev_ms:.3f} ms of device time in {n_ops} "
              f"device operations; kernels in the graph {e.graph_launches}")
    return rows


def check_replayed(label, launches, replayed):
    """Launches of a path against its replays' (calls x captures' counts):
    equal for every kernel, since every launch of the paths that call this
    runs inside a graph (the loop's fusion too)."""
    print(f"  {label}: window_match launches {launches['window_match']}, in replays "
          f"{replayed.get('window_match', 0)}")
    if any(launches[k] != replayed.get(k, 0) for k in launches):
        raise AssertionError(f"{label}: launches {launches} against the replays' {replayed}")


def profile_relocalize(stash, first_ms):
    """One relocalization on graphs against `graphs.eager()`: `relocalize`
    again on copies of the inputs of the call that found the frame (the
    path's call was the first, with the captures, in `first_ms`), then twice
    eagerly; the same bits; the time split by its "reloc/<stage>" ranges
    under `torch.profiler` on graphs; and each stage entry's capture and
    replay (`entry_table`)."""
    from multi_orb_slam_tpu_torch.reloc import relocalization
    from multi_orb_slam_tpu_torch.utils import graphs

    out_g, g_ms = host_ms(lambda: relocalization.relocalize(*stash))
    with graphs.eager():
        out_e, e1_ms = host_ms(lambda: relocalization.relocalize(*stash))
        _, e2_ms = host_ms(lambda: relocalization.relocalize(*stash))
    same = (out_g[0] and out_e[0] and out_g[3] == out_e[3] and torch.equal(out_g[1], out_e[1])
            and torch.equal(out_g[2], out_e[2]))
    print(f"  relocalize on the found frame's inputs, host ms on graphs: first call "
          f"{first_ms:.2f} (the path's, with the captures), again {g_ms:.2f}; under "
          f"graphs.eager(): {e1_ms:.2f}, again {e2_ms:.2f}; found {out_g[0]} with {out_g[3]} "
          f"inliers; graphs and eager the same bits (pose, frame map points, count): {same}")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    rows = collections.defaultdict(
        lambda: {"calls": 0, "host_ms": 0.0, "device_ops": 0, "device_ms": 0.0})
    with torch.profiler.profile(activities=acts) as prof:
        relocalization.relocalize(*stash)
        torch.cuda.synchronize()
    n_in, n_all = read_ranges(prof, "reloc/", rows)
    print(f"  on graphs under the profiler, {n_in} of {n_all} device operations inside a stage "
          f"(a replay's kernels count where the host sees them):")
    print(f"    {'stage':<16}{'calls':>6}{'host ms, profiled':>19}{'device ops':>12}{'device ms':>11}")
    for name, r in rows.items():
        print(f"    {name:<16}{r['calls']:>6}{r['host_ms']:>19.2f}{r['device_ops']:>12}"
              f"{r['device_ms']:>11.3f}")
    print("  relocalization's graph entries:")
    entries = entry_table(RELOC_ENTRIES)
    if not same:
        raise AssertionError("system-reloc: relocalize on graphs is not the eager call's bits")
    return {"first_ms": first_ms, "graph_ms": g_ms, "eager_ms": e1_ms, "eager_again_ms": e2_ms,
            "inliers": out_g[3], "stages": dict(rows), "entries": entries}


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
    from multi_orb_slam_tpu_torch.utils import metrics

    def clone(nt):
        return type(nt)(*[v.clone() if isinstance(v, torch.Tensor) else v for v in nt])

    sys_ = system_mod.System(sensor=system_mod.Sensor.DUAL_RGBD, calib=calib, cfg=cfg)
    sys_.loop_closer = loop_closing.LoopCloser(sys_.calib, cfg,
                                               vocab_min_descs=SMOKE_VOCAB_MIN_DESCS)
    with metrics.tracing():     # the timing report below reads the tracer's spans
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
        calls0 = entry_calls()
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
        replayed = replayed_launches(calls0)

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
        print(f"  kernel launches: {launches}; of the replays (calls x captures' counts) {replayed}")
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
    if found[0]["candidates"] != 1 or found[0]["host_reads"] != 5:
        raise AssertionError(f"system-reloc: the frame was not found by the first candidate "
                             f"with 5 host reads: {found[0]}")
    if states[-1] != TrackState.OK or sorted(set(range(n)) - set(tracked)) != blank_at:
        raise AssertionError(f"system-reloc: states {states}, tracked {tracked}")
    if not (last_err < LAST_POSE_LIMIT_M and ate < ATE_LIMIT_M):
        raise AssertionError(f"system-reloc: last pose {last_err:.4f} m, ATE {ate:.4f} m")
    if not bool(torch.isfinite(st.mp_pos[st.mp_valid]).all() and torch.isfinite(st.kf_Tcw).all()):
        raise AssertionError("system-reloc: NaN or inf in a keyframe pose or a map point")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"system-reloc never launched: {missing}")
    check_replayed("system-reloc", launches, replayed)
    split = profile_relocalize(stash[0], found[0]["ms"])
    print(json.dumps({"reloc_graphs": {
        "frame": found[0]["frame"], "candidates": found[0]["candidates"],
        "host_reads": found[0]["host_reads"], "ate_mm": ate * 1e3, **split}}))

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
    Kc, T_rc = np.asarray(LOOP_K, np.float32), calib.T_rc.cpu().numpy()
    frames, poses = synthetic.loop_circuit(Kc, T_rc, LOOP_FRAMES, LOOP_H, LOOP_W, LOOP_DRIFT)
    frames = [(torch.from_numpy(g).to(dev), torch.from_numpy(d).to(dev)) for g, d in frames]
    torch.cuda.synchronize()
    print(f"loop circuit: {LOOP_FRAMES} frames x {C} cameras at {LOOP_W}x{LOOP_H} rendered in "
          f"{time.perf_counter() - t0:.1f} s (the test's 320x240: the bench's 640x480 circuit-160 "
          f"is not tracked to the end by either package)")
    return calib, cfg, frames, poses


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
    """Device time of one global BA on `state` (a replay of its graph), from
    `torch.profiler`, and the number of device operations."""
    from multi_orb_slam_tpu_torch.optim import global_ba

    return profiled_device(
        lambda: global_ba.dispatch_global_ba(state, calib, cfg, n_outer=LOOP_GBA_OUTER))


def gba_points_apart(arrays, Tcw_ref, pos_ref, pos):
    """How far a global BA solution's points lie from a reference
    solution's, in each point's information metric there (H_pp of the
    problem `arrays` = (state_arrays, calib_arrays), at the reference):
    (the largest sqrt(dp^T H dp) over the valid points, the largest |dp| in
    m over those whose smallest H eigenvalue is >= GBA_INFO_FLOOR).  Points
    that one observation or a short baseline holds slide along their ray
    with any rounding; the metric weighs that out."""
    from multi_orb_slam_tpu_torch.optim import global_ba

    H = global_ba.map_point_information(*arrays, Tcw_ref, pos_ref)
    valid = arrays[0][6]
    dp, Hv = (pos - pos_ref)[valid].double(), H[valid].double()
    maha = torch.sqrt(torch.clamp(torch.einsum("ni,nij,nj->n", dp, Hv, dp), min=0.0))
    held = torch.linalg.eigvalsh(Hv)[:, 0] >= GBA_INFO_FLOOR
    return float(maha.max()), float(dp[held].abs().max()) if bool(held.any()) else 0.0


def loop_graphs_vs_eager(stash, calib, cfg, voc):
    """The loop keyframe's stages on the inputs the run handed them (copies
    kept in `stash`), each on a fresh `LoopCloser`, once on graphs (every
    entry captured by the run: replays) and once under `graphs.eager()`;
    the pose graph and the global BA twice each (their spread: 0 since
    they sum in one fixed order).  Host ms (`_correct_loop` and the dispatch: until they return,
    and until the card is done), and the results held: `_compute_sim3` and
    the merge to the bit, the pose graph and `_correct_loop`'s poses within
    LOOP_POSE_TOL, the global BA's poses within GBA_POSE_TOL and its points
    in their information metric (`gba_points_apart`).  Returns {mode:
    {stage: ms}} and the measured differences."""
    from multi_orb_slam_tpu_torch.loop import loop_closing
    from multi_orb_slam_tpu_torch.optim import global_ba, pose_graph
    from multi_orb_slam_tpu_torch.utils import graphs

    def closer():
        lc = loop_closing.LoopCloser(calib, cfg)
        lc.voc, lc.loop_pairs = voc, list(stash["loop_pairs"])
        return lc

    def enqueue_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return out, (t1 - t) * 1e3, (time.perf_counter() - t) * 1e3

    out, ms = {}, {}
    for mode in ("graphs", "eager"):
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            r, m = {}, {}
            r["compute_sim3"], m["compute_sim3"] = host_ms(
                lambda: closer()._compute_sim3(*stash["compute"]))
            r["correct_loop"], m["correct_loop"], m["correct_loop_done"] = enqueue_ms(
                lambda: closer()._correct_loop(*stash["correct"]))
            for key in ("pose_graph", "pose_graph_again"):
                r[key], m[key] = host_ms(
                    lambda: pose_graph.optimize_essential_graph(*stash["pose_graph"]))
            for key in ("dispatch_global_ba", "dispatch_again"):
                r[key], m[key], m[key + "_done"] = enqueue_ms(
                    lambda: global_ba.dispatch_global_ba(*stash["dispatch"],
                                                         n_outer=LOOP_GBA_OUTER))
            r["merge"], m["merge"] = host_ms(lambda: loop_closing.merge_gba(*stash["merge"]))
        out[mode], ms[mode] = r, m

    def diff(a, b):
        return float((a - b).abs().max())

    g, e = out["graphs"], out["eager"]
    arrays = global_ba.global_ba_arrays(*stash["dispatch"])[:2]
    gba_e, gba_g, gba_e2 = (e["dispatch_global_ba"], g["dispatch_global_ba"],
                            e["dispatch_again"])
    maha, held_m = gba_points_apart(arrays, *gba_e, gba_g[1])
    maha_e, held_e = gba_points_apart(arrays, *gba_e, gba_e2[1])
    d = {
        "compute_sim3_same_bits": (g["compute_sim3"][0] == e["compute_sim3"][0]
                                   and g["compute_sim3"][2] == e["compute_sim3"][2]
                                   and torch.equal(g["compute_sim3"][1], e["compute_sim3"][1])),
        "merge_same_bits": all(torch.equal(x, y) for x, y in zip(g["merge"], e["merge"])),
        # the loop fusion's fields (the pose graph after it is held to a tolerance)
        "correct_loop_fusion_same_bits": all(
            torch.equal(getattr(g["correct_loop"], f), getattr(e["correct_loop"], f))
            for f in ("kf_mp", "mp_valid", "mp_replaced", "mp_found", "mp_visible", "n_mp")),
        "pose_graph": diff(g["pose_graph"], e["pose_graph"]),
        "pose_graph_eager_spread": diff(e["pose_graph"], e["pose_graph_again"]),
        "pose_graph_graph_spread": diff(g["pose_graph"], g["pose_graph_again"]),
        "correct_loop_poses": diff(g["correct_loop"].kf_Tcw, e["correct_loop"].kf_Tcw),
        "gba_poses": diff(gba_g[0], gba_e[0]),
        "gba_points_mahalanobis": maha, "gba_held_points_m": held_m,
        "gba_eager_spread_poses": diff(gba_e2[0], gba_e[0]),
        "gba_eager_spread_points_mahalanobis": maha_e, "gba_eager_spread_held_points_m": held_e,
    }
    return ms, d


def phase_system_loop(dev):
    """The loop path: the circuit through `System` with loop closing and
    global BA; returns its launch counts."""
    from multi_orb_slam_tpu_torch import system as system_mod
    from multi_orb_slam_tpu_torch.geometry import align
    from multi_orb_slam_tpu_torch.loop import loop_closing
    from multi_orb_slam_tpu_torch.ops import kernels
    from multi_orb_slam_tpu_torch.optim import global_ba, pose_graph
    from multi_orb_slam_tpu_torch.placerec import database
    from multi_orb_slam_tpu_torch.utils import graphs, metrics

    calib, cfg, frames, poses_gt = loop_scene(dev)
    print(f"system-loop: System(DUAL_RGBD) on the card, unpipelined, mapping and loop closing "
          f"on, run_gba=True; the test's make_cfg() (512 features, max_frames_kf=12, "
          f"th_depth=4.0, local_cap=1024, ba_local_cap=2048, max_kf {cfg.max_kf}, max_mp "
          f"{cfg.max_mp})")
    voc = loop_vocabulary(frames, cfg)
    sys_ = system_mod.System(sensor=system_mod.Sensor.DUAL_RGBD, calib=calib, cfg=cfg)
    lc = sys_.loop_closer
    lc.voc, lc.db = voc, database.make_empty_db(cfg.max_kf, voc.n_words)
    with metrics.tracing():     # the timing report below reads the tracer's spans

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
        # copies of the inputs of the loop keyframe's stages, for the graphs
        # against eager split after the run
        stash = {}

        def stashed(key, fn, when=lambda out: True):
            def inner(*a):
                kept = graphs.clone(a) if key not in stash else None
                pairs = list(lc.loop_pairs)
                out = fn(*a)
                if kept is not None and when(out):
                    stash[key] = kept
                    if key == "correct":
                        stash["loop_pairs"] = pairs
                    if key == "compute":
                        stash["frame"] = sys_.tracker.frame_id
                return out
            return inner

        def merge_timed(state):
            if lc._gba_pending is None:
                return merge(state)
            if "merge" not in stash:
                stash["merge"] = graphs.clone((state,) + lc._gba_pending)
            return timed("merge_pending_gba", merge)(state)

        lc._compute_sim3 = stashed("compute", timed("compute_sim3", lc._compute_sim3),
                                   when=lambda out: out is not None)
        # host time until it returns: the global BA at its end is only enqueued
        lc._correct_loop = stashed("correct", timed("correct_loop", lc._correct_loop,
                                                    sync_after=False))
        lc.merge_pending_gba = merge_timed
        patched = [(pose_graph, "optimize_essential_graph",
                    stashed("pose_graph", timed("pose_graph", pose_graph.optimize_essential_graph))),
                   (global_ba, "dispatch_global_ba",
                    lambda st, cal, cf, n_outer: stashed("dispatch", lambda *a: dispatch(
                        *a, n_outer=n_outer))(st, cal, cf))]
        originals = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        roles0 = dict(loop_closing.STATS)
        states, times, map_frames = [], [], []
        on_keyframe = sys_.tracker.kf_inserted_cb

        def kf_cb(kf_slot):
            map_frames.append(len(times))
            return on_keyframe(kf_slot)

        sys_.tracker.kf_inserted_cb = kf_cb
        calls0 = entry_calls()
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
            replayed = replayed_launches(calls0)
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
        kf_ms = ms_[map_frames]
        print(f"  frames that ran the keyframe stages (mapping graph, loop stage): "
              f"{len(map_frames)}, median {np.median(kf_ms):.2f} ms, max {kf_ms.max():.2f} ms, "
              f"{kf_ms.sum() / 1e3:.2f} s in all; the other frames median "
              f"{np.median(np.delete(ms_, map_frames)):.2f} ms")
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
        print(f"  kernel launches: {launches}; of the replays (calls x captures' counts) {replayed}")
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
    return_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    done_ms = (time.perf_counter() - t) * 1e3
    finite = bool(torch.isfinite(Tcw_g).all() and torch.isfinite(pos_g[copy.mp_valid]).all())
    dev_ms, n_ops = gba_device_ms(copy, calib, cfg)
    print(f"  dispatch_global_ba under torch.cuda.set_sync_debug_mode('error'): no host "
          f"synchronisation; returned after {return_ms:.2f} ms of host time, done on the device "
          f"{done_ms:.2f} ms after the call; result finite {finite}; under torch.profiler "
          f"{n_ops} device operations, {dev_ms:.3f} ms of device time")

    # the loop keyframe's stages again, on graphs and eagerly
    first = {name: next((r["ms"] for r in stages[name] if r["frame"] >= stash["frame"]), None)
             for name in ("compute_sim3", "correct_loop", "pose_graph", "dispatch_global_ba",
                          "merge_pending_gba")}
    split_ms, held = loop_graphs_vs_eager(stash, calib, cfg, voc)
    print(f"  the loop keyframe (frame {stash['frame']}) again on its inputs, host ms: first "
          f"call in the run (on graphs, with the captures of the entries first used there) / "
          f"replay / graphs.eager()")
    for name, key in (("compute_sim3", "compute_sim3"), ("correct_loop", "correct_loop"),
                      ("pose_graph", "pose_graph"), ("dispatch_global_ba", "dispatch_global_ba"),
                      ("merge_pending_gba", "merge")):
        done = (f" (card done {split_ms['graphs'][key + '_done']:.2f} / "
                f"{split_ms['eager'][key + '_done']:.2f})" if key + "_done" in split_ms["graphs"]
                else "")
        f_ms = first[name]
        print(f"    {name:<20}{f_ms if f_ms is not None else float('nan'):>10.2f}"
              f"{split_ms['graphs'][key]:>10.2f}{split_ms['eager'][key]:>10.2f}{done}")
    print(f"  graphs against eager: _compute_sim3 the same bits {held['compute_sim3_same_bits']}, "
          f"the merge the same bits {held['merge_same_bits']}, _correct_loop's fusion "
          f"(observations, validity, counters) the same bits "
          f"{held['correct_loop_fusion_same_bits']}; pose graph "
          f"{held['pose_graph']:.3e} (two eager calls {held['pose_graph_eager_spread']:.3e} apart, "
          f"two replays {held['pose_graph_graph_spread']:.3e}), _correct_loop's poses "
          f"{held['correct_loop_poses']:.3e} (tolerance {LOOP_POSE_TOL:.0e}); global BA poses "
          f"{held['gba_poses']:.3e} (tolerance {GBA_POSE_TOL:.0e}), points "
          f"{held['gba_points_mahalanobis']:.4f} sigma at most (tolerance {GBA_MAHALANOBIS}), "
          f"those with H_pp >= {GBA_INFO_FLOOR:.0f} m^-2 within {held['gba_held_points_m']:.3e} m "
          f"(1e-3); two eager calls {held['gba_eager_spread_poses']:.3e}, "
          f"{held['gba_eager_spread_points_mahalanobis']:.4f} sigma, "
          f"{held['gba_eager_spread_held_points_m']:.3e} m apart")
    print("  the loop's graph entries:")
    entries = entry_table(LOOP_ENTRIES)
    closed = [v for v in lc.verifications if v["accepted"]]
    print(json.dumps({"loop_graphs": {
        "loop": closed[0] if closed else None, "ate_m": ate, "frames": len(traj),
        "lost": len(lost), "first_ms": first, "ms": split_ms, "held": held,
        "entries": entries}}))

    failures = []
    if not (held["compute_sim3_same_bits"] and held["merge_same_bits"]
            and held["correct_loop_fusion_same_bits"]):
        failures.append("_compute_sim3, the loop fusion or the merge on graphs is not the "
                        "eager call's bits")
    if not (max(held["pose_graph"], held["correct_loop_poses"]) <= LOOP_POSE_TOL
            and held["gba_poses"] <= GBA_POSE_TOL
            and held["gba_points_mahalanobis"] <= GBA_MAHALANOBIS
            and held["gba_held_points_m"] <= 1e-3):
        failures.append(f"graphs against eager beyond the tolerances: {held}")
    try:
        check_replayed("system-loop", launches, replayed)
    except AssertionError as e:
        failures.append(str(e))
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
    return launches, {"stash": stash, "calib": calib, "cfg": cfg, "voc": voc}


# ---------------------------------------------------------------------------
# One result per input: the loop stage's solvers called again on one input
# ---------------------------------------------------------------------------

DETERMINISM_REPLAYS = 3


@contextlib.contextmanager
def index_add_sums():
    """Every `Segments` sum as the float `index_add_` it took the place of
    (atomics on the card, in no fixed order): the loop stage's sums as the
    port summed them before, for the record."""
    from multi_orb_slam_tpu_torch.optim import segments

    def index_add_sum(self, v):
        index = (torch.arange(v.shape[0], device=v.device) // self.block if self.block
                 else self.index)
        out = torch.zeros((self.n + 1,) + v.shape[1:], dtype=v.dtype, device=v.device)
        return out.index_add_(0, index, v)[:self.n]

    kept = segments.Segments.sum
    segments.Segments.sum = index_add_sum
    try:
        yield
    finally:
        segments.Segments.sum = kept


def spread(runs):
    """The largest |difference| of any output of `runs[1:]` from `runs[0]`'s."""
    from multi_orb_slam_tpu_torch.utils import graphs

    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
               for r in runs[1:] for x, y in zip(graphs.tensors(runs[0]), graphs.tensors(r)))


def differing_fields(a, b):
    """The fields of two MapStates whose bits differ."""
    return [f for f in a._fields if isinstance(getattr(a, f), torch.Tensor)
            and not torch.equal(getattr(a, f), getattr(b, f))]


def phase_determinism(ctx):
    """`determinism`: the loop keyframe's solvers again on the inputs
    `system-loop` handed them (copies): the global BA (`run_global_ba_arrays`)
    and the essential graph each replayed DETERMINISM_REPLAYS times, and
    `_correct_loop` run twice on fresh `LoopCloser`s from copies of one map
    (its pose graph, fusion and point correction, and the global BA it
    dispatches).  Fails unless every output of each is the same bits on every
    call.  For the record: the same two solvers captured with their sums as
    the parent's float `index_add_` (`index_add_sums`), replayed as often,
    their spread and their distance from the fixed-order result; and each
    replay's device ms against the parent form's, in turns (parent, new,
    new, parent; `torch.profiler`)."""
    from multi_orb_slam_tpu_torch.loop import loop_closing
    from multi_orb_slam_tpu_torch.optim import global_ba, pose_graph
    from multi_orb_slam_tpu_torch.utils import graphs

    stash, calib, cfg, voc = ctx["stash"], ctx["calib"], ctx["cfg"], ctx["voc"]
    dev = calib.K.device
    sa, ca, kf_free = global_ba.global_ba_arrays(*stash["dispatch"])
    gba_args = (sa, ca, kf_free, stash["dispatch"][2], LOOP_GBA_OUTER)
    pg_args = stash["pose_graph"]
    print(f"determinism: on the loop keyframe's inputs (frame {stash['frame']}): the global BA "
          f"({int(sa[1].sum())} keyframes, {int(sa[6].sum())} points, {LOOP_GBA_OUTER} outer "
          f"iterations) and the essential graph ({int(pg_args[5].sum())} edges of "
          f"{pg_args[5].shape[0]}) {DETERMINISM_REPLAYS} replays each, _correct_loop twice")

    def correct():
        lc = loop_closing.LoopCloser(calib, cfg)
        lc.voc, lc.loop_pairs = voc, list(stash["loop_pairs"])
        state = lc._correct_loop(*graphs.clone(stash["correct"]))
        return state, lc._gba_pending[:2]

    gba = [global_ba.run_global_ba_arrays(*gba_args) for _ in range(DETERMINISM_REPLAYS)]
    pg = [pose_graph.optimize_essential_graph(*pg_args) for _ in range(DETERMINISM_REPLAYS)]
    cl = [correct() for _ in range(2)]
    torch.cuda.synchronize()
    fields = differing_fields(cl[0][0], cl[1][0])
    held = {"global_ba_spread": spread(gba), "essential_graph_spread": spread(pg),
            "correct_loop_fields_apart": fields,
            "correct_loop_gba_spread": spread([c[1] for c in cl])}

    # the parent's form on the same inputs: captured, replayed as often
    bodies = {"global_ba": lambda: global_ba.run_global_ba_arrays.__wrapped__(*gba_args),
              "essential_graph": lambda: pose_graph.optimize_essential_graph.__wrapped__(
                  *pg_args)}
    with index_add_sums():
        parent = {k: graphs.capture(dev, body, body) for k, body in bodies.items()}
    parent_runs = {}
    for k, cap in parent.items():
        runs = []
        for _ in range(DETERMINISM_REPLAYS):
            cap.graph.replay()
            runs.append(graphs.clone(cap.out))
        torch.cuda.synchronize()
        parent_runs[k] = runs
    gba_pts = gba_points_apart((sa, ca), *gba[0], parent_runs["global_ba"][0][1])
    gba_pts_self = max(gba_points_apart((sa, ca), *parent_runs["global_ba"][0], r[1])[0]
                       for r in parent_runs["global_ba"][1:])
    record = {
        "parent_global_ba_spread": spread(parent_runs["global_ba"]),
        "parent_global_ba_pose_spread": spread([r[0] for r in parent_runs["global_ba"]]),
        "parent_global_ba_points_sigma_spread": gba_pts_self,
        "parent_essential_graph_spread": spread(parent_runs["essential_graph"]),
        "parent_global_ba_from_fixed_poses": spread([gba[0][0], parent_runs["global_ba"][0][0]]),
        "parent_global_ba_from_fixed_points_sigma": gba_pts[0],
        "parent_essential_graph_from_fixed": spread([pg[0], parent_runs["essential_graph"][0]]),
    }

    # device ms of a replay, the parent's form and this one's in turns
    entries = {"global_ba": global_ba.run_global_ba_arrays.entry(*gba_args),
               "essential_graph": pose_graph.optimize_essential_graph.entry(*pg_args)}
    device_ms = {}
    for k in entries:
        turns = [("parent", parent[k].graph), ("fixed", entries[k].graph),
                 ("fixed", entries[k].graph), ("parent", parent[k].graph)]
        ms = collections.defaultdict(list)
        for label, graph in turns:
            ms[label].append(profiled_device(graph.replay)[0])
        device_ms[k] = dict(ms)
    print(f"  global BA: {DETERMINISM_REPLAYS} replays the same bits "
          f"{held['global_ba_spread'] == 0.0} (spread {held['global_ba_spread']:.3e}); the "
          f"parent's index_add_ form {record['parent_global_ba_spread']:.3e} apart over "
          f"{DETERMINISM_REPLAYS} replays (poses {record['parent_global_ba_pose_spread']:.3e}, "
          f"points {record['parent_global_ba_points_sigma_spread']:.4f} sigma), "
          f"{record['parent_global_ba_from_fixed_poses']:.3e} (poses) and "
          f"{record['parent_global_ba_from_fixed_points_sigma']:.4f} sigma (points) from the "
          f"fixed-order result")
    print(f"  essential graph: {DETERMINISM_REPLAYS} replays the same bits "
          f"{held['essential_graph_spread'] == 0.0}; the parent's form "
          f"{record['parent_essential_graph_spread']:.3e} apart, "
          f"{record['parent_essential_graph_from_fixed']:.3e} from the fixed-order result")
    print(f"  _correct_loop twice from one map: fields apart {fields or 'none'}; the global BA "
          f"it dispatched {held['correct_loop_gba_spread']:.3e} apart")
    for k, ms in device_ms.items():
        print(f"  {k} replay device ms, parent's form {ms['parent']} / fixed order {ms['fixed']}")
    print(json.dumps({"determinism": {**held, **record, "device_ms": device_ms}}))
    if held["global_ba_spread"] or held["essential_graph_spread"] or fields \
            or held["correct_loop_gba_spread"]:
        raise AssertionError(f"determinism: repeated calls on one input differ: {held}")


# ---------------------------------------------------------------------------
# The long run, the capacity overflow run
# ---------------------------------------------------------------------------

LONG_TEST_MAX_NOT_OK = 10         # tests/test_longrun.py's first assertion, at 320x240
# At 640x480 the JAX package itself misses that bound: 182 of the 520 frames
# not OK (LOST from frame 56 to 232; `tools/circuit_parity.py run --package jax
# --system --scene longrun --size full`, ROADMAP C), so the phase holds the
# port to the JAX package's own count at this width and prints the test's.
LONG_MAX_NOT_OK = 182
LONG_RATE_SLACK = (2.5, 0.02)     # low-contrast rate <= 2.5 x overall + 0.02
LONG_MEMORY_FRAMES = (100, 300, 519)
LONG_MEMORY_GROWTH_MB = 64.0      # peak at the last frame over the peak at frame 300


def signature_groups():
    """Graph entries of one function whose tensor inputs have the same
    shapes and dtypes and whose static arguments are equal: a key that
    differs only in a value baked into it (a slot or a count carried as a
    Python value in a tuple), which would capture that function again at
    the same shapes for every new value.  {label: entries} of each group
    of more than one."""
    from multi_orb_slam_tpu_torch.utils import graphs

    groups = collections.defaultdict(list)
    for name, e in graphs.all_entries():
        shapes = tuple((tuple(t.shape), str(t.dtype)) for k, v in e.inputs.items()
                       if k not in e.static for t in graphs.tensors(v))
        static = tuple((k, repr(e.inputs[k])) for k in sorted(e.static))
        groups[(name, shapes, static)].append(e)
    return {entry_label(es[0]): len(es) for es in groups.values() if len(es) > 1}


def longrun_scene(dev):
    """`tests/test_longrun.py`'s scene at the bench's width: 520 frames of
    the dual rig at 640x480 (`bench_rig`), rendered in parallel
    processes; the frames on the card and the poses."""
    import os

    from multi_orb_slam_tpu_torch.io import synthetic

    calib = bench_rig(dev)
    t0 = time.perf_counter()
    workers = max(1, min(8, os.cpu_count() or 1))
    with synthetic.render_pool(workers) as pool:
        frames, poses = synthetic.longrun_circuit(calib.K[0].cpu().numpy(),
                                                  calib.T_rc.cpu().numpy(), H, W, pool=pool)
    frames = [(torch.from_numpy(g).to(dev), torch.from_numpy(d).to(dev)) for g, d in frames]
    torch.cuda.synchronize()
    print(f"system-longrun: {len(frames)} frames x {C} cameras at {W}x{H} (2.2 laps of the "
          f"2.2 m circuit, frames {synthetic.LONGRUN_LOW_CONTRAST[0]}-"
          f"{synthetic.LONGRUN_LOW_CONTRAST[1] - 1} at half contrast) rendered in "
          f"{time.perf_counter() - t0:.1f} s by {workers} processes")
    return calib, frames, poses


def longrun_pass(frames, calib, cfg, voc):
    """One pass of `system-longrun`'s frames through a fresh
    `System(DUAL_RGBD)` with loop closing and global BA; the launch counts
    set to 0 just before and read just after.  Returns what the phase
    prints and holds (see `longrun_row` for the part two passes must
    share)."""
    from multi_orb_slam_tpu_torch import system as system_mod
    from multi_orb_slam_tpu_torch.ops import kernels
    from multi_orb_slam_tpu_torch.placerec import database
    from multi_orb_slam_tpu_torch.utils import graphs

    sys_ = system_mod.System(sensor=system_mod.Sensor.DUAL_RGBD, calib=calib, cfg=cfg)
    lc = sys_.loop_closer
    lc.voc, lc.db = voc, database.make_empty_db(cfg.max_kf, voc.n_words)
    tr = sys_.tracker
    kf_frames, kf_slots = [], []
    on_keyframe = tr.kf_inserted_cb

    def kf_cb(kf_slot):
        kf_frames.append(tr.frame_id)
        kf_slots.append(int(kf_slot))
        return on_keyframe(kf_slot)

    tr.kf_inserted_cb = kf_cb
    relocs = []
    relocalize = tr.reloc_cb

    def reloc_cb(fr):
        out = relocalize(fr)
        relocs.append((tr.frame_id, bool(out[0])))
        return out

    tr.reloc_cb = reloc_cb
    ms_, syncs, states, captures, loops, memory = [], [], [], [], [], {}
    captured = {id(e) for _, e in graphs.all_entries() if e.graph is not None}
    calls0 = entry_calls()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for i, (g, d) in enumerate(frames):
        n_loops = lc.n_loops_closed
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, n_sync = count_host_syncs(
            lambda: sys_.track_rgbd(g[0], d[0], g[1], d[1], timestamp=i / 30.0))
        torch.cuda.synchronize()
        ms_.append((time.perf_counter() - t) * 1e3)
        syncs.append(n_sync)
        states.append(int(sys_.get_tracking_state()))
        for _, e in graphs.all_entries():
            if e.graph is not None and id(e) not in captured:
                captured.add(id(e))
                captures.append({"frame": i, "entry": entry_label(e),
                                 "warmup_ms": e.warmup_ms, "capture_ms": e.capture_ms,
                                 "frame_ms": ms_[-1]})
        if lc.n_loops_closed > n_loops:
            kf_a, kf_b = lc.loop_pairs[-1]
            fid = sys_.map.kf_frame_id.tolist()
            rec = next(v for v in reversed(lc.verifications) if v["accepted"])
            loops.append({"frame": i, "kf_a": kf_a, "kf_b": kf_b,
                          "kf_a_frame": fid[kf_a], "kf_b_frame": fid[kf_b],
                          "bow": rec["bow"], "ransac": rec["ransac"], "lm": rec["lm"],
                          "total": rec["total"], "frame_ms": ms_[-1]})
        if i in LONG_MEMORY_FRAMES:
            memory[i] = {"peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
                         "allocated_mb": torch.cuda.memory_allocated() / 2 ** 20,
                         "captures_so_far": len(captures)}
    pending_at_end = lc._gba_pending is not None
    merged_before_shutdown = lc.n_gba_merged
    sys_.shutdown()
    traj = tr.absolute_trajectory()
    torch.cuda.synchronize()
    return {"system": sys_, "states": states, "ms": np.asarray(ms_), "syncs": syncs,
            "kf_frames": kf_frames, "kf_slots": kf_slots, "relocs": relocs,
            "captures": captures, "loops": loops, "memory": memory,
            "pending_at_end": pending_at_end, "merged_before_shutdown": merged_before_shutdown,
            "traj": traj, "launches": dict(kernels.LAUNCHES),
            "replayed": replayed_launches(calls0)}


def longrun_row(run):
    """What two passes on one input must share: the frames not OK, the
    keyframes' frames, each loop's frame and keyframe pair, the GBAs
    dispatched and merged, n_kf and n_mp (the final poses and points are
    compared to the bit apart)."""
    from multi_orb_slam_tpu_torch.frontend import tracking

    lc, st = run["system"].loop_closer, run["system"].map
    return {"not_ok": [i for i, x in enumerate(run["states"]) if x != tracking.TrackState.OK],
            "keyframes": run["kf_frames"],
            "loops": [(r["frame"], r["kf_a"], r["kf_b"]) for r in run["loops"]],
            "gba_dispatched": lc.n_loops_closed, "gba_merged": lc.n_gba_merged,
            "n_kf": int(st.n_kf), "n_mp": int(st.n_mp)}


def longrun_ate(run, poses_gt):
    from multi_orb_slam_tpu_torch.geometry import align

    traj, n = run["traj"], len(poses_gt)
    est = np.stack([np.linalg.inv(np.asarray(T, np.float64))[:3, 3] for _, _, T, _ in traj])
    gt = np.stack([np.linalg.inv(poses_gt[min(f, n - 1)])[:3, 3] for f, *_ in traj])
    return float(align.ate_rmse(torch.from_numpy(est), torch.from_numpy(gt))), est


def phase_system_longrun(dev):
    """`system-longrun`: `tests/test_longrun.py`'s 520-frame circuit at 640x480
    through `System(DUAL_RGBD)` with loop closing and global BA, on graphs.
    Fails unless the test's four assertions hold (frames not OK, keyframe
    cadence, the low-contrast stretch's cadence, capacity), a loop is
    closed and a GBA merged, every kernel launched (the three that run only
    in graphs as often as the replays say), no function holds two graph
    entries at the same shapes and static arguments, and the peak memory
    at the last frame is within LONG_MEMORY_GROWTH_MB of frame 300's (unless
    a capture came between).  Then a second pass of the same frames in a
    fresh `System` (its graphs already captured): fails unless it gives the
    first pass's row (`longrun_row`) and its final keyframe poses and map
    points to the bit.  Returns the first pass's launch counts."""
    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.io import synthetic
    from multi_orb_slam_tpu_torch.ops import orb
    from multi_orb_slam_tpu_torch.utils import graphs

    calib, frames, poses_gt = longrun_scene(dev)
    n = len(frames)
    cfg = SlamConfig(n_cams=C, width=W, height=H, th_depth=4.0,
                     orb=orb.ORBConfig(n_features=1024))
    print(f"  System(DUAL_RGBD) on graphs, loop closing and run_gba on; the default SlamConfig "
          f"(1024 features, max_kf {cfg.max_kf}, max_mp {cfg.max_mp}, local_cap "
          f"{cfg.local_cap}, new_mp_per_cam {cfg.new_mp_per_cam}) with th_depth 4.0 as the test "
          f"sets it")
    voc = loop_vocabulary(frames, cfg)
    run = longrun_pass(frames, calib, cfg, voc)
    sys_, states, ms_, syncs = run["system"], run["states"], run["ms"], run["syncs"]
    kf_frames, kf_slots, relocs = run["kf_frames"], run["kf_slots"], run["relocs"]
    captures, loops, memory = run["captures"], run["loops"], run["memory"]
    launches, replayed, traj = run["launches"], run["replayed"], run["traj"]
    lc, st = sys_.loop_closer, sys_.map
    ate, est = longrun_ate(run, poses_gt)
    not_ok = sum(1 for x in states if x != tracking.TrackState.OK)
    n_created = len(kf_frames)
    lo, hi = synthetic.LONGRUN_LOW_CONTRAST
    rate_low = sum(1 for f in kf_frames if lo <= f < hi) / (hi - lo)
    rate_all = n_created / n
    n_alloc_failed, n_kf, n_mp = int(st.n_alloc_failed), int(st.n_kf), int(st.n_mp)
    reused = len(kf_slots) - len(set(kf_slots))
    final_fid = st.kf_frame_id.tolist()
    final_valid = st.kf_valid.tolist()
    for rec in loops:
        rec["slots_hold_them_at_the_end"] = (
            final_valid[rec["kf_a"]] and final_fid[rec["kf_a"]] == rec["kf_a_frame"]
            and final_valid[rec["kf_b"]] and final_fid[rec["kf_b"]] == rec["kf_b_frame"])
    # one GBA dispatched a loop closed (run_gba); one not merged was superseded
    superseded = lc.n_loops_closed - lc.n_gba_merged
    per_fn = collections.Counter(name for name, _ in graphs.all_entries())
    caught = collections.Counter(c["entry"].split("[")[0] for c in captures)
    duplicates = signature_groups()
    print(f"  states: {sum(1 for x in states if x == tracking.TrackState.OK)} OK, {not_ok} not OK "
          f"(frames {[i for i, x in enumerate(states) if x != tracking.TrackState.OK]}; the "
          f"test's bound at 320x240 {LONG_TEST_MAX_NOT_OK}: "
          f"{'held' if not_ok <= LONG_TEST_MAX_NOT_OK else 'missed'}; the phase's limit "
          f"{LONG_MAX_NOT_OK}, the JAX package's own count at 640x480); "
          f"relocalization calls {len(relocs)}, found {sum(ok for _, ok in relocs)} "
          f"(frames {[f for f, ok in relocs if ok]})")
    print(f"  keyframes created {n_created} (cadence 1/{n / max(n_created, 1):.1f}) at frames "
          f"{kf_frames}; slots {kf_slots} ({reused} inserted into a slot used before)")
    print(f"  low-contrast frames {lo}-{hi - 1}: {rate_low:.4f} keyframes a frame against "
          f"{rate_all:.4f} over the run (limit {LONG_RATE_SLACK[0]} x + {LONG_RATE_SLACK[1]})")
    for rec in loops:
        print(f"  loop closed at frame {rec['frame']}: kf {rec['kf_a']} (frame {rec['kf_a_frame']})"
              f" -> kf {rec['kf_b']} (frame {rec['kf_b_frame']}), BoW {rec['bow']} / RANSAC "
              f"{rec['ransac']} / LM {rec['lm']} / total {rec['total']}; the frame "
              f"{rec['frame_ms']:.2f} ms; the slots still hold those keyframes at the end: "
              f"{rec['slots_hold_them_at_the_end']}")
    print(f"  loop candidates verified {len(lc.verifications)}, loops closed "
          f"{lc.n_loops_closed}, loop pairs {lc.loop_pairs}")
    print(f"  GBAs dispatched {lc.n_loops_closed}, merged {lc.n_gba_merged} "
          f"({run['merged_before_shutdown']} before shutdown(); pending at the end "
          f"{run['pending_at_end']}), superseded {superseded}")
    print(f"  final n_kf {n_kf} of {cfg.max_kf}, n_mp {n_mp} of {cfg.max_mp}, n_alloc_failed "
          f"{n_alloc_failed}; ATE over all {len(traj)} frames {ate:.4f} m")
    print(f"  track_rgbd ms: median {np.median(ms_):.2f}, p99 {np.percentile(ms_, 99):.2f}, "
          f"max {ms_.max():.2f}, total {ms_.sum() / 1e3:.2f} s; frames that created a keyframe "
          f"median {np.median(ms_[kf_frames]) if kf_frames else float('nan'):.2f}; host syncs "
          f"a frame median "
          f"{np.median(syncs):.0f}, max {max(syncs)}")
    for c in captures:
        print(f"    frame {c['frame']} captured {c['entry']}: warm-up {c['warmup_ms']:.1f} ms, "
              f"capture {c['capture_ms']:.1f} ms (the frame {c['frame_ms']:.2f} ms)")
    print(f"  graph entries per function (the whole process; captured in this run): "
          f"{ {k: (v, caught.get(k, 0)) for k, v in sorted(per_fn.items())} }")
    print(f"  entries of one function at the same shapes and static arguments: "
          f"{duplicates or 'none'}")
    for f, m in sorted(memory.items()):
        print(f"  frame {f}: torch.cuda.max_memory_allocated {m['peak_mb']:.1f} MiB, allocated "
              f"{m['allocated_mb']:.1f} MiB (the {n} frames on the card included), captures so "
              f"far {m['captures_so_far']}")
    print(f"  kernel launches {launches}; of the replays (calls x captures' counts) {replayed}")
    f0, f1 = LONG_MEMORY_FRAMES[1], LONG_MEMORY_FRAMES[2]
    growth = memory[f1]["peak_mb"] - memory[f0]["peak_mb"]
    captured_between = [c for c in captures if f0 < c["frame"] <= f1]
    if captured_between:
        print(f"  captures between frames {f0} and {f1} (the memory bound is not held): "
              f"{[(c['frame'], c['entry']) for c in captured_between]}")

    # the second pass: the same frames, a fresh System, the graphs captured
    again = longrun_pass(frames, calib, cfg, voc)
    ate2, _ = longrun_ate(again, poses_gt)
    row, row2 = longrun_row(run), longrun_row(again)
    st2, ms2 = again["system"].map, again["ms"]
    same_map = torch.equal(st.kf_Tcw, st2.kf_Tcw) and torch.equal(st.mp_pos, st2.mp_pos)
    poses = [np.asarray(T) for _, _, T, _ in traj]
    poses2 = [np.asarray(T) for _, _, T, _ in again["traj"]]
    parted = next((i for i, (x, y) in enumerate(zip(poses, poses2)) if not np.array_equal(x, y)),
                  None if len(poses) == len(poses2) else min(len(poses), len(poses2)))
    print(f"  second pass, a fresh System on the same frames: the same row {row == row2}, the "
          f"final keyframe poses and map points the same bits {same_map}, every frame's pose "
          f"the same bits {parted is None}"
          + ("" if parted is None else f" (first apart at frame {parted})"))
    for label, r, a_, m_ in (("first", row, ate, ms_), ("second", row2, ate2, ms2)):
        print(f"    {label} pass: not OK {len(r['not_ok'])}, keyframes {len(r['keyframes'])}, "
              f"loops {r['loops']}, GBAs dispatched {r['gba_dispatched']} merged "
              f"{r['gba_merged']}, n_kf {r['n_kf']}, n_mp {r['n_mp']}, ATE {a_:.4f} m, "
              f"track_rgbd median {np.median(m_):.2f} ms, p99 {np.percentile(m_, 99):.2f} ms")
    print(json.dumps({"system_longrun": {
        "frames": n, "not_ok": not_ok, "keyframes": kf_frames, "rate_low": rate_low,
        "rate_all": rate_all, "loops": loops, "gba": {"dispatched": lc.n_loops_closed,
                                                      "merged": lc.n_gba_merged,
                                                      "superseded": superseded},
        "n_kf": n_kf, "n_mp": n_mp, "n_alloc_failed": n_alloc_failed, "ate_m": ate,
        "ms": {"median": float(np.median(ms_)), "p99": float(np.percentile(ms_, 99)),
               "max": float(ms_.max())},
        "host_syncs_median": float(np.median(syncs)), "captures": captures,
        "memory": memory, "slot_reuses": reused, "launches": launches,
        "second_pass": {"same_row": row == row2, "same_map_bits": same_map,
                        "first_frame_apart": parted, "row": row2, "ate_m": ate2,
                        "ms": {"median": float(np.median(ms2)),
                               "p99": float(np.percentile(ms2, 99))},
                        "captures": len(again["captures"])}}}))

    failures = []
    if not_ok > LONG_MAX_NOT_OK:
        failures.append(f"{not_ok}/{n} frames not OK")
    if not n // 20 <= n_created <= n // 6:
        failures.append(f"{n_created} keyframes for {n} frames")
    if not rate_low <= LONG_RATE_SLACK[0] * rate_all + LONG_RATE_SLACK[1]:
        failures.append(f"low-contrast cadence {rate_low:.3f} against {rate_all:.3f}")
    if n_alloc_failed != 0 or not n_kf < cfg.max_kf - 1 or not n_mp < cfg.max_mp:
        failures.append(f"capacity: n_alloc_failed {n_alloc_failed}, n_kf {n_kf}, n_mp {n_mp}")
    if lc.n_loops_closed < 1 or lc.n_gba_merged < 1:
        failures.append(f"{lc.n_loops_closed} loops closed, {lc.n_gba_merged} GBAs merged")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        failures.append(f"never launched {missing}")
    try:
        check_replayed("system-longrun", launches, replayed)
    except AssertionError as e:
        failures.append(str(e))
    if duplicates:
        failures.append(f"graph entries at the same shapes and static arguments: {duplicates}")
    if growth > LONG_MEMORY_GROWTH_MB and not captured_between:
        failures.append(f"peak memory grew {growth:.1f} MiB from frame {f0} to frame {f1} "
                        f"with no capture between")
    if not (np.isfinite(est).all() and bool(torch.isfinite(st.kf_Tcw).all())):
        failures.append("NaN or inf in a pose")
    if row != row2 or not same_map:
        failures.append(f"the second pass is not the first: {row2} against {row}, the final map "
                        f"the same bits {same_map}, first frame apart {parted}")
    if failures:
        raise AssertionError("system-longrun: " + "; ".join(failures))
    return launches


OVERFLOW_FRAMES = 25
OVERFLOW_H, OVERFLOW_W = 240, 320
OVERFLOW_K = (520.9, 521.0, 160.0, 120.0)
OVERFLOW_CFG = dict(n_cams=1, max_feat=512, max_kf=24, max_mp=768, local_cap=512,
                    ba_local_cap=768, max_frames_kf=5, width=OVERFLOW_W, height=OVERFLOW_H)


def overflow_run(frames, calib, cfg, eager):
    """`tests/test_capacity.py`'s overflow run: `Tracker(calib, cfg)` with
    the mapping stage as the keyframe callback, on graphs or under
    `graphs.eager()`: per-frame states, the map's fill before each mapping
    stage, the final map and the launch counts."""
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.mapping import local_mapping
    from multi_orb_slam_tpu_torch.ops import kernels
    from multi_orb_slam_tpu_torch.utils import graphs

    fill = []
    with graphs.eager() if eager else contextlib.nullcontext():
        tr = tracking.Tracker(calib, cfg, device=calib.K.device)

        def kf_cb(kf_slot):
            fill.append(int(tr.map.n_mp))
            return local_mapping.run_mapping_stage(tr.map, kf_slot, tr.frame_id, calib, cfg)

        tr.kf_inserted_cb = kf_cb
        kernels.reset_launch_counts()
        states, n_mp = [], []
        t = time.perf_counter()
        for g, d in frames:
            tr.process(g, d)
            states.append(int(tr.state))
            n_mp.append(int(tr.map.n_mp))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    return {"states": states, "n_mp": n_mp, "fill_before_stage": fill, "map": tr.map,
            "frame_id": tr.frame_id, "launches": dict(kernels.LAUNCHES), "s": secs}


def over_ninety_percent(state):
    """`state` with filler points (valid, long tracked, observed by no
    keyframe: the eviction's first victims) in the lowest free slots until
    the store is over 90% full."""
    M = state.mp_valid.shape[0]
    n_fill = int(0.90 * M) + 20 - int(state.n_mp)
    free = torch.nonzero(~state.mp_valid[:M - 1])[:n_fill, 0]
    put = lambda x, v: x.index_put((free,), v)  # noqa: E731
    slots = free.to(torch.int32)
    return state._replace(
        mp_valid=put(state.mp_valid, torch.ones_like(free, dtype=torch.bool)),
        mp_visible=put(state.mp_visible, torch.full_like(slots, 40)),
        mp_found=put(state.mp_found, 10 + slots % 30),
        mp_first_frame=put(state.mp_first_frame, torch.full_like(slots, -1)),
        n_mp=state.n_mp + free.numel())


def relief_graphs_vs_eager(run, calib, cfg):
    """The overflow run's final map filled over 90% (`over_ninety_percent`)
    through one mapping stage at its newest keyframe, on graphs and under
    `graphs.eager()`: (free slots before, after on graphs, map fields apart
    from the eager call's)."""
    from multi_orb_slam_tpu_torch.mapping import local_mapping
    from multi_orb_slam_tpu_torch.utils import graphs

    state = over_ninety_percent(run["map"])
    fids = torch.where(state.kf_valid, state.kf_frame_id, torch.full_like(state.kf_frame_id, -1))
    kf = int(torch.argmax(fids))
    out = {}
    for mode in ("graphs", "eager"):
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            out[mode] = local_mapping.run_mapping_stage(graphs.clone(state), kf, run["frame_id"],
                                                        calib, cfg)
    M = state.mp_valid.shape[0]
    apart = [f for f, a, b in zip(state._fields, out["graphs"], out["eager"])
             if not torch.equal(a, b)]
    return M - int(state.n_mp), M - int(out["graphs"].n_mp), apart


def phase_overflow(dev):
    """The capacity overflow run of `tests/test_capacity.py` (25 frames, one
    320x240 camera, a map ~2x too small) on graphs and under
    `graphs.eager()`: the same per-frame states, `n_mp` after every frame
    and `n_alloc_failed`, and every field of the final map bit-equal, the
    test's own bounds held, every kernel of the path launched.  Returns the
    graph run's launch counts."""
    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.geometry import camera as cam_mod
    from multi_orb_slam_tpu_torch.io import synthetic
    from multi_orb_slam_tpu_torch.ops import orb

    K = np.asarray(OVERFLOW_K, np.float32)
    seq = synthetic.make_sequence(n_frames=OVERFLOW_FRAMES, K=K,
                                  T_rc=np.eye(4, dtype=np.float32)[None], height=OVERFLOW_H,
                                  width=OVERFLOW_W, seed=2, n_points=4000, trajectory="orbit")
    frames = [(torch.from_numpy(np.asarray(g, np.float32)).to(dev),
               torch.from_numpy(np.asarray(d, np.float32)).to(dev))
              for g, d in zip(seq.grays, seq.depths)]
    cfg = SlamConfig(**OVERFLOW_CFG, orb=orb.ORBConfig(n_features=512))
    calib = cam_mod.CameraParams(
        K=torch.from_numpy(K)[None].to(dev), dist=torch.zeros((1, 5), device=dev),
        T_rc=torch.eye(4, device=dev)[None], bf=torch.tensor(40.0, device=dev),
        width=OVERFLOW_W, height=OVERFLOW_H)
    eager = overflow_run(frames, calib, cfg, eager=True)
    graph = overflow_run(frames, calib, cfg, eager=False)
    M = cfg.max_mp
    apart = [f for f, a, b in zip(graph["map"]._fields, graph["map"], eager["map"])
             if not torch.equal(a, b)]
    n_ok = sum(1 for x in graph["states"] if x == 1)
    failed = int(graph["map"].n_alloc_failed)
    relieved = sum(1 for x in graph["fill_before_stage"] if x > int(0.90 * M))
    print(f"overflow: tests/test_capacity.py's run ({OVERFLOW_FRAMES} frames, one camera at "
          f"{OVERFLOW_W}x{OVERFLOW_H}, max_kf {cfg.max_kf}, max_mp {M}), Tracker with the mapping "
          f"stage; eager {eager['s']:.2f} s, graphs {graph['s']:.2f} s (captures included)")
    print(f"  states {''.join(str(x) for x in graph['states'])} ({n_ok} OK; eager "
          f"{''.join(str(x) for x in eager['states'])}); n_mp after each frame {graph['n_mp']}")
    print(f"  map fill before each mapping stage {graph['fill_before_stage']} of {M} "
          f"({relieved} stages over the 90% mark, where the stage's graph takes relieve_capacity "
          f"to >= {max(M // 10, 64)} free slots); n_alloc_failed {failed} (eager "
          f"{int(eager['map'].n_alloc_failed)}); final map fields apart from the eager run's: "
          f"{apart or 'none'}")
    print(f"  kernel launches on graphs {graph['launches']}, eager {eager['launches']}")
    free0, free1, relief_apart = relief_graphs_vs_eager(graph, calib, cfg)
    print(f"  the final map filled to {M - free0} of {M} points, one mapping stage at its newest "
          f"keyframe: {free0} free slots before, {free1} after on graphs (relieve_capacity's "
          f"target {max(M // 10, 64)}); fields apart from the eager stage's: "
          f"{relief_apart or 'none'}")
    failures = []
    if free1 < max(M // 10, 64) or relief_apart:
        failures.append(f"capacity relief: {free1} free slots, fields apart {relief_apart}")
    if (graph["states"] != eager["states"] or graph["n_mp"] != eager["n_mp"]
            or failed != int(eager["map"].n_alloc_failed)):
        failures.append("states, n_mp or n_alloc_failed differ from the eager run's")
    if "mp_pos" in apart:
        failures.append("the final map's positions differ from the eager run's")
    if n_ok < 18 or int(graph["map"].n_mp) > M or not (
            failed > 0 or int(graph["map"].n_mp) < int(0.95 * M)):
        failures.append(f"{n_ok} frames OK, n_mp {int(graph['map'].n_mp)}, n_alloc_failed "
                        f"{failed}")
    missing = [k for k, v in graph["launches"].items() if v <= 0]
    if missing:
        failures.append(f"never launched {missing}")
    if failures:
        raise AssertionError("overflow: " + "; ".join(failures))
    return graph["launches"]


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
AB_FRAMES = 30                     # frames of each run of the pipelined A/B
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
    from multi_orb_slam_tpu_torch.utils import graphs

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
    with graphs.eager():
        _, t_eager = timed(lambda: frame.build_frame_stereo(gl, gr, calib, orb_cfg))
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
          f"frame {t_all:.2f} as a replay of its graph, {t_eager:.2f} eager")
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
        ba0 = local_ba.STATS.read().get("solves", 0)
        kernels.reset_launch_counts()
        (rc, slam), text, secs = run_driver(stereo_kitti.run, [settings, root, "--out", out])
        launches = dict(kernels.LAUNCHES)
        solves = local_ba.STATS.read().get("solves", 0) - ba0
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
    from multi_orb_slam_tpu_torch.utils import metrics

    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/seq"
        poses = write_tum_rig_sequence(root, DRIVER_FRAMES)
        print(f"  io/png.py, host ms to decode one 640x480 image (the best of 3), every row "
              f"written with the filter named: {png_decode_ms(tmp)}")
        out, kf_out = f"{tmp}/traj.txt", f"{tmp}/kf.txt"
        kernels.reset_launch_counts()
        with metrics.tracing():     # the timing report below reads the tracer's spans
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
    """The first AB_FRAMES of the same frames through the TUM driver without
    and with `--pipelined`, in turns (off, on, on, off), after the counted
    run above has warmed the card: each run's median tracking and
    whole-frame times.  Every run must track every frame under the ATE
    limit."""
    from multi_orb_slam_tpu_torch.drivers import rgbd_tum

    for name in ("associations.txt", "associations2.txt"):
        with open(f"{root}/{name}") as f:
            lines = f.read().splitlines()[:AB_FRAMES]
        with open(f"{root}/ab_{name}", "w") as f:
            f.write("\n".join(lines) + "\n")
    poses = poses[:AB_FRAMES]
    runs = []
    for pipelined in (False, True, True, False):
        out = f"{tmp}/ab.txt"
        rc, text, secs = run_driver(rgbd_tum.main, [
            str(REPO_DIR / "configs/multi.yaml"), root, f"{root}/ab_associations.txt",
            "--assoc2", f"{root}/ab_associations2.txt",
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


DEGRADED_FRAMES = 120
DEGRADED_K = (520.9, 521.0, 320.0, 240.0)
DEGRADED_SEED, DEGRADED_POINTS, DEGRADED_NOISE_SEED = 0, 4000, 7
# tools/make_tum_dataset.py's settings.yaml (the port keeps its own copy:
# that tool imports the JAX package and cv2)
TUM_SETTINGS_YAML = """%YAML:1.0
Camera.fx: {fx}
Camera.fy: {fy}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.k1: 1.0e-9
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.k3: 0.0
Camera.width: {w}
Camera.height: {h}
Camera.fps: 30.0
Camera.bf: 40.0
Camera.RGB: 1
ThDepth: 40.0
DepthMapFactor: {depth_factor}
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""
# BASELINE_MEASURED.md's round-5 rows on the same 120 frames (accuracy, ATE
# RMSE in cm: clean, degraded)
BASELINE_ATE_CM = {"JAX package": (0.19, 0.21), "reference C++": (0.77, 0.81)}


def _write_tum_frame(task):
    """One frame's four PNGs (grey 8-bit, depth 16-bit at DepthMapFactor)."""
    from multi_orb_slam_tpu_torch.io import png

    root, name, grays, depths = task
    for c, (rgb, dep) in enumerate((("rgb", "depth"), ("rgb2", "depth2"))):
        png.write_png(f"{root}/{rgb}/{name}", np.clip(grays[c], 0, 255).astype(np.uint8))
        png.write_png(f"{root}/{dep}/{name}", np.clip(
            depths[c] * DRIVER_DEPTH_FACTOR, 0, 65535).astype(np.uint16))


def write_tum_dataset(root, seq, T_rc, pool):
    """`tools/make_tum_dataset.py`'s layout for `seq`: rgb/, depth/, rgb2/,
    depth2/ (written by `pool`'s processes), associations.txt,
    associations2.txt, settings.yaml and calibration.txt (the rig's cam1 ->
    cam2 transform inverted, as that tool writes it)."""
    import os

    for sub in ("rgb", "depth", "rgb2", "depth2"):
        os.makedirs(f"{root}/{sub}")
    names = [f"{ts:.6f}.png" for ts in seq.timestamps]
    list(pool.map(_write_tum_frame, [(root, nm, g, d) for nm, g, d in
                                     zip(names, seq.grays, seq.depths)]))
    for fname, (rgb, dep) in (("associations.txt", ("rgb", "depth")),
                              ("associations2.txt", ("rgb2", "depth2"))):
        with open(f"{root}/{fname}", "w") as f:
            f.write("\n".join(f"{ts:.6f} {rgb}/{nm} {ts:.6f} {dep}/{nm}"
                              for ts, nm in zip(seq.timestamps, names)) + "\n")
    fx, fy, cx, cy = DEGRADED_K
    with open(f"{root}/settings.yaml", "w") as f:
        f.write(TUM_SETTINGS_YAML.format(fx=fx, fy=fy, cx=cx, cy=cy, w=W, h=H,
                                         depth_factor=DRIVER_DEPTH_FACTOR))
    T_21 = np.linalg.inv(np.asarray(T_rc[1], np.float64))
    with open(f"{root}/calibration.txt", "w") as f:
        for r in range(3):
            f.write(" ".join(f"{v:.9f}" for v in T_21[r, :3]) + "\n")
        f.write(" ".join(f"{v:.9f}" for v in T_21[:3, 3]) + "\n")


def phase_driver_degraded(dev):
    """`driver-rgbd-degraded`: `tools/make_tum_dataset.py`'s default
    sequence (120 frames, orbit, seed 0, 4000 squares, 640x480, the real
    rig), clean and through `degrade_sequence(SensorModel(), seed=7)`,
    written as TUM-layout PNGs with `io/png.py` and tracked by
    `drivers/rgbd_tum --pipelined --no-realtime`.  Fails unless each run
    tracks every frame under ATE_LIMIT_M.  Returns {"clean", "degraded"}:
    each run's launch counts."""
    import os

    from multi_orb_slam_tpu_torch.drivers import rgbd_tum
    from multi_orb_slam_tpu_torch.io import synthetic
    from multi_orb_slam_tpu_torch.ops import kernels

    T_rc = bench_rig(dev).T_rc.cpu().numpy()
    K = np.asarray(DEGRADED_K, np.float32)
    workers = max(1, min(8, os.cpu_count() or 1))
    rows, launches, failures = [], {}, []
    with tempfile.TemporaryDirectory() as tmp, synthetic.render_pool(workers) as pool:
        t = time.perf_counter()
        world = synthetic.make_box_world(seed=DEGRADED_SEED, n_points=DEGRADED_POINTS)
        poses = synthetic.orbit_trajectory(DEGRADED_FRAMES, seed=DEGRADED_SEED + 1)
        frames = synthetic.render_frames(world, K, T_rc, poses, H, W, pool)
        clean = synthetic.SyntheticSequence([g for g, _ in frames], [d for _, d in frames],
                                            poses, np.arange(DEGRADED_FRAMES) / 30.0)
        render_s = time.perf_counter() - t
        t = time.perf_counter()
        degraded = synthetic.degrade_sequence(clean, synthetic.SensorModel(),
                                              seed=DEGRADED_NOISE_SEED)
        degrade_s = time.perf_counter() - t
        t = time.perf_counter()
        for name, seq in (("clean", clean), ("degraded", degraded)):
            write_tum_dataset(f"{tmp}/{name}", seq, T_rc, pool)
        print(f"driver-rgbd-degraded: tools/make_tum_dataset.py's default sequence "
              f"({DEGRADED_FRAMES} frames, orbit, seed {DEGRADED_SEED}, {DEGRADED_POINTS} squares, "
              f"{W}x{H}, the real rig) rendered in {render_s:.1f} s by {workers} processes, "
              f"degraded (SensorModel(), seed {DEGRADED_NOISE_SEED}) in {degrade_s:.1f} s, both "
              f"written with io/png.py in {time.perf_counter() - t:.1f} s")
        for name in ("clean", "degraded"):
            root = f"{tmp}/{name}"
            out, kf_out = f"{tmp}/{name}_traj.txt", f"{tmp}/{name}_kf.txt"
            kernels.reset_launch_counts()
            (rc, slam), text, secs = run_driver(rgbd_tum.run, [
                f"{root}/settings.yaml", root, f"{root}/associations.txt",
                "--assoc2", f"{root}/associations2.txt",
                "--calibration", f"{root}/calibration.txt",
                "--pipelined", "--no-realtime", "--out", out, "--kf-out", kf_out])
            launches[name] = dict(kernels.LAUNCHES)
            centres = tum_centres(out)
            ate = (centre_ate(centres, poses) if len(centres) == DEGRADED_FRAMES
                   else float("inf"))
            row = {"input": name, "tracked": len(centres), "frames": DEGRADED_FRAMES,
                   "ate_mm": ate * 1e3, "track_median_ms": median_tracking_ms(text),
                   "frame_median_ms": median_frame_ms(text), "run_s": secs,
                   "keyframes": len(tum_centres(kf_out)), "launches": launches[name]}
            rows.append(row)
            i = 0 if name == "clean" else 1
            base = ", ".join(f"{k} {v[i]:.2f} cm" for k, v in BASELINE_ATE_CM.items())
            print(f"  {name}: {row['tracked']}/{DEGRADED_FRAMES} frames tracked, ATE "
                  f"{ate * 1e2:.4f} cm (BASELINE_MEASURED.md on the same frames: {base}), "
                  f"keyframes {row['keyframes']}, track_rgbd median {row['track_median_ms']:.2f} "
                  f"ms, a whole frame median {row['frame_median_ms']:.2f} ms; launches "
                  f"{launches[name]}")
            missing = [k for k, v in launches[name].items() if v <= 0]
            if rc != 0 or len(centres) != DEGRADED_FRAMES or not ate < ATE_LIMIT_M or missing:
                failures.append(f"{name}: rc {rc}, {len(centres)} frames, ATE {ate:.4f} m, "
                                f"never launched {missing}")
    print(json.dumps({"driver_rgbd_degraded": rows}))
    if failures:
        raise AssertionError("driver-rgbd-degraded: " + "; ".join(failures))
    return launches


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


MONO_SIZES = (300, 2000)     # test_mono_init.py's; two cameras' worth of 1024 features


def phase_mono_init(dev):
    """The two-view initializer on the card (eager, then the graph entry's
    capture and a replay) and on the CPU, on the same 256 draws, on both
    scenes at each size: the replay the eager bits, the CPU's decisions."""
    from multi_orb_slam_tpu_torch.frontend import initializer
    from multi_orb_slam_tpu_torch.utils import graphs

    fn = initializer.solve_two_view
    failures = []
    for n in MONO_SIZES:
        for planar, seed in ((False, 0), (True, 1)):
            uv1, uv2, mask, K, R_true = two_views(planar, n=n)
            idx_h, idx_f = initializer.sample_hypotheses(torch.from_numpy(mask), 256,
                                                         torch.Generator().manual_seed(seed))
            cpu_args = tuple(torch.from_numpy(np.asarray(a)) for a in (uv1, uv2, mask)) + (
                idx_h, idx_f, torch.from_numpy(K))
            args = tuple(a.to(dev) for a in cpu_args)
            with graphs.eager():
                eager, eager_ms = host_ms(lambda: fn(*args))
            entry = fn.entry(*args)
            captured = entry.graph is None
            g, first_ms = host_ms(lambda: fn(*args))
            g, replay_ms = host_ms(lambda: fn(*args))
            same = all(torch.equal(a, b) for a, b in zip(g, eager))
            c, c_ms = host_ms(lambda: fn(*cpu_args))
            g = type(g)(*[v.cpu() for v in g])
            diff_good = float((c.is_good != g.is_good).float().mean())
            dR = float((c.R - g.R).abs().max())
            ang = float(np.degrees(np.arccos(np.clip((np.trace(g.R.numpy() @ R_true.T) - 1) / 2,
                                                     -1, 1))))
            name = f"{'planar' if planar else 'general'} n={n}"
            capture = (f" (warm-up {entry.warmup_ms:.1f}, capture {entry.capture_ms:.1f})"
                       if captured and entry.graph is not None else "")
            print(f"mono-init {name}: card ok {bool(g.ok)} homography "
                  f"{bool(g.used_homography)}, CPU ok {bool(c.ok)} homography "
                  f"{bool(c.used_homography)}; is_good differs on {diff_good:.2%} of {n}, R "
                  f"within {dR:.2e}, rotation error against the truth {ang:.3f} deg; the replay "
                  f"the eager bits {same}; ms: eager {eager_ms:.1f}, first graph call "
                  f"{first_ms:.1f}{capture}, replay {replay_ms:.2f}, CPU {c_ms:.1f}")
            # accepted, with the scene's model, at test_mono_init.py's size; at
            # 2000 the port's seed-0 draws leave the general scene unaccepted
            # on both devices and in the SVD form alike (a RANSAC draw's
            # outcome, as the reference's own key 1 at 1000: ROADMAP C)
            accepted = n != MONO_SIZES[0] or (bool(g.ok) and bool(g.used_homography) == planar)
            if not (same and accepted and bool(g.ok) == bool(c.ok)
                    and bool(g.used_homography) == bool(c.used_homography)
                    and diff_good <= 0.01 and dR < 1e-4):
                failures.append(name)
    entry_table(("solve_two_view",))
    if failures:
        raise AssertionError(f"mono-init: the replay, the eager call and the CPU disagree on "
                             f"{failures}")


def orb_reference(frames, cfg):
    """`orb-reference`: `extract_orb_reference` on frame 0 of each orbit
    camera (640x480, 1024 features): eager, the capture and a replay on the
    card, and the CPU run; the replay must be the eager bits and share >=
    99% of the CPU run's keypoints.  The keypoints it shares with the
    batched CUDA-path `extract_orb` are printed."""
    from multi_orb_slam_tpu_torch.ops import orb
    from multi_orb_slam_tpu_torch.utils import graphs

    fn = orb.extract_orb_reference

    def keys(f):
        xy, lvl, ok = f.xy.cpu().numpy(), f.level.cpu().numpy(), f.valid.cpu().numpy()
        return set(map(tuple, np.concatenate([xy, lvl[:, None]], 1)[ok].tolist()))

    failures = []
    for cam in range(C):
        img = frames[0][0][cam].contiguous()
        with graphs.eager():
            eager, eager_ms = host_ms(lambda: fn(img, cfg.orb))
        g, first_ms = host_ms(lambda: fn(img, cfg.orb))
        g, replay_ms = host_ms(lambda: fn(img, cfg.orb))
        same = all(torch.equal(a, b) for a, b in zip(g, eager))
        c, c_ms = host_ms(lambda: fn(img.cpu(), cfg.orb))
        batched = orb.extract_orb(img, cfg.orb)
        kg, kc, kb = keys(g), keys(c), keys(batched)
        cpu_share = len(kg & kc) / max(len(kc), 1)
        desc_rows = float((g.desc.cpu() == c.desc).all(-1).float().mean())
        entry = fn.entry(img, cfg.orb)
        print(f"orb-reference camera {cam}: {len(kg)} keypoints; the replay the eager bits "
              f"{same}; shared with the CPU run {cpu_share:.4f} (descriptor rows equal "
              f"{desc_rows:.4f}); shared with the batched CUDA-path extract_orb "
              f"{len(kg & kb) / max(len(kb), 1):.4f} of its {len(kb)}; ms: eager {eager_ms:.1f}, "
              f"first graph call {first_ms:.1f} (capture {entry.capture_ms or 0.0:.1f}), "
              f"replay {replay_ms:.2f}, CPU {c_ms:.1f}")
        if not (same and cpu_share >= 0.99):
            failures.append(f"camera {cam}: replay bit-equal {same}, CPU share {cpu_share:.4f}")
    entry_table(("extract_orb_reference",))
    if failures:
        raise AssertionError("orb-reference: " + "; ".join(failures))


# ---------------------------------------------------------------------------
# The distributed path: global BA, place recognition and extraction on ranks
# ---------------------------------------------------------------------------

# the default SlamConfig's capacity: max_kf keyframes x 2 cameras x 1024
# feature slots, max_mp points
DIST_KF, DIST_POINTS, DIST_SLOTS = 192, 24576, 1024
DIST_OUTER, DIST_CG = 8, 40
DIST_POSE_NOISE, DIST_POINT_NOISE = 0.01, 0.05   # rad / m of the free poses' start, m of the points'
DIST_WORDS = 10 ** 6                  # DBoW2's ORBvoc: k = 10, L = 6
DIST_WORDS_PER_KF = 4096              # `placerec/database.make_empty_db`'s budget_all
DIST_DRYRUN_WORLD = 2                 # the dry run's largest world: one orbit frame a rank
DIST_TCW_TOL = 5e-4                   # tests/test_dist_ba.py:50-52
# the points: 99% within 1 mm (a point seen only through mono rows, where u
# lies left of the image and ur < 0, slides along its ray; ROADMAP C), and
# every point within 1 cm (on an H100 the farthest came within 0.90-1.50 mm)
DIST_POS_Q, DIST_POS_TOL, DIST_POS_MAX_TOL = 0.99, 1e-3, 1e-2


def distributed_problem(calib):
    """`drivers/bench_dist_ba`'s synthetic problem (its K, bf and 0.5 px
    noise) at the default capacity on the bench rig's two cameras: points in
    a 16 m cube about the middle of the keyframes' 9.55 m track, so about
    half of each camera's random slots see their point; the free poses and
    the points start off the truth."""
    from multi_orb_slam_tpu_torch.drivers import bench_dist_ba

    return bench_dist_ba.make_problem(
        DIST_KF, DIST_POINTS, DIST_SLOTS, T_rc=calib.T_rc.cpu().numpy(), half=8.0,
        centre=(-0.025 * (DIST_KF - 1), 0.0, 0.0), pose_noise=DIST_POSE_NOISE,
        point_noise=DIST_POINT_NOISE)


def distributed_store(world):
    """A [192 world, 4096] sparse BoW store over 10^6 words (distinct ids and
    L1-normalised values a row), queried with its last keyframe, which lies
    on the last rank's shard."""
    rng = np.random.default_rng(world)
    K = DIST_KF * world
    ids = np.stack([rng.choice(DIST_WORDS, DIST_WORDS_PER_KF, replace=False)
                    for _ in range(K)]).astype(np.int32)
    vals = rng.random((K, DIST_WORDS_PER_KF), dtype=np.float32)
    vals /= vals.sum(1, keepdims=True)
    return ids, vals, K - 1


def pose_errors(Tcw, Tcw_gt):
    from multi_orb_slam_tpu_torch.geometry import se3

    d = se3.log(torch.from_numpy(np.asarray(Tcw)) @ se3.inverse(torch.from_numpy(Tcw_gt)))
    return d.norm(dim=-1).numpy()


def step_device_ms(prob, dev):
    """Device time of one step on one process with no group, summed over its
    kernels from `torch.profiler`, and the number of device operations."""
    from multi_orb_slam_tpu_torch.parallel import dist_ba, dryrun, multihost

    mesh = multihost.global_mesh(device=dev)
    flat = dist_ba.shard_problem(
        dist_ba.flatten_problem(*(prob[k] for k in dryrun.FLAT_KEYS), 1), mesh)
    cal = [torch.from_numpy(np.asarray(prob[k], np.float32)).to(dev) for k in ("T_rc", "K_intr")]
    bf = torch.tensor(float(prob["bf"]), device=dev)
    step = dist_ba.make_dist_ba_step(mesh, DIST_OUTER, DIST_CG)
    step(flat, *cal, bf)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        step(flat, *cal, bf)
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    kernels = [k for e in prof.events() if e.device_type == cpu for k in e.kernels]
    return sum(k.duration for k in kernels) / 1e3, len(kernels)


def phase_distributed(dev, frames):
    """`parallel/`: the distributed global BA at the default capacity on a
    real NCCL process group of one rank (no host synchronisation in the
    step) and on 2 and 4 gloo ranks sharing the card, against each other and
    against the same problem on the CPU; `dryrun_multichip` at world 1 (NCCL)
    and 2 (gloo), each rank extracting its own orbit frame; returns each
    world's per-rank kernel launches."""
    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.ops import orb
    from multi_orb_slam_tpu_torch.parallel import dist_ba, dryrun, multihost

    cfg = SlamConfig(n_cams=C, width=W, height=H, orb=orb.ORBConfig(n_features=1024))
    t0 = time.perf_counter()
    prob = distributed_problem(bench_rig(dev))
    stores = {w: distributed_store(w) for w in (1, 2)}
    print(f"distributed: problem of {DIST_KF} keyframes x {C} cameras x {DIST_SLOTS} slots, "
          f"{DIST_POINTS} points, stores of {DIST_KF} keyframes a rank x {DIST_WORDS_PER_KF} "
          f"words of {DIST_WORDS}, made in {time.perf_counter() - t0:.1f} s")

    def inputs(world):
        ids, vals, q = stores[world]
        return dict(frames=frames[:world], orb_cfg=cfg.orb, problem=prob, n_outer=DIST_OUTER,
                    cg_iters=DIST_CG, db_ids=ids, db_vals=vals, n_words=DIST_WORDS, query=q)

    runs = {}
    for name, world, backend, fn, args in (
            ("world1_nccl", 1, "nccl", dryrun.dryrun_multichip, (inputs(1),)),
            ("world2_gloo", 2, "gloo", dryrun.dryrun_multichip, (inputs(2),)),
            ("world4_gloo", 4, "gloo", dryrun.run_ba, (prob, DIST_OUTER, DIST_CG))):
        t, t_wall = time.perf_counter(), time.time()
        runs[name] = multihost.spawn_local(fn, world, backend, "cuda", *args)
        print(f"  {name}: {world} rank(s) started, ran and joined in "
              f"{time.perf_counter() - t:.1f} s, the first {world} call(s) began "
              f"{min(r['started_at'] for r in runs[name]) - t_wall:.1f} s after the start")
    ba = {k: [r["ba"] if "ba" in r else r for r in v] for k, v in runs.items()}
    ref = ba["world1_nccl"][0]

    t = time.perf_counter()
    mesh_cpu = multihost.global_mesh(device="cpu")
    flat = dist_ba.shard_problem(
        dist_ba.flatten_problem(*(prob[k] for k in dryrun.FLAT_KEYS), 1), mesh_cpu)
    Tcw_cpu, pos_cpu, costs_cpu = dist_ba.make_dist_ba_step(mesh_cpu, DIST_OUTER, DIST_CG)(
        flat, torch.from_numpy(prob["T_rc"]), torch.from_numpy(prob["K_intr"]),
        torch.tensor(float(prob["bf"])))
    cpu_s = time.perf_counter() - t
    dev_ms, n_ops = step_device_ms(prob, dev)

    free = prob["kf_free"]
    err0 = pose_errors(prob["kf_Tcw"], prob["poses_gt"])[free]
    failures, rows = [], []

    def against(Tcw, pos):
        dp = np.abs(np.asarray(pos) - ref["pos"]).max(-1)
        return float(np.abs(np.asarray(Tcw) - ref["Tcw"]).max()), float(dp.max()), \
            float(np.quantile(dp, DIST_POS_Q))

    for name, ranks in list(ba.items()) + [("cpu_world1", [{
            "Tcw": Tcw_cpu.numpy(), "pos": pos_cpu.numpy(), "costs": costs_cpu.numpy(),
            "backend": "none", "world_size": 1, "s_per_outer_iter": cpu_s / DIST_OUTER,
            "sync_checked": False}])]:
        r = ranks[0]
        err1 = pose_errors(r["Tcw"], prob["poses_gt"])[free]
        dT, dp_max, dp_q = against(r["Tcw"], r["pos"])
        same = all(np.array_equal(x["Tcw"], r["Tcw"]) and np.array_equal(x["pos"], r["pos"])
                   for x in ranks)
        row = {"run": name, "world_size": r["world_size"], "backend": r["backend"],
               "device": "cpu" if name.startswith("cpu") else "cuda",
               "outer": DIST_OUTER, "cg_iters": DIST_CG,
               "s_per_outer_iter": r["s_per_outer_iter"],
               "cost_first": float(r["costs"][0]), "cost_last": float(r["costs"][-1]),
               "pose_err_mean_before": float(err0.mean()), "pose_err_mean_after": float(err1.mean()),
               "dTcw_vs_world1": dT, "dpos_max_vs_world1": dp_max,
               f"dpos_q{DIST_POS_Q}_vs_world1": dp_q, "ranks_bit_equal": same,
               "no_host_sync_checked": r["sync_checked"]}
        rows.append(row)
        print(f"  {name}: {r['world_size']} rank(s) on {row['device']} ({r['backend']}): "
              f"{r['s_per_outer_iter'] * 1e3:.2f} ms per outer iteration, cost "
              f"{row['cost_first']:.6g} -> {row['cost_last']:.6g}, free-pose error "
              f"{err0.mean():.5f} -> {err1.mean():.5f}; against world 1 (NCCL): poses within "
              f"{dT:.3g}, points within {dp_max:.3g} (q{DIST_POS_Q} {dp_q:.3g}); ranks the "
              f"same bits {same}; step checked free of host syncs {r['sync_checked']}")
        if not (np.isfinite(r["Tcw"]).all() and np.isfinite(r["pos"]).all()):
            failures.append(f"{name}: NaN or inf")
        if not (r["costs"][-1] < r["costs"][0] and err1.mean() < err0.mean()):
            failures.append(f"{name}: cost {row['cost_first']} -> {row['cost_last']}, "
                            f"pose error {err0.mean()} -> {err1.mean()}")
        if not (same and dT <= DIST_TCW_TOL and dp_q <= DIST_POS_TOL
                and dp_max <= DIST_POS_MAX_TOL):
            failures.append(f"{name}: ranks equal {same}, poses {dT}, points q{DIST_POS_Q} "
                            f"{dp_q}, max {dp_max}")
    if not ref["sync_checked"]:
        failures.append("world 1 on NCCL was not run under set_sync_debug_mode('error')")
    print(f"  the step at world 1 on one process under torch.profiler: {n_ops} device "
          f"operations, {dev_ms:.3f} ms of device time; {ref['n_obs']} observations in "
          f"{ref['n_slots']} slots; all_reduce calls a step: {DIST_OUTER * (DIST_CG + 2)} "
          f"(on gloo each stages its tensor through the host)")

    launches, extraction, scorer = {}, [], []
    for name in ("world1_nccl", "world2_gloo"):
        launches[name] = [r["launches"] for r in runs[name]]
        for r in runs[name]:
            want = orb.extract_orb(torch.from_numpy(frames[r["rank"]]).to(dev), cfg.orb)
            equal = all(np.array_equal(r["features"][f], v.cpu().numpy())
                        for f, v in want._asdict().items())
            n_kp = int(r["features"]["valid"].sum())
            extraction.append({"run": name, "rank": r["rank"], "ms": r["extract_s"] * 1e3,
                               "keypoints": n_kp, "bit_equal_to_one_process": equal,
                               "launches": r["launches"]})
            scorer.append({"run": name, "rank": r["rank"], "keyframes": len(r["scores"]),
                           "max_abs_err": r["score_err"], "bit_equal": r["scores_bit_equal"],
                           "best": r["best"]})
            print(f"  {name} rank {r['rank']}: frame {r['rank']} extracted in "
                  f"{r['extract_s'] * 1e3:.2f} ms ({n_kp} keypoints, bit-equal to one process's "
                  f"extraction {equal}), launches {r['launches']}; scores of "
                  f"{len(r['scores'])} keyframes within {r['score_err']:.3g} of the whole "
                  f"table's (bit-equal {r['scores_bit_equal']}), best {r['best']}")
            if not (equal and r["launches"]["fast_score"] > 0
                    and r["launches"]["gather_patches"] > 0):
                failures.append(f"{name} rank {r['rank']}: features equal {equal}, "
                                f"launches {r['launches']}")
    print(json.dumps({"distributed": {"runs": rows, "extraction": extraction, "scorer": scorer,
                                      "step_device_ms": dev_ms, "step_device_ops": n_ops}}))
    if failures:
        raise AssertionError("distributed: " + "; ".join(failures))
    return {k: {name: [c[k] for c in v] for name, v in launches.items()}
            for k in ("fast_score", "gather_patches", "window_match", "point_sums")}


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
    (tracking, mapped, system, firsts, fused, scan, graph, system_graphs,
     stepwise) = phase_main_paths(dev)
    t = elapsed("orbit paths and system-reloc", t)
    loop, loop_ctx = phase_system_loop(dev)
    t = elapsed("system-loop", t)
    phase_determinism(loop_ctx)
    t = elapsed("determinism", t)
    longrun = phase_system_longrun(dev)
    t = elapsed("system-longrun", t)
    overflow = phase_overflow(dev)
    t = elapsed("overflow", t)
    stereo = phase_system_stereo(dev)
    t = elapsed("system-stereo", t)
    driver = phase_driver_rgbd(dev)
    t = elapsed("driver-rgbd", t)
    degraded = phase_driver_degraded(dev)
    t = elapsed("driver-rgbd-degraded", t)
    phase_driver_live(dev)
    t = elapsed("driver-live", t)
    phase_mono_init(dev)
    t = elapsed("mono-init", t)
    distributed = phase_distributed(dev, firsts)
    elapsed("distributed", t)
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s since the start")
    from multi_orb_slam_tpu_torch.utils import graphs

    # every signature captured in the run: the port's compile time, per function
    print(json.dumps({"graph_entries": [
        {"entry": entry_label(e), "calls": e.n_calls, "warmup_ms": e.warmup_ms,
         "capture_ms": e.capture_ms} for _, e in graphs.all_entries()]}))
    rows = []
    for name, res in results.items():
        source, replaces = KERNELS[name]
        extra = {"kitti_shapes": kitti[name]} if name in kitti else {}
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": mapped[name],
                     "launches_tracking_only": tracking[name],
                     "launches_system": system[name], "launches_loop": loop[name],
                     "launches_stereo": stereo[name], "launches_driver": driver[name],
                     "launches_distributed": distributed[name],
                     "launches_fused": fused[name], "launches_scan": scan[name],
                     "launches_mapping_graph": graph[name],
                     "launches_mapping_stepwise": stepwise[name],
                     "launches_system_graphs": system_graphs[name],
                     "launches_longrun": longrun[name], "launches_overflow": overflow[name],
                     "launches_degraded": degraded["degraded"][name],
                     "launches_degraded_clean": degraded["clean"][name],
                     **res, **extra})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
