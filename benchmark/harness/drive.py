"""Driving the system under test: how a cell builds its `System`, feeds it
frames closed loop (the next frame goes in when the previous pose is back,
as a sequence is processed offline), times each frame on the host, and
wraps the layers' calls from outside.

A cell's `drive` (in `workloads/<cell>.json`):

- `fresh_system_each_pass`: true to run every pass of the traffic's pass
  order through a new `System` (each pass then repeats the warm pass's
  work, graph signatures included); false to keep one `System` and play the
  passes one after another;
- `warm_passes` (a fresh system each pass) or `warm_frames` (one system):
  the set-up's warm run, which captures every CUDA graph the window
  replays;
- `localization_after_warm`: switch the one system to localization mode
  after the warm run (`System.activate_localization_mode`);
- `settle_frames`, `blank_frames`: then feed the last warm system
  `settle_frames` more frames, the first `blank_frames` of them black with
  no depth, so that it is lost and found again and relocalization's graphs
  are captured in set-up too;
- `vocabulary`: `setup` (trained once from camera 0 of every
  `vocabulary_every`-th frame, k = 10, depth 4, 3 iterations, and given to
  each new system's loop closer, as a user loads a vocabulary file) or
  `online` (the loop closer trains its own, as the drivers run it).

The wrappers time a keyframe's callback (the mapping stage and the loop
stage behind it) and the loop closer's `process_keyframe`, and count
relocalizations; in a traced run they synchronise the device before and
after, so that their times are device-complete.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings

import numpy as np
import torch


def count_host_syncs(fn):
    """`fn()` under `torch.cuda.set_sync_debug_mode("warn")`: its result and
    the number of operations that made the host wait on the device."""
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(before)
    return out, sum("synchroniz" in str(w.message) for w in caught)


class Driver:
    def __init__(self, cell: dict, cfg: dict, sc, device, trace: bool):
        from multi_orb_slam_tpu_torch import system as system_mod

        self.system_mod = system_mod
        self.cell, self.cfg, self.sc = cell, cfg, sc
        self.drive = cell["drive"]
        self.device = device
        self.trace = trace and device.type == "cuda"
        self.voc = None
        self.systems = []          # every System made, in order
        self.cur = None            # the record of the frame being fed
        self.last_ok = None        # (input frame, its features) of the last frame left OK
        self.pairs = None
        if sc.assoc is not None:
            from multi_orb_slam_tpu_torch.drivers import rgbd_tum

            self.pairs = rgbd_tum.load_assoc_pairs(sc.assoc)

    # -- building ---------------------------------------------------------

    def _sync(self):
        if self.trace:
            torch.cuda.synchronize()

    def new_system(self):
        sm = self.system_mod
        sensor = {"dual_rgbd": sm.Sensor.DUAL_RGBD, "rgbd": sm.Sensor.RGBD}[self.cfg["sensor"]]
        cal = self.cfg.get("calibration")
        sysargs = self.cell.get("system", {})
        slam = sm.System(str(self.cfg["dir"] / self.cfg["settings"]),
                         str(self.cfg["dir"] / cal) if cal else None, sensor,
                         pipelined=sysargs.get("pipelined", False),
                         pipeline_depth=sysargs.get("pipeline_depth", 1),
                         device=self.device)
        if self.drive["vocabulary"] == "setup":
            from multi_orb_slam_tpu_torch.placerec import database

            if self.voc is None:
                self.voc = self.train_vocabulary(slam)
            lc = slam.loop_closer
            lc.voc, lc.db = self.voc, database.make_empty_db(slam.cfg.max_kf, self.voc.n_words,
                                                           device=self.device)
        self.instrument(slam)
        self.systems.append(slam)
        self.frame_id = 0
        return slam

    def train_vocabulary(self, slam):
        from multi_orb_slam_tpu_torch.ops import orb
        from multi_orb_slam_tpu_torch.placerec import vocabulary

        every = self.drive.get("vocabulary_every", 8)
        descs = []
        for f in range(0, len(self.sc.poses_gt), every):
            grey, _ = self.images(f)
            feats = orb.extract_orb(torch.as_tensor(grey[0], device=self.device), slam.cfg.orb)
            descs.append(feats.desc[feats.valid].cpu().numpy())
        return vocabulary.build_vocabulary(np.concatenate(descs), k=10, depth=4, iters=3,
                                           device=self.device)

    def instrument(self, slam):
        tr, lc = slam.tracker, slam.loop_closer
        on_kf, relocalize = tr.kf_inserted_cb, tr.reloc_cb

        def kf_cb(slot):
            self._sync()
            t = time.perf_counter()
            out = on_kf(slot)
            self._sync()
            self.cur["hook_ms"] += (time.perf_counter() - t) * 1e3
            self.cur["keyframes"] += 1
            return out

        def reloc_cb(fr):
            out = relocalize(fr)
            self.cur["relocalized"] += int(bool(out[0]))
            return out

        if on_kf is not None:
            tr.kf_inserted_cb = kf_cb
        tr.reloc_cb = reloc_cb
        if lc is not None:
            process = lc.process_keyframe

            def process_keyframe(state, kf_slot):
                loops, merged = lc.n_loops_closed, lc.n_gba_merged
                self._sync()
                t = time.perf_counter()
                out = process(state, kf_slot)
                self._sync()
                self.cur["loop_ms"] += (time.perf_counter() - t) * 1e3
                self.cur["loop_stages"] += 1
                self.cur["loops"] += lc.n_loops_closed - loops
                self.cur["gba_merged"] += lc.n_gba_merged - merged
                return out

            lc.process_keyframe = process_keyframe

    # -- feeding ----------------------------------------------------------

    def images(self, f: int):
        """(greys [C, H, W], depths [C, H, W]) float32 of input frame f, as
        fed (decoded from the PNGs for the TUM feed)."""
        if self.sc.greys is not None:
            return self.sc.greys[f], self.sc.depths[f]
        g, d = self.read_png(self.pairs[f])
        return g[None], d[None]

    def read_png(self, pair):
        """The TUM driver's read of one frame (`drivers/rgbd_tum.run`)."""
        from multi_orb_slam_tpu_torch.io import png

        root = os.path.dirname(self.sc.assoc)
        _, rgb_rel, _, d_rel = pair
        grey = png.read_gray(os.path.join(root, rgb_rel)).astype(np.float32)
        depth = png.read_png(os.path.join(root, d_rel)).astype(np.float32)
        return grey, depth * (1.0 / self.sc.depth_factor)

    @staticmethod
    def track(slam, greys, depths, k: int):
        if len(greys) > 1:
            return slam.track_rgbd(greys[0], depths[0], greys[1], depths[1], timestamp=k / 30.0)
        return slam.track_rgbd(greys[0], depths[0], timestamp=k / 30.0)

    def step(self, slam, f: int, k: int, keep_images: bool = False) -> dict:
        """Feed input frame f as frame k of this system's sequence; the
        frame's record."""
        rec = {"frame": f, "fid": self.frame_id, "sys": len(self.systems) - 1, "hook_ms": 0.0,
               "loop_ms": 0.0, "keyframes": 0, "loop_stages": 0, "loops": 0, "gba_merged": 0,
               "relocalized": 0,
               "decode_ms": None, "syncs": None}
        self.cur = rec
        self._sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.frame") if self.trace else contextlib.nullcontext():
            if self.pairs is not None:
                grey, depth = self.read_png(self.pairs[k % len(self.pairs)])
                rec["decode_ms"] = (time.perf_counter() - t0) * 1e3
                greys, depths = [grey], [depth]
                if keep_images:
                    rec["decoded"] = (grey, depth)
            else:
                greys, depths = self.sc.greys[f], self.sc.depths[f]
            if self.trace:
                pose, rec["syncs"] = count_host_syncs(
                    lambda: self.track(slam, greys, depths, k))
            else:
                pose = self.track(slam, greys, depths, k)
            self._sync()
        rec["t_end"] = time.perf_counter()
        rec["ms"] = (rec["t_end"] - t0) * 1e3
        rec["pose"] = np.asarray(pose, np.float64)
        rec["ok"] = slam.get_tracking_state() == 1
        if rec["ok"]:
            # a frame left OK is the tracker's previous frame for the next one
            self.last_ok = (f, slam.tracker.prev_frame)
        self.frame_id += 1
        return rec

    # -- the sequence -----------------------------------------------------

    def schedule(self):
        """An endless list of (start a new system?, input frame, k)."""
        order = self.sc.pass_order
        fresh = self.drive["fresh_system_each_pass"]
        k = 0
        while True:
            for j, f in enumerate(order):
                yield (fresh and j == 0) or (not fresh and k == 0), f, j if fresh else k
                k += 1

    def warm(self, frame_cap: int | None = None):
        """The set-up's warm run; returns the schedule the window follows
        (with a fresh system each pass, from the start of a pass)."""
        sched = self.schedule()
        n = (self.drive["warm_passes"] * len(self.sc.pass_order)
             if self.drive["fresh_system_each_pass"] else self.drive["warm_frames"])
        if frame_cap is not None:
            n = min(n, frame_cap)
        slam = None
        for _ in range(n):
            new, f, k = next(sched)
            if new:
                self.finish(slam)
                slam = self.new_system()
            self.step(slam, f, k)
        if self.drive.get("localization_after_warm"):
            slam.activate_localization_mode()
        settle = self.drive.get("settle_frames", 0)
        for j in range(settle if frame_cap is None else min(settle, frame_cap)):
            _, f, k = next(sched)
            if j < self.drive.get("blank_frames", 0):
                self.track(slam, np.zeros_like(self.images(f)[0]), np.zeros_like(self.images(f)[1]), k)
                self.frame_id += 1
            else:
                self.step(slam, f, k)
        self.slam = slam
        return self.schedule() if self.drive["fresh_system_each_pass"] else sched

    @staticmethod
    def finish(slam):
        """Close a pass: fold in a pending global BA, as `shutdown` does."""
        if slam is not None:
            slam.shutdown()

    def window(self, sched, seconds: float, stretch=None, keep: set | None = None,
               frame_cap: int | None = None):
        """Frames until `seconds` have passed and the traced stretch (if
        any) is read, or `frame_cap` frames: (records, window seconds)."""
        if self.drive["fresh_system_each_pass"]:
            self.finish(self.slam)
            self.slam = None
        recs = []
        self.t_first = t0 = time.perf_counter()
        for new, f, k in sched:
            i = len(recs)
            if frame_cap is not None:
                if i >= frame_cap:
                    break
            elif time.perf_counter() - t0 >= seconds and (stretch is None or stretch.done):
                break
            if new:
                self.finish(self.slam)
                self.slam = self.new_system()
            recs.append(self.step(self.slam, f, k, keep_images=keep is not None and i in keep))
            if stretch is not None:
                stretch.after()
        if stretch is not None:
            stretch.close()
        return recs, recs[-1]["t_end"] - t0 if recs else 0.0
