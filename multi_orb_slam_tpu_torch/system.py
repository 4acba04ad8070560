"""System facade: the public API.

Counterpart of `multi_orb_slam_tpu/system.py` (which re-designs the reference
`System` class, src/System.cc): construction from settings + calibration
files or from `calib` + `cfg`, `track_rgbd` (one camera or the dual rig),
`track_stereo` (depth from left / right ORB matching), localization mode switching,
reset, shutdown, trajectory savers, map checkpoints.  The reference's three
free-running threads are a deterministic staged pipeline: the tracking step
runs inline; the mapping stage runs at each keyframe insertion; the loop
stage runs after mapping (`loop/loop_closing.py`: it indexes the keyframe
for place recognition, detects, verifies and corrects loops, and enqueues a
global BA that merges into the map at the next keyframe or at `shutdown`).
A lost tracker is found again by `reloc/relocalization.py` against the loop
stage's vocabulary and database.

The system runs on the CUDA device unless the caller asks for another one
(`device="cpu"`, as the CPU tests do); with `device=None` and no CUDA device
the constructor raises.

A map checkpoint is a pickle of numpy arrays under the reference's field
names, descriptor words as uint32, so that a file written by either package
loads in the other.  The place-recognition database is not part of it, in
either package: after `load_map` relocalization finds a keyframe only once
it has been indexed again (`placerec.database.add_keyframe`).
"""

from __future__ import annotations

import pickle
import types
from typing import Optional

import numpy as np
import torch

from . import convert, resolve_device
from .config import SlamConfig
from .frontend import frame as frame_mod, tracking
from .geometry import camera as cam_mod, se3
from .io import config_io, tum
from .mapping import local_mapping, map_state as ms
from .utils import metrics as metrics_mod


class Sensor:
    RGBD = "rgbd"
    DUAL_RGBD = "dual_rgbd"
    STEREO = "stereo"


class System:
    def __init__(
        self,
        settings_path: Optional[str] = None,
        calibration_path: Optional[str] = None,
        sensor: str = Sensor.DUAL_RGBD,
        calib: Optional[cam_mod.CameraParams] = None,
        cfg: Optional[SlamConfig] = None,
        enable_mapping: bool = True,
        enable_loop_closing: bool = True,
        pipelined: bool = False,
        pipeline_depth: int = 1,
        device=None,
    ):
        self.device = resolve_device(device)
        n_cams = 2 if sensor == Sensor.DUAL_RGBD else 1
        if calib is None or cfg is None:
            if settings_path is None:
                raise ValueError("System needs calib and cfg, or a settings file")
            st = config_io.load_settings(settings_path, n_cams=n_cams)
            T12 = (config_io.load_calibration(calibration_path)
                   if calibration_path else None)
            calib = config_io.camera_params_from(st, T12, n_cams, device=self.device)
            # ThDepth scaled to meters as mbf*ThDepth/fx (Tracking.cc:162)
            th_depth_m = st.bf * st.th_depth / float(st.K[0][0])
            cfg = SlamConfig(
                n_cams=n_cams,
                max_feat=st.n_features,
                width=st.width, height=st.height,
                scale_factor=st.scale_factor,
                n_levels=st.n_levels,
                th_depth=th_depth_m,
                max_frames_kf=int(st.fps),
                orb=config_io.orb_config_from(st),
            )
            self.depth_map_factor = st.depth_map_factor
        else:
            self.depth_map_factor = 1.0
        self.cfg = cfg
        self.sensor = sensor
        self.enable_mapping = enable_mapping
        self.enable_loop_closing = enable_loop_closing
        self.tracker = tracking.Tracker(calib, cfg, pipelined=pipelined,
                                        pipeline_depth=pipeline_depth,
                                        device=self.device)
        self.calib = self.tracker.calib      # on the system's device
        self.loop_closer = None
        if enable_loop_closing:
            from .loop import loop_closing
            self.loop_closer = loop_closing.LoopCloser(self.calib, cfg)
        if enable_mapping:
            self.tracker.kf_inserted_cb = self._on_keyframe
        self.tracker.reloc_cb = self._relocalize
        # looked up at call time: a caller may replace `loop_closer`
        self.tracker.reset_cb = self._reset_loop_closer
        self.tracker.reloc_ready_fn = (
            lambda: self.loop_closer is not None
            and self.loop_closer.voc is not None)
        self._reset_requested = False
        self._covis_pending = None  # async covis-count for ba_adaptive
        self.metrics = metrics_mod.Metrics()

    # ------------------------------------------------------------------
    # Pipeline hooks
    # ------------------------------------------------------------------

    def _on_keyframe(self, kf_slot: int):
        with self.metrics.span("system/keyframe", self.device):
            m = self._keyframe_stages(kf_slot)
        self.metrics.count("keyframes_inserted")
        return m

    def _keyframe_stages(self, kf_slot: int):
        """The mapping stage, then the loop stage, on a new keyframe."""
        # adaptive-window hint: the PREVIOUS keyframe's covisible count,
        # queued below and read here one keyframe later (by which time the
        # device has finished it: no stall of the queue)
        hint = (int(metrics_mod.host("covis_hint", self._covis_pending))
                if self._covis_pending is not None else None)
        with metrics_mod.span("mapping/stage", self.device):
            m = local_mapping.run_mapping_stage(
                self.tracker.map, kf_slot, self.tracker.frame_id,
                self.calib, self.cfg, covis_hint=hint,
            )
        if self.cfg.ba_adaptive:
            self._covis_pending = local_mapping.covis_kf_count(m, kf_slot)
        if self.loop_closer is not None:
            n_loops_before = self.loop_closer.n_loops_closed
            # a copy, not a view: the loop stage replaces kf_Tcw, and the
            # correction below is taken against the pose from before it
            pose_mid = m.kf_Tcw[kf_slot].clone()
            with metrics_mod.span("loop/stage", self.device):
                m = self.loop_closer.process_keyframe(m, kf_slot)
            if self.loop_closer.n_loops_closed > n_loops_before:
                # a loop correction JUMPED the newest keyframe; the live
                # tracking pose rigidly attached to it must follow or the
                # next frame searches the corrected map from the
                # uncorrected pose and drops to LOST.  Local-BA nudges are
                # deliberately NOT propagated: the tracker re-anchors to
                # the optimized map through matching every frame.
                self.tracker.queue_pose_correction(
                    se3.inverse(pose_mid) @ m.kf_Tcw[kf_slot])
        return m

    def _relocalize(self, fr):
        """Tracking-lost recovery (reference Tracking::Relocalization)."""
        if self.loop_closer is None or self.loop_closer.voc is None:
            return False, None, None, 0
        from .reloc import relocalization
        with self.metrics.span("system/relocalize", self.device):
            return relocalization.relocalize(
                self.tracker.map, fr, self.loop_closer.voc,
                self.loop_closer.db, self.calib, self.cfg)

    def _reset_loop_closer(self):
        if self.loop_closer is not None:
            self.loop_closer.reset()

    # ------------------------------------------------------------------
    # Public API (reference include/System.h:63-127)
    # ------------------------------------------------------------------

    def track_rgbd(self, im1, depth1, im2=None, depth2=None,
                   timestamp: Optional[float] = None):
        """TrackRGBD (reference src/System.cc:183-243).  Images are
        grayscale float arrays (numpy or tensors); depth in meters
        (DepthMapFactor already applied by the caller).  Returns the rig
        pose Tcw [4, 4] as a numpy array, which waits for the device."""
        with self.metrics.span("system/track_rgbd", self.device, frame=self.tracker.frame_id):
            if self._reset_requested:
                self._do_reset()
            on_device = self._on_device
            if self.sensor == Sensor.DUAL_RGBD:
                if im2 is None or depth2 is None:
                    raise ValueError("a dual-camera system needs im2 and depth2")
                grays = torch.stack([on_device(im1), on_device(im2)])
                depths = torch.stack([on_device(depth1), on_device(depth2)])
            else:
                grays = on_device(im1)[None]
                depths = on_device(depth1)[None]
            self.tracker.process(grays, depths, timestamp)
            return metrics_mod.host("pose_readback", self.tracker.Tcw)

    def _on_device(self, a) -> torch.Tensor:
        return metrics_mod.upload(a, self.device, torch.float32)

    def timing_report(self) -> str:
        """Per-stage summary of this system's spans (the reference's chrono
        prints, structured): host ms, and device ms where a span carries
        events.  Spans are recorded only while tracing is on
        (`utils.metrics.enable()`, or a recording `torch.profiler`)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # every span's end event reached
        return self.metrics.report()

    def track_stereo(self, im_left, im_right, timestamp: Optional[float] = None):
        """TrackStereo (the reference keeps this entry point though its
        stereo build is disabled, src/System.cc:132-181): depth from
        left<->right ORB matching, then the RGB-D pipeline.  Images are
        grayscale float arrays (numpy or tensors); returns Tcw [4, 4] as a
        numpy array."""
        with self.metrics.span("system/track_stereo", self.device, frame=self.tracker.frame_id):
            if self._reset_requested:
                self._do_reset()
            left, right = self._on_device(im_left), self._on_device(im_right)
            with metrics_mod.span("track/process", self.device):
                with metrics_mod.span("track/extract", self.device):
                    fr = frame_mod.build_frame_stereo(left, right, self.calib, self.cfg.orb)
                self.tracker.process_frame(fr, timestamp)
            return metrics_mod.host("pose_readback", self.tracker.Tcw)

    def activate_localization_mode(self):
        """Track against the frozen map; no new keyframes
        (reference System::ActivateLocalizationMode, System.cc:298-303)."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        self.tracker.only_tracking = False

    def reset(self):
        self._reset_requested = True

    def _do_reset(self):
        """Reset tracker AND loop closer together (the reference's
        System::Reset signals Tracking::Reset, which in turn requests
        LocalMapping/LoopClosing resets, src/Tracking.cc:2160-2206); the
        tracker notifies the loop closer through `reset_cb`."""
        self.tracker.reset()
        self._covis_pending = None
        self._reset_requested = False

    def shutdown(self):
        """Fold in any still-pending asynchronous GBA (the reference's
        Shutdown waits on isRunningGBA, System.cc:343-347); no free-running
        threads to join in this design."""
        self._flush_gba()

    def _flush_gba(self):
        if self.loop_closer is not None:
            self.tracker.map = self.loop_closer.merge_pending_gba(
                self.tracker.map)
            self.tracker.invalidate_local_cache()

    def get_tracking_state(self) -> int:
        return self.tracker.state

    def get_tracked_map_points(self) -> int:
        return self.tracker.last_n_inliers

    def get_tracked_keypoints_un(self):
        """Undistorted keypoints of the last frame with their match mask
        (reference System::GetTrackedKeyPointsUn, System.h:126)."""
        if self.tracker.prev_frame is None:
            return np.zeros((0, 2), np.float32), np.zeros((0,), bool)
        fr = self.tracker.prev_frame
        xy = fr.xy_und.reshape(-1, 2).cpu().numpy()
        matched = (self.tracker.prev_mp.reshape(-1) >= 0).cpu().numpy()
        valid = fr.valid.reshape(-1).cpu().numpy()
        return xy[valid], matched[valid]

    def change_calibration(self, settings_path: str,
                           calibration_path: Optional[str] = None):
        """Re-load camera settings (reference Tracking::ChangeCalibration,
        src/Tracking.cc:2208-2239).  Capacities (the static SlamConfig) are
        unchanged; intrinsics/distortion/rig extrinsics are replaced."""
        n_cams = self.cfg.n_cams
        st = config_io.load_settings(settings_path, n_cams=n_cams)
        T12 = (config_io.load_calibration(calibration_path)
               if calibration_path else None)
        self.calib = config_io.camera_params_from(st, T12, n_cams, device=self.device)
        self.depth_map_factor = st.depth_map_factor
        self.tracker.calib = self.calib
        if self.loop_closer is not None:
            self.loop_closer.calib = self.calib

    @property
    def map(self) -> ms.MapState:
        return self.tracker.map

    # ------------------------------------------------------------------
    # Trajectory export (reference src/System.cc:353-503)
    # ------------------------------------------------------------------

    def save_trajectory_tum(self, path: str):
        self._flush_gba()
        frames = [
            (ts, Tcw) for _, ts, Tcw, lost in self.tracker.absolute_trajectory()
            if not lost
        ]
        tum.write_trajectory_tum(path, frames)

    def save_keyframe_trajectory_tum(self, path: str):
        self._flush_gba()
        state = self.map
        kf_valid = state.kf_valid.cpu().numpy()
        kf_fid = state.kf_frame_id.cpu().numpy()
        kf_Tcw = state.kf_Tcw.cpu().numpy()
        rows = []
        for k in np.nonzero(kf_valid)[0]:
            fid = int(kf_fid[k])
            rows.append((fid, self._ts_of_frame(fid), kf_Tcw[k]))
        rows.sort(key=lambda row: row[0])
        tum.write_trajectory_tum(path, [(ts, T) for _, ts, T in rows])

    def save_trajectory_kitti(self, path: str):
        self._flush_gba()
        poses = [Tcw for _, _, Tcw, lost in self.tracker.absolute_trajectory()
                 if not lost]
        tum.write_trajectory_kitti(path, poses)

    def _ts_of_frame(self, fid: int) -> float:
        for f, ts, _, _, _ in self.tracker.trajectory:
            if f == fid:
                return ts
        return fid / 30.0

    # ------------------------------------------------------------------
    # Map checkpointing (beyond the reference)
    # ------------------------------------------------------------------

    def save_map(self, path: str):
        """Write the map, the trajectory and the tracker's keyframe
        bookkeeping as a pickle of numpy arrays and plain numbers."""
        def host(v):
            return v.cpu().numpy() if isinstance(v, torch.Tensor) else v

        self.tracker._resolve_pending()
        payload = {
            "map": convert.to_numpy(self.tracker.map),
            "trajectory": [
                (fid, ts, host(ref), tuple(host(v) for v in rec), lost)
                for fid, ts, ref, rec, lost in self.tracker.trajectory],
            "frame_id": self.tracker.frame_id,
            "last_kf_slot": int(self.tracker.last_kf_slot),
            "last_kf_frame": int(self.tracker.last_kf_frame),
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    def load_map(self, path: str):
        """Read a checkpoint written by `save_map` of either package onto
        this system's device.  The tracker comes back LOST: it must
        relocalize.  Unpickling runs code: load only files you wrote."""
        def on_device(v):
            return torch.as_tensor(np.array(v), device=self.device)

        with open(path, "rb") as f:
            payload = pickle.load(f)
        missing = set(ms.MapState._fields) - set(payload["map"])
        if missing:
            raise ValueError(f"{path}: the map lacks {sorted(missing)}")
        self.tracker.map = convert.to_torch(
            types.SimpleNamespace(**payload["map"]), ms.MapState, self.device)
        self.tracker.invalidate_local_cache()
        self.tracker._pending = []
        self.tracker.trajectory = [
            (fid, ts, int(np.asarray(ref)),
             (on_device(rec[0]), on_device(rec[1]), on_device(rec[2])), lost)
            for fid, ts, ref, rec, lost in payload["trajectory"]]
        self.tracker.frame_id = payload["frame_id"]
        self.tracker.last_kf_slot = int(payload["last_kf_slot"])
        self.tracker.last_kf_frame = int(payload["last_kf_frame"])
        self.tracker._tstate_dirty = True
        self.tracker.state = tracking.TrackState.LOST  # must relocalize
