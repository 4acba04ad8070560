"""The fused tracking step as one CUDA graph a frame.

`track_frame_fused_images` reads nothing back to the host, so on the card
its ~30,000 launches (three pose BAs of 4 x 10 LM iterations, the three
searches, extraction, the insertion) can be captured once and replayed: the
JAX package's one jitted program a frame.  `FusedStep` owns that step:

- fixed buffers for everything the step reads: the calibration, the map
  state, the previous frame, its pose and map-point ids, the velocity,
  `tstate`, the local points, `frame_id` and the [C, H, W] grays and depths;
- the captured body ends by copying the step's outputs into those buffers,
  so one `replay()` is one frame and the next replay tracks from it;
- whatever replaces the tracker's state between frames (the mapping stage's
  new map, a pose correction, a rebuilt local cache, a reset, a LOST frame,
  a relocalization) goes in through `load`, which `copy_()`s each field that
  is not already the buffer;
- the kernel wrappers count launches on the host, and a replay calls no
  wrapper: the launches the capture made are added to `kernels.LAUNCHES` on
  every replay; the warm-up's and the capture's own launches do not count
  (`utils/graphs.capture`, which `graphs.graphed` captures with too).

On the card a failed capture raises; nothing falls back to eager launches.
On the CPU (the tests) the same object calls the body directly, buffers and
copies included.

`scan_chunk` is `tracking.track_frames_scan` on the card: G replays of a
graph of `tracking.scan_step`, back to back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..mapping import map_state as ms
from ..ops import kernels, search
from ..utils import graphs, metrics
from . import frame as frame_mod
from . import tracking

# the buffers `load` fills, in the body function's argument order
INPUTS = ("state", "prev", "prev_Tcw", "prev_mp", "velocity", "tstate", "local_pts")


class FusedStep:
    """One tracking frame on fixed buffers: `track_frame_fused_images`, or
    `tracking.scan_step` with `rebuild_local=True` (the local-point cache
    rebuilt on the device after an insertion), captured into a CUDA graph on
    first use and replayed once a frame.

    Use: `load(...)` the tracker's state (fields that already are the
    buffers cost nothing), `put_images(grays, depths)`, `run()`; then the
    buffers hold the new frame's state (`state`, `prev` = this frame,
    `prev_Tcw` = its pose, `prev_mp`, `velocity`, `tstate`, `local_pts`,
    `frame_id` + 1) and `scalars`, `ref_slot`, `ref_pose`, `ref_fid` its
    other outputs, all valid until the next `run()`.
    """

    def __init__(self, calib: cam_mod.CameraParams, cfg: SlamConfig, device,
                 rebuild_local: bool = False):
        self.device = torch.device(device)
        self.cfg = cfg
        self.rebuild_local = rebuild_local
        self.calib = cam_mod.CameraParams(*[
            v.to(self.device).clone() if isinstance(v, torch.Tensor) else v for v in calib])
        C, H, W = cfg.n_cams, calib.height, calib.width
        self.grays = torch.zeros((C, H, W), dtype=torch.float32, device=self.device)
        self.depths = torch.zeros((C, H, W), dtype=torch.float32, device=self.device)
        self.frame_id = torch.zeros((), dtype=torch.int32, device=self.device)
        self._frame_id_host = 0
        for name in INPUTS:
            setattr(self, name, None)
        self.scalars = self.ref_slot = self.ref_pose = self.ref_fid = None
        self.graph = None
        self.graph_launches = {}
        self.n_captures = 0
        self.n_replays = 0
        self.warmup_ms = self.capture_ms = None
        # pinned staging for images that come from the host: a slot is
        # reused once the copy out of it has run
        self._stage = None
        self._stage_events = None
        self._stage_pos = 0

    # -- inputs ------------------------------------------------------------

    def load(self, calib=None, frame_id=None, **fields) -> None:
        """Copy values into the buffers (`INPUTS` by name, `calib`,
        `frame_id`); a field that already is its buffer is not copied.  The
        first load of a field allocates its buffer, as a clone.  `tstate`
        may be a tuple of three ints, filled in on the device; `frame_id` an
        int (filled in where it differs from the buffer's) or a tensor."""
        if calib is not None:
            graphs.copy_into(self.calib, calib)
        for name, value in fields.items():
            if name not in INPUTS:
                raise TypeError(f"unknown input {name!r}")
            if value is None:
                continue
            buf = getattr(self, name)
            if name == "tstate" and not isinstance(value, torch.Tensor):
                if buf is None:
                    buf = torch.zeros(3, dtype=torch.int32, device=self.device)
                    setattr(self, name, buf)
                for i, v in enumerate(value):
                    buf[i].fill_(int(v))
            elif buf is None:
                if self.graph is not None:
                    raise RuntimeError(f"{name}: no buffer in the captured step")
                setattr(self, name, graphs.clone(value))
            else:
                graphs.copy_into(buf, value)
        if frame_id is not None:
            if isinstance(frame_id, torch.Tensor):
                self.frame_id.copy_(frame_id)
                self._frame_id_host = None
            elif frame_id != self._frame_id_host:
                self.frame_id.fill_(int(frame_id))
                self._frame_id_host = int(frame_id)

    def put_images(self, grays, depths) -> None:
        """Copy one frame's [C, H, W] grays and depths into their buffers:
        from the device as they are, from the host through pinned staging
        (a copy that does not make the host wait)."""
        for buf, x, i in ((self.grays, grays, 0), (self.depths, depths, 1)):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            if x.device == buf.device or buf.device.type == "cpu":
                buf.copy_(x)
                continue
            if self._stage is None:
                self._stage = torch.empty((2, 2) + tuple(buf.shape), dtype=buf.dtype,
                                          pin_memory=True)
                self._stage_events = [torch.cuda.Event() for _ in range(2)]
            slot = self._stage_pos % 2
            with metrics.wait("image_staging", self._stage_events[slot]):
                self._stage_events[slot].synchronize()
            self._stage[slot, i].copy_(x)
            buf.copy_(self._stage[slot, i], non_blocking=True)
            if i == 1:
                self._stage_events[slot].record()
                self._stage_pos += 1

    # -- the step ----------------------------------------------------------

    def _call(self):
        args = [getattr(self, name) for name in INPUTS]
        if self.rebuild_local:
            return tracking.scan_step(*args, self.grays, self.depths, self.calib,
                                      self.cfg, self.frame_id)
        (fr, st, Tcw, fmp, vel, tst, scalars, ref_slot, ref_pose,
         ref_fid) = tracking.track_frame_fused_images(*args, self.grays, self.depths,
                                                       self.calib, self.cfg, self.frame_id)
        return ((st, fr, Tcw, fmp, vel, tst, args[6], self.frame_id + 1),
                (scalars, ref_slot, ref_pose, ref_fid, Tcw))

    def _body(self):
        """The step, then its outputs copied into the input buffers."""
        carry, (self.scalars, self.ref_slot, self.ref_pose, self.ref_fid, _) = self._call()
        for name, value in zip(INPUTS + ("frame_id",), carry):
            graphs.copy_into(getattr(self, name), value)

    def _check_loaded(self):
        missing = [name for name in INPUTS if getattr(self, name) is None]
        if missing:
            raise RuntimeError(f"FusedStep: {missing} never loaded")

    def capture(self) -> None:
        """Warm the step up on a side stream, then capture the body into a
        CUDA graph (`graphs.capture`).  The buffers are left as they were;
        the launches of both do not count."""
        self._check_loaded()
        cap = graphs.capture(self.device, self._call, self._body)
        self.graph, self.graph_launches = cap.graph, cap.launches
        self.warmup_ms, self.capture_ms = cap.warmup_ms, cap.capture_ms
        self.n_captures += 1

    def run(self) -> None:
        """One frame: a replay of the captured graph on the card (captured
        on the first call), the body itself on the CPU."""
        if self.device.type != "cuda":
            self._check_loaded()
            self._body()
        else:
            if self.graph is None:
                self.capture()
            with graphs.no_host_sync(self.device), metrics.span("graph/replay", self.device):
                self.graph.replay()
            kernels.add_launches(self.graph_launches)
            self.n_replays += 1
        if self._frame_id_host is not None:
            self._frame_id_host += 1


# the captured scan steps, one per (device, configuration, image size): a
# chunk's graph is captured once and replayed by every later chunk
_SCAN_STEPS: dict = {}


def scan_chunk(state: ms.MapState, prev: frame_mod.FrameData, prev_Tcw, prev_mp, velocity,
               tstate, local_pts: search.LocalPoints, grays_G, depths_G,
               calib: cam_mod.CameraParams, cfg: SlamConfig, frame_id0):
    """`tracking.track_frames_scan` on the card: load the carry, then G
    replays of the graph of `scan_step`, each frame's outputs copied into
    the stacked [G, ...] outputs on the device.  Nothing is read back here;
    the carry that comes out is a copy, not the step's buffers."""
    dev = grays_G.device
    key = (dev, cfg, calib.width, calib.height)
    fs = _SCAN_STEPS.get(key)
    if fs is None:
        fs = _SCAN_STEPS[key] = FusedStep(calib, cfg, dev, rebuild_local=True)
    fs.load(calib=calib, state=state, prev=prev, prev_Tcw=prev_Tcw, prev_mp=prev_mp,
            velocity=velocity, tstate=tstate, local_pts=local_pts, frame_id=frame_id0)
    G = grays_G.shape[0]
    outs = None
    for g in range(G):
        fs.put_images(grays_G[g], depths_G[g])
        fs.run()
        with graphs.no_host_sync(dev):
            row = (fs.scalars, fs.ref_slot, fs.ref_pose, fs.ref_fid, fs.prev_Tcw)
            if outs is None:
                outs = tuple(torch.empty((G,) + t.shape, dtype=t.dtype, device=dev)
                             for t in row)
            for o, t in zip(outs, row):
                o[g].copy_(t)
    carry = tuple(graphs.clone(getattr(fs, name)) for name in INPUTS)
    return carry + (outs,)

