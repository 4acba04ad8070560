"""The mapping stage as one CUDA graph a keyframe.

`local_mapping._mapping_stage_fused` reads nothing back to the host (local
BA's LM loop and the stage's two branches are decided on the device), so
on the card its ~10,000 launches can be captured once and replayed: the
JAX package's one jitted program a keyframe.  `MappingStep` owns that
stage for one (device, configuration, window bucket):

- fixed buffers for what the stage reads: the map state, the calibration,
  the keyframe slot and the frame id (the two scalars are filled in on the
  device with `fill_`, never copied from the host);
- the stage is captured on first use and replayed once a keyframe; its
  outputs stay in the graph's memory, rewritten by the next replay, so
  `run` hands the caller a copy (~25 MB at the default capacities) that
  nothing else aliases: the tracker's `FusedStep.load`, the loop closer
  and `save_map` never hold a buffer of the step;
- the kernel wrappers count launches on the host, and a replay calls no
  wrapper: the launches the capture made (`window_match`, `point_sums`)
  are added to `kernels.LAUNCHES` on every replay; the device counters of
  `local_ba.STATS` and `local_mapping.STATS` / `BA_WINDOWS` count inside
  the graph.  The warm-up's and the capture's own counts are taken back.

On the card a failed capture raises; nothing falls back to eager launches.
On the CPU (the tests) the same object calls the body directly, buffers
and copies included.
"""

from __future__ import annotations

import time

import torch

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..ops import kernels
from ..optim import local_ba
from ..utils import graphs
from . import local_mapping
from . import map_state as ms

# the device counters a stage adds to
COUNTERS = (local_ba.STATS, local_mapping.STATS, local_mapping.BA_WINDOWS)


class MappingStep:
    """`_mapping_stage_fused` for one window bucket on fixed buffers.

    Use: `load(state=..., kf_slot=..., frame_id=..., calib=...)` (a field
    that already is its buffer costs nothing; the slot and the frame id may
    be ints or tensors), then `run()`, which returns the stage's new map as
    the caller's own copy.  `body()` is the stage called eagerly on the
    buffers (what a replay must equal)."""

    def __init__(self, calib: cam_mod.CameraParams, cfg: SlamConfig, device,
                 n_free: int, n_fixed: int, phases: tuple):
        self.device = torch.device(device)
        self.cfg = cfg
        self.n_free, self.n_fixed, self.phases = n_free, n_fixed, phases
        self.calib = cam_mod.CameraParams(*[
            v.to(self.device).clone() if isinstance(v, torch.Tensor) else v for v in calib])
        self.kf_slot = torch.zeros((), dtype=torch.int32, device=self.device)
        self.frame_id = torch.zeros((), dtype=torch.int32, device=self.device)
        self.state = None
        self.out = None
        self.graph = None
        self.graph_launches = {}
        self.n_captures = 0
        self.n_replays = 0
        self.warmup_ms = self.capture_ms = None

    def load(self, state: ms.MapState | None = None, kf_slot=None, frame_id=None,
             calib: cam_mod.CameraParams | None = None) -> None:
        """Copy the inputs into the buffers; the first state allocates its
        buffers, as a clone."""
        if calib is not None:
            graphs.copy_into(self.calib, calib)
        if state is not None:
            if self.state is None:
                self.state = graphs.clone(state)
            else:
                graphs.copy_into(self.state, state)
        for buf, v in ((self.kf_slot, kf_slot), (self.frame_id, frame_id)):
            if isinstance(v, torch.Tensor):
                buf.copy_(v.reshape(()))
            elif v is not None:
                buf.fill_(int(v))

    def body(self) -> ms.MapState:
        if self.state is None:
            raise RuntimeError("MappingStep: no state loaded")
        return local_mapping._mapping_stage_fused(
            self.state, self.kf_slot, self.frame_id, self.calib, self.cfg,
            self.n_free, self.n_fixed, self.phases)

    def _body(self) -> None:
        self.out = self.body()

    def capture(self) -> None:
        """Warm the stage up on a side stream (library handles, the LM
        schedule's tables, the counters), then capture it into a CUDA
        graph.  The buffers are left as they were; neither the warm-up's
        nor the capture's launches and counts remain counted."""
        from ..ops import _build

        _build.load()
        launches0 = dict(kernels.LAUNCHES)
        cur = torch.cuda.current_stream(self.device)
        torch.cuda.synchronize(self.device)
        saved = [c.save(self.device) for c in COUNTERS]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            self.body()
        cur.wait_stream(side)
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        launches1 = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._body()
        torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        self.graph_launches = {k: v - launches1[k] for k, v in kernels.LAUNCHES.items()}
        kernels.LAUNCHES.update(launches0)
        for c, s in zip(COUNTERS, saved):
            c.restore(self.device, s)
        self.graph = graph
        self.n_captures += 1
        self.warmup_ms = (t1 - t0) * 1e3
        self.capture_ms = (t2 - t1) * 1e3

    def run(self) -> ms.MapState:
        """One mapping stage: a replay of the captured graph on the card
        (captured on the first call), the body itself on the CPU.  Returns
        a copy of the new map."""
        if self.device.type != "cuda":
            self._body()
            return graphs.clone(self.out)
        if self.graph is None:
            self.capture()
        with graphs.no_host_sync(self.device):
            self.graph.replay()
            out = graphs.clone(self.out)
        kernels.add_launches(self.graph_launches)
        self.n_replays += 1
        return out


# the captured stages, one per (device, configuration, window bucket)
STEPS: dict = {}


def step_for(device, cfg: SlamConfig, calib: cam_mod.CameraParams, n_free: int, n_fixed: int,
             phases: tuple) -> MappingStep:
    """The `MappingStep` of one window bucket, made on first use."""
    device = torch.device(device)
    key = (device, cfg, n_free, n_fixed, phases)
    step = STEPS.get(key)
    if step is None:
        step = STEPS[key] = MappingStep(calib, cfg, device, n_free, n_fixed, phases)
    return step


def run_stage(state: ms.MapState, kf_slot, frame_id, calib: cam_mod.CameraParams,
              cfg: SlamConfig, n_free: int, n_fixed: int, phases: tuple) -> ms.MapState:
    """`run_mapping_stage` with every stage on: load, run (a replay on the
    card), and the new map as the caller's own copy."""
    step = step_for(state.mp_pos.device, cfg, calib, n_free, n_fixed, phases)
    step.load(state=state, kf_slot=kf_slot, frame_id=frame_id, calib=calib)
    return step.run()
