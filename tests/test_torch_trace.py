"""The port's tracer (`multi_orb_slam_tpu_torch/utils/metrics.py`) on the CPU:
spans nest with their parents, systems and frames; off it records nothing
and costs no range and no event; `enable()` or a recording `torch.profiler`
turns it on (the profiler's wait and warm-up steps do not); a span inside a
graph's warm-up or capture records nothing; the ring drops its oldest
spans and counts them; `System.timing_report()` lists the spans of every
layer a frame crosses.  No JAX here."""

import numpy as np
import pytest
import torch

from multi_orb_slam_tpu_torch import system as t_system
from multi_orb_slam_tpu_torch.config import SlamConfig
from multi_orb_slam_tpu_torch.geometry import camera as t_cam
from multi_orb_slam_tpu_torch.io import png, synthetic
from multi_orb_slam_tpu_torch.ops import orb as t_orb
from multi_orb_slam_tpu_torch.utils import graphs, metrics

torch.set_num_threads(2)
H, W, NF = 240, 320, 512


@pytest.fixture(autouse=True)
def fresh_store():
    """Each test starts with tracing off and an empty store."""
    metrics.enable(False)
    metrics.clear()
    yield
    metrics.enable(False)
    metrics.clear()


def _names(spans):
    return [s.name for s in spans]


def test_spans_nest_with_parents_systems_and_frames():
    owner = metrics.Metrics()
    with metrics.tracing():
        with owner.span("system/track_rgbd", frame=7):
            with metrics.span("track/process"):
                with metrics.span("wait/upload"):
                    pass
                with metrics.span("track/step"):
                    pass
        with metrics.span("io/decode"):
            pass
    got = {s.name: s for s in metrics.spans()}
    root, proc = got["system/track_rgbd"], got["track/process"]
    assert root.parent is None and proc.parent == root.seq
    assert got["wait/upload"].parent == proc.seq and got["track/step"].parent == proc.seq
    for name in ("system/track_rgbd", "track/process", "wait/upload", "track/step"):
        assert got[name].system == owner.id and got[name].frame == 7
    assert got["io/decode"].system is None and got["io/decode"].parent is None
    assert all(s.t1 >= s.t0 and s.host_ms >= 0 for s in got.values())
    assert root.t0 <= proc.t0 <= got["wait/upload"].t0 <= proc.t1 <= root.t1
    # the owner's view holds its own spans only
    assert sorted(_names(owner.spans())) == sorted(
        ["system/track_rgbd", "track/process", "wait/upload", "track/step"])
    # a span with a CPU device carries no events
    assert all(s.events is None and s.device_ms() is None for s in got.values())


def test_off_records_nothing_opens_no_range_and_makes_no_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the tracer did work while off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(metrics.GLOBAL, "_new", refuse)
    a = metrics.span("system/track_rgbd", device="cuda")
    b = metrics.span("track/process", device="cuda")
    assert a is b                                  # one shared no-op context
    with a:
        with metrics.Metrics().span("graph/replay", device="cuda"):
            pass
    monkeypatch.undo()
    assert metrics.spans() == []


def test_enable_records_and_tracing_restores():
    with metrics.span("a"):
        pass
    assert metrics.spans() == []
    metrics.enable()
    with metrics.tracing(False):
        with metrics.span("b"):
            pass
    with metrics.span("c"):
        pass
    metrics.enable(False)
    with metrics.span("d"):
        pass
    assert _names(metrics.spans()) == ["c"]


def test_a_recording_profiler_turns_spans_on_and_names_its_ranges():
    sched = torch.profiler.schedule(wait=1, warmup=1, active=1, repeat=1)
    x = torch.ones(64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                schedule=sched) as prof:
        for step in range(3):
            with metrics.span(f"track/step{step}"):
                x = x * 2.0
            prof.step()
    # only the active step recorded; its span is a range in the profile
    assert _names(metrics.spans()) == ["track/step2"]
    ranges = {e.key for e in prof.key_averages()}
    assert "track/step2" in ranges
    assert "track/step0" not in ranges and "track/step1" not in ranges
    with metrics.span("after"):
        pass
    assert _names(metrics.spans()) == ["track/step2"]


def test_a_span_inside_a_graph_body_records_nothing():
    @graphs.graphed()
    def body(x):
        with metrics.span("mapping/inside"):
            return x + 1

    x = torch.zeros(3)
    with metrics.tracing():
        body(x)                         # the CPU calls the body: the span records
        assert _names(metrics.spans()) == ["mapping/inside"]
        metrics.clear()
        entry = body.entry(x)
        with graphs._depth("inline"):   # a warm-up or a capture calls the body so
            body(x)
        entry.body()
        assert metrics.spans() == []
        # the entry's run records its boundary, not the body's inside
        entry.run(x)
    names = _names(metrics.spans())
    assert "graph/test_a_span_inside_a_graph_body_records_nothing.<locals>.body" in names
    assert "graph/load" in names and "mapping/inside" not in names


class _Event:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done


def test_host_reads_uploads_and_event_waits_are_wait_spans():
    with metrics.tracing():
        got = metrics.host("counts", torch.arange(3))
        up = metrics.upload(np.ones(2), "cpu", torch.float32)   # host to host: no wait
        with metrics.wait("scalars", _Event(done=True)):        # completed: no wait
            pass
        with metrics.wait("scalars", _Event(done=False)):
            pass
    assert isinstance(got, np.ndarray) and got.tolist() == [0, 1, 2]
    assert up.dtype == torch.float32 and up.tolist() == [1.0, 1.0]
    assert _names(metrics.spans()) == ["wait/counts", "wait/scalars"]
    metrics.clear()
    assert metrics.host("off", torch.zeros(1)).tolist() == [0.0]
    assert metrics.spans() == []


def test_the_ring_drops_the_oldest_and_counts_them():
    store = metrics.Store(capacity=8)
    for i in range(20):
        s = store._new(f"s{i}", None, None, None)
        s.t0, s.t1 = i, i + 1
    assert store.dropped == 12
    assert _names(store.spans()) == [f"s{i}" for i in range(12, 20)]
    store.clear()
    assert store.spans() == [] and store.dropped == 0


def test_a_metrics_view_summarises_and_resets():
    m = metrics.Metrics()
    with metrics.tracing():
        for _ in range(3):
            with m.span("stage"):
                pass
    m.count("frames", 2)
    s = m.summary()
    assert s["stage"]["n"] == 3 and s["frames"] == 2 and "stage" in m.report()
    assert set(s["stage"]) == {"n", "median_ms", "mean_ms", "p90_ms", "total_s"}
    m.reset()
    assert m.summary() == {}


def test_png_decoding_is_an_io_span(tmp_path):
    path = str(tmp_path / "g.png")
    png.write_png(path, np.arange(64, dtype=np.uint8).reshape(8, 8))
    with metrics.tracing():
        png.read_gray(path)
        png.read_png(path)
    assert _names(metrics.spans()) == ["io/decode", "io/decode"]


def _small_system():
    cfg = SlamConfig(n_cams=1, max_feat=NF, max_kf=32, max_mp=8192, local_cap=1024,
                     new_mp_per_cam=128, width=W, height=H, th_depth=6.0, max_frames_kf=4,
                     orb=t_orb.ORBConfig(n_features=NF))
    calib = t_cam.CameraParams(
        K=torch.tensor([[260.0, 260.0, 160.0, 120.0]]), dist=torch.zeros((1, 5)),
        T_rc=torch.eye(4)[None], bf=torch.tensor(20.0), width=W, height=H)
    return t_system.System(sensor=t_system.Sensor.RGBD, calib=calib, cfg=cfg,
                           enable_loop_closing=False, device="cpu")


def test_timing_report_lists_every_layer_of_the_frame():
    sys_ = _small_system()
    seq = synthetic.make_sequence(n_frames=10, K=np.array([260.0, 260.0, 160.0, 120.0]),
                                  height=H, width=W, n_points=2500)
    with metrics.tracing():
        for i, (g, d) in enumerate(zip(seq.grays, seq.depths)):
            sys_.track_rgbd(g[0], d[0], timestamp=seq.timestamps[i])
    report = sys_.timing_report()
    for name in ("system/track_rgbd", "track/process", "track/extract", "track/step",
                 "track/motion_model", "track/local_map", "wait/motion_model_counts",
                 "wait/local_map_counts", "wait/pose_readback", "system/keyframe",
                 "mapping/stage", "mapping/cull_points", "mapping/triangulate",
                 "mapping/solve", "mapping/geometry"):
        assert name in report, name
    spans = sys_.metrics.spans()
    roots = [s for s in spans if s.name == "system/track_rgbd"]
    assert [s.frame for s in roots] == list(range(10))
    # every span of a frame carries its frame id and reaches the root
    by_seq = {s.seq: s for s in spans}
    for s in spans:
        r = s
        while r.parent is not None:
            r = by_seq[r.parent]
        assert r.name == "system/track_rgbd" and r.frame == s.frame
    assert sys_.metrics.counters["keyframes_inserted"] >= 2
    assert sys_.metrics.summary()["system/keyframe"]["n"] == \
        sys_.metrics.counters["keyframes_inserted"]
