"""The readers of the program's spans and of the mapping LM's counters, fed
a synthetic store: each gives the value its docstring defines, and None
where the store holds no frame (or the counters no trip)."""

import types

import pytest

from harness import files
from multi_orb_slam_tpu_torch.optim import local_ba
from multi_orb_slam_tpu_torch.utils import metrics

SPAN_METRICS = ("span.host_waits.per_frame", "span.host_wait_ms.per_frame",
                "span.tracker_host_ms.p50", "span.tracker_device_ms.p50",
                "span.graph_io_ms.per_frame")


def store(factors):
    """One frame per factor: every host and device ms of the template below
    times the factor.

    system/track_rgbd                  10 (device 9)
      wait/upload                       0.5
      wait/upload                       0.5
      track/process                     8 (device 7)
        track/extract                   2 (device 1.9)
          graph/build_frame             1.5
            graph/load                  0.2
            graph/replay                0.3 (device 0.25)
            graph/clone                 0.4
        track/step                      5
          track/motion_model            0.8 (device 0.7)
          system/keyframe               3 (device 2)
            wait/covis_hint             1
            graph/_mapping_stage_fused  1.5
              graph/load                0.1
          wait/pipeline_scalars         0.6
      wait/pose_readback                1
    io/decode                           4 (outside the frame)
    """
    tree = ("system/track_rgbd", 10, 9, [
        ("wait/upload", 0.5, None, []), ("wait/upload", 0.5, None, []),
        ("track/process", 8, 7, [
            ("track/extract", 2, 1.9, [
                ("graph/build_frame", 1.5, None, [
                    ("graph/load", 0.2, None, []), ("graph/replay", 0.3, 0.25, []),
                    ("graph/clone", 0.4, None, [])])]),
            ("track/step", 5, None, [
                ("track/motion_model", 0.8, 0.7, []),
                ("system/keyframe", 3, 2, [
                    ("wait/covis_hint", 1, None, []),
                    ("graph/_mapping_stage_fused", 1.5, None, [("graph/load", 0.1, None, [])])]),
                ("wait/pipeline_scalars", 0.6, None, [])])]),
        ("wait/pose_readback", 1, None, [])])
    out = []

    def add(node, parent, f):
        name, host, dev, kids = node
        s = types.SimpleNamespace(seq=len(out), name=name, parent=parent, host_ms=host * f,
                                  device_ms=(lambda d=dev: None if d is None else d * f))
        out.append(s)
        for k in kids:
            add(k, s.seq, f)

    for f in factors:
        add(tree, None, f)
        add(("io/decode", 4, None, []), None, f)
    return out


# per frame at factor 1: 5 waits of 3.6 ms; track/process 8 less graph/load
# 0.2, graph/clone 0.4, system/keyframe 3 and wait/pipeline_scalars 0.6;
# device: the innermost spans with events outside the keyframe, the replay's
# 0.25 and motion_model's 0.7 (not track/extract's 1.9, which holds the
# replay); graph copies 0.2 + 0.4 + 0.1
PER_FRAME = {"span.host_waits.per_frame": (5.0, False), "span.host_wait_ms.per_frame": (3.6, True),
             "span.tracker_host_ms.p50": (3.8, True), "span.tracker_device_ms.p50": (0.95, True),
             "span.graph_io_ms.per_frame": (0.7, True)}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_on_a_synthetic_store(name, monkeypatch):
    factors = (1.0, 2.0, 4.0)
    monkeypatch.setattr(metrics, "spans", lambda system=None: store(factors))
    value, scales = PER_FRAME[name]
    if not scales:
        expect = value
    elif name.endswith(".p50"):
        expect = value * 2.0                       # the median frame's factor
    else:
        expect = value * sum(factors) / len(factors)
    assert files.metric_reader(name)({}) == pytest.approx(expect)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_is_none_without_a_frame(name, monkeypatch):
    monkeypatch.setattr(metrics, "spans", lambda system=None: [])
    assert files.metric_reader(name)({}) is None
    only_decode = [s for s in store((1.0,)) if s.name == "io/decode"]
    monkeypatch.setattr(metrics, "spans", lambda system=None: only_decode)
    assert files.metric_reader(name)({}) is None


def test_span_metrics_are_none_for_a_program_without_the_tracer(monkeypatch):
    monkeypatch.delattr(metrics, "spans")
    for name in SPAN_METRICS:
        assert files.metric_reader(name)({}) is None


def test_live_trips_share(monkeypatch):
    read = files.metric_reader("ba.live_trips.share")
    monkeypatch.setattr(local_ba, "STATS", types.SimpleNamespace(
        read=lambda: {"solves": 3, "iterations": 27, "trips": 36}))
    assert read({}) == pytest.approx(75.0)
    monkeypatch.setattr(local_ba, "STATS", types.SimpleNamespace(read=lambda: {}))
    assert read({}) is None
