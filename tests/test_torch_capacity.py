"""PyTorch port vs JAX reference: the map's capacity lifecycle
(`tests/test_capacity.py`'s counterpart).

- `allocate_mp_slots`: the same slots, and the same refused requests, as the
  reference on a store with one free slot and on a random one.
- `relieve_capacity` on two hand-made stores, field for field equal to the
  reference's result: `test_capacity.py`'s (the only keyframe's weak points
  are protected, the unobserved ones go, no observation refers to a dead
  point) and one with old unprotected points (the lowest found / visible
  ratios go).
- The overflow run: `test_capacity.py`'s 25 frames (one 320x240 camera,
  seed 2, 4000 squares, orbit) with a map ~2x too small (`max_kf=24,
  max_mp=768, local_cap=512, ba_local_cap=768, max_frames_kf=5`) and the
  mapping stage as the keyframe callback, through both packages' `Tracker`
  on the same rendered frames.  The port's per-frame OK states equal the
  reference's on all but at most 2 frames; its final `n_mp` is within 5% of
  the reference's; capacity pressure shows in both the same way (refused
  allocations counted, or the store kept under 95% full by eviction); and
  the port holds `test_capacity.py`'s own bounds (>= 18 frames OK, `n_mp`
  <= 768).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orb_slam_tpu.config import SlamConfig as JCfg
from multi_orb_slam_tpu.frontend import tracking as j_tr
from multi_orb_slam_tpu.geometry import camera as j_cam
from multi_orb_slam_tpu.io import synthetic
from multi_orb_slam_tpu.mapping import local_mapping as j_lm
from multi_orb_slam_tpu.mapping import map_state as j_ms
from multi_orb_slam_tpu.ops import orb as j_orb
from multi_orb_slam_tpu_torch import convert
from multi_orb_slam_tpu_torch.config import SlamConfig as TCfg
from multi_orb_slam_tpu_torch.frontend import tracking as t_tr
from multi_orb_slam_tpu_torch.geometry import camera as t_cam
from multi_orb_slam_tpu_torch.mapping import local_mapping as t_lm
from multi_orb_slam_tpu_torch.mapping import map_state as t_ms
from multi_orb_slam_tpu_torch.ops import orb as t_orb

torch.set_num_threads(2)

# the overflow run (test_capacity.test_overflow_run_degrades_gracefully)
OVERFLOW_KW = dict(n_cams=1, max_feat=512, max_kf=24, max_mp=768, local_cap=512,
                   ba_local_cap=768, max_frames_kf=5, width=320, height=240)
OVERFLOW_K = np.array([520.9, 521.0, 160.0, 120.0], np.float32)
N_OVERFLOW = 25
MAX_STATES_APART = 2
N_MP_REL = 0.05


def _fields_equal(j, t):
    want = {k: np.asarray(v) for k, v in j._asdict().items()}
    got = convert.to_numpy(t)
    for name, a in want.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)


@pytest.mark.parametrize("case", ["one free slot", "random"])
def test_alloc_failure_counter(case):
    """Requests past the free slots get -1 in both packages, in slot order."""
    if case == "one free slot":
        valid = np.ones(64, bool)
        valid[10] = False                   # one free slot (63 is reserved)
        want = np.ones(8, bool)
    else:
        rng = np.random.RandomState(4)
        valid = rng.uniform(size=256) < 0.9
        want = rng.uniform(size=48) < 0.7
    slots_j = np.asarray(j_ms.allocate_mp_slots(jnp.asarray(valid), jnp.asarray(want)))
    slots_t = t_ms.allocate_mp_slots(torch.from_numpy(valid), torch.from_numpy(want)).numpy()
    np.testing.assert_array_equal(slots_t, slots_j)
    n_free = int((~valid[:-1]).sum())
    assert int((slots_t >= 0).sum()) == min(n_free, int(want.sum()))
    assert int(((slots_t < 0) & want).sum()) == max(int(want.sum()) - n_free, 0)
    if case == "one free slot":
        assert int((slots_t >= 0).sum()) == 1 and int(((slots_t < 0) & want).sum()) == 7


def _store(case):
    """(numpy fields, make_empty shape, target_free) of a hand-made store."""
    if case == "protects the newest keyframe's points":
        K, Cc, F, M = 8, 1, 32, 128
        kf_mp = np.full((K, Cc, F), -1, np.int32)
        kf_mp[0, 0] = np.arange(32)          # KF0 observes the weak points
        fields = dict(
            mp_valid=np.arange(M) != M - 1, n_mp=np.asarray(M - 1, np.int32),
            mp_visible=np.full(M, 10, np.int32),
            # low found ratio for slots < 32 -> eviction order targets them
            mp_found=np.where(np.arange(M) < 32, 1, 9).astype(np.int32),
            kf_valid=np.arange(K) == 0,
            kf_frame_id=np.where(np.arange(K) == 0, 0, -1).astype(np.int32), kf_mp=kf_mp,
            kf_feat_valid=np.zeros((K, Cc, F), bool))
        fields["kf_feat_valid"][0] = True
        return fields, (K, Cc, F, M), 40
    rng = np.random.RandomState(2)
    K, Cc, F, M = 16, 1, 8, 256
    fields = dict(
        kf_valid=np.arange(K) < 14, kf_frame_id=np.arange(K, dtype=np.int32) * 3,
        kf_mp=np.full((K, Cc, F), -1, np.int32), mp_valid=np.arange(M) < 200,
        mp_found=rng.randint(1, 20, M).astype(np.int32),
        mp_visible=rng.randint(10, 30, M).astype(np.int32), n_mp=np.asarray(200, np.int32))
    fields["kf_mp"][:14, 0, :] = rng.permutation(112).reshape(14, 8)
    return fields, (K, Cc, F, M), 100


@pytest.mark.parametrize("case", ["protects the newest keyframe's points",
                                  "evicts the weakest of old unprotected points"])
def test_relieve_capacity(case):
    """The reference's eviction on the same store, field for field."""
    fields, shape, target = _store(case)
    js = j_ms.make_empty(*shape)._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    ts = t_ms.make_empty(*shape, device="cpu")._replace(
        **{k: torch.from_numpy(np.asarray(v).copy()) for k, v in fields.items()})
    out_j, out_t = j_ms.relieve_capacity(js, target), t_ms.relieve_capacity(ts, target)
    _fields_equal(out_j, out_t)
    M = shape[3]
    valid, kf_mp = out_t.mp_valid.numpy(), out_t.kf_mp.numpy()
    assert int((~valid).sum()) >= target
    # the observation table never refers to a dead point
    assert not ((kf_mp >= 0) & ~valid[np.clip(kf_mp, 0, M - 1)]).any()
    if case == "protects the newest keyframe's points":
        assert valid[:32].all()
    else:
        assert int(out_t.n_mp) == 200 - (100 - 56)


@pytest.fixture(scope="module")
def overflow():
    """The overflow run through both packages' `Tracker` on the same
    frames: per-frame OK flags and the final counters of each."""
    T_rc = np.eye(4, dtype=np.float32)[None]
    seq = synthetic.make_sequence(n_frames=N_OVERFLOW, K=OVERFLOW_K, T_rc=T_rc, height=240,
                                  width=320, seed=2, n_points=4000, trajectory="orbit")
    jcfg = JCfg(**OVERFLOW_KW, orb=j_orb.ORBConfig(n_features=512))
    jcal = j_cam.CameraParams(K=jnp.asarray(OVERFLOW_K)[None], dist=jnp.zeros((1, 5)),
                              T_rc=jnp.asarray(T_rc), bf=jnp.asarray(40.0), width=320,
                              height=240)
    tcfg = TCfg(**OVERFLOW_KW, orb=t_orb.ORBConfig(n_features=512))
    tcal = convert.to_torch(jcal, t_cam.CameraParams, "cpu")
    out = {}
    for name, tr_mod, lm, cal, cfg, arr in (
            ("jax", j_tr, j_lm, jcal, jcfg, jnp.asarray),
            ("torch", t_tr, t_lm, tcal, tcfg, torch.from_numpy)):
        kw = {} if name == "jax" else {"device": "cpu"}
        tr = tr_mod.Tracker(cal, cfg, **kw)
        tr.kf_inserted_cb = (lambda tr, lm, cal, cfg: lambda s: lm.run_mapping_stage(
            tr.map, s, tr.frame_id, cal, cfg))(tr, lm, cal, cfg)
        ok = []
        for g, d in zip(seq.grays, seq.depths):
            tr.process(arr(np.asarray(g)), arr(np.asarray(d)))
            ok.append(int(tr.state) == 1)
        out[name] = dict(ok=ok, n_mp=int(tr.map.n_mp), n_failed=int(tr.map.n_alloc_failed),
                         n_kf=int(tr.map.n_kf))
    return out


def test_overflow_run_states_are_the_references(overflow):
    j, t = overflow["jax"], overflow["torch"]
    apart = [i for i, (a, b) in enumerate(zip(j["ok"], t["ok"])) if a != b]
    assert len(apart) <= MAX_STATES_APART, (apart, j["ok"], t["ok"])


def test_overflow_run_map_is_the_references(overflow):
    j, t = overflow["jax"], overflow["torch"]
    assert abs(t["n_mp"] - j["n_mp"]) <= N_MP_REL * j["n_mp"], (t, j)
    # capacity pressure is met the same way: refusals counted in both, or
    # eviction kept both stores under the high-water mark
    cap = OVERFLOW_KW["max_mp"]
    failed = [r["n_failed"] > 0 for r in (j, t)]
    under = [r["n_mp"] < int(0.95 * cap) for r in (j, t)]
    assert all(failed) or all(under), (t, j)


def test_overflow_run_degrades_gracefully(overflow):
    """`test_capacity.py`'s own bounds, on the port."""
    t = overflow["torch"]
    cap = OVERFLOW_KW["max_mp"]
    assert sum(t["ok"]) >= 18
    assert t["n_mp"] <= cap
    assert t["n_failed"] > 0 or t["n_mp"] < int(0.95 * cap)
