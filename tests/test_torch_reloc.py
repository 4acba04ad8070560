"""PyTorch port vs JAX reference: PnP RANSAC and relocalization.

The reference draws its 256 minimal sets from a JAX key; the port cannot
repeat those bits, so its solver takes the triplets.  The test draws them
with the reference's own four lines, hands them to `pnp.pnp_solve` and holds
the result against `pnp.pnp_ransac` under the same key: the pose to 1e-3
(norm of the se3 log of the difference; 1024 hypotheses from a 12-step
Newton iteration and an SVD each, scored in float32, then two rounds of pose
BA), the inlier masks equal but for points whose squared reprojection error
lies within 1% of the 5.991 gate.  The port's own sampler is checked for what
a sampler must give: the same triplets from the same seed, three distinct
valid indices each, and indices in range when fewer than three are valid.

`relocalize` runs on one map: a JAX `System` tracks 12 frames of the dual
320x240 rig, the map, the vocabulary and the database are converted, and a
later frame is relocalized by both packages: the same `ok`, the pose within
2 mm and 1e-3 rad (the two draw other triplets; both end in the same two
pose BAs), the inlier count within 3.

On the same relocalization, each of its graphed stages (`match_stage`,
`pnp_solve`, `pose_ba_inputs`, `optimize_pose`, `top_up_stage`: one CUDA
graph replay a call on the card) leaves its inputs bit-unchanged and reads
nothing back through its entry (`test_torch_graphs`' checks); the traced
slot gives two slots' direct results through one entry; and `relocalize`
with every graphed call sent through its entry is the direct run, bit for
bit, with the same host reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orb_slam_tpu import system as j_system
from multi_orb_slam_tpu.config import SlamConfig as JCfg
from multi_orb_slam_tpu.frontend import frame as j_frame
from multi_orb_slam_tpu.geometry import camera as j_cam
from multi_orb_slam_tpu.geometry import se3 as j_se3
from multi_orb_slam_tpu.io import synthetic
from multi_orb_slam_tpu.loop import loop_closing as j_lc
from multi_orb_slam_tpu.ops import orb as j_orb
from multi_orb_slam_tpu.reloc import pnp as j_pnp
from multi_orb_slam_tpu.reloc import relocalization as j_reloc
from multi_orb_slam_tpu_torch import convert
from multi_orb_slam_tpu_torch.config import SlamConfig as TCfg
from multi_orb_slam_tpu_torch.frontend import frame as t_frame
from multi_orb_slam_tpu_torch.geometry import camera as t_cam
from multi_orb_slam_tpu_torch.mapping import map_state as t_ms
from multi_orb_slam_tpu_torch.ops import kernels
from multi_orb_slam_tpu_torch.ops import orb as t_orb
from multi_orb_slam_tpu_torch.optim import pose_opt as t_pose_opt
from multi_orb_slam_tpu_torch.placerec import database as t_db
from multi_orb_slam_tpu_torch.placerec import vocabulary as t_voc
from multi_orb_slam_tpu_torch.reloc import pnp as t_pnp
from multi_orb_slam_tpu_torch.reloc import relocalization as t_reloc

from test_torch_graphs import (_equal, _routed, assert_pure, assert_reads_nothing_back,
                               assert_traced_values)

torch.set_num_threads(2)
GATE = 5.991


def _t(a):
    return convert._field_to_torch(a, "cpu")


def _pnp_case(seed=0, n=150, n_out=0, noise=0.5):
    """The inputs of `tests/test_reloc.py::TestPnP.make`."""
    rng = np.random.RandomState(seed)
    Xw = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    Xw[:, 2] += 5.0
    Tcw = np.asarray(j_se3.exp(jnp.asarray([0.2, -0.1, 0.3, 0.1, -0.2, 0.15], jnp.float32)))
    K = np.array([400.0, 400.0, 320.0, 240.0], np.float32)
    Xc = Xw @ Tcw[:3, :3].T + Tcw[:3, 3]
    uv = np.stack([K[0] * Xc[:, 0] / Xc[:, 2] + K[2],
                   K[1] * Xc[:, 1] / Xc[:, 2] + K[3]], -1) \
        + rng.randn(n, 2).astype(np.float32) * noise
    valid = Xc[:, 2] > 0.3
    if n_out:
        idx = rng.choice(np.nonzero(valid)[0], n_out, replace=False)
        uv[idx] += rng.uniform(30, 100, (n_out, 2))
    return Tcw, uv.astype(np.float32), Xw, valid, K


def _reference_triplets(key, valid, n_hyp=256):
    """The draws of `pnp.pnp_ransac` (its lines `keys = ...` to `tri = ...`)."""
    N = valid.shape[0]
    keys = jax.random.split(key, n_hyp)

    def sample3(k):
        g = jax.random.gumbel(k, (N,)) + jnp.where(valid, 0.0, -1e9)
        _, idx = jax.lax.top_k(g, 3)
        return idx

    return np.asarray(jax.vmap(sample3)(keys))


def _log_norm(Ta, Tb):
    return float(jnp.linalg.norm(j_se3.log(jnp.asarray(Ta) @ jnp.linalg.inv(jnp.asarray(Tb)))))


@pytest.mark.parametrize("name,kw,key,gt_tol", [
    ("clean", dict(), 0, 0.02),
    ("outliers", dict(n_out=40), 1, 0.03),
    ("noisy", dict(seed=4, noise=2.0, n_out=15), 2, 0.1),
])
def test_pnp_solver_on_the_reference_triplets(name, kw, key, gt_tol):
    Tcw, uv, Xw, valid, K = _pnp_case(**kw)
    jkey = jax.random.PRNGKey(key)
    T_j, inl_j, n_j = j_pnp.pnp_ransac(jkey, jnp.asarray(uv), jnp.asarray(Xw),
                                       jnp.asarray(valid), jnp.asarray(K))
    tri = _reference_triplets(jkey, jnp.asarray(valid))
    T_t, inl_t, n_t = t_pnp.pnp_solve(torch.from_numpy(tri.copy()).long(), _t(uv), _t(Xw),
                                      _t(valid), _t(K))
    assert _log_norm(T_t.numpy(), np.asarray(T_j)) < 1e-3
    assert _log_norm(T_t.numpy(), Tcw) < gt_tol
    # inlier masks: equal but for points within 1% of the gate
    Tj = np.asarray(T_j)
    Xc = Xw @ Tj[:3, :3].T + Tj[:3, 3]
    e2 = ((K[0] * Xc[:, 0] / Xc[:, 2] + K[2] - uv[:, 0]) ** 2
          + (K[1] * Xc[:, 1] / Xc[:, 2] + K[3] - uv[:, 1]) ** 2)
    differ = np.nonzero(inl_t.numpy() != np.asarray(inl_j))[0]
    assert all(abs(e2[i] - GATE) < 0.01 * GATE for i in differ), (differ, e2[differ])
    assert abs(int(n_t) - int(n_j)) <= len(differ)
    assert int(n_t) > (100 if name == "clean" else 60)


def test_sampler_is_seeded_distinct_and_valid():
    rng = np.random.RandomState(9)
    valid = torch.from_numpy(rng.rand(200) < 0.3)

    def draw(seed):
        g = torch.Generator(device="cpu")
        g.manual_seed(seed)
        return t_pnp.sample_triplets(valid, 256, g)

    a, b, c = draw(5), draw(5), draw(6)
    assert a.shape == (256, 3) and torch.equal(a, b) and not torch.equal(a, c)
    assert bool(valid[a].all())
    s = torch.sort(a, dim=1).values
    assert bool((s[:, 0] < s[:, 1]).all() and (s[:, 1] < s[:, 2]).all())
    # every valid index is drawn at some point: the draw is over all of them
    assert set(a.reshape(-1).tolist()) == set(torch.nonzero(valid)[:, 0].tolist())


@pytest.mark.parametrize("n_valid", [0, 2])
def test_fewer_than_three_valid_correspondences(n_valid):
    """No hang, no index out of range, and no pose that claims inliers it
    cannot have."""
    _, uv, Xw, _, K = _pnp_case()
    valid = torch.zeros(150, dtype=torch.bool)
    valid[:n_valid] = True
    g = torch.Generator(device="cpu")
    g.manual_seed(0)
    tri = t_pnp.sample_triplets(valid, 64, g)
    assert int(tri.min()) >= 0 and int(tri.max()) < 150
    assert bool((torch.sort(tri, dim=1).values.diff(dim=1) > 0).all())
    T, inl, n = t_pnp.pnp_solve(tri, _t(uv), _t(Xw), valid, _t(K))
    assert T.shape == (4, 4) and inl.shape == (150,)
    assert 0 <= int(n) <= n_valid and not bool((inl & ~valid).any())
    with pytest.raises(ValueError):
        t_pnp.sample_triplets(valid[:2], 4, g)


# ---------------------------------------------------------------------------
# relocalize on one converted map
# ---------------------------------------------------------------------------

C, H, W, NF = 2, 240, 320, 512
CFG_KW = dict(n_cams=C, max_feat=NF, max_kf=32, max_mp=12288, local_cap=2048,
              new_mp_per_cam=128, width=W, height=H, th_depth=6.0, max_frames_kf=3)


@pytest.fixture(scope="module")
def lost_scene():
    K = jnp.tile(jnp.asarray([[260.0, 260.0, 160.0, 120.0]]), (C, 1))
    Ry = j_se3.so3_exp(jnp.asarray([0.0, 0.9, 0.0]))
    T_c12 = jnp.eye(4).at[:3, :3].set(Ry).at[:3, 3].set(jnp.asarray([0.16, 0.004, -0.07]))
    T_rc = jnp.stack([jnp.eye(4), jnp.linalg.inv(T_c12)])
    jcal = j_cam.CameraParams(K=K, dist=jnp.zeros((C, 5)), T_rc=T_rc,
                              bf=jnp.asarray(20.0), width=W, height=H)
    jcfg = JCfg(**CFG_KW, orb=j_orb.ORBConfig(n_features=NF))
    seq = synthetic.make_sequence(n_frames=16, K=np.asarray(K[0]), T_rc=np.asarray(T_rc),
                                  height=H, width=W, n_points=5000)
    sys_ = j_system.System(sensor=j_system.Sensor.DUAL_RGBD, calib=jcal, cfg=jcfg)
    sys_.loop_closer = j_lc.LoopCloser(jcal, jcfg, vocab_min_descs=1200, vocab_k=6,
                                       vocab_depth=3)
    for g, d in zip(seq.grays[:12], seq.depths[:12]):
        sys_.track_rgbd(g[0], d[0], g[1], d[1])
    assert sys_.loop_closer.voc is not None and int(sys_.map.n_kf) >= 4
    return dict(sys=sys_, jcal=jcal, jcfg=jcfg, seq=seq)


@pytest.mark.parametrize("frame", [15, "blank"])
def test_relocalize_on_a_converted_map(lost_scene, frame):
    s = lost_scene
    sys_, jcal, jcfg, seq = s["sys"], s["jcal"], s["jcfg"], s["seq"]
    if frame == "blank":
        g, d = np.full_like(seq.grays[0], 100.0), np.zeros_like(seq.depths[0])
    else:
        g, d = seq.grays[frame], seq.depths[frame]
    fr_j = j_frame.build_frame(jnp.asarray(g), jnp.asarray(d), jcal, jcfg.orb)
    voc_j, db_j = sys_.loop_closer.voc, sys_.loop_closer.db
    ok_j, T_j, fmp_j, n_j = j_reloc.relocalize(sys_.map, fr_j, voc_j, db_j, jcal, jcfg)

    tcfg = TCfg(**CFG_KW, orb=t_orb.ORBConfig(n_features=NF))
    before = dict(t_reloc.STATS)
    ok_t, T_t, fmp_t, n_t = t_reloc.relocalize(
        convert.to_torch(sys_.map, t_ms.MapState, "cpu"),
        convert.to_torch(fr_j, t_frame.FrameData, "cpu"),
        convert.to_torch(voc_j, t_voc.Vocabulary, "cpu"),
        convert.to_torch(db_j, t_db.KeyFrameDB, "cpu"),
        convert.to_torch(jcal, t_cam.CameraParams, "cpu"), tcfg)
    assert ok_t == ok_j == (frame != "blank")
    assert t_reloc.STATS["calls"] == before["calls"] + 1
    if frame == "blank":
        assert T_t is None and fmp_t is None and n_t == 0
        return
    assert t_reloc.STATS["found"] == before["found"] + 1
    assert 1 <= t_reloc.STATS["host_reads"] - before["host_reads"] <= 1 + 4 * 5
    Tj, Tt = np.asarray(T_j, np.float64), T_t.numpy().astype(np.float64)
    cj, ct = np.linalg.inv(Tj)[:3, 3], np.linalg.inv(Tt)[:3, 3]
    assert np.linalg.norm(cj - ct) < 0.002, np.linalg.norm(cj - ct)
    assert np.linalg.norm(np.asarray(j_se3.so3_log(jnp.asarray(Tj[:3, :3] @ Tt[:3, :3].T)))) < 1e-3
    assert abs(n_t - n_j) <= 3 and n_t >= t_reloc.MIN_ACCEPT_INLIERS
    agree = (fmp_t.numpy() == np.asarray(fmp_j)).mean()
    assert agree > 0.98, agree
    # the recovered pose is the scene's: within 5 cm of ground truth
    gt = np.linalg.inv(seq.poses_gt[frame] @ np.linalg.inv(seq.poses_gt[0]))[:3, 3]
    assert np.linalg.norm(ct - gt) < 0.05


def test_dense_match_equals_masked_argmin2():
    """The every-gate-open `window_match` call of `relocalize` against the
    reference's dense Hamming matrix + `masked_argmin2`."""
    from multi_orb_slam_tpu.ops import hamming as j_ham

    rng = np.random.RandomState(2)
    kd = rng.randint(0, 4, (70, 8)).astype(np.uint32)          # many ties
    fd = rng.randint(0, 4, (90, 8)).astype(np.uint32)
    has, fvalid = rng.rand(70) < 0.8, rng.rand(90) < 0.8
    d = j_ham.pairwise_hamming(jnp.asarray(kd), jnp.asarray(fd))
    bi_j, bd_j, b2_j = j_ham.masked_argmin2(
        d, jnp.asarray(has)[:, None] & jnp.asarray(fvalid)[None, :])
    bi, bd, b2 = t_reloc.match_kf_cam0(_t(kd), _t(has), _t(fd), _t(fvalid))
    np.testing.assert_array_equal(bd.numpy(), np.asarray(bd_j))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(b2_j))
    np.testing.assert_array_equal(bi.numpy(), np.asarray(bi_j))
    assert int(bd.max()) == kernels.BIG     # a keyframe feature without a map point


# ---------------------------------------------------------------------------
# relocalization's graphed stages (one CUDA graph replay a call on the card),
# driven through their entries on the CPU
# ---------------------------------------------------------------------------

RELOC_GRAPHED = ("match_stage", "pnp_solve", "pose_ba_inputs", "optimize_pose", "top_up_stage")


@pytest.fixture(scope="module")
def reloc_case(lost_scene):
    """The port's relocalization of frame 15 on the converted map, stage by
    stage for its first candidate: {name: (graphed function, arguments)},
    the candidate's slot, another valid slot, and `relocalize`'s inputs."""
    sys_, jcal, jcfg, seq = (lost_scene[k] for k in ("sys", "jcal", "jcfg", "seq"))
    fr_j = j_frame.build_frame(jnp.asarray(seq.grays[15]), jnp.asarray(seq.depths[15]), jcal,
                               jcfg.orb)
    cfg = TCfg(**CFG_KW, orb=t_orb.ORBConfig(n_features=NF))
    inputs = (convert.to_torch(sys_.map, t_ms.MapState, "cpu"),
              convert.to_torch(fr_j, t_frame.FrameData, "cpu"),
              convert.to_torch(sys_.loop_closer.voc, t_voc.Vocabulary, "cpu"),
              convert.to_torch(sys_.loop_closer.db, t_db.KeyFrameDB, "cpu"),
              convert.to_torch(jcal, t_cam.CameraParams, "cpu"), cfg)
    st, fr, voc, db, cal, _ = inputs
    kf = int(t_db.detect_relocalization_candidates(db, voc, st, fr.desc[0], fr.valid[0])[0])
    calls = {"match_stage": (t_reloc.match_stage, (
        st.kf_desc, st.kf_mp, st.kf_feat_valid, st.mp_valid, st.mp_pos, fr.desc[0],
        fr.valid[0], kf))}
    _, mp_of_feat, matched, Xw = t_reloc.match_stage(*calls["match_stage"][1])
    gen = torch.Generator(device="cpu")
    gen.manual_seed(kf)
    calls["pnp_solve"] = (t_pnp.pnp_solve, (t_pnp.sample_triplets(matched, 256, gen),
                                           fr.xy_und[0], Xw, matched, cal.K[0]))
    Tcw0, inl, _ = t_pnp.pnp_solve(*calls["pnp_solve"][1])
    calls["pose_ba_inputs"] = (t_reloc.pose_ba_inputs, (matched, inl, mp_of_feat, st.mp_pos,
                                                         fr, cfg))
    frame_mp, obs = t_reloc.pose_ba_inputs(*calls["pose_ba_inputs"][1])
    calls["optimize_pose"] = (t_pose_opt.optimize_pose, (Tcw0, obs, cal.T_rc, cal.K, cal.bf))
    Tcw, inlier, _ = t_pose_opt.optimize_pose(*calls["optimize_pose"][1])
    calls["top_up_stage"] = (t_reloc.top_up_stage, (st, kf, frame_mp, inlier, Tcw, fr, cal,
                                                     cfg))
    other = next(int(k) for k in torch.nonzero(st.kf_valid)[:, 0] if int(k) != kf)
    return dict(calls=calls, kf=kf, other=other, inputs=inputs)


@pytest.mark.parametrize("name", RELOC_GRAPHED)
def test_reloc_graphed_function_leaves_inputs_unchanged(reloc_case, name):
    assert_pure(*reloc_case["calls"][name])


@pytest.mark.parametrize("name", RELOC_GRAPHED)
def test_reloc_graphed_function_reads_nothing_back(reloc_case, monkeypatch, name):
    assert_reads_nothing_back(monkeypatch, *reloc_case["calls"][name])


@pytest.mark.parametrize("name", ["match_stage", "top_up_stage"])
def test_reloc_stage_takes_each_slot_through_one_entry(reloc_case, name):
    """The candidate's slot is traced: two slots, one entry, each the direct
    call's result."""
    fn, args = reloc_case["calls"][name]
    at = 7 if name == "match_stage" else 1
    assert args[at] == reloc_case["kf"]
    other = args[:at] + (reloc_case["other"],) + args[at + 1:]
    assert_traced_values(fn, [args, other])


def test_relocalize_through_entries_is_the_direct_run(reloc_case):
    """`relocalize` with every graphed call sent through its entry, as on
    the card: the direct run's bits (which `test_relocalize_on_a_converted_map`
    holds to the JAX package), the same host reads, and one entry a stage
    (the two pose BAs share one)."""
    inputs = reloc_case["inputs"]
    r0 = dict(t_reloc.STATS)
    direct = t_reloc.relocalize(*inputs)
    r1 = dict(t_reloc.STATS)
    routed, used = _routed(lambda: t_reloc.relocalize(*inputs))
    assert direct[0] is routed[0] is True and direct[3] == routed[3]
    assert _equal(direct[1:3], routed[1:3])
    assert t_reloc.STATS["host_reads"] - r1["host_reads"] == r1["host_reads"] - r0["host_reads"]
    assert set(used) == set(RELOC_GRAPHED), used
    assert all(n <= 1 for n, _ in used.values()), used
    assert used["optimize_pose"][1] == 2 * used["match_stage"][1]
