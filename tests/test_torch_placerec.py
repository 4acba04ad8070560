"""PyTorch port vs JAX reference: vocabulary, keyframe database, candidates.

The same training descriptors (numpy, from a seed) give the same tree in
both packages (the training is host numpy with the same `RandomState`; the
idf weights go through `transform_words`, so they are held to 1e-6).  Word
ids must be EQUAL, not close: equal Hamming distances are common and the
beam's tie order decides the leaf, so random, perturbed and hand-made tied
descriptors all go through both `transform_words` at beam 1 and 3.  The
sparse BoW's ids are equal and its values agree to 1e-6 (a float32 cumsum
differenced, then normalized: the two backends add in another order); scores
to 1e-6 for the same reason.  The database rows written by `add_keyframe`
on a converted `MapState` agree likewise, and both candidate detectors return
the same lists, and both packages' whole `LoopCloser.process_keyframe` makes
the same detections and decisions on every keyframe.  `load_dbow2_text`
reads a small file written here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orb_slam_tpu.mapping import map_state as j_ms
from multi_orb_slam_tpu.placerec import database as j_db
from multi_orb_slam_tpu.placerec import vocabulary as j_voc
from multi_orb_slam_tpu_torch import convert
from multi_orb_slam_tpu_torch.mapping import map_state as t_ms
from multi_orb_slam_tpu_torch.placerec import database as t_db
from multi_orb_slam_tpu_torch.placerec import vocabulary as t_voc

torch.set_num_threads(2)
K_KF, C, F, M = 10, 2, 96, 600
PLACE_OF_KF = [0, 0, 0, 1, 1, 2, 2, 0, 0, 0]     # keyframes 7 to 9 revisit place 0


def _clustered(rng, n, n_centers=40, flip=0.08):
    """[n, 8] uint32 descriptors around `n_centers` random centres."""
    centers = rng.randint(0, 2, (n_centers, 256)).astype(np.uint8)
    bits = centers[rng.randint(0, n_centers, n)] ^ (rng.rand(n, 256) < flip).astype(np.uint8)
    return np.packbits(bits, axis=1).view(np.uint32)


def _t(a):
    return convert._field_to_torch(a, "cpu")


@pytest.fixture(scope="module")
def vocs():
    rng = np.random.RandomState(11)
    train = _clustered(rng, 1500)
    vj = j_voc.build_vocabulary(train, k=6, depth=3)
    vt = t_voc.build_vocabulary(train, k=6, depth=3, device="cpu")
    return dict(train=train, j=vj, t=vt, rng=rng)


def test_same_descriptors_give_the_same_tree(vocs):
    vj, vt = vocs["j"], vocs["t"]
    assert (vt.k, vt.depth, vt.n_words) == (vj.k, vj.depth, vj.n_words)
    assert vt.n_words > 100
    got = convert.to_numpy(vt)
    np.testing.assert_array_equal(got["children"], np.asarray(vj.children))
    np.testing.assert_array_equal(got["node_desc"], np.asarray(vj.node_desc))
    assert got["node_desc"].dtype == np.uint32
    np.testing.assert_array_equal(got["word_id"], np.asarray(vj.word_id))
    np.testing.assert_allclose(got["word_weight"], np.asarray(vj.word_weight), atol=1e-6)
    # and the tuple crosses `convert` both ways
    back = convert.to_torch(vj, t_voc.Vocabulary, "cpu")
    assert torch.equal(back.node_desc, vt.node_desc) and back.node_desc.dtype == torch.int32
    assert torch.equal(back.children, vt.children) and back.n_words == vt.n_words


@pytest.mark.parametrize("beam", [1, 3])
@pytest.mark.parametrize("kind", ["random", "perturbed"])
def test_transform_words_equal(vocs, kind, beam):
    rng = np.random.RandomState(5 + beam)
    if kind == "random":
        d = rng.randint(0, 2**32, (2000, 8), dtype=np.uint64).astype(np.uint32)
    else:
        src = vocs["train"][rng.randint(0, len(vocs["train"]), 2000)]
        flips = np.packbits((rng.rand(2000, 256) < 0.05).astype(np.uint8), axis=1).view(np.uint32)
        d = src ^ flips
    wj = np.asarray(j_voc.transform_words(vocs["j"], jnp.asarray(d), beam=beam))
    wt = t_voc.transform_words(vocs["t"], _t(d), beam=beam)
    assert wt.dtype == torch.int32
    np.testing.assert_array_equal(wt.numpy(), wj)
    assert len(np.unique(wj)) > 50


def _tied_vocabulary():
    """A hand-made two-level tree, k = 3, whose centroids repeat: the root's
    children 1 and 2 are equal, node 3 differs in 4 bits; under each, two or
    three leaves, some with equal centroids.  Returns the arrays."""
    children = np.full((10, 3), -1, np.int32)
    children[0] = [1, 2, 3]
    children[1] = [4, 5, -1]
    children[2] = [6, 7, 8]
    children[3] = [9, -1, -1]
    node_desc = np.zeros((10, 8), np.uint32)
    node_desc[3, 0] = 0xF
    node_desc[4, 1] = 0x3      # leaves 4 and 6 are equal, 5 and 7 are equal
    node_desc[6, 1] = 0x3
    node_desc[5, 2] = 0x1
    node_desc[7, 2] = 0x1
    node_desc[8, 3] = 0x7
    node_desc[9, 0] = 0xF
    word_id = np.array([-1, -1, -1, -1, 0, 1, 2, 3, 4, 5], np.int32)
    return children, node_desc, word_id


@pytest.mark.parametrize("beam", [1, 2, 3])
def test_transform_words_ties(beam):
    children, node_desc, word_id = _tied_vocabulary()
    weight = np.ones(6, np.float32)
    vj = j_voc.Vocabulary(jnp.asarray(children), jnp.asarray(node_desc), jnp.asarray(word_id),
                          jnp.asarray(weight), k=3, depth=2, n_words=6)
    vt = t_voc.Vocabulary(_t(children), _t(node_desc), _t(word_id), _t(weight),
                          k=3, depth=2, n_words=6)
    q = np.zeros((7, 8), np.uint32)
    q[1, 1] = 0x3          # equals leaves 4 and 6
    q[2, 2] = 0x1          # equals leaves 5 and 7
    q[3, 0] = 0x3          # 2 bits from nodes 1, 2 and 3 alike
    q[4, 3] = 0x7          # equals leaf 8, reachable only through node 2
    q[5, 0] = 0xF          # equals node 3 and its only leaf
    q[6] = 0xFFFFFFFF      # far from everything
    wj = np.asarray(j_voc.transform_words(vj, jnp.asarray(q), beam=beam))
    wt = t_voc.transform_words(vt, _t(q), beam=beam).numpy()
    np.testing.assert_array_equal(wt, wj)
    # greedy descent takes the first of the equal children at every level
    if beam == 1:
        assert wt[1] == 0 and wt[2] == 1 and wt[3] == 1 and wt[5] == 5


def test_bow_sparse_and_scores(vocs):
    rng = np.random.RandomState(21)
    d = _clustered(rng, 300)
    valid = rng.rand(300) < 0.8
    for budget in (None, 512):
        ij, vj = j_voc.bow_sparse(vocs["j"], jnp.asarray(d), jnp.asarray(valid), budget=budget)
        it, vt = t_voc.bow_sparse(vocs["t"], _t(d), _t(valid), budget=budget)
        assert it.dtype == torch.int32 and it.shape == (budget or 300,)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6)
        assert abs(float(vt.sum()) - 1.0) < 1e-5
    # dense form and the L1 score of two frames
    d2 = d ^ np.packbits((rng.rand(300, 256) < 0.03).astype(np.uint8), axis=1).view(np.uint32)
    bj = [j_voc.bow_vector(vocs["j"], jnp.asarray(x), jnp.asarray(valid)) for x in (d, d2)]
    bt = [t_voc.bow_vector(vocs["t"], _t(x), _t(valid)) for x in (d, d2)]
    np.testing.assert_allclose(bt[0].numpy(), np.asarray(bj[0]), atol=1e-6)
    sj, st = float(j_voc.score_l1(*bj)), float(t_voc.score_l1(*bt))
    assert abs(sj - st) < 1e-6 and 0.2 < st < 1.0
    # the sparse score of the same pair equals the dense one
    i2, v2 = t_voc.bow_sparse(vocs["t"], _t(d2), _t(valid))
    sp = t_voc.score_sparse_many(it[:300], vt[:300], i2[None], v2[None], vocs["t"].n_words)
    assert abs(float(sp[0]) - st) < 1e-5
    # all invalid: an empty vector, score 0
    ie, ve = t_voc.bow_sparse(vocs["t"], _t(d), torch.zeros(300, dtype=torch.bool))
    assert bool((ie == -1).all()) and not bool(ve.any())


@pytest.fixture(scope="module")
def filled(vocs):
    """A map of K_KF keyframes seeing overlapping windows of a point line,
    and both packages' databases with every keyframe indexed."""
    rng = np.random.RandomState(31)
    st = j_ms.make_empty(16, C, F, M)
    places = [_clustered(rng, C * F, n_centers=30) for _ in range(3)]
    kf_desc = np.zeros((16, C, F, 8), np.uint32)
    kf_mp = np.full((16, C, F), -1, np.int32)
    kf_valid = np.zeros(16, bool)
    feat_valid = np.zeros((16, C, F), bool)
    for k in range(K_KF):
        place = places[PLACE_OF_KF[k]]
        flips = np.packbits((rng.rand(C * F, 256) < 0.02).astype(np.uint8), axis=1).view(np.uint32)
        kf_desc[k] = (place ^ flips).reshape(C, F, 8)
        feat_valid[k] = rng.rand(C, F) < 0.9
        kf_valid[k] = True
        # keyframes k and k + 1 share 30 camera-0 points; the revisit (7, 8,
        # 9) shares none with the first visit (0, 1, 2)
        kf_mp[k, 0, :60] = np.arange(30 * k, 30 * k + 60)
        kf_mp[k, 1, :20] = 400 + np.arange(20 * (k % 5), 20 * (k % 5) + 20)
    st = st._replace(
        kf_desc=jnp.asarray(kf_desc), kf_mp=jnp.asarray(kf_mp), kf_valid=jnp.asarray(kf_valid),
        kf_feat_valid=jnp.asarray(feat_valid), mp_valid=jnp.ones(M, bool),
        kf_frame_id=jnp.asarray(np.where(kf_valid, np.arange(16) * 8, -1).astype(np.int32)),
        n_kf=jnp.asarray(K_KF, jnp.int32))
    st_t = convert.to_torch(st, t_ms.MapState, "cpu")
    dbj = j_db.make_empty_db(16, vocs["j"].n_words, budget_cam0=128, budget_all=256)
    dbt = t_db.make_empty_db(16, vocs["t"].n_words, budget_cam0=128, budget_all=256, device="cpu")
    for k in range(K_KF):
        dbj = j_db.add_keyframe(dbj, vocs["j"], st, k)
        dbt = t_db.add_keyframe(dbt, vocs["t"], st_t, k)
    return dict(st=st, st_t=st_t, dbj=dbj, dbt=dbt, places=places, rng=rng)


def test_add_keyframe_rows(filled):
    dbj, dbt = filled["dbj"], filled["dbt"]
    got = convert.to_numpy(dbt)
    for f in ("ids_cam0", "ids_all", "has_bow"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(dbj, f)), err_msg=f)
    for f in ("vals_cam0", "vals_all"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(dbj, f)), atol=1e-6, err_msg=f)
    assert got["has_bow"].sum() == K_KF and dbt.n_words == dbj.n_words
    removed = t_db.remove_keyframe(
        convert.to_torch(dbj, t_db.KeyFrameDB, "cpu"), 3)
    assert not bool(removed.has_bow[3]) and int(removed.has_bow.sum()) == K_KF - 1


def test_scores_and_relocalization_candidates(vocs, filled):
    rng = np.random.RandomState(41)
    for place in (0, 1, 2):
        flips = np.packbits((rng.rand(F, 256) < 0.03).astype(np.uint8), axis=1).view(np.uint32)
        d = filled["places"][place][:F] ^ flips
        valid = rng.rand(F) < 0.95
        qj = j_voc.bow_sparse(vocs["j"], jnp.asarray(d), jnp.asarray(valid), budget=128)
        qt = t_voc.bow_sparse(vocs["t"], _t(d), _t(valid), budget=128)
        sj = np.asarray(j_db.score_query_cam0(filled["dbj"], *qj))
        st = t_db.score_query_cam0(filled["dbt"], *qt).numpy()
        np.testing.assert_allclose(st, sj, atol=1e-6)
        cj = j_db.detect_relocalization_candidates(
            filled["dbj"], vocs["j"], filled["st"], jnp.asarray(d), jnp.asarray(valid))
        ct = t_db.detect_relocalization_candidates(
            filled["dbt"], vocs["t"], filled["st_t"], _t(d), _t(valid))
        assert ct == cj and len(ct) >= 2
        # the best candidates are the keyframes of that place
        want = {k for k in range(K_KF) if PLACE_OF_KF[k] == place}
        assert set(ct[:2]) <= want


@pytest.mark.parametrize("min_score,max_fid", [(0.05, None), (0.3, None), (0.05, 40), (0.0, 8)])
def test_loop_candidates(filled, min_score, max_fid):
    """Keyframe 9 revisits the place of keyframes 0 to 2."""
    cj = j_db.detect_loop_candidates(filled["dbj"], filled["st"], 9, min_score,
                                     max_frame_id=max_fid)
    ct = t_db.detect_loop_candidates(filled["dbt"], filled["st_t"], 9, min_score,
                                     max_frame_id=max_fid)
    assert ct == cj
    if min_score == 0.05:
        assert ct and set(ct[:2]) <= {0, 1, 2}


def _dual_rig():
    """A real two-camera calibration, the reference rig (camera 1 turned 90
    degrees about y), in both packages."""
    from multi_orb_slam_tpu.geometry import camera as j_cam
    from multi_orb_slam_tpu.geometry import se3 as j_se3
    from multi_orb_slam_tpu_torch.geometry import camera as t_cam

    T_rc1 = (jnp.eye(4).at[:3, :3].set(j_se3.so3_exp(jnp.asarray([0.0, np.pi / 2, 0.0])))
             .at[:3, 3].set(jnp.asarray([0.161, 0.004, -0.071])))
    jcal = j_cam.CameraParams(
        K=jnp.tile(jnp.asarray([[260.0, 260.0, 160.0, 120.0]]), (C, 1)), dist=jnp.zeros((C, 5)),
        T_rc=jnp.stack([jnp.eye(4), T_rc1]).astype(jnp.float32), bf=jnp.asarray(20.0),
        width=320, height=240)
    return jcal, convert.to_torch(jcal, t_cam.CameraParams, "cpu")


def test_loop_closer_detects_and_does_not_close(vocs, filled):
    """The keyframes go through both packages' whole `process_keyframe` in
    order, with the reference rig's calibration.  On every keyframe: the same
    loop candidates (the third keyframe of the revisit passes the temporal
    consistency check), the same consistency groups, and the same decision
    on each candidate that reaches Sim3 verification (the port takes the
    reference's RANSAC triplets).  This map has descriptors and no geometry
    (every point and pose at the origin), so both packages reject the
    revisit's candidates: neither closes a loop, the map comes back as it
    went in and no global BA is pending."""
    from multi_orb_slam_tpu.config import SlamConfig as JCfg
    from multi_orb_slam_tpu.loop import loop_closing as j_lc
    from multi_orb_slam_tpu_torch.config import SlamConfig as TCfg
    from multi_orb_slam_tpu_torch.loop import loop_closing as t_lc
    from test_torch_sim3 import _reference_triplets

    kw = dict(n_cams=C, max_feat=F, max_kf=16, max_mp=M, width=320, height=240)
    jcal, tcal = _dual_rig()
    lj = j_lc.LoopCloser(jcal, JCfg(**kw))
    lj.voc, lj.db = vocs["j"], j_db.make_empty_db(16, vocs["j"].n_words, 128, 256)
    lt = t_lc.LoopCloser(tcal, TCfg(**kw))
    lt.voc = vocs["t"]
    lt.db = t_db.make_empty_db(16, vocs["t"].n_words, 128, 256, device="cpu")
    lt.triplet_source = lambda valid, a, b: torch.from_numpy(_reference_triplets(
        jax.random.PRNGKey(a * 1000 + b), jnp.asarray(valid.numpy()))).long()
    logs = {"j": [], "t": []}
    for name, lc in (("j", lj), ("t", lt)):
        def wrap(fn, tag, log=logs[name]):
            def inner(state, k, *rest):
                out = fn(state, k, *rest)
                log.append((tag, k, list(out) if tag == "detect" else
                            (rest[0], None if out is None else int(out[0]))))
                return out
            return inner
        lc._detect = wrap(lc._detect, "detect")
        lc._compute_sim3 = wrap(lc._compute_sim3, "sim3")
    st, st_t = filled["st"], filled["st_t"]
    for k in range(K_KF):
        view_j = st._replace(n_kf=jnp.asarray(k + 1, jnp.int32))
        view_t = st_t._replace(n_kf=torch.tensor(k + 1, dtype=torch.int32))
        assert lj.process_keyframe(view_j, k) is view_j
        assert lt.process_keyframe(view_t, k) is view_t
        assert logs["t"] == logs["j"], k
        assert [sorted(g) for g, _ in lt.consistent_groups] == \
            [sorted(g) for g, _ in lj.consistent_groups], k
    detected = {k: c for tag, k, c in logs["j"] if tag == "detect"}
    assert sorted(detected) == list(range(5, K_KF))     # its gate: more than 5 keyframes
    assert detected[9] and set(detected[9]) <= {0, 1, 2}, detected
    tried = [(k, c) for tag, k, c in logs["t"] if tag == "sim3"]
    assert tried and tried[-1][0] == 9 and all(res is None for _, (_, res) in tried)
    assert len(lt.verifications) >= 1 and not any(v["accepted"] for v in lt.verifications)
    assert lt.n_loops_closed == lj.n_loops_closed == 0
    assert lt._gba_pending is None and lt.merge_pending_gba(st_t) is st_t
    assert lt.n_gba_merged == lj.n_gba_merged == 0
    np.testing.assert_array_equal(lt.db.has_bow.numpy(), np.asarray(lj.db.has_bow))
    lt.loop_pairs.append((9, 0))
    lt.reset()
    assert not bool(lt.db.has_bow.any()) and lt.voc is vocs["t"] and lt.consistent_groups == []
    assert lt.loop_pairs == [] and lt.last_loop_kf == -t_lc.DETECT_GAP


def test_load_dbow2_text(tmp_path):
    """k = 3, L = 2: nine node lines "parent is_leaf d0..d31 weight" after
    the header, in breadth-first order."""
    rng = np.random.RandomState(3)
    lines = ["3 2 0 0"]
    rows = [(0, 0), (0, 1), (0, 0), (1, 1), (1, 1), (1, 1), (3, 1), (3, 1)]
    for parent, leaf in rows:
        desc = " ".join(str(v) for v in rng.randint(0, 256, 32))
        lines.append(f"{parent} {leaf} {desc} {rng.uniform(0.5, 3.0):.6f}")
    path = tmp_path / "voc.txt"
    path.write_text("\n".join(lines) + "\n")
    vj = j_voc.load_dbow2_text(str(path))
    vt = t_voc.load_dbow2_text(str(path), device="cpu")
    assert (vt.k, vt.depth, vt.n_words) == (vj.k, vj.depth, vj.n_words) == (3, 2, 6)
    got = convert.to_numpy(vt)
    for f in ("children", "node_desc", "word_id", "word_weight"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(vj, f)), err_msg=f)
    q = rng.randint(0, 2**32, (50, 8), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        t_voc.transform_words(vt, _t(q)).numpy(),
        np.asarray(j_voc.transform_words(vj, jnp.asarray(q))))
    # a node that names a parent outside the file is refused
    path.write_text("3 2 0 0\n7 1 " + " ".join(["0"] * 32) + " 1.0\n")
    with pytest.raises(ValueError):
        t_voc.load_dbow2_text(str(path), device="cpu")


def test_tensors_land_on_the_cuda_device_unless_asked(vocs):
    """With no CUDA device here, asking for none raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError):
        t_db.make_empty_db(4, 10)
    with pytest.raises(RuntimeError):
        t_voc.build_vocabulary(vocs["train"][:50], k=3, depth=1)
