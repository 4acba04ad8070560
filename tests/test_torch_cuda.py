"""The port's kernel wrappers: routing, checks, launch counts, and (on a
card) each CUDA kernel against its plain PyTorch version.

This file imports no jax, so it also runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tests marked `cuda` build the kernels with nvcc and skip without a card.
"""

import numpy as np
import pytest
import torch

from multi_orb_slam_tpu_torch.ops import kernels, orb

torch.set_num_threads(2)


def _window_args(rng, C=2, Q=300, F=256, dev="cpu"):
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    q_lmin = rng.randint(-1, 6, (C, Q)).astype(np.int32)
    return (
        T(rng.uniform(0, 300, (C, Q, 2)).astype(np.float32)),
        T(np.where(rng.rand(C, Q) < 0.9, rng.uniform(5, 30, (C, Q)), -1).astype(np.float32)),
        T(q_lmin), T(q_lmin + 2),
        T(np.where(rng.rand(C, Q) < 0.5, rng.uniform(0, 300, (C, Q)), -1e9).astype(np.float32)),
        T(rng.randint(-2**31, 2**31, (1, Q, 8), dtype=np.int64).astype(np.int32)),
        T(rng.uniform(0, 300, (C, F, 2)).astype(np.float32)),
        T(np.where(rng.rand(C, F) < 0.7, rng.uniform(0, 300, (C, F)), -1).astype(np.float32)),
        T(rng.randint(0, 8, (C, F)).astype(np.int32)),
        T(rng.rand(C, F) < 0.9),
        T(rng.randint(-2**31, 2**31, (C, F, 8), dtype=np.int64).astype(np.int32)),
    )


def _point_sums_args(rng, LC, F, P, D, dev="cpu"):
    """Each row a random injection of F features into P points, the rest
    -1; the last row all -1."""
    V = rng.randn(LC, F, D).astype(np.float32)
    inv = np.full((LC, P), -1, np.int32)
    for r in range(LC - 1):
        inv[r, rng.choice(P, F, replace=False)] = rng.permutation(F)
    return torch.from_numpy(V).to(dev), torch.from_numpy(inv).to(dev)


def test_cpu_tensors_take_the_plain_version_without_counting():
    kernels.reset_launch_counts()
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.uniform(0, 255, (1, 2, 64, 80)).astype(np.float32))
    orb.extract_orb(img[0], orb.ORBConfig(n_features=64, n_levels=2))
    kernels.window_match(*_window_args(rng, Q=20, F=16))
    kernels.point_sums(*_point_sums_args(rng, 3, 16, 40, 4))
    assert kernels.LAUNCHES == {"fast_score": 0, "gather_patches": 0, "window_match": 0,
                                "point_sums": 0}


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape", "extents"])
def test_wrappers_reject_bad_inputs(bad):
    canvas = torch.zeros((2, 40, 50))
    if bad == "dtype":
        with pytest.raises(TypeError):
            kernels.fast_score(canvas.double(), [(40, 50)] * 2)
    elif bad == "contiguity":
        with pytest.raises(ValueError):
            kernels.gather_patches(canvas.transpose(1, 2), torch.zeros((3, 3), dtype=torch.int32), 5)
    elif bad == "shape":
        args = list(_window_args(np.random.RandomState(1), Q=10, F=8))
        args[2] = args[2][:, :5].contiguous()
        with pytest.raises(ValueError):
            kernels.window_match(*args)
    else:
        with pytest.raises(ValueError):
            kernels.fast_score(canvas, [(40, 50)])


def _dense_window_args(rng, C, Q, F, dev):
    """Every gate open, as `search.match_frame_kf_brute` calls the kernel."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (
        torch.zeros((C, Q, 2), device=dev),
        T(np.where(rng.rand(C, Q) < 0.9, np.inf, -1.0).astype(np.float32)),
        torch.full((C, Q), -1, dtype=torch.int32, device=dev),
        torch.full((C, Q), 1 << 30, dtype=torch.int32, device=dev),
        torch.full((C, Q), -1e9, device=dev),
        T(rng.randint(-2**31, 2**31, (C, Q, 8), dtype=np.int64).astype(np.int32)),
        torch.zeros((C, F, 2), device=dev), torch.full((C, F), -1.0, device=dev),
        torch.zeros((C, F), dtype=torch.int32, device=dev),
        T(rng.rand(C, F) < 0.9),
        T(rng.randint(-2**31, 2**31, (C, F, 8), dtype=np.int64).astype(np.int32)),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fast_score", "gather_patches", "window_match"])
def test_cuda_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.RandomState(2)
    before = kernels.LAUNCHES[name]
    if name == "fast_score":
        for shape, extents in (
                ((3, 120, 160), [(120, 160), (100, 133), (83, 111)]),
                # whole blocks outside the extents, a 7x7 extent, an empty one
                ((4, 96, 400), [(40, 70), (96, 130), (7, 7), (0, 0)]),
                # every extent equal to the canvas
                ((2, 64, 128), [(64, 128), (64, 128)]),
                # a width that is no multiple of 4: scalar loads and stores
                ((2, 50, 131), [(50, 131), (33, 77)])):
            canvas = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)).to(dev)
            assert torch.equal(kernels.fast_score(canvas, extents),
                               kernels.fast_score_plain(canvas, extents)), shape
        # a canvas that does not start on a 16-byte boundary
        flat = torch.from_numpy(rng.uniform(0, 255, 1 + 2 * 40 * 72).astype(np.float32)).to(dev)
        canvas = flat[1:].view(2, 40, 72)
        assert canvas.data_ptr() % 16 and canvas.is_contiguous()
        assert torch.equal(kernels.fast_score(canvas, [(40, 72), (21, 30)]),
                           kernels.fast_score_plain(canvas, [(40, 72), (21, 30)]))
    elif name == "gather_patches":
        canvas = torch.from_numpy(rng.uniform(0, 255, (3, 120, 160)).astype(np.float32)).to(dev)
        idx = np.stack([rng.randint(0, 3, 200), rng.randint(0, 76, 200),
                        rng.randint(0, 116, 200)], 1).astype(np.int32)
        idx[:4] = (5, 500, -3)     # clamped into range by both versions
        idx = torch.from_numpy(idx).to(dev)
        assert torch.equal(kernels.gather_patches(canvas, idx, 45),
                           kernels.gather_patches_plain(canvas, idx, 45))
    else:
        # all four outputs, so both indices, on every row
        for args in (_window_args(rng, dev=dev), _window_args(rng, Q=37, F=70, dev=dev),
                     _window_args(rng, C=1, Q=5, F=1, dev=dev),
                     _window_args(rng, Q=19, F=1100, dev=dev),
                     _dense_window_args(rng, 2, 300, 256, dev),
                     _dense_window_args(rng, 1, 1024, 1024, dev)):
            for g, p in zip(kernels.window_match(*args), kernels.window_match_plain(*args)):
                assert torch.equal(g, p), [tuple(a.shape) for a in args[:2]]
        for strided in (False, True):
            tie = kernels.window_match_tie_rows(strided=strided)
            expected = tie.pop("expected")
            out = kernels.window_match(*[torch.from_numpy(v).to(dev) for v in tie.values()])
            np.testing.assert_array_equal(torch.stack([o[0] for o in out], 1).cpu().numpy(),
                                          expected)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] > before


@pytest.mark.cuda
def test_cuda_window_match_best_in_the_last_tile():
    """The kernel scans the frame features in tiles of 1024 with keys local
    to the tile and folds each tile's pair into the lane's; here the best
    and its equal sit in the sixth, partial tile, past worse candidates in
    every earlier one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(5)
    F = 5 * 1024 + 37
    args = list(_dense_window_args(rng, 1, 3, F, "cuda"))
    args[10][0, F - 5] = args[5][0, 1]            # query 1's own descriptor, twice
    args[10][0, F - 2] = args[5][0, 1]
    args[1] = torch.tensor([[np.inf, np.inf, -1.0]], device="cuda")
    args[9] = torch.ones((1, F), dtype=torch.bool, device="cuda")
    got = kernels.window_match(*args)
    for g, p in zip(got, kernels.window_match_plain(*args)):
        assert torch.equal(g, p)
    assert [int(o[0, 1]) for o in got] == [F - 5, 0, 0, F - 2]
    assert [int(o[0, 2]) for o in got] == [0, kernels.BIG, kernels.BIG, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("LC,F,P,D", [
    (48, 1024, 2048, 4), (64, 1024, 2048, 4), (96, 1024, 2048, 4), (128, 1024, 2048, 4),
    (48, 1024, 4096, 30), (3, 7, 5, 1),
    (130, 1024, 2045, 4), (300, 64, 77, 4), (5, 16, 3, 4), (37, 50, 61, 1), (37, 50, 61, 30)])
def test_cuda_point_sums_matches_plain(LC, F, P, D):
    """The local-BA re-layout shapes (24 to 64 keyframes x 2 cameras), the
    reference kernel's design shape, a ragged tiny one, then what the tiled
    design must get right: a P that no tile of 8 points divides, more rows
    than one chunk of 128, fewer points than a tile, D = 1 and 30 on the
    scalar path: bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(LC + D)
    if P < F:
        V = torch.from_numpy(rng.randn(LC, F, D).astype(np.float32)).cuda()
        inv = torch.from_numpy(rng.randint(-1, F + 2, (LC, P)).astype(np.int32)).cuda()
    else:
        V, inv = _point_sums_args(rng, LC, F, P, D, "cuda")
    before = kernels.LAUNCHES["point_sums"]
    s_k, g_k = kernels.point_sums(V, inv)
    s_p, g_p = kernels.point_sums_plain(V, inv)
    torch.cuda.synchronize()
    assert torch.equal(g_k, g_p) and torch.equal(s_k, s_p)
    assert kernels.LAUNCHES["point_sums"] == before + 1
    s_k2, _ = kernels.point_sums(V, inv)
    assert torch.equal(s_k, s_k2), "summed differs from launch to launch"


@pytest.mark.cuda
def test_cuda_point_sums_unaligned_values_take_the_scalar_path():
    """D = 4 values that do not start on a 16-byte boundary cannot be read
    as float4: the launcher takes the scalar kernel, with the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(8)
    V0, inv = _point_sums_args(rng, 50, 256, 515, 4, "cuda")
    flat = torch.empty(V0.numel() + 1, device="cuda")
    V = flat[1:].view(V0.shape).copy_(V0)
    assert V.data_ptr() % 16 and V.is_contiguous()
    s_k, g_k = kernels.point_sums(V, inv)
    s_p, g_p = kernels.point_sums_plain(V0, inv)
    torch.cuda.synchronize()
    assert torch.equal(g_k, g_p) and torch.equal(s_k, s_p)


def _ba_problem(seed=0, n_free=6, n_fixed=4, n_pts=400, C=2, F=160, dev="cpu"):
    """A windowed BA problem made with numpy: points in front of a row of
    rigs, pixel noise 0.1, 40% of the observations mono, 30 of them moved by
    20 to 50 pixels, perturbed free poses and points, padded to L = 24
    keyframe rows and P = 512 points as `build_local_problem` pads."""
    from multi_orb_slam_tpu_torch.geometry import se3
    from multi_orb_slam_tpu_torch.optim import local_ba

    rng = np.random.RandomState(seed)
    L, Lp, Pp = n_free + n_fixed, 24, 512
    K = np.tile(np.array([400.0, 400.0, 320.0, 240.0], np.float32), (C, 1))
    bf = np.float32(80.0)
    T_rc = np.stack([np.eye(4, dtype=np.float32)] * C)
    T_rc[1][:3, 3] = [0.1, 0.0, 0.0]
    exp = lambda xi: se3.exp(torch.from_numpy(np.asarray(xi, np.float32))).numpy()  # noqa: E731
    pts = rng.uniform(-3, 3, (n_pts, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    poses = np.stack([exp([0.3 * (i - L / 2), 0, 0, 0, 0.05 * (i - L / 2), 0]) for i in range(L)])
    obs_mp = np.full((Lp, C, F), -1, np.int32)
    obs_uvr = np.zeros((Lp, C, F, 3), np.float32)
    for l in range(L):
        for c in range(C):
            Tcam = T_rc[c] @ poses[l]
            Xc = pts @ Tcam[:3, :3].T + Tcam[:3, 3]
            sel = rng.permutation(np.nonzero(Xc[:, 2] > 0.5)[0])[:F]
            u = K[c, 0] * Xc[sel, 0] / Xc[sel, 2] + K[c, 2]
            v = K[c, 1] * Xc[sel, 1] / Xc[sel, 2] + K[c, 3]
            uvr = np.stack([u, v, u - bf / Xc[sel, 2]], 1) + 0.1 * rng.randn(len(sel), 3)
            uvr[rng.rand(len(sel)) < 0.4, 2] = -1.0
            obs_mp[l, c, :len(sel)] = sel
            obs_uvr[l, c, :len(sel)] = uvr
    for _ in range(30):
        l, c, j = rng.randint(L), rng.randint(C), rng.randint(F)
        obs_uvr[l, c, j, :2] += rng.uniform(20, 50, 2)
    kf_free = np.zeros(Lp, bool)
    kf_free[n_fixed:L] = True
    kf_Tcw = np.tile(np.eye(4, dtype=np.float32), (Lp, 1, 1))
    kf_Tcw[:L] = poses
    for l in np.nonzero(kf_free)[0]:
        kf_Tcw[l] = exp(0.03 * rng.randn(6)) @ kf_Tcw[l]
    mp_pos = np.zeros((Pp, 3), np.float32)
    mp_pos[:n_pts] = pts + 0.15 * rng.randn(n_pts, 3).astype(np.float32)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    prob = local_ba.BAProblem(
        kf_slot=T(np.where(np.arange(Lp) < L, np.arange(Lp), -1).astype(np.int32)),
        kf_Tcw=T(kf_Tcw), kf_free=T(kf_free), kf_valid=T(np.arange(Lp) < L),
        mp_slot=T(np.where(np.arange(Pp) < n_pts, np.arange(Pp), -1).astype(np.int32)),
        mp_pos=T(mp_pos), mp_valid=T(np.arange(Pp) < n_pts), obs_mp=T(obs_mp),
        obs_uvr=T(obs_uvr),
        obs_inv_sigma2=T((1.0 / 1.44 ** rng.randint(0, 4, (Lp, C, F))).astype(np.float32)))
    return prob, T(T_rc), T(K), T(bf)


def _hold_solves_together(label, prob, T_rc, K, bf, cpu, card, atol, one_stereo_holds):
    """Two `solve_ba` results on one CPU-side problem: poses within `atol`,
    points that their common inliers hold within `atol` metres, inlier flags
    equal except where chi2 at the CPU's solution lies within 1% of its
    gate.  Prints the readings."""
    from multi_orb_slam_tpu_torch.optim import residuals

    (kf_c, mp_c, inl_c), (kf_g, mp_g, inl_g) = cpu, card
    both = inl_c & inl_g
    P = prob.mp_pos.shape[0]
    n_inl = torch.bincount(prob.obs_mp[both].long(), minlength=P)
    n_st = torch.bincount(prob.obs_mp[both & (prob.obs_uvr[..., 2] >= 0)].long(), minlength=P)
    held = prob.mp_valid & ((n_inl >= 2) | ((n_st >= 1) if one_stereo_holds else False))
    d_kf = float((kf_g - kf_c).abs().max())
    d_mp = (mp_g - mp_c).abs().amax(-1)
    differ = inl_c != inl_g
    loose = prob.mp_valid & ~held
    print(f"solve_ba card vs CPU, {label}: poses max |diff| {d_kf:.3e}; "
          f"{int(held.sum())} held points max {float(d_mp[held].max()):.3e} m; "
          f"{int(loose.sum())} other points max "
          f"{float(d_mp[loose].max()) if loose.any() else 0.0:.3e} m; "
          f"{int(differ.sum())} inlier flags differ; farthest point "
          f"{float(mp_c[prob.mp_valid].norm(dim=-1).max()):.1f} m (CPU) "
          f"{float(mp_g[prob.mp_valid].norm(dim=-1).max()):.1f} m (card)")
    assert d_kf < atol
    assert int(held.sum()) >= 0.6 * int(prob.mp_valid.sum())
    assert float(d_mp[held].max()) < atol
    if differ.any():
        g = prob.obs_mp.clamp(min=0).long()
        e, _, _, is_st, _ = residuals.reproj_residual(
            kf_c[:, None, None], mp_c[g], T_rc[None, :, None], K[None, :, None], bf,
            prob.obs_uvr, want_jac=False)
        chi2 = torch.sum(e * e * residuals.row_weights(is_st), dim=-1) * prob.obs_inv_sigma2
        gate = torch.where(is_st, 7.815, 5.991)
        assert bool(((chi2 - gate).abs()[differ] <= 1e-2 * gate[differ]).all()), int(differ.sum())


def test_ba_problem_fixture_is_solved_on_the_cpu():
    """The fixed problem of the card test below: local BA brings the
    perturbed free poses back and rejects the moved observations."""
    from multi_orb_slam_tpu_torch.optim import local_ba

    prob, T_rc, K, bf = _ba_problem()
    start = prob.kf_Tcw.clone()
    kf, mp, inl = local_ba.solve_ba(prob, T_rc, K, bf, phases=((5, True), (8, False)))
    free = prob.kf_free
    assert torch.equal(kf[~free], start[~free])
    seen = prob.obs_mp >= 0
    assert 15 <= int((seen & ~inl).sum()) <= 0.05 * int(seen.sum())
    assert torch.isfinite(kf).all() and torch.isfinite(mp).all()


@pytest.mark.cuda
def test_cuda_solve_ba_matches_cpu():
    """`solve_ba` on the card against `solve_ba` on the CPU on one fixed
    problem (24 keyframe rows x 2 cameras, 512 points: the `point_sums`
    kernel on one side, its plain version on the other).  Poses atol 1e-3,
    points whose inliers fix their depth (two or more, or one stereo) atol
    1e-3 m, inlier flags equal except where chi2 at the CPU's solution lies
    within 1% of its gate."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch.optim import local_ba

    phases = ((5, True), (8, False))
    prob, T_rc, K, bf = _ba_problem()
    kf_c, mp_c, inl_c = local_ba.solve_ba(prob, T_rc, K, bf, phases=phases)
    before = kernels.LAUNCHES["point_sums"]
    prob_g, *cal_g = _ba_problem(dev="cuda")
    kf_g, mp_g, inl_g = [x.cpu() for x in local_ba.solve_ba(prob_g, *cal_g, phases=phases)]
    assert kernels.LAUNCHES["point_sums"] == before + 1
    _hold_solves_together("fixed problem", prob, T_rc, K, bf, (kf_c, mp_c, inl_c),
                          (kf_g, mp_g, inl_g), atol=1e-3, one_stereo_holds=True)


def _small_scene():
    """A one-camera 320x240 scene of 12 frames and its configuration."""
    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.geometry import camera as cam_mod
    from multi_orb_slam_tpu_torch.io import synthetic

    Hh, Ww, Cc = 240, 320, 1
    cfg = SlamConfig(n_cams=Cc, max_feat=512, max_kf=32, max_mp=8192, width=Ww, height=Hh,
                     th_depth=6.0, max_frames_kf=4, orb=orb.ORBConfig(n_features=512))
    K = torch.tensor([[260.0, 260.0, 160.0, 120.0]])
    calib = cam_mod.CameraParams(K=K, dist=torch.zeros((1, 5)), T_rc=torch.eye(4)[None],
                                 bf=torch.tensor(20.0), width=Ww, height=Hh)
    seq = synthetic.make_sequence(n_frames=12, K=K[0].numpy(), height=Hh, width=Ww,
                                  n_points=2500)
    return cfg, calib, seq


@pytest.mark.cuda
def test_cuda_solve_ba_matches_cpu_on_a_real_window():
    """The local-BA window of the last keyframe of a tracked scene (built
    on the CPU), solved on the CPU and on the card.  A real window holds
    points that one inlier or none leaves free to slide along their ray
    (in the reference package too); poses and the points that two or more
    common inliers hold agree to 2e-3, inlier flags except near the gate."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.mapping import fusion, local_mapping, triangulation
    from multi_orb_slam_tpu_torch.optim import local_ba

    cfg, calib, seq = _small_scene()
    tracker = tracking.Tracker(calib, cfg, device="cpu")
    snaps = []

    def cb(k):
        snaps.append((tracker.map, k, tracker.frame_id))
        return local_mapping.run_mapping_stage(tracker.map, k, tracker.frame_id, calib, cfg)

    tracker.kf_inserted_cb = cb
    for g, d in zip(seq.grays, seq.depths):
        tracker.process(g, d)
    st, k, fid = snaps[-1]
    assert int(st.n_kf) >= 4
    st = local_mapping.cull_map_points(st, fid, cfg)
    st = triangulation.triangulate_new_points(st, k, calib, cfg)[0]
    st = fusion.fuse_neighbors(st, k, calib, cfg)[0]
    prob = local_mapping.build_local_problem(st, k, cfg, 12, 12)
    phases = ((5, True), (8, False))
    cpu = local_ba.solve_ba(prob, calib.T_rc, calib.K, calib.bf, phases=phases)
    prob_g = local_ba.BAProblem(*[v.cuda() for v in prob])
    card = [x.cpu() for x in local_ba.solve_ba(
        prob_g, calib.T_rc.cuda(), calib.K.cuda(), calib.bf.cuda(), phases=phases)]
    _hold_solves_together("real window", prob, calib.T_rc, calib.K, calib.bf, cpu, card,
                          atol=2e-3, one_stereo_holds=False)


@pytest.mark.cuda
def test_cuda_mapping_stage_runs_on_the_card():
    """The tracker with the mapping stage, every stage on, over a small
    one-camera scene on the CPU and on the card: the same keyframes, every
    frame tracked, both within 5 cm of ground truth.  (The two runs are not
    held to each other: tracking alone already differs by 6 mm between the
    devices on this scene, and local BA over 4 keyframes amplifies it.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.geometry import align
    from multi_orb_slam_tpu_torch.mapping import local_mapping

    cfg, calib, seq = _small_scene()
    out = {}
    for dev in ("cpu", "cuda"):
        tracker = tracking.Tracker(calib, cfg, device=dev)
        tracker.kf_inserted_cb = lambda k, t=tracker: local_mapping.run_mapping_stage(
            t.map, k, t.frame_id, t.calib, cfg)
        for g, d in zip(seq.grays, seq.depths):
            tracker.process(g, d)
        traj = tracker.absolute_trajectory()
        assert all(not lost for *_, lost in traj)
        centres = lambda Ts: torch.from_numpy(np.stack(  # noqa: E731
            [np.linalg.inv(np.asarray(T, np.float64))[:3, 3] for T in Ts]))
        ate = float(align.ate_rmse(centres([T for _, _, T, _ in traj]), centres(seq.poses_gt)))
        out[dev] = (ate, int(tracker.map.n_kf))
    assert kernels.LAUNCHES["point_sums"] >= 1
    assert out["cpu"][1] == out["cuda"][1] >= 3
    assert out["cpu"][0] < 0.05 and out["cuda"][0] < 0.05, out


@pytest.mark.cuda
def test_cuda_relocalization_matches_cpu():
    """A `System` tracks 12 frames of a dual 320x240 rig on the CPU (mapping
    and the loop stage on, a small online vocabulary).  Its map, vocabulary
    and database are copied to the card and a later frame, then a blank one,
    are relocalized on both devices: the same `ok`, the found poses within
    1 cm of each other (each device draws its own minimal sets) and 5 cm of
    ground truth, and `window_match` launched twice for the found frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch import system as system_mod
    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.frontend import frame as frame_mod
    from multi_orb_slam_tpu_torch.geometry import camera as cam_mod, se3
    from multi_orb_slam_tpu_torch.io import synthetic
    from multi_orb_slam_tpu_torch.loop import loop_closing
    from multi_orb_slam_tpu_torch.reloc import relocalization

    Hh, Ww, Cc, NF = 240, 320, 2, 512
    cfg = SlamConfig(n_cams=Cc, max_feat=NF, max_kf=32, max_mp=12288, local_cap=2048,
                     new_mp_per_cam=128, width=Ww, height=Hh, th_depth=6.0, max_frames_kf=3,
                     orb=orb.ORBConfig(n_features=NF))
    T_c12 = torch.eye(4)
    T_c12[:3, :3] = se3.so3_exp(torch.tensor([0.0, 0.9, 0.0]))
    T_c12[:3, 3] = torch.tensor([0.16, 0.004, -0.07])
    T_rc = torch.stack([torch.eye(4), torch.linalg.inv(T_c12)])
    K = torch.tensor([[260.0, 260.0, 160.0, 120.0]]).repeat(Cc, 1)
    calib = cam_mod.CameraParams(K=K, dist=torch.zeros((Cc, 5)), T_rc=T_rc,
                                 bf=torch.tensor(20.0), width=Ww, height=Hh)
    seq = synthetic.make_sequence(n_frames=16, K=K[0].numpy(), T_rc=T_rc.numpy(), height=Hh,
                                  width=Ww, n_points=5000)
    sys_ = system_mod.System(sensor=system_mod.Sensor.DUAL_RGBD, calib=calib, cfg=cfg,
                             device="cpu")
    sys_.loop_closer = loop_closing.LoopCloser(sys_.calib, cfg, vocab_min_descs=1200,
                                               vocab_k=6, vocab_depth=3)
    for g, d in zip(seq.grays[:12], seq.depths[:12]):
        sys_.track_rgbd(g[0], d[0], g[1], d[1])
    voc, db = sys_.loop_closer.voc, sys_.loop_closer.db
    assert voc is not None and int(sys_.map.n_kf) >= 4

    def on(nt, dev):
        return type(nt)(*[v.to(dev) if isinstance(v, torch.Tensor) else v for v in nt])

    blank = (np.full_like(seq.grays[0], 100.0), np.zeros_like(seq.depths[0]))
    for name, (g, d) in (("frame 15", (seq.grays[15], seq.depths[15])), ("blank", blank)):
        out = {}
        for dev in ("cpu", "cuda"):
            cal = on(calib, dev)
            fr = frame_mod.build_frame(torch.from_numpy(np.asarray(g, np.float32)).to(dev),
                                       torch.from_numpy(np.asarray(d, np.float32)).to(dev),
                                       cal, cfg.orb)
            before = kernels.LAUNCHES["window_match"]
            ok, Tcw, fmp, n = relocalization.relocalize(
                on(sys_.map, dev), fr, on(voc, dev), on(db, dev), cal, cfg)
            out[dev] = (ok, None if Tcw is None else Tcw.cpu().numpy().astype(np.float64), n,
                        kernels.LAUNCHES["window_match"] - before)
        assert out["cpu"][0] == out["cuda"][0] == (name != "blank"), (name, out)
        assert out["cpu"][3] == 0
        if name == "blank":
            continue
        assert out["cuda"][3] == 2
        c_cpu, c_gpu = (np.linalg.inv(out[dev][1])[:3, 3] for dev in ("cpu", "cuda"))
        gt = np.linalg.inv(seq.poses_gt[15] @ np.linalg.inv(seq.poses_gt[0]))[:3, 3]
        assert np.linalg.norm(c_cpu - c_gpu) < 0.01, (c_cpu, c_gpu)
        assert np.linalg.norm(c_gpu - gt) < 0.05 and abs(out["cpu"][2] - out["cuda"][2]) <= 10


# ---------------------------------------------------------------------------
# loop closing: the three window_match roles and global BA on the card
# ---------------------------------------------------------------------------


def _loop_role_args(role, rng, dev):
    """Random `window_match` arguments as each loop role builds them: the
    word-gated match and the projection count through the loop closer's own
    builders, `search_by_sim3`'s two directions as one C = 2 call."""
    from multi_orb_slam_tpu_torch.loop import loop_closing

    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    desc = lambda n: T(rng.randint(0, 4, (n, 8)).astype(np.int32))  # noqa: E731  (many ties)
    if role == "word_match":
        words = np.array([0, 7, 999_999, 123_456], np.int32)
        return loop_closing.word_match_args(
            desc(700), T(rng.rand(700) < 0.8), T(words[rng.randint(0, 4, 700)]),
            desc(650), T(rng.rand(650) < 0.8), T(words[rng.randint(0, 4, 650)]))
    if role == "guided_matches":
        Q, F = 5000, 300
        return loop_closing.guided_count_args(
            T(rng.uniform(0, 60, (Q, 2)).astype(np.float32)), T(rng.rand(Q) < 0.5), desc(Q),
            T(rng.uniform(0, 60, (F, 2)).astype(np.float32)), T(rng.rand(F) < 0.9), desc(F))
    F = 400
    lvl = rng.randint(0, 8, (2, F)).astype(np.int32)
    return (T(rng.uniform(0, 100, (2, F, 2)).astype(np.float32)),
            T(np.where(rng.rand(2, F) < 0.7, 7.5 * 1.2 ** lvl, -1.0).astype(np.float32)),
            T(lvl - 1), T(lvl), torch.full((2, F), -1e9, device=dev), desc(2 * F).reshape(2, F, 8),
            T(rng.uniform(0, 100, (2, F, 2)).astype(np.float32)), torch.full((2, F), -1.0, device=dev),
            T(rng.randint(0, 8, (2, F)).astype(np.int32)), T(rng.rand(2, F) < 0.7),
            desc(2 * F).reshape(2, F, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("role", ["word_match", "search_by_sim3", "guided_matches"])
def test_cuda_loop_role_matches_plain(role):
    """Each of the loop closer's `window_match` calls: the kernel's four
    outputs equal the plain version's on every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _loop_role_args(role, np.random.RandomState(11), "cuda")
    before = kernels.LAUNCHES["window_match"]
    got = kernels.window_match(*args)
    for g, p in zip(got, kernels.window_match_plain(*args)):
        assert torch.equal(g, p), role
    assert kernels.LAUNCHES["window_match"] == before + 1
    assert int((got[1] < kernels.BIG).sum()) > 10


def _gba_map(dev, seed=0, K=8, C=2, F=160, M=600):
    """A map made with numpy for global BA: K rig keyframes along a line,
    points in front of them, every point seen where it projects (stereo
    where depth < 4 m, pixel noise 0.3), then all keyframes but slot 0 and
    all points perturbed.  Returns (state, calib, cfg)."""
    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.geometry import camera as cam_mod, se3
    from multi_orb_slam_tpu_torch.mapping import map_state

    rng = np.random.RandomState(seed)
    cfg = SlamConfig(n_cams=C, max_feat=F, max_kf=K + 2, max_mp=M + 1, width=320, height=240)
    Kc = np.tile(np.array([260.0, 260.0, 160.0, 120.0], np.float32), (C, 1))
    T_rc = np.stack([np.eye(4, dtype=np.float32)] * C)
    T_rc[1][:3, :3] = se3.so3_exp(torch.tensor([0.0, 0.5, 0.0])).numpy()
    T_rc[1][:3, 3] = [0.1, 0.0, 0.0]
    exp = lambda xi: se3.exp(torch.from_numpy(np.asarray(xi, np.float32))).numpy()  # noqa: E731
    pts = rng.uniform([-3, -1.5, 2.0], [4, 1.5, 6.0], (M, 3)).astype(np.float32)
    st = map_state.make_empty(K + 2, C, F, M + 1, device="cpu")
    kf_Tcw = st.kf_Tcw.numpy().copy()
    kf_mp = np.full((K + 2, C, F), -1, np.int32)
    xy = np.zeros((K + 2, C, F, 2), np.float32)
    ur = np.full((K + 2, C, F), -1.0, np.float32)
    for k in range(K):
        kf_Tcw[k] = exp([-0.3 * k, 0.0, 0.0, 0.0, 0.04 * k, 0.0])
        for c in range(C):
            Tc = T_rc[c] @ kf_Tcw[k]
            Xc = pts @ Tc[:3, :3].T + Tc[:3, 3]
            u = Kc[c, 0] * Xc[:, 0] / Xc[:, 2] + Kc[c, 2]
            v = Kc[c, 1] * Xc[:, 1] / Xc[:, 2] + Kc[c, 3]
            ok = np.nonzero((Xc[:, 2] > 0.5) & (u > 0) & (u < 320) & (v > 0) & (v < 240))[0]
            sel = rng.permutation(ok)[:F]
            kf_mp[k, c, :len(sel)] = sel
            xy[k, c, :len(sel)] = np.stack([u[sel], v[sel]], -1) + 0.3 * rng.randn(len(sel), 2)
            ur[k, c, :len(sel)] = np.where(Xc[sel, 2] < 4.0, xy[k, c, :len(sel), 0]
                                           - 20.0 / Xc[sel, 2], -1.0)
    kf_pert = kf_Tcw.copy()
    for k in range(1, K):
        kf_pert[k] = exp(0.02 * rng.randn(6)) @ kf_Tcw[k]
    pos = np.zeros((M + 1, 3), np.float32)
    pos[:M] = pts + 0.03 * rng.randn(M, 3)
    valid = np.zeros(K + 2, bool)
    valid[:K] = True
    mp_valid = np.zeros(M + 1, bool)
    mp_valid[:M] = True
    st = st._replace(
        kf_Tcw=torch.from_numpy(kf_pert), kf_valid=torch.from_numpy(valid),
        kf_frame_id=torch.from_numpy(np.where(valid, np.arange(K + 2), -1).astype(np.int32)),
        kf_xy_und=torch.from_numpy(xy), kf_uright=torch.from_numpy(ur),
        kf_feat_valid=torch.from_numpy(kf_mp >= 0), kf_mp=torch.from_numpy(kf_mp),
        mp_pos=torch.from_numpy(pos), mp_valid=torch.from_numpy(mp_valid))
    calib = cam_mod.CameraParams(K=torch.from_numpy(Kc), dist=torch.zeros((C, 5)),
                                 T_rc=torch.from_numpy(T_rc), bf=torch.tensor(20.0),
                                 width=320, height=240)
    on = lambda nt: type(nt)(*[v.to(dev) if isinstance(v, torch.Tensor) else v for v in nt])  # noqa: E731
    return on(st), on(calib), cfg


def test_gba_map_fixture_is_solved_on_the_cpu():
    """The problem of the card tests below: global BA moves the perturbed
    keyframes, leaves slot 0 as it was and gives finite points."""
    from multi_orb_slam_tpu_torch.optim import global_ba

    st, calib, cfg = _gba_map("cpu")
    Tcw, pos = global_ba.dispatch_global_ba(st, calib, cfg, n_outer=9)
    assert torch.equal(Tcw[0], st.kf_Tcw[0]) and bool(torch.isfinite(pos).all())
    assert float((Tcw[1:8] - st.kf_Tcw[1:8]).abs().max()) > 1e-3


@pytest.mark.cuda
def test_cuda_global_ba_matches_cpu():
    """`dispatch_global_ba` on the card against the CPU on one problem (its
    scatters add with atomics on the card, in no fixed order): keyframe poses
    within 1e-3, points within 1e-3 m."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch.optim import global_ba

    out = {}
    for dev in ("cpu", "cuda"):
        st, calib, cfg = _gba_map(dev)
        Tcw, pos = global_ba.dispatch_global_ba(st, calib, cfg, n_outer=9)
        out[dev] = (Tcw.cpu(), pos.cpu(), st.mp_valid.cpu())
    (Tc, pc, mv), (Tg, pg, _) = out["cpu"], out["cuda"]
    d_kf, d_mp = float((Tc - Tg).abs().max()), float((pc - pg)[mv].abs().max())
    print(f"global BA card vs CPU: poses max |diff| {d_kf:.3e}, points max |diff| {d_mp:.3e} m")
    assert d_kf < 1e-3 and d_mp < 1e-3


@pytest.mark.cuda
def test_cuda_dispatch_global_ba_reads_nothing_back():
    """The global BA is only enqueued: under
    `torch.cuda.set_sync_debug_mode("error")` no operation of the dispatch
    synchronises the host with the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch.optim import global_ba

    st, calib, cfg = _gba_map("cuda")
    global_ba.dispatch_global_ba(st, calib, cfg, n_outer=3)     # first-use set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        Tcw, pos = global_ba.dispatch_global_ba(st, calib, cfg, n_outer=9)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(Tcw).all() and torch.isfinite(pos).all())


KITTI_H, KITTI_W = 376, 1241      # KITTI 00-02's published image size


@pytest.mark.cuda
def test_cuda_fast_score_at_the_kitti_canvas():
    """The stereo frame's canvas: left and right x 8 pyramid levels of a
    1241 x 376 image.  1241 is no multiple of 4, so the kernel takes its
    scalar loads and stores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(11)
    shapes = orb.pyramid_shapes(KITTI_H, KITTI_W, orb.ORBConfig(n_features=2000))
    extents = shapes * 2
    canvas = torch.from_numpy(
        rng.uniform(0, 255, (16, KITTI_H, KITTI_W)).astype(np.float32)).cuda()
    assert torch.equal(kernels.fast_score(canvas, extents),
                       kernels.fast_score_plain(canvas, extents))


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
def test_cuda_window_match_one_camera_2000_features(dense):
    """C = 1 and F = 2000: two tiles of 1024 features, the second partial
    (976), at the search shape and with every gate open."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(12)
    args = (_dense_window_args(rng, 1, 2000, 2000, "cuda") if dense
            else _window_args(rng, C=1, Q=2000, F=2000, dev="cuda"))
    for g, p in zip(kernels.window_match(*args), kernels.window_match_plain(*args)):
        assert torch.equal(g, p)


@pytest.mark.cuda
def test_cuda_build_frame_stereo_matches_cpu():
    """One stereo pair of a 320x240 rendered scene through
    `build_frame_stereo` on the CPU and on the card: the pyramid's float32
    products run in another order on each, so keypoints are held as shared
    (>= 95%), and where both sides matched the same right keypoint, depth
    within 1e-4 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch.frontend import frame
    from multi_orb_slam_tpu_torch.geometry import camera as cam_mod
    from multi_orb_slam_tpu_torch.io import synthetic

    K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
    world = synthetic.make_box_world(seed=0, n_points=3000)
    T = synthetic.orbit_trajectory(8)[0]
    T_lr = np.eye(4, dtype=np.float32)
    T_lr[0, 3] = -20.0 / 260.0
    gl, _ = synthetic.render_rgbd(world, K, T, 240, 320)
    gr, _ = synthetic.render_rgbd(world, K, T_lr @ T, 240, 320)
    calib = cam_mod.CameraParams(K=torch.from_numpy(K)[None], dist=torch.zeros((1, 5)),
                                 T_rc=torch.eye(4)[None], bf=torch.tensor(20.0),
                                 width=320, height=240)
    cfg = orb.ORBConfig(n_features=512)
    out = {}
    for dev in ("cpu", "cuda"):
        cal = cam_mod.CameraParams(*[v.to(dev) if isinstance(v, torch.Tensor) else v
                                     for v in calib])
        fr = frame.build_frame_stereo(torch.from_numpy(np.round(gl)).float().to(dev),
                                      torch.from_numpy(np.round(gr)).float().to(dev), cal, cfg)
        out[dev] = {f: getattr(fr, f)[0].cpu().numpy() for f in ("xy", "level", "valid",
                                                                  "depth", "uright")}
    keyed = {d: {(float(x), float(y), int(l)): i for i, ((x, y), l, v) in enumerate(
        zip(o["xy"], o["level"], o["valid"])) if v} for d, o in out.items()}
    shared = [(i, keyed["cuda"][k]) for k, i in keyed["cpu"].items() if k in keyed["cuda"]]
    assert len(shared) >= 0.95 * len(keyed["cpu"])
    ic, ig = (np.array(v) for v in zip(*shared))
    uc, ug = out["cpu"]["uright"][ic], out["cuda"]["uright"][ig]
    assert ((ug >= 0) & (uc >= 0)).sum() > 150
    assert np.mean((uc >= 0) == (ug >= 0)) >= 0.98
    both = (uc >= 0) & (ug >= 0) & (np.abs(uc - ug) < 1e-3)
    np.testing.assert_allclose(out["cuda"]["depth"][ig][both], out["cpu"]["depth"][ic][both],
                               rtol=1e-4)
    print(f"build_frame_stereo card vs CPU: {len(shared)} of {len(keyed['cpu'])} keypoints "
          f"shared, the same match decision on {np.mean((uc >= 0) == (ug >= 0)):.4f}, "
          f"{int(both.sum())} same right matches")
