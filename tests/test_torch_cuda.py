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
def test_cuda_mapping_step_replays_equal_the_body():
    """The small scene tracked on the card with the mapping stage; the maps
    that went into its last two stages (both with local BA) go, one after
    the other, through one entry of the graphed
    `local_mapping._mapping_stage_fused` (captured before the first, unless
    the tracker's own stages captured it): each
    replay (and its copy out, under `set_sync_debug_mode("error")`) is the
    same bits as the body called eagerly (`graphs.eager()`) on the same
    inputs, and each replay adds the launches of its capture (one
    `point_sums`, the fusion's `window_match`) to the counts, and nothing
    more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.mapping import local_mapping
    from multi_orb_slam_tpu_torch.utils import graphs

    cfg, calib, seq = _small_scene()
    tracker = tracking.Tracker(calib, cfg, device="cuda")
    snaps = []

    def cb(k):
        snaps.append((graphs.clone(tracker.map), k, tracker.frame_id))
        return local_mapping.run_mapping_stage(tracker.map, k, tracker.frame_id,
                                               tracker.calib, cfg)

    tracker.kf_inserted_cb = cb
    for g, d in zip(seq.grays, seq.depths):
        tracker.process(g, d)
    snaps = [x for x in snaps if int(x[0].n_kf) > 2][-2:]
    assert len(snaps) == 2
    fn = local_mapping._mapping_stage_fused
    window = (12, 12, ((5, True), (8, False)))
    entry = None
    kernels.reset_launch_counts()
    for i, (st, k, fid) in enumerate(snaps):
        args = (st, torch.full((), k, dtype=torch.int32, device="cuda"),
                torch.full((), fid, dtype=torch.int32, device="cuda"), tracker.calib, cfg,
                *window)
        counts = dict(kernels.LAUNCHES)
        with graphs.eager():
            eager = fn(*args)
        kernels.LAUNCHES.update(counts)
        if entry is None:
            entry = fn.entry(*args)
            calls0 = entry.n_calls
            if entry.graph is None:
                entry.capture()     # the host waits here, once
        assert fn.entry(*args) is entry
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for name in st._fields:
            assert torch.equal(getattr(out, name), getattr(eager, name)), (i, name)
        assert int(out.n_kf) >= 3
    assert entry.n_calls - calls0 == 2
    assert entry.graph_launches["point_sums"] == 1 and entry.graph_launches["window_match"] >= 1
    assert kernels.LAUNCHES == {k: 2 * v for k, v in entry.graph_launches.items()}
    print(f"mapping graph: 2 replays the eager bits, kernels in the graph "
          f"{entry.graph_launches}, warm-up {entry.warmup_ms:.1f} ms, capture "
          f"{entry.capture_ms:.1f} ms")


def _on(nt, dev):
    return type(nt)(*[v.to(dev) if isinstance(v, torch.Tensor) else v for v in nt])


@pytest.fixture(scope="module")
def reloc_scene():
    """A `System` tracks 12 frames of a dual 320x240 rig on the CPU (mapping
    and the loop stage on, a small online vocabulary): its map, vocabulary,
    database, the configuration and the sequence."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch import system as system_mod
    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.geometry import camera as cam_mod, se3
    from multi_orb_slam_tpu_torch.io import synthetic
    from multi_orb_slam_tpu_torch.loop import loop_closing

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
    assert sys_.loop_closer.voc is not None and int(sys_.map.n_kf) >= 4
    return dict(cfg=cfg, calib=calib, seq=seq, map=sys_.map, voc=sys_.loop_closer.voc,
                db=sys_.loop_closer.db)


@pytest.mark.cuda
def test_cuda_relocalization_matches_cpu(reloc_scene):
    """The `reloc_scene` map, vocabulary and database are copied to the card
    and a later frame, then a blank one, are relocalized on both devices: the
    same `ok`, the found poses within 1 cm of each other (each device draws
    its own minimal sets) and 5 cm of ground truth, and `window_match`
    launched twice for the found frame."""
    from multi_orb_slam_tpu_torch.frontend import frame as frame_mod
    from multi_orb_slam_tpu_torch.reloc import relocalization

    cfg, calib, seq = reloc_scene["cfg"], reloc_scene["calib"], reloc_scene["seq"]
    blank = (np.full_like(seq.grays[0], 100.0), np.zeros_like(seq.depths[0]))
    for name, (g, d) in (("frame 15", (seq.grays[15], seq.depths[15])), ("blank", blank)):
        out = {}
        for dev in ("cpu", "cuda"):
            cal = _on(calib, dev)
            fr = frame_mod.build_frame(torch.from_numpy(np.asarray(g, np.float32)).to(dev),
                                       torch.from_numpy(np.asarray(d, np.float32)).to(dev),
                                       cal, cfg.orb)
            before = kernels.LAUNCHES["window_match"]
            ok, Tcw, fmp, n = relocalization.relocalize(
                _on(reloc_scene["map"], dev), fr, _on(reloc_scene["voc"], dev),
                _on(reloc_scene["db"], dev), cal, cfg)
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


RELOC_GRAPHED = ("match_stage", "pnp_solve", "pose_ba_inputs", "optimize_pose", "top_up_stage")


def _reloc_stage_args(scene, frame):
    """The arguments of relocalization's graphed stages for the first
    candidate of `frame` on the card, each stage's inputs from the eager
    call of the stage before: {name: (function, arguments)}."""
    from multi_orb_slam_tpu_torch.frontend import frame as frame_mod
    from multi_orb_slam_tpu_torch.optim import pose_opt
    from multi_orb_slam_tpu_torch.placerec import database
    from multi_orb_slam_tpu_torch.reloc import pnp, relocalization as rl
    from multi_orb_slam_tpu_torch.utils import graphs

    cfg, seq = scene["cfg"], scene["seq"]
    cal, st = _on(scene["calib"], "cuda"), _on(scene["map"], "cuda")
    voc, db = _on(scene["voc"], "cuda"), _on(scene["db"], "cuda")
    fr = frame_mod.build_frame(torch.from_numpy(seq.grays[frame]).float().cuda(),
                               torch.from_numpy(seq.depths[frame]).float().cuda(), cal, cfg.orb)
    kf = int(database.detect_relocalization_candidates(db, voc, st, fr.desc[0], fr.valid[0])[0])
    out = {"match_stage": (st.kf_desc, st.kf_mp, st.kf_feat_valid, st.mp_valid, st.mp_pos,
                           fr.desc[0], fr.valid[0], kf)}
    with graphs.eager():
        _, mp_of_feat, matched, Xw = rl.match_stage(*out["match_stage"])
        gen = torch.Generator(device="cuda")
        gen.manual_seed(kf)
        out["pnp_solve"] = (pnp.sample_triplets(matched, 256, gen), fr.xy_und[0], Xw, matched,
                            cal.K[0])
        Tcw0, inl, _ = pnp.pnp_solve(*out["pnp_solve"])
        out["pose_ba_inputs"] = (matched, inl, mp_of_feat, st.mp_pos, fr, cfg)
        frame_mp, obs = rl.pose_ba_inputs(*out["pose_ba_inputs"])
        out["optimize_pose"] = (Tcw0, obs, cal.T_rc, cal.K, cal.bf)
        Tcw, inlier, _ = pose_opt.optimize_pose(*out["optimize_pose"])
        out["top_up_stage"] = (st, kf, frame_mp, inlier, Tcw, fr, cal, cfg)
    fns = {"match_stage": rl.match_stage, "pnp_solve": pnp.pnp_solve,
           "pose_ba_inputs": rl.pose_ba_inputs, "optimize_pose": pose_opt.optimize_pose,
           "top_up_stage": rl.top_up_stage}
    return {name: (fns[name], args) for name, args in out.items()}


@pytest.fixture(scope="module")
def reloc_graph_cases(reloc_scene):
    """Each of relocalization's graphed stages with the arguments of two
    frames (15 and 14): {name: (function, arguments a, arguments b)}."""
    a, b = _reloc_stage_args(reloc_scene, 15), _reloc_stage_args(reloc_scene, 14)
    return {name: (a[name][0], a[name][1], b[name][1]) for name in RELOC_GRAPHED}


@pytest.mark.cuda
@pytest.mark.parametrize("name", RELOC_GRAPHED)
def test_cuda_reloc_graphed_replays_are_the_eager_calls(reloc_graph_cases, name):
    """Relocalization's graphed stages on two frames' inputs: each replay
    is the eager call's bits (`_hold_replays`)."""
    _hold_replays(name, *reloc_graph_cases[name])


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
    """`dispatch_global_ba` on the card against the CPU on one problem: the
    same sums in the same fixed order of rows, but the poses' block sums
    (`sum(1)`) and the card's fused arithmetic round apart from the CPU's,
    and LM iterations carry that on: keyframe poses within 1e-3, points
    within 1e-3 m."""
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
    (its argument build and the replay of its CUDA graph, captured on the
    first call) synchronises the host with the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch.optim import global_ba

    st, calib, cfg = _gba_map("cuda")
    global_ba.dispatch_global_ba(st, calib, cfg, n_outer=9)     # first use: the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        Tcw, pos = global_ba.dispatch_global_ba(st, calib, cfg, n_outer=9)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(Tcw).all() and torch.isfinite(pos).all())


@pytest.mark.cuda
def test_cuda_dispatch_global_ba_gives_the_same_bits_twice():
    """The global BA adds every sum in one fixed order (`optim/segments.py`),
    so on the card two dispatches on one map (replays of its graph) are the
    same bits, and so are two calls of its body under `graphs.eager()`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch.optim import global_ba
    from multi_orb_slam_tpu_torch.utils import graphs

    st, calib, cfg = _gba_map("cuda")
    runs = [global_ba.dispatch_global_ba(st, calib, cfg, n_outer=9) for _ in range(2)]
    with graphs.eager():
        runs += [global_ba.dispatch_global_ba(st, calib, cfg, n_outer=9) for _ in range(2)]
    for a, b in (runs[:2], runs[2:]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    print(f"global BA on the card: two replays and two eager calls each the same bits; replay "
          f"against eager poses {float((runs[0][0] - runs[2][0]).abs().max()):.3e}")


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


DIST_BA_INFO_FLOOR = 10.0   # m^-2: the smallest H_pp eigenvalue of a point held to 1 mm
DIST_BA_MAHALANOBIS = 0.1   # sqrt(dp^T H_pp dp) of every point: a tenth of its own sigma


@pytest.mark.cuda
def test_cuda_dist_ba_nccl_world_one_matches_gloo_world_two():
    """The distributed BA on the card: world 1 on a real NCCL process group
    (its timed step under `set_sync_debug_mode("error")`) against world 2 on
    gloo, two ranks sharing the card, on a small two-camera problem: poses
    within 5e-4, every rank the same poses.

    The points are held in the metric of their information: H_pp, the 3x3
    block the step forms for its Schur complement, at world 1's solution.
    Many points of this problem are seen once or twice, so a change of
    summation order moves them freely along their rays (smallest eigenvalue
    down to ~0.03 m^-2, a standard deviation of metres): every point within
    a tenth of its own standard deviation, sqrt(dp^T H_pp dp) <= 0.1, and
    within 1 mm wherever the smallest eigenvalue is at least 10 m^-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch.drivers import bench_dist_ba
    from multi_orb_slam_tpu_torch.parallel import dist_ba, dryrun, multihost

    T_rc = np.stack([np.eye(4, dtype=np.float32)] * 2)
    T_rc[1, 0, 3] = 0.1
    prob = bench_dist_ba.make_problem(8, 256, 64, T_rc=T_rc, pose_noise=0.01, point_noise=0.05)
    one = multihost.spawn_local(dryrun.run_ba, 1, "nccl", "cuda", prob, 8, 30)[0]
    two = multihost.spawn_local(dryrun.run_ba, 2, "gloo", "cuda", prob, 8, 30)
    assert one["backend"] == "nccl" and one["sync_checked"]
    assert two[0]["backend"] == "gloo" and np.array_equal(two[0]["Tcw"], two[1]["Tcw"])
    np.testing.assert_allclose(two[0]["Tcw"], one["Tcw"], atol=5e-4)
    flat = dist_ba.flatten_problem(*(prob[k] for k in dryrun.FLAT_KEYS), 1)
    H = dist_ba.point_information(
        dist_ba.FlatBA(*(torch.from_numpy(np.asarray(a)) for a in flat)),
        torch.from_numpy(prob["T_rc"]), torch.from_numpy(prob["K_intr"]),
        torch.tensor(float(prob["bf"])), torch.from_numpy(one["Tcw"]),
        torch.from_numpy(one["pos"])).double().numpy()
    dp = (two[0]["pos"] - one["pos"]).astype(np.float64)
    mahalanobis = np.sqrt(np.maximum(np.einsum("mi,mij,mj->m", dp, H, dp), 0.0))
    eig_min = np.linalg.eigvalsh(H)[:, 0]
    held = eig_min >= DIST_BA_INFO_FLOOR
    assert held.sum() >= 0.25 * len(held), held.sum()
    assert mahalanobis.max() <= DIST_BA_MAHALANOBIS, mahalanobis.max()
    np.testing.assert_allclose(two[0]["pos"][held], one["pos"][held], atol=1e-3)
    assert one["costs"][-1] < one["costs"][0]
    print(f"dist BA card, world 1 nccl vs 2 gloo: Tcw within "
          f"{np.abs(two[0]['Tcw'] - one['Tcw']).max():.3g}, sqrt(dp^T H_pp dp) <= "
          f"{mahalanobis.max():.3g}, {int(held.sum())} of {len(held)} points with an "
          f"eigenvalue >= {DIST_BA_INFO_FLOOR} within {np.abs(dp[held]).max():.3g} m, all "
          f"within {np.abs(dp).max():.3g} m, costs {one['costs'][[0, -1]]}")


def _fused_tracker(dev, fuse=False):
    """The small scene, and a pipelined tracker on `dev` after its first
    frame (the map initialized)."""
    from multi_orb_slam_tpu_torch.frontend import tracking

    cfg, calib, seq = _small_scene()
    tracker = tracking.Tracker(calib, cfg, pipelined=True, pipeline_depth=3,
                               fuse_extraction=fuse, device=dev)
    tracker.process(seq.grays[0], seq.depths[0])
    return cfg, tracker, seq


@pytest.mark.cuda
def test_cuda_fused_graph_replays_equal_eager_calls():
    """Five consecutive frames of `track_frame_fused_images`, each once
    eagerly and once as a replay of the `FusedStep`'s CUDA graph, each chain
    on its own outputs: every output and every buffer the same bits; each
    replay adds the launches of its capture (one `fast_score`, one
    `gather_patches`, three `window_match`) to the counts, and nothing more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch.frontend import fused_graph, tracking
    from multi_orb_slam_tpu_torch.utils import graphs

    cfg, tr, seq = _fused_tracker("cuda")
    lp = tr._ensure_local_pts()
    tstate = torch.tensor([tr.last_kf_frame, tr.ref_kf_tracked, 0], dtype=torch.int32,
                          device="cuda")
    carry = (tr.map, tr.prev_frame, tr.prev_Tcw, tr.prev_mp, tr.velocity, tstate, lp)
    fs = fused_graph.FusedStep(tr.calib, cfg, "cuda")
    fs.load(state=carry[0], prev=carry[1], prev_Tcw=carry[2], prev_mp=carry[3],
            velocity=carry[4], tstate=carry[5], local_pts=lp, frame_id=1)
    inserted = 0
    for i in range(1, 6):
        g = torch.from_numpy(seq.grays[i]).float().cuda()
        d = torch.from_numpy(seq.depths[i]).float().cuda()
        out = tracking.track_frame_fused_images(
            *carry, g, d, tr.calib, cfg, torch.full((), i, dtype=torch.int32, device="cuda"))
        kernels.reset_launch_counts()
        fs.put_images(g, d)
        fs.run()
        assert kernels.LAUNCHES == fs.graph_launches
        carry = (out[1], out[0], out[2], out[3], out[4], out[5], lp)
        pairs = [(fs.state, out[1]), (fs.prev, out[0]), (fs.prev_Tcw, out[2]),
                 (fs.prev_mp, out[3]), (fs.velocity, out[4]), (fs.tstate, out[5]),
                 (fs.scalars, out[6]), (fs.ref_slot, out[7]), (fs.ref_pose, out[8]),
                 (fs.ref_fid, out[9])]
        for k, (a, b) in enumerate(pairs):
            for x, y in zip(graphs.tensors(a), graphs.tensors(b)):
                assert torch.equal(x, y), (i, k)
        assert int(fs.frame_id) == i + 1
        inserted += int(out[6][2])
    assert fs.n_captures == 1 and fs.n_replays == 5
    assert fs.graph_launches == {"fast_score": 1, "gather_patches": 1, "window_match": 3,
                                 "point_sums": 0}
    print(f"fused graph: 5 replays the eager bits, {inserted} keyframes inserted, "
          f"warm-up {fs.warmup_ms:.1f} ms, capture {fs.capture_ms:.1f} ms")


@pytest.mark.cuda
def test_cuda_fused_tracker_replays_read_nothing_back():
    """The tracker with `fuse_extraction` on the card: every OK frame one
    replay (with its copies out) under `set_sync_debug_mode("error")`, one
    capture, and the same trajectory and map as the eager pipelined tracker;
    one more replay with the scalars' pinned copy, under the mode set here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runs = {}
    for fuse in (False, True):
        cfg, tr, seq = _fused_tracker("cuda", fuse=fuse)
        for g, d in zip(seq.grays[1:], seq.depths[1:]):
            tr.process(g, d)
        traj = np.stack([T for _, _, T, _ in tr.absolute_trajectory()])
        runs[fuse] = (traj, tr)
    tr = runs[True][1]
    assert tr.fused.n_captures == 1 and tr.fused.n_replays == len(seq.grays) - 1
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    for name in tr.map._fields:
        assert torch.equal(getattr(tr.map, name), getattr(runs[False][1].map, name)), name
    host = torch.empty(8, dtype=torch.int32, pin_memory=True)
    tr.fused.put_images(torch.from_numpy(seq.grays[-1]).cuda(),
                        torch.from_numpy(seq.depths[-1]).cuda())
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.fused.run()
        host.copy_(tr.fused.scalars, non_blocking=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert host[0] in (0, 1)


GRAPHED_NAMES = ("build_frame", "build_frame_stereo", "track_motion_model",
                 "track_reference_kf", "build_local_points_cache", "track_local_map",
                 "insert_keyframe_jit", "track_frame_fused")


@pytest.fixture(scope="module")
def graph_cases():
    """The eight graphed functions of the tracking path, each with the
    arguments of two snapshots of the small scene tracked on the card (two
    frames, two slots, two frame ids; two rendered stereo pairs for
    `build_frame_stereo`): {name: (function, arguments a, arguments b)}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch.frontend import frame, tracking
    from multi_orb_slam_tpu_torch.geometry import camera as cam_mod
    from multi_orb_slam_tpu_torch.io import synthetic
    from multi_orb_slam_tpu_torch.utils import graphs

    cfg, calib, seq = _small_scene()
    tracker = tracking.Tracker(calib, cfg, device="cuda")
    cal = tracker.calib
    snaps = []
    for i, (g, d) in enumerate(zip(seq.grays, seq.depths)):
        if i in (8, 11):
            cur = frame.build_frame(torch.from_numpy(g).float().cuda(),
                                    torch.from_numpy(d).float().cuda(), cal, cfg.orb)
            s = dict(state=tracker.map, prev=tracker.prev_frame, prev_Tcw=tracker.prev_Tcw,
                     prev_mp=tracker.prev_mp, velocity=tracker.velocity, cur=cur, fid=i,
                     slot=tracker.last_kf_slot, pts=tracker._ensure_local_pts(),
                     tstate=graphs.filled([tracker.last_kf_frame, tracker.ref_kf_tracked, 0],
                                          torch.int32, "cuda"),
                     grays=torch.from_numpy(g).float().cuda(),
                     depths=torch.from_numpy(d).float().cuda())
            s["Tcw"], s["frame_mp"] = tracking.track_motion_model(
                s["state"], s["prev"], s["prev_Tcw"], s["prev_mp"], s["velocity"], cur, cal,
                cfg)[:2]
            snaps.append(s)
        tracker.process(g, d)

    K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
    world = synthetic.make_box_world(seed=0, n_points=3000)
    T_lr = np.eye(4, dtype=np.float32)
    T_lr[0, 3] = -20.0 / 260.0
    stereo_cal = cam_mod.CameraParams(K=torch.from_numpy(K)[None].cuda(),
                                      dist=torch.zeros((1, 5), device="cuda"),
                                      T_rc=torch.eye(4, device="cuda")[None],
                                      bf=torch.tensor(20.0, device="cuda"), width=320,
                                      height=240)
    pairs = []
    for T in synthetic.orbit_trajectory(8)[:2]:
        gl, _ = synthetic.render_rgbd(world, K, T, 240, 320)
        gr, _ = synthetic.render_rgbd(world, K, T_lr @ T, 240, 320)
        pairs.append((torch.from_numpy(np.round(gl)).float().cuda(),
                      torch.from_numpy(np.round(gr)).float().cuda(), stereo_cal, cfg.orb))

    def args(name, s, slot):
        return {
            "build_frame": (s["grays"], s["depths"], cal, cfg.orb),
            "track_motion_model": (s["state"], s["prev"], s["prev_Tcw"], s["prev_mp"],
                                   s["velocity"], s["cur"], cal, cfg),
            "track_reference_kf": (s["state"], slot, s["prev_Tcw"], s["cur"], cal, cfg),
            "build_local_points_cache": (s["state"], slot, cfg),
            "track_local_map": (s["state"], s["Tcw"], s["cur"], s["frame_mp"], s["pts"], cal,
                                cfg),
            "insert_keyframe_jit": (s["state"], s["cur"], s["Tcw"], s["frame_mp"], cal, cfg,
                                    s["fid"]),
            "track_frame_fused": (s["state"], s["prev"], s["prev_Tcw"], s["prev_mp"],
                                  s["velocity"], s["tstate"], s["pts"], s["cur"], cal, cfg,
                                  s["fid"]),
        }[name]

    # the second call anchors on the first keyframe: a map that gained no
    # keyframe between the snapshots gives the same local points for one slot
    assert snaps[0]["slot"] > 0
    out = {name: (getattr(tracking, name), args(name, snaps[0], snaps[0]["slot"]),
                  args(name, snaps[1], 0))
           for name in GRAPHED_NAMES if name not in ("build_frame", "build_frame_stereo")}
    out["build_frame"] = (frame.build_frame, args("build_frame", snaps[0], 0),
                          args("build_frame", snaps[1], 0))
    out["build_frame_stereo"] = (frame.build_frame_stereo, pairs[0], pairs[1])
    return out


def _hold_replays(name, fn, args_a, args_b, close=None):
    """`fn` (graphed) on two inputs of one signature: each replay is the
    same bits as the body called eagerly (`graphs.eager()`), or, where a
    check is given (the pose graph and the global BA, whose replays were
    held to tolerances when they summed with atomics), `close(args, out,
    eager)` holds (a pass flag and a reading; the reading of two eager calls
    is printed beside it); the second replay leaves the first one's outputs
    intact, both go through one entry, and each replay adds its capture's
    launches to the counts and nothing more."""
    from multi_orb_slam_tpu_torch.utils import graphs

    counts = dict(kernels.LAUNCHES)
    with graphs.eager():
        eager_a, eager_b = fn(*args_a), fn(*args_b)
        again_a = fn(*args_a) if close is not None else eager_a
    kernels.LAUNCHES.update(counts)
    out_a = fn(*args_a)              # captured on first use
    kept = graphs.clone(out_a)
    entry = fn.entry(*args_a)
    assert fn.entry(*args_b) is entry and entry.graph is not None
    kernels.reset_launch_counts()
    out_b = fn(*args_b)
    assert kernels.LAUNCHES == {k: entry.graph_launches.get(k, 0) for k in kernels.LAUNCHES}
    for args, a, b in ((args_a, out_a, eager_a), (args_b, out_b, eager_b), (None, out_a, kept)):
        if close is None or args is None:
            ta, tb = graphs.tensors(a), graphs.tensors(b)
            assert len(ta) == len(tb) > 0
            for k, (x, y) in enumerate(zip(ta, tb)):
                assert torch.equal(x, y), (name, k)
        else:
            ok, reading = close(args, a, b)
            assert ok, (name, reading)
    assert any(not torch.equal(x, y) for x, y in zip(graphs.tensors(out_a),
                                                     graphs.tensors(out_b)))
    held = ("the eager bits" if close is None else
            f"the eager call within {close(args_a, out_a, eager_a)[1]} (two eager calls "
            f"{close(args_a, again_a, eager_a)[1]})")
    print(f"{name}: replays {held}, warm-up {entry.warmup_ms:.1f} ms, capture "
          f"{entry.capture_ms:.1f} ms, kernels in the graph {entry.graph_launches}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAPHED_NAMES)
def test_cuda_graphed_replays_are_the_eager_calls(graph_cases, name):
    """Each graphed function of the tracking path on two inputs of one
    signature (other frames, slots and frame ids): `_hold_replays`, to the
    bit."""
    _hold_replays(name, *graph_cases[name])


def _orbit(n):
    """The bench's orbit scene (640x480, the dual ~90-degree rig) and its
    configuration: (cfg, calib, frames on the card, poses)."""
    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.geometry import camera as cam_mod, se3
    from multi_orb_slam_tpu_torch.io import synthetic

    T_rc1 = torch.eye(4)
    T_rc1[:3, :3] = se3.so3_exp(torch.tensor([0.0, np.pi / 2, 0.0]))
    T_rc1[:3, 3] = torch.tensor([0.161, 0.004, -0.071])
    calib = cam_mod.CameraParams(
        K=torch.tensor([[520.9, 521.0, 320.0, 240.0]] * 2), dist=torch.zeros((2, 5)),
        T_rc=torch.stack([torch.eye(4), T_rc1]), bf=torch.tensor(40.0), width=640, height=480)
    cfg = SlamConfig(n_cams=2, width=640, height=480, orb=orb.ORBConfig(n_features=1024))
    seq = synthetic.make_sequence(n_frames=n, K=calib.K[0].numpy(), T_rc=calib.T_rc.numpy(),
                                  height=480, width=640, n_points=4000)
    frames = [(torch.from_numpy(np.asarray(g, np.float32)).cuda(),
               torch.from_numpy(np.asarray(d, np.float32)).cuda())
              for g, d in zip(seq.grays, seq.depths)]
    return cfg, calib, frames


@pytest.mark.cuda
@pytest.mark.parametrize("pipelined", [False, True])
def test_cuda_system_on_graphs_is_the_eager_system(pipelined):
    """The orbit's first 20 frames through `System(DUAL_RGBD)` (mapping and
    loop stage on), once on graphs and once under `graphs.eager()`: the same
    keyframes and the same camera centres, to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import contextlib

    from multi_orb_slam_tpu_torch import system
    from multi_orb_slam_tpu_torch.utils import graphs

    cfg, calib, frames = _orbit(20)
    runs = {}
    for mode in ("eager", "graphs"):
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            slam = system.System(sensor=system.Sensor.DUAL_RGBD, calib=calib, cfg=cfg,
                                 pipelined=pipelined, pipeline_depth=3 if pipelined else 1)
            for g, d in frames:
                slam.track_rgbd(g[0], d[0], g[1], d[1])
            traj = slam.tracker.absolute_trajectory()
        st = slam.map
        kfs = sorted(int(f) for f, v in zip(st.kf_frame_id.tolist(), st.kf_valid.tolist()) if v)
        centres = np.stack([np.linalg.inv(T)[:3, 3] for _, _, T, _ in traj])
        runs[mode] = (kfs, centres, [lost for *_, lost in traj])
    assert runs["graphs"][0] == runs["eager"][0] and len(runs["eager"][0]) >= 2
    assert not any(runs["graphs"][2])
    np.testing.assert_array_equal(runs["graphs"][1], runs["eager"][1])
    print(f"System(pipelined={pipelined}) orbit-20: keyframes {runs['graphs'][0]}, centres "
          f"the eager run's")


# ---------------------------------------------------------------------------
# the loop stage's graphed functions on the loop circuit
# ---------------------------------------------------------------------------

LOOP_POSE_TOL = 1e-4       # keyframe poses after the pose graph, graphs against eager
GBA_POSE_TOL = 1e-3        # after the global BA, as test_cuda_global_ba_matches_cpu
GBA_INFO_FLOOR = 10.0      # m^-2, GBA_MAHALANOBIS: as the distributed BA's points above
GBA_MAHALANOBIS = 0.1


def _gba_points_apart(arrays, Tcw_ref, pos_ref, pos):
    """(the largest sqrt(dp^T H_pp dp) over the valid points, the largest
    |dp| over those whose smallest H_pp eigenvalue is >= GBA_INFO_FLOOR):
    the points of a global BA solution against a reference one's, H_pp the
    problem's (`global_ba.map_point_information`) at the reference."""
    from multi_orb_slam_tpu_torch.optim import global_ba

    H = global_ba.map_point_information(*arrays, Tcw_ref, pos_ref)
    valid = arrays[0][6]
    dp, Hv = (pos - pos_ref)[valid].double(), H[valid].double()
    maha = torch.sqrt(torch.clamp(torch.einsum("ni,nij,nj->n", dp, Hv, dp), min=0.0))
    held = torch.linalg.eigvalsh(Hv)[:, 0] >= GBA_INFO_FLOOR
    return float(maha.max()), float(dp[held].abs().max()) if bool(held.any()) else 0.0


def _poses_close(args, out, ref):
    d = float((out - ref).abs().max())
    return d <= LOOP_POSE_TOL, f"{d:.3e} (tolerance {LOOP_POSE_TOL:.0e})"


def _gba_close(args, out, ref):
    """The global BA's poses within GBA_POSE_TOL and its points in their
    information metric (a point that one observation holds slides along its
    ray with any rounding)."""
    d = float((out[0] - ref[0]).abs().max())
    maha, held = _gba_points_apart(args[:2], ref[0], ref[1], out[1])
    ok = d <= GBA_POSE_TOL and maha <= GBA_MAHALANOBIS and held <= 1e-3
    return ok, f"poses {d:.3e}, points {maha:.4f} sigma, well-held points {held:.3e} m"


LOOP_GRAPHED = {   # name: (module path, check: None = bit-equal)
    "word_match_stage": ("loop.loop_closing", None),
    "solve_sim3": ("loop.sim3_solver", None),
    "search_by_sim3": ("loop.sim3_solver", None),
    "optimize_sim3": ("optim.sim3_opt", None),
    "guided_count_stage": ("loop.loop_closing", None),
    "optimize_essential_graph": ("optim.pose_graph", _poses_close),
    "run_global_ba_arrays": ("optim.global_ba", _gba_close),
    "merge_gba": ("loop.loop_closing", None),
    "fuse_into_kfs": ("mapping.fusion", None),
}


def _loop_circuit_system():
    """The loop circuit (`synthetic.loop_circuit`, the rig of `bench.py`) and
    a `System(DUAL_RGBD)` on the card with loop closing and global BA, its
    vocabulary trained from camera 0 of every 8th frame."""
    from multi_orb_slam_tpu_torch import system
    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.geometry import camera as cam_mod, se3
    from multi_orb_slam_tpu_torch.io import synthetic
    from multi_orb_slam_tpu_torch.placerec import database, vocabulary

    T_rc1 = torch.eye(4)
    T_rc1[:3, :3] = se3.so3_exp(torch.tensor([0.0, np.pi / 2, 0.0]))
    T_rc1[:3, 3] = torch.tensor([0.161, 0.004, -0.071])
    K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
    calib = cam_mod.CameraParams(
        K=torch.from_numpy(K).repeat(2, 1), dist=torch.zeros((2, 5)),
        T_rc=torch.stack([torch.eye(4), T_rc1]), bf=torch.tensor(20.0), width=320, height=240)
    cfg = SlamConfig(n_cams=2, max_feat=512, width=320, height=240, max_frames_kf=12,
                     th_depth=4.0, local_cap=1024, ba_local_cap=2048,
                     orb=orb.ORBConfig(n_features=512))
    frames, _ = synthetic.loop_circuit(K, calib.T_rc.numpy())
    frames = [(torch.from_numpy(g).cuda(), torch.from_numpy(d).cuda()) for g, d in frames]
    feats = [orb.extract_orb(frames[i][0][0], cfg.orb) for i in range(0, len(frames), 8)]
    voc = vocabulary.build_vocabulary(
        np.concatenate([f.desc[f.valid].cpu().numpy() for f in feats]), k=10, depth=4, iters=3)
    slam = system.System(sensor=system.Sensor.DUAL_RGBD, calib=calib, cfg=cfg)
    slam.loop_closer.voc = voc
    slam.loop_closer.db = database.make_empty_db(cfg.max_kf, voc.n_words)
    return slam, frames


@pytest.fixture(scope="module")
def loop_run():
    """The loop circuit on graphs up to the keyframe that merges the first
    loop's global BA: the arguments of the first call of each of the loop's
    graphed functions (copies), and the loop keyframe's `_compute_sim3` and
    `_correct_loop` inputs with the loop pairs from before it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import importlib
    import inspect

    from multi_orb_slam_tpu_torch.utils import graphs

    slam, frames = _loop_circuit_system()
    lc = slam.loop_closer
    calls, stash, patched = {}, {}, []
    for name, (mod, _) in LOOP_GRAPHED.items():
        module = importlib.import_module(f"multi_orb_slam_tpu_torch.{mod}")
        fn = getattr(module, name)

        def record(*args, _fn=fn, _name=name, **kwargs):
            bound = inspect.signature(_fn).bind(*args, **kwargs)
            calls.setdefault(_name, (_fn, graphs.clone(tuple(bound.args))))
            return _fn(*args, **kwargs)

        patched.append((module, name, fn))
        setattr(module, name, record)
    compute, correct = lc._compute_sim3, lc._correct_loop

    def compute_rec(state, kf_a, candidates):
        out = compute(state, kf_a, candidates)
        if out is not None and "compute" not in stash:
            stash["compute"] = (graphs.clone(state), kf_a, list(candidates))
        return out

    def correct_rec(state, kf_a, kf_b, g_ab):
        if "correct" not in stash:
            stash["correct"] = (graphs.clone(state), kf_a, kf_b, g_ab.clone())
            stash["loop_pairs"] = list(lc.loop_pairs)
        return correct(state, kf_a, kf_b, g_ab)

    lc._compute_sim3, lc._correct_loop = compute_rec, correct_rec
    try:
        for i, (g, d) in enumerate(frames):
            slam.track_rgbd(g[0], d[0], g[1], d[1], timestamp=i / 30.0)
            if lc.n_gba_merged:
                break
    finally:
        for module, name, fn in patched:
            setattr(module, name, fn)
    assert lc.n_gba_merged == 1 and set(calls) == set(LOOP_GRAPHED), (i, set(calls))
    return dict(calls=calls, stash=stash, calib=slam.calib, cfg=slam.cfg, voc=lc.voc)


def _perturbed_loop_args(name, args):
    """Other inputs of one signature: a moved Sim3, hypothesis points,
    starting poses or points, or GBA result."""
    from multi_orb_slam_tpu_torch.geometry import sim3

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    a = list(args)

    def moved(g, size):
        xi = torch.zeros(g.shape[:-1] + (7,), device="cuda")
        xi[..., :6] = size * torch.randn(g.shape[:-1] + (6,), generator=gen, device="cuda")
        return sim3.compose(sim3.exp(xi), g)

    if name == "word_match_stage":          # another keyframe pair
        a[5] = a[5] + 1 if a[5] + 1 != a[4] else a[5] + 2
    elif name == "solve_sim3":
        a[2] = a[2] + 0.01 * torch.randn(a[2].shape, generator=gen, device="cuda")
    elif name in ("search_by_sim3", "guided_count_stage"):
        a[3] = moved(a[3], 0.2)
    elif name == "optimize_sim3":
        a[0] = moved(a[0], 0.02)
    elif name == "optimize_essential_graph":
        a[0] = torch.where(a[1][:, None], moved(a[0], 0.01), a[0])
    elif name == "fuse_into_kfs":           # every other loop point left out
        mask = a[1].clone()
        mask[torch.nonzero(mask)[::2, 0]] = False
        a[1] = mask
    elif name == "run_global_ba_arrays":
        st = list(a[0])
        st[5] = st[5] + 0.01 * torch.randn(st[5].shape, generator=gen, device="cuda")
        a[0] = tuple(st)
    else:                                    # merge_gba
        a[2] = a[2] + 0.01
    return tuple(a)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LOOP_GRAPHED))
def test_cuda_loop_graphed_replays_are_the_eager_calls(loop_run, name):
    """Each of the loop's graphed functions on the arguments of its first
    call in the circuit and on moved ones (`_perturbed_loop_args`): each
    replay is the eager call's bits, or within the stated tolerance (the
    pose graph's poses to 1e-4; the global BA's poses to 1e-3 and its points
    in their information metric, `_gba_close`), with two eager calls' spread
    printed beside it."""
    fn, args = loop_run["calls"][name]
    _hold_replays(name, fn, args, _perturbed_loop_args(name, args), LOOP_GRAPHED[name][1])


@pytest.mark.cuda
def test_cuda_essential_graph_gives_the_same_bits_twice(loop_run):
    """`optimize_essential_graph` on the arguments of its call at the loop
    keyframe: two replays the same bits, and two eager calls (its sums add
    in one fixed order, `optim/segments.py`)."""
    from multi_orb_slam_tpu_torch.optim import pose_graph
    from multi_orb_slam_tpu_torch.utils import graphs

    _, args = loop_run["calls"]["optimize_essential_graph"]
    runs = [pose_graph.optimize_essential_graph(*args) for _ in range(2)]
    with graphs.eager():
        runs += [pose_graph.optimize_essential_graph(*args) for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[2], runs[3])
    print(f"essential graph on the card: two replays and two eager calls each the same bits; "
          f"replay against eager {float((runs[0] - runs[2]).abs().max()):.3e}")


@pytest.mark.cuda
def test_cuda_loop_keyframe_on_graphs_is_the_eager_run(loop_run):
    """The loop keyframe's `_compute_sim3` and `_correct_loop` (global BA
    dispatched) and the merge of that BA, on graphs and under
    `graphs.eager()`, each on a fresh `LoopCloser`: the same loop keyframe,
    total and Sim3 bits, the same fused observations, the corrected poses
    within LOOP_POSE_TOL, the merged map's poses and points as
    `_gba_close` holds a global BA's."""
    import contextlib

    from multi_orb_slam_tpu_torch.loop import loop_closing
    from multi_orb_slam_tpu_torch.optim import global_ba
    from multi_orb_slam_tpu_torch.utils import graphs

    stash = loop_run["stash"]
    runs = {}
    for mode in ("graphs", "eager"):
        lc = loop_closing.LoopCloser(loop_run["calib"], loop_run["cfg"])
        lc.voc, lc.loop_pairs = loop_run["voc"], list(stash["loop_pairs"])
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            found = lc._compute_sim3(*stash["compute"])
            corrected = lc._correct_loop(*stash["correct"])
            merged = lc.merge_pending_gba(corrected)
        runs[mode] = (found, corrected, merged)
    (fg, cg, mg), (fe, ce, me) = runs["graphs"], runs["eager"]
    assert fg is not None and fg[0] == fe[0] and fg[2] == fe[2] and torch.equal(fg[1], fe[1])
    assert torch.equal(cg.kf_mp, ce.kf_mp) and torch.equal(cg.mp_valid, ce.mp_valid)
    d_pose = float((cg.kf_Tcw - ce.kf_Tcw).abs().max())
    arrays = global_ba.global_ba_arrays(me, loop_run["calib"], loop_run["cfg"])[:2]
    ok, reading = _gba_close(arrays, (mg.kf_Tcw, mg.mp_pos), (me.kf_Tcw, me.mp_pos))
    print(f"loop keyframe: kf_b {fg[0]}, total {fg[2]}; graphs against eager: poses after the "
          f"pose graph {d_pose:.3e}; after the merge {reading}")
    assert d_pose <= LOOP_POSE_TOL and ok, (d_pose, reading)


# ---------------------------------------------------------------------------
# the capacity overflow run (tests/test_capacity.py) on graphs
# ---------------------------------------------------------------------------

OVERFLOW_CFG = dict(n_cams=1, max_feat=512, max_kf=24, max_mp=768, local_cap=512,
                    ba_local_cap=768, max_frames_kf=5, width=320, height=240)


@pytest.mark.cuda
def test_cuda_overflow_run_on_graphs_is_the_eager_run():
    """`tests/test_capacity.py`'s overflow run (25 frames, one 320x240 camera,
    a map ~2x too small, the mapping stage as the keyframe callback) through
    `Tracker` on graphs and under `graphs.eager()`: the same per-frame
    states and `n_mp`, the same `n_alloc_failed`, the final positions to the
    bit; then the final map filled over 90% through one mapping stage on
    graphs and eagerly: relieved to >= M / 10 free slots, every field the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import contextlib

    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.geometry import camera as cam_mod
    from multi_orb_slam_tpu_torch.io import synthetic
    from multi_orb_slam_tpu_torch.mapping import local_mapping
    from multi_orb_slam_tpu_torch.utils import graphs

    K = np.array([520.9, 521.0, 160.0, 120.0], np.float32)
    seq = synthetic.make_sequence(n_frames=25, K=K, T_rc=np.eye(4, dtype=np.float32)[None],
                                  height=240, width=320, seed=2, n_points=4000)
    frames = [(torch.from_numpy(np.asarray(g)).cuda(), torch.from_numpy(np.asarray(d)).cuda())
              for g, d in zip(seq.grays, seq.depths)]
    cfg = SlamConfig(**OVERFLOW_CFG, orb=orb.ORBConfig(n_features=512))
    calib = cam_mod.CameraParams(K=torch.from_numpy(K)[None].cuda(),
                                 dist=torch.zeros((1, 5), device="cuda"),
                                 T_rc=torch.eye(4, device="cuda")[None],
                                 bf=torch.tensor(40.0, device="cuda"), width=320, height=240)
    runs = {}
    for mode in ("eager", "graphs"):
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            tr = tracking.Tracker(calib, cfg)
            tr.kf_inserted_cb = (lambda tr: lambda s: local_mapping.run_mapping_stage(
                tr.map, s, tr.frame_id, calib, cfg))(tr)
            states, n_mp = [], []
            for g, d in frames:
                tr.process(g, d)
                states.append(int(tr.state))
                n_mp.append(int(tr.map.n_mp))
        runs[mode] = (states, n_mp, tr.map, tr.frame_id)
    (sg, ng, mg, fid), (se, ne, me, _) = runs["graphs"], runs["eager"]
    assert sg == se and ng == ne and int(mg.n_alloc_failed) == int(me.n_alloc_failed)
    assert torch.equal(mg.mp_pos, me.mp_pos)
    assert sum(s == 1 for s in sg) >= 18 and int(mg.n_mp) <= cfg.max_mp
    # capacity relief inside the mapping stage's graph
    M = cfg.max_mp
    n_fill = int(0.90 * M) + 20 - int(mg.n_mp)
    free = torch.nonzero(~mg.mp_valid[:M - 1])[:n_fill, 0]
    slots = free.to(torch.int32)
    full = mg._replace(
        mp_valid=mg.mp_valid.index_put((free,), torch.ones_like(free, dtype=torch.bool)),
        mp_visible=mg.mp_visible.index_put((free,), torch.full_like(slots, 40)),
        mp_found=mg.mp_found.index_put((free,), 10 + slots % 30),
        mp_first_frame=mg.mp_first_frame.index_put((free,), torch.full_like(slots, -1)),
        n_mp=mg.n_mp + free.numel())
    kf = int(torch.argmax(torch.where(full.kf_valid, full.kf_frame_id, -1)))
    out = {}
    for mode in ("eager", "graphs"):
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            out[mode] = local_mapping.run_mapping_stage(graphs.clone(full), kf, fid, calib, cfg)
    assert M - int(out["graphs"].n_mp) >= max(M // 10, 64)
    for name, a, b in zip(full._fields, out["graphs"], out["eager"]):
        assert torch.equal(a, b), name
    print(f"overflow run: states {''.join(map(str, sg))}, n_mp {int(mg.n_mp)}, n_alloc_failed "
          f"{int(mg.n_alloc_failed)}; relief {M - int(full.n_mp)} -> "
          f"{M - int(out['graphs'].n_mp)} free slots, graphs the eager bits")


# ---------------------------------------------------------------------------
# the stepwise mapping stage, the two-view initializer and the reference
# extractor on graphs
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("off", ["do_triangulate", "do_fuse", "do_ba", "do_cull"])
def test_cuda_stepwise_mapping_stage_on_graphs_is_the_eager_stage(off):
    """The small scene tracked on the card with the mapping stage; the map
    that went into its last stage through `run_mapping_stage` with one
    stage switched off (the stepwise path: each stage a replay of its own
    entry), on graphs and under `graphs.eager()`: every field the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import contextlib

    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.mapping import local_mapping
    from multi_orb_slam_tpu_torch.utils import graphs

    cfg, calib, seq = _small_scene()
    tracker = tracking.Tracker(calib, cfg, device="cuda")
    snaps = []

    def cb(k):
        snaps.append((graphs.clone(tracker.map), k, tracker.frame_id))
        return local_mapping.run_mapping_stage(tracker.map, k, tracker.frame_id,
                                               tracker.calib, cfg)

    tracker.kf_inserted_cb = cb
    for g, d in zip(seq.grays, seq.depths):
        tracker.process(g, d)
    st, k, fid = snaps[-1]
    assert int(st.n_kf) > 2
    out = {}
    for mode in ("eager", "graphs", "again"):
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            out[mode] = local_mapping.run_mapping_stage(graphs.clone(st), k, fid, tracker.calib,
                                                        cfg, **{off: False})
    for mode in ("graphs", "again"):
        for name, a, b in zip(st._fields, out[mode], out["eager"]):
            assert torch.equal(a, b), (off, mode, name)
    print(f"stepwise mapping stage with {off}=False: graphs the eager bits")


def _two_view_problem(planar, n=300, seed=0):
    """`tests/test_mono_init.py`'s two-view problems (K 500/500/320/240, a
    general scene or a rough tilted plane, 0.3 px noise, 10% outliers),
    with the port's own rotation: (uv1, uv2, mask, K) on the card."""
    from multi_orb_slam_tpu_torch.geometry import se3

    K = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
    rng = np.random.RandomState(seed)
    X = rng.uniform([-2, -1.5, 4.0], [2, 1.5, 8.0], (n, 3)).astype(np.float32)
    if planar:
        X[:, 2] = 6.0 + 0.3 * X[:, 0] + 0.1 * X[:, 1] + rng.randn(n).astype(np.float32) * 0.05
    R = se3.so3_exp(torch.tensor([0.02, 0.12, -0.03])).numpy()
    t = np.array([0.4, 0.05, 0.1], np.float32) / np.linalg.norm([0.4, 0.05, 0.1])

    def proj(R_, t_):
        Xc = X @ R_.T + t_
        return (np.stack([K[0] * Xc[:, 0] / Xc[:, 2] + K[2], K[1] * Xc[:, 1] / Xc[:, 2] + K[3]],
                         -1), Xc[:, 2])

    uv1, z1 = proj(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    uv2, z2 = proj(R, t.astype(np.float32))
    uv1 += rng.randn(n, 2) * 0.3
    uv2 += rng.randn(n, 2) * 0.3
    out = rng.choice(n, n // 10, replace=False)
    uv2[out] += rng.uniform(20, 80, (len(out), 2)) * rng.choice([-1, 1], (len(out), 2))
    c = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to("cuda", dt)  # noqa: E731
    return c(uv1), c(uv2), c((z1 > 0) & (z2 > 0), torch.bool), c(K)


@pytest.mark.cuda
def test_cuda_solve_two_view_replays_are_the_eager_calls():
    """`solve_two_view` on a general and a planar scene of one signature
    (300 correspondences, 256 hypotheses drawn on the CPU): each replay the
    eager call's bits (`_hold_replays`), the general scene through the
    fundamental and the plane through the homography, and the card's
    decisions and R those of the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch.frontend import initializer

    args = []
    for planar, seed in ((False, 0), (True, 1)):
        uv1, uv2, mask, K = _two_view_problem(planar)
        idx_h, idx_f = initializer.sample_hypotheses(mask.cpu(), 256,
                                                     torch.Generator().manual_seed(seed))
        args.append((uv1, uv2, mask, idx_h.cuda(), idx_f.cuda(), K))
    _hold_replays("solve_two_view", initializer.solve_two_view, args[0], args[1])
    for planar, a in zip((False, True), args):
        card = initializer.solve_two_view(*a)
        cpu = initializer.solve_two_view(*(x.cpu() for x in a))
        assert bool(card.ok) and bool(card.used_homography) == planar
        assert bool(cpu.ok) == bool(card.ok)
        assert bool(cpu.used_homography) == bool(card.used_homography)
        assert float((card.R.cpu() - cpu.R).abs().max()) < 1e-4


@pytest.mark.cuda
def test_cuda_extract_orb_reference_replays_are_the_eager_calls():
    """The reference extractor on two rendered 320x240 images of one
    signature: each replay the eager call's bits; the card's keypoints those
    of the CPU run on >= 99% of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, calib, seq = _small_scene()
    imgs = [torch.from_numpy(np.asarray(seq.grays[i][0], np.float32)).cuda() for i in (0, 6)]
    fn = orb.extract_orb_reference
    _hold_replays("extract_orb_reference", fn, (imgs[0], cfg.orb), (imgs[1], cfg.orb))
    card, cpu = fn(imgs[0], cfg.orb), fn(imgs[0].cpu(), cfg.orb)

    def keys(f):
        xy, lvl, ok = f.xy.cpu().numpy(), f.level.cpu().numpy(), f.valid.cpu().numpy()
        return set(map(tuple, np.concatenate([xy, lvl[:, None]], 1)[ok].tolist()))

    kc, kg = keys(cpu), keys(card)
    assert len(kc & kg) >= 0.99 * len(kc) > 100


# ---------------------------------------------------------------------------
# the tracer's device events and host waits
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_span_device_ms_is_the_profilers_kernel_time():
    """A span around 12 float32 4096 x 4096 matmuls: its device ms (its two
    events) within 10% of the kernels' device time the profiler saw."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multi_orb_slam_tpu_torch.utils import metrics

    a = torch.randn(4096, 4096, device="cuda")
    b = torch.randn(4096, 4096, device="cuda")
    for _ in range(3):
        a @ b
    torch.cuda.synchronize()
    metrics.clear()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with metrics.span("test/matmuls", "cuda"):
            for _ in range(12):
                a @ b
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    kernel_ms = sum(e.end_ns() - e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.device_type() != cpu and not e.is_user_annotation()) / 1e6
    (s,) = [s for s in metrics.spans() if s.name == "test/matmuls"]
    metrics.clear()
    print(f"span device {s.device_ms():.3f} ms, host {s.host_ms:.3f} ms; kernels {kernel_ms:.3f} ms")
    assert kernel_ms > 10.0
    assert abs(s.device_ms() - kernel_ms) <= 0.10 * kernel_ms


# waits the sync-debug mode does not count: a synchronise of the device
# around a graph's capture, and of an event that had not completed
NOT_WARNED = ("wait/capture", "wait/pipeline_scalars", "wait/image_staging")


@pytest.mark.cuda
@pytest.mark.parametrize("sensor", ["rgbd", "dual"])
def test_cuda_wait_spans_are_the_host_syncs(sensor):
    """40 orbit frames through `System`, fed host arrays as the drivers and
    the benchmark feed it, mapping and loop stage on (a vocabulary trained
    online from the first keyframes): `rgbd` the rig's camera 0 on the
    stepwise route, `dual` the pipelined rig.  Then the frames in reverse,
    each under `set_sync_debug_mode("warn")` with the tracer on.  Every
    warning falls inside a `wait/*` span, and a frame has at least as many
    warnings as `wait/*` spans of waits the mode counts and at most as many
    as all its `wait/*` spans; a frame that differs is named with its sites."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import warnings

    from multi_orb_slam_tpu_torch import system
    from multi_orb_slam_tpu_torch.loop import loop_closing
    from multi_orb_slam_tpu_torch.utils import metrics

    cfg, calib, frames = _orbit(40)
    cfg = cfg._replace(max_frames_kf=10)     # a keyframe in the reversed frames too
    n = 2 if sensor == "dual" else 1
    if n == 1:
        cfg = cfg._replace(n_cams=1)
        calib = calib._replace(K=calib.K[:1], dist=calib.dist[:1], T_rc=calib.T_rc[:1])
    frames = [[x for c in range(n) for x in (g[c].cpu().numpy(), d[c].cpu().numpy())]
              for g, d in frames]
    slam = system.System(sensor=system.Sensor.DUAL_RGBD if n == 2 else system.Sensor.RGBD,
                         calib=calib, cfg=cfg, pipelined=n == 2, pipeline_depth=3 if n == 2 else 1)
    slam.loop_closer = loop_closing.LoopCloser(slam.calib, cfg, vocab_min_descs=1500)
    for ims in frames:
        slam.track_rgbd(*ims)
    sites, problems, waits_seen = [], [], 0

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            waits = [s.name for s in getattr(metrics._local, "stack", []) if s.name.startswith("wait/")]
            sites.append((waits[-1] if waits else None, f"{filename}:{lineno}"))

    metrics.clear()
    kf0 = slam.metrics.counters["keyframes_inserted"]
    with metrics.tracing(), warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        for ims in frames[::-1]:
            sites.clear()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                slam.track_rgbd(*ims)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            root = [s for s in metrics.spans() if s.name == "system/track_rgbd"][-1]
            waits = [s.name for s in metrics.spans()
                     if s.name.startswith("wait/") and s.frame == root.frame]
            counted = [w for w in waits if w not in NOT_WARNED]
            waits_seen += len(waits)
            if any(w is None for w, _ in sites) or not len(counted) <= len(sites) <= len(waits):
                problems.append({"frame": root.frame, "waits": waits, "syncs": sites[:]})
    metrics.clear()
    keyframes = slam.metrics.counters["keyframes_inserted"] - kf0
    print(f"orbit-40 {sensor}, reversed: {waits_seen / len(frames):.2f} waits a frame, "
          f"{keyframes} keyframes, vocabulary {slam.loop_closer.voc is not None}")
    assert slam.get_tracking_state() == 1
    assert slam.loop_closer.voc is not None and keyframes >= 1
    assert not problems, problems
