"""New map-point triangulation between covisible keyframes.

Counterpart of `multi_orb_slam_tpu/mapping/triangulation.py`
(CreateNewMapPoints + SearchForTriangulation):

- candidate pairs: unmatched features of the new keyframe against a
  covisible neighbour, same camera only, gated by the epipolar distance in
  the second view
- rays triangulated by the closed-form two-ray midpoint
- acceptance: positive depth in both views, reprojection chi2 under
  5.991 * sigma2, and scale consistency of the two observation distances

Pure tensor code: a dense [F, F] epipolar gate and Hamming matrix per
camera, no hand-written kernel (the reference has none here either).
Keyframe slots may be Python ints or 0-dim / 1-element tensors
(`map_state.slot_index`).

Scatter rule where the reference leaves the winner of a repeated index
open: an observation written into the neighbour's row wins over the
no-op writes that share its dump column (F-1).
"""

from __future__ import annotations

import torch

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..ops import hamming
from ..utils import graphs
from . import map_state as ms


def _fundamental(K1, K2, T12):
    """F such that line2 = F @ x1h, with T21 = T12^-1 (x2^T F x1 = 0)."""
    T21 = se3.inverse(T12)
    E = se3.hat(T21[:3, 3]) @ T21[:3, :3]

    def k_inv(K):
        one, zero = torch.ones_like(K[0]), torch.zeros_like(K[0])
        return torch.stack([
            torch.stack([1.0 / K[0], zero, -K[2] / K[0]]),
            torch.stack([zero, 1.0 / K[1], -K[3] / K[1]]),
            torch.stack([zero, zero, one])])

    return k_inv(K2).T @ E @ k_inv(K1)


def _ray_midpoint(o1, d1, o2, d2):
    """Midpoint of the common perpendicular of rays o + s*d: (X, s1, s2)."""
    r = o2 - o1
    a = torch.sum(d1 * d1, -1)
    b = torch.sum(d1 * d2, -1)
    c = torch.sum(d2 * d2, -1)
    d = torch.sum(r * d1, -1)
    e = torch.sum(r * d2, -1)
    den = a * c - b * b
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12), den)
    s1 = (c * d - b * e) / den
    s2 = (b * d - a * e) / den
    X1 = o1 + s1[..., None] * d1
    X2 = o2 + s2[..., None] * d2
    return 0.5 * (X1 + X2), s1, s2


def triangulate_pair(state: ms.MapState, kf_a, kf_b, cfg: SlamConfig,
                     calib: cam_mod.CameraParams):
    """Create new map points from unmatched feature pairs of two keyframes.

    Returns (state, number of points created [] int32)."""
    C, F, M = cfg.n_cams, cfg.max_feat, cfg.max_mp
    dev = state.mp_pos.device
    f32 = torch.float32
    ka, kb = ms.slot_index(kf_a, dev), ms.slot_index(kf_b, dev)
    row = lambda x, k: x.index_select(0, k)[0]      # noqa: E731
    Ta, Tb = row(state.kf_Tcw, ka), row(state.kf_Tcw, kb)
    mp_a, mp_b = row(state.kf_mp, ka), row(state.kf_mp, kb)
    fv_a, fv_b = row(state.kf_feat_valid, ka), row(state.kf_feat_valid, kb)
    xy_a, xy_b = row(state.kf_xy_und, ka), row(state.kf_xy_und, kb)
    lvl_a, lvl_b = row(state.kf_level, ka), row(state.kf_level, kb)
    desc_a, desc_b = row(state.kf_desc, ka), row(state.kf_desc, kb)
    ones = torch.ones(F, dtype=f32, device=dev)
    feat = torch.arange(F, device=dev)

    all_pw, all_ok, all_fb = [], [], []
    for c in range(C):
        T1 = calib.T_rc[c] @ Ta  # world -> cam c of kf_a
        T2 = calib.T_rc[c] @ Tb
        K1 = calib.K[c]
        T_ab = T1 @ se3.inverse(T2)  # cam_b -> cam_a
        F12 = _fundamental(K1, K1, T_ab)

        free_a = fv_a[c] & (mp_a[c] < 0)
        free_b = fv_b[c] & (mp_b[c] < 0)
        xa, xb = xy_a[c], xy_b[c]
        xah = torch.cat([xa, ones[:, None]], -1)
        xbh = torch.cat([xb, ones[:, None]], -1)
        lines = xah @ F12.T                       # [F, 3] lines in view b
        num = torch.abs(lines @ xbh.T)            # [F, F]
        den = torch.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2 + 1e-12)[:, None]
        dist_epi = num / den
        sigma2_b = torch.pow(cfg.scale_factor, 2.0 * lvl_b[c].to(f32))
        epi_ok = dist_epi < 3.84 * torch.sqrt(sigma2_b)[None, :]

        cand = free_a[:, None] & free_b[None, :] & epi_ok
        d = hamming.pairwise_hamming(desc_a[c], desc_b[c])
        bi, bd, b2 = hamming.masked_argmin2(d, cand)
        ok = (bd <= hamming.TH_LOW) & (bd.to(f32) <= 0.9 * b2.to(f32))
        # mutual best for stability
        d_masked = torch.where(cand, d, torch.full_like(d, hamming.BIG))
        best_back = hamming.first_argmin(d_masked, dim=0)
        ok = ok & (best_back[bi] == feat)
        if cfg.tri_rotation_check:
            delta = row(state.kf_angle, ka)[c] - row(state.kf_angle, kb)[c][bi]
            ok = hamming.rotation_histogram_filter(delta, ok)

        # triangulate each a-feature with its matched b-feature
        fb = bi
        Twc1, Twc2 = se3.inverse(T1), se3.inverse(T2)
        o1, o2 = Twc1[:3, 3], Twc2[:3, 3]
        r1 = cam_mod.backproject(K1, xa, ones)    # unit-depth directions
        r2 = cam_mod.backproject(K1, xb[fb], ones)
        d1w = r1 @ Twc1[:3, :3].T
        d2w = r2 @ Twc2[:3, :3].T
        X, _, _ = _ray_midpoint(o1[None], d1w, o2[None], d2w)

        # parallax gate: rays must not be near-parallel
        cosp = torch.sum(d1w * d2w, -1) / torch.clamp(
            torch.linalg.norm(d1w, dim=-1) * torch.linalg.norm(d2w, dim=-1), min=1e-9)
        good_par = cosp < 0.9998

        # depth positivity + reprojection checks in both views
        Xc1 = se3.transform_points(T1, X)
        Xc2 = se3.transform_points(T2, X)
        z_ok = (Xc1[:, 2] > 0.05) & (Xc2[:, 2] > 0.05)
        uv1 = cam_mod.project(K1, Xc1)
        uv2 = cam_mod.project(K1, Xc2)
        s2a = torch.pow(cfg.scale_factor, 2.0 * lvl_a[c].to(f32))
        e1 = torch.sum((uv1 - xa) ** 2, -1)
        e2 = torch.sum((uv2 - xb[fb]) ** 2, -1)
        rp_ok = (e1 <= 5.991 * s2a) & (e2 <= 5.991 * sigma2_b[fb])

        # scale consistency
        d1n = torch.linalg.norm(X - o1[None], dim=-1)
        d2n = torch.linalg.norm(X - o2[None], dim=-1)
        ratio = d1n / torch.clamp(d2n, min=1e-9)
        ratio_octave = torch.pow(
            cfg.scale_factor, lvl_a[c].to(f32) - lvl_b[c][fb].to(f32))
        rf = cfg.scale_factor * 1.5
        sc_ok = (ratio < ratio_octave * rf) & (ratio > ratio_octave / rf)

        all_pw.append(X)
        all_ok.append(ok & good_par & z_ok & rp_ok & sc_ok)
        all_fb.append(fb)

    pw = torch.cat(all_pw)            # [C*F, 3]
    want = torch.cat(all_ok)          # [C*F]
    fb_all = torch.cat(all_fb)        # [C*F]

    slots = ms.allocate_mp_slots(state.mp_valid, want)
    created = slots >= 0
    n_created = created.sum(dtype=torch.int32)
    n_failed = (want & ~created).sum(dtype=torch.int32)
    cgrid = created.reshape(C, F)
    sgrid = slots.reshape(C, F)
    fbgrid = fb_all.reshape(C, F)

    # write observations into both keyframes: feature fb of kf_b gets the
    # new id (matched b-features were free, so the row held -1 there)
    neg = torch.full_like(sgrid, -1)
    new_b = neg.clone()
    new_b.scatter_reduce_(1, torch.where(cgrid, fbgrid, F - 1),
                          torch.where(cgrid, sgrid, neg), "amax", include_self=True)
    kf_mp = state.kf_mp.clone()
    kf_mp[ka] = torch.where(cgrid, sgrid, mp_a)[None]
    kf_mp[kb] = torch.where(new_b >= 0, new_b, mp_b)[None]

    # new point attributes; requests without a slot write slot M-1 back to
    # itself
    tgt = torch.where(created, slots, M - 1).long()
    put = created
    desc_flat = desc_a.reshape(-1, 8)
    po = pw - se3.camera_center(Ta)[None]
    distn = torch.linalg.norm(po, dim=-1)
    normal = po / torch.clamp(distn[:, None], min=1e-9)
    min_d, max_d = ms.scale_range_from_obs(
        distn, lvl_a.reshape(-1), cfg.scale_factor, cfg.n_levels)

    def put_at(dst, val):
        """dst.at[tgt].set(where(put, val, dst[tgt])); a Python `val` is
        filled in on the device"""
        old = dst[tgt]
        if isinstance(val, torch.Tensor):
            val = val.to(dst.dtype).expand_as(old)
        else:
            val = torch.full_like(old, val)
        out = dst.clone()
        out[tgt] = torch.where(put.reshape((-1,) + (1,) * (old.dim() - 1)), val, old)
        return out

    descbuf = state.mp_descbuf.clone()
    descbuf[tgt, 0] = torch.where(put[:, None], desc_flat, state.mp_descbuf[tgt, 0])
    new_state = state._replace(
        kf_mp=kf_mp,
        mp_pos=put_at(state.mp_pos, pw),
        mp_valid=put_at(state.mp_valid, True),
        mp_desc=put_at(state.mp_desc, desc_flat),
        mp_descbuf=descbuf,
        mp_descbuf_n=put_at(state.mp_descbuf_n, 1),
        mp_normal=put_at(state.mp_normal, normal),
        mp_min_dist=put_at(state.mp_min_dist, min_d),
        mp_max_dist=put_at(state.mp_max_dist, max_d),
        mp_first_kf=put_at(state.mp_first_kf, ka.to(torch.int32)),
        mp_first_frame=put_at(state.mp_first_frame, row(state.kf_frame_id, ka)),
        mp_visible=put_at(state.mp_visible, 1),
        mp_found=put_at(state.mp_found, 1),
        n_mp=state.n_mp + n_created,
        n_alloc_failed=state.n_alloc_failed + n_failed,
    )
    return new_state, n_created


@graphs.graphed(static_argnames=("cfg", "n_neighbors"))
def triangulate_new_points(state: ms.MapState, kf_slot,
                           calib: cam_mod.CameraParams, cfg: SlamConfig,
                           n_neighbors: int = 5):
    """Triangulate against the top covisible neighbours, one after another.

    The neighbour top-k stays on the device.  Empty neighbour ranks map to
    the reserved dummy keyframe slot K-1, whose features are never valid:
    a guaranteed no-op.  Returns (state, number of points created)."""
    K = state.kf_mp.shape[0]
    dev = state.mp_pos.device
    ks = ms.slot_index(kf_slot, dev)
    W = ms.covisibility(state)
    w, nbrs = hamming.top_k(W.index_select(0, ks)[0], n_neighbors)
    slots = torch.where(w > 0, nbrs, K - 1)
    total = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(n_neighbors):
        state, n = triangulate_pair(state, ks, slots[i], cfg, calib)
        total = total + n
    return state, total
