"""What decides `correct`: the program's outputs from the window, taken to
the host, then held against the plain references of `benchmark/reference/`
once the program's state is freed.

The numbers (each lower is better; a cell compares those its workload file
gives a limit, and a number that cannot be read counts as over its limit):

- `pose_ortho_max`: the largest departure of a returned pose's rotation
  from a rotation, max |R R^T - I| over the window's frames (every pose
  a rigid transform);
- `rpe_1s_mm`, `rpe_1s_mrad`: the returned poses against the ground truth
  the scene was rendered from: over every pair of the window's frames one
  second apart in one system's sequence (Camera.fps frames, both left OK),
  the median gap between the rig motion the returned poses give and the
  ground truth's, in translation and in rotation (a rotation gap that also
  counts a returned rotation that is no rotation);
- `pose_ate_mm`: the RMS distance of the returned poses' camera centres from
  the ground truth's after each system's best rigid alignment, over the
  window's frames left OK;
- `orb_angle_p50_mrad`, `orb_desc_bits_mean`, `orb_fast_fail_pct`: the
  window's ORB features (keyframes made in the window, drawn from the seed,
  and the last frame) against the reference extractor at the same
  keypoints: the median angle gap, the mean differing descriptor bits, the
  share of keypoints that fail the FAST test (fast_score and
  gather_patches feed all three).  The last frame is the last one the
  tracker was left OK by, with the features the tracker kept from it;
- `wall_p50_mm`: the median gap of the window's keyframes' map points from
  the room's walls (the mapping stage's local BA, the loop stage's
  corrections);
- `decode_max_abs`: the largest difference of a decoded TUM frame from the
  arrays written (the drivers' PNG decoding; exact, limit 0).

`ate_m` (the map system's keyframe-anchored trajectory after a rigid
alignment, over its window frames) is printed beside them.
"""

from __future__ import annotations

import numpy as np

from reference import images as ref_images, orb as ref_orb, poses as ref_poses, walls as ref_walls

def _np(t):
    return t.detach().cpu().numpy()


def collect(driver, recs: list, n_pass: int) -> dict:
    """Everything the checks need, on the host, before the program's state
    is freed."""
    out = {"recs": [{k: r[k] for k in ("frame", "fid", "sys", "ok", "pose")} for r in recs],
           "decoded": [(r["frame"], r["decoded"]) for r in recs if "decoded" in r]}
    if not recs:
        return out
    counts = {}
    for r in recs:
        counts[r["sys"]] = counts.get(r["sys"], 0) + 1
    done = [s for s, n in counts.items() if n == n_pass]
    s = done[-1] if done else recs[-1]["sys"]
    slam = driver.systems[s]
    st = slam.map
    fid_frame = {r["fid"]: r["frame"] for r in recs if r["sys"] == s}
    out["map"] = {k: _np(getattr(st, k)) for k in (
        "kf_Tcw", "kf_valid", "kf_frame_id", "kf_xy_und", "kf_level", "kf_angle", "kf_desc",
        "kf_feat_valid", "kf_mp", "mp_pos", "mp_valid")}
    out["fid_frame"] = fid_frame
    traj = slam.tracker.absolute_trajectory()
    out["traj"] = [(fid_frame[fid], np.asarray(T, np.float64)) for fid, _, T, lost in traj
                   if not lost and fid in fid_frame]
    if driver.last_ok is not None and driver.last_ok[1] is not None:
        f, fr = driver.last_ok
        out["last"] = (f, {k: _np(getattr(fr, k)) for k in ("xy", "level", "angle", "desc", "valid")})
    return out


def numbers(out: dict, sc, settings: dict, seed: int, orb_keyframes: int, span: int) -> dict:
    """Every number the checks can read from `out` (missing where there is
    nothing to read)."""
    res = {}
    recs = out["recs"]
    res["poses_not_finite"] = sum(1 for r in recs if not np.isfinite(r["pose"]).all())
    if recs:
        R = np.stack([r["pose"][:3, :3] for r in recs])
        gap = np.abs(R @ np.swapaxes(R, 1, 2) - np.eye(3)).max(axis=(1, 2))
        res["pose_ortho_max"] = float(np.max(np.where(np.isfinite(gap), gap, np.inf)))
    res.update(pose_numbers(recs, sc.poses_gt, span))
    if len(out.get("traj", [])) >= 10:
        frames = [f for f, _ in out["traj"]]
        res["ate_m"] = ref_poses.ate_rmse(np.stack([T for _, T in out["traj"]]),
                                          sc.poses_gt[frames])
    if "map" in out:
        res.update(_map_numbers(out, sc, settings, seed, orb_keyframes))
    if out["decoded"]:
        gaps = [ref_images.max_gap(g, d, sc.stored[0][f], sc.stored[1][f], sc.depth_factor)
                for f, (g, d) in out["decoded"]]
        res["decode_max_abs"] = float(max(gaps))
        res["decode_frames"] = len(gaps)
    return res


def pose_numbers(recs: list, poses_gt: np.ndarray, span: int) -> dict:
    """`rpe_1s_mm`, `rpe_1s_mrad` (with `rpe_1s_pairs`) and `pose_ate_mm`
    of the window's returned poses (missing where no pair or frame counts)."""
    res = {}
    good = [r for r in recs if r["ok"] and np.isfinite(r["pose"]).all()]
    by_fid = {(r["sys"], r["fid"]): r for r in good}
    pairs = [(by_fid[(r["sys"], r["fid"] - span)], r) for r in good
             if (r["sys"], r["fid"] - span) in by_fid]
    if pairs:
        est = np.stack([np.stack([a["pose"], b["pose"]]) for a, b in pairs])
        gt = np.stack([np.stack([poses_gt[a["frame"]], poses_gt[b["frame"]]]) for a, b in pairs])
        dt, dr = ref_poses.relative_errors(est, gt)
        res["rpe_1s_mm"] = float(np.median(dt) * 1e3)
        res["rpe_1s_mrad"] = float(np.median(dr) * 1e3)
        res["rpe_1s_pairs"] = len(pairs)
    sq, n = 0.0, 0
    for s in sorted({r["sys"] for r in good}):
        rs = [r for r in good if r["sys"] == s]
        if len(rs) >= 3:
            ate = ref_poses.ate_rmse(np.stack([r["pose"] for r in rs]),
                                     poses_gt[[r["frame"] for r in rs]])
            sq, n = sq + ate ** 2 * len(rs), n + len(rs)
    if n:
        res["pose_ate_mm"] = float(np.sqrt(sq / n) * 1e3)
    return res


def _map_numbers(out, sc, settings, seed, orb_keyframes) -> dict:
    res = {}
    m, fid_frame = out["map"], out["fid_frame"]
    made = [k for k in np.nonzero(m["kf_valid"])[0] if int(m["kf_frame_id"][k]) in fid_frame]
    if made:
        kf_gt = np.stack([sc.poses_gt[fid_frame[int(m["kf_frame_id"][k])]] for k in made])
        obs_kf, obs_mp = [], []
        for i, k in enumerate(made):
            ids = m["kf_mp"][k].reshape(-1)
            ids = ids[ids >= 0]
            ids = ids[m["mp_valid"][ids]]
            obs_kf.append(np.full(len(ids), i))
            obs_mp.append(ids)
        obs_kf, obs_mp = np.concatenate(obs_kf), np.concatenate(obs_mp)
        if len(obs_mp):
            gaps = ref_walls.wall_gaps(m["kf_Tcw"][made], kf_gt, obs_kf, m["mp_pos"][obs_mp],
                                       sc.world.box)
            res["wall_p50_mm"] = float(np.median(gaps) * 1e3)
            res["wall_obs"] = len(gaps)
    rng = np.random.default_rng(seed)
    pick = sorted(rng.choice(made, size=min(orb_keyframes, len(made)), replace=False)) if made else []
    sets = []
    for k in pick:
        f = fid_frame[int(m["kf_frame_id"][k])]
        sets.append((f, m["kf_xy_und"][k], m["kf_level"][k], m["kf_angle"][k], m["kf_desc"][k],
                     m["kf_feat_valid"][k]))
    if "last" in out:
        f, fr = out["last"]
        sets.append((f, fr["xy"], fr["level"], fr["angle"], fr["desc"], fr["valid"]))
    gaps, bits, fails = [], [], []
    for f, xy, level, angle, desc, valid in sets:
        greys = fed_greys(sc, f)
        for c in range(len(greys)):
            v = valid[c]
            if not v.any():
                continue
            r = ref_orb.check_features(np.asarray(greys[c]), xy[c][v], level[c][v], angle[c][v],
                                       np.ascontiguousarray(desc[c][v]), settings["n_levels"],
                                       settings["scale_factor"], settings["fast_min"])
            gaps.append(r["angle_gap"])
            bits.append(r["desc_bits"])
            fails.append(r["fast_fail"])
    if gaps:
        res["orb_angle_p50_mrad"] = float(np.median(np.concatenate(gaps)) * 1e3)
        res["orb_desc_bits_mean"] = float(np.mean(np.concatenate(bits)))
        res["orb_fast_fail_pct"] = float(np.mean(np.concatenate(fails)) * 100)
        res["orb_features"] = int(sum(len(g) for g in gaps))
        res["orb_images"] = len(gaps)
    return res


def fed_greys(sc, f: int) -> np.ndarray:
    """[C, H, W] the grey images of input frame f as the benchmark made them
    (for the TUM feed, the stored 8-bit images, which the decoder must give
    back exactly)."""
    if sc.greys is not None:
        return sc.greys[f]
    return sc.stored[0][f][None].astype(np.float32)


def compare(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the cell's limits; a
    number that could not be read is over its limit."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = values.get(name)
        checks[name] = {"value": v, "limit": limit}
        if v is None or not np.isfinite(v) or v > limit:
            ok = False
    return ok, checks
