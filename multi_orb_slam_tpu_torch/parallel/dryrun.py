"""Multi-rank dry run: the three distributed stages on every rank.

Counterpart of `__graft_entry__.dryrun_multichip`: data-parallel ORB
extraction (one frame a rank), one distributed global BA step (points and
observations sharded, the camera system summed over the ranks), and
distributed place recognition (the keyframe store sharded, the scores made
whole on every rank).  The inputs are arguments; `dryrun_inputs` draws the
reference's tiny ones.  Every function here is a rank body for
`multihost.spawn_local` or runs under torchrun, and returns numpy arrays and
plain values.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..ops import kernels, orb
from ..placerec import vocabulary as vocab_mod
from . import dist_ba, dist_placerec
from .multihost import Mesh

# the `make_problem` / `flatten_problem` inputs, in `flatten_problem`'s order
FLAT_KEYS = ("kf_Tcw", "kf_valid", "kf_free", "kf_mp", "obs_uvr", "obs_is2", "mp_pos", "mp_valid")


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _no_host_sync(on: bool):
    """Raise on any host synchronisation inside (CUDA only)."""
    if not on:
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def run_ba(mesh: Mesh, prob: dict, n_outer: int = 8, cg_iters: int = 40, reps: int = 1) -> dict:
    """Flatten the whole problem (`FLAT_KEYS`, `T_rc`, `K_intr`, `bf`) for
    this mesh, keep this rank's shard, run the distributed step once to warm
    up and `reps` times timed.  On a card whose collectives stay on the device
    (NCCL, or no group) the timed calls run under
    `torch.cuda.set_sync_debug_mode("error")`: a host read inside the step
    raises.  Returns the poses, all points, the costs and the seconds per
    outer iteration, and the host's clock when the call began
    (`started_at`, `time.time()`)."""
    started_at = time.time()
    dev = mesh.device
    flat = dist_ba.flatten_problem(*(prob[k] for k in FLAT_KEYS), mesh.world_size)
    local = dist_ba.shard_problem(flat, mesh)
    T_rc = torch.from_numpy(np.asarray(prob["T_rc"], np.float32)).to(dev)
    K_intr = torch.from_numpy(np.asarray(prob["K_intr"], np.float32)).to(dev)
    bf = torch.tensor(float(prob["bf"]), dtype=torch.float32, device=dev)
    step = dist_ba.make_dist_ba_step(mesh, n_outer=n_outer, cg_iters=cg_iters)
    backend = "none" if mesh.group is None else str(torch.distributed.get_backend(mesh.group))
    strict = dev.type == "cuda" and backend != "gloo"
    step(local, T_rc, K_intr, bf)
    _synchronize(dev)
    t = time.perf_counter()
    with _no_host_sync(strict):
        for _ in range(reps):
            Tcw, pos_local, costs = step(local, T_rc, K_intr, bf)
    _synchronize(dev)
    dt = (time.perf_counter() - t) / reps
    pos = dist_ba.gather_points(pos_local, mesh)
    return {"Tcw": Tcw.cpu().numpy(), "pos": pos.cpu().numpy(), "costs": costs.cpu().numpy(),
            "s_per_outer_iter": dt / n_outer, "backend": backend, "world_size": mesh.world_size,
            "sync_checked": strict, "n_obs": int((flat.obs_mp >= 0).sum()),
            "n_slots": int(flat.obs_mp.shape[0]), "started_at": started_at}


def dryrun_inputs(world_size: int) -> dict:
    """The reference dry run's tiny inputs (for a world of 2 or more), drawn
    in its order from `RandomState(0)`: one 64x96 frame a rank (ORB: 64
    features, 3 levels); 8 keyframes (the first fixed) observing 32 of 16
    points a rank each, exactly (K 100/100/48/32, bf 10); a store of 4
    keyframes a rank x 32 words of 1000, queried with keyframe 1; 2 outer and
    8 CG iterations."""
    rng = np.random.RandomState(0)
    frames = rng.uniform(0, 255, (world_size, 64, 96)).astype(np.float32)
    Kf, F, M = 8, 32, 16 * world_size
    kf_Tcw = np.tile(np.eye(4, dtype=np.float32), (Kf, 1, 1))
    kf_Tcw[:, 0, 3] = 0.1 * np.arange(Kf)
    kf_free = np.ones(Kf, bool)
    kf_free[0] = False
    pts = rng.uniform(-2, 2, (M, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    kf_mp = np.full((Kf, 1, F), -1, np.int32)
    uvr = np.zeros((Kf, 1, F, 3), np.float32)
    Kintr = np.array([[100.0, 100.0, 48.0, 32.0]], np.float32)
    bf = np.float32(10.0)
    for k in range(Kf):
        sel = rng.choice(M, F, replace=False)
        for j, p in enumerate(sel):
            Xc = kf_Tcw[k, :3, :3] @ pts[p] + kf_Tcw[k, :3, 3]
            if Xc[2] < 0.2:
                continue
            u = Kintr[0, 0] * Xc[0] / Xc[2] + Kintr[0, 2]
            v = Kintr[0, 1] * Xc[1] / Xc[2] + Kintr[0, 3]
            kf_mp[k, 0, j] = p
            uvr[k, 0, j] = [u, v, u - bf / Xc[2]]
    n_words, Kdb, Bw = 1000, 4 * world_size, 32
    ids = np.full((Kdb, Bw), -1, np.int32)
    vals = np.zeros((Kdb, Bw), np.float32)
    for k in range(Kdb):
        w = rng.choice(n_words, Bw // 2, replace=False).astype(np.int32)
        v = rng.rand(Bw // 2).astype(np.float32)
        ids[k, :Bw // 2] = w
        vals[k, :Bw // 2] = v / v.sum()
    problem = dict(kf_Tcw=kf_Tcw, kf_valid=np.ones(Kf, bool), kf_free=kf_free, kf_mp=kf_mp,
                   obs_uvr=uvr, obs_is2=np.ones((Kf, 1, F), np.float32), mp_pos=pts,
                   mp_valid=np.ones(M, bool), T_rc=np.eye(4, dtype=np.float32)[None],
                   K_intr=Kintr, bf=bf)
    return dict(frames=frames, orb_cfg=orb.ORBConfig(n_features=64, n_levels=3),
                problem=problem, n_outer=2, cg_iters=8, db_ids=ids, db_vals=vals,
                n_words=n_words, query=1)


def dryrun_multichip(mesh: Mesh, inputs: dict) -> dict:
    """The three stages on this rank (`inputs` as `dryrun_inputs` gives them,
    with `frames` holding at least one frame a rank).  Raises if the BA
    step gives a NaN, or if the distributed scores are not the whole
    table's (`score_sparse_many`) within 1e-6 with the query as the best.
    Returns this rank's features, its kernel launches during its two
    extractions and the second one's seconds, the BA's result (`run_ba`)
    and the scores, and the host's clock when the call began."""
    started_at = time.time()
    dev, r = mesh.device, mesh.rank

    # stage 1: data-parallel ORB extraction, one frame a rank; the first
    # call pays for first use, the second is timed and must give the same
    frame = torch.from_numpy(np.asarray(inputs["frames"][r], np.float32)).to(dev)
    kernels.reset_launch_counts()
    first = orb.extract_orb(frame, inputs["orb_cfg"])
    _synchronize(dev)
    t = time.perf_counter()
    feats = orb.extract_orb(frame, inputs["orb_cfg"])
    _synchronize(dev)
    extract_s = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    if not all(torch.equal(a, b) for a, b in zip(first, feats)):
        raise AssertionError(f"rank {r}: two extractions of one frame differ")
    features = {f: v.cpu().numpy() for f, v in feats._asdict().items()}

    # stage 2: one distributed global BA step
    ba = run_ba(mesh, inputs["problem"], inputs["n_outer"], inputs["cg_iters"])
    if not (np.isfinite(ba["Tcw"]).all() and np.isfinite(ba["pos"]).all()):
        raise FloatingPointError(f"rank {r}: NaN or inf in the distributed BA's result")

    # stage 3: distributed place recognition
    pr = score_distributed(mesh, inputs["db_ids"], inputs["db_vals"], inputs["n_words"],
                           inputs["query"])
    return {"rank": r, "started_at": started_at, "features": features, "launches": launches,
            "extract_s": extract_s, "ba": ba, **pr}


def score_distributed(mesh: Mesh, db_ids, db_vals, n_words: int, query: int) -> dict:
    """Score keyframe `query` of the [K, B] store against the whole store,
    sharded over the mesh; raises unless the scores are the whole table's
    (`score_sparse_many` on this rank) within 1e-6 with the query as the
    best.  Returns the scores, their largest difference to the whole
    table's, whether they are the same bits, and the best keyframe."""
    dev = mesh.device
    q_ids = torch.from_numpy(np.asarray(db_ids[query])).to(dev)
    q_vals = torch.from_numpy(np.asarray(db_vals[query])).to(dev)
    d_ids, d_vals = dist_placerec.shard_database(mesh, db_ids, db_vals)
    scores = dist_placerec.make_dist_scorer(mesh, n_words)(q_ids, q_vals, d_ids, d_vals)
    whole = vocab_mod.score_sparse_many(
        q_ids, q_vals, torch.from_numpy(np.asarray(db_ids)).to(dev),
        torch.from_numpy(np.asarray(db_vals)).to(dev), n_words)
    scores, whole = scores.cpu().numpy(), whole.cpu().numpy()
    err = float(np.abs(scores - whole).max())
    best = int(np.argmax(scores))
    if best != query or not np.allclose(scores, whole, rtol=1e-6, atol=1e-6):
        raise AssertionError(f"rank {mesh.rank}: distributed scores part from the whole "
                             f"table's by {err:.3g}, best keyframe {best} (query {query})")
    return {"scores": scores, "score_err": err,
            "scores_bit_equal": bool(np.array_equal(scores, whole)), "best": best}
