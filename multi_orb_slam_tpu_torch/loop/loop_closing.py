"""Loop closing: detection, Sim3 computation, correction, pose graph, GBA.

Counterpart of `multi_orb_slam_tpu/loop/loop_closing.py` (which replaces the
`LoopClosing` thread, src/LoopClosing.cc) as a deterministic stage invoked
after each keyframe's mapping pass:

1. DetectLoop (LoopClosing.cc:123-293): BoW gate (>= 10 frames since the
   last loop), minScore from camera-0 covisibility neighbours, database
   candidates with covisibility-group accumulation, temporal consistency
   over 3 consecutive keyframes.
2. ComputeSim3 (LoopClosing.cc:320-565): word-gated descriptor matching
   over every rig camera (>= 15), batched Sim3 RANSAC with camera-aware
   reprojection checks (>= 20 inliers), the guided Sim3 search and the
   gated Sim3 LM (>= 20 inliers), then a projection count (>= 40 total).
3. CorrectLoop (LoopClosing.cc:586-818): Sim3 correction propagated to the
   covisibility neighbourhood, map-point correction, loop-point fusion,
   essential-graph optimization, then a global BA that is only enqueued on
   the device and merged into the map at the next keyframe
   (`merge_pending_gba`).

The three Hamming searches of step 2 are launches of the `window_match`
kernel (`STATS` counts them by role): the word-gated match (a query's level
range is its word id, a feature's level its word), both directions of
`sim3_solver.search_by_sim3` in one launch, and the projection count (a
radius of 8 px, every level open).  Each gives the reference's dense
Hamming matrix + argmin result.

The functions the reference jits are `graphs.graphed`, one CUDA graph
replay a call on the card, with the keyframe slots traced (every candidate
and loop replays the same entries): `sim3_solver.solve_sim3` and
`search_by_sim3`, `sim3_opt.optimize_sim3`, the loop fusion
`fusion.fuse_into_kfs`, `pose_graph.optimize_essential_graph`, the global
BA behind `global_ba.dispatch_global_ba` and `merge_gba`; so are the two
other searches of a candidate with what they count (`word_match_stage`,
`guided_count_stage`).  Every `window_match` launch of the stage runs
inside one of these graphs.  Between them the host reads what the reference
reads: the counts at each gate and the two compactions of matched pairs.

The RANSAC's minimal sets come from `triplet_source(valid, kf_a, kf_b)`: by
default a `torch.Generator` seeded with kf_a * 1000 + kf_b (the reference
seeds a JAX key with the same number; the two draw other sets).  A caller
may replace it, as the tests do with the reference's own draws.

The vocabulary is trained online from early keyframe descriptors, or loaded
from a DBoW2 text file.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import camera as cam_mod, se3, sim3
from ..mapping import fusion, map_state as ms
from ..ops import hamming, kernels
from ..optim import global_ba, pose_graph, sim3_opt
from ..placerec import database as db_mod, vocabulary as vocab_mod
from ..utils import graphs, metrics
from . import sim3_solver

MIN_MATCHES_BOW = 15      # LoopClosing.cc:372 (SearchByBoW gate)
MIN_INLIERS_SIM3 = 20     # LoopClosing.cc:461
MIN_TOTAL_MATCHES = 40    # LoopClosing.cc:522
CONSISTENCY_TH = 3        # LoopClosing.cc:53 (mnCovisibilityConsistencyTh)
DETECT_GAP = 10           # LoopClosing.cc:137 (mnId < mLastLoopKFid+10)
MAX_RELAX_STREAK = 3      # consecutive relaxed-only chain extensions allowed
MIN_LOOP_AGE = 30         # frames: a loop candidate must be genuinely old.
                          # The reference relies on covisibility exclusion
                          # alone; after tracking losses fragment the map, a
                          # recent-but-disconnected KF can pass that gate and
                          # close a spurious "loop" onto itself.
VOCAB_MIN_DESCS = 6000
GUIDED_RADIUS_PX = 8.0
SIM3_CAP = 256            # correspondences into the RANSAC
REFINE_CAP = 512          # correspondences into the Sim3 LM
FUSE_CAP = 32             # keyframes fused per loop: one fixed batch

# `window_match` launches by loop role, since import
STATS = {"word_match": 0, "search_by_sim3": 0, "guided_matches": 0}


def _count(role: str, before: int) -> None:
    STATS[role] += kernels.LAUNCHES["window_match"] - before


def word_match_args(desc_a, has_a, words_a, desc_b, has_b, words_b) -> tuple:
    """The `window_match` arguments of the word-gated match (C = 1): a
    query's level range is [w, w] for its word w and a feature's level is
    its word (the gate record carries the level's full 32 bits), the window
    is open (every position 0, radius 1, -1 for a query without a landmark),
    the stereo gate is off and the feature mask is `has_b`."""
    Na, Nb = desc_a.shape[0], desc_b.shape[0]
    dev = desc_a.device
    f32, i32 = torch.float32, torch.int32
    wa = words_a.to(i32)[None].contiguous()
    return (torch.zeros((1, Na, 2), dtype=f32, device=dev),
            torch.where(has_a, 1.0, -1.0).to(f32)[None].contiguous(),
            wa, wa,
            torch.full((1, Na), -1e9, dtype=f32, device=dev),
            desc_a[None].contiguous(),
            torch.zeros((1, Nb, 2), dtype=f32, device=dev),
            torch.full((1, Nb), -1.0, dtype=f32, device=dev),
            words_b.to(i32)[None].contiguous(),
            has_b[None].contiguous(), desc_b[None].contiguous())


def word_gated_match(desc_a, has_a, words_a, desc_b, has_b, words_b):
    """Best and second-best b feature per a feature among the b features
    that share its vocabulary word: (best_idx, best_d, second_d), each [Na];
    distance 2^20 where there is none.  The reference's dense [Na, Nb]
    Hamming matrix masked by word equality and `masked_argmin2`, as ONE
    `window_match` launch (`word_match_args`)."""
    bi, bd, b2, _ = kernels.window_match(
        *word_match_args(desc_a, has_a, words_a, desc_b, has_b, words_b))
    return bi[0], bd[0], b2[0]


def guided_count_args(uv, proj_ok, q_desc, f_xy, f_valid, f_desc,
                      radius: float = GUIDED_RADIUS_PX) -> tuple:
    """The `window_match` arguments of the projection count (C = 1):
    queries are the projected points with radius `radius` (-1 where the
    projection is not usable), every level open, the stereo gate off."""
    Q, F = uv.shape[0], f_xy.shape[0]
    dev = uv.device
    f32, i32 = torch.float32, torch.int32
    return (uv[None].contiguous(),
            torch.where(proj_ok, radius, -1.0).to(f32)[None].contiguous(),
            torch.full((1, Q), -1, dtype=i32, device=dev),
            torch.full((1, Q), 1 << 30, dtype=i32, device=dev),
            torch.full((1, Q), -1e9, dtype=f32, device=dev),
            q_desc[None].contiguous(),
            f_xy[None].contiguous(),
            torch.full((1, F), -1.0, dtype=f32, device=dev),
            torch.zeros((1, F), dtype=i32, device=dev),
            f_valid[None].contiguous(), f_desc[None].contiguous())


def count_guided_matches(uv, proj_ok, q_desc, f_xy, f_valid, f_desc,
                         radius: float = GUIDED_RADIUS_PX) -> torch.Tensor:
    """Number of projected points [Q] that land within `radius` px (both
    axes) of a valid feature [F] whose descriptor is within TH_LOW of theirs:
    the reference's `any(near & d <= TH_LOW)` over a dense [Q, F] matrix,
    which is "the best gated distance is <= TH_LOW": ONE `window_match`
    launch (`guided_count_args`)."""
    _, bd, _, _ = kernels.window_match(
        *guided_count_args(uv, proj_ok, q_desc, f_xy, f_valid, f_desc, radius))
    return (bd[0] <= hamming.TH_LOW).sum(dtype=torch.int32)


@graphs.graphed()
def word_match_stage(kf_desc: torch.Tensor, kf_mp: torch.Tensor, kf_feat_valid: torch.Tensor,
                     voc: vocab_mod.Vocabulary, kf_a, kf_b):
    """The word-gated match between the map-point features of every rig
    camera of keyframes `kf_a` and `kf_b` (slots: ints, traced on the
    card) with Lowe's ratio 0.75 at TH_LOW: (n_matches, best_idx [C*F],
    ok [C*F]) over the flat [C*F] features of kf_a."""
    dev = kf_mp.device
    ra, rb = ms.slot_index(kf_a, dev), ms.slot_index(kf_b, dev)
    da = kf_desc.index_select(0, ra)[0].reshape(-1, kf_desc.shape[-1])
    db_ = kf_desc.index_select(0, rb)[0].reshape(-1, kf_desc.shape[-1])
    has_a = (kf_mp.index_select(0, ra).reshape(-1) >= 0) & kf_feat_valid.index_select(
        0, ra).reshape(-1)
    has_b = (kf_mp.index_select(0, rb).reshape(-1) >= 0) & kf_feat_valid.index_select(
        0, rb).reshape(-1)
    bi, bd, b2 = word_gated_match(da, has_a, vocab_mod.transform_words(voc, da),
                                  db_, has_b, vocab_mod.transform_words(voc, db_))
    ok = (bd <= hamming.TH_LOW) & (bd.to(torch.float32) <= 0.75 * b2.to(torch.float32))
    return ok.sum(), bi, ok


@graphs.graphed(static_argnames=("cfg",))
def guided_count_stage(state: ms.MapState, kf_a, kf_b, g_ab: torch.Tensor,
                       calib: cam_mod.CameraParams, cfg: SlamConfig) -> torch.Tensor:
    """SearchByProjection_cam1-style count of additional agreements:
    keyframe `kf_b`'s landmarks projected through g_ab into `kf_a`'s camera
    0 (`count_guided_matches`); slots as in `word_match_stage`."""
    M = cfg.max_mp
    dev = g_ab.device
    ra, rb = ms.slot_index(kf_a, dev), ms.slot_index(kf_b, dev)
    mp_b = state.kf_mp.index_select(0, rb).reshape(-1)
    mask_b = ms.scatter_max_bool(M, torch.where(mp_b >= 0, mp_b, M - 1), mp_b >= 0)
    pts_a_rig = sim3.apply(g_ab, se3.transform_points(state.kf_Tcw.index_select(0, rb)[0],
                                                      state.mp_pos))
    uv = cam_mod.project(calib.K[0], pts_a_rig)
    proj_ok = (mask_b & state.mp_valid & cam_mod.in_image(uv, cfg.width, cfg.height)
               & (pts_a_rig[:, 2] > 0.1))
    return count_guided_matches(uv, proj_ok, state.mp_desc,
                                state.kf_xy_und.index_select(0, ra)[0, 0],
                                state.kf_feat_valid.index_select(0, ra)[0, 0],
                                state.kf_desc.index_select(0, ra)[0, 0])


@graphs.graphed()
def merge_gba(state: ms.MapState, Tcw_gba, pos_gba, old_kf, kf_fid_launch,
              old_mp, mp_ff_launch) -> ms.MapState:
    """Fold GBA output (computed from a past map snapshot) into the live map.

    Mirrors the propagation of src/LoopClosing.cc:927-989.  Slot-recycling
    guard: a slot only counts as "existed at launch" if it still holds the
    same keyframe (frame id) / map point (creation frame): a culled slot
    reused during the solve is treated as new.  Written out of place: no
    input tensor is modified.
    """
    K = state.kf_Tcw.shape[0]
    old_kf_eff = old_kf & state.kf_valid & (state.kf_frame_id == kf_fid_launch)
    old_mp_eff = old_mp & state.mp_valid & (state.mp_first_frame == mp_ff_launch)
    is_new_kf = state.kf_valid & ~old_kf_eff
    # spanning-tree parent of a keyframe born during the solve: the old
    # keyframe sharing the most camera-0 observations (the first such)
    W = ms.covisibility(state, cam0_only=True)
    w_old = torch.where(old_kf_eff[None, :], W, -1.0)
    parent = hamming.first_argmin(-w_old, dim=1)
    has_parent = torch.gather(w_old, 1, parent[:, None])[:, 0] > 0
    # Tcw_child' = (Tcw_child * Tcw_parent^-1) * Tcw_parent_GBA
    corr_child = state.kf_Tcw @ se3.inverse(state.kf_Tcw[parent]) @ Tcw_gba[parent]
    new_Tcw = torch.where(
        old_kf_eff[:, None, None], Tcw_gba,
        torch.where((is_new_kf & has_parent)[:, None, None], corr_child, state.kf_Tcw))
    # map points born during the solve: re-anchor through their creating
    # keyframe's old->new transform (x' = T_ref_new^-1 * T_ref_old * x)
    ref = state.mp_first_kf.clamp(0, K - 1).long()
    corr = se3.inverse(new_Tcw[ref]) @ state.kf_Tcw[ref]
    x_corr = (corr[:, :3, :3] @ state.mp_pos[..., None])[..., 0] + corr[:, :3, 3]
    is_new_mp = state.mp_valid & ~old_mp_eff & (state.mp_first_kf >= 0)
    mp_pos = torch.where(old_mp_eff[:, None], pos_gba,
                         torch.where(is_new_mp[:, None], x_corr, state.mp_pos))
    return state._replace(kf_Tcw=new_Tcw, mp_pos=mp_pos)


class LoopCloser:
    def __init__(self, calib: cam_mod.CameraParams, cfg: SlamConfig,
                 run_gba: bool = True, vocab_k: int = 10, vocab_depth: int = 4,
                 vocab_min_descs: int = VOCAB_MIN_DESCS,
                 vocab_path: str | None = None):
        # vocab depth 4 (~10^4 words) is the DEFAULT, as in the reference:
        # the 1000-word depth-3 tree sits on a score knife edge
        self.calib = calib
        self.cfg = cfg
        self.device = calib.K.device
        self.run_gba = run_gba
        self.vocab_k = vocab_k
        self.vocab_depth = vocab_depth
        self.vocab_min_descs = vocab_min_descs
        self.voc: vocab_mod.Vocabulary | None = None
        self.db: db_mod.KeyFrameDB | None = None
        if vocab_path:
            # pre-trained DBoW2 text vocabulary (the reference's ORBvoc.txt
            # pathway, src/System.cc:79-87), any size up to 10^6 words; the
            # sparse database scales independently of n_words
            self.voc = vocab_mod.load_dbow2_text(vocab_path, device=self.device)
            self.db = self._empty_db()
        self._train_descs = []
        self.vocab_train_seconds = None   # host time of the online training
        self.last_loop_kf = -DETECT_GAP
        self.consistent_groups = []  # [(set_of_kfs, count)]
        self._relax_streak = 0       # relaxed-only extensions in a row
        self.loop_pairs = []         # accumulated loop edges
        self.n_loops_closed = 0
        self._pending_bow = []
        # asynchronously dispatched global BA awaiting merge (the
        # reference's transient GBA thread, src/LoopClosing.cc:812):
        # (Tcw_gba, pos_gba, old_kf, kf_fid_launch, old_mp, mp_ff_launch)
        self._gba_pending = None
        self.n_gba_merged = 0
        self.triplet_source = self._draw_triplets
        # one record per candidate that reached Sim3 verification: the
        # counts at each gate as far as it got, and whether it closed
        self.verifications = []

    def _empty_db(self) -> db_mod.KeyFrameDB:
        return db_mod.make_empty_db(self.cfg.max_kf, self.voc.n_words, device=self.device)

    def _draw_triplets(self, valid: torch.Tensor, kf_a: int, kf_b: int) -> torch.Tensor:
        gen = torch.Generator(device=valid.device)
        gen.manual_seed(kf_a * 1000 + kf_b)
        return sim3_solver.sample_triplets(valid, sim3_solver.N_HYP, gen)

    def reset(self):
        """Clear all map-derived state (reference LoopClosing::RequestReset,
        src/LoopClosing.cc:1006-1030).  MUST run on a system reset: a pending
        GBA computed against the pre-reset map would otherwise merge into the
        fresh map, and since frame ids restart at 0 the slot-recycling guard
        can falsely match.  The keyframe database is re-created (its BoW rows
        index dead slots); the trained vocabulary itself is map-independent
        and kept."""
        self._gba_pending = None
        self._pending_bow = []
        self.consistent_groups = []
        self._relax_streak = 0
        self.loop_pairs = []
        self.last_loop_kf = -DETECT_GAP
        if self.voc is not None:
            self.db = self._empty_db()

    # ------------------------------------------------------------------

    def _ensure_vocab(self, state: ms.MapState, kf_slot: int) -> bool:
        if self.voc is not None:
            return True
        with metrics.span("loop/vocabulary", self.device):
            desc = metrics.host("loop_descriptors", state.kf_desc[kf_slot][0])
            valid = metrics.host("loop_descriptors", state.kf_feat_valid[kf_slot][0])
            self._train_descs.append(desc[valid])
            total = sum(len(d) for d in self._train_descs)
            if total < self.vocab_min_descs:
                self._pending_bow.append(kf_slot)
                return False
            train = np.concatenate(self._train_descs)
            t0 = time.perf_counter()
            self.voc = vocab_mod.build_vocabulary(
                train, k=self.vocab_k, depth=self.vocab_depth, device=self.device)
            self.vocab_train_seconds = time.perf_counter() - t0
            self.db = self._empty_db()
            return True

    # ------------------------------------------------------------------

    def process_keyframe(self, state: ms.MapState, kf_slot: int) -> ms.MapState:
        # merge a finished asynchronous GBA before anything else (the
        # reference applies GBA results once its thread completes; the
        # deterministic equivalent is the next keyframe boundary)
        state = self.merge_pending_gba(state)
        if not self._ensure_vocab(state, kf_slot):
            return state
        # index any keyframes that arrived before the vocabulary was ready
        kf_valid = metrics.host("loop_kf_valid", state.kf_valid) if self._pending_bow else None
        for k in self._pending_bow:
            if bool(kf_valid[k]):
                self.db = db_mod.add_keyframe(self.db, self.voc, state, k)
        self._pending_bow = []

        fid = int(metrics.host("loop_frame_id", state.kf_frame_id[kf_slot]))
        n_kf = int(metrics.host("loop_n_kf", state.n_kf))
        candidates = []
        if fid >= self.last_loop_kf + DETECT_GAP and n_kf > 5:
            with metrics.span("loop/detect", self.device):
                candidates = self._detect(state, kf_slot)
        self.db = db_mod.add_keyframe(self.db, self.voc, state, kf_slot)
        if not candidates:
            return state
        with metrics.span("loop/sim3", self.device):
            result = self._compute_sim3(state, kf_slot, candidates)
        if result is None:
            return state
        loop_kf, g_ab, _ = result
        with metrics.span("loop/correct", self.device):
            state = self._correct_loop(state, kf_slot, loop_kf, g_ab)
        self.last_loop_kf = fid
        self.n_loops_closed += 1
        return state

    # ------------------------------------------------------------------

    def _detect(self, state: ms.MapState, kf_slot: int) -> list:
        """DetectLoop with temporal consistency groups."""
        # minScore = lowest BoW similarity to a covisibility neighbor
        W = metrics.host("loop_covisibility", ms.covisibility(state, cam0_only=True))
        neighbors = np.nonzero(W[kf_slot] >= 15.0)[0]
        q_desc = state.kf_desc[kf_slot][0]
        q_valid = state.kf_feat_valid[kf_slot][0]
        q_ids, q_vals = vocab_mod.bow_sparse(
            self.voc, q_desc, q_valid, budget=self.db.ids_cam0.shape[1])
        scores = metrics.host("loop_scores", db_mod.score_query_cam0(self.db, q_ids, q_vals))
        has = metrics.host("loop_has_bow", self.db.has_bow)
        nb = [n for n in neighbors if has[n]]
        min_score = float(scores[nb].min()) if nb else 0.3
        max_fid = int(metrics.host("loop_frame_id", state.kf_frame_id[kf_slot])) - MIN_LOOP_AGE
        cands = db_mod.detect_loop_candidates(
            self.db, state, kf_slot, max(min_score, 0.0),
            q_ids=q_ids, q_vals=q_vals, max_frame_id=max_fid)
        # consistency-earned score slack: a candidate whose covisibility
        # group is already part of an in-progress consistency chain may
        # pass at a relaxed minScore.  minScore tracks the covisibility
        # neighborhood and rises on well-tracked legs, so a revisit that
        # scored above it for CONSISTENCY_TH-1 consecutive keyframes can
        # drop below it on the final one and reset the chain.
        strict = list(cands)
        if self.consistent_groups and self._relax_streak < MAX_RELAX_STREAK:
            chain = set()
            for g, cnt in self.consistent_groups:
                if cnt >= 1:
                    chain |= g
            if chain:
                relaxed = db_mod.detect_loop_candidates(
                    self.db, state, kf_slot, max(0.75 * min_score, 0.0),
                    q_ids=q_ids, q_vals=q_vals, max_frame_id=max_fid)
                for c in relaxed:
                    if c in cands:
                        continue
                    group = set(np.nonzero(W[c] > 0)[0].tolist()) | {c}
                    if group & chain:
                        cands.append(c)
        if not cands:
            self.consistent_groups = []
            self._relax_streak = 0
            return []
        # a chain may extend on relaxed-only hits for at most
        # MAX_RELAX_STREAK consecutive keyframes; after that it must earn a
        # full-minScore hit or die
        self._relax_streak = 0 if strict else self._relax_streak + 1
        # temporal consistency: a candidate's covis group must reappear in
        # CONSISTENCY_TH consecutive keyframes (LoopClosing.cc:210-280)
        enough = []
        new_groups = []
        for c in cands:
            group = set(np.nonzero(W[c] > 0)[0].tolist()) | {c}
            count = 0
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count >= CONSISTENCY_TH - 1:
                enough.append(c)
        self.consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------

    def _compute_sim3(self, state: ms.MapState, kf_a: int, candidates: list):
        """Word-gated matching + batched Sim3 RANSAC + refinement against
        each candidate in turn; the first that passes every gate wins.
        Returns (kf_b, g_ab [8], total matches) or None."""
        F = state.kf_desc.shape[2]
        dev = state.mp_pos.device
        fids = metrics.host("loop_frame_ids", state.kf_frame_id)
        fid_a = int(fids[kf_a])
        for kf_b in candidates:
            if int(fids[kf_b]) > fid_a - MIN_LOOP_AGE:
                continue
            rec = {"kf_a": kf_a, "kf_b": kf_b, "frame": fid_a, "bow": None,
                   "ransac": None, "lm": None, "total": None, "accepted": False}
            self.verifications.append(rec)
            # word-gated matching between map-point features of ALL rig
            # cameras: candidate pairs share a vocabulary leaf, as in the
            # reference's SearchByBoW over the full multi-camera feature set
            mp_a_flat = state.kf_mp[kf_a].reshape(-1)
            mp_b_flat = state.kf_mp[kf_b].reshape(-1)
            before = kernels.LAUNCHES["window_match"]
            n_matches, bi, ok = word_match_stage(state.kf_desc, state.kf_mp,
                                                 state.kf_feat_valid, self.voc, kf_a, kf_b)
            _count("word_match", before)
            rec["bow"] = n_matches = int(metrics.host("loop_bow_matches", n_matches))
            if n_matches < MIN_MATCHES_BOW:
                continue
            # matched landmark pairs in each RIG frame, with the observing
            # camera of each side (loop matches can land in any camera)
            with metrics.wait("loop_matched_pairs"):
                ia = torch.nonzero(ok)[:, 0][:SIM3_CAP]
            ib = bi[ia].long()
            n = ia.shape[0]
            pts_a = se3.transform_points(state.kf_Tcw[kf_a], state.mp_pos[mp_a_flat[ia].long()])
            pts_b = se3.transform_points(state.kf_Tcw[kf_b], state.mp_pos[mp_b_flat[ib].long()])

            def pad(x):
                out = torch.zeros((SIM3_CAP,) + x.shape[1:], dtype=x.dtype, device=dev)
                out[:n] = x
                return out

            valid = torch.arange(SIM3_CAP, device=dev) < n
            cam_a, cam_b = pad((ia // F).to(torch.int32)), pad((ib // F).to(torch.int32))
            pts_a, pts_b = pad(pts_a), pad(pts_b)
            g_ab, inl, n_inl = sim3_solver.solve_sim3(
                self.triplet_source(valid, kf_a, kf_b), pts_a, pts_b, cam_a, cam_b,
                valid, self.calib.T_rc, self.calib.K)
            rec["ransac"] = n_inl = int(metrics.host("loop_ransac_inliers", n_inl))
            if n_inl < MIN_INLIERS_SIM3:
                continue
            # guided match-producing search (SearchBySim3) + gated Sim3 LM
            # (OptimizeSim3): new correspondences feed the refinement,
            # acceptance needs >= 20 LM inliers (LoopClosing.cc:455-461)
            with metrics.span("loop/sim3_refine", dev):
                g_ab, n_lm = self._refine_sim3(state, kf_a, kf_b, g_ab, ia, ib, inl[:n])
            rec["lm"] = n_lm
            if n_lm < MIN_INLIERS_SIM3:
                continue
            # total-match gate: project the loop keyframe's points through
            # g_ab into kf_a and count agreeing landmarks
            # (LoopClosing.cc:478-529)
            rec["total"] = total = n_lm + self._guided_matches(state, kf_a, kf_b, g_ab)
            if total >= MIN_TOTAL_MATCHES:
                rec["accepted"] = True
                return kf_b, g_ab, total
        return None

    def _refine_sim3(self, state, kf_a: int, kf_b: int, g_ab, ia: torch.Tensor,
                     ib: torch.Tensor, ransac_inl: torch.Tensor):
        """SearchBySim3 guided matches + gated camera-aware Sim3-pair LM.

        `ia` / `ib` are the word-matched feature pairs (FLAT [C*F] indices
        over all rig cameras) that seeded RANSAC; `ransac_inl` their inlier
        mask.  Returns (g_refined [8], n_inliers int)."""
        cfg = self.cfg
        C, F = state.kf_desc.shape[1], state.kf_desc.shape[2]
        dev = state.mp_pos.device
        before = kernels.LAUNCHES["window_match"]
        guided = sim3_solver.search_by_sim3(
            state, kf_a, kf_b, g_ab, self.calib.K[0], cfg.max_mp,
            cfg.scale_factor, cfg.n_levels)
        _count("search_by_sim3", before)
        # union in the flat [C*F] index space: the guided search produces
        # cam0<->cam0 pairs (flat index == feature index); RANSAC-inlier seed
        # pairs, which may live in any camera, take precedence
        pair_of_a = torch.full((C * F,), -1, dtype=torch.int64, device=dev)
        pair_of_a[:F] = guided.long()
        pair_of_a[ia] = torch.where(ransac_inl, ib, pair_of_a[ia])    # ia holds no index twice
        with metrics.wait("loop_refine_pairs"):
            ja = torch.nonzero(pair_of_a >= 0)[:, 0][:REFINE_CAP]
        jb = pair_of_a[ja]
        n = ja.shape[0]

        def rows(kf, j):
            mp = state.kf_mp[kf].reshape(-1)[j].long()
            X = se3.transform_points(state.kf_Tcw[kf], state.mp_pos[mp])
            uv = state.kf_xy_und[kf].reshape(-1, 2)[j]
            lvl = state.kf_level[kf].reshape(-1)[j].long()
            return X, uv, 1.0 / sf2[lvl], (j // F).to(torch.int32)

        def pad(x):
            out = torch.zeros((REFINE_CAP,) + x.shape[1:], dtype=x.dtype, device=dev)
            out[:n] = x
            return out

        sf2 = metrics.upload([cfg.scale_factor ** (2.0 * lvl) for lvl in range(cfg.n_levels)],
                             dev, torch.float32)
        X_a, uv_a, is2_a, cam_a = (pad(x) for x in rows(kf_a, ja))
        X_b, uv_b, is2_b, cam_b = (pad(x) for x in rows(kf_b, jb))
        obs = sim3_opt.Sim3Obs(
            X_a=X_a, X_b=X_b, uv_a=uv_a, uv_b=uv_b, inv_sigma2_a=is2_a,
            inv_sigma2_b=is2_b, mask=torch.arange(REFINE_CAP, device=dev) < n,
            cam_a=cam_a, cam_b=cam_b)
        g_ref, _, n_inl = sim3_opt.optimize_sim3(
            g_ab, obs, self.calib.K, T_rc=self.calib.T_rc, fix_scale=True)
        return g_ref, int(metrics.host("loop_refine_inliers", n_inl))

    def _guided_matches(self, state, kf_a: int, kf_b: int, g_ab) -> int:
        """`guided_count_stage`, read back."""
        before = kernels.LAUNCHES["window_match"]
        n = guided_count_stage(state, kf_a, kf_b, g_ab, self.calib, self.cfg)
        _count("guided_matches", before)
        return int(metrics.host("loop_guided_matches", n))

    # ------------------------------------------------------------------

    def _correct_loop(self, state: ms.MapState, kf_a: int, kf_b: int,
                      g_ab: torch.Tensor) -> ms.MapState:
        """Sim3 propagation + point correction + fusion + pose graph + GBA.
        Every map array is replaced, none written in place."""
        K = self.cfg.max_kf
        M = self.cfg.max_mp
        dev = state.mp_pos.device
        # the loop says: landmarks seen in b map into a through g_ab, so a's
        # TRUE pose is S_aw = g_ab * S_bw; a's current pose carries the drift
        g_old = sim3.from_se3(state.kf_Tcw)            # [K, 8] world->kf
        S_aw_corr = sim3.compose(g_ab, g_old[kf_b])

        # propagate to the covisibility neighborhood of kf_a (CorrectedSim3)
        W = metrics.host("loop_covisibility", ms.covisibility(state, cam0_only=True))
        neigh = np.nonzero(W[kf_a] >= 15.0)[0].tolist()
        corrected_slots = [kf_a] + [n for n in neigh if n != kf_a]
        corr_mask = np.zeros(K, bool)
        corr_mask[corrected_slots] = True
        idx = metrics.upload(corrected_slots, dev, torch.int64)
        # S_kw_corr = S_k,a * S_aw_corr with S_k,a = S_kw * S_aw^-1
        S_ka = sim3.compose(g_old[idx], sim3.inverse(g_old[kf_a]))
        g_corr = g_old.clone()
        g_corr[idx] = sim3.compose(S_ka, S_aw_corr)

        # correct the map points of the corrected keyframes through kf_a:
        # x' = S_corr^-1 ( S_old (x) )
        rows = state.kf_mp[idx].reshape(-1)
        owned = ms.scatter_max_bool(M, torch.where(rows >= 0, rows, M - 1), rows >= 0)
        owned = owned & state.mp_valid
        x_corr = sim3.apply(sim3.inverse(g_corr[kf_a]), sim3.apply(g_old[kf_a], state.mp_pos))
        mp_pos = torch.where(owned[:, None], x_corr, state.mp_pos)
        kf_Tcw = state.kf_Tcw.clone()
        kf_Tcw[idx] = sim3.to_se3(g_corr[idx])
        state = state._replace(kf_Tcw=kf_Tcw, mp_pos=mp_pos)

        # fuse the loop landmarks into the corrected neighborhood in one
        # replay (reference SearchAndFuse, LoopClosing.cc:824-856)
        mp_b = state.kf_mp[kf_b].reshape(-1)
        loop_mask = ms.scatter_max_bool(M, torch.where(mp_b >= 0, mp_b, M - 1), mp_b >= 0)
        slots = torch.full((FUSE_CAP,), K - 1, dtype=torch.int64, device=dev)
        slots[:min(len(corrected_slots), FUSE_CAP)] = idx[:FUSE_CAP]
        state, _ = fusion.fuse_into_kfs(state, loop_mask, slots, self.cfg, self.calib)

        # essential-graph optimization
        self.loop_pairs.append((kf_a, kf_b))
        with metrics.span("loop/pose_graph", dev):
            ei, ej, meas, ok = pose_graph.build_essential_edges(
                W, metrics.host("loop_kf_valid", state.kf_valid),
                metrics.host("loop_frame_ids", state.kf_frame_id),
                g_old, (g_corr, corr_mask), self.loop_pairs)
            kf_free = state.kf_valid & (torch.arange(K, device=dev) != kf_b)
            g_opt = pose_graph.optimize_essential_graph(g_corr, kf_free, ei, ej, meas, ok)

        # apply: poses from Sim3 ([R | t/s]); points corrected through their
        # first (creating) keyframe's old->new transform
        new_Tcw = torch.where(state.kf_valid[:, None, None], sim3.to_se3(g_opt), state.kf_Tcw)
        ref_kf = state.mp_first_kf.clamp(0, K - 1).long()
        x_new = sim3.apply(sim3.inverse(g_opt[ref_kf]), sim3.apply(g_corr[ref_kf], state.mp_pos))
        mp_pos = torch.where((state.mp_valid & (state.mp_first_kf >= 0))[:, None],
                             x_new, state.mp_pos)
        state = state._replace(kf_Tcw=new_Tcw, mp_pos=mp_pos)

        # full-map BA, dispatched ASYNCHRONOUSLY: the solve is enqueued on
        # the device without a host read; tracking keeps working against the
        # pose-graph-corrected map and the result merges at the next
        # keyframe boundary (merge_pending_gba).  A newer loop closure
        # supersedes a pending GBA, as the reference's mnFullBAIdx check
        # ignores an outdated run (LoopClosing.cc:897-907).
        if self.run_gba:
            self._gba_pending = None
            with metrics.span("loop/gba_dispatch", dev):
                Tcw_gba, pos_gba = global_ba.dispatch_global_ba(
                    state, self.calib, self.cfg, n_outer=9)
            self._gba_pending = (Tcw_gba, pos_gba, state.kf_valid, state.kf_frame_id,
                                 state.mp_valid, state.mp_first_frame)
        return state

    # ------------------------------------------------------------------

    def merge_pending_gba(self, state: ms.MapState) -> ms.MapState:
        """Fold an asynchronously dispatched GBA result into the live map
        (reference LoopClosing::RunGlobalBundleAdjustment): keyframes that
        existed when GBA launched take their optimized poses; keyframes
        created during the solve are corrected through their spanning-tree
        parent; map points that existed take optimized positions, newer ones
        are re-anchored through their creating keyframe."""
        if self._gba_pending is None:
            return state
        pending, self._gba_pending = self._gba_pending, None
        self.n_gba_merged += 1
        with metrics.span("loop/gba_merge", self.device):
            return merge_gba(state, *pending)
