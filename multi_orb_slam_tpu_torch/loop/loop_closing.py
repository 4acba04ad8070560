"""Loop closing, the place-recognition half: vocabulary, keyframe database
and loop-candidate detection with temporal consistency.

Counterpart of `multi_orb_slam_tpu/loop/loop_closing.py` (which replaces the
`LoopClosing` thread, src/LoopClosing.cc) as a deterministic stage invoked
after each keyframe's mapping pass:

1. DetectLoop (LoopClosing.cc:123-293): BoW gate (>= 10 frames since the
   last loop), minScore from camera-0 covisibility neighbours, database
   candidates with covisibility-group accumulation, temporal consistency
   over 3 consecutive keyframes.

**Loops are detected and not closed.**  The reference's steps 2 and 3
(ComputeSim3: matching, Sim3 RANSAC and refinement; CorrectLoop: Sim3
propagation, point fusion, essential-graph optimization, global BA) rest on
`geometry/sim3`, `loop/sim3_solver`, `optim/sim3_opt`, `optim/pose_graph`
and `optim/global_ba`, which this package does not have yet.  Until it does,
`process_keyframe` counts the candidates that pass detection
(`n_candidates_unverified`) and returns the map unchanged,
`merge_pending_gba` returns its argument and `n_loops_closed` stays 0.
Everything relocalization needs is here: the vocabulary (trained online from
early keyframe descriptors, or loaded from a DBoW2 text file) and the
database that every mapped keyframe is indexed into.
"""

from __future__ import annotations

import time

import numpy as np

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..mapping import map_state as ms
from ..placerec import database as db_mod, vocabulary as vocab_mod

MIN_MATCHES_BOW = 15      # LoopClosing.cc:372 (SearchByBoW gate)      } the gates of
MIN_INLIERS_SIM3 = 20     # LoopClosing.cc:461                         } the Sim3 stage,
MIN_TOTAL_MATCHES = 40    # LoopClosing.cc:522                         } not ported yet
CONSISTENCY_TH = 3        # LoopClosing.cc:53 (mnCovisibilityConsistencyTh)
DETECT_GAP = 10           # LoopClosing.cc:137 (mnId < mLastLoopKFid+10)
MAX_RELAX_STREAK = 3      # consecutive relaxed-only chain extensions allowed
MIN_LOOP_AGE = 30         # frames: a loop candidate must be genuinely old.
                          # The reference relies on covisibility exclusion
                          # alone; after tracking losses fragment the map, a
                          # recent-but-disconnected KF can pass that gate and
                          # close a spurious "loop" onto itself.
VOCAB_MIN_DESCS = 6000


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
        self.n_loops_closed = 0
        self.n_candidates_unverified = 0
        self._pending_bow = []

    def _empty_db(self) -> db_mod.KeyFrameDB:
        return db_mod.make_empty_db(self.cfg.max_kf, self.voc.n_words, device=self.device)

    def reset(self):
        """Clear all map-derived state (reference LoopClosing::RequestReset,
        src/LoopClosing.cc:1006-1030).  MUST run on a system reset: the
        keyframe database is re-created (its BoW rows index dead slots); the
        trained vocabulary itself is map-independent and kept."""
        self._pending_bow = []
        self.consistent_groups = []
        self._relax_streak = 0
        self.last_loop_kf = -DETECT_GAP
        if self.voc is not None:
            self.db = self._empty_db()

    # ------------------------------------------------------------------

    def _ensure_vocab(self, state: ms.MapState, kf_slot: int) -> bool:
        if self.voc is not None:
            return True
        desc = state.kf_desc[kf_slot][0].cpu().numpy()
        valid = state.kf_feat_valid[kf_slot][0].cpu().numpy()
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
        state = self.merge_pending_gba(state)
        if not self._ensure_vocab(state, kf_slot):
            return state
        # index any keyframes that arrived before the vocabulary was ready
        kf_valid = state.kf_valid.cpu().numpy() if self._pending_bow else None
        for k in self._pending_bow:
            if bool(kf_valid[k]):
                self.db = db_mod.add_keyframe(self.db, self.voc, state, k)
        self._pending_bow = []

        fid, n_kf = (int(v) for v in (state.kf_frame_id[kf_slot], state.n_kf))
        candidates = []
        if fid >= self.last_loop_kf + DETECT_GAP and n_kf > 5:
            candidates = self._detect(state, kf_slot)
        self.db = db_mod.add_keyframe(self.db, self.voc, state, kf_slot)
        # detected, not verified and not corrected (see the module docstring)
        self.n_candidates_unverified += len(candidates)
        return state

    # ------------------------------------------------------------------

    def _detect(self, state: ms.MapState, kf_slot: int) -> list:
        """DetectLoop with temporal consistency groups."""
        # minScore = lowest BoW similarity to a covisibility neighbor
        W = ms.covisibility(state, cam0_only=True).cpu().numpy()
        neighbors = np.nonzero(W[kf_slot] >= 15.0)[0]
        q_desc = state.kf_desc[kf_slot][0]
        q_valid = state.kf_feat_valid[kf_slot][0]
        q_ids, q_vals = vocab_mod.bow_sparse(
            self.voc, q_desc, q_valid, budget=self.db.ids_cam0.shape[1])
        scores = db_mod.score_query_cam0(self.db, q_ids, q_vals).cpu().numpy()
        has = self.db.has_bow.cpu().numpy()
        nb = [n for n in neighbors if has[n]]
        min_score = float(scores[nb].min()) if nb else 0.3
        max_fid = int(state.kf_frame_id[kf_slot]) - MIN_LOOP_AGE
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

    def merge_pending_gba(self, state: ms.MapState) -> ms.MapState:
        """No global BA is ever dispatched while loops are not closed: the
        map comes back as it went in."""
        return state
