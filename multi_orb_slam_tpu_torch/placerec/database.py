"""Keyframe database: sparse BoW store + loop / reloc candidate detection.

Counterpart of `multi_orb_slam_tpu/placerec/database.py` (which replaces
`KeyFrameDatabase`, src/KeyFrameDatabase.cc).  Each keyframe's BoW is kept
SPARSE (word ids + tf-idf values, at most one per feature, a lossless
[K, F] store) and a query is scored against every keyframe with one scatter
+ gather + row reduction (`vocabulary.score_sparse_many`), independent of
vocabulary size.  The camera-0 BoW serves loop detection and relocalization
(the reference's loop path only ever uses its cam1-only inverted file); the
all-camera BoW is stored beside it.

The two detectors read the scores, the covisibility matrix and the validity
flags from the device once and decide on the host in numpy, as the
reference does: they run once per keyframe or per lost frame.

`add_keyframe` and `remove_keyframe` write into the database's tensors in
place and return the same tuple; a caller must not hold on to the database
it passed in as if it were a snapshot.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..mapping import map_state as ms
from ..utils import metrics
from . import vocabulary as vocab_mod


class KeyFrameDB(NamedTuple):
    ids_cam0: torch.Tensor    # [K, F] int32 word ids (-1 pad), camera 0
    vals_cam0: torch.Tensor   # [K, F] float32 tf-idf values (L1-normalized)
    ids_all: torch.Tensor     # [K, C*F] all-camera word ids
    vals_all: torch.Tensor    # [K, C*F]
    has_bow: torch.Tensor     # [K] bool
    n_words: int


def make_empty_db(max_kf: int, n_words: int,
                  budget_cam0: int = 2048, budget_all: int = 4096,
                  device=None) -> KeyFrameDB:
    """An empty store on `device` (the CUDA device when None)."""
    device = resolve_device(device)
    return KeyFrameDB(
        ids_cam0=torch.full((max_kf, budget_cam0), -1, dtype=torch.int32, device=device),
        vals_cam0=torch.zeros((max_kf, budget_cam0), dtype=torch.float32, device=device),
        ids_all=torch.full((max_kf, budget_all), -1, dtype=torch.int32, device=device),
        vals_all=torch.zeros((max_kf, budget_all), dtype=torch.float32, device=device),
        has_bow=torch.zeros(max_kf, dtype=torch.bool, device=device),
        n_words=n_words,
    )


def add_keyframe(
    db: KeyFrameDB, voc: vocab_mod.Vocabulary, state: ms.MapState, kf_slot,
) -> KeyFrameDB:
    """KeyFrameDatabase::add / add_cam1 (KeyFrameDatabase.cc:43-58)."""
    k = int(kf_slot)
    desc = state.kf_desc[k]          # [C, F, 8]
    valid = state.kf_feat_valid[k]
    B0 = db.ids_cam0.shape[1]
    BA = db.ids_all.shape[1]
    i0, v0 = vocab_mod.bow_sparse(voc, desc[0], valid[0], budget=B0)
    ia, va = vocab_mod.bow_sparse(
        voc, desc.reshape(-1, 8), valid.reshape(-1), budget=BA)
    db.ids_cam0[k] = i0
    db.vals_cam0[k] = v0
    db.ids_all[k] = ia
    db.vals_all[k] = va
    with metrics.wait("db_has_bow_write"):     # a copy from the host
        db.has_bow[k] = True
    return db


def remove_keyframe(db: KeyFrameDB, kf_slot) -> KeyFrameDB:
    with metrics.wait("db_has_bow_write"):     # a copy from the host
        db.has_bow[int(kf_slot)] = False
    return db


def score_query_cam0(db: KeyFrameDB, q_ids, q_vals) -> torch.Tensor:
    """L1 score of one sparse query against every keyframe's cam-0 BoW."""
    return vocab_mod.score_sparse_many(
        q_ids, q_vals, db.ids_cam0, db.vals_cam0, db.n_words)


def detect_loop_candidates(
    db: KeyFrameDB,
    state: ms.MapState,
    query_kf: int,
    min_score: float,
    n_candidates: int = 10,
    q_ids=None,
    q_vals=None,
    max_frame_id: int | None = None,
) -> list:
    """DetectLoopCandidates_cam1 (reference KeyFrameDatabase.cc:119-267).

    Score all keyframes at once, exclude covisibility-connected ones,
    accumulate scores over each candidate's covisibility group, keep the
    groups above 0.75 x the best accumulated score; then forward the top two
    raw-score disconnected candidates that clear 1.3 x minScore even when
    the group filter dropped them (a genuine revisit with a thin
    covisibility group).  Host-side (returns a python list of slots).

    `max_frame_id`: when given, keyframes with a newer frame id are not
    candidates: a young disconnected keyframe (the far side of a tracking
    cut) can otherwise outscore every genuine old revisit and mask it
    through the relative filter.
    """
    if q_ids is None:
        # query must already be indexed in the db; callers detecting BEFORE
        # add_keyframe (the reference's order, LoopClosing.cc:277) must pass
        # the query BoW explicitly or every score is silently zero
        q_ids, q_vals = db.ids_cam0[query_kf], db.vals_cam0[query_kf]
    l1 = metrics.host("db_scores", score_query_cam0(db, q_ids, q_vals))
    K = l1.shape[0]
    has = metrics.host("db_has_bow", db.has_bow & state.kf_valid).copy()
    has[query_kf] = False
    # exclude covisibility-connected keyframes (weight >= 15)
    W = metrics.host("db_covisibility", ms.covisibility(state, cam0_only=True))
    connected = W[query_kf] >= 15.0
    cand_mask = has & ~connected
    if max_frame_id is not None:
        cand_mask &= metrics.host("db_frame_ids", state.kf_frame_id) <= max_frame_id
    if not cand_mask.any():
        return []
    l1 = np.where(cand_mask, l1, -1.0)
    ok = l1 >= min_score
    out = []
    if ok.any():
        # accumulate over covisibility groups (top-10 covis per candidate)
        acc = np.full(K, -1.0, np.float32)
        best_of_group = np.arange(K).copy()
        for k in np.nonzero(ok)[0]:
            group = np.argsort(-W[k])[:10]
            group = group[W[k][group] > 0]
            members = [k] + [g for g in group if ok[g]]
            sc = sum(float(l1[m]) for m in members)
            best = max(members, key=lambda m: l1[m])
            acc[k] = sc
            best_of_group[k] = best
        best_acc = float(acc.max())
        keep = acc >= 0.75 * best_acc
        out = sorted({int(best_of_group[k]) for k in np.nonzero(keep)[0]},
                     key=lambda k: -l1[k])
    floor = 1.3 * min_score
    extra = [int(k) for k in np.argsort(-l1)[:2] if l1[k] > max(floor, 0.0)]
    out = list(dict.fromkeys(out + extra))
    return out[:n_candidates]


def detect_relocalization_candidates(
    db: KeyFrameDB,
    voc: vocab_mod.Vocabulary,
    state: ms.MapState,
    frame_desc_cam0: torch.Tensor,
    frame_valid_cam0: torch.Tensor,
    n_candidates: int = 5,
) -> list:
    """DetectRelocalizationCandidates (KeyFrameDatabase.cc:415-543):
    same scheme as loop candidates but scored against a frame and without
    the min-score/connected-KF gates."""
    q_ids, q_vals = vocab_mod.bow_sparse(
        voc, frame_desc_cam0, frame_valid_cam0,
        budget=db.ids_cam0.shape[1])
    l1 = metrics.host("db_scores", torch.where(db.has_bow & state.kf_valid,
                                               score_query_cam0(db, q_ids, q_vals), -1.0))
    order = np.argsort(-l1)[:n_candidates]
    return [int(k) for k in order if l1[k] > 0]
