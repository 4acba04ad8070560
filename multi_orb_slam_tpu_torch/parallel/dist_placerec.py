"""Distributed place recognition over a process group.

Counterpart of `multi_orb_slam_tpu/parallel/dist_placerec.py`.  In a
multi-host deployment each host tracks its own rig and owns a shard of the
keyframe database, and a loop or relocalization query is scored against
every host's keyframes.  The sparse BoW store ([K, B] word ids and tf-idf
values) is split along the keyframe axis; the query is the same on every
rank.  Each rank scores its block with `vocabulary.score_sparse_many`, then
the [K] score vector is made whole on every rank: each rank writes its block
into zeros and the vectors are summed, which is exact (x + 0 = x) and is the
reference's tiled `all_gather` as an `all_reduce`.  Only scores move, never
BoW rows.
"""

from __future__ import annotations

import torch

from ..placerec import vocabulary as vocab_mod
from .multihost import Mesh, all_reduce_sum, rank_block


def make_dist_scorer(mesh: Mesh, n_words: int):
    """Returns `score(q_ids, q_vals, db_ids, db_vals) -> [K]`, where
    `db_ids` / `db_vals` are this rank's [K/n, B] block (`shard_database`)
    and the query is the same on every rank; every rank gets all K scores."""

    def score(q_ids, q_vals, db_ids, db_vals):
        s = vocab_mod.score_sparse_many(q_ids, q_vals, db_ids, db_vals, n_words)
        Kl = s.shape[0]
        full = torch.zeros(Kl * mesh.world_size, dtype=s.dtype, device=s.device)
        full[mesh.rank * Kl:(mesh.rank + 1) * Kl] = s
        return all_reduce_sum(full, mesh)

    return score


def shard_database(mesh: Mesh, db_ids, db_vals):
    """This rank's block of keyframe rows of the [K, B] store, on its device."""
    return rank_block(db_ids, mesh), rank_block(db_vals, mesh)
