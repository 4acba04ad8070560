"""Bag-of-binary-words vocabulary as dense arrays.

Counterpart of `multi_orb_slam_tpu/placerec/vocabulary.py` (which replaces
DBoW2's `TemplatedVocabulary<FORB>`): a k-ary tree of 256-bit centroids with
TF-IDF weights.

- the tree is a [n_nodes, k] child table + [n_nodes, 8] int32 centroids (the
  reference's uint32 words, bit for bit, see `convert.py`); `transform_words`
  descends all descriptors in parallel (L levels of Hamming argmin over k
  children per beam slot)
- a frame/keyframe BoW vector is sparse: word ids + tf-idf values, at most
  one per feature; one query is scored against every keyframe with one
  scatter + gather + row sum (`score_sparse_many`)
- vocabularies are trained with k-medians over binary descriptors
  (bit-majority centroids), in numpy on the host, with the reference's
  `RandomState(seed)` draws: the same descriptors give the same tree in both
  packages

Tie order is part of the result: equal Hamming distances are common, so the
beam keeps the lowest index among equals (`hamming.top_k`, a stable sort) and
the final choice is the first minimum (`hamming.first_argmin`), as
`jax.lax.top_k` and `jnp.argmin` do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import hamming
from ..utils import metrics

_BIGD = 1 << 20      # distance of a dead beam slot
_NO_WORD = 1 << 30   # sort key of an invalid feature in `bow_sparse`


class Vocabulary(NamedTuple):
    children: torch.Tensor     # [n_nodes, k] int32 child node ids (-1 none)
    node_desc: torch.Tensor    # [n_nodes, 8] int32 centroids
    word_id: torch.Tensor      # [n_nodes] int32 word index for leaves (-1 inner)
    word_weight: torch.Tensor  # [n_words] float32 idf weights
    k: int
    depth: int
    n_words: int


def _as_words(descs) -> np.ndarray:
    """[N, 8] descriptor words as uint32, whichever 32-bit integer type
    they arrive in (the port's tensors hold them as int32)."""
    a = np.ascontiguousarray(descs)
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return np.asarray(a, np.uint32)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return metrics.upload(np.array(a, copy=True), device)


def _bit_majority(descs: np.ndarray) -> np.ndarray:
    """Majority vote per bit over [N, 8] uint32 -> [8] uint32 centroid
    (FORB::meanValue, Thirdparty/DBoW2/DBoW2/FORB.cpp)."""
    bits = np.unpackbits(descs.view(np.uint8), axis=1)
    mean = bits.mean(axis=0) >= 0.5
    return np.packbits(mean.astype(np.uint8)).view(np.uint32)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x = (a[:, None, :] ^ b[None, :, :]).view(np.uint8)
    return np.unpackbits(x, axis=-1).sum(-1)


def _kmedians(descs: np.ndarray, k: int, iters: int, rng) -> tuple:
    """Binary k-medians: returns (centroids [k', 8], assign [N])."""
    n = descs.shape[0]
    k = min(k, n)
    sel = rng.choice(n, k, replace=False)
    cent = descs[sel].copy()
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = _hamming_np(descs, cent)
        assign = d.argmin(1)
        for j in range(k):
            m = assign == j
            if m.any():
                cent[j] = _bit_majority(descs[m])
    return cent, assign


def build_vocabulary(
    descriptors: np.ndarray, k: int = 10, depth: int = 3,
    iters: int = 5, seed: int = 0, weight_descs: np.ndarray | None = None,
    device=None,
) -> Vocabulary:
    """Train a k^depth-word tree from [N, 8] descriptor words (numpy, on the
    host); the tree's tensors land on `device` (the CUDA device when None)."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    descriptors = _as_words(descriptors)
    max_nodes = sum(k ** (l + 1) for l in range(depth)) + 1
    children = np.full((max_nodes, k), -1, np.int32)
    node_desc = np.zeros((max_nodes, 8), np.uint32)
    word_id = np.full(max_nodes, -1, np.int32)
    next_node = 1
    next_word = 0

    # BFS expansion
    queue = [(0, descriptors, 0)]  # (node, descs, level)
    while queue:
        node, descs, level = queue.pop(0)
        if level == depth or len(descs) <= 1:
            word_id[node] = next_word
            next_word += 1
            continue
        cent, assign = _kmedians(descs, k, iters, rng)
        for j in range(cent.shape[0]):
            m = assign == j
            if not m.any():
                continue
            cid = next_node
            next_node += 1
            children[node, j] = cid
            node_desc[cid] = cent[j]
            queue.append((cid, descs[m], level + 1))
    n_words = next_word

    voc = Vocabulary(
        children=_to_device(children[:next_node], device),
        node_desc=_to_device(node_desc[:next_node], device),
        word_id=_to_device(word_id[:next_node], device),
        word_weight=torch.ones(n_words, dtype=torch.float32, device=device),
        k=k, depth=depth, n_words=n_words,
    )
    # idf weights from the training corpus (TemplatedVocabulary::setWeights)
    train = _as_words(weight_descs) if weight_descs is not None else descriptors
    words = metrics.host("vocab_words", transform_words(voc, _to_device(train, device)))
    n_docs_proxy = max(len(train), 1)
    counts = np.bincount(words, minlength=n_words).astype(np.float32)
    idf = np.log(n_docs_proxy / np.maximum(counts, 1.0) + 1.0)
    return voc._replace(word_weight=_to_device(idf.astype(np.float32), device))


def transform_words(voc: Vocabulary, descs: torch.Tensor,
                    beam: int = 3) -> torch.Tensor:
    """Descend the tree: [N, 8] descriptors -> [N] int32 word ids.

    Beam search (default width 3) instead of DBoW2's greedy descent: a
    descriptor near a decision boundary at an upper level otherwise lands
    in an entirely different subtree under small appearance change; the beam
    keeps the candidate subtrees alive and picks the closest LEAF centroid.
    beam=1 reproduces the greedy descent.
    """
    n = descs.shape[0]
    dev = descs.device
    k = voc.children.shape[1]
    n_nodes = voc.children.shape[0]
    nodes = torch.zeros((n, beam), dtype=torch.int64, device=dev)  # beam of live nodes
    # invalid beam slots point at node 0 with +inf distance (set by a
    # comparison on the device: a number written in would be a copy from
    # the host, which a CUDA graph's capture refuses)
    dist = torch.where(torch.arange(beam, device=dev) == 0, 0, _BIGD).to(
        torch.int32).expand(n, beam)
    for _ in range(voc.depth):
        ch = voc.children[nodes].long()                    # [N, B, k]
        cd = voc.node_desc[ch.clamp(0, n_nodes - 1)]       # [N, B, k, 8]
        d = hamming.popcount32(
            torch.bitwise_xor(cd, descs[:, None, None, :])).sum(dim=-1, dtype=torch.int32)
        # children of exhausted/invalid slots: carry the node itself (a
        # leaf reached above this level keeps competing with its distance)
        d = torch.where((ch >= 0) & (dist[..., None] < _BIGD), d, _BIGD)
        cand_nodes = torch.where(ch >= 0, ch, nodes[..., None])
        leaf_self = torch.all(ch < 0, dim=-1) & (dist < _BIGD)   # [N, B]
        d_self = torch.where(leaf_self, dist, _BIGD)
        flat_d = torch.cat([d.reshape(n, beam * k), d_self], dim=1)
        flat_n = torch.cat([cand_nodes.reshape(n, beam * k), nodes], dim=1)
        top_d, top_i = hamming.top_k(-flat_d, beam)
        dist = -top_d
        nodes = torch.gather(flat_n, 1, top_i)
    best = hamming.first_argmin(dist, dim=1)
    node = torch.gather(nodes, 1, best[:, None])[:, 0]
    w = voc.word_id[node]
    return torch.where(w >= 0, w, torch.zeros_like(w))


def bow_vector(voc: Vocabulary, descs: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """[F, 8] descriptors (+mask) -> L1-normalized tf-idf vector [n_words].

    Replaces `transform(features, BowVector, ...)` + the BowVector map
    (reference include/ORBVocabulary.h:26-34 usage)."""
    words = transform_words(voc, descs).long()
    tgt = torch.where(valid, words, torch.full_like(words, voc.n_words - 1))
    v = torch.zeros(voc.n_words, dtype=torch.float32, device=descs.device)
    # counts are small integers: exact whatever order the adds land in
    v.index_add_(0, tgt, valid.to(torch.float32))
    v = v * voc.word_weight
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


def score_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score in [0, 1] (ScoringObject.cpp L1Scoring):
    s = 1 - 0.5 * |va - vb|_1 for L1-normalized va, vb.
    Broadcasts: a [..., W], b [..., W]."""
    return 1.0 - 0.5 * torch.sum(torch.abs(a - b), dim=-1)


def bow_sparse(voc: Vocabulary, descs: torch.Tensor, valid: torch.Tensor,
               budget: int | None = None):
    """[F, 8] descriptors (+mask) -> sparse L1-normalized tf-idf vector.

    Returns (word ids [B] int32 with -1 padding, values [B] float32).
    A frame has at most F distinct words, so a [B = F] budget is lossless.
    Built with a stable sort + segment sums (no [n_words]-sized
    intermediate) and no host read: the run ends are compacted to the front
    by a second stable sort, and the slots past the last run repeat the final
    run end, whose differenced value is exactly 0.
    """
    F = descs.shape[0]
    B = budget or F
    dev = descs.device
    words = transform_words(voc, descs)
    w = torch.where(valid, voc.word_weight[words.long()], 0.0)
    key = torch.where(valid, words, _NO_WORD)
    order = torch.argsort(key, stable=True)
    sw = key[order]
    sv = w[order]
    # segment sums over runs of equal word id
    csum = torch.cumsum(sv, dim=0)
    last = torch.cat([sw[1:] != sw[:-1], torch.ones(1, dtype=torch.bool, device=dev)])
    ends_first = torch.argsort((~last).to(torch.int8), stable=True)
    slot = torch.arange(F, device=dev)
    idx_end = torch.where(slot < last.sum(), ends_first, F - 1)
    run_word = sw[idx_end]
    ends = csum[idx_end]
    starts = torch.cat([torch.zeros(1, dtype=ends.dtype, device=dev), ends[:-1]])
    run_val = ends - starts
    ok = run_word < _NO_WORD
    total = torch.sum(torch.where(ok, run_val, 0.0))
    run_val = torch.where(ok, run_val / torch.clamp(total, min=1e-9), 0.0)
    ids = torch.where(ok, run_word, -1)
    if B > F:
        ids = torch.cat([ids, torch.full((B - F,), -1, dtype=ids.dtype, device=dev)])
        run_val = torch.cat([run_val, torch.zeros(B - F, dtype=run_val.dtype, device=dev)])
    return ids[:B].to(torch.int32), run_val[:B].to(torch.float32)


def score_sparse_many(q_ids, q_vals, db_ids, db_vals, n_words: int):
    """L1 score of one sparse query against a [K, B] sparse database.

    For L1-normalized non-negative vectors,
      1 - 0.5*|a-b|_1  =  0.5 * sum_shared (a_i + b_i - |a_i - b_i|),
    so only shared words contribute: scatter the query dense once
    ([n_words + 1] floats), gather it at every stored word id, reduce per
    row.  The scatter is an `index_add_`, unordered on the card: harmless,
    because a query's valid ids are distinct but for `bow_sparse`'s repeats
    of its last word where every feature is valid, which add exactly 0, and
    the pads, which share the dump slot `n_words`, add 0: any order of the
    adds gives the same bits.
    """
    q_ok = q_ids >= 0
    qd = torch.zeros(n_words + 1, dtype=q_vals.dtype, device=q_vals.device)
    qd.index_add_(0, torch.where(q_ok, q_ids, n_words).long(),
                  torch.where(q_ok, q_vals, 0.0))
    ok = db_ids >= 0
    qg = qd[torch.where(ok, db_ids, n_words).long()]
    v = torch.where(ok, db_vals, 0.0)
    contrib = qg + v - torch.abs(qg - v)
    return 0.5 * torch.sum(torch.where(ok, contrib, 0.0), dim=-1)


def load_dbow2_text(path: str, device=None) -> Vocabulary:
    """Load a DBoW2 text-format vocabulary (ORBvoc.txt).

    Parses the exact format of TemplatedVocabulary::loadFromTextFile
    (reference Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1339-1421):
    header "k L scoring weighting", then one BFS-ordered node line
    "parent is_leaf d0..d31 weight".  The tensors land on `device` (the CUDA
    device when None).
    """
    device = resolve_device(device)
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        parents, leaves, descs, weights = [], [], [], []
        for line in f:
            v = line.split()
            if len(v) < 35:
                continue
            parents.append(int(v[0]))
            leaves.append(int(v[1]))
            descs.append([int(x) for x in v[2:34]])
            weights.append(float(v[34]))
    n = len(parents)
    parents_np = np.asarray(parents, np.int64)
    # text file omits the root: node ids are 1-based relative to the file
    children = np.full((n + 1, k), -1, np.int32)
    node_desc = np.zeros((n + 1, 8), np.uint32)
    word_id = np.full(n + 1, -1, np.int32)
    child_count = np.zeros(n + 1, np.int32)
    w_leaf = []
    next_word = 0
    for i in range(n):
        nid = i + 1
        p = parents_np[i]
        if not 0 <= p <= n or child_count[p] >= k:
            raise ValueError(f"{path}: node {nid} names parent {p}, which is out "
                             f"of range or already has {k} children")
        children[p, child_count[p]] = nid
        child_count[p] += 1
        node_desc[nid] = np.packbits(
            np.unpackbits(np.asarray(descs[i], np.uint8))).view(np.uint32)
        if leaves[i]:
            word_id[nid] = next_word
            w_leaf.append(weights[i])
            next_word += 1
    return Vocabulary(
        children=_to_device(children, device),
        node_desc=_to_device(node_desc, device),
        word_id=_to_device(word_id, device),
        word_weight=_to_device(np.asarray(w_leaf, np.float32), device),
        k=k, depth=depth, n_words=next_word,
    )
