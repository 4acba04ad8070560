"""Essential-graph Sim3 pose optimization.

Counterpart of `multi_orb_slam_tpu/optim/pose_graph.py` (which replaces
`Optimizer::OptimizeEssentialGraph`): a Sim3 pose graph over all keyframes
with spanning-tree edges, loop edges and strong-covisibility edges (weight
>= 100 on the camera-0 graph); scale fixed for RGB-D rigs.

Per-edge residuals e = log(S_meas * S_i * S_j^-1) over a fixed-capacity edge
list; per-edge 7x7 Jacobian blocks by forward-mode autodiff through the Sim3
exp / log (`sim3.jacfwd_batched`: one jvp over 14 tangent copies of the
edge batch, which is what `vmap(jacfwd(...))` per edge computes); a dense damped [7K, 7K] normal system solved
with `torch.linalg.solve_ex`.  The blocks are summed into a [K*K, 7, 7] view
and the gradient into [K, 7] as the reference's `.at[].add` sums them,
repeated (i, j) pairs included, but in one fixed order
(`optim/segments.py`): the edge list is fixed over the iterations, so the
stable sorts of the four block indices and of the two gradient indices are
built once before the loop, and each iteration adds each segment's rows in
ascending order, with no atomics.  Padded edges (`e_ok` False) are left out
of the sums, so where they sit does not matter, and two calls on one input
give the same bits on the card.

`optimize_essential_graph` is `graphs.graphed` (`n_iters` and `fix_scale`
static, as the reference's `static_argnums=(6, 7)`): one CUDA graph replay
a call on the card.  `build_essential_edges` pads the edges to `max_edges`,
so every loop replays one entry.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import sim3
from ..utils import graphs, metrics
from .segments import Segments


def edge_residual(g_all: torch.Tensor, xi_all: torch.Tensor, i, j,
                  meas: torch.Tensor) -> torch.Tensor:
    """e = log(meas * S_i * S_j^-1) with S = exp(xi) o g, S_i and S_j taken
    at rows i and j of the last-but-one axis of g_all (..., K, 8) and
    xi_all (..., K, 7)."""
    Si = sim3.compose(sim3.exp(xi_all[..., i, :]), g_all[..., i, :])
    Sj = sim3.compose(sim3.exp(xi_all[..., j, :]), g_all[..., j, :])
    return sim3.log(sim3.compose(meas, sim3.compose(Si, sim3.inverse(Sj))))


@graphs.graphed(static_argnames=("n_iters", "fix_scale"))
def optimize_essential_graph(
    g_init: torch.Tensor,     # [K, 8] Sim3 world->kf per slot
    kf_free: torch.Tensor,    # [K] bool (False = fixed, e.g. the loop KF)
    e_i: torch.Tensor,        # [E] int32 edge endpoints
    e_j: torch.Tensor,        # [E]
    e_meas: torch.Tensor,     # [E, 8] Sim3 measurements S_ji
    e_ok: torch.Tensor,       # [E] bool
    n_iters: int = 20,
    fix_scale: bool = True,
) -> torch.Tensor:
    """Returns optimized [K, 8] Sim3 poses."""
    K, E = g_init.shape[0], e_i.shape[0]
    dev, dtype = g_init.device, g_init.dtype
    dof = sim3.free_scale_mask(fix_scale, dtype, dev)
    ei, ej = e_i.long(), e_j.long()
    w = e_ok.to(dtype)
    # the blocks' rows in the order ii, jj, ij, ji; the gradient's in i, j
    to_H = Segments.of_index(torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei]),
                             K * K, e_ok.repeat(4))
    to_b = Segments.of_index(torch.cat([ei, ej]), K, e_ok.repeat(2))
    free7 = (kf_free[:, None].to(dtype) * dof[None, :]).reshape(K * 7) > 0
    zeros = torch.zeros((E, 14), dtype=dtype, device=dev)

    def r_of(x, gi, gj):
        """Edge residuals [..., E, 7] at the tangents x [..., E, 14] of the
        two endpoints (each edge's two poses as rows 0 and 1)."""
        x2 = x.reshape(x.shape[:-1] + (2, 7))
        return edge_residual(torch.stack([gi, gj], dim=-2), x2 * dof, 0, 1, e_meas)

    def residuals(g_all):
        return r_of(zeros, g_all[ei], g_all[ej])

    g_all = g_init
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)
    for _ in range(n_iters):
        gi, gj = g_all[ei], g_all[ej]
        e0 = r_of(zeros, gi, gj)
        # per-edge 7x14 Jacobian, forward mode
        J = sim3.jacfwd_batched(lambda x: r_of(x, gi, gj), zeros).reshape(E, 7, 2, 7)
        Ji, Jj = J[:, :, 0, :], J[:, :, 1, :]
        JiT, JjT = Ji * w[:, None, None], Jj * w[:, None, None]
        # normal equations over free dofs, as blocks of a [K, K, 7, 7] array
        Hkk = to_H.sum(torch.cat([torch.einsum("eri,erj->eij", JiT, Ji),
                                  torch.einsum("eri,erj->eij", JjT, Jj),
                                  torch.einsum("eri,erj->eij", JiT, Jj),
                                  torch.einsum("eri,erj->eij", JjT, Ji)]))
        b = to_b.sum(torch.cat([torch.einsum("eri,er->ei", JiT, e0),
                                torch.einsum("eri,er->ei", JjT, e0)]))

        Hf = Hkk.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(K * 7, K * 7)
        d = torch.diagonal(Hf)
        Hf = Hf + torch.diag(lam * d + 1e-6)
        Hf = torch.where(free7[:, None] & free7[None, :], Hf, 0.0)
        Hf = Hf + torch.diag(torch.where(free7, 0.0, 1.0))
        rhs = torch.where(free7, b.reshape(K * 7), 0.0)
        dx = -torch.linalg.solve_ex(Hf, rhs)[0]
        dx = torch.where(free7, dx, 0.0).reshape(K, 7) * dof[None, :]

        g_new = sim3.compose(sim3.exp(dx), g_all)
        # accept / reject
        e1 = residuals(g_new)
        c_new = torch.sum(w * torch.sum(e1 * e1, -1))
        c_old = torch.sum(w * torch.sum(e0 * e0, -1))
        accept = c_new < c_old
        g_all = torch.where(accept, g_new, g_all)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
    return g_all


def build_essential_edges(
    covis_w, kf_valid, kf_frame_id, g_old, g_corrected,
    loop_pairs, strong_th: float = 100.0, max_edges: int = 2048,
):
    """Host-side edge assembly (runs once per loop closure).

    Edge set as the reference's (Optimizer.cc:1439-1616):
    - spanning tree: each KF -> best-covisible earlier KF
    - loop pairs (current + accumulated past loop edges)
    - strong covisibility pairs (weight >= strong_th)
    Measurements come from the UNCORRECTED poses except for loop edges and
    edges incident to corrected keyframes, which use the corrected Sim3s (the
    reference's NonCorrectedSim3 / CorrectedSim3 maps): S_ba = P_b * P_a^-1
    with P_k the corrected pose of a corrected keyframe, else its old pose.

    `covis_w`, `kf_valid` and `kf_frame_id` are numpy arrays; `g_old` [K, 8]
    and `g_corrected` = (g_corr [K, 8], corr_mask [K] numpy bool) or None are
    tensors.  Returns (e_i, e_j, meas, ok) tensors on `g_old`'s device.
    """
    covis_w = np.asarray(covis_w)
    kf_valid = np.asarray(kf_valid)
    kf_frame_id = np.asarray(kf_frame_id)
    edges = set()
    valid_ids = np.nonzero(kf_valid)[0]
    order = valid_ids[np.argsort(kf_frame_id[valid_ids])]
    for idx, k in enumerate(order):
        if idx == 0:
            continue
        earlier = order[:idx]
        w = covis_w[k][earlier]
        if w.max() > 0:
            parent = int(earlier[int(w.argmax())])
            edges.add((min(parent, int(k)), max(parent, int(k))))
    for a, b in loop_pairs:
        edges.add((min(a, b), max(a, b)))
    strong = np.argwhere(covis_w >= strong_th)
    for a, b in strong:
        if a < b and kf_valid[a] and kf_valid[b]:
            edges.add((int(a), int(b)))
    edges = sorted(edges)[:max_edges]

    E = max_edges
    dev = g_old.device
    ei = np.zeros(E, np.int32)
    ej = np.zeros(E, np.int32)
    ok = np.zeros(E, bool)
    for n, (a, b) in enumerate(edges):
        ei[n], ej[n], ok[n] = a, b, True
    if g_corrected is None:
        pose = g_old
    else:
        g_corr, corr_mask = g_corrected
        mask = metrics.upload(np.asarray(corr_mask, bool), dev)
        pose = torch.where(mask[:, None], g_corr, g_old)
    ei_t, ej_t = metrics.upload(ei, dev), metrics.upload(ej, dev)
    meas = sim3.compose(pose[ej_t.long()], sim3.inverse(pose[ei_t.long()]))
    ok_t = metrics.upload(ok, dev)
    meas = torch.where(ok_t[:, None], meas, sim3.identity(g_old.dtype, dev))
    return ei_t, ej_t, meas, ok_t
