"""Row sums into segments in one fixed order: the solvers' `.at[].add`.

The JAX package sums the global BA's and the essential graph's blocks with
`.at[].add`.  `index_add_` would do the same here, but on the card it adds
with atomics, in an order that changes from call to call, so two calls on
one input could part in the last bits and, through the loop stage, a whole
run could part.  A `Segments` fixes the order instead: built once per
solve from the rows' segment index (a stable sort of it and each segment's
offsets), it sums the rows of each segment in ascending row order, as the
CPU's `index_add_` does, with `torch.segment_reduce` (one thread per
segment and component on the card, rows added one after the other; no
atomics, no host read, capturable in a CUDA graph).  Rows left out (`keep`
False) are rows whose terms are zero: they are dropped, not added.

Where the rows are whole equal blocks in segment order (the global BA's
[K, C, F] observation grid onto its K poses), `Segments.blocks` sums each
block with `sum(1)` over a [n, block, ...] view: a reduction whose order is
fixed by the shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Segments(NamedTuple):
    """How N rows sum into `n` segments.

    `index` [N] is each row's segment (`n` for a row left out); `order` [N]
    the rows sorted by segment, each segment's rows in ascending order;
    `offsets` [n + 1] where segment s starts in `order` (rows from
    `offsets[n]` on are left out).  `block` > 0 marks the block form: row r
    in segment r // block, and the three tensors None."""

    index: torch.Tensor | None
    order: torch.Tensor | None
    offsets: torch.Tensor | None
    n: int
    block: int = 0

    @staticmethod
    def of_index(index: torch.Tensor, n: int, keep: torch.Tensor | None = None) -> "Segments":
        """Rows into segments `index` [N] (0 <= index < n where `keep`)."""
        key = index.long() if keep is None else torch.where(keep, index.long(), n)
        order = torch.sort(key, stable=True).indices
        offsets = torch.searchsorted(key[order], torch.arange(n + 1, device=key.device))
        return Segments(key, order, offsets, n)

    @staticmethod
    def blocks(n: int, block: int) -> "Segments":
        """Rows [s * block, (s + 1) * block) into segment s, for s < n."""
        return Segments(None, None, None, n, block)

    def sum(self, v: torch.Tensor) -> torch.Tensor:
        """[N, ...] rows -> [n, ...] segment sums."""
        if self.block:
            return v.reshape((self.n, self.block) + v.shape[1:]).sum(1)
        rows = v.reshape(v.shape[0], -1)[self.order]
        out = torch.segment_reduce(rows, "sum", offsets=self.offsets, unsafe=True)
        return out.reshape((self.n,) + v.shape[1:])
