"""Collective hooks (``unclerenderer_tpu/parallel/dist.py``): one deferred
frame body runs on one device or over a row-sharded process group.

Each rank owns a horizontal slab of the viewport.  Everything in the frame
that depends on the slab goes through this interface, so
``render/deferred.py`` holds the only lighting and post implementation:

* ``SingleChip``: identity hooks (the default); the frame computes what it
  computes without them, with the same kernel launches.
* ``RowShards``: ``torch.distributed`` collectives over a process group --
  an all-gather of rows for the shadow map and the HZB's source depth, a sum
  for the auto-exposure grid and the counters, and the slab neighbours'
  edge rows for the TAA/CAS neighbourhoods and the forward-difference LOD at
  the seams.

The halo rows travel by all-gather, not by point-to-point sends: gloo's
send and recv take no CUDA tensors and NCCL refuses two ranks on one card,
while every backend all-gathers and all-reduces.  Over gloo a CUDA tensor
is staged through host memory (a copy each way; the values are unchanged).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.post import edge_pad


class SingleChip:
    """Trivial hooks: the whole frame is one slab."""

    n_dev = 1
    rank = 0

    def __init__(self, height: int):
        self.slab_h = height
        self.row0 = 0

    def all_gather_rows(self, x):
        return x

    def psum(self, x):
        return x

    def halo2d(self, img):
        """(H, W, C) -> (H+2, W+2, C), edge-padded: the single-device
        TAA/CAS border."""
        return edge_pad(img)

    def row_below(self, img):
        """(H, W, ...) -> (1, W, ...): the row just below the slab,
        edge-replicated at the frame's bottom (the forward-difference
        neighbour of the texture LOD)."""
        return img[-1:]

    def row_above(self, img):
        """As ``row_below``: the row just above, edge-replicated at the top."""
        return img[:1]


class RowShards:
    """Hooks for a process group whose rank r owns viewport rows
    ``[r * slab_h, (r + 1) * slab_h)``, ``slab_h = height // world size``
    (and ``shadow_map_size // world size`` light-space rows in the shadow
    raster).  ``group`` None is the default group."""

    def __init__(self, group, height: int):
        self.group = group
        self.n_dev = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if height % self.n_dev:
            raise ValueError(f"height {height} must divide over {self.n_dev} ranks")
        self.slab_h = height // self.n_dev
        self.row0 = self.rank * self.slab_h
        self._staged = dist.get_backend(group) == "gloo"

    def _stage(self, x):
        """The tensor the backend takes: gloo gets CUDA tensors via host
        memory."""
        x = x.contiguous()
        return x.cpu() if self._staged and x.is_cuda else x

    def _all_gather(self, x):
        """(rows, ...) on each rank -> (n_dev, rows, ...), rank order."""
        src = self._stage(x)
        parts = [torch.empty_like(src) for _ in range(self.n_dev)]
        dist.all_gather(parts, src, group=self.group)
        return torch.stack(parts).to(x.device)

    def all_gather_rows(self, x):
        g = self._all_gather(x)
        return g.reshape((g.shape[0] * g.shape[1],) + g.shape[2:])

    def psum(self, x):
        y = self._stage(x).clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y.to(x.device)

    def row_halo(self, img):
        """``(row_above(img), row_below(img))``: the neighbours' edge rows
        from one all-gather of every rank's first and last row, this
        slab's own edge row at the frame's top and bottom."""
        edges = self._all_gather(torch.cat([img[:1], img[-1:]]))  # (n_dev, 2, W, ...)
        above = img[:1] if self.rank == 0 else edges[self.rank - 1, 1:2]
        below = img[-1:] if self.rank == self.n_dev - 1 else edges[self.rank + 1, 0:1]
        return above, below

    def halo2d(self, img):
        """(Hs, W, C) -> (Hs+2, W+2, C): the neighbours' edge rows above and
        below (edge rows at the frame's top and bottom), then edge-padded
        columns, as the single-device border."""
        above, below = self.row_halo(img)
        rows = torch.cat([above, img, below])
        return torch.cat([rows[:, :1], rows, rows[:, -1:]], dim=1)

    def row_below(self, img):
        return self.row_halo(img)[1]

    def row_above(self, img):
        return self.row_halo(img)[0]
