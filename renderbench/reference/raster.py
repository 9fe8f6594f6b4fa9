"""The reference's triangle raster, in float64: for every pixel centre the
nearest covering triangle, by a plain walk over each triangle's bounding
box.

Conventions of the D3D12 renderer (and of any D3D rasterizer): pixel
centres at (x + 0.5, y + 0.5) with y down, clockwise front faces, the
top-left fill rule, clipless homogeneous edge functions (so triangles
that cross the camera plane need no clipping), a depth in [0, 1] and
ties of depth resolved to the lowest triangle id.  The camera pass keeps
front faces and the largest depth (reverse Z); the shadow pass keeps back
faces and the smallest depth (an orthographic light, cleared to 1).
"""

from __future__ import annotations

import torch

F64 = torch.float64
ID_NONE = torch.iinfo(torch.int64).max
PAIR_BUDGET = 1 << 22  # (pixel, triangle) pairs evaluated at once


class Triangles:
    """Per-triangle homogeneous pixel vertices: ``X``, ``Y`` (pixel x and y
    times clip w), ``W`` (clip w) and ``Z`` (clip z), each (T, 3) float64."""

    def __init__(self, clip: torch.Tensor, width: int, height: int):
        """``clip`` (T, 3, 4): the triangles' clip coordinates."""
        x, y, z, w = clip.unbind(-1)
        self.X = (x * 0.5 + w * 0.5) * width
        self.Y = (w * 0.5 - y * 0.5) * height
        self.W, self.Z = w, z
        self.width, self.height = width, height

    def edges(self, ids: torch.Tensor | None = None):
        """Edge functions (a, b, c), each (n, 3): e_k(X, Y) = a_k X + b_k Y +
        c_k is the cross product of the two vertices other than k."""
        X, Y, W = ((t if ids is None else t[ids]) for t in (self.X, self.Y, self.W))
        i, j = [1, 2, 0], [2, 0, 1]
        a = Y[:, i] * W[:, j] - W[:, i] * Y[:, j]
        b = W[:, i] * X[:, j] - X[:, i] * W[:, j]
        c = X[:, i] * Y[:, j] - Y[:, i] * X[:, j]
        return a, b, c


def _boxes(tri: Triangles, draw: torch.Tensor):
    """Each drawn triangle's inclusive pixel box (x0, y0, x1, y1), the
    whole viewport where a vertex is at or behind the camera plane; a box
    off the viewport draws nothing."""
    wmax, hmax = tri.width - 1, tri.height - 1
    behind = (tri.W <= 1e-9).any(dim=1)
    ws = torch.where(tri.W > 1e-9, tri.W, torch.ones_like(tri.W))
    sx, sy = tri.X / ws, tri.Y / ws
    x0 = torch.where(behind, 0.0, torch.floor(sx.amin(1)))
    y0 = torch.where(behind, 0.0, torch.floor(sy.amin(1)))
    x1 = torch.where(behind, float(wmax), torch.ceil(sx.amax(1)))
    y1 = torch.where(behind, float(hmax), torch.ceil(sy.amax(1)))
    on = (x1 >= 0) & (y1 >= 0) & (x0 <= wmax) & (y0 <= hmax)
    box = [x0.clamp(0, wmax), y0.clamp(0, hmax), x1.clamp(0, wmax), y1.clamp(0, hmax)]
    return [b.to(torch.int64) for b in box], draw & on


def covered_pairs(tri: Triangles, draw: torch.Tensor, front: bool):
    """Yield, in batches, the (pixel, triangle) pairs that the triangles in
    ``draw`` cover with a depth in [0, 1]: (triangle ids, pixel x, pixel
    y, the three signed edge values (n, 3), depth).  ``front`` keeps
    clockwise (front) faces, else counter-clockwise (back) ones."""
    a, b, c = tri.edges()
    p0 = torch.stack([tri.X[:, 0], tri.Y[:, 0], tri.W[:, 0]], dim=1)
    det = a[:, 0] * p0[:, 0] + b[:, 0] * p0[:, 1] + c[:, 0] * p0[:, 2]
    keep = (det < 0) if front else (det > 0)
    sign = -1.0 if front else 1.0
    (x0, y0, x1, y1), keep = _boxes(tri, draw & keep)
    ids = keep.nonzero(as_tuple=True)[0]
    bw = (x1 - x0 + 1)[ids]
    area = bw * (y1 - y0 + 1)[ids]
    ends = torch.cumsum(area, 0)
    dev = tri.X.device
    start = 0
    while start < ids.shape[0]:
        base = int(ends[start - 1]) if start else 0
        stop = int(torch.searchsorted(ends, base + PAIR_BUDGET, right=True))
        stop = max(stop, start + 1)
        t_loc = torch.repeat_interleave(torch.arange(start, stop, device=dev),
                                        area[start:stop])
        first = torch.cumsum(area[start:stop], 0) - area[start:stop]
        local = torch.arange(t_loc.shape[0], device=dev) - first[t_loc - start]
        t = ids[t_loc]
        px = x0[t] + local % bw[t_loc]
        py = y0[t] + torch.div(local, bw[t_loc], rounding_mode="floor")
        qx, qy = px.to(F64) + 0.5, py.to(F64) + 0.5
        ea, eb, ec = a[t] * sign, b[t] * sign, c[t] * sign
        e = ea * qx[:, None] + eb * qy[:, None] + ec
        top_left = (ea > 0) | ((ea == 0) & (eb > 0))
        inside = ((e > 0) | ((e == 0) & top_left)).all(dim=1)
        nz = (e * tri.Z[t]).sum(1)
        nw = (e * tri.W[t]).sum(1)
        depth = nz / torch.where(nw != 0, nw, torch.ones_like(nw))
        ok = inside & (nw > 0) & (depth >= 0) & (depth <= 1)
        k = ok.nonzero(as_tuple=True)[0]
        yield t[k], px[k], py[k], e[k], depth[k]
        start = stop


class DepthBuffer:
    """Per pixel the nearest depth so far and the lowest triangle id at it
    (``nearest``: "max", reverse Z, cleared to -1 = empty; "min", cleared
    to 1)."""

    def __init__(self, width: int, height: int, nearest: str, device, ids: bool = True):
        self.width, self.nearest = width, nearest
        clear = -1.0 if nearest == "max" else 1.0
        self.depth = torch.full((height * width,), clear, dtype=F64, device=device)
        self.ids = (torch.full((height * width,), ID_NONE, dtype=torch.int64, device=device)
                    if ids else None)

    def add(self, t, px, py, depth) -> None:
        pix = py * self.width + px
        if self.nearest == "max":
            best = self.depth.scatter_reduce(0, pix, depth, "amax", include_self=True)
        else:
            best = self.depth.scatter_reduce(0, pix, depth, "amin", include_self=True)
        if self.ids is not None:
            at = depth == best[pix]
            cand = torch.full_like(self.ids, ID_NONE).scatter_reduce(
                0, pix[at], t[at], "amin", include_self=True)
            kept = torch.where(best == self.depth, self.ids, torch.full_like(self.ids, ID_NONE))
            self.ids = torch.minimum(kept, cand)
        self.depth = best

    def images(self, height: int):
        """(depth (H, W), ids (H, W) with -1 where empty)."""
        d = self.depth.reshape(height, self.width)
        if self.ids is None:
            return d, None
        ids = torch.where(self.ids == ID_NONE, torch.full_like(self.ids, -1), self.ids)
        return d, ids.reshape(height, self.width)
