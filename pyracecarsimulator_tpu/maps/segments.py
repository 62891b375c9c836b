"""Occupancy-boundary segment extraction ("compiled geometry").

Performance layer with no reference equivalent (SURVEY.md §2b/§7 "hard
parts": the DT march is a chain of dependent gathers per ray). The
alternative is to *compile the map into geometry once at load time*: the
boundary of the occupied-cell union is an axis-aligned polygon set;
raycasting against its segments is dense, branch-free vector math with
zero gathers in the hot loop. (Same family as CDDT's observation that
occupancy-grid raycasts should be precomputed into compressed geometric
structure, arXiv:1705.01167 / PAPERS.md — here the "compression" is exact
boundary geometry and the query is a dense min-reduction instead of a LUT
walk.) Which of the two is faster on the card is not measured yet.

Semantics contract (tested in tests/test_segments.py):
  * The segment raycast computes the EXACT first intersection of the ray
    with the occupied-cell union boundary (t*).
  * The reference DT sphere-trace terminates one sample inside the first
    occupied cell it reaches, so its range T satisfies
    ``t* <= T <= t* + O(resolution)`` (it never undershoots the boundary by
    more than float round-off, and overshoots by at most ~the cell
    diagonal). The segment backend is therefore reference-allclose at
    tolerance ~2 cells, and exactly matches the *geometry* oracle at 1e-5.

Everything here is host-side init-time NumPy (like the reference's EDT
precompute); outputs are padded, lane-aligned device arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import jax
import jax.numpy as jnp

_LANE = 128
# Segment params are packed as 4 rows: [p (fixed coord), lo, hi, is_vertical]
# Vertical segment:   x = p, y in [lo, hi]
# Horizontal segment: y = p, x in [lo, hi]


def _merge_runs(mask_2d: np.ndarray):
    """Given a boolean edge mask (rows = fixed index, cols = run axis),
    return (fixed_idx, start, stop) arrays of maximal consecutive runs."""
    h, w = mask_2d.shape
    padded = np.zeros((h, w + 2), dtype=bool)
    padded[:, 1:-1] = mask_2d
    d = np.diff(padded.astype(np.int8), axis=1)
    fi_s, starts = np.where(d == 1)
    fi_e, stops = np.where(d == -1)
    # starts/stops are aligned per row by construction
    return fi_s, starts, stops


def extract_segments(occupancy: np.ndarray, resolution: float,
                     origin_xy=(0.0, 0.0), occupied_thresh: float = 0.5
                     ) -> np.ndarray:
    """Extract merged axis-aligned boundary segments in world coordinates.

    occupancy: (H, W) array; cell (i, j) spans world
    [ox + j*res, ox + (j+1)*res] x [oy + i*res, oy + (i+1)*res].

    Returns (K, 4) float64: [p, lo, hi, is_vertical]; every segment has a
    free cell on one side and an occupied cell (or nothing, at array edges)
    on the other.
    """
    occ = np.asarray(occupancy) >= occupied_thresh
    h, w = occ.shape
    ox, oy = float(origin_xy[0]), float(origin_xy[1])
    segs = []

    # Vertical edges between columns j-1 and j (boundary at x = j):
    # occupancy changes along x. Include outer array edges.
    occ_x = np.zeros((h, w + 1), dtype=bool)
    occ_x[:, :] = np.diff(
        np.concatenate([np.zeros((h, 1), bool), occ,
                        np.zeros((h, 1), bool)], axis=1), axis=1) != 0
    # For merging, runs go along y for each fixed x-boundary -> transpose.
    fi, st, sp = _merge_runs(occ_x.T)   # fi = x boundary index, runs over y
    for x_idx, y0, y1 in zip(fi, st, sp):
        segs.append((ox + x_idx * resolution,
                     oy + y0 * resolution,
                     oy + y1 * resolution, 1.0))

    # Horizontal edges between rows i-1 and i (boundary at y = i).
    occ_y = np.diff(
        np.concatenate([np.zeros((1, w), bool), occ,
                        np.zeros((1, w), bool)], axis=0), axis=0) != 0
    fi, st, sp = _merge_runs(occ_y)     # fi = y boundary index, runs over x
    for y_idx, x0, x1 in zip(fi, st, sp):
        segs.append((oy + y_idx * resolution,
                     ox + x0 * resolution,
                     ox + x1 * resolution, 0.0))

    if not segs:
        return np.zeros((0, 4), np.float64)
    return np.asarray(segs, np.float64)


# Sentinel placement for padding segments: far away so they never intersect.
_FAR = 1.0e9


def pad_segments(segs: np.ndarray, align: int = _LANE) -> np.ndarray:
    """Pad segment count to a lane multiple with never-hit sentinels.

    Sentinel = empty run interval (lo > hi) at ``p = _FAR``. The empty
    interval alone is NOT sufficient: the hot paths test it in product form
    ``(a - lo)*(hi - a) >= 0``, which a reversed interval passes for
    a in [hi, lo] — with p = 0 that made a phantom wall at the origin
    (latent until a map left the origin region reachable). Placing the
    plane at _FAR makes any "hit" land at t >~ 1e9 (clamped by max_range)
    or t < 0 (rejected), independent of the interval test's form.
    """
    k = len(segs)
    kp = max(align, ((k + align - 1) // align) * align)
    out = np.zeros((kp, 4), np.float64)
    out[:, 0] = _FAR
    out[:, 1] = 1.0    # lo
    out[:, 2] = -1.0   # hi  -> empty interval
    out[:, 3] = 1.0
    out[:k] = segs
    return out


def split_pad_segments(segs: np.ndarray, align: int = _LANE):
    """Sort verticals first, pad EACH group to a lane multiple.

    Returns (params (4, KV+KH), KV, KH). Splitting lets raycast kernels
    run two orientation-specialized sweeps with zero per-pair
    ``is_vertical`` selects (~25% fewer vector ops per pair).
    """
    v = segs[segs[:, 3] > 0.5] if len(segs) else segs
    h = segs[segs[:, 3] <= 0.5] if len(segs) else segs
    pv = pad_segments(v, align)
    ph = pad_segments(h, align)
    ph[:, 3] = 0.0
    return np.concatenate([pv, ph], axis=0).T, len(pv), len(ph)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SegmentMap:
    """Device-resident compiled geometry for the dense raycast backend.

    ``params``: (4, K) float32 — rows [p, lo, hi, is_vertical], transposed
    so the segment axis is the minor axis.
    ``tiles``: optional culling table, (T, 4, K_tile) float32 — per coarse
    map tile, the (padded) segments within ``max_range`` of that tile.
    """

    params: Any
    n_segments: int
    tiles: Any = None
    tile_size: float = 0.0           # meters (static)
    tiles_shape: Tuple[int, int] = (0, 0)  # (rows, cols) of the tile grid
    tile_origin: Tuple[float, float] = (0.0, 0.0)
    # Real map extent (x0, x1, y0, y1): poses outside return max_range, the
    # reference's immediate out-of-map behavior (oracle trace_ray).
    extent: Tuple[float, float, float, float] = (
        -_FAR, _FAR, -_FAR, _FAR)
    # V/H split points (static): params[:, :kv] are vertical segments,
    # params[:, kv:] horizontal; likewise kv_tile inside each tile block.
    # 0 = unsorted legacy layout (orientation read from row 3).
    kv: int = 0
    kv_tile: int = 0

    def tree_flatten(self):
        # n_segments rides as a LEAF: it changes on obstacle rebuilds
        # while padded shapes usually don't - keeping it out of the aux
        # data keeps the jit cache key stable (no recompiles per obstacle).
        return (self.params, self.tiles, self.n_segments), (
            self.tile_size, self.tiles_shape,
            self.tile_origin, self.extent, self.kv, self.kv_tile)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        params, tiles, n = leaves
        ts, tshape, torg, ext, kv, kvt = aux
        return cls(params=params, tiles=tiles, n_segments=n, tile_size=ts,
                   tiles_shape=tshape, tile_origin=torg, extent=ext,
                   kv=kv, kv_tile=kvt)


def _segment_tile_distance(segs: np.ndarray, cx, cy) -> np.ndarray:
    """Distance from point (cx, cy) to each axis-aligned segment."""
    p, lo, hi, isv = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3]
    # along = coordinate along the run axis, perp = fixed-coord axis
    along = np.where(isv > 0.5, cy, cx)
    perp = np.where(isv > 0.5, cx, cy)
    d_along = np.maximum(np.maximum(lo - along, along - hi), 0.0)
    d_perp = np.abs(perp - p)
    return np.hypot(d_along, d_perp)


def build_segment_map(occupancy: np.ndarray, resolution: float,
                      origin_xy=(0.0, 0.0), occupied_thresh: float = 0.5,
                      max_range: float = 10.0, tile_size: float = 0.0,
                      k_tile: int = 0, real_hw=None) -> SegmentMap:
    """Extract boundary segments and (optionally) build per-tile cull lists.

    With ``tile_size > 0``, the map is covered by square tiles; each tile
    stores (padded to ``k_tile``, lane-aligned) the segments whose distance
    to the tile center is below ``max_range + tile_diag/2``. At scan time an
    agent only intersects its tile's list — the work per ray drops from K
    to K_tile with zero hot-loop gathers (one tile row is dynamically
    sliced per agent block).
    """
    segs = extract_segments(occupancy, resolution, origin_xy,
                            occupied_thresh)
    # Always the split layout (V block | H block, each padded): it drops
    # the per-pair orientation selects, and the mixed layout's selects
    # made XLA's GPU compiler take minutes on a 4096x1080 scan (levine:
    # 354 s to compile vs 0.6 s split, H100, PERF.md)
    padded_T, kv, _ = split_pad_segments(segs)
    out_params = jnp.asarray(padded_T, jnp.float32)  # (4, KV+KH)
    rh, rw = real_hw if real_hw is not None else occupancy.shape
    ox0, oy0 = float(origin_xy[0]), float(origin_xy[1])
    extent = (ox0, ox0 + rw * resolution, oy0, oy0 + rh * resolution)

    tiles = None
    tiles_shape = (0, 0)
    tile_origin = (0.0, 0.0)
    if tile_size > 0.0 and len(segs):
        h, w = occupancy.shape
        ox, oy = float(origin_xy[0]), float(origin_xy[1])
        ext_x, ext_y = w * resolution, h * resolution
        nc = int(np.ceil(ext_x / tile_size))
        nr = int(np.ceil(ext_y / tile_size))
        reach = max_range + tile_size * np.sqrt(2) / 2 + resolution
        lists = []
        sel_idx = []
        for r in range(nr):
            for c in range(nc):
                cx = ox + (c + 0.5) * tile_size
                cy = oy + (r + 0.5) * tile_size
                d = _segment_tile_distance(segs, cx, cy)
                idx = np.where(d <= reach)[0]
                sel_idx.append(idx)
        # split every tile into V|H sub-blocks with GLOBAL padded sizes
        def _pad_group(group, kp):
            if len(group) > kp:
                raise ValueError(
                    f"k_tile too small: a tile needs {len(group)} segments "
                    f"but the block holds {kp}; raise k_tile or leave it 0 "
                    "(auto-size) - silent truncation would punch invisible "
                    "holes in walls")
            block = np.zeros((kp, 4), np.float64)
            block[:, 0] = _FAR   # see pad_segments: product-form safety
            block[:, 1] = 1.0
            block[:, 2] = -1.0
            block[: len(group)] = group
            return block
        kv_needed = kh_needed = 0
        groups = []
        for idx in sel_idx:
            sub = segs[idx]
            v = sub[sub[:, 3] > 0.5]
            h = sub[sub[:, 3] <= 0.5]
            groups.append((v, h))
            kv_needed = max(kv_needed, len(v))
            kh_needed = max(kh_needed, len(h))
        a = lambda n: max(_LANE, ((n + _LANE - 1) // _LANE) * _LANE)
        kv_t, kh_t = a(kv_needed), a(kh_needed)
        if k_tile > 0:
            kv_t = kh_t = a(k_tile // 2)
        for v, h in groups:
            bv = _pad_group(v, kv_t)
            bv[:, 3] = 1.0
            bh = _pad_group(h, kh_t)
            bh[:, 3] = 0.0
            lists.append(np.concatenate([bv, bh], axis=0).T)
        kv_tile = kv_t
        tiles = jnp.asarray(np.stack(lists), jnp.float32)
        tiles_shape = (nr, nc)
        tile_origin = (ox, oy)
        if tiles.shape[2] >= out_params.shape[1]:
            # culling buys nothing (every tile sees ~the whole set) and the
            # per-agent tile gather costs ~40%: use the full-set path
            tiles = None
            tiles_shape = (0, 0)
            kv_tile = 0
    else:
        kv_tile = 0

    return SegmentMap(params=out_params, n_segments=len(segs), tiles=tiles,
                      tile_size=float(tile_size), tiles_shape=tiles_shape,
                      tile_origin=tile_origin, extent=extent,
                      kv=kv, kv_tile=kv_tile)


def raycast_segments_numpy(segs: np.ndarray, x, y, cos_t, sin_t,
                           max_range: float) -> np.ndarray:
    """Exact geometric oracle: first-hit distance per ray (vectorized).

    segs: (K, 4) [p, lo, hi, is_vertical]; ray args broadcastable 1D.
    """
    x = np.atleast_1d(np.asarray(x, np.float64))
    y, cos_t, sin_t = (np.broadcast_to(np.asarray(a, np.float64), x.shape)
                       for a in (y, cos_t, sin_t))
    p, lo, hi, isv = (segs[:, i] for i in range(4))
    isv = isv > 0.5
    o_perp = np.where(isv, x[:, None], y[:, None])
    o_along = np.where(isv, y[:, None], x[:, None])
    u_perp = np.where(isv, cos_t[:, None], sin_t[:, None])
    u_along = np.where(isv, sin_t[:, None], cos_t[:, None])
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (p[None, :] - o_perp) / u_perp
    a = o_along + t * u_along
    valid = (t >= 0.0) & (a >= lo[None, :]) & (a <= hi[None, :]) \
        & np.isfinite(t)
    t = np.where(valid, t, np.inf)
    return np.minimum(t.min(axis=1), max_range)
