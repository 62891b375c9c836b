"""Angular-sector culling tables for the dense segment raycast.

Why: on curvy maps (berlin-class) the exact boundary is a staircase of
thousands of tiny segments; per-*tile* culling (segments.py) still leaves
~1.3k segments within lidar reach of every tile, and the dense sweep pays
for ALL of them on EVERY ray. But a single ray only ever hits segments in
its own direction — and lidar beams are sorted by angle, so a contiguous
block of beams spans a narrow angular wedge. This module compiles, per
(map tile, angular sector), the list of segments VISIBLE from anywhere in
the tile in directions within that sector (padded by the beam-block
half-width and by parallax). At scan time each 128-beam block intersects
only its own (tile, sector) list: ~2x fewer pairs/ray for the dense
sweep (max-count bound) and more for the length-sorted sweeps
(mean-count bound, via the per-list real counts in ``meta``).

Semantics: IDENTICAL to the exact `segments` backend — culling is
conservative (a segment is dropped for a block only if no ray of that
block, from any origin in the tile, can point at it). Proof obligation per
segment: the set of directions from origin o to segment points is an arc;
over all o within tile-radius ``rt`` of the tile center it is contained in
the center's arc padded by ``asin(rt / d)`` (d = center-to-segment
distance); blocks assigned to sector s only contain beams within
``block_half`` of a direction inside s. Tested against the geometric
oracle in tests/test_sectors.py.

No reference equivalent (the reference raycaster is a sequential DT march,
SURVEY.md §3.3); this is an acceleration structure in the CDDT lineage
(precompute per-heading structure; arXiv:1705.01167, PAPERS.md),
re-designed as dense lists so the sweep is branch-free vector math.

Host-side init-time NumPy, like the reference's EDT precompute.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .segments import extract_segments, _FAR

_SUB = 8  # capacity quantum of each orientation block (slots)


def _align(n: int, q: int = _SUB) -> int:
    return max(q, ((n + q - 1) // q) * q)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SectorSegmentMap:
    """Per-(tile, sector) culled segment lists (exact-boundary geometry).

    ``table``: (T*NS, 4, K) float32 — rows [p, lo, hi, is_vertical]; each
    list is V-block | H-block, independently padded with never-hit
    sentinels (segments.pad_segments convention) to the static split
    ``kv_sec`` / ``K - kv_sec``.
    ``meta``: (T*NS, 3) int32 — [n_v, h_lo, h_end] real-segment sweep
    bounds per list (V slots [0, n_v), H slots [h_lo, h_end)), a LEAF so
    obstacle rebuilds with different counts reuse compiled sweeps.
    """

    table: Any                       # (T*NS, 4, K)
    meta: Any                        # (T*NS, 3) int32
    n_segments: int
    ns: int = 16                     # angular sectors per full circle
    kv_sec: int = 0                  # static V/H split inside each list
    block_half: float = 0.285        # max supported beam-block half-width
    tile_size: float = 0.0
    tiles_shape: Tuple[int, int] = (0, 0)
    tile_origin: Tuple[float, float] = (0.0, 0.0)
    extent: Tuple[float, float, float, float] = (-_FAR, _FAR, -_FAR, _FAR)
    rt: float = 0.0                  # tile half-diagonal + slack (meters)
    reach: float = 0.0               # max_range + rt (cull distance)

    def tree_flatten(self):
        return (self.table, self.meta, self.n_segments), (
            self.ns, self.kv_sec, self.block_half, self.tile_size,
            self.tiles_shape, self.tile_origin, self.extent, self.rt,
            self.reach)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        table, meta, n = leaves
        ns, kv, bh, ts, tshape, torg, ext, rt, reach = aux
        return cls(table=table, meta=meta, n_segments=n, ns=ns, kv_sec=kv,
                   block_half=bh, tile_size=ts, tiles_shape=tshape,
                   tile_origin=torg, extent=ext, rt=rt, reach=reach)


def _seg_endpoints(segs: np.ndarray):
    p, lo, hi, isv = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3] > 0.5
    ax = np.where(isv, p, lo)
    ay = np.where(isv, lo, p)
    bx = np.where(isv, p, hi)
    by = np.where(isv, hi, p)
    return ax, ay, bx, by


def _seg_point_distance(segs: np.ndarray, cx: float, cy: float):
    p, lo, hi, isv = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3] > 0.5
    along = np.where(isv, cy, cx)
    perp = np.where(isv, cx, cy)
    d_along = np.maximum(np.maximum(lo - along, along - hi), 0.0)
    return np.hypot(d_along, np.abs(perp - p))


def _membership(segs: np.ndarray, nr: int, nc: int, ns: int,
                tile_size: float, ox: float, oy: float, rt: float,
                reach: float, block_half: float) -> np.ndarray:
    """(T*NS, K) bool: conservative visibility of each segment from each
    (tile, sector) cull list — the module-doc proof obligation.

    Fully vectorized over (tiles, segments): the round-2 per-tile Python
    loop took 147 s on berlin-class maps (1024 tiles x 4442 segs); this
    broadcasts the same geometry in ~1 s. float32 throughout (halves the
    working set; the 1e-3 rad safety epsilon in ``pad`` dwarfs f32
    rounding, so the conservative cover is preserved).

    Native tier: ``csrc`` carries the same geometry as
    ``rc_sector_membership`` (double precision — also inside the 1e-3
    margin), cutting the berlin-class build ~3 s -> ~0.3 s; the NumPy
    body below is the always-available fallback and the parity reference
    (tests/test_native.py).
    """
    from .._native import loader as _native
    memb_n = _native.sector_membership(segs, nr, nc, ns, tile_size, ox,
                                       oy, rt, reach, block_half)
    if memb_n is not None:
        return memb_n
    wsec = 2.0 * np.pi / ns
    sec_starts = (np.arange(ns) * wsec).astype(np.float32)
    ax, ay, bx, by = _seg_endpoints(segs)
    f32 = lambda a: np.asarray(a, np.float32)
    ax, ay, bx, by = f32(ax), f32(ay), f32(bx), f32(by)
    cxs = f32(ox + (np.tile(np.arange(nc), nr) + 0.5) * tile_size)   # (T,)
    cys = f32(oy + (np.repeat(np.arange(nr), nc) + 0.5) * tile_size)
    p, slo, shi = f32(segs[:, 0]), f32(segs[:, 1]), f32(segs[:, 2])
    isv = segs[:, 3] > 0.5
    along = np.where(isv[None, :], cys[:, None], cxs[:, None])  # (T, K)
    perp = np.where(isv[None, :], cxs[:, None], cys[:, None])
    d_along = np.maximum(
        np.maximum(slo[None, :] - along, along - shi[None, :]), 0.0)
    d = np.hypot(d_along, np.abs(perp - p[None, :]))
    near = d <= reach
    th1 = np.arctan2(ay[None, :] - cys[:, None], ax[None, :] - cxs[:, None])
    th2 = np.arctan2(by[None, :] - cys[:, None], bx[None, :] - cxs[:, None])
    # short-way arc between endpoint directions (width < pi: the segment
    # lies on one side of any external viewpoint)
    diff = np.mod(th2 - th1, 2.0 * np.pi)
    flip = diff > np.pi
    arc_lo = np.where(flip, th2, th1)
    width = np.where(flip, 2.0 * np.pi - diff, diff)
    par = np.arcsin(np.minimum(1.0, rt / np.maximum(d, 1e-9)))
    pad = par + block_half + 1e-3
    full = (d <= rt) | (width + 2.0 * pad >= 2.0 * np.pi - wsec)
    lo_pad = arc_lo - pad
    span = width + 2.0 * pad
    # sector s = [s*wsec, (s+1)*wsec) intersects the padded arc iff its
    # start lands inside the arc (mod 2pi) or within wsec before it.
    # Looping s keeps peak memory at O(T*K) instead of O(T*K*NS) floats.
    memb = np.empty((ns, nr * nc, len(segs)), bool)
    for s in range(ns):
        rel = np.mod(sec_starts[s] - lo_pad, 2.0 * np.pi)
        memb[s] = ((rel <= span) | (rel >= 2.0 * np.pi - wsec) | full) & near
    return memb.transpose(1, 0, 2).reshape(nr * nc * ns, len(segs))


def add_segments(smap: SectorSegmentMap, new_segs: np.ndarray
                 ) -> SectorSegmentMap:
    """Append boundary segments (e.g. a rasterized obstacle's 4-segment
    box) into the cull lists' headroom slots — O(T x n_new) host geometry
    plus one tiny device scatter per segment, vs the multi-second full
    rebuild. Leaf shapes are UNCHANGED (no retrace).

    Correctness: extra segments are only ever added, never removed, and a
    segment interior to the occupied union is occluded by the union's own
    boundary, so first-hit ranges from free-space origins are EXACTLY those
    of a full rebuild (tests/test_sectors.py::test_incremental_obstacle).

    Raises ValueError when any list's capacity would overflow — the caller
    (simulator facade) falls back to a full rebuild.
    """
    import jax.numpy as jnp
    new_segs = np.atleast_2d(np.asarray(new_segs, np.float64))
    nr, nc = smap.tiles_shape
    ox, oy = smap.tile_origin
    memb = _membership(new_segs, nr, nc, smap.ns, smap.tile_size, ox, oy,
                       smap.rt, smap.reach, smap.block_half)  # (L, n)
    meta = np.asarray(smap.meta)
    kv = smap.kv_sec
    k_tot = smap.table.shape[2]
    counts_v = meta[:, 0].copy()
    counts_h = (meta[:, 2] - meta[:, 1]).copy()
    table = smap.table
    for i, seg in enumerate(new_segs):
        lid = np.where(memb[:, i])[0]
        if len(lid) == 0:
            continue
        if seg[3] > 0.5:
            if (counts_v[lid] >= kv).any():
                raise ValueError(
                    "sector headroom exhausted (V); full rebuild needed")
            slots = counts_v[lid]
            counts_v[lid] += 1
        else:
            if (counts_h[lid] >= k_tot - kv).any():
                raise ValueError(
                    "sector headroom exhausted (H); full rebuild needed")
            slots = kv + counts_h[lid]
            counts_h[lid] += 1
        table = table.at[jnp.asarray(lid), :, jnp.asarray(slots)].set(
            jnp.asarray(seg, jnp.float32))
    meta2 = np.stack([counts_v, np.full(len(meta), kv, counts_v.dtype),
                      kv + counts_h], axis=1).astype(np.int32)
    return dataclasses.replace(
        smap, table=table, meta=jnp.asarray(meta2),
        n_segments=smap.n_segments + len(new_segs))


def build_sector_map(occupancy: np.ndarray, resolution: float,
                     origin_xy=(0.0, 0.0), occupied_thresh: float = 0.5,
                     max_range: float = 10.0, tile_size: float = 2.0,
                     ns: int = 16, block_half: float = 0.285,
                     k_sec: int = 0, kvh=None, headroom: int = 0,
                     real_hw=None) -> SectorSegmentMap:
    """Compile the occupancy boundary into per-(tile, sector) cull lists.

    Args:
      tile_size: spatial tile edge (meters). Smaller tiles shrink the
        parallax pad (tighter lists) but grow the table linearly.
      ns: angular sectors over the full circle.
      block_half: the largest beam-block angular half-width (radians) the
        runtime may use with this map; lists are padded to cover it. The
        default 0.285 covers 128-beam blocks of the flagship 1080-beam /
        270 deg scan (half-width 0.277) with margin.
      k_sec: optional per-orientation capacity override (obstacle-rebuild
        shape stability, cf. segments.build_segment_map k_tile). 0 = auto.
      kvh: optional exact (kv_sec, kh_sec) capacity pair — the obstacle
        add/clear path passes the PREVIOUS map's split so the rebuilt table
        keeps identical leaf shapes (no retrace; simulator._swap_or_rebuild).
        Overrides k_sec. Each entry must be a multiple of 8.
      headroom: extra per-orientation capacity on top of the auto-sized
        need. Capacity is paid DENSELY by the XLA sweep, so the default is
        tight (benchmarks); the interactive facade passes 8 so small
        obstacle additions keep the padded shapes (no retrace).
    """
    segs = extract_segments(occupancy, resolution, origin_xy,
                            occupied_thresh)
    if len(segs) == 0:
        raise ValueError("map has no boundary segments")
    rh, rw = real_hw if real_hw is not None else occupancy.shape
    ox, oy = float(origin_xy[0]), float(origin_xy[1])
    extent = (ox, ox + rw * resolution, oy, oy + rh * resolution)

    h, w = occupancy.shape
    nc = int(np.ceil(w * resolution / tile_size))
    nr = int(np.ceil(h * resolution / tile_size))
    rt = tile_size * np.sqrt(2.0) / 2.0 + 2.0 * resolution
    reach = max_range + rt
    wsec = 2.0 * np.pi / ns

    memb_flat = _membership(segs, nr, nc, ns, tile_size, ox, oy, rt,
                            reach, block_half)
    k_n = len(segs)
    tnl = nr * nc * ns
    isv = segs[:, 3] > 0.5
    counts_v = (memb_flat & isv[None, :]).sum(axis=1)
    counts_h = (memb_flat & ~isv[None, :]).sum(axis=1)

    if kvh is not None:
        kv_sec, kh_sec = int(kvh[0]), int(kvh[1])
        if kv_sec % _SUB or kh_sec % _SUB:
            raise ValueError(f"kvh entries must be multiples of {_SUB}")
    else:
        kv_sec = _align(k_sec // 2 if k_sec > 0
                        else int(counts_v.max()) + headroom)
        kh_sec = _align(k_sec - k_sec // 2 if k_sec > 0
                        else int(counts_h.max()) + headroom)

    table = np.zeros((tnl, kv_sec + kh_sec, 4), np.float32)
    table[:, :, 0] = _FAR     # never-hit sentinel (segments.pad_segments)
    table[:, :, 1] = 1.0
    table[:, :, 2] = -1.0
    table[:, :kv_sec, 3] = 1.0
    for want_v, base, kp, counts in ((True, 0, kv_sec, counts_v),
                                     (False, kv_sec, kh_sec, counts_h)):
        if counts.max() > kp:
            raise ValueError(
                f"k_sec too small: a (tile, sector) list needs "
                f"{int(counts.max())} {'V' if want_v else 'H'} segments but "
                f"the block holds {kp}; raise k_sec or leave it 0 (auto) - "
                "silent truncation would punch invisible holes in walls")
        mo = memb_flat & (isv if want_v else ~isv)[None, :]
        # nonzero is row-major: entries of one list are consecutive and in
        # segs order, so the in-list slot is a per-group arange (a full-rank
        # cumsum over (T*NS, K) took 15 s of the build; this is O(entries))
        lid, kk = np.nonzero(mo)
        starts = np.zeros(tnl, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        table[lid, base + (np.arange(len(lid)) - starts[lid])] = segs[kk]
    meta = np.stack([counts_v, np.full(tnl, kv_sec, counts_v.dtype),
                     kv_sec + counts_h], axis=1).astype(np.int32)

    # contiguous f32 on host BEFORE the device put: a (T*NS, K, 4) f64
    # transpose would cost a 2x transfer + a device-side convert
    table = np.ascontiguousarray(table.transpose(0, 2, 1), np.float32)
    return SectorSegmentMap(
        table=jnp.asarray(table),
        meta=jnp.asarray(meta),
        n_segments=len(segs), ns=ns, kv_sec=kv_sec,
        block_half=float(block_half), tile_size=float(tile_size),
        tiles_shape=(nr, nc), tile_origin=(ox, oy), extent=extent,
        rt=float(rt), reach=float(reach))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class StackedSectorMap:
    """M sector maps stacked for multi-track batched serving: one scan
    call over agents living on DIFFERENT maps (e.g. RL across a track
    distribution). Tables are padded to a common capacity and
    concatenated; per-map tile-grid geometry rides in small per-map leaf
    arrays gathered per agent (O(agents) scalar gathers — noise next to
    the sweep).

    No reference equivalent (the reference holds one map per process).
    """

    table: Any        # (sum_m L_m, 4, K) common capacity
    meta: Any         # (sum_m L_m, 3)
    offsets: Any      # (M,) int32 — row offset of each map's lists
    grids: Any        # (M, 4) f32 — [nr, nc, tox, toy] per map
    extents: Any      # (M, 4) f32 — [x0, x1, y0, y1] per map
    ns: int = 16
    kv_sec: int = 0
    block_half: float = 0.285
    tile_size: float = 0.0

    def tree_flatten(self):
        return (self.table, self.meta, self.offsets, self.grids,
                self.extents), (
            self.ns, self.kv_sec, self.block_half, self.tile_size)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        table, meta, offsets, grids, extents = leaves
        ns, kv, bh, ts = aux
        return cls(table=table, meta=meta, offsets=offsets, grids=grids,
                   extents=extents, ns=ns, kv_sec=kv, block_half=bh,
                   tile_size=ts)


def stack_sector_maps(maps) -> StackedSectorMap:
    """Stack sector maps (same ns/tile_size/block_half; capacities are
    re-padded to the common max) for ``scan_poses_sectors_multi``."""
    import jax.numpy as jnp
    m0 = maps[0]
    for m in maps:
        if (m.ns != m0.ns or m.tile_size != m0.tile_size
                or m.block_half != m0.block_half):
            raise ValueError("stacked maps must share ns/tile_size/"
                             "block_half (rebuild with common settings)")
    kv = max(m.kv_sec for m in maps)
    kh = max(m.table.shape[2] - m.kv_sec for m in maps)
    tables, metas, offsets, grids, extents = [], [], [], [], []
    row = 0
    for m in maps:
        t = np.asarray(m.table)                   # (L, 4, K_m)
        l_m, _, _ = t.shape
        kv_m = m.kv_sec
        kh_m = t.shape[2] - kv_m
        out = np.zeros((l_m, 4, kv + kh), np.float32)
        out[:, 0, :] = _FAR                       # never-hit sentinels
        out[:, 1, :] = 1.0
        out[:, 2, :] = -1.0
        out[:, 3, :kv] = 1.0
        out[:, :, :kv_m] = t[:, :, :kv_m]
        out[:, :, kv:kv + kh_m] = t[:, :, kv_m:]
        meta = np.asarray(m.meta).copy()          # [n_v, h_lo, h_end]
        n_h = meta[:, 2] - meta[:, 1]
        meta[:, 1] = kv
        meta[:, 2] = kv + n_h
        tables.append(out)
        metas.append(meta)
        offsets.append(row)
        row += l_m
        nr, nc = m.tiles_shape
        grids.append((nr, nc, m.tile_origin[0], m.tile_origin[1]))
        extents.append(m.extent)
    return StackedSectorMap(
        table=jnp.asarray(np.concatenate(tables, axis=0)),
        meta=jnp.asarray(np.concatenate(metas, axis=0)),
        offsets=jnp.asarray(np.asarray(offsets, np.int32)),
        grids=jnp.asarray(np.asarray(grids, np.float32)),
        extents=jnp.asarray(np.asarray(extents, np.float32)),
        ns=m0.ns, kv_sec=kv, block_half=m0.block_half,
        tile_size=m0.tile_size)
