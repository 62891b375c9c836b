"""Dense segment-intersection raycast (XLA) — the zero-gather hot path.

Companion to ``maps/segments.py`` (see its module doc for the semantics
contract vs the reference DT march). Each ray's range is the min over all
boundary segments of the exact ray/segment intersection distance — a dense
(rays x segments) elementwise computation + min-reduction with no
gathers, unlike the DT march (``raymarch_xla.py``).

Two variants:
  * ``raycast_all``: every ray against the full padded segment set.
  * ``raycast_tiled``: agents are binned into coarse map tiles; each agent
    block intersects only its tile's culled segment list (built at map
    load). One small row-gather per agent outside the hot loop.

Both are differentiable by plain ``jax.grad``: XLA's autodiff of
``min((p - o)/u)`` yields the exact analytic pose gradient at the hit
segment (the implicit-surface form of SURVEY.md §7 step 5 — for an
axis-aligned hit segment the surface normal is the fixed axis, so autodiff
and the analytic formula coincide).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .raymarch_xla import beam_angles

import numpy as _np

_BIG = _np.float32(3.0e38)  # plain numpy: no device array at import time


def _fit_chunk(k: int, chunk: int) -> int:
    """Largest multiple of 128 <= chunk that divides k (k is 128-aligned)."""
    chunk = min(chunk, k)
    while k % chunk:
        chunk -= 128
    return max(chunk, 128)


def _ray_invs(cos_t, sin_t):
    """Per-ray safe reciprocals, hoisted out of the segment sweep: turns
    the per-(ray,segment) divide into a multiply. A zero direction
    component maps to a NaN reciprocal: t and the hit coordinate become
    NaN and every comparison rejects them (IEEE NaN compares false) — this
    also covers the ray-collinear-with-the-segment-line case, where a huge
    finite reciprocal would still yield t = 0 * huge = 0."""
    nan = jnp.float32(jnp.nan)
    inv_c = jnp.where(cos_t == 0.0, nan, 1.0 / jnp.where(cos_t == 0.0,
                                                         1.0, cos_t))
    inv_s = jnp.where(sin_t == 0.0, nan, 1.0 / jnp.where(sin_t == 0.0,
                                                         1.0, sin_t))
    return inv_c, inv_s


def _min_t_vchunk(p, lo, hi, x, y, sin_t, inv_c):
    """Vertical-only chunk: x = p planes. ~9 vector ops/pair, no orientation
    selects (split layout, maps/segments.py::split_pad_segments)."""
    t = (p - x[..., None]) * inv_c[..., None]
    a = y[..., None] + t * sin_t[..., None]
    valid = (t >= 0.0) & ((a - lo) * (hi - a) >= 0.0)
    return jnp.min(jnp.where(valid, t, _BIG), axis=-1)


def _min_t_hchunk(p, lo, hi, x, y, cos_t, inv_s):
    """Horizontal-only chunk: y = p planes."""
    t = (p - y[..., None]) * inv_s[..., None]
    a = x[..., None] + t * cos_t[..., None]
    valid = (t >= 0.0) & ((a - lo) * (hi - a) >= 0.0)
    return jnp.min(jnp.where(valid, t, _BIG), axis=-1)


def _min_t_split(params, kv, x, y, cos_t, sin_t, inv_c, inv_s, chunk):
    """Min over a split (4, KV+KH) table via orientation-specialized
    chunked sweeps. kv static."""
    best = jnp.full(jnp.shape(x), _BIG)
    for (lo_i, hi_i, fn, d1, d2) in (
            (0, kv, _min_t_vchunk, sin_t, inv_c),
            (kv, params.shape[1], _min_t_hchunk, cos_t, inv_s)):
        n = hi_i - lo_i
        if n <= 0:
            continue
        ck = _fit_chunk(n, chunk)
        blk = params[:, lo_i:hi_i].reshape(4, n // ck, ck)
        blk = blk.transpose(1, 0, 2)

        def body(b, seg, fn=fn, d1=d1, d2=d2):
            t = fn(seg[0], seg[1], seg[2], x, y, d1, d2)
            return jnp.minimum(b, t), None

        best, _ = jax.lax.scan(body, best, blk)
    return best


def _min_t_chunk(seg_chunk, x, y, cos_t, sin_t, inv_c, inv_s, max_range):
    """Min intersection distance over one (4, KC) segment chunk.

    Ray args have any common shape S; returns shape S. The (S..., KC)
    intermediate stays inside one XLA fusion (elementwise -> reduce), so it
    is never materialized in device memory. ~10 vector ops per (ray,
    segment) pair.
    """
    p = seg_chunk[0]
    lo = seg_chunk[1]
    hi = seg_chunk[2]
    isv = seg_chunk[3] > 0.5

    o_perp = jnp.where(isv, x[..., None], y[..., None])
    o_along = jnp.where(isv, y[..., None], x[..., None])
    u_inv = jnp.where(isv, inv_c[..., None], inv_s[..., None])
    u_along = jnp.where(isv, sin_t[..., None], cos_t[..., None])

    t = (p - o_perp) * u_inv
    a = o_along + t * u_along
    inside = (a - lo) * (hi - a) >= 0.0     # NaN-safe: false on NaN
    valid = (t >= 0.0) & inside
    t = jnp.where(valid, t, _BIG)
    return jnp.min(t, axis=-1)


@functools.partial(jax.jit, static_argnames=("chunk", "kv"))
def raycast_all(segment_params, x, y, cos_t, sin_t, max_range=10.0,
                chunk: int = 1024, kv: int = 0):
    """Raycast against the full segment set.

    Args:
      segment_params: (4, K) float32, K lane-aligned (maps/segments.py).
      x, y, cos_t, sin_t: ray origin/direction arrays, any common shape S.
      chunk: static K-chunk size for the min-reduction scan (bounds the
        fused intermediate to |S| * chunk lanes).
      kv: static V/H split point (split_pad_segments layout). 0 = mixed
        layout (orientation selects per pair, ~25% slower).

    Returns:
      ranges, shape S, clamped to max_range.
    """
    inv_c, inv_s = _ray_invs(cos_t, sin_t)
    if kv > 0:
        best = _min_t_split(segment_params, kv, x, y, cos_t, sin_t,
                            inv_c, inv_s, chunk)
        return jnp.minimum(best, max_range)
    k = segment_params.shape[1]
    chunk = _fit_chunk(k, chunk)
    n_chunks = k // chunk
    chunks = segment_params.reshape(4, n_chunks, chunk).transpose(1, 0, 2)

    def body(best, seg_chunk):
        t = _min_t_chunk(seg_chunk, x, y, cos_t, sin_t, inv_c, inv_s,
                         max_range)
        return jnp.minimum(best, t), None

    init = jnp.full(jnp.shape(x), _BIG)
    best, _ = jax.lax.scan(body, init, chunks)
    return jnp.minimum(best, max_range)


@functools.partial(jax.jit, static_argnames=("chunk", "kv_tile"))
def raycast_tiled(tiles, tiles_shape, tile_size, tile_origin,
                  x0, y0, x, y, cos_t, sin_t, max_range=10.0,
                  chunk: int = 512, kv_tile: int = 0):
    """Raycast with per-agent tile culling.

    Args:
      tiles: (T, 4, K_tile) per-tile culled segment lists.
      tiles_shape: (rows, cols) of the tile grid (python ints).
      tile_size, tile_origin: tile geometry (meters).
      x0, y0: agent positions, shape (A,) — used only for tile lookup.
      x, y, cos_t, sin_t: ray arrays of shape (A, B).

    Returns:
      ranges (A, B).
    """
    nr, nc = tiles_shape
    tox, toy = tile_origin
    ci = jnp.clip(((x0 - tox) / tile_size).astype(jnp.int32), 0, nc - 1)
    ri = jnp.clip(((y0 - toy) / tile_size).astype(jnp.int32), 0, nr - 1)
    tid = ri * nc + ci
    agent_segs = jnp.take(tiles, tid, axis=0)      # (A, 4, K_tile)

    inv_c, inv_s = _ray_invs(cos_t, sin_t)

    if kv_tile > 0:
        best = jnp.full(jnp.shape(x), _BIG)
        for (lo_i, hi_i, vertical) in (
                (0, kv_tile, True), (kv_tile, tiles.shape[2], False)):
            n = hi_i - lo_i
            if n <= 0:
                continue
            ck = _fit_chunk(n, chunk)
            blk = agent_segs[:, :, lo_i:hi_i].reshape(
                x0.shape[0], 4, n // ck, ck).transpose(2, 0, 1, 3)

            def body(b, seg, vertical=vertical):
                p = seg[:, 0][:, None, :]
                lo = seg[:, 1][:, None, :]
                hi = seg[:, 2][:, None, :]
                if vertical:
                    t = (p - x[..., None]) * inv_c[..., None]
                    a = y[..., None] + t * sin_t[..., None]
                else:
                    t = (p - y[..., None]) * inv_s[..., None]
                    a = x[..., None] + t * cos_t[..., None]
                valid = (t >= 0.0) & ((a - lo) * (hi - a) >= 0.0)
                return jnp.minimum(
                    b, jnp.min(jnp.where(valid, t, _BIG), axis=-1)), None

            best, _ = jax.lax.scan(body, best, blk)
        return jnp.minimum(best, max_range)

    k = tiles.shape[2]
    chunk = _fit_chunk(k, chunk)
    n_chunks = k // chunk
    # (A, 4, K) -> (n_chunks, A, 4, chunk) for the reduction scan
    ch = agent_segs.reshape(x0.shape[0], 4, n_chunks, chunk)
    ch = ch.transpose(2, 0, 1, 3)

    def body(best, seg_chunk):
        # seg_chunk: (A, 4, chunk); rays (A, B): broadcast per-agent params
        p = seg_chunk[:, 0][:, None, :]
        lo = seg_chunk[:, 1][:, None, :]
        hi = seg_chunk[:, 2][:, None, :]
        isv = seg_chunk[:, 3][:, None, :] > 0.5
        o_perp = jnp.where(isv, x[..., None], y[..., None])
        o_along = jnp.where(isv, y[..., None], x[..., None])
        u_inv = jnp.where(isv, inv_c[..., None], inv_s[..., None])
        u_along = jnp.where(isv, sin_t[..., None], cos_t[..., None])
        t = (p - o_perp) * u_inv
        a = o_along + t * u_along
        inside = (a - lo) * (hi - a) >= 0.0
        valid = (t >= 0.0) & inside
        t = jnp.where(valid, t, _BIG)
        return jnp.minimum(best, jnp.min(t, axis=-1)), None

    init = jnp.full(jnp.shape(x), _BIG)
    best, _ = jax.lax.scan(body, init, ch)
    return jnp.minimum(best, max_range)


def scan_poses_segments(segmap, poses, num_beams: int = 1080,
                        fov: float = 4.712388980384690, max_range=10.0,
                        theta_discretization: int = 0,
                        use_tiles: bool = True) -> jnp.ndarray:
    """Full lidar scans for poses (..., 3) via the segment backend."""
    from .common import rays_from_poses, apply_extent_mask
    batch, poses2, xb, yb, ct, st = rays_from_poses(
        poses, num_beams, fov, theta_discretization)
    # The *_diff variants carry an analytic O(rays) VJP (raycast_grad.py);
    # values are identical to raycast_all/raycast_tiled.
    from .raycast_grad import raycast_all_diff, raycast_tiled_diff
    if use_tiles and segmap.tiles is not None:
        r = raycast_tiled_diff(segmap.tiles, segmap.tiles_shape,
                               segmap.tile_size, segmap.tile_origin,
                               poses2[:, 0], poses2[:, 1], xb, yb, ct, st,
                               max_range, 512, getattr(segmap, "kv_tile", 0))
    else:
        r = raycast_all_diff(segmap.params, xb, yb, ct, st, max_range,
                             1024, getattr(segmap, "kv", 0))
    r = apply_extent_mask(r, poses2[:, 0], poses2[:, 1], segmap.extent,
                          max_range)
    return r.reshape(*batch, num_beams)
