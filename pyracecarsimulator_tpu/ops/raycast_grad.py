"""Analytic custom-VJP segment raycast — O(rays) backward pass.

Plain autodiff of the dense min-intersection (raycast_segments.py) replays
the full (rays x segments) comparison in the backward pass. But the range of
a ray is ``t = (p - o_perp)/u_perp`` of just its *winning* segment, so the
VJP is closed form and elementwise over rays:

    vertical hit:    dr/dx = -1/u_perp   dr/dcos = -t/u_perp   (dy = dsin = 0)
    horizontal hit:  dr/dy = -1/u_perp   dr/dsin = -t/u_perp   (dx = dcos = 0)
    clamped/no hit:  all zero

(the implicit-surface gradient of SURVEY.md §7 step 5 — the hit surface is
axis-aligned, so its normal is the fixed axis and the implicit-function form
coincides with exact autodiff of the winning branch). ``d/dtheta`` chains
through cos/sin outside this boundary automatically.

Winner tracking is nearly free: because every segment is axis-aligned, the
winner's ``u_perp`` is the RAY's own cos/sin — the only per-ray residual the
backward needs is the winning ORIENTATION bit. That bit falls out of
carrying separate vertical/horizontal minima (``isv = t_v <= t_h``), which
costs ~2 extra vector ops/pair vs the ~10 of an argmin-style tie-max sweep.
Cost: fwd+bwd ~= 1.2x fwd (measured; previously 2.7x with tie-max).

Map gradients (``d range/d map``) go through the EDF-march backend
(raymarch_xla.py bilinear mode), per the SURVEY.md §7 step 5 contract: the
occupancy grid is the differentiable map representation; compiled segment
geometry is not (boundary extraction is combinatorial).

Validated against plain ``jax.grad`` of the dense formula and against finite
differences in tests/test_grad.py.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .raycast_segments import (_fit_chunk, _ray_invs, _min_t_vchunk,
                               _min_t_hchunk)

_BIG = np.float32(3.0e38)


def _vh_chunk_body(seg, x, y, cos_t, sin_t, inv_c, inv_s, best_key):
    """One mixed-layout segment-chunk update of the packed winner key.

    seg: p/lo/hi/isv arrays already broadcast to (..., KC) against rays.
    Same per-pair math as raycast_segments._min_t_chunk, then the
    orientation bit is packed into the mantissa LSB of t and a SINGLE
    integer min-reduction finds the winner: all candidate t are
    non-negative finite floats, whose int32 bit patterns order identically,
    so ``min(int_key)`` is ``argmin(t)`` with a <=1-ulp tie-break toward
    horizontal. (Two separate V/H float minima measure 2x slower: XLA
    duplicates the whole masked-t producer into each reduction fusion.)
    """
    p, lo, hi, isv = seg
    o_perp = jnp.where(isv, x[..., None], y[..., None])
    o_along = jnp.where(isv, y[..., None], x[..., None])
    u_inv = jnp.where(isv, inv_c[..., None], inv_s[..., None])
    u_along = jnp.where(isv, sin_t[..., None], cos_t[..., None])
    t = (p - o_perp) * u_inv
    a = o_along + t * u_along
    valid = (t >= 0.0) & ((a - lo) * (hi - a) >= 0.0)  # NaN-safe
    t = jnp.where(valid, t, _BIG)
    key = jax.lax.bitcast_convert_type(t, jnp.int32)
    key = (key & jnp.int32(-2)) | isv.astype(jnp.int32)
    return jnp.minimum(best_key, jnp.min(key, axis=-1))


_BIG_KEY = np.asarray(np.float32(_BIG)).view(np.int32) | np.int32(1)


def _finish_key(best_key, max_range):
    """Packed winner key -> (ranges, isv_win, hit)."""
    isv = (best_key & 1) == 1
    best_t = jax.lax.bitcast_convert_type(best_key & jnp.int32(-2),
                                          jnp.float32)
    hit = best_t < max_range
    return jnp.minimum(best_t, max_range), isv, hit


def _finish_vh(best_tv, best_th, max_range):
    """(best_tv, best_th) -> (ranges, isv_win, hit)."""
    best_t = jnp.minimum(best_tv, best_th)
    hit = best_t < max_range
    isv = best_tv <= best_th
    return jnp.minimum(best_t, max_range), isv, hit


def _fwd_with_winner(segment_params, x, y, cos_t, sin_t, max_range, chunk,
                     kv=0):
    """Full-set min-reduction tracking the winning orientation. Returns
    (ranges, isv_win, hit). With the split layout (kv > 0) the V/H minima
    come from the orientation-specialized sweeps at zero tracking cost."""
    inv_c, inv_s = _ray_invs(cos_t, sin_t)
    k = segment_params.shape[1]

    if kv > 0:
        best_tv = jnp.full(jnp.shape(x), _BIG)
        best_th = jnp.full(jnp.shape(x), _BIG)
        for (lo_i, hi_i, vertical) in ((0, kv, True), (kv, k, False)):
            n = hi_i - lo_i
            if n <= 0:
                continue
            ck = _fit_chunk(n, chunk)
            blk = segment_params[:, lo_i:hi_i].reshape(4, n // ck, ck)
            blk = blk.transpose(1, 0, 2)

            def body(b, seg, vertical=vertical):
                if vertical:
                    t = _min_t_vchunk(seg[0], seg[1], seg[2], x, y,
                                      sin_t, inv_c)
                else:
                    t = _min_t_hchunk(seg[0], seg[1], seg[2], x, y,
                                      cos_t, inv_s)
                return jnp.minimum(b, t), None

            if vertical:
                best_tv, _ = jax.lax.scan(body, best_tv, blk)
            else:
                best_th, _ = jax.lax.scan(body, best_th, blk)
        return _finish_vh(best_tv, best_th, max_range)

    chunk = _fit_chunk(k, chunk)
    chunks = segment_params.reshape(4, k // chunk, chunk).transpose(1, 0, 2)

    def body(carry, seg_chunk):
        seg = (seg_chunk[0], seg_chunk[1], seg_chunk[2], seg_chunk[3] > 0.5)
        return _vh_chunk_body(seg, x, y, cos_t, sin_t, inv_c, inv_s,
                              carry), None

    init = jnp.full(jnp.shape(x), _BIG_KEY, jnp.int32)
    best_key, _ = jax.lax.scan(body, init, chunks)
    return _finish_key(best_key, max_range)


def _fwd_tiled_winner(tiles, tiles_shape, tile_size, tile_origin,
                      x0, y0, x, y, cos_t, sin_t, max_range, chunk,
                      kv_tile=0):
    """Tile-culled variant: rays (A, B), per-agent segment lists. Returns
    (ranges, isv_win, hit)."""
    nr, nc = tiles_shape
    tox, toy = tile_origin
    ci = jnp.clip(((x0 - tox) / tile_size).astype(jnp.int32), 0, nc - 1)
    ri = jnp.clip(((y0 - toy) / tile_size).astype(jnp.int32), 0, nr - 1)
    agent_segs = jnp.take(tiles, ri * nc + ci, axis=0)   # (A, 4, K_tile)
    k = tiles.shape[2]
    inv_c, inv_s = _ray_invs(cos_t, sin_t)

    if kv_tile > 0:
        best_tv = jnp.full(jnp.shape(x), _BIG)
        best_th = jnp.full(jnp.shape(x), _BIG)
        for (lo_i, hi_i, vertical) in ((0, kv_tile, True),
                                       (kv_tile, k, False)):
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

            if vertical:
                best_tv, _ = jax.lax.scan(body, best_tv, blk)
            else:
                best_th, _ = jax.lax.scan(body, best_th, blk)
        return _finish_vh(best_tv, best_th, max_range)

    chunk = _fit_chunk(k, chunk)
    ch = agent_segs.reshape(x0.shape[0], 4, k // chunk, chunk)
    ch = ch.transpose(2, 0, 1, 3)                        # (n, A, 4, KC)

    def body(carry, seg_chunk):
        seg = (seg_chunk[:, 0][:, None, :], seg_chunk[:, 1][:, None, :],
               seg_chunk[:, 2][:, None, :],
               seg_chunk[:, 3][:, None, :] > 0.5)
        return _vh_chunk_body(seg, x, y, cos_t, sin_t, inv_c, inv_s,
                              carry), None

    init = jnp.full(jnp.shape(x), _BIG_KEY, jnp.int32)
    best_key, _ = jax.lax.scan(body, init, ch)
    return _finish_key(best_key, max_range)


def _winner_vjp(r, isv, hit, cos_t, sin_t, g):
    """Shared closed-form cotangents (gx, gy, gcos, gsin).

    The winner's u_perp is the ray's own direction component selected by the
    orientation bit; a vertical hit guarantees cos != 0 (and horizontal,
    sin != 0), so the reciprocal is safe wherever ``hit``.

    Corner-tie convention: at an EXACT V/H tie both orientations are valid
    subgradients. The split-register paths (_finish_vh, the Pallas kernel's
    ``bv <= bh``) break ties toward VERTICAL; the mixed packed-key path
    breaks toward HORIZONTAL (the isv bit makes vertical keys 1 larger).
    Cross-layout gradient reproducibility at exact corner hits is therefore
    not guaranteed — a measure-zero set under float inputs.
    """
    u_win = jnp.where(isv, cos_t, sin_t)
    u_safe = jnp.where(u_win == 0.0, 1e-30, u_win)
    inv_u = jnp.where(hit, 1.0 / u_safe, 0.0)
    gx = jnp.where(isv, -g * inv_u, 0.0)
    gy = jnp.where(isv, 0.0, -g * inv_u)
    gt = -g * r * inv_u
    gct = jnp.where(isv, gt, 0.0)
    gst = jnp.where(isv, 0.0, gt)
    return gx, gy, gct, gst


@functools.partial(jax.custom_vjp, nondiff_argnums=(5, 6, 7))
def raycast_all_diff(segment_params, x, y, cos_t, sin_t,
                     max_range=10.0, chunk: int = 1024, kv: int = 0):
    """Differentiable full-set raycast (analytic VJP, O(rays) backward).

    Values match ``raycast_all`` exactly OUTSIDE autodiff (the primal path
    below is literally raycast_all). UNDER autodiff the mixed-layout
    (kv=0) winner-tracking forward clears the mantissa LSB of t to pack the
    orientation bit, so the primal can sit <=1 ulp below raycast_all and
    ``hit`` can flip exactly at the max_range boundary (pinned in
    tests/test_grad.py::test_diff_primal_ulp_contract). The split layout
    (kv>0) is bit-exact in both modes. ``segment_params`` receives a zero
    cotangent (map grads use the EDF backend, module doc).

    The primal path below runs only OUTSIDE autodiff, so it uses the cheap
    forward; the winner-tracking forward runs only under jax.grad (the
    custom_vjp fwd rule)."""
    from .raycast_segments import raycast_all
    return raycast_all(segment_params, x, y, cos_t, sin_t, max_range,
                       chunk=chunk, kv=kv)


def _rc_fwd(segment_params, x, y, cos_t, sin_t, max_range, chunk, kv):
    r, isv, hit = _fwd_with_winner(
        segment_params, x, y, cos_t, sin_t, max_range, chunk, kv)
    return r, (jnp.shape(segment_params), r, isv, hit, cos_t, sin_t)


def _rc_bwd(max_range, chunk, kv, res, g):
    shape, r, isv, hit, cos_t, sin_t = res
    gx, gy, gct, gst = _winner_vjp(r, isv, hit, cos_t, sin_t, g)
    return jnp.zeros(shape, jnp.float32), gx, gy, gct, gst


raycast_all_diff.defvjp(_rc_fwd, _rc_bwd)


@functools.partial(jax.custom_vjp,
                   nondiff_argnums=(1, 2, 3, 10, 11, 12))
def raycast_tiled_diff(tiles, tiles_shape, tile_size, tile_origin,
                       x0, y0, x, y, cos_t, sin_t,
                       max_range=10.0, chunk: int = 512,
                       kv_tile: int = 0):
    """Differentiable tile-culled raycast (analytic VJP, O(rays) backward).

    ``tiles``/``x0``/``y0`` receive zero cotangents (tile selection is
    piecewise constant in position). Cheap forward outside autodiff."""
    from .raycast_segments import raycast_tiled
    return raycast_tiled(tiles, tiles_shape, tile_size, tile_origin,
                         x0, y0, x, y, cos_t, sin_t, max_range,
                         chunk=chunk, kv_tile=kv_tile)


def _rct_fwd(tiles, tiles_shape, tile_size, tile_origin,
             x0, y0, x, y, cos_t, sin_t, max_range, chunk, kv_tile):
    r, isv, hit = _fwd_tiled_winner(
        tiles, tiles_shape, tile_size, tile_origin, x0, y0, x, y,
        cos_t, sin_t, max_range, chunk, kv_tile)
    return r, (jnp.shape(tiles), jnp.shape(x0), r, isv, hit, cos_t, sin_t)


def _rct_bwd(tiles_shape, tile_size, tile_origin, max_range, chunk,
             kv_tile, res, g):
    tshape, ashape, r, isv, hit, cos_t, sin_t = res
    gx, gy, gct, gst = _winner_vjp(r, isv, hit, cos_t, sin_t, g)
    z = jnp.zeros(ashape, jnp.float32)
    return (jnp.zeros(tshape, jnp.float32), z, z, gx, gy, gct, gst)


raycast_tiled_diff.defvjp(_rct_fwd, _rct_bwd)
