"""Sector-culled dense segment raycast (plain XLA sweeps).

Beams are grouped into angle-contiguous blocks of ``bb`` (default 128);
each block intersects only its (tile, sector) cull list from
``maps/sectors.py``. Same exact-boundary semantics as
``raycast_segments`` (culling is conservative; tests/test_sectors.py).

Two sweep families over the same tables:
  * dense (``_sweep_xla``): beam-minor layout, every ray sweeps the full
    padded list capacity K — work per ray is bound by the MAX list length.
  * length-sorted (``_sweep_xla_sorted*``): rays sorted by their list's
    real length and tiled, each tile sweeping only the chunks its longest
    list needs — work per ray is bound by the batch-visited MEAN length.

Both carry the analytic O(rays) VJP (raycast_grad._winner_vjp).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .raycast_segments import _ray_invs

_BIG = np.float32(3.0e38)
_TWO_PI = np.float32(2.0 * np.pi)


def sector_block_width(smap, num_beams: int, fov: float,
                       bb: int | None = None) -> int:
    """Derive (bb=None) or validate a beam-block width for a sector map.

    The SINGLE definition of the block-width/coverage contract: every real
    beam of a ``bb``-block must lie within the map's ``block_half`` of the
    block's lookup beam (the lookup sits <= bb/2 beam spacings from any
    in-block beam; maps/sectors.py proof obligation). Used by
    ``scan_poses_sectors``, ``scan_poses_sectors_multi`` and the sharded
    paths in ``parallel/mesh.py`` — a drift between per-path copies would
    silently violate the coverage contract only on one of them. Works for ``SectorSegmentMap`` and ``StackedSectorMap``
    (anything with ``block_half``).

    With ``bb=None`` returns the widest supported block, capped at 128
    (the flagship 1080-beam/270 deg block size).
    Raises ValueError when the requested/derived ``bb`` exceeds what the
    map was built for.
    """
    spacing = fov / max(num_beams - 1, 1)
    if bb is None:
        bb = max(1, min(128, 2 * int(smap.block_half / spacing)))
    need = (bb // 2) * spacing
    if need > smap.block_half:
        raise ValueError(
            f"beam blocks span +-{need:.3f} rad but the sector map was "
            f"built for block_half={smap.block_half:.3f}; rebuild the map "
            "with a larger block_half or use a smaller bb")
    return bb


def _pad_beams(a, b_pad):
    """Pad the beam axis by edge replication (padded beams keep valid
    directions; their outputs are sliced off)."""
    if b_pad == 0:
        return a
    return jnp.concatenate(
        [a, jnp.broadcast_to(a[:, -1:], (a.shape[0], b_pad))], axis=1)


def _list_ids(tiles_shape, tile_size, tile_origin, ns, x0, y0, ct, st,
              bb: int):
    """(A,) agent positions + (A, B) beam directions -> (A, NBLK) int32
    rows into the (T*NS, ...) sector table. Block sector is read from one
    in-block beam within half-a-block of every real beam (maps/sectors.py
    coverage contract)."""
    a_n, b_n = ct.shape
    nblk = -(-b_n // bb)
    nr, nc = tiles_shape
    tox, toy = tile_origin
    ci = jnp.clip(((x0 - tox) / tile_size).astype(jnp.int32), 0, nc - 1)
    ri = jnp.clip(((y0 - toy) / tile_size).astype(jnp.int32), 0, nr - 1)
    tid = ri * nc + ci                                     # (A,)
    mids = np.minimum(np.arange(nblk) * bb + bb // 2, b_n - 1)
    th = jnp.arctan2(st[:, mids], ct[:, mids])             # (A, NBLK)
    th = jnp.mod(th, _TWO_PI)
    sec = jnp.clip((th * (ns / _TWO_PI)).astype(jnp.int32), 0, ns - 1)
    return tid[:, None] * ns + sec                         # (A, NBLK)


def _sweep_xla(table, kv_sec, ids, x, y, cos_t, sin_t, inv_c, inv_s,
               chunk: int):
    """Beam-minor dense sweep over ray rows: ray args (G, BB), ``ids``
    (G,) rows into ``table``. Returns per-orientation minima
    (best_v, best_h), each (G, BB).

    Callers flatten (agent, block) into the ONE major axis G, so a
    non-power-of-2 block count (1080 beams = 9 blocks) sits on a single
    major dim instead of an odd middle dim of 4D intermediates.

    The cull rows are gathered ONCE per ray-block from the 2D-flattened
    (L, 4K) table view — one contiguous row per list — and the
    orientation chunks are static slices of the gathered buffer.

    Memory note: the gathered buffer ``g_all`` is (A*NBLK, 4, K) floats
    and is NOT bounded by ``chunk`` (which only sizes the compute
    intermediate) — berlin-class K=496 at 4096 agents is ~0.3 GB, at the
    65k-agent config ~4.7 GB per un-sharded device. ``scan_poses_sectors``
    splits very large batches into agent chunks (``_auto_agent_chunk``).
    """
    k = table.shape[2]
    g_all = jnp.take(table.reshape(table.shape[0], 4 * k), ids,
                     axis=0).reshape(ids.shape[0], 4, k)
    return _sweep_gathered(g_all, kv_sec, x, y, cos_t, sin_t, inv_c,
                           inv_s, chunk)


def _sweep_gathered(g_all, kv_sec, x, y, cos_t, sin_t, inv_c, inv_s,
                    chunk: int):
    """The dense sweep's compute over PRE-GATHERED cull rows: ``g_all``
    (G, 4, K) is ray row g's cull list; ray args are (G, BB). Factored
    out of ``_sweep_xla`` so sharded-map paths that assemble rows by
    other means (the ring map-pass, parallel/ringmap.py) reuse the
    identical arithmetic. Returns (best_v, best_h), each (G, BB)."""
    gdim, bb = x.shape
    k = g_all.shape[2]
    best_v = jnp.full((gdim, bb), _BIG)
    best_h = jnp.full((gdim, bb), _BIG)
    for lo_i, hi_i, vertical in ((0, kv_sec, True), (kv_sec, k, False)):
        best = best_v if vertical else best_h
        c0 = lo_i
        while c0 < hi_i:
            ck = min(chunk, hi_i - c0)
            g = g_all[:, :, c0:c0 + ck]
            # g: (G, 4, ck); beam-minor broadcast -> (G, ck, BB)
            p = g[:, 0, :, None]
            lo = g[:, 1, :, None]
            hi = g[:, 2, :, None]
            if vertical:
                t = (p - x[:, None, :]) * inv_c[:, None, :]
                a = y[:, None, :] + t * sin_t[:, None, :]
            else:
                t = (p - y[:, None, :]) * inv_s[:, None, :]
                a = x[:, None, :] + t * cos_t[:, None, :]
            valid = (t >= 0.0) & ((a - lo) * (hi - a) >= 0.0)
            best = jnp.minimum(
                best, jnp.min(jnp.where(valid, t, _BIG), axis=1))
            c0 += ck
        if vertical:
            best_v = best
        else:
            best_h = best
    return best_v, best_h


def _sweep_xla_sorted(table, meta, kv_sec, ids, x, y, cos_t, sin_t,
                      inv_c, inv_s, chunk: int = 64, tile_rows: int = 64,
                      do_sort: bool = True, lazy_gather: bool = False):
    """Length-sorted tiled sweep: work bound by per-tile MAX real list
    length (~= the mean, after sorting) instead of the padded capacity K.

    The dense ``_sweep_xla`` pays K slots per ray — on berlin-class maps
    well past the real need. Note the honest prize is the BATCH-visited
    mean, not the table mean: rays concentrate in long-list (open
    free-space) tiles, so berlin's visited lists average ~198 of K=496
    (table mean 109) — a predicted sorted-tile work ratio of 0.40 of
    dense. This variant recovers that bound with XLA-legal control flow:

      1. gather each ray row's real V/H counts from ``meta`` (a leaf);
      2. sort ray rows by total count, descending (row gathers of the six
         (G, BB) ray arrays — the same 2D-row-gather form the dense sweep
         uses for the table, measured nearly free);
      3. tile the sorted rows into groups of ``tile_rows``; a tile needs
         ceil(tile_max_nv/C) V-chunks + ceil(tile_max_nh/C) H-chunks of
         ``C = chunk`` slots — after sorting, tile maxes hug the mean;
      4. enumerate all possible (tile, chunk, orientation) work items
         statically, mask the needed ones, compact them to the front with
         one stable argsort, and run ONE ``lax.while_loop`` over the
         needed prefix. Each iteration sweeps a static
         (tile_rows, C, BB) block with the standard formulas and
         min-accumulates into the output via dynamic_update_slice.

    Exactness: identical values to ``_sweep_xla`` — every real slot is
    covered (chunk counts come from the meta bounds), padded slots hold
    never-hit sentinels, and the final V chunk is CLAMPED to the V block
    (re-sweeping overlapped slots is idempotent under min). Work items
    never cross the V/H boundary, so no orientation mismatch is possible.

    ``lazy_gather=False`` pre-gathers the full (G, 4, K) cull buffer once
    (the dense sweep's form); ``True`` instead gathers each work item's
    (tile_rows, C, 4) chunk inside the loop from a slot-major (L, K*4)
    view — mean-bound memory traffic too, for the large-K regime where the
    full-row gather itself is the bottleneck. ``do_sort=False`` skips
    step 2 (saves the row gathers, pays looser tile maxes).
    """
    g_n, bb = x.shape
    k = table.shape[2]
    kv = int(kv_sec)
    kh = k - kv
    c_v = min(chunk, kv)
    c_h = min(chunk, kh)
    tr = tile_rows
    nv = jnp.take(meta[:, 0], ids)                    # (G,) real V counts
    nh = jnp.take(meta[:, 2] - meta[:, 1], ids)       # (G,) real H counts
    pad = (-g_n) % tr
    if pad:
        rep = lambda a: jnp.concatenate(
            [a, jnp.broadcast_to(a[-1:], (pad,) + a.shape[1:])], axis=0)
        x, y, cos_t, sin_t, inv_c, inv_s, ids = map(
            rep, (x, y, cos_t, sin_t, inv_c, inv_s, ids))
        # padded rows cost nothing: zero counts spawn no work items
        z = jnp.zeros((pad,), nv.dtype)
        nv = jnp.concatenate([nv, z])
        nh = jnp.concatenate([nh, z])
    gp = g_n + pad
    if do_sort:
        order = jnp.argsort(-(nv + nh))
        take0 = lambda a: jnp.take(a, order, axis=0)
        x, y, cos_t, sin_t, inv_c, inv_s, ids, nv, nh = map(
            take0, (x, y, cos_t, sin_t, inv_c, inv_s, ids, nv, nh))
    if lazy_gather:
        # slot-major view: one (K, 4) row per list, so a C-slot chunk is a
        # contiguous 4C-float strip gathered per work item
        table_sm = table.transpose(0, 2, 1).reshape(table.shape[0], k * 4)
    else:
        g_all = jnp.take(table.reshape(table.shape[0], 4 * k), ids,
                         axis=0).reshape(gp, 4, k)
    gt = gp // tr
    mj_v = -(-kv // c_v)                              # static chunk caps
    mj_h = -(-kh // c_h)
    tmax_v = jnp.max(nv.reshape(gt, tr), axis=1)      # (GT,)
    tmax_h = jnp.max(nh.reshape(gt, tr), axis=1)
    jv = np.arange(mj_v, dtype=np.int32)
    jh = np.arange(mj_h, dtype=np.int32)
    need_v = (jv[None, :] * c_v) < tmax_v[:, None]    # (GT, mj_v)
    need_h = (jh[None, :] * c_h) < tmax_h[:, None]
    ts = np.repeat(np.arange(gt, dtype=np.int32), mj_v + mj_h)
    js = np.tile(np.concatenate([jv, jh]), gt)
    osv = np.tile(np.concatenate([np.ones(mj_v, np.int32),
                                  np.zeros(mj_h, np.int32)]), gt)
    need = jnp.concatenate([need_v, need_h], axis=1).reshape(-1)
    # compact needed items to the front, preserving order (stable sort)
    perm = jnp.argsort(jnp.where(need, 0, 1), stable=True)
    ts = jnp.take(jnp.asarray(ts), perm)
    js = jnp.take(jnp.asarray(js), perm)
    osv = jnp.take(jnp.asarray(osv), perm)
    n_items = jnp.sum(need.astype(jnp.int32))

    big = jnp.full((gp, bb), _BIG)

    def body(carry):
        i, bv, bh = carry
        t = ts[i]
        j = js[i]
        is_v = osv[i] == 1
        row0 = t * tr
        sl = lambda a: jax.lax.dynamic_slice(a, (row0, 0), (tr, bb))
        xs, ys, cts, sts, ics, iss = map(sl, (x, y, cos_t, sin_t,
                                              inv_c, inv_s))
        # clamp the final chunk inside its orientation block (idempotent
        # overlap; never crosses the V/H boundary)
        slot0 = jnp.where(is_v,
                          jnp.minimum(j * c_v, kv - c_v),
                          kv + jnp.minimum(j * c_h, kh - c_h))

        def seg_chunk(c_static):
            if lazy_gather:
                rows = jax.lax.dynamic_slice(ids, (row0,), (tr,))
                strip = jax.vmap(lambda r: jax.lax.dynamic_slice(
                    table_sm, (r, slot0 * 4), (1, c_static * 4))[0])(rows)
                return strip.reshape(tr, c_static, 4).transpose(0, 2, 1)
            return jax.lax.dynamic_slice(
                g_all, (row0, 0, slot0), (tr, 4, c_static))

        def sweep(c_static):
            seg = seg_chunk(c_static)                 # (TR, 4, C)
            p = seg[:, 0, :, None]
            lo = seg[:, 1, :, None]
            hi = seg[:, 2, :, None]
            o1 = jnp.where(is_v, xs, ys)[:, None, :]
            oi = jnp.where(is_v, ics, iss)[:, None, :]
            oa = jnp.where(is_v, ys, xs)[:, None, :]
            od = jnp.where(is_v, sts, cts)[:, None, :]
            t_ = (p - o1) * oi
            a_ = oa + t_ * od
            valid = (t_ >= 0.0) & ((a_ - lo) * (hi - a_) >= 0.0)
            return jnp.min(jnp.where(valid, t_, _BIG), axis=1)  # (TR, BB)

        # the two orientations may use different static chunk widths;
        # both sweeps return (TR, BB) so lax.cond unifies them
        if c_v == c_h:
            m = sweep(c_v)
        else:
            m = jax.lax.cond(is_v, lambda: sweep(c_v),
                             lambda: sweep(c_h))

        # update BOTH carry buffers with masked mins (no lax.cond around
        # the carries: cond branches returning whole buffers defeat
        # XLA's in-place while-carry analysis and copy the full buffers
        # every iteration)
        def upd(b, mm):
            cur = jax.lax.dynamic_slice(b, (row0, 0), (tr, bb))
            return jax.lax.dynamic_update_slice(
                b, jnp.minimum(cur, mm), (row0, 0))

        bv = upd(bv, jnp.where(is_v, m, _BIG))
        bh = upd(bh, jnp.where(is_v, _BIG, m))
        return i + 1, bv, bh

    _, bv, bh = jax.lax.while_loop(
        lambda c: c[0] < n_items, body, (jnp.int32(0), big, big))
    if do_sort:
        inv = jnp.argsort(order)
        bv = jnp.take(bv, inv, axis=0)
        bh = jnp.take(bh, inv, axis=0)
    return bv[:g_n], bh[:g_n]


def _sweep_xla_sorted_pt(table, meta, kv_sec, ids, x, y, cos_t, sin_t,
                         inv_c, inv_s, chunk: int = 64,
                         tile_rows: int = 2048, do_sort: bool = True,
                         transpose_chunks: bool = False):
    """Per-tile variant of the length-sorted sweep: ``lax.scan`` over row
    tiles, a small-carry ``lax.while_loop`` per tile.

    `_sweep_xla_sorted` min-accumulates every work item into the two
    full (G, BB) output buffers via dynamic_update_slice on the
    while-loop carry, which XLA can materialize as a copy-on-write of
    the whole buffer per iteration. Here the outer loop is a
    ``lax.scan`` whose per-tile (TR, BB) results are written once by
    scan's output stacking, and the inner while-loop carry is only the
    per-tile accumulators (TR, BB) updated by FULL elementwise mins —
    nothing for XLA to copy-on-write.

    Work bound, exactness and sorting are identical to
    `_sweep_xla_sorted` (same chunk-count derivation from ``meta``, same
    clamped final chunk, work never crosses the V/H boundary).

    ``transpose_chunks=True`` stores each tile's gathered cull rows
    slot-major — (K, 4, TR) instead of (TR, 4, K) — so the per-iteration
    chunk slice is a MAJOR-axis dynamic_slice, contiguous for every slot
    offset, instead of a minor-axis slice of the K-wide dim.
    """
    g_n, bb = x.shape
    k = table.shape[2]
    kv = int(kv_sec)
    kh = k - kv
    c_v = min(chunk, kv)
    c_h = min(chunk, kh)
    tr = tile_rows
    nv = jnp.take(meta[:, 0], ids)
    nh = jnp.take(meta[:, 2] - meta[:, 1], ids)
    pad = (-g_n) % tr
    if pad:
        rep = lambda a: jnp.concatenate(
            [a, jnp.broadcast_to(a[-1:], (pad,) + a.shape[1:])], axis=0)
        x, y, cos_t, sin_t, inv_c, inv_s, ids = map(
            rep, (x, y, cos_t, sin_t, inv_c, inv_s, ids))
        z = jnp.zeros((pad,), nv.dtype)
        nv = jnp.concatenate([nv, z])
        nh = jnp.concatenate([nh, z])
    gp = g_n + pad
    if do_sort:
        order = jnp.argsort(-(nv + nh))
        take0 = lambda a: jnp.take(a, order, axis=0)
        x, y, cos_t, sin_t, inv_c, inv_s, ids, nv, nh = map(
            take0, (x, y, cos_t, sin_t, inv_c, inv_s, ids, nv, nh))
    g_all = jnp.take(table.reshape(table.shape[0], 4 * k), ids,
                     axis=0).reshape(gp, 4, k)
    gt = gp // tr
    tmax_v = jnp.max(nv.reshape(gt, tr), axis=1)
    tmax_h = jnp.max(nh.reshape(gt, tr), axis=1)
    nvc = -(-tmax_v // c_v)                      # per-tile V chunk counts
    nhc = -(-tmax_h // c_h)
    tile = lambda a: a.reshape((gt, tr) + a.shape[1:])
    xs_t = tuple(map(tile, (x, y, cos_t, sin_t, inv_c, inv_s)))
    g_tiles = tile(g_all)
    if transpose_chunks:
        g_tiles = g_tiles.transpose(0, 3, 2, 1)      # (gt, K, 4, tr)

    big = jnp.full((tr, bb), _BIG)

    def per_tile(_, xs):
        (xs_, ys_, cts, sts, ics, iss), g_t, nvc_t, nhc_t = xs

        def body(carry):
            i, bv, bh = carry
            is_v = i < nvc_t
            j = jnp.where(is_v, i, i - nvc_t)
            slot0 = jnp.where(is_v,
                              jnp.minimum(j * c_v, kv - c_v),
                              kv + jnp.minimum(j * c_h, kh - c_h))

            def sweep(c_static):
                o1 = jnp.where(is_v, xs_, ys_)
                oi = jnp.where(is_v, ics, iss)
                oa = jnp.where(is_v, ys_, xs_)
                od = jnp.where(is_v, sts, cts)
                if transpose_chunks:
                    seg = jax.lax.dynamic_slice(
                        g_t, (slot0, 0, 0), (c_static, 4, tr))
                    p = seg[:, 0, :, None]           # (C, TR, 1)
                    lo = seg[:, 1, :, None]
                    hi = seg[:, 2, :, None]
                    t_ = (p - o1[None]) * oi[None]   # (C, TR, BB)
                    a_ = oa[None] + t_ * od[None]
                    valid = (t_ >= 0.0) & ((a_ - lo) * (hi - a_) >= 0.0)
                    return jnp.min(jnp.where(valid, t_, _BIG), axis=0)
                seg = jax.lax.dynamic_slice(
                    g_t, (0, 0, slot0), (tr, 4, c_static))
                p = seg[:, 0, :, None]
                lo = seg[:, 1, :, None]
                hi = seg[:, 2, :, None]
                t_ = (p - o1[:, None, :]) * oi[:, None, :]
                a_ = oa[:, None, :] + t_ * od[:, None, :]
                valid = (t_ >= 0.0) & ((a_ - lo) * (hi - a_) >= 0.0)
                return jnp.min(jnp.where(valid, t_, _BIG), axis=1)

            if c_v == c_h:
                m = sweep(c_v)
            else:
                m = jax.lax.cond(is_v, lambda: sweep(c_v),
                                 lambda: sweep(c_h))
            bv = jnp.minimum(bv, jnp.where(is_v, m, _BIG))
            bh = jnp.minimum(bh, jnp.where(is_v, _BIG, m))
            return i + 1, bv, bh

        _, bv, bh = jax.lax.while_loop(
            lambda c: c[0] < nvc_t + nhc_t, body, (jnp.int32(0), big, big))
        return None, (bv, bh)

    _, (bv, bh) = jax.lax.scan(
        per_tile, None,
        (xs_t, g_tiles, nvc.astype(jnp.int32), nhc.astype(jnp.int32)))
    bv = bv.reshape(gp, bb)
    bh = bh.reshape(gp, bb)
    if do_sort:
        inv = jnp.argsort(order)
        bv = jnp.take(bv, inv, axis=0)
        bh = jnp.take(bh, inv, axis=0)
    return bv[:g_n], bh[:g_n]


# mode strings of removed Pallas kernels ("sorted_pt" replaces them all)
_REMOVED_MODES = ("sorted_pl", "sorted_plf", "sorted_plfm", "sorted_plfr",
                  "sorted_plfmr")


def resolve_sector_mode(mode: str) -> str:
    """Resolve "auto" to a concrete sweep mode; validate any other mode.

    "auto" is the dense sweep at every table capacity. Timed on one H100
    at 4096 agents x 1080 beams (scripts/sector_modes.py; numbers in
    PERF.md), dense beat the length-sorted ``sorted_pt`` at every
    capacity measured, K = 32 to 496, forward and forward+backward, and
    the gap in milliseconds grew with K: the sorted sweep's row sort and
    sequential tile loop cost more than the padded slots it skips.
    Every mode gives identical values (tests/test_sectors.py).
    """
    if mode == "auto":
        return "dense"
    _parse_mode(mode)
    return mode


def _parse_mode(mode: str):
    """"dense" | "sorted[@TR]" | "sorted_lazy[@TR]" | "sorted_nosort[@TR]"
    | "sorted_pt[@TR]" | "sorted_pt_nosort[@TR]" | "sorted_ptt[@TR]"
    -> (kind, tile_rows, do_sort, lazy_gather)."""
    tr = 64
    name = mode
    if "@" in mode:
        mode, tr_s = mode.split("@", 1)
        tr = int(tr_s)
    if mode in _REMOVED_MODES:
        raise ValueError(
            f"sector sweep mode {name!r} was a Pallas kernel that has been "
            "removed; use 'sorted_pt' (same values, plain XLA) or 'auto'")
    if mode == "dense":
        return "dense", tr, True, False
    if mode == "sorted":
        return "sorted", tr, True, False
    if mode == "sorted_lazy":
        return "sorted", tr, True, True
    if mode == "sorted_nosort":
        return "sorted", tr, False, False
    if mode == "sorted_pt":
        return "sorted_pt", tr, True, False
    if mode == "sorted_pt_nosort":
        return "sorted_pt", tr, False, False
    if mode == "sorted_ptt":
        return "sorted_ptt", tr, True, False
    raise ValueError(f"unknown sector sweep mode {name!r}")


def _sweep_flat(table, meta, kv_sec, ids, x, y, cos_t, sin_t, inv_c,
                inv_s, chunk, mode):
    """Dispatch one sweep mode over flattened ray rows: ``ids`` (G,) rows
    into ``table``, ray args (G, BB). Returns (best_v, best_h), (G, BB)."""
    kind, tile_rows, do_sort, lazy = _parse_mode(mode)
    args = (x, y, cos_t, sin_t, inv_c, inv_s)
    if kind == "dense":
        return _sweep_xla(table, kv_sec, ids, *args, chunk)
    if kind in ("sorted_pt", "sorted_ptt"):
        return _sweep_xla_sorted_pt(table, meta, kv_sec, ids, *args,
                                    chunk=chunk, tile_rows=tile_rows,
                                    do_sort=do_sort,
                                    transpose_chunks=kind == "sorted_ptt")
    return _sweep_xla_sorted(table, meta, kv_sec, ids, *args, chunk=chunk,
                             tile_rows=tile_rows, do_sort=do_sort,
                             lazy_gather=lazy)


def _fwd_impl(table, meta, tiles_shape, tile_size, tile_origin, ns, kv_sec,
              x0, y0, x, y, cos_t, sin_t, max_range, bb, chunk, mode):
    a_n, b_n = x.shape
    nblk = -(-b_n // bb)
    b_pad = nblk * bb - b_n
    ids = _list_ids(tiles_shape, tile_size, tile_origin, ns, x0, y0,
                    cos_t, sin_t, bb)
    inv_c, inv_s = _ray_invs(cos_t, sin_t)
    flat = [_pad_beams(v, b_pad).reshape(a_n * nblk, bb)
            for v in (x, y, cos_t, sin_t, inv_c, inv_s)]
    bv, bh = _sweep_flat(table, meta, kv_sec, ids.reshape(-1), *flat,
                         chunk, mode)
    bv = bv.reshape(a_n, -1)[:, :b_n]
    bh = bh.reshape(a_n, -1)[:, :b_n]
    r = jnp.minimum(jnp.minimum(bv, bh), max_range)
    isv = bv <= bh
    hit = jnp.minimum(bv, bh) < max_range
    return r, isv, hit


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5, 6, 13, 14,
                                                    15, 16))
def raycast_sectors(table, meta, tiles_shape, tile_size, tile_origin,
                    ns, kv_sec, x0, y0, x, y, cos_t, sin_t,
                    max_range: float = 10.0, bb: int = 128,
                    chunk: int = 64, mode: str = "dense"):
    """Differentiable sector-culled raycast; rays are (A, B).

    Values match ``raycast_all`` over the same boundary geometry (culling
    is conservative). ``table``/``meta``/``x0``/``y0`` receive zero
    cotangents; the VJP is the analytic O(rays) closed form.

    ``mode``: "dense" (capacity-bound `_sweep_xla`) or the
    "sorted"-family mean-bound sweeps (`_sweep_xla_sorted*`) for
    large-capacity maps; identical values either way.

    The caller must guarantee that every beam of a ``bb``-block lies
    within the map's ``block_half`` of the block's lookup beam (checked in
    ``scan_poses_sectors``, where beam spacing is known).
    """
    r, _, _ = _fwd_impl(table, meta, tiles_shape, tile_size, tile_origin,
                        ns, kv_sec, x0, y0, x, y, cos_t, sin_t, max_range,
                        bb, chunk, mode)
    return r


def _rs_fwd(table, meta, tiles_shape, tile_size, tile_origin, ns, kv_sec,
            x0, y0, x, y, cos_t, sin_t, max_range, bb, chunk, mode):
    r, isv, hit = _fwd_impl(table, meta, tiles_shape, tile_size,
                            tile_origin, ns, kv_sec, x0, y0, x, y, cos_t,
                            sin_t, max_range, bb, chunk, mode)
    # plain shape tuples ride the residuals (array-typed shape carriers
    # do not survive shard_map's transpose)
    return r, (jnp.shape(table), jnp.shape(meta), jnp.shape(x0),
               r, isv, hit, cos_t, sin_t)


def _rs_bwd(tiles_shape, tile_size, tile_origin, ns, kv_sec, max_range,
            bb, chunk, mode, res, g):
    from .raycast_grad import _winner_vjp
    tshape, mshape, ashape, r, isv, hit, cos_t, sin_t = res
    gx, gy, gct, gst = _winner_vjp(r, isv, hit, cos_t, sin_t, g)
    z = jnp.zeros(ashape, jnp.float32)
    meta_ct = np.zeros(mshape, jax.dtypes.float0)
    return (jnp.zeros(tshape, jnp.float32), meta_ct, z, z, gx, gy, gct,
            gst)


raycast_sectors.defvjp(_rs_fwd, _rs_bwd)


# Auto agent-chunking: the sweeps pre-gather each ray row's (4, K) cull
# list, a working set NOT bounded by the compute chunk (berlin-class
# K=496: ~71 KB per agent at 9 beam blocks, ~4.7 GB at 65k agents).
# Batches whose gathered rows would exceed an eighth of the device's
# memory are split into agent chunks executed sequentially by
# ``lax.map`` (values identical: rays are independent). On one H100
# (60 GB to a JAX process) that is 105k berlin agents: chunking the 32k
# and 65k batches there only cost 2-4% (PERF.md), so they run in one
# shot. Devices that report no memory limit use the fixed fallback.
_CHUNK_BYTES_FALLBACK = 1.8e9


def _chunk_bytes_budget() -> float:
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return limit / 8.0 if limit else _CHUNK_BYTES_FALLBACK


def _auto_agent_chunk(a_n: int, nblk: int, k: int) -> int:
    """Agents per chunk (0 = no chunking) for a batch of ``a_n`` agents,
    ``nblk`` beam blocks and a capacity-``k`` table: the pre-gathered
    (NBLK, 4, K) rows of one chunk stay under ``_chunk_bytes_budget()``."""
    per_agent = nblk * 4 * k * 4.0          # (NBLK, 4, K) f32 rows
    cap = int(_chunk_bytes_budget() // per_agent)
    cap = max(2048, (cap // 1024) * 1024)
    if a_n <= cap:
        return 0
    # smallest chunk count that fits under ``cap``, then the chunk size
    # balanced across chunks (128-aligned) — a 33k batch pads ~1%
    # instead of the 24% a fixed cap-sized chunk would
    nc = -(-a_n // cap)
    return min(cap, -(-(-(-a_n // nc)) // 128) * 128)


def _padded_offsets(num_beams, fov, bb):
    """The (B_padded,) beam-offset row: padding the offset row is free,
    where padding six (A, B) ray arrays inside the raycast would be real
    device-memory copies."""
    from .common import beam_angles
    nblk = -(-num_beams // bb)
    b_pad = nblk * bb - num_beams
    offs = beam_angles(num_beams, fov)
    if b_pad:
        offs = jnp.concatenate(
            [offs, jnp.broadcast_to(offs[-1:], (b_pad,))])
    return offs


def _scan_chunk(smap, poses2, ct, st, num_beams, max_range, bb, mode,
                chunk: int = 64):
    """Raycast + extent mask for one (A, 3) pose chunk whose beam fan
    (ct, st) was built OUTSIDE the chunk loop — one fusion context, so
    chunked and unchunked execution stay bit-identical (XLA may
    contract the rotation fan's mul-sub into FMAs differently per
    fusion context otherwise; measured on CPU)."""
    from .common import apply_extent_mask
    xb = jnp.broadcast_to(poses2[:, 0:1], ct.shape)
    yb = jnp.broadcast_to(poses2[:, 1:2], ct.shape)
    r = raycast_sectors(
        smap.table, smap.meta, smap.tiles_shape,
        smap.tile_size, smap.tile_origin, smap.ns, smap.kv_sec,
        poses2[:, 0], poses2[:, 1],
        xb, yb, ct, st, max_range, bb, chunk, mode)[:, :num_beams]
    return apply_extent_mask(r, poses2[:, 0], poses2[:, 1], smap.extent,
                             max_range)


def _chunked(fn, agent_chunk, a_n, num_beams, *arrays):
    """Run ``fn(*arrays)`` over agent chunks of ``agent_chunk`` (edge-
    replicated pad tail) via ``lax.map``, or in one shot when the batch
    fits. Every array's leading axis is the agent axis; ``fn`` returns
    (A, num_beams)."""
    if not agent_chunk or a_n <= agent_chunk:
        return fn(*arrays)
    nc = -(-a_n // agent_chunk)
    pad = nc * agent_chunk - a_n
    if pad:
        arrays = [jnp.concatenate(
            [a, jnp.broadcast_to(a[-1:], (pad,) + a.shape[1:])])
            for a in arrays]
    r = jax.lax.map(
        lambda sl: fn(*sl),
        tuple(a.reshape((nc, agent_chunk) + a.shape[1:]) for a in arrays))
    return r.reshape(nc * agent_chunk, num_beams)[:a_n]


def scan_poses_sectors(smap, poses, num_beams: int = 1080,
                       fov: float = 4.712388980384690, max_range=10.0,
                       theta_discretization: int = 0, bb=None,
                       mode: str = "auto",
                       agent_chunk=None) -> jnp.ndarray:
    """Full lidar scans for poses (..., 3) via the sector backend.

    ``mode="auto"`` (default) resolves to the sweep measured fastest on
    the card (resolve_sector_mode). All modes are value-identical
    (tests/test_sectors.py).

    ``agent_chunk``: agents per sequential execution chunk for very
    large batches (``None`` = auto-derive from the table capacity so the
    pre-gathered cull working set stays bounded — the 32k/65k
    single-device configs; ``0`` = never chunk). Values are identical
    either way (rays are independent); gradients flow through the
    chunked path unchanged (lax.map differentiates as a scan).
    """
    bb = sector_block_width(smap, num_beams, fov, bb)
    mode = resolve_sector_mode(mode)
    poses = jnp.asarray(poses)
    batch = poses.shape[:-1]
    poses2 = poses.reshape(-1, 3)
    a_n = poses2.shape[0]
    nblk = -(-num_beams // bb)
    if agent_chunk is None:
        agent_chunk = _auto_agent_chunk(a_n, nblk, smap.table.shape[2])
    from .common import fan_cos_sin
    offs = _padded_offsets(num_beams, fov, bb)
    # the fan is built ONCE for the whole batch (see _scan_chunk note)
    ct, st = fan_cos_sin(poses2[:, 2], offs, theta_discretization)
    r = _chunked(
        lambda p, c, s: _scan_chunk(smap, p, c, s, num_beams, max_range,
                                    bb, mode),
        agent_chunk, a_n, num_beams, poses2, ct, st)
    return r.reshape(*batch, num_beams)


def scan_poses_sectors_mapgrad(smap, edf, resolution, origin_xy, poses,
                               num_beams: int = 1080,
                               fov: float = 4.712388980384690,
                               max_range=10.0,
                               theta_discretization: int = 0,
                               eps: float = 1e-4, bounds_hw=None,
                               bb=None, dedup: bool = False) -> jnp.ndarray:
    """Sector-culled scan with a ∂range/∂map cotangent: the production
    ∂range/∂map path (BASELINE.json configs[2]).

    Values are BIT-IDENTICAL to ``scan_poses_sectors`` (the compiled-
    geometry forward; with_map_gradient is straight-through). Backward:
    pose/direction cotangents via the sector backend's analytic O(rays)
    VJP, plus the implicit-function map cotangent into ``edf`` attached at
    each hit (ops/raymarch_diff.with_map_gradient — 4 bilinear taps/ray).

    ``edf``: the euclidean distance field the map cotangent lands in
    (e.g. ``track.edf``; grid convention of ops/raymarch_xla). It must
    describe the SAME occupancy boundary the sector map was compiled
    from — the IFT gradient is the derivative of that shared surface.
    ``bounds_hw``: real (h, w) if ``edf`` is padded.
    """
    from .raymarch_diff import with_map_gradient
    from .common import fan_cos_sin, apply_extent_mask
    bb = sector_block_width(smap, num_beams, fov, bb)
    poses = jnp.asarray(poses)
    batch = poses.shape[:-1]
    poses2 = poses.reshape(-1, 3)
    offs = _padded_offsets(num_beams, fov, bb)
    ct, st = fan_cos_sin(poses2[:, 2], offs, theta_discretization)
    xb = jnp.broadcast_to(poses2[:, 0:1], ct.shape)
    yb = jnp.broadcast_to(poses2[:, 1:2], ct.shape)
    r = raycast_sectors(
        smap.table, smap.meta, smap.tiles_shape, smap.tile_size,
        smap.tile_origin, smap.ns, smap.kv_sec, poses2[:, 0], poses2[:, 1],
        xb, yb, ct, st, max_range, bb, 64)[:, :num_beams]
    r = apply_extent_mask(r, poses2[:, 0], poses2[:, 1], smap.extent,
                          max_range)
    r = with_map_gradient(edf, r, xb[:, :num_beams], yb[:, :num_beams],
                          ct[:, :num_beams], st[:, :num_beams],
                          resolution, origin_xy, eps, bounds_hw, dedup)
    return r.reshape(*batch, num_beams)


def _ids_sweep(table, meta, ids, kv_sec, x, y, cos_t, sin_t, chunk, mode):
    """Shared sweep dispatch for the precomputed-ids path: ray args
    (A, NBLK, BB). Returns (bv, bh) shaped (A, NBLK, BB)."""
    inv_c, inv_s = _ray_invs(cos_t, sin_t)
    a_n, nblk, bb = jnp.shape(x)
    flat = [v.reshape(a_n * nblk, bb)
            for v in (x, y, cos_t, sin_t, inv_c, inv_s)]
    bv, bh = _sweep_flat(table, meta, kv_sec, ids.reshape(-1), *flat,
                         chunk, mode)
    unflat = lambda v: v.reshape(a_n, nblk, bb)
    return unflat(bv), unflat(bh)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 8, 9, 10))
def raycast_sectors_ids(table, meta, ids, kv_sec, x, y, cos_t, sin_t,
                        max_range: float = 10.0, chunk: int = 64,
                        mode: str = "dense"):
    """Sector sweep over PRECOMPUTED list ids (multi-map serving path).

    ray args are (A, NBLK, BB); ``ids`` (A, NBLK) rows into ``table``.
    Same values/VJP as ``raycast_sectors`` — only the id routing differs
    (per-agent map offsets, maps/sectors.StackedSectorMap). ``mode``
    takes the same sweep family as ``raycast_sectors`` (the sorted
    sweeps work unchanged here: ids are already rows into the stacked
    table, so multi-track batches sort/tile across ALL their maps at
    once). Returns (A, NBLK*BB) clamped ranges.
    """
    bv, bh = _ids_sweep(table, meta, ids, kv_sec, x, y, cos_t, sin_t,
                        chunk, mode)
    a_n = x.shape[0]
    return jnp.minimum(jnp.minimum(bv, bh), max_range).reshape(a_n, -1)


def _rsi_fwd(table, meta, ids, kv_sec, x, y, cos_t, sin_t, max_range,
             chunk, mode):
    bv, bh = _ids_sweep(table, meta, ids, kv_sec, x, y, cos_t, sin_t,
                        chunk, mode)
    a_n = x.shape[0]
    r = jnp.minimum(jnp.minimum(bv, bh), max_range).reshape(a_n, -1)
    isv = (bv <= bh).reshape(a_n, -1)
    hit = (jnp.minimum(bv, bh) < max_range).reshape(a_n, -1)
    return r, (jnp.shape(table), jnp.shape(meta), jnp.shape(ids),
               jnp.shape(x), r, isv, hit, cos_t, sin_t)


def _rsi_bwd(kv_sec, max_range, chunk, mode, res, g):
    from .raycast_grad import _winner_vjp
    tshape, mshape, ishape, rshape, r, isv, hit, cos_t, sin_t = res
    gx, gy, gct, gst = _winner_vjp(
        r, isv, hit, cos_t.reshape(r.shape), sin_t.reshape(r.shape), g)
    f0 = lambda s: np.zeros(s, jax.dtypes.float0)
    return (jnp.zeros(tshape, jnp.float32), f0(mshape), f0(ishape),
            gx.reshape(rshape), gy.reshape(rshape), gct.reshape(rshape),
            gst.reshape(rshape))


raycast_sectors_ids.defvjp(_rsi_fwd, _rsi_bwd)


def stack_block_ids(stack, mid, x0, y0, ct, st, b_real: int, bb: int):
    """Per-agent routing for the stacked multi-map sweep.

    ``mid``: (A,) int32 map ids; ``x0``/``y0``: (A,) agent positions;
    ``ct``/``st``: (A, NBLK*BB) padded beam fan; ``b_real``: real beam
    count (block lookup indices are capped there so padded beams never
    route). Returns ``(ids, inside)`` — (A, NBLK) rows into
    ``stack.table`` and the (A,) per-agent map-extent mask. A handful of
    O(agents) scalar gathers on top of the single-map path; shared by
    ``scan_poses_sectors_multi`` and the sharded step
    (parallel/mesh.make_sharded_step with a StackedSectorMap)."""
    nblk = ct.shape[1] // bb
    g = jnp.take(stack.grids, mid, axis=0)          # [nr, nc, tox, toy]
    base = jnp.take(stack.offsets, mid)             # (A,)
    nr = g[:, 0].astype(jnp.int32)
    nc = g[:, 1].astype(jnp.int32)
    ci = jnp.clip(((x0 - g[:, 2]) / stack.tile_size)
                  .astype(jnp.int32), 0, nc - 1)
    ri = jnp.clip(((y0 - g[:, 3]) / stack.tile_size)
                  .astype(jnp.int32), 0, nr - 1)
    tid = ri * nc + ci
    mids = np.minimum(np.arange(nblk) * bb + bb // 2, b_real - 1)
    th = jnp.mod(jnp.arctan2(st[:, mids], ct[:, mids]), _TWO_PI)
    sec = jnp.clip((th * (stack.ns / _TWO_PI)).astype(jnp.int32), 0,
                   stack.ns - 1)
    ids = (base + tid * stack.ns)[:, None] + sec    # (A, NBLK)
    e = jnp.take(stack.extents, mid, axis=0)
    inside = ((x0 >= e[:, 0]) & (x0 < e[:, 1])
              & (y0 >= e[:, 2]) & (y0 < e[:, 3]))
    return ids, inside


def scan_poses_sectors_multi(stack, map_ids, poses, num_beams: int = 1080,
                             fov: float = 4.712388980384690,
                             max_range=10.0, theta_discretization: int = 0,
                             bb=None, mode: str = "auto",
                             agent_chunk=None) -> jnp.ndarray:
    """Multi-track batched scan: agent i scans on map ``map_ids[i]``.

    ``agent_chunk``: as ``scan_poses_sectors`` — auto-derived chunking
    for very large batches (None = auto; 0 = off).

    ``stack``: maps/sectors.StackedSectorMap. One fused sweep serves the
    whole agent batch across all stacked tracks — per-agent map routing is
    a handful of O(agents) scalar gathers on top of the single-map path.
    ``mode="auto"`` resolves exactly as ``scan_poses_sectors``.
    """
    bb = sector_block_width(stack, num_beams, fov, bb)
    mode = resolve_sector_mode(mode)
    poses = jnp.asarray(poses)
    batch = poses.shape[:-1]
    poses2 = poses.reshape(-1, 3)
    mid = jnp.asarray(map_ids, jnp.int32).reshape(-1)
    a_n = poses2.shape[0]
    nblk = -(-num_beams // bb)
    if agent_chunk is None:
        agent_chunk = _auto_agent_chunk(a_n, nblk, stack.table.shape[2])
    from .common import fan_cos_sin
    offs = _padded_offsets(num_beams, fov, bb)
    # fan built ONCE for the whole batch (see _scan_chunk note)
    ct, st = fan_cos_sin(poses2[:, 2], offs, theta_discretization)
    r = _chunked(
        lambda p, m, c, s: _scan_chunk_multi(stack, p, m, c, s, num_beams,
                                             max_range, bb, mode),
        agent_chunk, a_n, num_beams, poses2, mid, ct, st)
    return r.reshape(*batch, num_beams)


def _scan_chunk_multi(stack, poses2, mid, ct, st, num_beams, max_range,
                      bb, mode):
    """Stacked raycast + per-agent extent mask for one (A, 3) pose
    chunk; the fan (ct, st) rides in pre-built so chunked execution stays
    bit-identical (see ``_scan_chunk``)."""
    nblk = ct.shape[1] // bb
    a_n = poses2.shape[0]
    xb = jnp.broadcast_to(poses2[:, 0:1], ct.shape)
    yb = jnp.broadcast_to(poses2[:, 1:2], ct.shape)
    ids, inside = stack_block_ids(stack, mid, poses2[:, 0], poses2[:, 1],
                                  ct, st, num_beams, bb)
    shp = (a_n, nblk, bb)
    r = raycast_sectors_ids(
        stack.table, stack.meta, ids, stack.kv_sec,
        xb.reshape(shp), yb.reshape(shp), ct.reshape(shp),
        st.reshape(shp), max_range, 64, mode)[:, :num_beams]
    # per-agent extent mask (reference out-of-map => max_range)
    return jnp.where(inside[:, None], r, max_range)
