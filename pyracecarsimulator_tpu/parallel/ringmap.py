"""Ring map-pass scan: the sector table SHARDED across devices.

SURVEY.md §5 "long-context analogue" names two layers: beam-axis
sharding (parallel/mesh.py, the default — sector tables are small enough
to replicate: levine 10.6 MB, berlin 130 MB) and, as the extension for
maps that DON'T fit per-device (continent-scale grids, or hundreds of
stacked tracks), a ring-pass of map shards between devices during the
scan — the ring-attention analogue. This module is that extension.

Design: the (L, 4, K) cull table is sharded by LIST ROWS over the
``beams`` mesh axis (S shards; each device holds L/S rows, memory /S).
Rays stay put; the map moves: at ring step s, device d holds slab
(d + s) mod S, copies the resident rows its rays need into a per-ray
buffer, and ppermutes the slab to the next device of the ring. After S
steps every ray has its cull list and ONE dense sweep (the factored
``ops.raycast_sectors._sweep_gathered`` — identical arithmetic to the
replicated path) produces the ranges. Collectives are S ppermutes of
L/S rows each = one full table traversal per scan. The ring order is
just the ``beams`` axis order: cards joined all to all (NVLink inside a
host) reach every peer at the same rate, so no device order is
preferred. XLA's latency-hiding scheduler may overlap each ppermute
with the row-copy compute (docs/OVERLAP.md).

Cost model (why this is the extension, not the default): the row-copy
runs S times per scan (each step touches every ray row slot), so the
assemble phase costs ~S x the replicated path's single gather, buying a
1/S per-device table footprint. That trade is right exactly when the
table cannot be replicated — the ring is a capacity feature, not a
throughput one.

Gradients: the usual analytic O(rays) winner VJP
(ops.raycast_grad._winner_vjp) — the backward never touches the ring
(only (r, isv, hit) residuals), so training through a sharded map costs
the same as through a replicated one.

No reference equivalent (single map, single process — SURVEY.md §2b).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.raycast_segments import _ray_invs
from ..ops.raycast_sectors import (_sweep_gathered, _list_ids,
                                   sector_block_width)
from ..maps.segments import _FAR
from ..ops.raymarch_xla import beam_angles


@functools.partial(jax.custom_vjp, nondiff_argnums=(6, 7, 8, 9, 10, 11))
def _ring_raycast(slab, ids, x, y, cos_t, sin_t, kv_sec, n_slabs, ls,
                  axis_name, max_range, chunk):
    """Ray ranges from a ring-sharded cull table (module doc).

    ``slab``: this device's (ls, 4, K) table rows; ``ids``: (G,) GLOBAL
    list rows for each local ray row; ray args (G, BB). Must run inside
    shard_map with ``axis_name`` a ring of ``n_slabs`` devices.
    """
    r, _, _ = _ring_fwd_impl(slab, ids, x, y, cos_t, sin_t, kv_sec,
                             n_slabs, ls, axis_name, max_range, chunk)
    return r


def _ring_fwd_impl(slab, ids, x, y, cos_t, sin_t, kv_sec, n_slabs, ls,
                   axis_name, max_range, chunk):
    inv_c, inv_s = _ray_invs(cos_t, sin_t)
    g_n = ids.shape[0]
    k = slab.shape[2]
    my = jax.lax.axis_index(axis_name)
    sent = jnp.asarray([_FAR, 1.0, -1.0, 0.0], jnp.float32)
    buf0 = jnp.tile(sent[None, :, None], (g_n, 1, k))
    perm = [(i, (i - 1) % n_slabs) for i in range(n_slabs)]

    def step(s, carry):
        buf, sl = carry
        base = ((my + s) % n_slabs) * ls
        rel = ids - base
        owned = (rel >= 0) & (rel < ls)
        rows = jnp.take(sl.reshape(ls, 4 * k),
                        jnp.clip(rel, 0, ls - 1),
                        axis=0).reshape(g_n, 4, k)
        buf = jnp.where(owned[:, None, None], rows, buf)
        sl = jax.lax.ppermute(sl, axis_name, perm)
        return buf, sl

    buf, _ = jax.lax.fori_loop(0, n_slabs, step, (buf0, slab))
    bv, bh = _sweep_gathered(buf, kv_sec, x, y, cos_t, sin_t, inv_c,
                             inv_s, chunk)
    r = jnp.minimum(jnp.minimum(bv, bh), max_range)
    isv = bv <= bh
    hit = jnp.minimum(bv, bh) < max_range
    return r, isv, hit


def _ring_fwd(slab, ids, x, y, cos_t, sin_t, kv_sec, n_slabs, ls,
              axis_name, max_range, chunk):
    r, isv, hit = _ring_fwd_impl(slab, ids, x, y, cos_t, sin_t, kv_sec,
                                 n_slabs, ls, axis_name, max_range, chunk)
    return r, (jnp.shape(slab), jnp.shape(ids), r, isv, hit, cos_t, sin_t)


def _ring_bwd(kv_sec, n_slabs, ls, axis_name, max_range, chunk, res, g):
    from ..ops.raycast_grad import _winner_vjp
    sshape, ishape, r, isv, hit, cos_t, sin_t = res
    gx, gy, gct, gst = _winner_vjp(r, isv, hit, cos_t, sin_t, g)
    ids_ct = np.zeros(ishape, jax.dtypes.float0)
    return (jnp.zeros(sshape, jnp.float32), ids_ct, gx, gy, gct, gst)


_ring_raycast.defvjp(_ring_fwd, _ring_bwd)


def shard_sector_table(mesh: Mesh, smap, axis: str = "beams"):
    """Pad the table's list rows to the ``axis`` size and return the
    row-sharded array (axis 0 split over ``axis``) + the per-device slab
    row count. The pad rows are never-hit sentinels."""
    from jax.sharding import NamedSharding
    s = mesh.shape[axis]
    t = np.asarray(smap.table)
    l, _, k = t.shape
    lp = -(-l // s) * s
    if lp != l:
        pad = np.zeros((lp - l, 4, k), np.float32)
        pad[:, 0] = _FAR
        pad[:, 1] = 1.0
        pad[:, 2] = -1.0
        t = np.concatenate([t, pad], axis=0)
    sharded = jax.device_put(
        jnp.asarray(t), NamedSharding(mesh, P(axis, None, None)))
    return sharded, lp // s


def make_ring_scan(mesh: Mesh, smap, num_beams: int, fov: float,
                   max_range: float = 10.0):
    """Build ``scan(poses) -> ranges`` with the sector table ring-sharded
    over the mesh's 'beams' axis (module doc). Bit-parity with the
    replicated ``scan_poses_sectors`` (tests/test_ringmap.py);
    differentiable in poses through the standard analytic VJP.
    """
    from jax import shard_map
    from ..ops.common import apply_extent_mask

    s = mesh.shape["beams"]
    nb_shards = s
    if num_beams % nb_shards:
        raise ValueError(f"num_beams={num_beams} not divisible by "
                         f"beams mesh axis {nb_shards}")
    bb = sector_block_width(smap, num_beams, fov)
    table_sharded, ls = shard_sector_table(mesh, smap)
    offs_full = beam_angles(num_beams, fov)
    ns = smap.ns
    kv = smap.kv_sec

    def shard_body(offs, poses, slab):
        x0 = poses[:, 0]
        y0 = poses[:, 1]
        b_loc = offs.shape[0]
        pad_l = (-b_loc) % bb
        if pad_l:
            offs = jnp.concatenate(
                [offs, jnp.broadcast_to(offs[-1:], (pad_l,))])
        from ..ops.common import fan_cos_sin
        ct, st = fan_cos_sin(poses[:, 2], offs)
        xb = jnp.broadcast_to(x0[:, None], ct.shape)
        yb = jnp.broadcast_to(y0[:, None], ct.shape)
        ids = _list_ids(smap.tiles_shape, smap.tile_size, smap.tile_origin,
                        ns, x0, y0, ct, st, bb)          # (A_loc, NBLK)
        a_n, bp = ct.shape
        nblk = bp // bb
        shp = lambda v: v.reshape(a_n * nblk, bb)
        r = _ring_raycast(slab, ids.reshape(-1), shp(xb), shp(yb),
                          shp(ct), shp(st), kv, s, ls, "beams",
                          max_range, 64)
        r = r.reshape(a_n, bp)[:, :b_loc]
        return apply_extent_mask(r, x0, y0, smap.extent, max_range)

    fn = shard_map(shard_body, mesh=mesh,
                   in_specs=(P("beams"), P("agents", None),
                             P("beams", None, None)),
                   out_specs=P("agents", "beams"), check_vma=False)

    def scan(poses):
        return fn(offs_full, poses, table_sharded)

    return scan
