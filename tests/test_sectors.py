"""Sector-culled raycast backend: parity vs the geometric oracle.

The sector backend (maps/sectors.py + ops/raycast_sectors.py) must be an
exact acceleration of the `segments` backend: conservative culling, same
first-intersection values, same analytic VJP.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyracecarsimulator_tpu.maps.sectors import build_sector_map
from pyracecarsimulator_tpu.maps.segments import (
    build_segment_map, extract_segments, raycast_segments_numpy)
from pyracecarsimulator_tpu.ops.raycast_sectors import (
    raycast_sectors, scan_poses_sectors)
from pyracecarsimulator_tpu.ops.raycast_grad import raycast_all_diff
from pyracecarsimulator_tpu.ops.common import rays_from_poses

FOV = 4.712388980384690
MAXR = 4.0


@pytest.fixture(scope="module")
def blobby():
    rng = np.random.RandomState(7)
    H = W = 220
    occ = np.zeros((H, W), np.float32)
    occ[:3, :] = 1; occ[-3:, :] = 1; occ[:, :3] = 1; occ[:, -3:] = 1
    for _ in range(40):
        r, c = rng.randint(10, H - 12), rng.randint(10, W - 12)
        h, w = rng.randint(2, 9, 2)
        occ[r:r + h, c:c + w] = 1
    res = 0.05
    org = (-H * res / 2, -W * res / 2)
    smap = build_sector_map(occ, res, org, max_range=MAXR, tile_size=1.0,
                            ns=8, block_half=0.62)
    segs = extract_segments(occ, res, org)
    ys, xs = np.where(occ < 0.5)
    k = rng.randint(len(ys), size=24)
    px = org[0] + (xs[k] + .5) * res
    py = org[1] + (ys[k] + .5) * res
    th = rng.uniform(-np.pi, np.pi, 24)
    poses = jnp.asarray(np.stack([px, py, th], -1), jnp.float32)
    return occ, res, org, smap, segs, poses


def _oracle(segs, poses, num_beams):
    _, _, xb, yb, ct, st = rays_from_poses(poses, num_beams, FOV, 0)
    r = raycast_segments_numpy(
        segs, np.asarray(xb).ravel(), np.asarray(yb).ravel(),
        np.asarray(ct).ravel(), np.asarray(st).ravel(), MAXR)
    return r.reshape(poses.shape[0], num_beams)


def test_xla_matches_oracle(blobby):
    occ, res, org, smap, segs, poses = blobby
    r = scan_poses_sectors(smap, poses, num_beams=540, fov=FOV,
                           max_range=MAXR, bb=64)
    np.testing.assert_allclose(np.asarray(r), _oracle(segs, poses, 540),
                               atol=2e-5)


@pytest.mark.parametrize("mode", ["sorted", "sorted@32", "sorted_lazy",
                                  "sorted_nosort", "sorted_pt",
                                  "sorted_pt@32", "sorted_pt_nosort",
                                  "sorted_ptt", "sorted_ptt@32"])
def test_sorted_sweep_bitexact_vs_dense(blobby, mode):
    """The mean-bound length-sorted tiled sweep (all variants) must be
    BIT-exact vs the dense capacity-bound sweep: same slots swept (chunk
    counts from meta bounds; clamped final chunks only re-sweep under an
    idempotent min), sentinels in padded slots, same formulas."""
    occ, res, org, smap, segs, poses = blobby
    r_d = scan_poses_sectors(smap, poses, num_beams=540, fov=FOV,
                             max_range=MAXR, bb=64, mode="dense")
    r_s = scan_poses_sectors(smap, poses, num_beams=540, fov=FOV,
                             max_range=MAXR, bb=64, mode=mode)
    assert np.array_equal(np.asarray(r_d), np.asarray(r_s)), mode


def test_sorted_sweep_grad_matches_dense(blobby):
    """Pose/direction gradients are mode-independent (the analytic VJP
    consumes only (r, isv, hit) residuals, which must coincide)."""
    occ, res, org, smap, segs, poses = blobby

    def loss(mode, p):
        return jnp.sum(scan_poses_sectors(
            smap, p, num_beams=540, fov=FOV, max_range=MAXR, bb=64,
            mode=mode) ** 2)

    g_d = jax.grad(lambda p: loss("dense", p))(poses)
    g_s = jax.grad(lambda p: loss("sorted", p))(poses)
    np.testing.assert_array_equal(np.asarray(g_d), np.asarray(g_s))


def test_sorted_sweep_small_capacity(blobby):
    """chunk larger than a block's capacity: the sweep clamps chunk sizes
    to the (kv, kh) block widths (c_v/c_h) without value changes."""
    occ, res, org, smap, segs, poses = blobby
    r_d = scan_poses_sectors(smap, poses[:6], num_beams=540, fov=FOV,
                             max_range=MAXR, bb=64, mode="dense")
    r_s = raycast_sectors  # direct call with an oversized chunk
    from pyracecarsimulator_tpu.ops.common import rays_from_poses
    _, _, xb, yb, ct, st = rays_from_poses(poses[:6], 540, FOV, 0)
    r2 = r_s(smap.table, smap.meta, smap.tiles_shape, smap.tile_size,
             smap.tile_origin, smap.ns, smap.kv_sec, poses[:6, 0],
             poses[:6, 1], xb, yb, ct, st, MAXR, 64, 100000,
             "sorted")[:, :540]
    from pyracecarsimulator_tpu.ops.common import apply_extent_mask
    r2 = apply_extent_mask(r2, poses[:6, 0], poses[:6, 1], smap.extent,
                           MAXR)
    assert np.array_equal(np.asarray(r_d), np.asarray(r2))


def test_block_size_invariance(blobby):
    """Culling is conservative for ANY block size within block_half:
    results must not depend on bb."""
    occ, res, org, smap, segs, poses = blobby
    r64 = scan_poses_sectors(smap, poses, num_beams=540, fov=FOV,
                             max_range=MAXR, bb=64)
    r128 = scan_poses_sectors(smap, poses, num_beams=540, fov=FOV,
                              max_range=MAXR, bb=128)
    assert np.array_equal(np.asarray(r64), np.asarray(r128))


def test_grad_matches_full_set_vjp(blobby):
    occ, res, org, smap, segs, poses = blobby
    sm = build_segment_map(occ, res, org, max_range=MAXR)
    _, _, xb, yb, ct, st = rays_from_poses(poses, 540, FOV, 0)

    def loss_sec(xb_, yb_, ct_, st_):
        return jnp.sum(raycast_sectors(
            smap.table, smap.meta, smap.tiles_shape, smap.tile_size,
            smap.tile_origin, smap.ns, smap.kv_sec, poses[:, 0],
            poses[:, 1], xb_, yb_, ct_, st_, MAXR, 64, 64))

    def loss_all(xb_, yb_, ct_, st_):
        return jnp.sum(raycast_all_diff(sm.params, xb_, yb_, ct_, st_,
                                        MAXR, 1024, sm.kv))

    g1 = jax.grad(loss_sec, argnums=(0, 1, 2, 3))(xb, yb, ct, st)
    g2 = jax.grad(loss_all, argnums=(0, 1, 2, 3))(xb, yb, ct, st)
    for a, b in zip(g1, g2):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_block_half_guard(blobby):
    occ, res, org, smap, segs, poses = blobby
    with pytest.raises(ValueError, match="block_half"):
        # 60 beams over the full fov: blocks span far more than 0.62 rad
        scan_poses_sectors(smap, poses, num_beams=60, fov=FOV,
                           max_range=MAXR, bb=64)


def test_meta_is_leaf_table_swap_no_retrace(blobby):
    """Obstacle-rebuild contract: a sector map rebuilt with the same
    padded shapes must reuse the compiled scan (CLAUDE.md invariant)."""
    occ, res, org, _, segs, poses = blobby
    occ2 = occ.copy()
    occ2[100:104, 100:104] = 1.0
    # explicit shared capacity: both maps get identical padded shapes
    smap = build_sector_map(occ, res, org, max_range=MAXR, tile_size=1.0,
                            ns=8, block_half=0.62, k_sec=160)
    smap2 = build_sector_map(occ2, res, org, max_range=MAXR, tile_size=1.0,
                             ns=8, block_half=0.62, k_sec=160)
    assert smap2.table.shape == smap.table.shape

    calls = {"n": 0}

    @jax.jit
    def scan(table, meta, poses):
        calls["n"] += 1
        return raycast_sectors(
            table, meta, smap.tiles_shape, smap.tile_size,
            smap.tile_origin, smap.ns, smap.kv_sec, poses[:, 0],
            poses[:, 1], *[jnp.broadcast_to(v, (poses.shape[0], 128))
                           for v in (poses[:, 0:1], poses[:, 1:2],
                                     jnp.cos(poses[:, 2:3]),
                                     jnp.sin(poses[:, 2:3]))],
            MAXR, 128, 64)

    scan(smap.table, smap.meta, poses)
    scan(smap2.table, smap2.meta, poses)
    assert calls["n"] == 1


def test_bundled_maps_parity_1080():
    """Flagship geometry on the bundled assets: sector scan vs the full-set
    geometric oracle at 1080 beams (the scale round 2's toy-map tests did
    not cover). Also records that the berlin-class table fits the budget.
    """
    from pyracecarsimulator_tpu.maps.loader import load_builtin
    for name in ("levine", "berlin"):
        m = load_builtin(name)
        occ = np.asarray(m.occupancy)
        org = (m.origin_x, m.origin_y)
        smap = build_sector_map(occ, m.resolution, org, max_range=10.0,
                                tile_size=2.0, ns=16,
                                real_hw=(m.height, m.width))
        segs = extract_segments(occ, m.resolution, org)
        rng = np.random.RandomState(3)
        edf = np.asarray(m.edf)[: m.height, : m.width]
        ys, xs = np.where(edf > 0.3)
        k = rng.randint(len(ys), size=8)
        px = m.origin_x + (xs[k] + .5) * m.resolution
        py = m.origin_y + (ys[k] + .5) * m.resolution
        th = rng.uniform(-np.pi, np.pi, 8)
        poses = jnp.asarray(np.stack([px, py, th], -1), jnp.float32)
        r = scan_poses_sectors(smap, poses, num_beams=1080, fov=FOV,
                               max_range=10.0)
        _, _, xb, yb, ct, st = rays_from_poses(poses, 1080, FOV, 0)
        ro = raycast_segments_numpy(
            segs, np.asarray(xb).ravel(), np.asarray(yb).ravel(),
            np.asarray(ct).ravel(), np.asarray(st).ravel(), 10.0
        ).reshape(8, 1080)
        np.testing.assert_allclose(np.asarray(r), ro, atol=1e-4,
                                   err_msg=f"{name} sector parity")
        # the table must stay small next to device memory (berlin:
        # ~130 MB; a regression past 0.5 GB would break 4-map serving)
        assert np.asarray(smap.table).nbytes < 5e8


def test_facade_auto_backend_end_to_end(small_track):
    """backend='auto' resolves to sectors, steps, and survives the
    obstacle add/clear cycle without retracing."""
    from pyracecarsimulator_tpu.config import ScanParams
    from pyracecarsimulator_tpu.simulator import RacecarSimulator
    sim = RacecarSimulator(small_track,
                           scan_params=ScanParams(num_beams=64),
                           backend="auto", with_noise=False)
    assert sim.backend == "sectors"
    edf = np.asarray(small_track.edf)[: small_track.height,
                                      : small_track.width]
    iy, ix = np.unravel_index(np.argmax(edf), edf.shape)
    x = small_track.origin_x + (ix + 0.5) * small_track.resolution
    y = small_track.origin_y + (iy + 0.5) * small_track.resolution
    sim.set_pose(x, y, 0.0)
    sim.drive(2.0, 0.0)
    out = sim.update_pose()
    assert out.ranges.shape == (64,)
    assert float(out.state.velocity) > 0.0
    r_before = np.asarray(sim.run_scan())
    n0 = sim._step.jitted._cache_size()
    step_obj = sim._step
    sim.add_obstacle(x + 1.0, y, size=0.4)
    r_with = np.asarray(sim.run_scan())
    assert r_with.min() < r_before.min() + 1e-6
    sim.clear_obstacles()
    r_after = np.asarray(sim.run_scan())
    np.testing.assert_allclose(r_after, r_before, atol=1e-6)
    assert sim._step is step_obj, "step was rebuilt despite same shapes"
    assert sim._step.jitted._cache_size() == n0, "obstacle caused retrace"


def test_incremental_obstacle_matches_full_rebuild(small_track):
    """maps.sectors.add_segments: appending a rasterized obstacle's box
    segments into headroom slots must yield EXACTLY the ranges of a full
    rebuild from the mutated occupancy (extra interior segments are
    occluded by the union boundary), with unchanged leaf shapes."""
    from pyracecarsimulator_tpu.maps.loader import add_obstacle
    from pyracecarsimulator_tpu.maps.sectors import add_segments
    from pyracecarsimulator_tpu.simulator import RacecarSimulator
    from pyracecarsimulator_tpu.config import ScanParams
    t = small_track
    occ = np.asarray(t.occupancy)[: t.height, : t.width]
    smap0 = build_sector_map(occ, t.resolution,
                             (t.origin_x, t.origin_y), max_range=10.0,
                             tile_size=2.0, ns=16, headroom=8,
                             real_hw=(t.height, t.width))
    # obstacle in open space (same snapping as the facade)
    edf = np.asarray(t.edf)[: t.height, : t.width]
    iy, ix = np.unravel_index(np.argmax(edf), edf.shape)
    x = t.origin_x + (ix + 0.5) * t.resolution
    y = t.origin_y + (iy + 0.5) * t.resolution
    t2 = add_obstacle(t, x, y, size=0.4)
    occ2 = np.asarray(t2.occupancy)[: t2.height, : t2.width]
    sim = RacecarSimulator(t, scan_params=ScanParams(num_beams=64),
                           backend="sectors", with_noise=False)
    segs_box = sim._obstacle_box_segments(t, x, y, 0.4)
    smap_inc = add_segments(smap0, segs_box)
    assert smap_inc.table.shape == smap0.table.shape
    smap_full = build_sector_map(occ2, t2.resolution,
                                 (t2.origin_x, t2.origin_y),
                                 max_range=10.0, tile_size=2.0, ns=16,
                                 real_hw=(t2.height, t2.width))
    rng_l = np.random.RandomState(5)
    ys, xs = np.where(edf > 0.8)
    k = rng_l.randint(len(ys), size=16)
    px = t.origin_x + (xs[k] + .5) * t.resolution
    py = t.origin_y + (ys[k] + .5) * t.resolution
    th = rng_l.uniform(-np.pi, np.pi, 16)
    poses = jnp.asarray(np.stack([px, py, th], -1), jnp.float32)
    r_inc = scan_poses_sectors(smap_inc, poses, num_beams=540, fov=FOV,
                               max_range=10.0)
    r_full = scan_poses_sectors(smap_full, poses, num_beams=540, fov=FOV,
                                max_range=10.0)
    np.testing.assert_array_equal(np.asarray(r_inc), np.asarray(r_full))
    # facade path: incremental add + cached-pristine clear, no retrace
    sim.set_pose(x + 1.2, y, np.pi)       # looking back at the obstacle
    r_before = np.asarray(sim.run_scan())
    n0 = sim._step.jitted._cache_size()
    sim.add_obstacle(x, y, size=0.4)
    r_with = np.asarray(sim.run_scan())
    assert r_with.min() <= r_before.min() + 1e-6
    sim.clear_obstacles()
    np.testing.assert_allclose(np.asarray(sim.run_scan()), r_before,
                               atol=1e-6)
    assert sim._step.jitted._cache_size() == n0


def test_facade_map_grad_route(small_track):
    """make_scan_fn(map_grad=True): the facade-reachable hybrid
    ∂range/∂map path. Values must be bit-identical
    to the plain sector scan; the ``edf`` gradient must agree with the
    FD-validated implicit march's map cotangent (both differentiate the
    same tau surface; agreement rate bound as in test_raymarch_diff)."""
    from pyracecarsimulator_tpu.config import ScanParams
    from pyracecarsimulator_tpu.simulator import build_sim, make_scan_fn
    from pyracecarsimulator_tpu.ops.raymarch_diff import scan_poses_implicit
    t = small_track
    bundle = build_sim(t, scan=ScanParams(num_beams=128, max_range=6.0),
                       backend="sectors")
    scan_g = make_scan_fn(bundle, map_grad=True)
    scan_plain = make_scan_fn(bundle)
    edf = jnp.asarray(np.asarray(t.edf))
    rng_l = np.random.RandomState(11)
    e_real = np.asarray(t.edf)[: t.height, : t.width]
    ys, xs = np.where(e_real > 0.5)
    k = rng_l.randint(len(ys), size=8)
    poses = jnp.asarray(np.stack(
        [t.origin_x + (xs[k] + .5) * t.resolution,
         t.origin_y + (ys[k] + .5) * t.resolution,
         rng_l.uniform(-np.pi, np.pi, 8)], -1), jnp.float32)
    # forward: bit-identical straight-through values
    np.testing.assert_array_equal(
        np.asarray(scan_g(poses, edf)), np.asarray(scan_plain(poses)))
    org = jnp.asarray((t.origin_x, t.origin_y), jnp.float32)
    g_hyb = np.asarray(jax.grad(
        lambda e: jnp.sum(scan_g(poses, e) ** 2))(edf))
    g_imp = np.asarray(jax.grad(lambda e: jnp.sum(scan_poses_implicit(
        e, t.resolution, org, poses, num_beams=128, max_range=6.0,
        bounds_hw=(t.height, t.width)) ** 2))(edf))
    assert np.abs(g_hyb).sum() > 0.0          # gradients actually flow
    num = np.abs(g_hyb - g_imp).sum()
    den = np.abs(g_imp).sum() + 1e-9
    assert num / den < 0.25, num / den
    # wrong-backend guard
    b2 = build_sim(t, scan=ScanParams(num_beams=128), backend="segments")
    with pytest.raises(ValueError, match="map_grad"):
        make_scan_fn(b2, map_grad=True)


def test_multi_map_stack_matches_per_map(blobby, small_track):
    """Multi-track serving: one scan call over agents on DIFFERENT maps
    must reproduce each map's own sector scan exactly, values and pose
    gradients."""
    from pyracecarsimulator_tpu.maps.sectors import stack_sector_maps
    from pyracecarsimulator_tpu.ops.raycast_sectors import (
        scan_poses_sectors_multi)
    occ, res, org, smap_a, segs, poses_a = blobby
    t = small_track
    occ_b = np.asarray(t.occupancy)[: t.height, : t.width]
    smap_b = build_sector_map(occ_b, t.resolution,
                              (t.origin_x, t.origin_y), max_range=MAXR,
                              tile_size=1.0, ns=8, block_half=0.62,
                              real_hw=(t.height, t.width))
    stack = stack_sector_maps([smap_a, smap_b])
    rng = np.random.RandomState(2)
    edf = np.asarray(t.edf)[: t.height, : t.width]
    ys, xs = np.where(edf > 0.4)
    k = rng.randint(len(ys), size=12)
    pb = np.stack([t.origin_x + (xs[k] + .5) * t.resolution,
                   t.origin_y + (ys[k] + .5) * t.resolution,
                   rng.uniform(-np.pi, np.pi, 12)], -1)
    poses_b = jnp.asarray(pb, jnp.float32)
    poses = jnp.concatenate([poses_a[:12], poses_b], axis=0)
    map_ids = jnp.asarray([0] * 12 + [1] * 12, jnp.int32)
    r_multi = scan_poses_sectors_multi(stack, map_ids, poses,
                                       num_beams=540, fov=FOV,
                                       max_range=MAXR, bb=64)
    r_a = scan_poses_sectors(smap_a, poses_a[:12], num_beams=540, fov=FOV,
                             max_range=MAXR, bb=64)
    r_b = scan_poses_sectors(smap_b, poses_b, num_beams=540, fov=FOV,
                             max_range=MAXR, bb=64)
    np.testing.assert_array_equal(np.asarray(r_multi[:12]), np.asarray(r_a))
    np.testing.assert_array_equal(np.asarray(r_multi[12:]), np.asarray(r_b))

    # pose gradients flow through the multi path identically
    def loss_multi(p):
        return jnp.sum(scan_poses_sectors_multi(
            stack, map_ids, p, num_beams=540, fov=FOV, max_range=MAXR,
            bb=64) ** 2)

    def loss_b(p):
        return jnp.sum(scan_poses_sectors(
            smap_b, p, num_beams=540, fov=FOV, max_range=MAXR,
            bb=64) ** 2)

    gm = np.asarray(jax.grad(loss_multi)(poses))
    gb = np.asarray(jax.grad(loss_b)(poses_b))
    np.testing.assert_allclose(gm[12:], gb, rtol=1e-5, atol=1e-5)

@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("table", ["blobby", "blobby_bigk"])
def test_auto_is_dense_at_every_capacity(request, table, multi):
    """"auto" is the dense sweep whatever the table's capacity: on the
    card dense beat the sorted sweeps at every capacity measured
    (PERF.md). The rule reads no backend name, so the CPU resolves
    exactly as the GPU; here, on a small (K=72) and a larger (K=144)
    table, single- and multi-map."""
    from pyracecarsimulator_tpu.maps.sectors import stack_sector_maps
    from pyracecarsimulator_tpu.ops.raycast_sectors import (
        resolve_sector_mode, scan_poses_sectors_multi)
    assert resolve_sector_mode("auto") == "dense"
    occ, res, org, smap, segs, poses = request.getfixturevalue(table)
    kw = dict(num_beams=540, fov=FOV, max_range=MAXR, bb=128)
    if multi:
        stack = stack_sector_maps([smap])
        mids = jnp.zeros(poses.shape[0], jnp.int32)
        run = lambda m: scan_poses_sectors_multi(stack, mids, poses,
                                                 mode=m, **kw)
    else:
        run = lambda m: scan_poses_sectors(smap, poses, mode=m, **kw)
    np.testing.assert_array_equal(np.asarray(run("auto")),
                                  np.asarray(run("dense")))


@pytest.mark.parametrize("mode", ["dense", "sorted_pt@64", "sorted_ptt",
                                  "sorted_lazy@32"])
def test_explicit_modes_pass_through(mode):
    from pyracecarsimulator_tpu.ops.raycast_sectors import (
        resolve_sector_mode)
    assert resolve_sector_mode(mode) == mode


@pytest.mark.parametrize("mode", ["sorted_pl", "sorted_pl@64", "sorted_plf",
                                  "sorted_plfm@128", "sorted_plfr",
                                  "sorted_plfmr@16"])
def test_removed_modes_raise(blobby, mode):
    """Mode strings of the removed Pallas kernels fail loudly and name
    their replacement, on both the single-map and the multi-map path."""
    from pyracecarsimulator_tpu.maps.sectors import stack_sector_maps
    from pyracecarsimulator_tpu.ops.raycast_sectors import (
        scan_poses_sectors_multi)
    occ, res, org, smap, segs, poses = blobby
    with pytest.raises(ValueError, match="sorted_pt"):
        scan_poses_sectors(smap, poses, num_beams=540, fov=FOV,
                           max_range=MAXR, bb=128, mode=mode)
    with pytest.raises(ValueError, match="sorted_pt"):
        scan_poses_sectors_multi(stack_sector_maps([smap]),
                                 jnp.zeros(poses.shape[0], jnp.int32),
                                 poses, num_beams=540, fov=FOV,
                                 max_range=MAXR, bb=128, mode=mode)


def test_unknown_mode_raises(blobby):
    occ, res, org, smap, segs, poses = blobby
    with pytest.raises(ValueError, match="unknown sector sweep mode"):
        scan_poses_sectors(smap, poses, num_beams=540, fov=FOV,
                           max_range=MAXR, bb=128, mode="sorted_fast")


@pytest.mark.parametrize("mode", ["sorted_pt@32", "sorted_pt@64",
                                  "sorted_ptt@32", "sorted@32"])
def test_multi_map_sorted_bitexact(blobby, small_track, mode):
    """The length-sorted sweeps through the PRECOMPUTED-ids multi-track
    path: sorting/tiling across a cross-map agent batch must reproduce
    the dense multi sweep bit-exactly (ids are rows into the stacked
    table, so the sweep needs no multi-awareness)."""
    from pyracecarsimulator_tpu.maps.sectors import stack_sector_maps
    from pyracecarsimulator_tpu.ops.raycast_sectors import (
        scan_poses_sectors_multi)
    occ, res, org, smap_a, segs, poses_a = blobby
    t = small_track
    occ_b = np.asarray(t.occupancy)[: t.height, : t.width]
    smap_b = build_sector_map(occ_b, t.resolution,
                              (t.origin_x, t.origin_y), max_range=MAXR,
                              tile_size=1.0, ns=8, block_half=0.62,
                              real_hw=(t.height, t.width))
    stack = stack_sector_maps([smap_a, smap_b])
    rng = np.random.RandomState(3)
    edf = np.asarray(t.edf)[: t.height, : t.width]
    ys, xs = np.where(edf > 0.4)
    k = rng.randint(len(ys), size=12)
    pb = np.stack([t.origin_x + (xs[k] + .5) * t.resolution,
                   t.origin_y + (ys[k] + .5) * t.resolution,
                   rng.uniform(-np.pi, np.pi, 12)], -1)
    poses = jnp.concatenate([poses_a[:12],
                             jnp.asarray(pb, jnp.float32)], axis=0)
    map_ids = jnp.asarray([0] * 12 + [1] * 12, jnp.int32)
    kw = dict(num_beams=540, fov=FOV, max_range=MAXR, bb=128)
    r_d = scan_poses_sectors_multi(stack, map_ids, poses, mode="dense",
                                   **kw)
    r_s = scan_poses_sectors_multi(stack, map_ids, poses, mode=mode, **kw)
    np.testing.assert_array_equal(np.asarray(r_d), np.asarray(r_s))


def test_agent_chunked_matches_unchunked(blobby):
    """agent_chunk splits the batch into lax.map'd chunks; values and
    gradients must be bit-identical to the single-shot sweep (automatic
    large-batch handling)."""
    occ, res, org, smap, segs, poses = blobby
    r0 = scan_poses_sectors(smap, poses, num_beams=540, fov=FOV,
                            max_range=MAXR, bb=64, agent_chunk=0)
    # 24 poses, chunk 7 -> 4 chunks with a 4-pose pad tail
    r1 = scan_poses_sectors(smap, poses, num_beams=540, fov=FOV,
                            max_range=MAXR, bb=64, agent_chunk=7)
    np.testing.assert_array_equal(np.asarray(r0), np.asarray(r1))

    def loss(chunk):
        def f(p):
            return jnp.sum(jnp.minimum(scan_poses_sectors(
                smap, p, num_beams=540, fov=FOV, max_range=MAXR, bb=64,
                agent_chunk=chunk), MAXR - 0.1) ** 2)
        return jax.grad(f)(poses)
    g0, g1 = loss(0), loss(7)
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g1),
                               rtol=1e-6, atol=1e-6)


def test_auto_agent_chunk_thresholds(monkeypatch):
    from pyracecarsimulator_tpu.ops import raycast_sectors as rs
    # no device memory limit reported (the CPU): the fixed fallback
    monkeypatch.setattr(rs, "_chunk_bytes_budget",
                        lambda: rs._CHUNK_BYTES_FALLBACK)
    # flagship 4096-agent configs stay un-chunked on both bundled maps
    assert rs._auto_agent_chunk(4096, 9, 496) == 0
    assert rs._auto_agent_chunk(4096, 9, 32) == 0
    # 32k berlin-class splits into balanced, 128-aligned chunks
    c = rs._auto_agent_chunk(32768, 9, 496)
    assert 0 < c <= 16384 and c % 128 == 0
    cb = rs._auto_agent_chunk(33000, 9, 496)
    assert 0 < cb and cb % 128 == 0
    nc = -(-33000 // cb)
    assert nc * cb - 33000 < 0.05 * 33000   # <5% padding
    # levine-class K=32 never chunks below 65k
    assert rs._auto_agent_chunk(65536, 9, 32) == 0


@pytest.mark.parametrize("limit,chunked", [(None, True),
                                           (60e9, False), (8e9, True)])
def test_chunk_budget_follows_device_memory(monkeypatch, limit, chunked):
    """The budget is an eighth of the device's memory limit where the
    device reports one (H100: 65k berlin agents run in one shot)."""
    from pyracecarsimulator_tpu.ops import raycast_sectors as rs

    class Dev:
        def memory_stats(self):
            return None if limit is None else {"bytes_limit": limit}
    monkeypatch.setattr(rs.jax, "devices", lambda: [Dev()])
    assert (rs._auto_agent_chunk(65536, 9, 496) > 0) == chunked


@pytest.fixture(scope="module")
def blobby_bigk(blobby):
    """Same geometry at coarser tiles/sectors: a larger capacity (K=144),
    where the length-sorted sweeps have real chunks to skip."""
    occ, res, org, _, segs, poses = blobby
    smap = build_sector_map(occ, res, org, max_range=MAXR, tile_size=4.0,
                            ns=4, block_half=0.62)
    return occ, res, org, smap, segs, poses


@pytest.mark.parametrize("mode", ["sorted_pt@64", "sorted_ptt@32"])
def test_bigk_sorted_matches_dense(blobby_bigk, mode):
    """On a larger-capacity table the length-sorted sweeps skip real
    chunks; ranges and gradients are identical to the dense sweep."""
    occ, res, org, smap, segs, poses = blobby_bigk
    assert smap.table.shape[2] >= 128
    kw = dict(num_beams=540, fov=FOV, max_range=MAXR, bb=128)
    r_d = scan_poses_sectors(smap, poses, mode="dense", **kw)
    r_s = scan_poses_sectors(smap, poses, mode=mode, **kw)
    np.testing.assert_array_equal(np.asarray(r_d), np.asarray(r_s))

    def g(m):
        f = lambda p: jnp.sum(jnp.minimum(scan_poses_sectors(
            smap, p, mode=m, **kw), MAXR - 0.1) ** 2)
        return jax.grad(f)(poses)
    np.testing.assert_allclose(np.asarray(g("dense")), np.asarray(g(mode)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("multi", [False, True])
def test_sorted_pt_chunked_matches_dense(blobby_bigk, multi):
    """sorted_pt under agent chunking (pad tail included) reproduces the
    un-chunked dense sweep, single-map and multi-map."""
    from pyracecarsimulator_tpu.maps.sectors import stack_sector_maps
    from pyracecarsimulator_tpu.ops.raycast_sectors import (
        scan_poses_sectors_multi)
    occ, res, org, smap, segs, poses = blobby_bigk
    kw = dict(num_beams=540, fov=FOV, max_range=MAXR, bb=128)
    if multi:
        stack = stack_sector_maps([smap, smap])
        mids = jnp.asarray(np.arange(poses.shape[0]) % 2, jnp.int32)
        run = lambda **k: scan_poses_sectors_multi(stack, mids, poses,
                                                   **kw, **k)
    else:
        run = lambda **k: scan_poses_sectors(smap, poses, **kw, **k)
    r_d = run(mode="dense", agent_chunk=0)
    r_c = run(mode="sorted_pt@64", agent_chunk=7)
    np.testing.assert_array_equal(np.asarray(r_d), np.asarray(r_c))


def test_multi_agent_chunked_matches_unchunked(blobby_bigk):
    """Multi-track chunked execution (the large-batch path) is
    value-identical, pad tail included."""
    from pyracecarsimulator_tpu.maps.sectors import stack_sector_maps
    from pyracecarsimulator_tpu.ops.raycast_sectors import (
        scan_poses_sectors_multi)
    occ, res, org, smap, segs, poses = blobby_bigk
    stack = stack_sector_maps([smap, smap])
    mids = jnp.asarray(np.arange(poses.shape[0]) % 2, jnp.int32)
    kw = dict(num_beams=540, fov=FOV, max_range=MAXR, bb=64)
    r0 = scan_poses_sectors_multi(stack, mids, poses, agent_chunk=0, **kw)
    r1 = scan_poses_sectors_multi(stack, mids, poses, agent_chunk=7, **kw)
    np.testing.assert_array_equal(np.asarray(r0), np.asarray(r1))
