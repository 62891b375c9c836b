"""Segment backend: extraction correctness, exact-geometry parity, culling,
march-vs-geometry semantics bound (maps/segments.py module doc)."""

import numpy as np
import jax
import jax.numpy as jnp

from pyracecarsimulator_tpu.maps.segments import (
    build_segment_map, extract_segments, pad_segments,
    raycast_segments_numpy)
from pyracecarsimulator_tpu.ops.raycast_segments import (
    raycast_all, scan_poses_segments)
from pyracecarsimulator_tpu.oracle import raycast as orc


def _sample_free(track, rng, n, margin=0.3):
    edf = np.asarray(track.edf)[: track.height, : track.width]
    ys, xs = np.where(edf > margin)
    k = rng.randint(len(ys), size=n)
    x = track.origin_x + (xs[k] + 0.5) * track.resolution
    y = track.origin_y + (ys[k] + 0.5) * track.resolution
    return x, y


def test_single_cell_segments():
    """One occupied cell -> exactly its 4 boundary edges."""
    occ = np.zeros((8, 8))
    occ[3, 5] = 1.0
    segs = extract_segments(occ, 1.0, (0.0, 0.0))
    assert len(segs) == 4
    vert = segs[segs[:, 3] > 0.5]
    horz = segs[segs[:, 3] < 0.5]
    assert sorted(vert[:, 0]) == [5.0, 6.0]      # x = 5 and x = 6
    assert sorted(horz[:, 0]) == [3.0, 4.0]      # y = 3 and y = 4
    np.testing.assert_allclose(vert[:, 1:3], [[3, 4], [3, 4]])


def test_merging_collinear():
    """A 1x5 wall merges into 4 long segments, not 12."""
    occ = np.zeros((8, 8))
    occ[2, 1:6] = 1.0
    segs = extract_segments(occ, 1.0, (0.0, 0.0))
    assert len(segs) == 4
    horz = segs[segs[:, 3] < 0.5]
    np.testing.assert_allclose(sorted(horz[:, 2] - horz[:, 1]), [5.0, 5.0])


def test_known_ray_distance():
    occ = np.zeros((8, 8))
    occ[:, 6] = 1.0                    # wall column at x in [6, 7]
    segs = pad_segments(extract_segments(occ, 1.0, (0.0, 0.0)))
    r = raycast_segments_numpy(segs, [1.5], [4.0], [1.0], [0.0], 100.0)
    assert abs(r[0] - 4.5) < 1e-9      # 6 - 1.5
    # pointing away -> no hit -> clamp
    r = raycast_segments_numpy(segs, [1.5], [4.0], [-1.0], [0.0], 100.0)
    assert r[0] == 100.0


def test_jax_matches_numpy_oracle(small_track, rng):
    occ = np.asarray(small_track.occupancy)
    segs = extract_segments(occ, small_track.resolution,
                            (small_track.origin_x, small_track.origin_y))
    padded = pad_segments(segs)
    x, y = _sample_free(small_track, rng, 64)
    th = rng.uniform(-np.pi, np.pi, 64)
    ct, st = np.cos(th), np.sin(th)
    ref = raycast_segments_numpy(padded, x, y, ct, st, 10.0)
    got = np.asarray(raycast_all(
        jnp.asarray(padded.T, jnp.float32),
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
        jnp.asarray(ct, jnp.float32), jnp.asarray(st, jnp.float32), 10.0))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def test_tiled_equals_full(small_track, rng):
    occ = np.asarray(small_track.occupancy)
    sm = build_segment_map(occ, small_track.resolution,
                           (small_track.origin_x, small_track.origin_y),
                           max_range=10.0, tile_size=2.0,
                           real_hw=(small_track.height, small_track.width))
    x, y = _sample_free(small_track, rng, 32)
    poses = jnp.asarray(np.stack([x, y, rng.uniform(-3, 3, 32)], -1),
                        jnp.float32)
    a = np.asarray(scan_poses_segments(sm, poses, num_beams=64))
    b = np.asarray(scan_poses_segments(sm, poses, num_beams=64,
                                       use_tiles=False))
    np.testing.assert_array_equal(a, b)


def test_segment_map_is_split_layout(small_track, rng):
    """build_segment_map always emits the split V|H layout (kv > 0), full
    set and tiles: the mixed layout compiled for minutes on the GPU. Its
    ranges equal the mixed layout's (same segments, exact min)."""
    from pyracecarsimulator_tpu.ops.common import rays_from_poses
    occ = np.asarray(small_track.occupancy)
    org = (small_track.origin_x, small_track.origin_y)
    sm = build_segment_map(occ, small_track.resolution, org,
                           max_range=2.0, tile_size=1.0)
    assert sm.kv > 0 and sm.params.shape[1] > sm.kv
    assert sm.tiles is None or sm.kv_tile > 0
    x, y = _sample_free(small_track, rng, 8)
    poses = jnp.asarray(np.stack([x, y, rng.uniform(-3, 3, 8)], -1),
                        jnp.float32)
    _, _, xb, yb, ct, st = rays_from_poses(poses, 64, 4.71238898, 0)
    mixed = jnp.asarray(pad_segments(extract_segments(
        occ, small_track.resolution, org)).T, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(raycast_all(sm.params, xb, yb, ct, st, 2.0, 1024,
                               sm.kv)),
        np.asarray(raycast_all(mixed, xb, yb, ct, st, 2.0, 1024, 0)))


def test_march_semantics_bound(small_track, rng):
    """DT march T vs exact geometry t*: T >= t* - tiny, and overwhelmingly
    within ~2 cells; corner-grazing rays may tunnel (documented artifact of
    the reference algorithm)."""
    occ = np.asarray(small_track.occupancy)
    edf = np.asarray(small_track.edf)
    org = (small_track.origin_x, small_track.origin_y)
    segs = pad_segments(extract_segments(occ, small_track.resolution, org))
    x, y = _sample_free(small_track, rng, 128)
    th = rng.uniform(-np.pi, np.pi, 128)
    ct, st = np.cos(th), np.sin(th)
    t_star = raycast_segments_numpy(segs, x, y, ct, st, 10.0)
    T = np.array([orc.trace_ray(edf, small_track.resolution, org,
                                x[i], y[i], ct[i], st[i], 10.0, 1e-4,
                                bounds_hw=(small_track.height,
                                           small_track.width))
                  for i in range(128)])
    both_clamped = (t_star >= 10.0) & (T >= 10.0)
    diff = np.where(both_clamped, 0.0, T - t_star)
    assert diff.min() > -1e-3                      # never undershoots
    close = np.abs(diff) < 2 * small_track.resolution
    assert close.mean() > 0.95, (close.mean(), diff.max())


def test_outside_pose_max_range(small_track):
    occ = np.asarray(small_track.occupancy)
    sm = build_segment_map(occ, small_track.resolution,
                           (small_track.origin_x, small_track.origin_y),
                           real_hw=(small_track.height, small_track.width))
    r = np.asarray(scan_poses_segments(
        sm, jnp.array([[1e3, 1e3, 0.0]]), num_beams=8, max_range=10.0))
    assert (r == 10.0).all()


def test_pose_gradients_analytic():
    """d range/d pose via autodiff == closed form for a wall-facing ray."""
    occ = np.zeros((16, 16))
    occ[:, 12] = 1.0                    # wall at x = 12 (res 1.0)
    segs = pad_segments(extract_segments(occ, 1.0, (0.0, 0.0)))
    params = jnp.asarray(segs.T, jnp.float32)

    def range_of(pose):
        x, y, th = pose
        return raycast_all(params, x[None], y[None],
                           jnp.cos(th)[None], jnp.sin(th)[None], 100.0)[0]

    pose = jnp.array([2.0, 8.0, 0.3])
    g = jax.grad(range_of)(pose)
    # r = (12 - x)/cos(th): dr/dx = -1/cos, dr/dth = (12-x) sin/cos^2
    c, s = np.cos(0.3), np.sin(0.3)
    np.testing.assert_allclose(g[0], -1.0 / c, rtol=1e-5)
    np.testing.assert_allclose(g[1], 0.0, atol=1e-6)
    np.testing.assert_allclose(g[2], 10.0 * s / c ** 2, rtol=1e-5)


def test_padding_sentinels_cast_no_phantom_walls():
    """Regression: pad sentinels used to sit at p=0 with a reversed
    interval [1, -1]; the hot paths' product-form interval test
    (a-lo)*(hi-a) >= 0 ACCEPTS a in [-1, 1] for a reversed interval, so
    rays crossing x=0 with |y| <= 1 hit a phantom wall at the origin
    whenever a map leaves that region reachable (bundled tracks bury the
    origin inside the occupied infield, which hid this)."""
    import numpy as np
    import jax.numpy as jnp
    from pyracecarsimulator_tpu.maps.segments import (
        extract_segments, pad_segments, raycast_segments_numpy)
    from pyracecarsimulator_tpu.ops.raycast_segments import raycast_all

    # 40x40 map centered on the origin: fully free except the outer border
    occ = np.zeros((40, 40))
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = 1.0
    res = 0.25
    segs = extract_segments(occ, res, (-5.0, -5.0))
    params = jnp.asarray(pad_segments(segs).T, jnp.float32)
    # ray from (-3, 0) pointing +x: crosses (0, 0); the only real wall is
    # the border at x = +4.75 (inner face of the right border column)
    r = raycast_all(params, jnp.asarray([-3.0]), jnp.asarray([0.0]),
                    jnp.asarray([1.0]), jnp.asarray([0.0]), 10.0)
    expect = raycast_segments_numpy(
        pad_segments(segs), [-3.0], [0.0], [1.0], [0.0], 10.0)
    np.testing.assert_allclose(np.asarray(r), expect, rtol=1e-6)
    assert float(r[0]) > 7.0, f"phantom wall: range {float(r[0])}"
