"""Multi-device sharding tests on the 8-device CPU fake mesh
(SURVEY.md §4 item 4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyracecarsimulator_tpu.config import ScanParams
from pyracecarsimulator_tpu.maps.segments import build_segment_map
from pyracecarsimulator_tpu.parallel.mesh import (
    make_mesh, make_sharded_scan, make_sharded_step, shard_state)
from pyracecarsimulator_tpu.ops.raycast_grad import raycast_all_diff
from pyracecarsimulator_tpu.ops.raymarch_xla import beam_angles
from pyracecarsimulator_tpu.simulator import build_sim, make_step_fn
from pyracecarsimulator_tpu.state import state_from_pose


pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 fake devices")

NB = 128
SCAN = ScanParams(num_beams=NB)


@pytest.fixture(scope="module")
def bundle():
    from pyracecarsimulator_tpu.maps.loader import build_track_map
    h = w = 192
    occ = np.zeros((h, w), np.float32)
    occ[:4, :] = 1; occ[-4:, :] = 1; occ[:, :4] = 1; occ[:, -4:] = 1
    occ[60:132, 60:132] = 1
    track = build_track_map(occ, 0.05, (-4.8, -4.8), name="small")
    return build_sim(track, scan=SCAN)


def _poses(bundle, rng, n):
    edf = np.asarray(bundle.track.edf)[: bundle.track.height,
                                       : bundle.track.width]
    ys, xs = np.where(edf > 0.4)
    k = rng.randint(len(ys), size=n)
    x = bundle.track.origin_x + (xs[k] + 0.5) * bundle.track.resolution
    y = bundle.track.origin_y + (ys[k] + 0.5) * bundle.track.resolution
    th = rng.uniform(-np.pi, np.pi, n)
    return jnp.asarray(np.stack([x, y, th], -1), jnp.float32)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_scan_matches_single(bundle, rng, mesh_shape):
    mesh = make_mesh(agents_axis=mesh_shape[0], beams_axis=mesh_shape[1])
    scan = make_sharded_scan(mesh, bundle.segmap.params, NB,
                             float(SCAN.fov))
    poses = _poses(bundle, rng, 16)
    sharded = np.asarray(scan(poses))
    # reference: unsharded raycast
    offs = beam_angles(NB, float(SCAN.fov))
    ang = poses[:, 2:3] + offs[None, :]
    ct, st = jnp.cos(ang), jnp.sin(ang)
    xb = jnp.broadcast_to(poses[:, 0:1], ang.shape)
    yb = jnp.broadcast_to(poses[:, 1:2], ang.shape)
    ref = np.asarray(raycast_all_diff(bundle.segmap.params, xb, yb, ct, st,
                                      10.0))
    np.testing.assert_allclose(sharded, ref, atol=1e-5)


def test_sharded_scan_gradient_collective(bundle, rng):
    """Pose gradient must equal the unsharded gradient: checks the psum
    over the beams axis that shard_map's transpose inserts."""
    mesh = make_mesh(agents_axis=2, beams_axis=4)
    scan = make_sharded_scan(mesh, bundle.segmap.params, NB,
                             float(SCAN.fov))
    poses = _poses(bundle, rng, 8)

    def loss_sh(poses):
        return jnp.sum(scan(poses) ** 2)

    offs = beam_angles(NB, float(SCAN.fov))

    def loss_ref(poses):
        ang = poses[:, 2:3] + offs[None, :]
        ct, st = jnp.cos(ang), jnp.sin(ang)
        xb = jnp.broadcast_to(poses[:, 0:1], ang.shape)
        yb = jnp.broadcast_to(poses[:, 1:2], ang.shape)
        return jnp.sum(raycast_all_diff(bundle.segmap.params,
                                        xb, yb, ct, st, 10.0) ** 2)

    g_sh = np.asarray(jax.grad(loss_sh)(poses))
    g_ref = np.asarray(jax.grad(loss_ref)(poses))
    np.testing.assert_allclose(g_sh, g_ref, rtol=1e-4, atol=1e-4)


def test_sharded_step_matches_unsharded(bundle, rng):
    mesh = make_mesh(agents_axis=4, beams_axis=2)
    step_sh = make_sharded_step(mesh, bundle, with_noise=False)
    step_ref = make_step_fn(bundle, backend="segments", with_noise=False)
    poses = _poses(bundle, rng, 16)
    s0 = state_from_pose(poses[:, 0], poses[:, 1], poses[:, 2])
    s0 = shard_state(mesh, s0)
    action = (jnp.full((16,), 3.0), jnp.full((16,), 0.05))
    out_sh = step_sh(s0, action, None)
    out_ref = step_ref(state_from_pose(poses[:, 0], poses[:, 1],
                                       poses[:, 2]), action, None)
    np.testing.assert_allclose(np.asarray(out_sh.state.x),
                               np.asarray(out_ref.state.x), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out_sh.ranges),
                               np.asarray(out_ref.ranges), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out_sh.collision),
                                  np.asarray(out_ref.collision))


def test_sharded_rollout_runs(bundle, rng):
    """Multi-step closed loop under the mesh (agents+beams sharded)."""
    from pyracecarsimulator_tpu.parallel import rollout, \
        make_constant_policy
    mesh = make_mesh(agents_axis=4, beams_axis=2)
    step = make_sharded_step(mesh, bundle, with_noise=False)
    poses = _poses(bundle, rng, 8)
    s0 = shard_state(mesh, state_from_pose(poses[:, 0], poses[:, 1],
                                           poses[:, 2]))
    final, traj = rollout(step, s0, make_constant_policy(2.0, 0.0), 10, NB)
    assert np.isfinite(np.asarray(final.x)).all()
    assert traj["pose"].shape == (10, 8, 3)


def test_65k_agents_smoke(bundle):
    """BASELINE.json config 5 shape: 65k agents sharded over the mesh
    (beams kept small to bound CPU-test memory; the layout/collective
    structure is identical at 1080 beams)."""
    from pyracecarsimulator_tpu.config import ScanParams
    from pyracecarsimulator_tpu.simulator import build_sim
    small_scan = ScanParams(num_beams=16)
    b = build_sim(bundle.track, scan=small_scan)
    mesh = make_mesh(agents_axis=4, beams_axis=2)
    step = make_sharded_step(mesh, b, with_noise=False)
    n = 65536
    rng_l = np.random.RandomState(0)
    poses = _poses(b, rng_l, n)
    s0 = shard_state(mesh, state_from_pose(poses[:, 0], poses[:, 1],
                                           poses[:, 2]))
    action = (jnp.full((n,), 2.0), jnp.zeros((n,)))
    out = step(s0, action, None)
    assert out.ranges.shape == (n, 16)
    assert np.isfinite(np.asarray(out.state.x)).all()
    assert out.ranges.sharding is not None   # stays device-sharded


def test_sharded_step_simplified_backend(bundle, rng):
    """Sharded step over the contour-simplified geometry matches the
    unsharded simplified step."""
    b = build_sim(bundle.track, scan=SCAN, backend="segments_simplified")
    mesh = make_mesh(agents_axis=4, beams_axis=2)
    step_sh = make_sharded_step(mesh, b, with_noise=False)
    step_ref = make_step_fn(b, backend="segments_simplified",
                            with_noise=False)
    poses = _poses(b, rng, 8)
    s0 = shard_state(mesh, state_from_pose(poses[:, 0], poses[:, 1],
                                           poses[:, 2]))
    action = (jnp.full((8,), 2.0), jnp.zeros(8))
    out_sh = step_sh(s0, action, None)
    out_ref = step_ref(state_from_pose(poses[:, 0], poses[:, 1],
                                       poses[:, 2]), action, None)
    np.testing.assert_allclose(np.asarray(out_sh.ranges),
                               np.asarray(out_ref.ranges), atol=1e-5)


def test_sharded_step_sector_backend(bundle, rng):
    """Sharded step over the sector-culled backend (the round-3 flagship
    raycast) matches the unsharded sector step bit-for-bit on the mesh."""
    b = build_sim(bundle.track, scan=SCAN, backend="sectors")
    mesh = make_mesh(agents_axis=4, beams_axis=2)
    step_sh = make_sharded_step(mesh, b, with_noise=False)
    step_ref = make_step_fn(b, with_noise=False)
    poses = _poses(b, rng, 8)
    s0 = shard_state(mesh, state_from_pose(poses[:, 0], poses[:, 1],
                                           poses[:, 2]))
    action = (jnp.full((8,), 2.0), jnp.zeros(8))
    out_sh = step_sh(s0, action, None)
    out_ref = step_ref(state_from_pose(poses[:, 0], poses[:, 1],
                                       poses[:, 2]), action, None)
    np.testing.assert_allclose(np.asarray(out_sh.ranges),
                               np.asarray(out_ref.ranges), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out_sh.collision),
                                  np.asarray(out_ref.collision))


def test_sharded_step_multi_track(bundle, rng):
    """Multi-track stacked serving through the SHARDED step: agents on
    different maps, one fused sweep, (agents, beams) mesh.
    Ranges/collisions must match each map's own unsharded sector step."""
    from pyracecarsimulator_tpu.maps.sectors import (build_sector_map,
                                                     stack_sector_maps)
    from pyracecarsimulator_tpu.maps.loader import build_track_map
    # second track: same builder settings so the maps stack
    h = w = 192
    occ2 = np.zeros((h, w), np.float32)
    occ2[:4, :] = 1; occ2[-4:, :] = 1; occ2[:, :4] = 1; occ2[:, -4:] = 1
    occ2[40:60, 90:170] = 1
    occ2[120:168, 30:80] = 1
    track2 = build_track_map(occ2, 0.05, (-4.8, -4.8), name="small2")

    def smap_of(track):
        t = track
        return build_sector_map(
            np.asarray(t.occupancy)[: t.height, : t.width], t.resolution,
            (t.origin_x, t.origin_y), max_range=10.0, tile_size=2.0,
            ns=16, real_hw=(t.height, t.width))

    stack = stack_sector_maps([smap_of(bundle.track), smap_of(track2)])
    b_a = build_sim(bundle.track, scan=SCAN, backend="sectors")
    b_b = build_sim(track2, scan=SCAN, backend="sectors")
    mesh = make_mesh(agents_axis=4, beams_axis=2)
    step_sh = make_sharded_step(mesh, b_a, with_noise=False, stack=stack)
    poses_a = _poses(b_a, rng, 8)
    poses_b = _poses(b_b, rng, 8)
    poses = jnp.concatenate([poses_a, poses_b], axis=0)
    map_ids = jnp.asarray([0] * 8 + [1] * 8, jnp.int32)
    s0 = shard_state(mesh, state_from_pose(poses[:, 0], poses[:, 1],
                                           poses[:, 2]))
    action = (jnp.full((16,), 2.0), jnp.zeros(16))
    out_sh = step_sh(s0, action, map_ids, None)
    for b_ref, sl in ((b_a, slice(0, 8)), (b_b, slice(8, 16))):
        step_ref = make_step_fn(b_ref, with_noise=False)
        p = poses[sl]
        out_ref = step_ref(state_from_pose(p[:, 0], p[:, 1], p[:, 2]),
                           (action[0][sl], action[1][sl]), None)
        np.testing.assert_allclose(np.asarray(out_sh.ranges)[sl],
                                   np.asarray(out_ref.ranges), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(out_sh.collision)[sl],
                                      np.asarray(out_ref.collision))
        np.testing.assert_allclose(np.asarray(out_sh.state.x)[sl],
                                   np.asarray(out_ref.state.x), atol=1e-6)


def test_sharded_scan_sector_gradient(bundle, rng):
    """Sector sharded scan + its pose gradient match the dense unsharded
    reference (checks both the wedge-local block routing and the psum the
    shard_map transpose inserts on the beams axis)."""
    b = build_sim(bundle.track, scan=SCAN, backend="sectors")
    mesh = make_mesh(agents_axis=2, beams_axis=4)
    scan = make_sharded_scan(mesh, b.segmap, NB, float(SCAN.fov))
    dense = build_sim(bundle.track, scan=SCAN, backend="segments")
    offs = beam_angles(NB, float(SCAN.fov))

    def loss_ref(poses):
        ang = poses[:, 2:3] + offs[None, :]
        ct, st = jnp.cos(ang), jnp.sin(ang)
        xb = jnp.broadcast_to(poses[:, 0:1], ang.shape)
        yb = jnp.broadcast_to(poses[:, 1:2], ang.shape)
        return jnp.sum(raycast_all_diff(dense.segmap.params,
                                        xb, yb, ct, st, 10.0) ** 2)

    def loss_sh(poses):
        return jnp.sum(scan(poses) ** 2)

    poses = _poses(b, rng, 8)
    g_sh = np.asarray(jax.grad(loss_sh)(poses))
    g_ref = np.asarray(jax.grad(loss_ref)(poses))
    np.testing.assert_allclose(g_sh, g_ref, rtol=1e-4, atol=1e-4)


def test_sharded_step_map_swap_no_retrace(bundle, rng):
    """The sharded step reads its map from map_cell as a TRACED argument
    (never a closure constant — a closed-over berlin-class table
    retraces on obstacle swap and embeds ~130 MB in the compiled
    program). Swapping a same-shape rebuilt map must reuse the compiled
    executable."""
    from pyracecarsimulator_tpu.maps.sectors import build_sector_map
    b = build_sim(bundle.track, scan=SCAN, backend="sectors")
    mesh = make_mesh(agents_axis=4, beams_axis=2)
    cell = {"map": b.segmap}
    step = make_sharded_step(mesh, b, with_noise=False, map_cell=cell)
    poses = _poses(b, rng, 8)
    s0 = shard_state(mesh, state_from_pose(poses[:, 0], poses[:, 1],
                                           poses[:, 2]))
    action = (jnp.full((8,), 2.0), jnp.zeros(8))
    out0 = step(s0, action, None)
    jax.block_until_ready(out0.ranges)

    t = bundle.track
    occ = np.asarray(t.occupancy).copy()
    occ[t.height // 2, t.width // 2] = 1.0       # one-cell obstacle
    prev = b.segmap
    swapped = build_sector_map(
        occ, t.resolution, (t.origin_x, t.origin_y),
        max_range=prev.reach - prev.rt, tile_size=prev.tile_size,
        ns=prev.ns, block_half=prev.block_half,
        kvh=(prev.kv_sec, prev.table.shape[2] - prev.kv_sec),
        real_hw=(t.height, t.width))
    assert swapped.table.shape == prev.table.shape
    n0 = step.jitted._cache_size()
    cell["map"] = swapped
    out1 = step(s0, action, None)
    jax.block_until_ready(out1.ranges)
    assert step.jitted._cache_size() == n0, "map swap caused a retrace"
    # and the swapped map actually flowed through (values may change)
    assert out0.ranges.shape == out1.ranges.shape
