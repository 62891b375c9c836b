"""Facade + closed-loop integration tests (SURVEY.md §4 item 5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyracecarsimulator_tpu.config import CarParams, ScanParams, SimParams
from pyracecarsimulator_tpu.simulator import (
    RacecarSimulator, build_sim, make_scan_fn, make_step_fn)
from pyracecarsimulator_tpu.state import zero_state, state_from_pose
from pyracecarsimulator_tpu.parallel import (
    rollout, make_constant_policy, make_gap_follower_policy)


SCAN64 = ScanParams(num_beams=64, max_march_iters=64)


@pytest.fixture(scope="module")
def sim_bundle(request):
    # module-scope: build once for all tests here (uses the small corridor)
    import numpy as np
    from pyracecarsimulator_tpu.maps.loader import build_track_map
    h = w = 192
    occ = np.zeros((h, w), np.float32)
    occ[:4, :] = 1; occ[-4:, :] = 1; occ[:, :4] = 1; occ[:, -4:] = 1
    occ[60:132, 60:132] = 1
    track = build_track_map(occ, 0.05, (-4.8, -4.8), name="small")
    return build_sim(track, scan=SCAN64)


def _open_pose(bundle):
    edf = np.asarray(bundle.track.edf)[: bundle.track.height,
                                       : bundle.track.width]
    iy, ix = np.unravel_index(np.argmax(edf), edf.shape)
    x = bundle.track.origin_x + (ix + 0.5) * bundle.track.resolution
    y = bundle.track.origin_y + (iy + 0.5) * bundle.track.resolution
    return x, y


def test_step_shapes_and_motion(sim_bundle):
    step = make_step_fn(sim_bundle, with_noise=False)
    x, y = _open_pose(sim_bundle)
    s = state_from_pose(jnp.full((8,), x), y, 0.0)
    out = step(s, (jnp.full((8,), 2.0), jnp.zeros(8)), None)
    assert out.ranges.shape == (8, 64)
    assert out.state.x.shape == (8,)
    assert float(out.state.velocity[0]) > 0.0
    assert not bool(out.collision.any())


def test_rollout_straight_until_wall(sim_bundle):
    """Car drives forward, eventually latches collision and stops."""
    step = make_step_fn(sim_bundle, with_noise=False)
    x, y = _open_pose(sim_bundle)
    s0 = state_from_pose(jnp.array([x]), y, 0.0)
    final, traj = rollout(step, s0, make_constant_policy(5.0, 0.0),
                          num_steps=400, num_beams=64)
    assert bool(final.collision[0]), "car never hit the wall"
    assert float(final.velocity[0]) == 0.0
    poses = np.asarray(traj["pose"])  # (T, 1, 3)
    # once collided, pose freezes
    t_hit = int(np.asarray(traj["collision"]).argmax())
    assert np.allclose(poses[t_hit:, 0, 0], poses[-1, 0, 0], atol=1e-5)


def test_rollout_determinism(sim_bundle):
    step = make_step_fn(sim_bundle, with_noise=True)
    x, y = _open_pose(sim_bundle)
    s0 = state_from_pose(jnp.array([x, x]), y, 0.5)
    k = jax.random.PRNGKey(7)
    f1, t1 = rollout(step, s0, make_constant_policy(2.0, 0.1), 50, 64,
                     key=k, keep_scans=True)
    f2, t2 = rollout(step, s0, make_constant_policy(2.0, 0.1), 50, 64,
                     key=k, keep_scans=True)
    np.testing.assert_array_equal(np.asarray(t1["pose"]),
                                  np.asarray(t2["pose"]))
    np.testing.assert_array_equal(np.asarray(t1["ranges"]),
                                  np.asarray(t2["ranges"]))
    # different seed -> different noise in the scans (poses are unaffected
    # by noise under a constant policy, so compare ranges)
    f3, t3 = rollout(step, s0, make_constant_policy(2.0, 0.1), 50, 64,
                     key=jax.random.PRNGKey(8), keep_scans=True)
    assert not np.array_equal(np.asarray(t1["ranges"]),
                              np.asarray(t3["ranges"]))


def test_gap_follower_survives(sim_bundle):
    step = make_step_fn(sim_bundle, with_noise=False)
    x, y = _open_pose(sim_bundle)
    s0 = state_from_pose(jnp.array([x]), y, 0.0)
    policy = make_gap_follower_policy(64, float(SCAN64.fov), speed=2.0)
    final, traj = rollout(step, s0, policy, 300, 64)
    # reactive policy should keep the car alive far longer than ballistic
    assert not bool(final.collision[0])


def test_facade_reference_surface(sim_bundle):
    sim = RacecarSimulator(sim_bundle.track, scan_params=SCAN64,
                           with_noise=False)
    x, y = _open_pose(sim_bundle)
    sim.set_pose(x, y, 0.0)
    sim.drive(3.0, 0.0)
    out = sim.update_pose()
    assert out.ranges.shape == (64,)
    r0 = sim.run_scan()
    assert r0.shape == (64,)
    st = sim.get_state()
    assert float(st.velocity) > 0
    # state round-trip
    sim.set_state(st)
    sim.stop()
    assert float(sim.get_state().velocity) == 0.0
    assert not bool(sim.check_collision().any() if
                    hasattr(sim.check_collision(), "any")
                    else sim.check_collision())


def test_facade_obstacle_cycle(sim_bundle):
    sim = RacecarSimulator(sim_bundle.track, scan_params=SCAN64,
                           with_noise=False, backend="segments")
    x, y = _open_pose(sim_bundle)
    sim.set_pose(x, y, 0.0)
    r_before = np.asarray(sim.run_scan())
    sim.add_obstacle(x + 1.0, y, size=0.4)
    r_with = np.asarray(sim.run_scan())
    assert r_with.min() < r_before.min() + 1e-6
    # forward beam should now read ~0.8 - scan offset
    sim.clear_obstacles()
    r_after = np.asarray(sim.run_scan())
    np.testing.assert_allclose(r_after, r_before, atol=1e-6)


def test_backends_agree(sim_bundle):
    """segments vs reference-exact EDF march on the same pose (p99 < cell)."""
    x, y = _open_pose(sim_bundle)
    s = state_from_pose(jnp.array([x]), y, 1.1)
    outs = {}
    for backend in ("segments", "edf"):
        step = make_step_fn(sim_bundle, backend=backend, with_noise=False)
        outs[backend] = np.asarray(
            step(s, (jnp.zeros(1), jnp.zeros(1)), None).ranges)
    d = np.abs(outs["segments"] - outs["edf"])
    assert np.quantile(d, 0.95) < 2 * sim_bundle.track.resolution


@pytest.mark.parametrize("entry", ["build_sim", "make_scan_fn",
                                   "make_step_fn", "facade"])
def test_removed_pallas_backend_raises(sim_bundle, entry):
    """backend="segments_pallas" ran a removed Pallas kernel: every entry
    point refuses it and names the replacement."""
    with pytest.raises(ValueError, match="'sectors'"):
        if entry == "build_sim":
            build_sim(sim_bundle.track, scan=SCAN64,
                      backend="segments_pallas")
        elif entry == "make_scan_fn":
            make_scan_fn(sim_bundle, backend="segments_pallas")
        elif entry == "make_step_fn":
            make_step_fn(sim_bundle, backend="segments_pallas",
                         with_noise=False)
        else:
            RacecarSimulator(sim_bundle.track, scan_params=SCAN64,
                             backend="segments_pallas")


def test_obstacle_swap_avoids_recompile(sim_bundle):
    """Obstacle add/clear with unchanged padded shapes must reuse the
    compiled step (map rides as a traced argument)."""
    sim = RacecarSimulator(sim_bundle.track, scan_params=SCAN64,
                           with_noise=False)
    x, y = _open_pose(sim_bundle)
    sim.set_pose(x, y, 0.0)
    sim.drive(0.0, 0.0)
    sim.update_pose()
    n0 = sim._step.jitted._cache_size()
    step_obj = sim._step
    sim.add_obstacle(x + 1.0, y, size=0.3)
    sim.update_pose()
    sim.clear_obstacles()
    sim.update_pose()
    assert sim._step is step_obj, "step was rebuilt despite same shapes"
    assert sim._step.jitted._cache_size() == n0, "obstacle caused retrace"


def test_camelcase_reference_aliases(sim_bundle):
    sim = RacecarSimulator(sim_bundle.track, scan_params=SCAN64,
                           with_noise=False)
    x, y = _open_pose(sim_bundle)
    sim.setPose(x, y, 0.0)
    sim.setInput(2.0, 0.0)
    out = sim.updatePose()
    assert out.ranges.shape == (64,)
    assert sim.getScan().shape == (64,)
    assert not bool(np.asarray(sim.checkCollision()).any())
    sim.setState(sim.getState())
