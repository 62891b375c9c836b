"""BPTT through the full closed-loop rollout (SURVEY.md §4 item 6).

The differentiable simulator's reason to exist: gradients of a trajectory
loss w.r.t. per-step CONTROLS, back-propagated through T steps of
dynamics + lidar scan + TTC collision latch in one `lax.scan`. Uses the
ackermann model (smooth direct speed/steer inputs — the KS/ST input path
is bang-bang steering, zero gradient a.e. by reference semantics) and the
default exact `segments` backend, whose analytic O(rays) VJP
(ops/raycast_grad.py) carries ∂range/∂pose through every step.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyracecarsimulator_tpu.config import ScanParams, SimParams
from pyracecarsimulator_tpu.simulator import build_sim, make_step_fn
from pyracecarsimulator_tpu.state import state_from_pose


def _build_bundle(backend):
    from pyracecarsimulator_tpu.maps.loader import build_track_map
    h = w = 192
    occ = np.zeros((h, w), np.float32)
    occ[:4, :] = 1; occ[-4:, :] = 1; occ[:, :4] = 1; occ[:, -4:] = 1
    occ[60:132, 60:132] = 1
    track = build_track_map(occ, 0.05, (-4.8, -4.8), name="small")
    return build_sim(track, scan=ScanParams(num_beams=64),
                     sim=SimParams(dynamics="ackermann"), backend=backend)


@pytest.fixture(scope="module")
def ack_bundle():
    return _build_bundle("segments")


@pytest.fixture(scope="module")
def ack_bundle_sectors():
    return _build_bundle("sectors")


def _open_pose(bundle):
    edf = np.asarray(bundle.track.edf)[: bundle.track.height,
                                       : bundle.track.width]
    iy, ix = np.unravel_index(np.argmax(edf), edf.shape)
    x = bundle.track.origin_x + (ix + 0.5) * bundle.track.resolution
    y = bundle.track.origin_y + (iy + 0.5) * bundle.track.resolution
    return x, y


def _make_loss(bundle, s0, T, v_des=1.5):
    """loss(steers) -> scalar through T steps of the FULL step function.

    Controls enter as traced scan inputs (not jit closure constants), so
    grad flows. Loss mixes a terminal-pose term (pure dynamics chain) with
    a clearance term (through the raycast VJP) so a wrong gradient in
    either path fails the FD check.
    """
    step = make_step_fn(bundle, with_noise=False)

    @jax.jit
    def loss(steers):
        def body(state, s_des):
            out = step(state, (jnp.full(s0.batch_shape, v_des),
                               jnp.full(s0.batch_shape, s_des)), None)
            return out.state, jnp.mean(out.ranges)
        final, clear = jax.lax.scan(body, s0, steers)
        return (jnp.sum(final.x) + jnp.sum(final.y)
                + 0.1 * jnp.sum(clear))

    return loss


def test_bptt_matches_finite_differences(ack_bundle):
    """grad through T=4 steps of dynamics+scan+TTC == central FD."""
    x, y = _open_pose(ack_bundle)
    s0 = state_from_pose(jnp.array([x]), y, 0.3)
    T = 4
    loss = _make_loss(ack_bundle, s0, T)
    steers = jnp.array([0.05, -0.08, 0.12, 0.02], jnp.float32)

    g = np.asarray(jax.grad(loss)(steers))
    assert np.all(np.isfinite(g)) and np.any(g != 0.0)

    eps = 1e-3
    fd = np.zeros(T)
    for t in range(T):
        e = jnp.zeros(T).at[t].set(eps)
        fd[t] = (float(loss(steers + e)) - float(loss(steers - e))) / (2 * eps)
    # ranges are piecewise-linear in pose: exact match away from winner
    # switches; the loose floor guards against an FD step crossing one.
    np.testing.assert_allclose(g, fd, rtol=2e-2, atol=2e-3)


def test_bptt_sectors_matches_finite_differences(ack_bundle,
                                                 ack_bundle_sectors):
    """BPTT through the FLAGSHIP backend (backend='sectors') — the path
    training users differentiate through (single-scan sector gradients
    alone do not cover it). FD-checks a T=4 rollout
    loss w.r.t. the per-step controls; the initial-pose gradient is
    checked against the FD-validated `segments` backend's AD gradient
    instead (the two backends return bit-identical ranges, so their
    rollout gradients must agree — a direct pose FD here is unreliable
    because lidar ranges are discontinuous in pose at occlusion corners
    and a 64-beam x 4-step window reliably straddles one)."""

    def make_loss(bundle):
        step = make_step_fn(bundle, with_noise=False)

        @jax.jit
        def loss(steers, pose0):
            s0 = state_from_pose(pose0[0:1], pose0[1], pose0[2])
            def body(state, s_des):
                out = step(state, (jnp.full((1,), 1.5),
                                   jnp.full((1,), s_des)), None)
                return out.state, jnp.mean(out.ranges)
            final, clear = jax.lax.scan(body, s0, steers)
            return (jnp.sum(final.x) + jnp.sum(final.y)
                    + 0.1 * jnp.sum(clear))
        return loss

    x, y = _open_pose(ack_bundle_sectors)
    T = 4
    steers = jnp.array([0.05, -0.08, 0.12, 0.02], jnp.float32)
    pose0 = jnp.array([x, y, 0.3], jnp.float32)
    loss_sec = make_loss(ack_bundle_sectors)
    loss_seg = make_loss(ack_bundle)

    gs, gp = jax.grad(loss_sec, argnums=(0, 1))(steers, pose0)
    gs, gp = np.asarray(gs), np.asarray(gp)
    assert np.all(np.isfinite(gs)) and np.any(gs != 0.0)
    assert np.all(np.isfinite(gp)) and np.any(gp != 0.0)

    eps = 1e-3
    fd_s = np.zeros(T)
    for t in range(T):
        e = jnp.zeros(T).at[t].set(eps)
        fd_s[t] = (float(loss_sec(steers + e, pose0))
                   - float(loss_sec(steers - e, pose0))) / (2 * eps)
    np.testing.assert_allclose(gs, fd_s, rtol=2e-2, atol=2e-3)

    gs2, gp2 = jax.grad(loss_seg, argnums=(0, 1))(steers, pose0)
    np.testing.assert_allclose(gp, np.asarray(gp2), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gs, np.asarray(gs2), rtol=1e-5, atol=1e-6)


def test_bptt_long_horizon_finite(ack_bundle):
    """T=40 BPTT stays finite and the early-step gradient is nonzero
    (the chain through 40 jacobians hasn't died or exploded)."""
    x, y = _open_pose(ack_bundle)
    s0 = state_from_pose(jnp.array([x, x]), y, np.pi / 4)
    T = 40
    loss = _make_loss(ack_bundle, s0, T, v_des=1.0)
    steers = jnp.asarray(0.05 * np.sin(np.arange(T) * 0.3), jnp.float32)
    g = np.asarray(jax.grad(loss)(steers))
    assert g.shape == (T,)
    assert np.all(np.isfinite(g))
    assert np.abs(g[: T // 2]).max() > 0.0, "gradient vanished through BPTT"


def test_bptt_gradient_descends(ack_bundle):
    """A few SGD steps on the controls actually improve the loss — the
    end-to-end capability the differentiable sim exists for."""
    x, y = _open_pose(ack_bundle)
    s0 = state_from_pose(jnp.array([x]), y, 0.0)
    T = 12
    step = make_step_fn(ack_bundle, with_noise=False)

    @jax.jit
    def neg_clearance(steers):
        def body(state, s_des):
            out = step(state, (jnp.full((1,), 1.5),
                               jnp.full((1,), s_des)), None)
            return out.state, jnp.min(out.ranges)
        _, min_clear = jax.lax.scan(body, s0, steers)
        return -jnp.mean(min_clear)       # maximize worst-beam clearance

    vg = jax.jit(jax.value_and_grad(neg_clearance))
    steers = jnp.full((T,), 0.3, jnp.float32)   # steer toward the block
    l0, _ = vg(steers)
    for _ in range(25):
        l, g = vg(steers)
        steers = steers - 0.05 * g
    l1 = float(neg_clearance(steers))
    assert l1 < float(l0) - 1e-3, f"no improvement: {float(l0)} -> {l1}"
