"""BPTT training API (parallel/train.py): one compiled train step that
differentiates a rollout loss through the full production step and
applies an optax update. Verifies the loss actually DECREASES when the
policy parameter controls something learnable (steer toward open
space), and that gradients flow (non-zero updates)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyracecarsimulator_tpu.config import ScanParams, SimParams
from pyracecarsimulator_tpu.simulator import build_sim, make_step_fn
from pyracecarsimulator_tpu.state import state_from_pose
from pyracecarsimulator_tpu.parallel import make_bptt_train_fn


def test_bptt_train_step_learns():
    import optax
    B = 180
    bundle = build_sim("levine", scan=ScanParams(num_beams=B),
                      sim=SimParams(dt=0.05, steer_mode="smooth"),
                      backend="sectors")
    step = make_step_fn(bundle, with_noise=False)
    t = bundle.track
    edf = np.asarray(t.edf)[:t.height, :t.width]
    iy, ix = np.unravel_index(np.argmax(edf), edf.shape)
    x0 = t.origin_x + (ix + .5) * t.resolution
    y0 = t.origin_y + (iy + .5) * t.resolution
    A = 8
    rng = np.random.RandomState(0)
    s0 = state_from_pose(jnp.full((A,), x0) + 0.05 * rng.randn(A),
                         jnp.full((A,), y0) + 0.05 * rng.randn(A),
                         jnp.asarray(np.linspace(0, 2, A), jnp.float32))

    def policy(params, state, ranges, t):
        steer = jnp.tanh(ranges @ params["w"] + params["b"])
        return jnp.full(state.batch_shape, 2.0), steer

    def loss_fn(out, t):
        # maximize clearance: penalize short ranges (drives the policy
        # to steer away from walls) + collision penalty
        return (jnp.mean((out.ranges - 10.0) ** 2)
                + 10.0 * jnp.mean(out.collision.astype(jnp.float32)))

    train, init = make_bptt_train_fn(step, policy, loss_fn, num_steps=5,
                                     num_beams=B,
                                     optimizer=optax.adam(3e-3))
    params = {"w": jnp.zeros((B,)), "b": jnp.zeros(())}
    opt_state = init(params)
    losses = []
    for _ in range(8):
        params, opt_state, loss, final = train(params, opt_state, s0)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert float(jnp.sum(jnp.abs(params["w"]))) > 0   # gradients flowed
    assert losses[-1] < losses[0]                      # learned something
