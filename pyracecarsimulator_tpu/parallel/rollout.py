"""Closed-loop rollouts: lax.scan over time, on device, batched over agents.

The reference's rollout driver is a Python loop crossing into Cython every
step — its throughput ceiling (SURVEY.md §3.5). Here the whole T-step loop
is one compiled XLA program: ``lax.scan`` over time around the fused step,
with agents as a batch (vmap-free: the step is natively batched) — the
"closed-loop rollout: bicycle dynamics + TTC collision + scan, 4096 agents"
configuration of BASELINE.json.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..state import CarState


def make_rollout_fn(step_fn: Callable, policy: Callable, num_steps: int,
                    num_beams: int, keep_scans: bool = False):
    """Build a REUSABLE compiled rollout: ``run(state0, key) ->
    (final_state, traj)``. Use this (not repeated ``rollout`` calls) when
    benchmarking or sweeping initial conditions — each ``rollout()`` call
    builds a fresh jit closure and re-traces. ``step_fn`` may come from
    ``simulator.make_step_fn`` or ``parallel.mesh.make_sharded_step``."""

    def body(carry, t):
        state, ranges, k = carry
        if k is not None:
            k, sub = jax.random.split(k)
        else:
            sub = None
        action = policy(state, ranges, t)
        out = step_fn(state, action, sub)
        rec = {"pose": out.state.pose, "collision": out.collision}
        if keep_scans:
            rec["ranges"] = out.ranges
        return (out.state, out.ranges, k), rec

    @jax.jit
    def run(state0, key=None):
        zero_ranges = jnp.zeros(state0.batch_shape + (num_beams,))
        (final, _, _), traj = jax.lax.scan(
            body, (state0, zero_ranges, key), jnp.arange(num_steps))
        return final, traj

    return run


def rollout(step_fn: Callable, state0: CarState, policy: Callable,
            num_steps: int, num_beams: int, key=None,
            keep_scans: bool = False):
    """Run ``num_steps`` of closed-loop simulation in one XLA program.

    Args:
      step_fn: from ``simulator.make_step_fn``.
      state0: initial CarState (any batch shape).
      policy: ``policy(state, ranges, t) -> (v_des, steer_des)``. At t=0
        ranges are all zeros (no scan has happened yet); policies should
        gate on ``t > 0`` if that matters.
      num_beams: scan width (fixes the lax.scan carry shape).
      key: PRNG key for scan noise (None = noiseless).
      keep_scans: stack per-step ranges into the trajectory (memory-heavy:
        T x batch x num_beams).

    Returns:
      (final_state, traj) where traj is a dict of stacked per-step arrays:
      always poses (T, ..., 3) and collision (T, ...); plus ranges if
      ``keep_scans``.
    """
    run = make_rollout_fn(step_fn, policy, num_steps, num_beams,
                          keep_scans)
    return run(state0, key)


def make_constant_policy(v_des, steer_des):
    def policy(state, ranges, t):
        v = jnp.broadcast_to(jnp.asarray(v_des, jnp.float32),
                             state.batch_shape)
        s = jnp.broadcast_to(jnp.asarray(steer_des, jnp.float32),
                             state.batch_shape)
        return v, s
    return policy


def make_gap_follower_policy(num_beams: int, fov: float, speed: float = 3.0,
                             steer_gain: float = 0.6):
    """Tiny reactive policy: steer toward the farthest-range beam. Useful
    for demos and closed-loop benchmarks (exercises ranges -> control)."""
    import jax.numpy as jnp
    from ..ops.raymarch_xla import beam_angles
    offs = beam_angles(num_beams, fov)

    def policy(state, ranges, t):
        best = jnp.argmax(ranges, axis=-1)
        steer = steer_gain * jnp.take(offs, best)
        steer = jnp.where(t > 0, steer, 0.0)   # t=0: no scan yet
        v = jnp.full(state.batch_shape, speed)
        return v, steer
    return policy
