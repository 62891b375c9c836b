"""Training through the simulator: BPTT rollout-loss train steps.

The framework's defining capability (SURVEY.md §2b "gradient
parallelism": the reference has no gradients at all) packaged as a
first-class API: ``make_bptt_train_fn`` builds ONE compiled function
that rolls the production simulation step forward ``num_steps`` steps
under a parameterized policy, reverse-differentiates the rollout loss
back through every step (dynamics, raycast — via the analytic O(rays)
VJPs — and TTC latch), and applies an optax update. The same
construction is what `bench.py`'s ``train_steps_s_*`` stages time and
what ``__graft_entry__.dryrun_multichip`` exercises over the sharded
step.

Works with any step from ``simulator.make_step_fn`` (single device;
agent-chunk aware) or ``parallel.mesh.make_sharded_step``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp


def make_bptt_train_fn(step_fn: Callable, policy: Callable,
                       loss_fn: Callable, num_steps: int, num_beams: int,
                       optimizer: Any = None):
    """Build a compiled BPTT train step.

    Args:
      step_fn: ``step(state, action, key) -> StepOutput`` (the fused
        production step).
      policy: ``policy(params, state, ranges, t) -> (v_des, steer_des)``.
        At t=0 ranges are zeros (no scan yet).
      loss_fn: ``loss_fn(out: StepOutput, t) -> scalar`` per-step loss;
        the rollout loss is the mean over steps.
      num_steps: BPTT horizon T (memory: the raycast VJP keeps O(rays)
        residuals per step — ~5 * A * B floats * T).
      num_beams: scan width (fixes the carry shape).
      optimizer: an optax ``GradientTransformation``; None = plain SGD
        via ``optax.sgd(1e-2)``.

    Returns ``(train, init_opt_state)`` where
    ``train(params, opt_state, state0, key=None) ->
    (params, opt_state, loss, final_state)`` is jit-compiled, and
    ``init_opt_state(params)`` builds the optimizer state.
    """
    import optax
    if optimizer is None:
        optimizer = optax.sgd(1e-2)

    def rollout_loss(params, state0, key):
        zero_ranges = jnp.zeros(state0.batch_shape + (num_beams,))

        def body(carry, t):
            state, ranges, k = carry
            if k is not None:
                k, sub = jax.random.split(k)
            else:
                sub = None
            action = policy(params, state, ranges, t)
            out = step_fn(state, action, sub)
            return (out.state, out.ranges, k), loss_fn(out, t)

        (final, _, _), losses = jax.lax.scan(
            body, (state0, zero_ranges, key), jnp.arange(num_steps))
        return jnp.mean(losses), final

    @jax.jit
    def train(params, opt_state, state0, key=None):
        (loss, final), grads = jax.value_and_grad(
            rollout_loss, has_aux=True)(params, state0, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, final

    return train, optimizer.init
