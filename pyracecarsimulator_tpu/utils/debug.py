"""On-device sanity guards (SURVEY.md §5 "Race detection / sanitizers" row:
the analogues here are checkify/NaN guards, not thread sanitizers —
there are no data races in a pure-functional step).

Usage:
    safe_step = checked(step_fn)          # adds NaN/range checks
    out, errs = safe_step(state, action, key)
    errs.throw()                           # or inspect errs.get()
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.experimental import checkify


def checked(step_fn: Callable, max_abs_pos: float = 1e4) -> Callable:
    """Wrap a step function with checkify assertions on its outputs.

    Checks: finite state fields, finite non-negative ranges, positions
    within a sane bound. Returns ``fn(state, action, key) ->
    (StepOutput, checkify.Error)``.
    """

    def body(state, action, key=None):
        out = step_fn(state, action, key)
        s = out.state
        checkify.check(jnp.all(jnp.isfinite(s.x)), "non-finite x")
        checkify.check(jnp.all(jnp.isfinite(s.y)), "non-finite y")
        checkify.check(jnp.all(jnp.isfinite(s.theta)), "non-finite theta")
        checkify.check(jnp.all(jnp.isfinite(s.velocity)),
                       "non-finite velocity")
        checkify.check(jnp.all(jnp.isfinite(out.ranges)),
                       "non-finite scan ranges")
        checkify.check(jnp.all(out.ranges >= 0.0), "negative scan range")
        checkify.check(jnp.all(jnp.abs(s.x) < max_abs_pos),
                       "x out of bounds")
        checkify.check(jnp.all(jnp.abs(s.y) < max_abs_pos),
                       "y out of bounds")
        return out

    checked_fn = checkify.checkify(body)

    def run(state, action, key=None):
        err, out = checked_fn(state, action, key)
        return out, err

    return run
