"""Tracing / profiling utilities (SURVEY.md §5 "Tracing / profiling").

``jax.profiler`` wrappers plus a timing harness that runs its
repetitions inside one compiled program, so per-call dispatch and the
host fetch are paid once per measurement, not once per repetition.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture an XProf/Perfetto trace of the enclosed block (default
    directory: ``jax-trace`` under the temporary directory)."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "jax-trace")
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def timed_loop(fn: Callable, *args, reps: int = 20) -> float:
    """Seconds per call of ``fn(*args)`` (a jittable scalar-returning fn),
    measured as one compiled lax.scan of ``reps`` iterations + one host
    fetch. Returns per-iteration seconds.

    Every float-array argument is perturbed by ``i * 1e-30`` per iteration:
    without a data dependence on the loop index, XLA CSE-hoists the body
    and the "timing" measures one iteration.
    The perturbation is value-invisible for normal float32 magnitudes.
    """

    @jax.jit
    def loop(*a):
        def rep(acc, i):
            d = i.astype(jnp.float32) * 1e-30
            ai = [x + d if (hasattr(x, "dtype")
                            and jnp.issubdtype(x.dtype, jnp.floating))
                  else x for x in a]
            return acc + fn(*ai), None
        acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(reps))
        return acc

    float(loop(*args))                     # compile + warm
    t0 = time.perf_counter()
    float(loop(*args))
    return (time.perf_counter() - t0) / reps


def rays_per_second(scan_fn: Callable, poses, num_beams: int,
                    reps: int = 20) -> float:
    """First-class rays/s counter (SURVEY.md §5 row 1)."""
    n_rays = int(jnp.asarray(poses).shape[0]) * num_beams

    def once(poses):
        return jnp.sum(scan_fn(poses))

    sec = timed_loop(once, poses, reps=reps)
    return n_rays / sec
