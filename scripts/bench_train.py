"""Training-step throughput: value_and_grad through a T-step rollout.

The framework's defining capability — BPTT through the full production
step (input proc -> dynamics -> sector scan -> TTC latch) — is
FD-checked in tests/test_rollout_grad.py; this measures its rate:
a linear scan->steer policy W (B,) drives a T-step ``lax.scan`` rollout
at A x B; the loss is the mean range over all steps; the timed unit is
``value_and_grad`` w.r.t. W (policy-parameter cotangents, which BPTT
chains through every step's state). Timing discipline: REPS
perturbed in-program reps inside one jit, T3-T1 difference estimator.

Usage: python scripts/bench_train.py [map] [T] [reps]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

FOV = 4.712388980384690


def fetch1(fn, *args):
    t0 = time.perf_counter()
    s = float(fn(*args))
    assert np.isfinite(s)
    return time.perf_counter() - t0


def fetch3(fn, *args):
    t0 = time.perf_counter()
    a = fn(*args)
    b = fn(*args)
    c = fn(*args)
    s = float(a + b + c)
    assert np.isfinite(s)
    return time.perf_counter() - t0


def make_train_loop(step, A, B, T, reps):
    import jax
    import jax.numpy as jnp
    from pyracecarsimulator_tpu.state import set_field

    @jax.jit
    def loop(state0, W):
        def rep(acc, i):
            d = i.astype(jnp.float32) * 1e-7

            def loss_fn(W):
                def body(carry, _):
                    st, r = carry
                    steer = jnp.tanh(r @ W)
                    out = step(st, (jnp.full((A,), 2.0), steer), None)
                    return (out.state, out.ranges), jnp.mean(out.ranges)

                s0 = set_field(state0, x=state0.x + d)
                (_, _), ms = jax.lax.scan(
                    body, (s0, jnp.zeros((A, B))), None, length=T)
                return jnp.sum(ms)

            l, g = jax.value_and_grad(loss_fn)(W)
            return acc + l + jnp.sum(g), None

        acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(reps))
        return acc

    return loop


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "levine"
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    import jax
    from pyracecarsimulator_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax.numpy as jnp
    from pyracecarsimulator_tpu.config import ScanParams, SimParams
    from pyracecarsimulator_tpu.maps.loader import load_builtin
    from pyracecarsimulator_tpu.simulator import build_sim, make_step_fn
    from pyracecarsimulator_tpu.state import state_from_pose

    A = int(os.environ.get("AGENTS", "4096"))
    B = 1080
    m = load_builtin(name)
    edf = np.asarray(m.edf)[: m.height, : m.width]
    rng = np.random.RandomState(0)
    ys, xs = np.where(edf > 0.3)
    k = rng.randint(len(ys), size=A)
    X = (m.origin_x + (xs[k] + .5) * m.resolution).astype(np.float32)
    Y = (m.origin_y + (ys[k] + .5) * m.resolution).astype(np.float32)
    TH = rng.uniform(-np.pi, np.pi, A).astype(np.float32)
    s0 = state_from_pose(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(TH))

    bundle = build_sim(name, scan=ScanParams(num_beams=B),
                       sim=SimParams(steer_mode="smooth"),
                       backend="sectors")
    step = make_step_fn(bundle, with_noise=False)
    loop = make_train_loop(step, A, B, T, reps)
    W = jnp.zeros((B,))

    t0 = time.time()
    fetch1(loop, s0, W)                      # compile + warm
    compile_s = time.time() - t0
    print(f"[train] {name} compiled in {compile_s:.1f}s", file=sys.stderr,
          flush=True)
    t1 = min(fetch1(loop, s0, W) for _ in range(3))
    t3 = min(fetch3(loop, s0, W) for _ in range(3))
    dt = (t3 - t1) / (2.0 * reps)            # per rep = T train'd steps
    out = {
        "map": name, "agents": A, "beams": B, "T": T, "reps": reps,
        "t1_s": round(t1, 4), "t3_s": round(t3, 4),
        "compile_s": round(compile_s, 1),
        "train_steps_s": float(f"{A * T / dt:.4g}"),
        "train_rays_s": float(f"{A * B * T / dt:.4g}"),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
