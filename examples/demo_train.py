"""Demo: train a reactive steering policy by BPTT through the simulator.

A linear scan->steer policy (one weight per beam + bias) is trained with
``parallel.train.make_bptt_train_fn``: each optimizer step
value_and_grad's a T-step closed-loop rollout of the FULL production
step (smooth-steering input processing -> ST dynamics -> sector-culled
1080-beam raycast -> TTC latch) and applies an optax Adam update — the
capability the reference (forward-only simulation, SURVEY.md §2b)
cannot offer, at thousands of agents per device (rate on the card: not
measured yet; scripts/bench_train.py measures it).

The objective rewards forward clearance: the policy learns to steer
toward open space. Collisions (latched cars) show up directly in the
loss trace.

    python examples/demo_train.py [--agents N] [--steps T] [--iters K]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--beams", type=int, default=180)
    ap.add_argument("--map", default="levine")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import optax
    import pyracecarsimulator_tpu as rc
    from pyracecarsimulator_tpu.config import ScanParams, SimParams
    from pyracecarsimulator_tpu.parallel import make_bptt_train_fn
    from pyracecarsimulator_tpu.state import state_from_pose

    B = args.beams
    bundle = rc.build_sim(
        args.map, scan=ScanParams(num_beams=B),
        sim=SimParams(dt=0.04, steer_mode="smooth"), backend="sectors")
    step = rc.make_step_fn(bundle, with_noise=False)

    # spawn in free space
    t = bundle.track
    edf = np.asarray(t.edf)[: t.height, : t.width]
    rng = np.random.RandomState(0)
    ys, xs = np.where(edf > 0.5)
    k = rng.randint(len(ys), size=args.agents)
    s0 = state_from_pose(
        jnp.asarray(t.origin_x + (xs[k] + .5) * t.resolution),
        jnp.asarray(t.origin_y + (ys[k] + .5) * t.resolution),
        jnp.asarray(rng.uniform(-np.pi, np.pi, args.agents),
                    jnp.float32))

    def policy(params, state, ranges, tt):
        # normalized range features keep the tanh head out of saturation
        feats = (ranges - 5.0) / 10.0
        steer = jnp.tanh(feats @ params["w"] + params["b"])
        steer = jnp.where(tt > 0, steer, 0.0)     # t=0: no scan yet
        return jnp.full(state.batch_shape, 2.5), steer

    def loss_fn(out, tt):
        clearance = jnp.mean(out.ranges, axis=-1)          # (A,)
        crash = out.collision.astype(jnp.float32)
        return jnp.mean(-clearance + 25.0 * crash)

    train, init = make_bptt_train_fn(
        step, policy, loss_fn, num_steps=args.steps, num_beams=B,
        optimizer=optax.adam(1e-2))
    params = {"w": jnp.zeros((B,)), "b": jnp.zeros(())}
    opt_state = init(params)

    for it in range(args.iters):
        params, opt_state, loss, final = train(params, opt_state, s0)
        if it % max(1, args.iters // 10) == 0 or it == args.iters - 1:
            crashed = int(np.asarray(final.collision).sum())
            print(f"iter {it:3d}  loss {float(loss):+.4f}  "
                  f"crashed {crashed}/{args.agents}")
    print("|w|_1 =", float(jnp.sum(jnp.abs(params['w']))),
          " b =", float(params["b"]))


if __name__ == "__main__":
    main()
