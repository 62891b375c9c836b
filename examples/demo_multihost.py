"""Demo: 65k agents across a multi-host GPU cluster (BASELINE.json config 5).

One process per host; each joins the global mesh and owns a slab of
agents. Run on every host of the slice:

    python examples/demo_multihost.py            # on every host

or simulate 8 devices on CPU:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/demo_multihost.py --agents 1024 --steps 20
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--beams-axis", type=int, default=1,
                    help="devices on the beam (sequence) axis; must divide "
                         "local device count so collectives stay on one "
                         "host's NVLink")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import pyracecarsimulator_tpu as rc
    from pyracecarsimulator_tpu.config import ScanParams
    from pyracecarsimulator_tpu.parallel import (
        make_rollout_fn, make_gap_follower_policy, shard_state)
    from pyracecarsimulator_tpu.parallel.mesh import make_sharded_step
    from pyracecarsimulator_tpu.parallel import multihost

    multihost.initialize()          # no-op single-process
    mesh = multihost.make_pod_mesh(beams_axis=args.beams_axis)
    if jax.process_index() == 0:
        print(f"mesh: {dict(mesh.shape)} over {jax.device_count()} devices, "
              f"{jax.process_count()} processes")

    bundle = rc.build_sim("levine", scan=ScanParams(num_beams=args.beams))
    step = make_sharded_step(mesh, bundle, with_noise=False)

    t = bundle.track
    edf = np.asarray(t.edf)[: t.height, : t.width]
    ys, xs = np.where(edf > 0.5)
    rng = np.random.RandomState(jax.process_index())
    k = rng.randint(len(ys), size=args.agents)
    s0 = rc.state_from_pose(
        jnp.asarray(t.origin_x + (xs[k] + .5) * t.resolution, jnp.float32),
        jnp.asarray(t.origin_y + (ys[k] + .5) * t.resolution, jnp.float32),
        jnp.asarray(rng.uniform(-np.pi, np.pi, args.agents), jnp.float32))
    s0 = shard_state(mesh, s0)

    policy = make_gap_follower_policy(args.beams, float(bundle.scan.fov))
    run = make_rollout_fn(step, policy, args.steps, args.beams)
    t0 = time.time()
    final, _ = run(s0)
    jax.block_until_ready(final.x)
    wall = time.time() - t0
    t0 = time.time()
    final, _ = run(s0)
    jax.block_until_ready(final.x)
    steady = time.time() - t0
    if jax.process_index() == 0:
        aps = args.agents * args.steps / steady
        print(f"{args.agents} agents x {args.steps} steps: "
              f"{steady:.2f}s steady ({wall:.1f}s incl compile) "
              f"-> {aps:.3e} agent-steps/s, "
              f"{aps * args.beams:.3e} rays/s (closed loop)")


if __name__ == "__main__":
    main()
