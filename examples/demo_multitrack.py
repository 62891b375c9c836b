"""Demo: multi-track batched serving — one fleet, many maps, one sweep.

A capability with no reference equivalent (the reference holds one map per
process): agents living on DIFFERENT tracks scan in a single fused call
via the stacked sector tables (maps/sectors.stack_sector_maps), so an RL
training batch can mix a whole track distribution without per-map
dispatch or recompilation.

    python examples/demo_multitrack.py [--agents 512] [--beams 360]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=512,
                    help="total agents, split across the tracks")
    ap.add_argument("--beams", type=int, default=360)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from pyracecarsimulator_tpu.maps.loader import (load_builtin,
                                                    sample_free_poses)
    from pyracecarsimulator_tpu.maps.sectors import (build_sector_map,
                                                     stack_sector_maps)
    from pyracecarsimulator_tpu.ops.raycast_sectors import (
        scan_poses_sectors, scan_poses_sectors_multi)

    names = ("levine", "berlin")
    tracks = [load_builtin(n) for n in names]
    t0 = time.time()
    smaps = [build_sector_map(
        np.asarray(t.occupancy), t.resolution, (t.origin_x, t.origin_y),
        max_range=10.0, tile_size=2.0, ns=16,
        real_hw=(t.height, t.width)) for t in tracks]
    stack = stack_sector_maps(smaps)
    print(f"stacked {len(names)} tracks in {time.time() - t0:.1f}s: "
          f"table {tuple(stack.table.shape)} "
          f"({np.asarray(stack.table).nbytes / 1e6:.0f} MB), "
          f"backend={jax.default_backend()}")

    per = args.agents // len(names)
    rng = np.random.RandomState(0)
    poses = jnp.concatenate(
        [jnp.asarray(sample_free_poses(t, per, rng)) for t in tracks])
    map_ids = jnp.asarray(np.repeat(np.arange(len(names)), per), jnp.int32)

    t0 = time.time()
    ranges = scan_poses_sectors_multi(stack, map_ids, poses,
                                      num_beams=args.beams)
    ranges.block_until_ready()
    print(f"mixed-batch scan: {tuple(ranges.shape)} "
          f"(compile+run {time.time() - t0:.1f}s)")

    # parity vs each track's own scan
    for i, (n, sm) in enumerate(zip(names, smaps)):
        own = scan_poses_sectors(sm, poses[i * per:(i + 1) * per],
                                 num_beams=args.beams)
        d = float(jnp.max(jnp.abs(ranges[i * per:(i + 1) * per] - own)))
        print(f"  {n}: max |multi - own| = {d:.2e}")

    # gradients flow per-agent into the right map's geometry
    g = jax.grad(lambda p: jnp.sum(scan_poses_sectors_multi(
        stack, map_ids, p, num_beams=args.beams) ** 2))(poses)
    print(f"pose-gradient norms per track: "
          f"{[float(jnp.linalg.norm(g[i * per:(i + 1) * per])) for i in range(len(names))]}")

    # sharded route (round 4): the full simulation step over a device
    # mesh with per-agent map routing — the BASELINE configs[4] shape
    # (a fleet training across a track distribution). Parity vs the
    # per-map unsharded steps is locked by
    # tests/test_sharding.py::test_sharded_step_multi_track.
    from pyracecarsimulator_tpu.config import ScanParams
    from pyracecarsimulator_tpu.parallel import (make_mesh,
                                                 make_sharded_step,
                                                 shard_state)
    from pyracecarsimulator_tpu.simulator import build_sim
    from pyracecarsimulator_tpu.state import state_from_pose
    ndev = len(jax.devices())
    mesh = make_mesh(agents_axis=ndev, beams_axis=1)
    bundle = build_sim(tracks[0], scan=ScanParams(num_beams=args.beams),
                       backend="sectors")
    step = make_sharded_step(mesh, bundle, with_noise=False, stack=stack)
    n = per * len(names)
    s0 = shard_state(mesh, state_from_pose(poses[:, 0], poses[:, 1],
                                           poses[:, 2]))
    t0 = time.time()
    out = step(s0, (jnp.full((n,), 2.0), jnp.zeros(n)), map_ids, None)
    float(out.state.x[0])
    print(f"sharded multi-track step on a {ndev}-device mesh: ranges "
          f"{tuple(out.ranges.shape)}, "
          f"{int(np.asarray(out.collision).sum())} collisions "
          f"(compile+run {time.time() - t0:.1f}s)")


if __name__ == "__main__":
    main()
