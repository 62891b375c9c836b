"""Device measurements for multi-track serving and the ring map-pass.

Both features are bit-parity tested on the CPU fake mesh; this measures
them on the device:

  * multi-track: ``scan_poses_sectors_multi`` over a levine+berlin
    stack, 4096 agents split across the two tracks — fwd and fwd+bwd
    rays/s, plus hardware parity vs the per-map ``scan_poses_sectors``.
  * ring map-pass: ``parallel.ringmap.make_ring_scan`` on a 1-device
    mesh (degenerate ring; multi-device rings are CPU-mesh tested and run
    by ``chip_smoke.py --four``) — device compile + parity vs the
    replicated sector scan + rate.

Timing discipline: perturbed in-program reps, T3-T1 difference
estimator. Usage: python scripts/bench_serving.py [reps]
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


def rate(loop, args, reps, work, rec, key):
    fetch1(loop, *args)
    t1 = min(fetch1(loop, *args) for _ in range(3))
    t3 = min(fetch3(loop, *args) for _ in range(3))
    dt = (t3 - t1) / (2.0 * reps)
    if dt <= 0:
        dt = max(t1 / reps, 1e-9)
        rec[f"{key}_degenerate"] = True
    rec[f"{key}_t1_s"] = round(t1, 4)
    rec[f"{key}_t3_s"] = round(t3, 4)
    return work / dt


def poses_on(m, a, seed=0):
    import jax.numpy as jnp
    edf = np.asarray(m.edf)[: m.height, : m.width]
    rng = np.random.RandomState(seed)
    ys, xs = np.where(edf > 0.3)
    k = rng.randint(len(ys), size=a)
    X = (m.origin_x + (xs[k] + .5) * m.resolution).astype(np.float32)
    Y = (m.origin_y + (ys[k] + .5) * m.resolution).astype(np.float32)
    TH = rng.uniform(-np.pi, np.pi, a).astype(np.float32)
    return jnp.asarray(np.stack([X, Y, TH], -1))


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    import jax
    from pyracecarsimulator_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax.numpy as jnp
    from pyracecarsimulator_tpu.maps.loader import load_builtin
    from pyracecarsimulator_tpu.maps.sectors import (build_sector_map,
                                                     stack_sector_maps)
    from pyracecarsimulator_tpu.ops.raycast_sectors import (
        scan_poses_sectors, scan_poses_sectors_multi)

    A = int(os.environ.get("AGENTS", "4096"))
    B = 1080
    rec = {"agents": A, "beams": B, "reps": reps,
           "device": str(jax.devices()[0])}

    maps, smaps = {}, {}
    for name in ("levine", "berlin"):
        m = load_builtin(name)
        t0 = time.time()
        smaps[name] = build_sector_map(
            np.asarray(m.occupancy), m.resolution,
            (m.origin_x, m.origin_y), max_range=10.0, tile_size=2.0,
            ns=16, real_hw=(m.height, m.width))
        maps[name] = m
        print(f"[build] {name} {time.time()-t0:.1f}s", file=sys.stderr,
              flush=True)
    stack = stack_sector_maps([smaps["levine"], smaps["berlin"]])
    rec["stack_table_mb"] = round(
        np.asarray(stack.table).nbytes / 1e6, 1)

    half = A // 2
    p_lev = poses_on(maps["levine"], half, 0)
    p_ber = poses_on(maps["berlin"], half, 1)
    poses = jnp.concatenate([p_lev, p_ber], axis=0)
    mids = jnp.concatenate([jnp.zeros(half, jnp.int32),
                            jnp.ones(half, jnp.int32)])

    @jax.jit
    def mt_fwd(stack, poses, mids):
        def rep(acc, i):
            d = i.astype(jnp.float32) * 1e-7
            r = scan_poses_sectors_multi(stack, mids, poses + d,
                                         num_beams=B, fov=FOV)
            return acc + jnp.sum(r), None
        acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(reps))
        return acc

    @jax.jit
    def mt_fb(stack, poses, mids):
        def rep(acc, i):
            d = i.astype(jnp.float32) * 1e-7
            l, g = jax.value_and_grad(lambda p: jnp.sum(
                scan_poses_sectors_multi(stack, mids, p, num_beams=B,
                                         fov=FOV)))(poses + d)
            return acc + l + jnp.sum(g[0]), None
        acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(reps))
        return acc

    print("[multitrack] compiling fwd ...", file=sys.stderr, flush=True)
    rec["multitrack_fwd_rays_s"] = float(f"""{rate(
        mt_fwd, (stack, poses, mids), reps, A * B, rec,
        'mt_fwd'):.4g}""")
    print(f"[multitrack] fwd {rec['multitrack_fwd_rays_s']:.3e}",
          file=sys.stderr, flush=True)
    print("[multitrack] compiling fwd+bwd ...", file=sys.stderr,
          flush=True)
    rec["multitrack_fwdbwd_rays_s"] = float(f"""{rate(
        mt_fb, (stack, poses, mids), reps, A * B, rec,
        'mt_fb'):.4g}""")
    print(f"[multitrack] fwd+bwd {rec['multitrack_fwdbwd_rays_s']:.3e}",
          file=sys.stderr, flush=True)

    # hardware parity: stacked sweep == per-map scans on the same poses
    @jax.jit
    def mt_parity(stack, sl, sb, poses, mids):
        r = scan_poses_sectors_multi(stack, mids, poses, num_beams=B,
                                     fov=FOV)
        r_l = scan_poses_sectors(sl, poses[:half], num_beams=B, fov=FOV)
        r_b = scan_poses_sectors(sb, poses[half:], num_beams=B, fov=FOV)
        return jnp.max(jnp.abs(r - jnp.concatenate([r_l, r_b], axis=0)))
    rec["multitrack_parity_maxabs"] = float(mt_parity(
        stack, smaps["levine"], smaps["berlin"], poses, mids))
    print(f"[multitrack] parity {rec['multitrack_parity_maxabs']:.2e}",
          file=sys.stderr, flush=True)

    # ring map-pass: degenerate 1-device ring on the real chip
    from pyracecarsimulator_tpu.parallel.mesh import make_mesh
    from pyracecarsimulator_tpu.parallel.ringmap import make_ring_scan
    mesh1 = make_mesh(jax.devices()[:1], agents_axis=1, beams_axis=1)
    ring = make_ring_scan(mesh1, smaps["berlin"], B, FOV, 10.0)

    @jax.jit
    def ring_loop(poses):
        def rep(acc, i):
            d = i.astype(jnp.float32) * 1e-7
            return acc + jnp.sum(ring(poses + d)), None
        acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(reps))
        return acc

    print("[ring] compiling 1-device ring scan (berlin) ...",
          file=sys.stderr, flush=True)
    rec["ring_1dev_rays_s"] = float(f"""{rate(
        ring_loop, (p_ber,), reps, half * B, rec,
        'ring'):.4g}""")
    print(f"[ring] rate {rec['ring_1dev_rays_s']:.3e}", file=sys.stderr,
          flush=True)

    @jax.jit
    def ring_parity(sb, poses):
        return jnp.max(jnp.abs(
            ring(poses) - scan_poses_sectors(sb, poses, num_beams=B,
                                             fov=FOV, mode="dense")))
    rec["ring_parity_maxabs"] = float(ring_parity(smaps["berlin"], p_ber))
    print(f"[ring] parity {rec['ring_parity_maxabs']:.2e}",
          file=sys.stderr, flush=True)

    print(json.dumps(rec))


if __name__ == "__main__":
    main()
