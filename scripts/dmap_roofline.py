"""∂range/∂map roofline: place the hybrid path against its scatter bound.

The hybrid ∂range/∂map path (bench.py levine_dmap_hybrid) is its
backward, whose irreducible memory op is the 4-tap bilinear scatter-add
into the map cotangent (ops/raymarch_diff._wmg_bwd); everything else is
elementwise. This script measures, with the T3-T1 difference
estimator:

  1. scatter4: the isolated 4-tap scatter-add at the same (A, B) ray
     count and the same index distribution (hit points of real scans) —
     the path's hard ceiling;
  2. wmg_bwd: the full with_map_gradient VJP alone (scatter + the
     bilinear patch/gate math around it);
  3. hybrid: sector forward + VJP end-to-end (the bench.py stage, for
     cross-checking);
  4. scatter1: a single-tap scatter at the same count — isolates
     contention/formatting cost from tap multiplicity.

Usage: python scripts/dmap_roofline.py [agents] [reps]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    A = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    B = 1080
    import jax
    from pyracecarsimulator_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax.numpy as jnp
    from pyracecarsimulator_tpu.maps.loader import load_builtin
    from pyracecarsimulator_tpu.maps.sectors import build_sector_map
    from pyracecarsimulator_tpu.ops.raycast_sectors import raycast_sectors
    from pyracecarsimulator_tpu.ops.raymarch_diff import with_map_gradient
    from pyracecarsimulator_tpu.ops.raymarch_xla import beam_angles

    m = load_builtin("levine")
    smap = build_sector_map(
        np.asarray(m.occupancy), m.resolution, (m.origin_x, m.origin_y),
        max_range=10.0, tile_size=2.0, ns=16,
        real_hw=(m.height, m.width))
    edf = np.asarray(m.edf)[: m.height, : m.width]
    rng = np.random.RandomState(0)
    ys, xs = np.where(edf > 0.3)
    kk = rng.randint(len(ys), size=A)
    X = (m.origin_x + (xs[kk] + .5) * m.resolution).astype(np.float32)
    Y = (m.origin_y + (ys[kk] + .5) * m.resolution).astype(np.float32)
    TH = rng.uniform(-np.pi, np.pi, A).astype(np.float32)
    bp = -(-B // 128) * 128
    offs = np.asarray(beam_angles(B, 4.712388980384690), np.float32)
    offs = np.concatenate([offs, np.repeat(offs[-1:], bp - B)])
    ANG = TH[:, None] + offs[None, :]
    x0 = jnp.asarray(X); y0 = jnp.asarray(Y)
    xb = jnp.broadcast_to(x0[:, None], (A, bp))
    yb = jnp.broadcast_to(y0[:, None], (A, bp))
    ct = jnp.asarray(np.cos(ANG)); st = jnp.asarray(np.sin(ANG))
    org = jnp.asarray((m.origin_x, m.origin_y), jnp.float32)
    hw = (m.height, m.width)
    edf_j = jnp.asarray(edf)

    def sector_fwd(table, meta, xb_, yb_):
        d = xb_[0, 0] - x0[0]
        return raycast_sectors(
            table, meta, smap.tiles_shape, smap.tile_size,
            smap.tile_origin, smap.ns, smap.kv_sec, x0 + d, y0 + d,
            xb_, yb_, ct, st, 10.0, 128, 64, False, False)

    # real hit-point flat indices for the isolated scatters (same
    # distribution the hybrid backward sees)
    r_real = np.asarray(sector_fwd(smap.table, smap.meta, xb, yb))
    gx = ((np.asarray(xb) + r_real * np.asarray(ct) - m.origin_x)
          / m.resolution)
    gy = ((np.asarray(yb) + r_real * np.asarray(st) - m.origin_y)
          / m.resolution)
    xs0 = np.clip(gx - 0.5, 0, edf.shape[1] - 1.0)
    ys0 = np.clip(gy - 0.5, 0, edf.shape[0] - 1.0)
    xi = np.minimum(np.floor(xs0), edf.shape[1] - 2).astype(np.int32)
    yi = np.minimum(np.floor(ys0), edf.shape[0] - 2).astype(np.int32)
    base = jnp.asarray(yi * edf.shape[1] + xi).reshape(-1)
    w4 = jnp.asarray(rng.rand(4, base.size).astype(np.float32))

    def timed1(fn, *args):
        t0 = time.perf_counter()
        s = float(fn(*args))
        assert np.isfinite(s)
        return time.perf_counter() - t0

    def timed3(fn, *args):
        t0 = time.perf_counter()
        a = fn(*args); b = fn(*args); c = fn(*args)
        s = float(a + b + c)
        assert np.isfinite(s)
        return time.perf_counter() - t0

    def report(label, fn, args, work):
        print(f"[roofline] {label}: compiling ...", file=sys.stderr,
              flush=True)
        timed1(fn, *args)
        t1 = min(timed1(fn, *args) for _ in range(3))
        t3 = min(timed3(fn, *args) for _ in range(3))
        dt = (t3 - t1) / (2.0 * reps)
        if dt <= 0:
            dt = max(t1 / reps, 1e-9)
        print(f"{label} rays/s = {work / dt:.3e}  (t1={t1:.3f} t3={t3:.3f}"
              f" reps={reps})", flush=True)
        return work / dt

    W = edf.shape[1]
    taps = (0, 1, W, W + 1)

    @jax.jit
    def scatter4(base_i, w):
        def rep(acc, i):
            flat = jnp.zeros(edf_j.size, jnp.float32)
            for t_i, off in enumerate(taps):
                flat = flat.at[base_i + off + i].add(w[t_i])
            return acc + flat[0] + flat[-1], None
        acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(reps))
        return acc

    @jax.jit
    def scatter1(base_i, w):
        def rep(acc, i):
            flat = jnp.zeros(edf_j.size, jnp.float32)
            flat = flat.at[base_i + i].add(w[0])
            return acc + flat[0] + flat[-1], None
        acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(reps))
        return acc

    @jax.jit
    def wmg(edf_a, xb_, yb_):
        def loss(e, a, b):
            d = a[0, 0] - x0[0]
            r = jnp.broadcast_to(jnp.float32(3.0) + d, (A, bp))
            return jnp.sum(with_map_gradient(e, r, a, b, ct, st,
                                             m.resolution, org, 1e-4, hw))
        def rep(acc, i):
            di = i.astype(jnp.float32) * 1e-7
            l, g = jax.value_and_grad(loss)(edf_a, xb_ + di, yb_ + di)
            return acc + l + jnp.sum(g[:2, :2]), None
        acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(reps))
        return acc

    @jax.jit
    def hybrid(table, meta, edf_a, xb_, yb_):
        def loss(e, a, b):
            r = sector_fwd(table, meta, a, b)
            r = with_map_gradient(e, r, a, b, ct, st, m.resolution, org,
                                  1e-4, hw)
            return jnp.sum(r)
        def rep(acc, i):
            di = i.astype(jnp.float32) * 1e-7
            l, g = jax.value_and_grad(loss)(edf_a, xb_ + di, yb_ + di)
            return acc + l + jnp.sum(g[:2, :2]), None
        acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(reps))
        return acc

    @jax.jit
    def fwd_only(table, meta, xb_, yb_):
        def rep(acc, i):
            di = i.astype(jnp.float32) * 1e-7
            return acc + jnp.sum(sector_fwd(table, meta, xb_ + di,
                                            yb_ + di)), None
        acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(reps))
        return acc

    # round-5 task-4 variants: sort-by-cell segment-sum attribution
    @jax.jit
    def hybrid_dedup(table, meta, edf_a, xb_, yb_):
        def loss(e, a, b):
            r = sector_fwd(table, meta, a, b)
            r = with_map_gradient(e, r, a, b, ct, st, m.resolution, org,
                                  1e-4, hw, True)
            return jnp.sum(r)
        def rep(acc, i):
            di = i.astype(jnp.float32) * 1e-7
            l, g = jax.value_and_grad(loss)(edf_a, xb_ + di, yb_ + di)
            return acc + l + jnp.sum(g[:2, :2]), None
        acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(reps))
        return acc

    @jax.jit
    def sort_only(base_i, w):
        # isolate the argsort + sorted segment_sum the dedup form adds
        def rep(acc, i):
            order = jnp.argsort(base_i + i)
            bs = jnp.take(base_i + i, order)
            ws = jnp.take(w[0], order)
            seg = jax.ops.segment_sum(ws, bs,
                                      num_segments=edf_j.size + 1,
                                      indices_are_sorted=True)
            return acc + seg[0] + seg[-2], None
        acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(reps))
        return acc

    n_rays = A * B
    r_s1 = report("scatter1", scatter1, (base, w4), base.size)
    r_s4 = report("scatter4", scatter4, (base, w4), base.size)
    r_so = report("sort_segsum1", sort_only, (base, w4), base.size)
    r_w = report("wmg_bwd", wmg, (edf_j, xb, yb), n_rays)
    r_f = report("sector_fwd", fwd_only, (smap.table, smap.meta, xb, yb),
                 n_rays)
    r_h = report("hybrid_fwdbwd", hybrid,
                 (smap.table, smap.meta, edf_j, xb, yb), n_rays)
    r_hd = report("hybrid_dedup_fwdbwd", hybrid_dedup,
                  (smap.table, smap.meta, edf_j, xb, yb), n_rays)
    print(f"summary: hybrid/scatter4 = {r_h / r_s4:.2f}  "
          f"hybrid/wmg = {r_h / r_w:.2f}  wmg/scatter4 = "
          f"{r_w / r_s4:.2f}  dedup/hybrid = {r_hd / r_h:.2f}",
          flush=True)


if __name__ == "__main__":
    main()
