"""Benchmark harness. Prints ONE COMPACT JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

The stdout line is deliberately small (< ~1.2 KB) so that a reader of
only the last 2000 characters of the output gets it whole. The complete
record — every stage rate, parity gates, and the per-stage t1/t3/reps timing evidence that
makes the arithmetic auditable — is written to ``BENCH_DETAIL.json`` at
the repo root (gitignored; referenced from the stdout line as
``detail``).

Headline metric: rays/s per device, forward+backward, 1080-beam scans at
4096 agents on the levine-class map (the reference's flagship
configuration, BASELINE.json "metric"/"configs") — taken from whichever
exact-semantics path measures fastest (XLA dense / sector-culled), with the
chosen path recorded in ``extra.headline_path``. ``vs_baseline`` is
value / 1e9, the north-star target of 1e9 rays/s (fwd+bwd).

Every record names its device (``device_kind``, and the card's name and
power limit from nvidia-smi where there is one). Any stage that fails
makes the run exit non-zero after the JSON line.

Timing methodology (see .claude/skills/verify/SKILL.md):
  * Every timed region runs REPS iterations inside one jit (lax.scan),
    perturbing the loop inputs per iteration (i*1e-7) so XLA cannot
    CSE-hoist the body.
  * The per-rep time is the DIFFERENCE between one dispatch and three
    chained dispatches of the SAME executable, each min-of-3:
        T1 = C + R*t        (C = fetch + dispatch constant)
        T3 = C + 3*R*t      (three executions, one fused fetch)
        t  = (T3 - T1) / (2*R)
    The difference estimator cancels C exactly.
  * Per-stage t1/t3/reps are recorded in ``extra.timing`` so the arithmetic
    is auditable.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

FOV = 4.712388980384690


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _fetch_time(fn, *args):
    """Wall-time one dispatch + host fetch of a scalar."""
    t0 = time.perf_counter()
    s = float(fn(*args))
    assert np.isfinite(s)
    return time.perf_counter() - t0


def _fetch_time3(fn, *args):
    """Wall-time three chained dispatches with ONE fused host fetch."""
    import jax.numpy as jnp
    t0 = time.perf_counter()
    a = fn(*args)
    b = fn(*args)
    c = fn(*args)
    s = float(a + b + c)
    assert np.isfinite(s)
    return time.perf_counter() - t0


class Timing:
    """Collects per-stage timing evidence for the JSON output."""

    def __init__(self):
        self.records = {}

    def rate(self, key, loop, args, reps, work, k=3):
        """work units per second for one rep of ``loop`` (see module doc)."""
        _fetch_time(loop, *args)                      # compile + warm
        t1 = min(_fetch_time(loop, *args) for _ in range(k))
        t3 = min(_fetch_time3(loop, *args) for _ in range(k))
        dt = (t3 - t1) / (2.0 * reps)
        degenerate = dt <= 0
        if degenerate:       # jitter swamped the difference; fall back
            dt = max(t1 / reps, 1e-9)
        self.records[key] = {
            "t1_s": round(t1, 4), "t3_s": round(t3, 4), "reps": reps,
            **({"degenerate": True} if degenerate else {})}
        return work / dt


def _card() -> str:
    """The card's name and power limit, or "" where nvidia-smi is absent."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def main():
    import jax
    from pyracecarsimulator_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax.numpy as jnp
    from pyracecarsimulator_tpu.config import ScanParams
    from pyracecarsimulator_tpu.maps.loader import load_builtin
    from pyracecarsimulator_tpu.maps.segments import build_segment_map
    from pyracecarsimulator_tpu.maps.sectors import build_sector_map
    from pyracecarsimulator_tpu.ops.raycast_segments import (
        raycast_all, raycast_tiled)
    from pyracecarsimulator_tpu.ops.raycast_grad import (
        raycast_all_diff, raycast_tiled_diff)
    from pyracecarsimulator_tpu.ops.raycast_sectors import (
        raycast_sectors, resolve_sector_mode)
    from pyracecarsimulator_tpu.ops.raymarch_xla import beam_angles
    from pyracecarsimulator_tpu.simulator import build_sim, make_step_fn
    from pyracecarsimulator_tpu.state import state_from_pose
    from pyracecarsimulator_tpu.parallel import (
        make_rollout_fn, make_gap_follower_policy)

    # BENCH_AGENTS: small-batch override for CPU smoke tests
    A = int(os.environ.get("BENCH_AGENTS", "4096"))
    B = 1080
    dev = jax.devices()[0]
    extra = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices()), "card": _card()},
             "agents": A, "beams": B}
    tm = Timing()
    failed = []            # stages that raised; the run exits non-zero

    def ray_args(m, a=A):
        edf = np.asarray(m.edf)[: m.height, : m.width]
        rng = np.random.RandomState(0)
        ys, xs = np.where(edf > 0.3)
        k = rng.randint(len(ys), size=a)
        X = (m.origin_x + (xs[k] + .5) * m.resolution).astype(np.float32)
        Y = (m.origin_y + (ys[k] + .5) * m.resolution).astype(np.float32)
        TH = rng.uniform(-np.pi, np.pi, a).astype(np.float32)
        offs = np.asarray(beam_angles(B, FOV), np.float32)
        ANG = TH[:, None] + offs[None, :]
        return (jnp.asarray(X), jnp.asarray(Y),
                jnp.broadcast_to(jnp.asarray(X)[:, None], (a, B)),
                jnp.broadcast_to(jnp.asarray(Y)[:, None], (a, B)),
                jnp.asarray(np.cos(ANG)), jnp.asarray(np.sin(ANG)))

    def fwd_loop_of(once, reps):
        # NB: each rep perturbs the inputs by i*1e-7 m — otherwise XLA
        # CSE-hoists the loop-invariant scan out of the rep loop and the
        # "timing" measures one scan (observed: levine "2e12 rays/s").
        @jax.jit
        def loop(xb, yb, ct, st):
            def rep(acc, i):
                d = i.astype(jnp.float32) * 1e-7
                return acc + jnp.sum(once(xb + d, yb + d, ct, st)), None
            acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(reps))
            return acc
        return loop

    def fb_loop_of(once, reps):
        @jax.jit
        def loop(xb, yb, ct, st):
            def rep(acc, i):
                d = i.astype(jnp.float32) * 1e-7
                l, g = jax.value_and_grad(
                    lambda a, b: jnp.sum(once(a, b, ct, st)),
                    argnums=(0, 1))(xb + d, yb + d)
                return acc + l + jnp.sum(g[0]), None
            acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(reps))
            return acc
        return loop

    results = {}
    built_smaps = {}     # reused by the multitrack/ring stages

    def stage(key, once, args, reps, work, fwdbwd=True):
        try:
            _log(f"[bench] {key}: compiling fwd ...")
            results[f"{key}_fwd"] = tm.rate(
                f"{key}_fwd", fwd_loop_of(once, reps), args, reps, work)
            _log(f"[bench] {key}_fwd rays/s = {results[f'{key}_fwd']:.3e}")
            if fwdbwd:
                _log(f"[bench] {key}: compiling fwd+bwd ...")
                results[f"{key}_fwdbwd"] = tm.rate(
                    f"{key}_fwdbwd", fb_loop_of(once, reps), args, reps,
                    work)
                _log(f"[bench] {key}_fwdbwd rays/s = "
                     f"{results[f'{key}_fwdbwd']:.3e}")
        except Exception as e:
            failed.append(key)
            _log(f"[bench] {key} stage failed: {e!r}")

    for name in ("levine", "berlin"):
        m = load_builtin(name)
        sm = build_segment_map(
            np.asarray(m.occupancy), m.resolution,
            (m.origin_x, m.origin_y), max_range=10.0, tile_size=4.0,
            real_hw=(m.height, m.width))
        x0, y0, xb, yb, ct, st = ray_args(m)
        use_tiles = (sm.tiles is not None
                     and sm.tiles.shape[2] < sm.params.shape[1])
        REPS = 50 if name == "levine" else 20

        # *_diff: identical values, analytic O(rays) VJP — the fwd+bwd
        # number reflects the framework's real backward path (XLA autodiff
        # of the raw min-scan is ~10x slower backward).
        def fwd_once(xb, yb, ct, st, sm=sm, x0=x0, y0=y0,
                     use_tiles=use_tiles):
            if use_tiles:
                return raycast_tiled_diff(
                    sm.tiles, sm.tiles_shape, sm.tile_size, sm.tile_origin,
                    x0, y0, xb, yb, ct, st, 10.0, 512, sm.kv_tile)
            return raycast_all_diff(sm.params, xb, yb, ct, st, 10.0,
                                    1024, sm.kv)

        stage(name, fwd_once, (xb, yb, ct, st), REPS, A * B)

        # sector-culled backend: per-(tile, angular-sector) cull lists,
        # swept in the mode "auto" picks for the table.
        # x0/y0 are perturbed per rep too, so the per-block table-row
        # gather cannot be hoisted out of the rep loop.
        try:
            t0 = time.time()
            smap = build_sector_map(
                np.asarray(m.occupancy), m.resolution,
                (m.origin_x, m.origin_y), max_range=10.0, tile_size=2.0,
                ns=16, real_hw=(m.height, m.width))
            extra[f"{name}_sector_build_s"] = round(time.time() - t0, 2)
            extra[f"{name}_sector_table_mb"] = round(
                np.asarray(smap.table).nbytes / 1e6, 1)
            built_smaps[name] = smap

            # inputs at the padded block width, exactly as the production
            # scan_poses_sectors generates them (padding six (A, B) arrays
            # per scan instead is real device-memory copying); rays/s
            # still counts the B real beams.
            b_padded = -(-B // 128) * 128

            def pad_b(a):
                return jnp.concatenate(
                    [a, jnp.broadcast_to(a[:, -1:], (A, b_padded - B))], 1)
            xbp, ybp, ctp, stp = map(pad_b, (xb, yb, ct, st))

            sec_mode = resolve_sector_mode("auto")
            extra[f"{name}_sector_mode"] = sec_mode

            def sec_once(xb, yb, ct, st, smap=smap, x0=x0, y0=y0,
                         mode=sec_mode):
                d = xb[0, 0] - x0[0]        # the rep perturbation, (scalar)
                return raycast_sectors(
                    smap.table, smap.meta, smap.tiles_shape, smap.tile_size,
                    smap.tile_origin, smap.ns, smap.kv_sec, x0 + d, y0 + d,
                    xb, yb, ct, st, 10.0, 128, 64, mode)
            stage(f"{name}_sector", sec_once, (xbp, ybp, ctp, stp), REPS,
                  A * B)

            # hardware parity gate: sector == dense exact on this batch.
            # Tables and rays ride as jit ARGUMENTS: closed-over arrays
            # would embed berlin's 130 MB table as a compile-time constant.
            @jax.jit
            def parity(smap_a, table, tiles, a1, a2, a3, a4, b1, b2, b3,
                       b4, sm=sm, use_tiles=use_tiles, x0=x0, y0=y0):
                r_s = raycast_sectors(
                    smap_a.table, smap_a.meta, smap_a.tiles_shape,
                    smap_a.tile_size, smap_a.tile_origin, smap_a.ns,
                    smap_a.kv_sec, x0, y0, a1, a2, a3, a4, 10.0, 128,
                    64)[:, :B]
                if use_tiles:
                    r_d = raycast_tiled_diff(
                        tiles, sm.tiles_shape, sm.tile_size,
                        sm.tile_origin, x0, y0, b1, b2, b3, b4, 10.0, 512,
                        sm.kv_tile)
                else:
                    r_d = raycast_all_diff(table, b1, b2, b3, b4, 10.0,
                                           1024, sm.kv)
                return jnp.max(jnp.abs(r_s - r_d))
            extra[f"{name}_sector_parity_maxabs"] = float(parity(
                smap, sm.params, sm.tiles if use_tiles else sm.params,
                xbp, ybp, ctp, stp, xb, yb, ct, st))
            _log(f"[bench] {name}_sector parity max|d| = "
                 f"{extra[f'{name}_sector_parity_maxabs']:.2e}")
        except Exception as e:
            failed.append(f"{name}_sector")
            _log(f"[bench] {name} sector stage failed: {e!r}")

        extra[f"{name}_segments"] = int(sm.n_segments)

    # 1024-agent forward-only config (BASELINE.json configs[1])
    try:
        m = load_builtin("levine")
        sm1 = build_segment_map(
            np.asarray(m.occupancy), m.resolution,
            (m.origin_x, m.origin_y), max_range=10.0, tile_size=4.0,
            real_hw=(m.height, m.width))
        _, _, xbs, ybs, cts, sts = ray_args(m, 1024)

        def once1024(xb, yb, ct, st):
            return raycast_all(sm1.params, xb, yb, ct, st, 10.0,
                               1024, sm1.kv)
        _log("[bench] levine_1024: compiling ...")
        results["levine_1024_fwd"] = tm.rate(
            "levine_1024_fwd", fwd_loop_of(once1024, 20),
            (xbs, ybs, cts, sts), 20, 1024 * B)
        _log(f"[bench] levine_1024_fwd rays/s = "
             f"{results['levine_1024_fwd']:.3e}")
    except Exception as e:
        failed.append("levine_1024")
        _log(f"[bench] 1024-agent stage failed: {e!r}")

    # simplified-geometry backend on berlin (contour-DP, tol=1 cell)
    try:
        from pyracecarsimulator_tpu.maps.contours import (
            build_general_segment_map)
        from pyracecarsimulator_tpu.ops.raycast_general import (
            raycast_general_tiled)
        m = load_builtin("berlin")
        gm = build_general_segment_map(
            np.asarray(m.occupancy), m.resolution,
            (m.origin_x, m.origin_y), tol_cells=1.0, max_range=10.0,
            tile_size=4.0, real_hw=(m.height, m.width))
        x0, y0, xb, yb, ct, st = ray_args(m)

        def gen_once(xb, yb, ct, st):
            return raycast_general_tiled(
                gm.tiles, gm.tiles_shape, gm.tile_size, gm.tile_origin,
                x0, y0, xb, yb, ct, st, 10.0)
        extra["berlin_gsegments"] = int(gm.n_segments)
        stage("berlin_simplified", gen_once, (xb, yb, ct, st), 20, A * B)
    except Exception as e:
        failed.append("berlin_simplified")
        _log(f"[bench] simplified stage failed: {e!r}")

    # differentiable-map path: bilinear DT march, cotangent INTO THE MAP
    # (BASELINE.json configs[2] "∂range/∂map backward"). 128 agents — the
    # reverse-mode march is a long scatter-add chain, so 10 in-program
    # reps need a small batch to keep the stage short; rays/s is recorded
    # per-ray as everywhere.
    try:
        from pyracecarsimulator_tpu.ops.raymarch_xla import scan_poses
        m = load_builtin("levine")
        Ad, REPS_D = 128, 10
        x0d, y0d, *_ = ray_args(m, Ad)
        poses_d = jnp.stack([x0d, y0d, jnp.zeros(Ad)], -1)
        org = jnp.asarray((m.origin_x, m.origin_y), jnp.float32)

        @jax.jit
        def dmap_loop(edf, poses):
            def loss(e, p):
                r = scan_poses(e, m.resolution, org, p, num_beams=B,
                               max_iters=256, interp="bilinear",
                               bounds_hw=(m.height, m.width))
                return jnp.sum(r)
            def rep(acc, i):
                d = i.astype(jnp.float32) * 1e-7
                l, g = jax.value_and_grad(loss)(edf, poses + d)
                return acc + l + jnp.sum(g[:2, :2]), None
            acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(REPS_D))
            return acc

        _log("[bench] levine dmap (bilinear march, grad wrt EDF): "
             "compiling ...")
        results["levine_dmap_fwdbwd"] = tm.rate(
            "levine_dmap_fwdbwd", dmap_loop, (m.edf, poses_d), REPS_D,
            Ad * B, k=1)
        _log(f"[bench] levine_dmap_fwdbwd rays/s = "
             f"{results['levine_dmap_fwdbwd']:.3e}")
    except Exception as e:
        failed.append("levine_dmap")
        _log(f"[bench] dmap stage failed: {e!r}")

    # round-3 fast map-gradient paths (ops/raymarch_diff.py):
    #  * implicit: nearest while_loop march + IFT VJP (general EDF inputs)
    #  * hybrid: sector forward + IFT map-cotangent attachment (compiled
    #    binary maps — the framework's own map representation)
    try:
        from pyracecarsimulator_tpu.ops.raymarch_diff import (
            scan_poses_implicit, with_map_gradient)
        m = load_builtin("levine")
        Ad = 512
        x0d, y0d, xbd, ybd, ctd, std = ray_args(m, Ad)
        poses_d = jnp.stack([x0d, y0d, jnp.zeros(Ad)], -1)
        org = jnp.asarray((m.origin_x, m.origin_y), jnp.float32)

        @jax.jit
        def imp_loop(edf, poses):
            def loss(e, p):
                r = scan_poses_implicit(e, m.resolution, org, p,
                                        num_beams=B, max_iters=256,
                                        bounds_hw=(m.height, m.width))
                return jnp.sum(r)
            def rep(acc, i):
                d = i.astype(jnp.float32) * 1e-7
                l, g = jax.value_and_grad(loss)(edf, poses + d)
                return acc + l + jnp.sum(g[:2, :2]), None
            acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(10))
            return acc

        _log("[bench] levine dmap implicit: compiling ...")
        results["levine_dmap_implicit_fwdbwd"] = tm.rate(
            "levine_dmap_implicit_fwdbwd", imp_loop, (m.edf, poses_d), 10,
            Ad * B, k=2)
        _log(f"[bench] levine_dmap_implicit_fwdbwd rays/s = "
             f"{results['levine_dmap_implicit_fwdbwd']:.3e}")

        smap_d = build_sector_map(
            np.asarray(m.occupancy), m.resolution,
            (m.origin_x, m.origin_y), max_range=10.0, tile_size=2.0,
            ns=16, real_hw=(m.height, m.width))
        edf_j = jnp.asarray(np.asarray(m.edf)[: m.height, : m.width])

        @jax.jit
        def hyb_loop(edf, xb, yb, ct, st):
            def loss(e, xb_, yb_):
                d = xb_[0, 0] - x0d[0]
                r = raycast_sectors(
                    smap_d.table, smap_d.meta, smap_d.tiles_shape,
                    smap_d.tile_size, smap_d.tile_origin, smap_d.ns,
                    smap_d.kv_sec, x0d + d, y0d + d, xb_, yb_, ct, st,
                    10.0, 128, 64)
                r = with_map_gradient(e, r, xb_, yb_, ct, st,
                                      m.resolution, org, 1e-4,
                                      (m.height, m.width))
                return jnp.sum(r)
            def rep(acc, i):
                d = i.astype(jnp.float32) * 1e-7
                l, g = jax.value_and_grad(loss)(edf, xb + d, yb + d)
                return acc + l + jnp.sum(g[:2, :2]), None
            acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(10))
            return acc

        _log("[bench] levine dmap hybrid (sector fwd + IFT): compiling ..")
        results["levine_dmap_hybrid_fwdbwd"] = tm.rate(
            "levine_dmap_hybrid_fwdbwd", hyb_loop,
            (edf_j, xbd, ybd, ctd, std), 10, Ad * B)
        _log(f"[bench] levine_dmap_hybrid_fwdbwd rays/s = "
             f"{results['levine_dmap_hybrid_fwdbwd']:.3e}")

        # round-5 task-4 variant: sort-by-cell segment-sum attribution
        @jax.jit
        def hyb_dedup_loop(edf, xb, yb, ct, st):
            def loss(e, xb_, yb_):
                d = xb_[0, 0] - x0d[0]
                r = raycast_sectors(
                    smap_d.table, smap_d.meta, smap_d.tiles_shape,
                    smap_d.tile_size, smap_d.tile_origin, smap_d.ns,
                    smap_d.kv_sec, x0d + d, y0d + d, xb_, yb_, ct, st,
                    10.0, 128, 64)
                r = with_map_gradient(e, r, xb_, yb_, ct, st,
                                      m.resolution, org, 1e-4,
                                      (m.height, m.width), True)
                return jnp.sum(r)
            def rep(acc, i):
                d = i.astype(jnp.float32) * 1e-7
                l, g = jax.value_and_grad(loss)(edf, xb + d, yb + d)
                return acc + l + jnp.sum(g[:2, :2]), None
            acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(10))
            return acc

        _log("[bench] levine dmap hybrid DEDUP: compiling ..")
        results["levine_dmap_hybrid_dedup_fwdbwd"] = tm.rate(
            "levine_dmap_hybrid_dedup_fwdbwd", hyb_dedup_loop,
            (edf_j, xbd, ybd, ctd, std), 10, Ad * B)
        _log(f"[bench] levine_dmap_hybrid_dedup_fwdbwd rays/s = "
             f"{results['levine_dmap_hybrid_dedup_fwdbwd']:.3e}")
    except Exception as e:
        failed.append("levine_dmap_fast")
        _log(f"[bench] fast dmap stages failed: {e!r}")

    # closed-loop env steps/s @ 4096 agents (levine, reactive policy):
    # once on the round-2 dense backend (continuity) and once on the
    # round-3 flagship sector backend.
    m = load_builtin("levine")
    x0, y0, *_ = ray_args(m)
    s0 = state_from_pose(x0, y0, jnp.zeros(A))
    policy = make_gap_follower_policy(B, FOV, speed=3.0)
    T = 25
    # berlin rollout: the facade's "auto" sweep inside the full closed loop
    for track, backend, rkey in (
            ("levine", "segments", "env_steps_s_4096"),
            ("levine", "sectors", "env_steps_s_4096_sectors"),
            ("berlin", "sectors", "env_steps_s_4096_sectors_berlin")):
        try:
            _log(f"[bench] compiling closed-loop rollout ({track}/"
                 f"{backend}) ...")
            if track != "levine":
                mb = load_builtin(track)
                xb0, yb0, *_ = ray_args(mb)
                s0t = state_from_pose(xb0, yb0, jnp.zeros(A))
            else:
                s0t = s0
            bundle = build_sim(track, scan=ScanParams(num_beams=B),
                               backend=backend)
            step = make_step_fn(bundle, with_noise=False)
            run = make_rollout_fn(step, policy, T, B)
            t0 = time.perf_counter()
            final, _ = run(s0t)
            float(final.x[0])
            extra[f"rollout_compile_s_{track}_{backend}"] = round(
                time.perf_counter() - t0, 1)

            def one(s0t=s0t):
                t0 = time.perf_counter()
                final, _ = run(s0t)
                float(final.x[0])
                return time.perf_counter() - t0

            def three(s0t=s0t):
                t0 = time.perf_counter()
                f1, _ = run(s0t)
                f2, _ = run(s0t)
                f3, _ = run(s0t)
                float(f1.x[0] + f2.x[0] + f3.x[0])
                return time.perf_counter() - t0

            t1 = min(one() for _ in range(3))
            t3 = min(three() for _ in range(3))
            dt = max((t3 - t1) / 2.0, 1e-9) / T
            tm.records[rkey] = {"t1_s": round(t1, 4), "t3_s": round(t3, 4),
                                "reps": T}
            results[rkey] = A / dt
            _log(f"[bench] {rkey} = {results[rkey]:.3e}")
        except Exception as e:
            failed.append(rkey)
            _log(f"[bench] rollout stage ({backend}) failed: {e!r}")

    # TRAINING throughput — value_and_grad through a T-step lax.scan rollout of the production
    # sector step (BPTT into a linear scan->steer policy W whose gradient
    # chains through every step's state). The per-rep unit is T trained
    # steps; reported as agent-steps/s and effective fwd+bwd rays/s.
    try:
        from pyracecarsimulator_tpu.state import set_field
        TT, TREPS = 10, 10
        for track in ("levine", "berlin"):
            mt = load_builtin(track)
            xt, yt, *_ = ray_args(mt)
            s0t = state_from_pose(xt, yt, jnp.zeros(A))
            # smooth steering: the reference bang-bang law has zero
            # derivative w.r.t. desired steer (dynamics.compute_steer_vel
            # note), so the trained policy head needs SimParams
            # steer_mode="smooth" for non-degenerate gradients
            from pyracecarsimulator_tpu.config import SimParams
            bundle_t = build_sim(track, scan=ScanParams(num_beams=B),
                                 sim=SimParams(steer_mode="smooth"),
                                 backend="sectors")
            stept = make_step_fn(bundle_t, with_noise=False)

            @jax.jit
            def tloop(state0, W, stept=stept):
                def rep(acc, i):
                    d = i.astype(jnp.float32) * 1e-7

                    def loss_fn(W):
                        def body(carry, _):
                            st_, r = carry
                            steer = jnp.tanh(r @ W)
                            out = stept(st_, (jnp.full((A,), 2.0),
                                              steer), None)
                            return ((out.state, out.ranges),
                                    jnp.mean(out.ranges))

                        s0i = set_field(state0, x=state0.x + d)
                        (_, _), ms = jax.lax.scan(
                            body, (s0i, jnp.zeros((A, B))), None,
                            length=TT)
                        return jnp.sum(ms)

                    l, g = jax.value_and_grad(loss_fn)(W)
                    return acc + l + jnp.sum(g), None

                acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(TREPS))
                return acc

            key = f"train_steps_s_{track}"
            _log(f"[bench] {key}: compiling (BPTT T={TT}) ...")
            t0 = time.perf_counter()
            rate = tm.rate(key, tloop, (s0t, jnp.zeros((B,))), TREPS,
                           A * TT)
            extra[f"train_compile_s_{track}"] = round(
                time.perf_counter() - t0, 1)
            results[key] = rate
            results[f"train_rays_s_{track}"] = rate * B
            _log(f"[bench] {key} = {rate:.3e} agent-steps/s "
                 f"({rate * B:.3e} rays/s fwd+bwd)")
    except Exception as e:
        failed.append("train")
        _log(f"[bench] train stage failed: {e!r}")

    # multi-track stacked serving — one fused sweep over a levine+berlin stack, 50/50
    # agent split; parity vs per-map scans.
    try:
        from pyracecarsimulator_tpu.maps.sectors import (build_sector_map
                                                         as _bsm,
                                                         stack_sector_maps)
        from pyracecarsimulator_tpu.ops.raycast_sectors import (
            scan_poses_sectors, scan_poses_sectors_multi)
        smaps2 = {}
        poses2 = {}
        for nm in ("levine", "berlin"):
            mm = load_builtin(nm)
            # reuse the sector maps built in the per-map stage loop
            # (identical build args)
            smaps2[nm] = built_smaps.get(nm) or _bsm(
                np.asarray(mm.occupancy), mm.resolution,
                (mm.origin_x, mm.origin_y), max_range=10.0,
                tile_size=2.0, ns=16, real_hw=(mm.height, mm.width))
            xh, yh, *_ = ray_args(mm, A // 2)
            th = np.random.RandomState(7).uniform(
                -np.pi, np.pi, A // 2).astype(np.float32)
            poses2[nm] = jnp.stack([xh, yh, jnp.asarray(th)], -1)
        stack = stack_sector_maps([smaps2["levine"], smaps2["berlin"]])
        poses_mt = jnp.concatenate([poses2["levine"], poses2["berlin"]])
        mids = jnp.concatenate([jnp.zeros(A // 2, jnp.int32),
                                jnp.ones(A // 2, jnp.int32)])

        @jax.jit
        def mt_fb(stack, poses, mids):
            def rep(acc, i):
                d = i.astype(jnp.float32) * 1e-7
                l, g = jax.value_and_grad(lambda p: jnp.sum(
                    scan_poses_sectors_multi(stack, mids, p, num_beams=B,
                                             fov=FOV)))(poses + d)
                return acc + l + jnp.sum(g[0]), None
            acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(10))
            return acc

        _log("[bench] multitrack: compiling fwd+bwd ...")
        results["multitrack_fwdbwd"] = tm.rate(
            "multitrack_fwdbwd", mt_fb, (stack, poses_mt, mids), 10,
            A * B)
        _log(f"[bench] multitrack_fwdbwd = "
             f"{results['multitrack_fwdbwd']:.3e} rays/s")

        @jax.jit
        def mt_parity(stack, sl, sb, poses, mids):
            r = scan_poses_sectors_multi(stack, mids, poses, num_beams=B,
                                         fov=FOV)
            r_l = scan_poses_sectors(sl, poses[:A // 2], num_beams=B,
                                     fov=FOV)
            r_b = scan_poses_sectors(sb, poses[A // 2:], num_beams=B,
                                     fov=FOV)
            return jnp.max(jnp.abs(
                r - jnp.concatenate([r_l, r_b], axis=0)))
        extra["multitrack_parity_maxabs"] = float(mt_parity(
            stack, smaps2["levine"], smaps2["berlin"], poses_mt, mids))
        _log(f"[bench] multitrack parity = "
             f"{extra['multitrack_parity_maxabs']:.2e}")

        # ring map-pass: degenerate 1-device ring
        from pyracecarsimulator_tpu.parallel.mesh import make_mesh
        from pyracecarsimulator_tpu.parallel.ringmap import make_ring_scan
        mesh1r = make_mesh(jax.devices()[:1], agents_axis=1, beams_axis=1)
        ring = make_ring_scan(mesh1r, smaps2["berlin"], B, FOV, 10.0)

        @jax.jit
        def ring_loop(poses):
            def rep(acc, i):
                d = i.astype(jnp.float32) * 1e-7
                return acc + jnp.sum(ring(poses + d)), None
            acc, _ = jax.lax.scan(rep, 0.0, jnp.arange(10))
            return acc

        _log("[bench] ring 1-device (berlin): compiling ...")
        results["ring_1dev_rays_s"] = tm.rate(
            "ring_1dev", ring_loop, (poses2["berlin"],), 10,
            (A // 2) * B)
        _log(f"[bench] ring_1dev = {results['ring_1dev_rays_s']:.3e}")

        @jax.jit
        def ring_parity(sb, poses):
            return jnp.max(jnp.abs(
                ring(poses) - scan_poses_sectors(sb, poses, num_beams=B,
                                                 fov=FOV, mode="dense")))
        extra["ring_parity_maxabs"] = float(ring_parity(
            smaps2["berlin"], poses2["berlin"]))
        _log(f"[bench] ring parity = {extra['ring_parity_maxabs']:.2e}")
    except Exception as e:
        failed.append("multitrack_ring")
        _log(f"[bench] multitrack/ring stage failed: {e!r}")

    # sharded step on one device (1-device mesh): the production
    # shard_map path, timed with the same in-program scanned-reps
    # discipline as every other stage. The rep loop chains the state
    # through the step (a real rollout) and perturbs x per rep.
    try:
        from pyracecarsimulator_tpu.parallel.mesh import (make_mesh,
                                                          make_sharded_step)
        from pyracecarsimulator_tpu.state import set_field
        mesh1 = make_mesh(jax.devices()[:1], agents_axis=1, beams_axis=1)
        bundle_s = build_sim("levine", scan=ScanParams(num_beams=B),
                             backend="sectors")
        sstep = make_sharded_step(mesh1, bundle_s, with_noise=False)
        m = load_builtin("levine")
        x0, y0, *_ = ray_args(m)
        s0 = state_from_pose(x0, y0, jnp.zeros(A))
        act = (jnp.full((A,), 2.0), jnp.zeros(A))
        SREPS = 10

        @jax.jit
        def sloop(state, act):
            def rep(st, i):
                st = set_field(st, x=st.x + i.astype(jnp.float32) * 1e-7)
                out = sstep(st, act, None)
                return out.state, None
            final, _ = jax.lax.scan(rep, state, jnp.arange(SREPS))
            return final.x[0] + final.y[0]

        _log("[bench] compiling sharded step (1-device mesh) ...")
        results["sharded_step_1dev_rays_s"] = tm.rate(
            "sharded_step_1dev", sloop, (s0, act), SREPS, A * B)
        _log(f"[bench] sharded_step_1dev rays/s = "
             f"{results['sharded_step_1dev_rays_s']:.3e}")
    except Exception as e:
        failed.append("sharded_step_1dev")
        _log(f"[bench] sharded step stage failed: {e!r}")

    for k, v in results.items():
        extra[k] = float(f"{v:.4g}")
    extra["timing"] = tm.records

    # headline: the framework's fastest exact-semantics fwd+bwd path on the
    # flagship config (XLA dense vs sector-culled sweep)
    candidates = {k: results[k] for k in ("levine_fwdbwd",
                                          "levine_sector_fwdbwd")
                  if k in results}
    if candidates:
        key = max(candidates, key=candidates.get)
        headline = candidates[key]
        extra["headline_path"] = key
    else:
        key = "levine_fwd"
        headline = results.get("levine_fwd", 0.0)

    # full evidence -> the gitignored sidecar; stdout stays one short line
    # (module doc)
    detail_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "BENCH_DETAIL.json")
    with open(detail_path, "w") as f:
        json.dump({"headline": float(f"{headline:.4g}"),
                   "headline_path": key, "extra": extra}, f, indent=1,
                  sort_keys=True)
    _log(f"[bench] full evidence written to {detail_path}")

    small_keys = ("levine_sector_fwdbwd", "berlin_sector_fwdbwd",
                  "env_steps_s_4096_sectors",
                  "env_steps_s_4096_sectors_berlin",
                  "sharded_step_1dev_rays_s",
                  "levine_dmap_hybrid_fwdbwd",
                  "train_steps_s_levine", "train_steps_s_berlin",
                  "multitrack_fwdbwd", "ring_1dev_rays_s")
    small = {k: extra[k] for k in small_keys if k in extra}
    for k in ("levine_sector_parity_maxabs", "berlin_sector_parity_maxabs",
              "multitrack_parity_maxabs", "ring_parity_maxabs", "device"):
        if k in extra:
            small[k] = extra[k]
    small["headline_path"] = key
    small["detail"] = "BENCH_DETAIL.json"
    small["failed"] = failed
    line = json.dumps({
        "metric": "rays/s/device fwd+bwd (1080-beam, 4096 agents, levine)",
        "value": float(f"{headline:.4g}"),
        "unit": "rays/s",
        "vs_baseline": float(f"{headline / 1e9:.4g}"),
        "extra": small,
    })
    assert len(line) < 1500, f"stdout line {len(line)} chars (cap 1500)"
    print(line)
    if failed:
        _log(f"[bench] FAILED stages: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
