"""Smoke run of the simulator's main path on one NVIDIA GPU.

    python chip_smoke.py            # one card: phases 0-7 below
    python chip_smoke.py --four     # four cards: the sharded paths only

Drives the user entry points (``build_sim(backend="auto")``,
``make_step_fn``, ``parallel.make_rollout_fn`` with the gap follower,
``parallel.make_bptt_train_fn``, the ``RacecarSimulator`` facade) at the
flagship size — 1080 beams over 270 deg, 10 m range, 4096 agents — on both
bundled maps, and checks every result against the repo's references:

  0. device: card name and power limit, JAX version; refuses anything but
     a GPU (no CPU fallback);
  1. build: host build seconds and table bytes per map;
  2. step + scan parity: sector scan vs the dense exact ``segments``
     backend on the full batch (max|d| <= 1e-4 m), sector scan vs the
     float64 geometry oracle on 256 agents (1e-4 m on >= 99.99% of beams,
     all under 3 cells; see ORACLE_MIN_FRACTION), the compiled step's
     ``memory_analysis()``;
  3. pose gradients of sum(ranges): sector VJP vs the dense segment VJP
     on 512 agents (rtol 1e-4, atol 1e-5);
  4. the reference-semantics DT march (``backend="edf"``) vs the oracle DT
     march on 256 agents: > 99% of beams within 1e-3 m, max < 3 cells;
  5. closed loop: T=25 rollout with the gap follower, poses finite;
  6. training: 3 BPTT optimizer steps at T=10, finite, parameters move;
  7. multitrack stack vs per-map scans, and the ∂map route
     (``make_scan_fn(map_grad=True)``): same forward, finite EDF gradient.

Every phase prints one line; any failure raises and the script exits
non-zero. The last line of stdout is the JSON contract line
``{"ok": true, "device": {"platform", "kind", "count"}}``. Times printed
here are a smoke check, not a benchmark.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

FOV = 4.712388980384690
MAX_RANGE = 10.0
MAPS = ("levine", "berlin")
# tolerances (metres unless noted) and their sources
TOL_SECTOR_VS_DENSE = 1e-4     # same geometry, same f32 formulas
# vs the float64 oracle: 1e-4 m (tests/test_sectors.py bundled-map parity)
# on all but a few beams in 1e4. A beam through an exact segment vertex,
# or grazing a wall, is ill-conditioned in f32 (t = (p - x) / cos) and
# may slip past the vertex to the next wall: at 256 agents, 6 of 276480
# beams on berlin on the CPU, max 0.062 m. The dense exact backend does
# the same (sector vs dense is 0.0), so the bound on those beams is the
# DT-march rule's: under 3 cells.
TOL_SECTOR_VS_ORACLE = 1e-4
ORACLE_MIN_FRACTION = 0.9999
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5   # tests/test_grad.py
# The ring, the multitrack stack and the sharded step build the lidar
# origin and beam fan in other fusions than their single-card reference,
# so f32 rounding of those inputs may differ by an ulp; a grazing ray
# amplifies that (t = (p - x) / cos) to ~1e-5 m (1.4e-5 measured on four
# CPU devices), and a ray through an exact vertex may flip between
# hitting it and passing to the next wall (6.26 m on one ray in 17.7M,
# 4x1 mesh on four H100s). Their ranges are held to the sector tolerance,
# 1e-4 m, on all but a few rays in 1e4 (the oracle rule above); the
# sharded step's state (elementwise dynamics) to 1e-5 everywhere.
TOL_RING = 1e-4
TOL_MULTI = 1e-4
TOL_SHARDED_RANGES = 1e-4
TOL_SHARDED_STATE = 1e-5


_T0 = time.perf_counter()


def log(phase: str, **numbers) -> None:
    items = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{phase}] {items} elapsed_s={time.perf_counter() - _T0:.1f}",
          flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip()


def check_device(devices, platform: str = "gpu") -> dict:
    """Phase 0's gate: the run proceeds only on ``platform`` devices."""
    d = devices[0]
    if d.platform != platform:
        raise RuntimeError(
            f"chip_smoke needs a {platform.upper()}; JAX found "
            f"{d.platform!r} ({d.device_kind}) — refusing to run elsewhere")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def phase0_device() -> dict:
    import jax
    dev = check_device(jax.devices())
    print(f"card: {card_line()}", flush=True)
    log("0 device", jax=jax.__version__, devices=jax.devices(),
        kind=repr(dev["kind"]), count=dev["count"])
    return dev


# ---------------------------------------------------------------- helpers
def free_poses(track, n: int, seed: int) -> np.ndarray:
    """(n, 3) poses on free cells with 0.3 m clearance, random heading."""
    from pyracecarsimulator_tpu.maps.loader import sample_free_poses
    return sample_free_poses(track, n, np.random.RandomState(seed))


def jit_scan(bundle, **kw):
    """A jitted ``make_scan_fn`` whose map rides in as a traced argument
    (a closed-over table would be compiled in as a constant)."""
    import jax
    from pyracecarsimulator_tpu.simulator import make_scan_fn
    cell = {"map": None}
    scan = make_scan_fn(bundle, map_cell=cell, **kw)
    map_obj = (bundle.segmap if bundle.segmap is not None
               else bundle.track)

    def run(m, *args):
        cell["map"] = m
        return scan(*args)
    run.__name__ = f"scan_{bundle.backend}" + ("_mapgrad" if kw else "")
    run = jax.jit(run)
    return lambda *args: run(map_obj, *args)


def oracle_segments(track, poses, num_beams: int) -> np.ndarray:
    """float64 first-hit ranges against the exact boundary (native
    library when built, NumPy otherwise), rays from the device fan."""
    from pyracecarsimulator_tpu._native import loader as native
    from pyracecarsimulator_tpu.maps.segments import (
        extract_segments, raycast_segments_numpy)
    from pyracecarsimulator_tpu.ops.common import rays_from_poses
    segs = extract_segments(np.asarray(track.occupancy), track.resolution,
                            (track.origin_x, track.origin_y))
    _, _, xb, yb, ct, st = rays_from_poses(poses, num_beams, FOV, 0)
    rays = [np.asarray(a, np.float64).ravel() for a in (xb, yb, ct, st)]
    out = native.raycast_segments(segs, *rays, MAX_RANGE)
    if out is None:
        out = np.concatenate([
            raycast_segments_numpy(segs, *[r[i:i + 4096] for r in rays],
                                   MAX_RANGE)
            for i in range(0, len(rays[0]), 4096)])
    return out.reshape(len(poses), num_beams)


def maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# ----------------------------------------------------------------- phases
def phase1_build(names=MAPS, scan=None) -> dict:
    """build_sim(name, backend="auto") per map, plus the dense exact
    ``segments`` bundle over the same track (phase 2's reference)."""
    from pyracecarsimulator_tpu.config import ScanParams
    from pyracecarsimulator_tpu.simulator import build_sim
    scan = scan or ScanParams()
    built = {}
    for name in names:
        t0 = time.perf_counter()
        sec = build_sim(name, scan=scan, backend="auto")
        secs = time.perf_counter() - t0
        assert sec.backend == "sectors", sec.backend
        dense = build_sim(sec.track, scan=scan, backend="segments")
        table = sec.segmap.table
        log(f"1 build {name}", build_s=f"{secs:.2f}",
            table_bytes=int(np.prod(table.shape)) * 4,
            capacity=table.shape[2], segments=sec.segmap.n_segments)
        built[name] = (sec, dense)
    return built


def phase2_parity(name, sec, dense, agents: int, oracle_agents: int,
                  seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp
    from pyracecarsimulator_tpu.simulator import make_step_fn
    from pyracecarsimulator_tpu.state import state_from_pose
    nb = sec.scan.num_beams
    poses = jnp.asarray(free_poses(sec.track, agents, seed))
    r_sec = np.asarray(jit_scan(sec)(poses))
    r_den = np.asarray(jit_scan(dense)(poses))
    assert r_sec.shape == (agents, nb) and np.isfinite(r_sec).all()
    d_dense = maxabs(r_sec, r_den)
    ro = oracle_segments(sec.track, poses[:oracle_agents], nb)
    d = np.abs(r_sec[:oracle_agents].astype(np.float64) - ro)
    d_oracle = float(d.max())
    within = float((d <= TOL_SECTOR_VS_ORACLE).mean())
    # the full step (dynamics -> fan -> sweep -> TTC) compiled once
    step = make_step_fn(sec, with_noise=False)
    s0 = state_from_pose(poses[:, 0], poses[:, 1], poses[:, 2])
    act = (jnp.full((agents,), 2.0), jnp.zeros(agents))
    compiled = step.jitted.lower(sec.segmap, s0, act, None).compile()
    out = step(s0, act)
    assert np.isfinite(np.asarray(out.ranges)).all()
    mem = compiled.memory_analysis()
    log(f"2 parity {name}", agents=agents, beams=nb,
        sector_vs_dense_maxabs=d_dense, oracle_agents=oracle_agents,
        sector_vs_oracle_maxabs=d_oracle,
        oracle_within_1e4=within,
        oracle_beams_over_1e4=int((d > TOL_SECTOR_VS_ORACLE).sum()),
        collisions=int(np.asarray(out.collision).sum()))
    log(f"2 memory {name}", memory_analysis=str(mem).replace("\n", " "))
    assert d_dense <= TOL_SECTOR_VS_DENSE, d_dense
    assert within >= ORACLE_MIN_FRACTION, within
    assert d_oracle < 3 * sec.track.resolution, d_oracle
    return {"dense": d_dense, "oracle": d_oracle, "within": within}


def phase3_grad(name, sec, dense, agents: int, seed: int = 1) -> float:
    import jax
    import jax.numpy as jnp
    poses = jnp.asarray(free_poses(sec.track, agents, seed))
    grads = []
    for b in (sec, dense):
        scan = jit_scan(b)
        g = jax.jit(jax.grad(lambda p, scan=scan: jnp.sum(scan(p))))(poses)
        grads.append(np.asarray(g))
    g_sec, g_den = grads
    assert np.isfinite(g_sec).all()
    err = np.abs(g_sec - g_den) - GRAD_RTOL * np.abs(g_den)
    log(f"3 grad {name}", agents=agents, grad_maxabs=maxabs(g_sec, g_den),
        worst_excess_over_atol=float(err.max() - GRAD_ATOL))
    np.testing.assert_allclose(g_sec, g_den, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    return maxabs(g_sec, g_den)


def phase4_march(track, agents: int, scan=None, seed: int = 2) -> dict:
    """Reference-semantics DT march vs the float64 oracle march."""
    import jax.numpy as jnp
    from pyracecarsimulator_tpu.config import ScanParams
    from pyracecarsimulator_tpu.oracle.raycast import scan_batch
    from pyracecarsimulator_tpu.simulator import build_sim
    scan = scan or ScanParams()
    bundle = build_sim(track, scan=scan, backend="edf")
    poses = free_poses(track, agents, seed)
    got = np.asarray(jit_scan(bundle)(jnp.asarray(poses)))
    ref = scan_batch(np.asarray(track.edf), track.resolution,
                     (track.origin_x, track.origin_y), poses,
                     num_beams=scan.num_beams, fov=scan.fov,
                     max_range=scan.max_range,
                     eps=scan.ray_tracing_epsilon,
                     bounds_hw=(track.height, track.width))
    d = np.abs(got.astype(np.float64) - ref)
    frac = float((d < 1e-3).mean())
    log(f"4 march {track.name}", agents=agents, within_1mm=frac,
        maxabs=float(d.max()), cells=float(d.max() / track.resolution))
    assert frac > 0.99, frac
    assert d.max() < 3 * track.resolution, d.max()
    return {"within": frac, "max": float(d.max())}


def phase5_rollout(name, sec, agents: int, steps: int = 25,
                   seed: int = 3) -> int:
    import jax.numpy as jnp
    from pyracecarsimulator_tpu.parallel import (
        make_gap_follower_policy, make_rollout_fn)
    from pyracecarsimulator_tpu.simulator import make_step_fn
    from pyracecarsimulator_tpu.state import state_from_pose
    nb = sec.scan.num_beams
    p = free_poses(sec.track, agents, seed)
    s0 = state_from_pose(jnp.asarray(p[:, 0]), jnp.asarray(p[:, 1]),
                         jnp.asarray(p[:, 2]))
    run = make_rollout_fn(make_step_fn(sec, with_noise=False),
                          make_gap_follower_policy(nb, float(sec.scan.fov)),
                          steps, nb)
    t0 = time.perf_counter()
    final, traj = run(s0)
    final.x.block_until_ready()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    final, traj = run(s0)
    final.x.block_until_ready()
    run_s = time.perf_counter() - t0
    pose = np.asarray(traj["pose"])
    assert pose.shape == (steps, agents, 3) and np.isfinite(pose).all()
    collided = int(np.asarray(final.collision).sum())
    log(f"5 rollout {name}", agents=agents, steps=steps,
        collisions=collided,
        smoke_not_a_benchmark=f"compile_s={compile_s:.2f},"
                              f"run_s={run_s:.4f}")
    return collided


def phase6_train(track, agents: int, steps: int = 10, updates: int = 3,
                 scan=None, seed: int = 4) -> float:
    import jax
    import jax.numpy as jnp
    import optax
    from pyracecarsimulator_tpu.config import ScanParams, SimParams
    from pyracecarsimulator_tpu.parallel import make_bptt_train_fn
    from pyracecarsimulator_tpu.simulator import build_sim, make_step_fn
    from pyracecarsimulator_tpu.state import state_from_pose
    scan = scan or ScanParams()
    nb = scan.num_beams
    bundle = build_sim(track, scan=scan, sim=SimParams(steer_mode="smooth"),
                       backend="auto")
    step = make_step_fn(bundle, with_noise=False)

    def policy(params, state, ranges, t):
        return (jnp.full(state.batch_shape, 2.0),
                jnp.tanh(ranges @ params["w"] + params["b"]))

    def loss_fn(out, t):
        return (jnp.mean((out.ranges - scan.max_range) ** 2)
                + 10.0 * jnp.mean(out.collision.astype(jnp.float32)))

    train, init = make_bptt_train_fn(step, policy, loss_fn, steps, nb,
                                     optimizer=optax.adam(3e-3))
    p = free_poses(track, agents, seed)
    s0 = state_from_pose(jnp.asarray(p[:, 0]), jnp.asarray(p[:, 1]),
                         jnp.asarray(p[:, 2]))
    params = {"w": jnp.zeros((nb,)), "b": jnp.zeros(())}
    opt_state = init(params)
    losses = []
    for _ in range(updates):
        params, opt_state, loss, _ = train(params, opt_state, s0)
        losses.append(float(loss))
    w = np.asarray(params["w"])
    assert np.isfinite(losses).all() and np.isfinite(w).all()
    moved = float(np.abs(w).sum())
    log(f"6 train {track.name}", agents=agents, horizon=steps,
        updates=updates, losses=[f"{v:.6g}" for v in losses],
        param_l1=moved)
    assert moved > 0.0, "parameters did not change"
    return moved


def phase7_multi_and_mapgrad(built: dict, agents: int,
                             mapgrad_agents: int, seed: int = 5) -> dict:
    import jax
    import jax.numpy as jnp
    from pyracecarsimulator_tpu.maps.sectors import stack_sector_maps
    from pyracecarsimulator_tpu.ops.raycast_sectors import (
        scan_poses_sectors, scan_poses_sectors_multi)
    names = list(built)
    secs = [built[n][0] for n in names]
    nb = secs[0].scan.num_beams
    stack = stack_sector_maps([b.segmap for b in secs])
    per = -(-agents // len(names))
    poses = [jnp.asarray(free_poses(b.track, per, seed + i))
             for i, b in enumerate(secs)]
    mids = jnp.concatenate([jnp.full((per,), i, jnp.int32)
                            for i in range(len(names))])
    r_multi = jax.jit(lambda st, p, m: scan_poses_sectors_multi(
        st, m, p, num_beams=nb, fov=FOV, max_range=MAX_RANGE))(
        stack, jnp.concatenate(poses), mids)
    r_each = [jax.jit(lambda sm, p: scan_poses_sectors(
        sm, p, num_beams=nb, fov=FOV, max_range=MAX_RANGE))(b.segmap, p)
        for b, p in zip(secs, poses)]
    d_multi = maxabs(r_multi, jnp.concatenate(r_each))
    # ∂map route on the first map: same forward, finite EDF gradient
    b0 = secs[0]
    t = b0.track
    edf = jnp.asarray(t.edf)
    pg = jnp.asarray(free_poses(t, mapgrad_agents, seed + 10))
    scan_g = jit_scan(b0, map_grad=True)
    d_fwd = maxabs(scan_g(pg, edf), jit_scan(b0)(pg))
    g = np.asarray(jax.jit(jax.grad(
        lambda e: jnp.sum(scan_g(pg, e) ** 2)))(edf))
    log("7 multitrack+mapgrad", stack_capacity=stack.table.shape[2],
        agents=per * len(names), multi_vs_single_maxabs=d_multi,
        mapgrad_agents=mapgrad_agents, mapgrad_fwd_maxabs=d_fwd,
        edf_grad_l1=float(np.abs(g).sum()))
    assert d_multi <= TOL_MULTI, d_multi
    assert d_fwd == 0.0, d_fwd
    assert np.isfinite(g).all() and np.abs(g).sum() > 0.0
    return {"multi": d_multi, "mapgrad_fwd": d_fwd}


def phase_facade(track, scan=None) -> None:
    """The RacecarSimulator facade: drive, step, scan, obstacle cycle."""
    from pyracecarsimulator_tpu.simulator import RacecarSimulator
    from pyracecarsimulator_tpu.config import ScanParams
    sim = RacecarSimulator(track, scan_params=scan or ScanParams(),
                           backend="auto", with_noise=False)
    x, y, th = free_poses(track, 1, 6)[0]
    sim.set_pose(float(x), float(y), float(th))
    sim.drive(2.0, 0.1)
    out = sim.update_pose()
    r0 = np.asarray(sim.run_scan())
    sim.add_obstacle(float(x) + 0.8 * np.cos(th),
                     float(y) + 0.8 * np.sin(th), 0.3)
    r1 = np.asarray(sim.run_scan())
    sim.clear_obstacles()
    r2 = np.asarray(sim.run_scan())
    assert np.isfinite(r0).all() and float(out.state.velocity) > 0.0
    assert r1.min() < r0.min() + 1e-6
    np.testing.assert_allclose(r2, r0, atol=1e-6)
    log(f"7 facade {track.name}", min_before=float(r0.min()),
        min_with_obstacle=float(r1.min()))


# -------------------------------------------------------------- four cards
def _log_worst_rays(bundle, state, r_out, r_ref, d, n: int = 4) -> None:
    """The worst-differing rays with the float64 oracle's range for each:
    which of the two f32 answers the exact geometry supports."""
    worst = np.argsort(d.ravel())[::-1][:n]
    agents, beams = np.unravel_index(worst, d.shape)
    th = np.asarray(state.theta)[agents]
    lead = bundle.car.scan_distance_to_base_link
    poses = np.stack([np.asarray(state.x)[agents] + lead * np.cos(th),
                      np.asarray(state.y)[agents] + lead * np.sin(th), th],
                     -1).astype(np.float32)
    ro = oracle_segments(bundle.track, poses, r_out.shape[1])
    for i, (a, b) in enumerate(zip(agents, beams)):
        log("four worst ray", agent=int(a), beam=int(b),
            sharded=float(r_out[a, b]), single=float(r_ref[a, b]),
            oracle=float(ro[i, b]))


def four_card_checks(agents: int = 16384, bptt_agents: int = 4096,
                     ring_agents: int = 2048, track="berlin",
                     scan=None) -> None:
    """The multi-card paths on berlin: sharded step on a 4x1 and a 2x2
    (agents x beams) mesh vs the single-card step, one sharded BPTT step,
    and the ring map-pass vs the replicated scan."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from pyracecarsimulator_tpu.config import ScanParams, SimParams
    from pyracecarsimulator_tpu.ops.raycast_sectors import (
        scan_poses_sectors)
    from pyracecarsimulator_tpu.parallel.mesh import (
        make_mesh, make_sharded_step, shard_state)
    from pyracecarsimulator_tpu.parallel.ringmap import make_ring_scan
    from pyracecarsimulator_tpu.simulator import build_sim, make_step_fn
    from pyracecarsimulator_tpu.state import state_from_pose
    devs = jax.devices()[:4]
    assert len(devs) == 4, f"--four needs 4 devices, found {len(devs)}"
    scan = scan or ScanParams()
    nb = scan.num_beams
    bundle = build_sim(track, scan=scan, backend="auto")
    p = free_poses(bundle.track, agents, 7)
    s0 = state_from_pose(jnp.asarray(p[:, 0]), jnp.asarray(p[:, 1]),
                         jnp.asarray(p[:, 2]))
    act = (jnp.full((agents,), 2.0), jnp.zeros(agents))
    ref = make_step_fn(bundle, with_noise=False)(s0, act)
    # every comparison runs before any verdict, so one four-card run
    # reports all of them
    checks = []
    r_ref = np.asarray(ref.ranges, np.float64)
    for na, nbx in ((4, 1), (2, 2)):
        mesh = make_mesh(devs, agents_axis=na, beams_axis=nbx)
        step = make_sharded_step(mesh, bundle, with_noise=False)
        out = step(shard_state(mesh, s0), act)
        d = np.abs(np.asarray(out.ranges, np.float64) - r_ref)
        within = float((d <= TOL_SHARDED_RANGES).mean())
        d_s = max(maxabs(a, b) for a, b in zip(jax.tree.leaves(out.state),
                                               jax.tree.leaves(ref.state)))
        log(f"four sharded_step {na}x{nbx}", agents=agents, beams=nb,
            ranges_maxabs=float(d.max()), ranges_within_1e4=within,
            rays_over_1e4=int((d > TOL_SHARDED_RANGES).sum()),
            state_maxabs=d_s,
            collisions=int(np.asarray(out.collision).sum()),
            ref_collisions=int(np.asarray(ref.collision).sum()))
        if d.max() > TOL_SHARDED_RANGES:
            _log_worst_rays(bundle, ref.state, np.asarray(out.ranges),
                            r_ref, d)
        checks += [(f"{na}x{nbx} ranges within 1e-4", 1.0 - within,
                    1.0 - ORACLE_MIN_FRACTION),
                   (f"{na}x{nbx} state", d_s, TOL_SHARDED_STATE)]

    # one sharded BPTT step: value_and_grad through a short rollout of the
    # sharded step into a linear policy and the initial poses (smooth
    # steering: the reference law has zero gradient in desired steer)
    mesh = make_mesh(devs, agents_axis=2, beams_axis=2)
    step = make_sharded_step(
        mesh, bundle._replace(sim=SimParams(steer_mode="smooth")),
        with_noise=False)
    pb = jnp.asarray(p[:bptt_agents])
    target = 0.5 * scan.max_range

    def train_step(W, poses0):
        def loss_fn(W, poses0):
            s = state_from_pose(poses0[:, 0], poses0[:, 1], poses0[:, 2])

            def body(carry, _):
                st, r = carry
                out = step(st, (jnp.full((bptt_agents,), 2.0),
                                jnp.tanh(r @ W)), None)
                return (out.state, out.ranges), jnp.mean(
                    (out.ranges - target) ** 2)
            (_, _), losses = jax.lax.scan(
                body, (s, jnp.zeros((bptt_agents, nb))), None, length=3)
            return jnp.mean(losses)
        loss, (gW, gp) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            W, poses0)
        return W - 1e-3 * gW, poses0 - 1e-3 * gp, loss

    jit_train = jax.jit(train_step,
                        in_shardings=(NamedSharding(mesh, P("beams")),
                                      NamedSharding(mesh, P("agents"))),
                        out_shardings=(NamedSharding(mesh, P("beams")),
                                       NamedSharding(mesh, P("agents")),
                                       NamedSharding(mesh, P())))
    W2, p2, loss = jit_train(jnp.zeros((nb,)), pb)
    finite = bool(np.isfinite(float(loss))
                  and np.isfinite(np.asarray(W2)).all()
                  and np.isfinite(np.asarray(p2)).all())
    w_l1 = float(np.abs(np.asarray(W2)).sum())
    log("four bptt 2x2", agents=bptt_agents, horizon=3,
        loss=float(loss), w_l1=w_l1, finite=finite)
    checks.append(("bptt finite and moving",
                   0.0 if finite and w_l1 > 0 else 1.0, 0.0))

    # ring map-pass: the table sharded over the 4 cards of the beams axis
    mesh_r = make_mesh(devs, agents_axis=1, beams_axis=4)
    ring = make_ring_scan(mesh_r, bundle.segmap, nb, FOV, MAX_RANGE)
    pr = jnp.asarray(p[:ring_agents])
    r_ring = ring(pr)
    r_rep = jax.jit(lambda sm, q: scan_poses_sectors(
        sm, q, num_beams=nb, fov=FOV, max_range=MAX_RANGE))(
        bundle.segmap, pr)
    d_ring = maxabs(r_ring, r_rep)
    log("four ring 1x4", agents=ring_agents, ring_vs_replicated_maxabs=d_ring,
        tolerance=TOL_RING)
    checks.append(("ring", d_ring, TOL_RING))
    failed = [c for c in checks if not c[1] <= c[2]]
    assert not failed, f"four-card checks over tolerance: {failed}"


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded checks")
    args = ap.parse_args(argv)
    dev = phase0_device()
    from pyracecarsimulator_tpu.utils.compile_cache import (
        enable_compile_cache)
    log("0 cache", dir=enable_compile_cache())
    if args.four:
        four_card_checks()
    else:
        built = phase1_build()
        for name, (sec, dense) in built.items():
            phase2_parity(name, sec, dense, agents=4096, oracle_agents=256)
        for name, (sec, dense) in built.items():
            phase3_grad(name, sec, dense, agents=512)
        phase4_march(built["levine"][0].track, agents=256)
        for name, (sec, _) in built.items():
            phase5_rollout(name, sec, agents=4096)
        phase6_train(built["levine"][0].track, agents=4096)
        phase7_multi_and_mapgrad(built, agents=4096, mapgrad_agents=512)
        phase_facade(built["levine"][0].track)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
