"""Demo: occupancy-grid reconstruction from lidar scans by gradient descent.

The full differentiable chain (ops/soft_edt.py):

    occupancy --(chamfer soft-EDT, log init)--> EDF --(bilinear DT
    march)--> ranges --> TSDF loss vs observed scans --> grad --> occupancy

A capability with no reference equivalent: the reference simulates scans
FROM a map; this inverts the sensor to recover the map.

    python examples/demo_mapping.py                 # 96x96 toy room
    python examples/demo_mapping.py --map levine    # full 1300x1300 track
    python examples/demo_mapping.py --fast          # production hybrid path

``--fast`` runs the PRODUCTION ∂range/∂map path instead:
``make_scan_fn(bundle, map_grad=True)`` — sector-culled exact forward +
implicit-function map cotangent (much faster than the soft-EDT/bilinear
chain above). Task: full levine-scale map CORRECTION —
start from a miscalibrated prior (true walls dilated 2 cells = every
surface 0.10 m too close), observe exact scans, and recover the true
surface by relinearized Gauss-Newton steps where each step's per-cell
update is assembled from two VJP calls of the facade scan function
(weighted range residual / weighted hit density). The compiled geometry
is rebuilt from the corrected EDF between steps (host-side, like the
reference's obstacle path, SURVEY.md §3.4)."""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def toy_world():
    H = W = 96
    occ = np.zeros((H, W), np.float32)
    occ[:3, :] = 1; occ[-3:, :] = 1
    occ[:, :3] = 1; occ[:, -3:] = 1
    occ[40:52, 60:70] = 1.0
    occ[20:28, 25:32] = 1.0
    return occ


def builtin_world(name):
    from pyracecarsimulator_tpu.maps.loader import load_builtin
    m = load_builtin(name)
    return np.asarray(m.occupancy)[: m.height, : m.width].astype(np.float32)


def fast_main(args):
    """Map correction through the facade map_grad route (module doc)."""
    import jax
    import jax.numpy as jnp
    from scipy.ndimage import binary_dilation
    from pyracecarsimulator_tpu.config import ScanParams
    from pyracecarsimulator_tpu.simulator import build_sim, make_scan_fn
    from pyracecarsimulator_tpu.maps.loader import (load_builtin,
                                                    build_track_map)
    from pyracecarsimulator_tpu.maps.edt import edt

    name = args.map if args.map != "toy" else "levine"
    m_true = load_builtin(name)
    occ_true = np.asarray(m_true.occupancy)[: m_true.height,
                                            : m_true.width] > 0.5
    res = m_true.resolution
    H, W = occ_true.shape
    n_poses = args.poses or 96
    beams = 540
    sp = ScanParams(num_beams=beams, max_range=10.0)
    print(f"[fast] {name} {H}x{W} @ {res} m, {n_poses} poses x {beams} "
          f"beams (backend={jax.default_backend()})")

    # observed scans: the exact sector pipeline on the TRUE map
    bundle_true = build_sim(m_true, scan=sp, backend="sectors")
    scan_true = make_scan_fn(bundle_true)
    rng = np.random.RandomState(0)
    edf_true = np.asarray(m_true.edf)[:H, :W]
    ys, xs = np.where(edf_true > 0.5)
    k = rng.randint(len(ys), size=n_poses)
    poses = jnp.asarray(np.stack(
        [m_true.origin_x + (xs[k] + .5) * res,
         m_true.origin_y + (ys[k] + .5) * res,
         rng.uniform(-np.pi, np.pi, n_poses)], -1), jnp.float32)
    observed = scan_true(poses)

    # miscalibrated prior: every wall 2 cells (0.10 m) too close
    occ_est = binary_dilation(occ_true, iterations=2)
    org = (m_true.origin_x, m_true.origin_y)
    t0 = time.time()
    outer = args.iters if args.iters < 30 else 10
    for it in range(outer):
        # re-derive the EDF from the carved occupancy each relinearization:
        # the IFT gate needs |grad E| = 1 near the tau surface, which raw
        # residual-sized e updates violate one iteration later
        e = jnp.asarray(edt(occ_est, 1.0) * res, jnp.float32)
        track_est = build_track_map(occ_est.astype(np.float32), res, org,
                                    name=f"est{it}")
        bundle = build_sim(track_est, scan=sp, backend="sectors")
        scan_g = make_scan_fn(bundle, map_grad=True)
        pred, vjp = jax.vjp(lambda ef: scan_g(poses, ef), e)
        err = jnp.abs(pred - observed)
        rmse = float(jnp.sqrt(jnp.mean(err ** 2)))
        within = float(jnp.mean(err < res))
        print(f"[fast] iter {it}  range RMSE {rmse * 100:6.2f} cm   "
              f"beams within 1 cell: {within * 100:5.1f}%")
        if within > 0.999:
            break
        # Gauss-Newton-ish per-cell update from two VJP pulls:
        #   vjp(g)[0] = sum_rays -g * w_cell / denom_ray   (IFT cotangent)
        # g = 1:           G1 = sum  w/|denom|          (hit density)
        # g = pred - obs:  G2 = sum (pred-obs) w/|denom| (weighted resid.)
        # => -G2/G1 = hit-weighted mean of (obs - pred) = the EDF shift
        # that moves each cell's surface onto the observed range (|grad E|
        # = 1 for a distance field, so range error == surface offset).
        g1 = vjp(jnp.ones_like(pred))[0]
        g2 = vjp(pred - observed)[0]
        upd = jnp.where(g1 > 1e-3, -g2 / jnp.where(g1 > 1e-3, g1, 1.0),
                        0.0)
        occ_est = np.asarray((e + upd) < 0.5 * res)
    track_est = build_track_map(occ_est.astype(np.float32), res, org,
                                name="est_final")
    bundle = build_sim(track_est, scan=sp, backend="sectors")
    pred = make_scan_fn(bundle)(poses)
    err = jnp.abs(pred - observed)
    rmse = float(jnp.sqrt(jnp.mean(err ** 2)))
    within = float(jnp.mean(err < res))
    # surface agreement vs the true map (same scoring idea as the slow path)
    true_surface = occ_true & binary_dilation(~occ_true)
    pred_near = binary_dilation(occ_est, iterations=1)
    recall = (pred_near & true_surface).sum() / max(true_surface.sum(), 1)
    print(f"[fast] done in {time.time() - t0:.1f}s  final range RMSE "
          f"{rmse * 100:.2f} cm, {within * 100:.1f}% of beams within one "
          f"cell (prior: every wall {2 * res * 100:.0f} cm off); "
          f"true-surface recall {recall:.2f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", default="toy",
                    help="'toy' (96x96 room) or a builtin name "
                         "('levine': full 1300x1300 grid)")
    ap.add_argument("--poses", type=int, default=0,
                    help="scan poses (0 = per-map default)")
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--fast", action="store_true",
                    help="production hybrid ∂range/∂map path (module doc)")
    args = ap.parse_args()
    if args.fast:
        return fast_main(args)

    import jax
    import jax.numpy as jnp
    import optax
    from pyracecarsimulator_tpu.ops.soft_edt import soft_edt
    from pyracecarsimulator_tpu.ops.raymarch_xla import (
        scan_poses, beam_angles, sample_edf_bilinear)
    from pyracecarsimulator_tpu.maps.edt import edt

    # ground truth in GRID UNITS (res = 1 cell); levine's 0.05 m cells
    # make max_range 10 m = 200 cells
    if args.map == "toy":
        occ_true = toy_world()
        n_poses = args.poses or 24
        beams, max_range, max_iters = 180, 80.0, 128
        edt_iters, free_margin = 64, 0.8
    else:
        occ_true = builtin_world(args.map)
        n_poses = args.poses or 256
        beams, max_range, max_iters = 360, 200.0, 256
        # big maps: the chamfer EDF only needs to be exact out to the
        # free-sample margin test, not across the whole hall
        edt_iters, free_margin = 96, 0.8
    H, W = occ_true.shape
    print(f"world {H}x{W}, {n_poses} poses x {beams} beams "
          f"(backend={jax.default_backend()})")

    # observe scans from free-space poses with the EXACT pipeline
    edf_true = jnp.asarray(edt(occ_true > 0.5, 1.0))
    rng = np.random.RandomState(0)
    free_y, free_x = np.where(np.asarray(edf_true) > 4.0)
    k = rng.randint(len(free_y), size=n_poses)
    poses = jnp.asarray(np.stack([
        free_x[k] + 0.5, free_y[k] + 0.5,
        rng.uniform(-np.pi, np.pi, n_poses)], -1), jnp.float32)
    observed = scan_poses(edf_true, 1.0, jnp.zeros(2), poses,
                          num_beams=beams, fov=2 * np.pi * 0.999,
                          max_range=max_range, max_iters=max_iters)

    # reconstruct with a TSDF-style loss on the differentiable EDF:
    # observed hit points must lie ON surfaces (edf -> 0) and sampled
    # points along each beam before the hit must stay FREE (edf large).
    # (A naive MSE on re-simulated ranges saturates: through a transparent
    # initial map every ray clamps at max_range with zero gradient.)
    offs = beam_angles(beams, 2 * np.pi * 0.999)
    ang = poses[:, 2:3] + offs[None, :]
    ux, uy = jnp.cos(ang), jnp.sin(ang)
    hit_mask = observed < max_range * 0.99
    hx = poses[:, 0:1] + observed * ux
    hy = poses[:, 1:2] + observed * uy
    # free samples stop at 0.8*r: samples closer to the hit would demand
    # clearance where the surface itself must sit (margin conflict drove
    # reconstruction to empty maps)
    FREE_FRACS = jnp.asarray([0.2, 0.4, 0.6, 0.8])
    fx = poses[:, 0:1, None] + observed[..., None] * FREE_FRACS * ux[..., None]
    fy = poses[:, 1:2, None] + observed[..., None] * FREE_FRACS * uy[..., None]

    logits0 = jnp.zeros((H, W)) - 1.5         # sigmoid -> occ ~ 0.18

    @jax.jit
    def loss(logits):
        occ = jax.nn.sigmoid(logits)
        edf = soft_edt(occ, 1.0, iters=edt_iters, temperature=0.25,
                       init="log", init_lambda=3.0)
        d_hit = sample_edf_bilinear(edf, hx, hy)
        d_free = sample_edf_bilinear(edf, fx, fy)
        hit_term = jnp.mean(jnp.where(hit_mask, d_hit, 0.0) ** 2)
        free_term = jnp.mean(jax.nn.relu(free_margin - d_free) ** 2)
        return hit_term + free_term

    opt = optax.adam(0.3)
    state = opt.init(logits0)
    logits = logits0
    grad_fn = jax.jit(jax.value_and_grad(loss))
    t0 = time.time()
    for i in range(args.iters):
        l, g = grad_fn(logits)
        upd, state = opt.update(g, state)
        logits = optax.apply_updates(logits, upd)
        if i % max(1, args.iters // 5) == 0:
            print(f"iter {i:3d}  tsdf loss {float(l):8.4f}")
    occ_rec = np.asarray(jax.nn.sigmoid(logits))
    # score on the OBSERVABLE surface: lidar can only see obstacle
    # boundary cells within range of some pose (not block interiors,
    # not beyond max_range on big maps)
    from scipy.ndimage import binary_dilation
    true = occ_true > 0.5
    surface = true & binary_dilation(~true)
    if args.map != "toy":
        seen = np.zeros_like(true)
        hxn = np.clip(np.asarray(hx).astype(int), 0, W - 1)
        hyn = np.clip(np.asarray(hy).astype(int), 0, H - 1)
        seen[hyn[np.asarray(hit_mask)], hxn[np.asarray(hit_mask)]] = True
        surface &= binary_dilation(seen, iterations=2)
    pred_near = binary_dilation(occ_rec > 0.5, iterations=1)
    recall = (pred_near & surface).sum() / max(surface.sum(), 1)
    print(f"done in {time.time()-t0:.1f}s  surface recall = {recall:.2f} "
          f"({(pred_near & surface).sum()}/{surface.sum()} observed "
          f"boundary cells within 1 cell of a reconstructed obstacle)")


if __name__ == "__main__":
    main()
