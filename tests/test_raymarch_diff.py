"""Implicit-gradient DT march (ops/raymarch_diff.py).

Contracts:
  * forward: nearest-rule HIT/MISS, hit placed on the tau = res/2 bilinear
    level set = the occupied-boundary surface of the geometric oracle;
  * the custom VJP finite-difference-checks against ITS OWN forward (the
    gradient is of the function we actually compute), kink-filtered;
  * it agrees with exact autodiff of the bilinear march (the frozen
    reference, raymarch_xla.py) away from grazing incidence;
  * with_map_gradient (fast-forward hybrid) reproduces the same map
    cotangent.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyracecarsimulator_tpu.maps.edt import edt
from pyracecarsimulator_tpu.ops.raymarch_xla import march_rays
from pyracecarsimulator_tpu.ops.raymarch_diff import (
    march_rays_implicit, scan_poses_implicit)

RES = 0.05
MAXR = 6.0


@pytest.fixture(scope="module")
def field():
    rng = np.random.RandomState(11)
    H = W = 160
    occ = np.zeros((H, W), np.float32)
    occ[:3, :] = 1; occ[-3:, :] = 1; occ[:, :3] = 1; occ[:, -3:] = 1
    for _ in range(25):
        r, c = rng.randint(8, H - 14), rng.randint(8, W - 14)
        h, w = rng.randint(2, 10, 2)
        occ[r:r + h, c:c + w] = 1
    edf = jnp.asarray(edt(occ >= 0.5, RES), jnp.float32)
    org = jnp.asarray((-H * RES / 2, -W * RES / 2), jnp.float32)
    return occ, edf, org, (H, W)


def _rays(field, n=256, seed=0):
    occ, edf, org, hw = field
    rng = np.random.RandomState(seed)
    e = np.asarray(edf)
    ys, xs = np.where(e > 0.25)
    k = rng.randint(len(ys), size=n)
    x = np.asarray(org)[0] + (xs[k] + .5) * RES
    y = np.asarray(org)[1] + (ys[k] + .5) * RES
    th = rng.uniform(-np.pi, np.pi, n)
    return (jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
            jnp.asarray(np.cos(th), jnp.float32),
            jnp.asarray(np.sin(th), jnp.float32))


def test_forward_tracks_boundary_oracle(field):
    """Value contract: HIT/MISS follows the nearest (reference) march; the
    hit range sits on the tau = res/2 bilinear level set, which on walls is
    the occupied-cell boundary — i.e. the geometric oracle's surface. So
    r_oracle <= ~r_implicit <= r_nearest (+sub-cell slack), and the
    implicit range tracks the ORACLE to sub-cell error wherever the
    nearest march agrees with the oracle (away from its known corner
    tunneling)."""
    from pyracecarsimulator_tpu.maps.segments import (
        extract_segments, raycast_segments_numpy)
    occ, edf, org, hw = field
    x, y, ct, st = _rays(field, 512)
    r_imp = np.asarray(march_rays_implicit(edf, RES, org, x, y, ct, st,
                                           MAXR, 1e-4, 256, hw))
    r_near = np.asarray(march_rays(edf, RES, org, x, y, ct, st,
                                   max_range=MAXR, eps=1e-4, max_iters=512,
                                   interp="nearest", bounds_hw=hw))
    segs = extract_segments(occ, RES, np.asarray(org))
    r_or = raycast_segments_numpy(segs, np.asarray(x), np.asarray(y),
                                  np.asarray(ct), np.asarray(st), MAXR)
    # compare where the reference march itself matched the oracle (it
    # tunnels some corners; that is its documented semantics)
    agree = np.abs(r_near - r_or) < 2 * RES
    assert agree.mean() > 0.9
    d = np.abs(r_imp - r_or)[agree]
    assert np.quantile(d, 0.95) < 1.5 * RES, (np.quantile(d, 0.95),
                                              d.max())
    # and the implicit range never exceeds the nearest march's stop by
    # more than the bracket extension
    assert (r_imp - r_near).max() < RES


def test_vjp_matches_fd_of_own_forward(field):
    """Central finite differences of the implicit forward vs the analytic
    VJP, in all four differentiable ray args and in the map."""
    occ, edf, org, hw = field
    x, y, ct, st = _rays(field, 96, seed=3)

    def f(edf_, x_, y_, ct_, st_):
        return jnp.sum(march_rays_implicit(edf_, RES, org, x_, y_, ct_,
                                           st_, MAXR, 1e-4, 256, hw))

    g = jax.grad(f, argnums=(0, 1, 2, 3, 4))(edf, x, y, ct, st)
    # The function is piecewise-smooth: the march's bracket pattern shifts
    # at cell boundaries, so an FD probe straddling a kink is meaningless.
    # Detect kinks by one-sided FD disagreement and require a high pass
    # rate among the smooth probes (standard a.e.-gradient methodology,
    # same as tests/test_grad.py's treatment of tie boundaries).
    h = 1e-3
    rng = np.random.RandomState(0)
    checked = passed = 0
    for ai, arg in ((1, x), (2, y), (3, ct), (4, st)):
        ga = np.asarray(g[ai])
        for j in rng.choice(len(np.asarray(x)), 8, replace=False):
            e = jnp.zeros_like(arg).at[j].set(h)
            args = [edf, x, y, ct, st]
            f0 = float(f(*args))
            args[ai] = arg + e
            fp = float(f(*args))
            args[ai] = arg - e
            fm = float(f(*args))
            fd_f = (fp - f0) / h
            fd_b = (f0 - fm) / h
            fd = 0.5 * (fd_f + fd_b)
            smooth = (abs(fd_f - fd_b) < 0.05 * (1 + abs(fd))
                      and abs(fd) < 50)
            if not smooth:
                continue
            checked += 1
            passed += abs(fd - ga[j]) < 5e-2 + 0.05 * abs(fd)
    assert checked >= 12 and passed / checked >= 0.9, (checked, passed)
    # map cotangent, PER RAY: perturbing one cell re-routes every ray that
    # sampled it during the march (kinks), so the sum-FD is hopeless; the
    # per-ray range response to its own strongest hit cell is clean.
    def ray_fn(edf_):
        return march_rays_implicit(edf_, RES, org, x, y, ct, st, MAXR,
                                   1e-4, 256, hw)

    r0, vjp = jax.vjp(ray_fn, edf)
    mchecked = mpassed = 0
    for j in rng.choice(len(np.asarray(x)), 10, replace=False):
        if float(r0[j]) >= MAXR - 1e-6:
            continue
        (grow,) = vjp(jnp.zeros_like(r0).at[j].set(1.0))
        grow = np.asarray(grow)
        fi = np.abs(grow.ravel()).argmax()
        if grow.ravel()[fi] == 0:
            continue
        e = jnp.zeros(edf.size).at[fi].set(h).reshape(edf.shape)
        rp = float(ray_fn(edf + e)[j])
        rm = float(ray_fn(edf - e)[j])
        rc = float(r0[j])
        fd_f, fd_b = (rp - rc) / h, (rc - rm) / h
        fd = 0.5 * (fd_f + fd_b)
        if abs(fd_f - fd_b) > 0.05 * (1 + abs(fd)):
            continue
        mchecked += 1
        mpassed += abs(fd - grow.ravel()[fi]) < 2e-2 + 0.1 * abs(fd)
    assert mchecked >= 5 and mpassed / mchecked >= 0.8, (mchecked, mpassed)


def test_grad_agrees_with_bilinear_autodiff(field):
    """Pose gradient vs jax.grad of the exact bilinear march (the frozen
    reference for d range/d map): agree on well-conditioned rays."""
    occ, edf, org, hw = field
    x, y, ct, st = _rays(field, 128, seed=5)

    def f_imp(x_, y_):
        return march_rays_implicit(edf, RES, org, x_, y_, ct, st, MAXR,
                                   1e-4, 256, hw)

    def f_bil(x_, y_):
        return march_rays(edf, RES, org, x_, y_, ct, st, max_range=MAXR,
                          eps=1e-4, max_iters=512, interp="bilinear",
                          bounds_hw=hw)

    gi = jax.grad(lambda a, b: jnp.sum(f_imp(a, b)), (0, 1))(x, y)
    gb = jax.grad(lambda a, b: jnp.sum(f_bil(a, b)), (0, 1))(x, y)
    # compare where both paths hit the same wall (the tau vs eps level
    # sets are parallel ~res/2 apart there, so the DERIVATIVES agree even
    # though the values are offset)
    close = np.abs(np.asarray(f_imp(x, y))
                   - np.asarray(f_bil(x, y))) < 2 * RES
    for a, b in zip(gi, gb):
        a, b = np.asarray(a)[close], np.asarray(b)[close]
        sel = (np.abs(b) < 20) & (np.abs(a) < 20)   # drop grazing blowups
        assert sel.mean() > 0.8
        ok = np.abs(a[sel] - b[sel]) < 0.15 + 0.1 * np.abs(b[sel])
        # the two surfaces differ a.e. on a measure-zero kink set (the
        # implicit path's consistency gate zeroes degenerate corner hits;
        # the truncated bilinear march carries tail grads) — demand a high
        # agreement RATE, not pointwise equality
        assert ok.mean() >= 0.9, (ok.mean(), np.abs(a - b).max())


def test_scan_wrapper_and_misses(field):
    occ, edf, org, hw = field
    poses = jnp.asarray([[0.0, 0.0, 0.3], [50.0, 50.0, 0.0]], jnp.float32)
    r = scan_poses_implicit(edf, RES, org, poses, num_beams=64,
                            max_range=MAXR, bounds_hw=hw)
    assert r.shape == (2, 64)
    assert np.all(np.asarray(r)[1] == MAXR)        # out-of-map -> max_range
    # misses contribute zero map gradient
    g = jax.grad(lambda e: jnp.sum(scan_poses_implicit(
        e, RES, org, poses[1:], num_beams=64, max_range=MAXR,
        bounds_hw=hw)))(edf)
    assert float(jnp.abs(g).sum()) == 0.0


def test_with_map_gradient_matches_implicit(field):
    """The hybrid op (fast geometric forward + IFT map cotangent) must
    produce the same ∂loss/∂map as the pure implicit march when fed that
    march's own ranges — both differentiate the same tau surface at the
    same points — and a nearby cotangent when fed the exact segment
    backend's ranges (surfaces coincide on walls). Values pass through
    bit-identically and the r-cotangent is preserved."""
    from pyracecarsimulator_tpu.maps.segments import (
        extract_segments, raycast_segments_numpy)
    from pyracecarsimulator_tpu.ops.raymarch_diff import with_map_gradient
    occ, edf, org, hw = field
    x, y, ct, st = _rays(field, 128, seed=9)

    def loss_implicit(e):
        r = march_rays_implicit(e, RES, org, x, y, ct, st, MAXR, 1e-4,
                                256, hw)
        return jnp.sum(r ** 2)

    r_imp = march_rays_implicit(edf, RES, org, x, y, ct, st, MAXR, 1e-4,
                                256, hw)

    def loss_hybrid(e, r_in):
        r = with_map_gradient(e, r_in, x, y, ct, st, RES, org, 1e-4, hw)
        return jnp.sum(r ** 2)

    # value pass-through
    np.testing.assert_array_equal(
        np.asarray(with_map_gradient(edf, r_imp, x, y, ct, st, RES, org,
                                     1e-4, hw)), np.asarray(r_imp))
    g_imp = np.asarray(jax.grad(loss_implicit)(edf))
    g_hyb = np.asarray(jax.grad(loss_hybrid, argnums=0)(edf, r_imp))
    np.testing.assert_allclose(g_hyb, g_imp, atol=2e-2, rtol=1e-3)
    # r cotangent passes through: d loss/d r_in = 2 r
    gr = np.asarray(jax.grad(loss_hybrid, argnums=1)(edf, r_imp))
    np.testing.assert_allclose(gr, 2 * np.asarray(r_imp), rtol=1e-6)
    # segment-backend forward: same surface on walls -> cotangents close
    # on most rays (corners/gate differences allowed at a low rate)
    segs = extract_segments(occ, RES, np.asarray(org))
    r_seg = jnp.asarray(raycast_segments_numpy(
        segs, np.asarray(x), np.asarray(y), np.asarray(ct),
        np.asarray(st), MAXR), jnp.float32)
    g_seg = np.asarray(jax.grad(loss_hybrid, argnums=0)(edf, r_seg))
    num = np.abs(g_seg - g_imp).sum()
    den = np.abs(g_imp).sum() + 1e-9
    assert num / den < 0.25, num / den


def test_wmg_dedup_matches_scatter(field):
    """Sort-by-cell segment-sum backward (dedup=True) produces the same
    map cotangent as the scatter-add form up to f32 summation order."""
    from pyracecarsimulator_tpu.ops.raymarch_diff import with_map_gradient
    occ, edf, org, hw = field
    x0, y0, ct, st = _rays(field, n=512, seed=5)
    r = march_rays_implicit(edf, RES, org, x0, y0, ct, st, MAXR, 1e-4, 128)

    def grad_of(dedup):
        f = lambda e: jnp.sum(with_map_gradient(
            e, r, x0, y0, ct, st, RES, org, 1e-4, None, dedup) ** 2)
        return jax.grad(f)(edf)

    g0, g1 = grad_of(False), grad_of(True)
    assert float(jnp.sum(jnp.abs(g0))) > 0         # non-trivial cotangent
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g1),
                               rtol=1e-5, atol=1e-6)
