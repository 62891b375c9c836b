"""Fast differentiable DT march: implicit-function gradients at the hit.

Why: the ``edf_bilinear`` backend (raymarch_xla.py, interp="bilinear") is
the exact-autodiff reference for ∂range/∂map, but reverse-mode through a
256-step march materializes a 256-long scatter-add chain into the map
cotangent, orders of magnitude slower than the forward paths. The fix is
to remove the gathers/scatters from the backward almost entirely:

  * FORWARD: nearest-sample sphere trace (ONE gather per step instead of
    bilinear's four; in free space the nearest EDF sample is >= one cell,
    so the trip count is bounded by max_range/resolution) inside a
    ``lax.while_loop`` (legal here — the custom VJP makes the forward
    opaque to autodiff), then a bisection+Newton refinement of the hit
    range onto the BILINEAR level set E(p(r)) = tau, tau = max(eps, res/2).
    On flat walls that level set IS the occupied-cell boundary (the same
    surface the exact segment backend / geometric oracle computes), so the
    refined ranges align with ``raycast_segments`` to sub-cell error.
  * BACKWARD: the hit range r* satisfies F(r) = E_bilinear(p(r)) - tau = 0,
    so by the implicit function theorem (SURVEY.md §7 step 5 "implicit-fn
    treatment at the hit surface"):
        dr/dtheta_cell = -w_cell / (dE/dr),   w_cell = bilinear weight
        dr/d(origin)   = -grad_world E / (dE/dr)
    i.e. O(rays) elementwise math plus ONE 4-cell scatter-add per ray into
    the map cotangent. Misses (max-range / out-of-map) and grazing hits
    (|dE/dr| below a floor) get zero gradient — the same a.e. statement as
    the reference's piecewise behavior.

Semantics: HIT/MISS is decided by the reference nearest-sample rule; the
hit's sub-cell placement is the tau level set (~the occupied boundary).
Values therefore sit between the exact geometric boundary and the nearest
march's inside-the-cell stop — quantified against the oracle in
tests/test_raymarch_diff.py. ``edf_bilinear`` (raymarch_xla.py) is kept
unchanged as the frozen exact-autodiff reference.

No reference equivalent (the reference has no gradients at all,
SURVEY.md §2b "gradient parallelism: reference absent").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .raymarch_xla import sample_edf_nearest, sample_edf_bilinear

_DENOM_FLOOR = 1e-2    # |dE/dr| below this => grazing; zero gradient


def _bilinear_patch(edf, gx, gy, bounds_hw):
    """Bilinear value + grid-space gradient + the 4 taps' flat indices and
    weights at grid coords (gx, gy). Mirrors sample_edf_bilinear's
    cell-center convention exactly (raymarch_xla.py)."""
    hp, wp = edf.shape
    h, w = bounds_hw if bounds_hw is not None else (hp, wp)
    inb = (gx >= 0) & (gy >= 0) & (gx < w) & (gy < h)
    xs = jnp.clip(gx - 0.5, 0.0, wp - 1.0)
    ys = jnp.clip(gy - 0.5, 0.0, hp - 1.0)
    # clamp the integer base so all 4 taps stay in bounds: f32 rounds
    # wp - 1.000001 up to wp - 1 exactly, and an OOB jnp.take fills NaN,
    # which 0-masking turns into NaN gradients (0 * NaN)
    x0 = jnp.minimum(jnp.floor(xs).astype(jnp.int32), wp - 2)
    y0 = jnp.minimum(jnp.floor(ys).astype(jnp.int32), hp - 2)
    fx = xs - x0
    fy = ys - y0
    flat = edf.reshape(-1)
    base = y0 * wp + x0
    f00 = jnp.take(flat, base)
    f01 = jnp.take(flat, base + 1)
    f10 = jnp.take(flat, base + wp)
    f11 = jnp.take(flat, base + wp + 1)
    val = (f00 * (1 - fx) + f01 * fx) * (1 - fy) \
        + (f10 * (1 - fx) + f11 * fx) * fy
    dgx = (f01 - f00) * (1 - fy) + (f11 - f10) * fy
    dgy = (f10 - f00) * (1 - fx) + (f11 - f01) * fx
    weights = ((1 - fx) * (1 - fy), fx * (1 - fy),
               (1 - fx) * fy, fx * fy)
    idx = (base, base + 1, base + wp, base + wp + 1)
    return val, dgx, dgy, weights, idx, inb


def _march_nearest(edf, inv_res, ox, oy, x0, y0, cos_t, sin_t, max_range,
                   eps, max_iters, bounds_hw):
    """Reference-rule sphere trace with nearest sampling. Returns
    (total, last_step, hit): ``total`` ends one sample inside the first
    occupied cell (reference trace_ray semantics, SURVEY.md §3.3);
    ``[total - last_step, total]`` brackets the boundary crossing."""

    def cond(c):
        _, _, _, _, alive, _, it = c
        return (it < max_iters) & jnp.any(alive)

    def body(c):
        x, y, total, last, alive, hit, it = c
        gx = (x - ox) * inv_res
        gy = (y - oy) * inv_res
        d = sample_edf_nearest(edf, gx, gy, bounds_hw)
        oob = d < 0.0
        hit_now = alive & (d <= eps) & ~oob
        hit = hit | hit_now
        live = alive & ~hit_now & ~oob & (total < max_range)
        step = jnp.where(live, d, 0.0)
        total = jnp.where(alive & oob, jnp.full_like(total, max_range),
                          total)
        last = jnp.where(live, step, last)
        return (x + step * cos_t, y + step * sin_t, total + step, last,
                live, hit, it + 1)

    zeros = jnp.zeros_like(x0)
    alive0 = jnp.ones(jnp.shape(x0), bool)
    c = (x0, y0, zeros, zeros, alive0, jnp.zeros_like(alive0),
         jnp.int32(0))
    x, y, total, last, _, hit, _ = jax.lax.while_loop(cond, body, c)
    return total, last, hit


def _refine(edf, inv_res, ox, oy, x0, y0, cos_t, sin_t, eps, bounds_hw,
            lo, hi, iters=12):
    """Bisection + one Newton polish for the first bilinear eps-crossing
    in [lo, hi]. The bracket can be as long as the whole ray (a head-on
    march reaches the wall in ONE step, so last_step == total), hence 12
    halvings (10 m -> 2.4 mm) before the polish.

    The polish is anchored at the OUTSIDE end ``lo``: its bilinear patch
    straddles free/occupied cells, so the slope is informative, whereas the
    midpoint can sit in an all-occupied flat-zero patch (dE/dr = 0) whose
    fallback sign once pushed the result to the bracket top (a hit one cell
    deep with zero gradient — caught by the flat-wall probe)."""

    def eval_F(r):
        gx = (x0 + r * cos_t - ox) * inv_res
        gy = (y0 + r * sin_t - oy) * inv_res
        val, dgx, dgy, _, _, _ = _bilinear_patch(edf, gx, gy, bounds_hw)
        denom = (dgx * cos_t + dgy * sin_t) * inv_res   # dE/dr, 1/m * m
        return val - eps, denom

    # bisection is branch-free and always convergent here: E > eps =>
    # still outside => the first crossing is beyond r.
    def bis(i, c):
        lo, hi = c
        r = 0.5 * (lo + hi)
        F, _ = eval_F(r)
        lo = jnp.where(F > 0, r, lo)
        hi = jnp.where(F > 0, hi, r)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, iters, bis, (lo, hi))
    F, dF = eval_F(lo)
    # approach convention: E decreases along the ray into the surface, so
    # the degenerate-slope fallback is negative.
    safe = jnp.where(dF > -_DENOM_FLOOR, -_DENOM_FLOOR, dF)
    return jnp.clip(lo - F / safe, lo, hi)


def _surface_level(eps, resolution):
    """The bilinear level set the hit is refined onto. eps (1e-4 m) would
    put it at the occupied-cell CENTER (the bilinear field only reaches
    ~0 there), and at corner hits that set may not even be crossed inside
    the march's bracket. tau = res/2 instead crosses exactly at the
    occupied-cell BOUNDARY on flat walls (E_bilinear is linear res -> 0
    between the adjacent free and occupied cell centers), i.e. the same
    surface as the exact segment backend / geometric oracle — and it is
    always well-conditioned (|dE/dr| ~ cos(incidence)) near the wall."""
    return jnp.maximum(eps, 0.5 * resolution)


def _fwd_impl(edf, resolution, origin_xy, x0, y0, cos_t, sin_t,
              max_range, eps, max_iters, bounds_hw):
    inv_res = 1.0 / resolution
    ox, oy = origin_xy[0], origin_xy[1]
    total, last, hit = _march_nearest(
        edf, inv_res, ox, oy, x0, y0, cos_t, sin_t, max_range, eps,
        max_iters, bounds_hw)
    lo = jnp.maximum(total - last, 0.0)
    # bracket top extended 0.4 cells past the march stop: a landing just
    # inside the occupied cell's entry corner can still have
    # E_bilinear > tau; 0.4 cells cannot cross a thin wall's far side.
    hi = total + 0.4 * resolution
    tau = _surface_level(eps, resolution)
    r_hit = _refine(edf, inv_res, ox, oy, x0, y0, cos_t, sin_t, tau,
                    bounds_hw, lo, hi)
    r = jnp.where(hit, r_hit, jnp.minimum(total, max_range))
    r = jnp.minimum(r, max_range)
    hit = hit & (r < max_range)
    return r, hit


@functools.partial(jax.custom_vjp, nondiff_argnums=(7, 8, 9, 10))
def march_rays_implicit(edf, resolution, origin_xy, x0, y0, cos_t, sin_t,
                        max_range=10.0, eps=0.0001, max_iters: int = 256,
                        bounds_hw=None):
    """Differentiable DT march with implicit-function VJP (module doc).

    Same signature family as ``march_rays`` (raymarch_xla.py); ray args
    share one shape. Differentiable in ``edf`` (4-cell scatter at the hit),
    ``resolution``/``origin_xy`` get zero cotangents, ray origins and
    direction cosines get the closed-form hit-surface gradients.
    """
    r, _ = _fwd_impl(edf, resolution, origin_xy, x0, y0, cos_t, sin_t,
                     max_range, eps, max_iters, bounds_hw)
    return r


def _mri_fwd(edf, resolution, origin_xy, x0, y0, cos_t, sin_t,
             max_range, eps, max_iters, bounds_hw):
    r, hit = _fwd_impl(edf, resolution, origin_xy, x0, y0, cos_t, sin_t,
                       max_range, eps, max_iters, bounds_hw)
    return r, (edf, resolution, origin_xy, x0, y0, cos_t, sin_t, r, hit)


def _mri_bwd(max_range, eps, max_iters, bounds_hw, res, g):
    edf, resolution, origin_xy, x0, y0, cos_t, sin_t, r, hit = res
    inv_res = 1.0 / resolution
    ox, oy = origin_xy[0], origin_xy[1]
    gx = (x0 + r * cos_t - ox) * inv_res
    gy = (y0 + r * sin_t - oy) * inv_res
    val, dgx, dgy, weights, idx, inb = _bilinear_patch(edf, gx, gy,
                                                       bounds_hw)
    ex = dgx * inv_res                       # dE/dx_world [m EDF / m]
    ey = dgy * inv_res
    denom = ex * cos_t + ey * sin_t          # dE/dr along the ray
    # consistency gate: the IFT formula is only valid ON the tau level set;
    # refinement can end clamped at the bracket edge on degenerate corner
    # hits — those get the a.e.-correct zero gradient instead of a stale one
    tau = _surface_level(eps, resolution)
    on_surface = jnp.abs(val - tau) <= 0.6 * tau
    ok = hit & inb & on_surface & (jnp.abs(denom) >= _DENOM_FLOOR)
    scale = jnp.where(ok, -g / jnp.where(ok, denom, 1.0), 0.0)
    # map cotangent: dr/dtheta_cell = -w_cell / denom at the 4 taps
    flat_ct = jnp.zeros(edf.size, edf.dtype)
    for wgt, ix in zip(weights, idx):
        flat_ct = flat_ct.at[ix].add(scale * wgt)
    edf_ct = flat_ct.reshape(edf.shape)
    # pose cotangents: dr/dx0 = -ex/denom ; dr/dcos = -ex*r/denom
    gx0 = scale * ex
    gy0 = scale * ey
    gct = scale * ex * r
    gst = scale * ey * r
    zero_f = jnp.zeros((), jnp.float32)
    origin_ct = jax.tree_util.tree_map(lambda _: zero_f,
                                       origin_xy) if isinstance(
        origin_xy, tuple) else jnp.zeros_like(jnp.asarray(origin_xy))
    return (edf_ct, zero_f, origin_ct, gx0, gy0, gct, gst)


march_rays_implicit.defvjp(_mri_fwd, _mri_bwd)


def scan_poses_implicit(edf, resolution, origin_xy, poses,
                        num_beams: int = 1080,
                        fov: float = 4.712388980384690,
                        max_range=10.0, eps=0.0001, max_iters: int = 256,
                        theta_discretization: int = 0,
                        bounds_hw=None) -> jnp.ndarray:
    """Full lidar scans with the implicit-gradient march; poses (..., 3)."""
    from .common import rays_from_poses
    batch, poses2, xb, yb, ct, st = rays_from_poses(
        poses, num_beams, fov, theta_discretization)
    r = march_rays_implicit(edf, resolution, origin_xy, xb, yb, ct, st,
                            max_range, eps, max_iters, bounds_hw)
    return r.reshape(*batch, num_beams)


@functools.partial(jax.custom_vjp, nondiff_argnums=(8, 9, 10))
def with_map_gradient(edf, r, x0, y0, cos_t, sin_t, resolution, origin_xy,
                      eps: float = 0.0001, bounds_hw=None,
                      dedup: bool = False):
    """Attach a ∂range/∂map cotangent to ranges from ANY exact forward.

    The fast raycasts (sectors/segments) compute ranges from compiled
    GEOMETRY, so autodiff cannot reach the map. But their hit surface (the
    occupied-cell boundary) coincides with the EDF's bilinear
    tau = max(eps, res/2) level set on walls (see _surface_level), so the
    implicit-function map gradient evaluated AT the forward's hit point is
    the consistent derivative of the same surface:

        value:     r (straight-through — bit-identical to the input)
        d r/d edf: -w_cell / (dE/dr) at p(r), 4-cell scatter     (IFT)
        d r/d pose: passed through unchanged via the ``r`` cotangent (the
                    geometric backend's own analytic VJP owns those terms;
                    adding IFT pose terms here would double-count)

    Hits are rays with r < max-range-like values whose patch sits on the
    tau level set (the same consistency gate as march_rays_implicit); all
    others contribute zero map gradient. FD-checking this composite against
    ``edf`` is meaningless by construction (the forward does not read
    ``edf``); the gradient definition is FD-validated through
    ``march_rays_implicit``, which differentiates the same surface — their
    map cotangents are compared directly in tests/test_raymarch_diff.py.

    ``dedup=True`` switches the backward to the sort-by-cell form:
    rays are argsorted by their hit cell's base index once, then each
    tap is accumulated with
    ``jax.ops.segment_sum(indices_are_sorted=True)`` — the same values
    up to f32 summation order (adjacent beams hit the same cells, so
    sorted accumulation replaces most of the element-serial scatter).
    """
    return r


def _wmg_fwd(edf, r, x0, y0, cos_t, sin_t, resolution, origin_xy, eps,
             bounds_hw, dedup):
    return r, (edf, r, x0, y0, cos_t, sin_t, resolution, origin_xy)


def _wmg_bwd(eps, bounds_hw, dedup, res, g):
    edf, r, x0, y0, cos_t, sin_t, resolution, origin_xy = res
    inv_res = 1.0 / resolution
    ox, oy = origin_xy[0], origin_xy[1]
    gx = (x0 + r * cos_t - ox) * inv_res
    gy = (y0 + r * sin_t - oy) * inv_res
    val, dgx, dgy, weights, idx, inb = _bilinear_patch(edf, gx, gy,
                                                       bounds_hw)
    ex = dgx * inv_res
    ey = dgy * inv_res
    denom = ex * cos_t + ey * sin_t
    tau = _surface_level(eps, resolution)
    ok = inb & (jnp.abs(val - tau) <= 0.6 * tau) \
        & (jnp.abs(denom) >= _DENOM_FLOOR)
    scale = jnp.where(ok, -g / jnp.where(ok, denom, 1.0), 0.0)
    if dedup:
        # sort-by-cell attribution: one argsort by base index, then each
        # tap rides a sorted segment_sum (all 4 taps sit at base + const
        # offsets, so one order serves all; the tap's image position is a
        # static zero-padded shift of the per-base sums). Dead rays get a
        # sentinel segment one past the image and fall off the slice.
        n = edf.size
        stride = edf.shape[-1]
        base = jnp.where(ok.reshape(-1), idx[0].reshape(-1), n)
        order = jnp.argsort(base)
        bs = jnp.take(base, order)
        flat_ct = jnp.zeros(n, edf.dtype)
        for off, wgt in zip((0, 1, stride, stride + 1), weights):
            ws = jnp.take((scale * wgt).reshape(-1), order)
            seg = jax.ops.segment_sum(ws, bs, num_segments=n + 1,
                                      indices_are_sorted=True)[:n]
            if off:
                seg = jnp.concatenate(
                    [jnp.zeros((off,), edf.dtype), seg[:n - off]])
            flat_ct = flat_ct + seg
        edf_ct = flat_ct.reshape(edf.shape)
    else:
        flat_ct = jnp.zeros(edf.size, edf.dtype)
        for wgt, ix in zip(weights, idx):
            flat_ct = flat_ct.at[ix].add(scale * wgt)
        edf_ct = flat_ct.reshape(edf.shape)
    z = lambda a: jnp.zeros_like(a)
    zero_f = jnp.zeros((), jnp.float32)
    origin_ct = (jax.tree_util.tree_map(lambda _: zero_f, origin_xy)
                 if isinstance(origin_xy, tuple)
                 else jnp.zeros_like(jnp.asarray(origin_xy)))
    return (edf_ct, g, z(x0), z(y0), z(cos_t),
            z(sin_t), zero_f, origin_ct)


with_map_gradient.defvjp(_wmg_fwd, _wmg_bwd)
