"""Distance-transform ray-march on XLA: the scan simulator's hot loop.

Batched replacement for the reference's native per-beam ray-march
(SURVEY.md §3.3, lineage ``ScanSimulator2D::scan`` / ``trace_ray``). Design
notes:

* The reference's data-dependent ``while d > eps`` becomes a **fixed-trip
  ``lax.scan``** with an alive mask — all rays march in lockstep, finished
  rays step by zero. Static shapes, no divergence, no recompilation.
* The inner gather ``edf[cell]`` is one dependent gather per march step,
  so this backend is gather-latency-bound. It is kept as the
  *reference-exact semantics* backend (every DT step identical to the
  oracle) and as the ``∂range/∂map`` provider; the exact-geometry path is
  the segment-intersection family (``raycast_segments.py``,
  ``raycast_sectors.py``), which needs no gathers in the hot loop. Which
  is faster on the card is not measured yet.
* Everything is shape-polymorphic over a leading ray batch: callers vmap /
  shard over (agents, beams) however they like; the op itself is written on
  flat ray vectors so sharding layouts stay trivial.

Differentiability: with ``interp="bilinear"`` the EDF sample is a bilinear
interpolation, making ranges piecewise-smooth in pose and map; plain
``jax.grad`` through this function yields exact gradients of the computed
march (the backward pass is XLA-generated scatter-adds into the map
cotangent — the "scatter-add along visited cells" contract of SURVEY.md §7
step 5). ``interp="nearest"`` is exact reference semantics (ranges a.e.
piecewise-constant in pose, so its true derivative is zero a.e.; use
bilinear for optimization).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


def beam_angles(num_beams: int, fov: float) -> jnp.ndarray:
    """Beam angle offsets in [-fov/2, fov/2], inclusive endpoints."""
    return jnp.linspace(-fov / 2.0, fov / 2.0, num_beams)


def sample_edf_nearest(edf: jnp.ndarray, gx, gy, bounds_hw=None):
    """Nearest-cell EDF sample in grid units. Out-of-map -> -1 sentinel.

    ``bounds_hw``: real (unpadded) map dims for the in-bounds test; the
    gather itself uses the padded array (padding is free space, loader doc).
    """
    hp, wp = edf.shape
    h, w = bounds_hw if bounds_hw is not None else (hp, wp)
    ix = jnp.floor(gx).astype(jnp.int32)
    iy = jnp.floor(gy).astype(jnp.int32)
    inb = (ix >= 0) & (iy >= 0) & (ix < w) & (iy < h)
    flat = jnp.clip(iy, 0, hp - 1) * wp + jnp.clip(ix, 0, wp - 1)
    d = jnp.take(edf.reshape(-1), flat)
    return jnp.where(inb, d, -1.0)


def sample_edf_bilinear(edf: jnp.ndarray, gx, gy, bounds_hw=None):
    """Bilinear EDF sample, cell-center convention (value of cell (i,j)
    lives at grid point (j+0.5, i+0.5)). Out-of-map -> -1 sentinel."""
    hp, wp = edf.shape
    h, w = bounds_hw if bounds_hw is not None else (hp, wp)
    inb = (gx >= 0) & (gy >= 0) & (gx < w) & (gy < h)
    xs = jnp.clip(gx - 0.5, 0.0, wp - 1.0)
    ys = jnp.clip(gy - 0.5, 0.0, hp - 1.0)
    # clamp the integer base so all 4 taps stay in bounds: f32 rounds a
    # wp - 1.000001 clip bound up to wp - 1 exactly, making base + wp an
    # OOB gather (jnp.take fills NaN) within the last half-cell of an
    # unpadded map
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
    return jnp.where(inb, val, -1.0)


@functools.partial(
    jax.jit,
    static_argnames=("max_iters", "interp", "bounds_hw"))
def march_rays(edf: jnp.ndarray, resolution, origin_xy,
               x0, y0, cos_t, sin_t,
               max_range=10.0, eps=0.0001,
               max_iters: int = 256, interp: str = "nearest",
               bounds_hw=None):
    """March a batch of rays through the EDF. All ray args share one shape.

    Args:
      edf: (H, W) float32 euclidean distance field in meters.
      resolution: meters per cell.
      origin_xy: (2,) world coords of grid corner (0, 0).
      x0, y0: ray origins in world meters, any shape S.
      cos_t, sin_t: ray direction cosines, shape S.
      max_range: range clamp in meters.
      eps: hit threshold in meters (reference ray_tracing_epsilon).
      max_iters: static trip count. The sphere-trace step is >= one cell for
        any free cell, so ``max_range/resolution`` iterations are always
        sufficient for exact reference parity; fewer trade accuracy on
        wall-grazing rays for speed.
      interp: "nearest" (reference parity) or "bilinear" (differentiable).

    Returns:
      ranges: shape S, clamped to max_range.
    """
    sample = sample_edf_nearest if interp == "nearest" else sample_edf_bilinear
    inv_res = 1.0 / resolution
    ox = origin_xy[0]
    oy = origin_xy[1]

    def body(carry, _):
        x, y, total, alive = carry
        gx = (x - ox) * inv_res
        gy = (y - oy) * inv_res
        d = sample(edf, gx, gy, bounds_hw)
        oob = d < 0.0                       # left the map
        hit = d <= eps                      # includes oob; refined below
        # Reference loop condition: d > eps and in-map and total < max_range
        live = alive & ~hit & ~oob & (total < max_range)
        step = jnp.where(live, d, 0.0)
        # Out-of-map rays return max_range (clamp applied at the end).
        total = jnp.where(alive & oob, jnp.full_like(total, max_range), total)
        alive = live
        return (x + step * cos_t, y + step * sin_t, total + step, alive), None

    zeros = jnp.zeros_like(x0)
    alive0 = jnp.ones(jnp.shape(x0), bool)
    (xf, yf, total, _), _ = jax.lax.scan(
        body, (x0, y0, zeros, alive0), None, length=max_iters)
    return jnp.minimum(total, max_range)


def scan_poses(edf: jnp.ndarray, resolution, origin_xy, poses,
               num_beams: int = 1080, fov: float = 4.712388980384690,
               max_range=10.0, eps=0.0001, max_iters: int = 256,
               interp: str = "nearest",
               theta_discretization: int = 0,
               bounds_hw=None) -> jnp.ndarray:
    """Full lidar scans for a batch of poses.

    Args:
      poses: (..., 3) array of (x, y, theta).
      theta_discretization: if > 0, use the reference's theta-bucket trig
        tables (exactly reproduces its quantized beam directions); 0 uses
        exact trig.

    Returns:
      ranges: (..., num_beams) float32.
    """
    from .common import rays_from_poses
    batch, poses2, xb, yb, ct, st = rays_from_poses(
        poses, num_beams, fov, theta_discretization)
    r = march_rays(edf, resolution, origin_xy, xb, yb, ct, st,
                   max_range=max_range, eps=eps,
                   max_iters=max_iters, interp=interp,
                   bounds_hw=bounds_hw)
    return r.reshape(*batch, num_beams)
