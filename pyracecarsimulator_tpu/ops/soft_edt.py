"""Differentiable distance transform (occupancy -> EDF) on device.

SURVEY.md §2a "Distance transform" row flags an "optional jax EDT for
d/d map completeness": the exact Felzenszwalb EDT (maps/edt.py, csrc/) is a
host-side precompute and not differentiable w.r.t. occupancy. This module
closes the chain

    occupancy (continuous, [0,1]) --edt--> EDF --march--> ranges

so ``jax.grad`` reaches the *map itself* — enabling occupancy reconstruction
from scans (examples/demo_mapping.py) and map-level optimization.

Algorithm: chamfer wavefront propagation. Initialize ``d = (1 - occ) * BIG``
(0 inside obstacles, huge in free space, linear in fractional occupancy so
gradients flow), then repeat ``iters`` times:

    d <- min(d, min over 8 neighbors of (d_neighbor + step_neighbor))

with exact euclidean steps (1, sqrt2) — the classic 3x3 chamfer mask, whose
distances overestimate true euclidean by at most ~8% (worst at ~22.5 deg).
``min`` gives exact subgradients to the argmin chain (like maxpool), so
autodiff yields the geodesic-path derivative. Each iteration is a cheap
stencil (shifts + mins) — fully vectorized, no gathers; ``iters`` bounds
the propagation radius in cells.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

_SQRT2 = 1.4142135623730951


def _neighbor_candidates(d):
    """The 8 chamfer-neighborhood candidates (d_neighbor + step). Borders
    clamp to edge values (replicate pad), which leaves border distances
    governed by in-map obstacles only."""
    p = jnp.pad(d, 1, mode="edge")
    return [
        p[:-2, 1:-1] + 1.0, p[2:, 1:-1] + 1.0,
        p[1:-1, :-2] + 1.0, p[1:-1, 2:] + 1.0,
        p[:-2, :-2] + _SQRT2, p[:-2, 2:] + _SQRT2,
        p[2:, :-2] + _SQRT2, p[2:, 2:] + _SQRT2,
    ]


@functools.partial(jax.jit,
                   static_argnames=("iters", "temperature", "init",
                                    "init_lambda"))
def soft_edt(occupancy, resolution=1.0, iters: int = 64,
             temperature: float = 0.0, init: str = "linear",
             init_lambda: float = 3.0):
    """Differentiable chamfer distance field in meters.

    Args:
      occupancy: (H, W) float in [0, 1]; 1 = occupied. Fractional values
        lower the local distance proportionally (the differentiable
        relaxation).
      resolution: meters per cell.
      iters: propagation sweeps = max distance radius in cells. Distances
        beyond ``iters`` cells from any obstacle saturate (fine for
        ray-marching: steps clamp at max_range anyway).
      temperature: 0 = hard min (exact chamfer; gradients concentrate on
        the argmin chain roots, i.e. the hit obstacle's cells). > 0 =
        softmin in cells (e.g. 0.25): distances blur slightly and
        gradients spread across near-optimal chains.
      init: occupancy -> seed-distance map. "linear": (1-occ)*cap — exact
        for binary maps, but fractional cells only compete once occ is
        near 1 (hard-min gradient desert). "log": -init_lambda*ln(occ) —
        a cell with occupancy p seeds distance lam*ln(1/p), so PARTIAL
        beliefs already shorten nearby distances and d(range)/d(occ) is
        nonzero wherever occ > exp(-cap/lam): the occupancy-
        reconstruction mode (examples/demo_mapping.py).
      init_lambda: scale of the log init, in cells.

    Returns:
      (H, W) float32 distance field (chamfer metric, <=8% over-estimate
      at temperature 0 with binary occupancy).
    """
    cap = float(iters) + 1.0
    occupancy = jnp.asarray(occupancy, jnp.float32)
    if init == "log":
        floor = float(np.exp(-cap / init_lambda))
        d0 = -init_lambda * jnp.log(jnp.clip(occupancy, floor, 1.0))
    else:
        # init at the saturation cap (not 1e38): keeps d(occ) gradients at
        # a sane O(cap) scale instead of O(1e38)
        d0 = (1.0 - occupancy) * cap

    if temperature > 0.0:
        inv_t = 1.0 / temperature

        def combine(d):
            stack = jnp.stack([d] + _neighbor_candidates(d))
            return -temperature * jax.nn.logsumexp(-stack * inv_t, axis=0)
    else:
        def combine(d):
            out = d
            for c in _neighbor_candidates(d):
                out = jnp.minimum(out, c)
            return out

    def body(d, _):
        return combine(d), None

    d, _ = jax.lax.scan(body, d0, None, length=iters)
    return jnp.clip(d, 0.0, cap) * resolution


def scan_from_occupancy(occupancy, resolution, origin_xy, poses,
                        num_beams=1080, fov=4.712388980384690,
                        max_range=10.0, eps=1e-4, max_iters=128,
                        edt_iters: int = 64, bounds_hw=None):
    """End-to-end differentiable occupancy -> lidar ranges.

    Composes ``soft_edt`` with the bilinear DT march; ``jax.grad`` of any
    loss of the output reaches the occupancy grid (scatter through the
    visited cells, then back along the chamfer argmin chains).
    """
    from .raymarch_xla import scan_poses
    edf = soft_edt(occupancy, resolution, iters=edt_iters)
    return scan_poses(edf, resolution, origin_xy, poses,
                      num_beams=num_beams, fov=fov, max_range=max_range,
                      eps=eps, max_iters=max_iters, interp="bilinear",
                      bounds_hw=bounds_hw)
