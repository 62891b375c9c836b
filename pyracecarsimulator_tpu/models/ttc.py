"""Time-to-collision (TTC) check — pure JAX.

Batched equivalent of the reference's per-beam TTC loop and its
``Precompute`` tables (SURVEY.md §2a "TTC precompute" / "TTC collision
check"; lineage ``precompute.cpp`` + facade collision branch). Tables are
trace-time jnp constants (SURVEY.md §2c item 5); the check itself is a
branchless reduction over the beam axis.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import CarParams


def ttc_tables(num_beams: int, fov: float, p: CarParams):
    """Per-beam cos(beam offset) and scanner->footprint-edge distances.

    The scanner sits ``scan_distance_to_base_link`` ahead of the rear axle;
    the car rectangle (length x width) is centered on the wheelbase midpoint.
    ``car_distances[i]`` is the exit distance of beam i from inside that
    rectangle (slab method), matching the oracle in
    ``oracle/dynamics.py::ttc_tables``.
    """
    offs = jnp.linspace(-fov / 2.0, fov / 2.0, num_beams)
    cosines = jnp.cos(offs)
    rear_overhang = (p.length - p.wheelbase) / 2.0
    x_min = -(p.scan_distance_to_base_link + rear_overhang)
    x_max = p.wheelbase + rear_overhang - p.scan_distance_to_base_link
    y_min, y_max = -p.width / 2.0, p.width / 2.0
    c = jnp.cos(offs)
    s = jnp.sin(offs)
    big = jnp.asarray(1e9, jnp.float32)
    tx = jnp.where(c != 0, jnp.maximum(x_min / jnp.where(c == 0, 1.0, c),
                                       x_max / jnp.where(c == 0, 1.0, c)), big)
    ty = jnp.where(s != 0, jnp.maximum(y_min / jnp.where(s == 0, 1.0, s),
                                       y_max / jnp.where(s == 0, 1.0, s)), big)
    return cosines, jnp.minimum(tx, ty)


def check_ttc(ranges, velocity, cosines, car_distances, ttc_threshold):
    """Any-beam TTC collision predicate.

    Args:
      ranges: (..., B) scan ranges [m].
      velocity: (...,) longitudinal speed [m/s].
      cosines, car_distances: (B,) precomputed tables.
      ttc_threshold: latch threshold [s].

    Returns:
      (...,) bool — True where any beam's TTC is in [0, threshold).
    """
    proj = velocity[..., None] * cosines            # closing speed per beam
    safe = jnp.where(proj > 0, proj, 1.0)
    ttc = (ranges - car_distances) / safe
    hit = (proj > 0) & (ttc >= 0.0) & (ttc < ttc_threshold)
    return jnp.any(hit, axis=-1)
