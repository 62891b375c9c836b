"""Shared scan prologue/epilogue used by every raycast backend.

One implementation of the reference-parity-critical pieces — beam fan
construction, theta-bucket quantization (reference theta_discretization),
and the out-of-extent mask (reference out-of-map => max_range) — so the
backends (raymarch_xla, raycast_segments, raycast_general, parallel.mesh)
cannot drift apart.
"""

from __future__ import annotations

import jax.numpy as jnp


def beam_angles(num_beams: int, fov: float) -> jnp.ndarray:
    """Beam angle offsets in [-fov/2, fov/2], inclusive endpoints."""
    return jnp.linspace(-fov / 2.0, fov / 2.0, num_beams)


def quantize_angles(ang, theta_discretization: int):
    """Reference theta-bucket quantization: angle -> bucket-start angle.

    Matches oracle/raycast.py::scan's table mode: bucket index
    floor((a mod 2pi)/2pi * D), clipped to [0, D-1].
    """
    if not theta_discretization:
        return ang
    two_pi = 2.0 * jnp.pi
    idx = jnp.floor((ang % two_pi) / two_pi * theta_discretization)
    idx = jnp.clip(idx.astype(jnp.int32), 0, theta_discretization - 1)
    return idx * (two_pi / theta_discretization)


def fan_cos_sin(theta, offs, theta_discretization: int = 0):
    """Beam-fan direction cosines: (A,) headings x (B,) static beam
    offsets -> (ct, st), each (A, B).

    Exact mode (theta_discretization == 0, the default) computes the
    fan by ANGLE-ADDITION rotation: cos/sin of the heading ONCE PER
    AGENT, rotated by the static per-beam (cos d, sin d) constants
    (XLA constant-folds them) — 4 mul + 2 add per ray instead of two
    multi-op transcendentals per ray. Derivatives are analytically
    identical (d ct/d theta = -st); values differ from cos(theta + d)
    by ~1 ulp (both are f32 roundings of the same real angle), and
    every backend shares THIS definition, so cross-backend bit-parity
    is unaffected.

    theta_discretization > 0 keeps the reference theta-bucket table
    semantics (quantize_angles of the summed angle) unchanged.
    """
    theta = jnp.asarray(theta)
    if theta_discretization:
        ang = quantize_angles(theta[:, None] + offs[None, :],
                              theta_discretization)
        return jnp.cos(ang), jnp.sin(ang)
    cth = jnp.cos(theta)[:, None]
    sth = jnp.sin(theta)[:, None]
    cd = jnp.cos(offs)[None, :]
    sd = jnp.sin(offs)[None, :]
    return cth * cd - sth * sd, sth * cd + cth * sd


def rays_from_poses(poses, num_beams: int, fov: float,
                    theta_discretization: int = 0):
    """poses (..., 3) -> (batch_shape, poses2 (N,3), xb, yb, ct, st) with
    ray arrays shaped (N, num_beams)."""
    poses = jnp.asarray(poses)
    batch = poses.shape[:-1]
    poses2 = poses.reshape(-1, 3)
    ct, st = fan_cos_sin(poses2[:, 2], beam_angles(num_beams, fov),
                         theta_discretization)
    xb = jnp.broadcast_to(poses2[:, 0:1], ct.shape)
    yb = jnp.broadcast_to(poses2[:, 1:2], ct.shape)
    return batch, poses2, xb, yb, ct, st


def apply_extent_mask(r, x, y, extent, max_range):
    """Reference semantics: a scan from outside the real map is all
    max_range (the oracle's immediate out-of-map exit). x/y: (...,) scan
    origins; r: (..., B)."""
    ex0, ex1, ey0, ey1 = extent
    inside = (x >= ex0) & (x < ex1) & (y >= ey0) & (y < ey1)
    return jnp.where(inside[..., None], r, max_range)
