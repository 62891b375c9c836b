"""Static configuration pytrees for the racecar simulator.

Reference parity: mirrors the parameter surface of the reference simulator's
``CarParams`` / scan-simulator constructor arguments (see SURVEY.md §2a rows
"Car parameters" and "ScanSimulator2D"; reference lineage files
``car_params.hpp`` / ``scan_simulator_2d.cpp`` — mount was empty, values are
the well-known F1TENTH/MIT-racecar defaults recorded in SURVEY.md).

Design: frozen dataclasses registered as JAX pytrees whose leaves are Python
floats (weak-typed scalars). They are closed over at trace time, so every
parameter is a compile-time constant for XLA — no HBM traffic, full constant
folding — while still being overridable per-instantiation. Per-agent parameter
variation is supported by passing arrays for any field (broadcast against the
agent axis).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax


def _pytree_dataclass(cls):
    """Register a frozen dataclass as a JAX pytree node."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def flatten(obj):
        fields = [f.name for f in dataclasses.fields(obj)]
        return tuple(getattr(obj, n) for n in fields), tuple(fields)

    def unflatten(names, leaves):
        return cls(**dict(zip(names, leaves)))

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_pytree_dataclass
class CarParams:
    """Vehicle body / dynamics parameters.

    Mirrors the reference ``CarParams`` struct plus the actuator-limit fields
    the reference facade holds alongside it (SURVEY.md §2a). Defaults are the
    F1TENTH single-track values the reference lineage uses.
    """

    # Geometry
    wheelbase: Any = 0.3302        # l_f + l_r [m]
    width: Any = 0.2032            # car width [m]
    length: Any = 0.51             # car length [m] (bumper to bumper)
    l_f: Any = 0.15875             # CG -> front axle [m]
    l_r: Any = 0.17145             # CG -> rear axle [m]
    h_cg: Any = 0.074              # CG height [m]
    # Mass / inertia
    mass: Any = 3.47               # [kg]
    I_z: Any = 0.04712             # yaw moment of inertia [kg m^2]
    # Tire / friction (linear tire model, CommonRoad single-track)
    cs_f: Any = 4.718              # front cornering stiffness coeff [1/rad]
    cs_r: Any = 5.4562             # rear cornering stiffness coeff [1/rad]
    friction_coeff: Any = 0.523    # tire-road friction mu
    # Actuator limits
    max_speed: Any = 7.0           # [m/s]
    max_accel: Any = 7.51          # [m/s^2]
    max_decel: Any = 8.26          # [m/s^2]
    max_steer_angle: Any = 0.4189  # [rad]
    max_steer_vel: Any = 3.2       # [rad/s]
    # KS<->ST blending threshold (dynamic model falls back to kinematic
    # below this speed, where the slip-angle ODE is singular).
    v_switch: Any = 0.8            # [m/s]
    # Lidar mounting: distance from base_link (rear axle) to scanner origin.
    scan_distance_to_base_link: Any = 0.275  # [m]


@_pytree_dataclass
class ScanParams:
    """Lidar scan-simulation parameters.

    Mirrors the reference ``ScanSimulator2D`` constructor
    ``(num_beams, fov, scan_std_dev, ray_tracing_epsilon,
    theta_discretization)`` — SURVEY.md §2a "ScanSimulator2D".
    ``num_beams``/``theta_discretization``/``max_march_iters`` are static ints
    (shape-determining); the rest are scalars.
    """

    num_beams: Any = 1080            # beams per scan
    fov: Any = 4.712388980384690     # field of view [rad] (270 deg)
    scan_std_dev: Any = 0.01         # Gaussian range noise sigma [m]
    ray_tracing_epsilon: Any = 0.0001  # distance-transform hit threshold [m]
    theta_discretization: Any = 2000  # sin/cos table buckets (reference parity
    #                                  mode; exact trig is the default path)
    max_range: Any = 10.0            # range clamp [m]
    # Additions with no reference equivalent: static trip count for
    # the fixed-iteration sphere-trace and the EDF sampling mode.
    # Default covers exact parity on the builtin maps: worst case is
    # max_range/resolution = 10/0.05 = 200 steps (wall-grazing rays);
    # lower it for speed at documented accuracy cost (raymarch_xla doc).
    max_march_iters: Any = 200       # static march loop trip count
    use_theta_table: Any = False     # True = reference theta-bucket trig
    interp: Any = "nearest"          # "nearest" (reference parity) | "bilinear"
    #                                  (smooth, for pose/map gradients)


@_pytree_dataclass
class SimParams:
    """Top-level step parameters for the closed-loop simulator facade."""

    dt: Any = 0.01                  # physics timestep [s]
    ttc_threshold: Any = 0.01       # time-to-collision latch threshold [s]
    dynamics: Any = "st"            # "st" | "ks" | "ackermann"
    # Speed P-controller gain is the reference's 2*max_accel/max_speed
    # (SURVEY.md §2a "Input processing"); override here if desired.
    speed_kp: Any = None
    # Steering actuation: "bang" = the reference's bang-bang steering
    # velocity (sign(err)*max — its derivative w.r.t. the DESIRED steer
    # is zero a.e., so control/policy gradients through steering
    # vanish; measured round 5); "smooth" = clamped P-control
    # (clip(steer_kp*err, +-max_steer_vel)) — identical saturated
    # behavior away from the target, differentiable near it. Use
    # "smooth" for BPTT/policy training through steering.
    steer_mode: Any = "bang"
    steer_kp: Any = None            # default 2*max_steer_vel/max_steer_angle


# Static (non-traced) fields: these change compiled shapes or code paths, so
# facade code hashes them into jit static args rather than tracing them.
STATIC_SCAN_FIELDS = (
    "num_beams",
    "theta_discretization",
    "max_march_iters",
    "use_theta_table",
    "interp",
)
STATIC_SIM_FIELDS = ("dynamics", "steer_mode")


def replace(params, **kw):
    """dataclasses.replace that works on the registered pytree classes."""
    return dataclasses.replace(params, **kw)
