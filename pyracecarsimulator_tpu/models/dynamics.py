"""Pure-JAX vehicle dynamics: Ackermann / KS / ST single-track models.

Equivalents of the reference's native dynamics tier (SURVEY.md §2a rows
"Ackermann/KS/ST kinematics", "Input processing"; §2c item 4: element-wise
math that XLA fuses into the step — no hand-written kernel needed).
Every function is pure, shape-polymorphic (works on scalars or any batch
shape), jit/vmap/grad-compatible, and branchless: the reference's
``if |v| < v_switch`` becomes ``jnp.where`` so the whole agent batch steps
in lockstep on the device.

Parity: matches ``oracle/dynamics.py`` to float32 tolerance
(tests/test_dynamics.py), which in turn encodes the reference semantics.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import CarParams
from ..state import CarState

G = 9.81


def compute_accel(v_des, v, p: CarParams, kp=None):
    """Speed P-control with asymmetric accel/decel clamps (reference facade
    ``compute_accel``: kp = 2*max_accel/max_speed; override via
    SimParams.speed_kp)."""
    if kp is None:
        kp = 2.0 * p.max_accel / p.max_speed
    a = kp * (v_des - v)
    # Forward motion: brake limit max_decel, throttle limit max_accel;
    # mirrored in reverse; at standstill symmetric max_accel.
    lo = jnp.where(v > 0, -p.max_decel, -p.max_accel)
    hi = jnp.where(v < 0, p.max_decel, p.max_accel)
    return jnp.clip(a, lo, hi)


def compute_steer_vel(steer_des, steer, p: CarParams,
                      mode: str = "bang", kp=None):
    """Steering velocity toward the desired angle.

    ``mode="bang"`` is the reference's bang-bang law (sign(err)*max) —
    NOTE its derivative w.r.t. ``steer_des`` is zero a.e., so policy/
    control gradients through steering vanish (measured round 5; use
    the smooth mode for BPTT). ``mode="smooth"`` is clamped P-control:
    identical saturated behavior for |err| >= max_vel/kp,
    differentiable inside. ``kp`` defaults to
    2*max_steer_vel/max_steer_angle (saturates at half the steering
    range)."""
    if mode not in ("bang", "smooth"):
        raise ValueError(
            f"steer_mode must be 'bang' or 'smooth' (got {mode!r}) — a "
            "typo here would silently reproduce the zero-gradient "
            "bang-bang training failure")
    dif = steer_des - steer
    if mode == "smooth":
        if kp is None:
            kp = 2.0 * p.max_steer_vel / p.max_steer_angle
        return jnp.clip(kp * dif, -p.max_steer_vel, p.max_steer_vel)
    return jnp.where(jnp.abs(dif) > 1e-4,
                     jnp.sign(dif) * p.max_steer_vel, 0.0)


def process_input(v_des, steer_des, state: CarState, p: CarParams,
                  kp=None, steer_mode: str = "bang", steer_kp=None):
    """Desired (speed, steer) -> clamped (accel, steer_vel).

    Desired values are themselves clamped to actuator ranges first, as the
    reference facade does on ``drive()``. ``kp`` overrides the speed
    P-gain (SimParams.speed_kp); ``steer_mode``/``steer_kp`` select the
    steering law (SimParams.steer_mode — "smooth" for differentiable
    steering, see compute_steer_vel).
    """
    v_des = jnp.clip(v_des, -p.max_speed, p.max_speed)
    steer_des = jnp.clip(steer_des, -p.max_steer_angle, p.max_steer_angle)
    accel = compute_accel(v_des, state.velocity, p, kp)
    steer_vel = compute_steer_vel(steer_des, state.steer_angle, p,
                                  steer_mode, steer_kp)
    return accel, steer_vel


def _clamped_kinematics(state: CarState, accel, steer_vel, p: CarParams, dt):
    """Shared velocity/steer integration with hard actuator limits."""
    v = jnp.clip(state.velocity + accel * dt, -p.max_speed, p.max_speed)
    st = jnp.clip(state.steer_angle + steer_vel * dt,
                  -p.max_steer_angle, p.max_steer_angle)
    return v, st


def ackermann_step(state: CarState, speed, steer, p: CarParams, dt
                   ) -> CarState:
    """Direct kinematic update: inputs are (speed, steer), not (accel, sv)."""
    speed = jnp.clip(speed, -p.max_speed, p.max_speed)
    steer = jnp.clip(steer, -p.max_steer_angle, p.max_steer_angle)
    thd = speed * jnp.tan(steer) / p.wheelbase
    return CarState(
        x=state.x + speed * jnp.cos(state.theta) * dt,
        y=state.y + speed * jnp.sin(state.theta) * dt,
        theta=state.theta + thd * dt,
        velocity=speed * jnp.ones_like(state.velocity),
        steer_angle=steer * jnp.ones_like(state.steer_angle),
        angular_velocity=thd * jnp.ones_like(state.angular_velocity),
        slip_angle=jnp.zeros_like(state.slip_angle),
        st_dyn=jnp.zeros_like(state.st_dyn),
        collision=state.collision,
    )


def ks_step(state: CarState, accel, steer_vel, p: CarParams, dt) -> CarState:
    """Kinematic single-track Euler step."""
    v, st = state.velocity, state.steer_angle
    return CarState(
        x=state.x + v * jnp.cos(state.theta) * dt,
        y=state.y + v * jnp.sin(state.theta) * dt,
        theta=state.theta + (v / p.wheelbase) * jnp.tan(st) * dt,
        velocity=v + accel * dt,
        steer_angle=st + steer_vel * dt,
        angular_velocity=jnp.zeros_like(state.angular_velocity),
        slip_angle=jnp.zeros_like(state.slip_angle),
        st_dyn=jnp.zeros_like(state.st_dyn),
        collision=state.collision,
    )


def st_step(state: CarState, accel, steer_vel, p: CarParams, dt) -> CarState:
    """Dynamic single-track step, branchless low-speed KS fallback.

    The ST slip/yaw ODEs divide by v; the computation is guarded with a
    safe denominator and the result discarded by ``jnp.where`` below
    ``v_switch``, exactly reproducing the reference's branchy semantics
    while keeping one fused vector program.
    """
    x, y, th = state.x, state.y, state.theta
    v, st = state.velocity, state.steer_angle
    w, beta = state.angular_velocity, state.slip_angle
    lf, lr = p.l_f, p.l_r
    lwb = lf + lr
    mu, m, Iz, h = p.friction_coeff, p.mass, p.I_z, p.h_cg
    csf, csr = p.cs_f, p.cs_r
    a = accel

    # --- kinematic branch ---
    th_d_ks = (v / lwb) * jnp.tan(st)
    v_ks = v + a * dt
    st_ks = st + steer_vel * dt
    ks = dict(
        x=x + v * jnp.cos(th) * dt,
        y=y + v * jnp.sin(th) * dt,
        theta=th + th_d_ks * dt,
        velocity=v_ks,
        steer_angle=st_ks,
        angular_velocity=(v_ks / lwb) * jnp.tan(st_ks),
        slip_angle=jnp.arctan(jnp.tan(st_ks) * lr / lwb),
    )

    # --- dynamic branch (safe divide; branch is discarded below v_switch,
    # the guard only prevents NaN poisoning the where) ---
    v_safe = jnp.where(jnp.abs(v) < 1e-3, 1e-3, v)
    rear = G * lr - a * h   # front-axle load factor
    front = G * lf + a * h  # rear-axle load factor
    w_dot = (mu * m / (Iz * lwb)) * (
        lf * csf * rear * st
        + (lr * csr * front - lf * csf * rear) * beta
        - (lf * lf * csf * rear + lr * lr * csr * front) * (w / v_safe))
    beta_dot = (mu / (v_safe * lwb)) * (
        csf * rear * st
        - (csr * front + csf * rear) * beta
        + (csr * front * lr - csf * rear * lf) * (w / v_safe)) - w
    dyn = dict(
        x=x + v * jnp.cos(th + beta) * dt,
        y=y + v * jnp.sin(th + beta) * dt,
        theta=th + w * dt,
        velocity=v + a * dt,
        steer_angle=st + steer_vel * dt,
        angular_velocity=w + w_dot * dt,
        slip_angle=beta + beta_dot * dt,
    )

    use_dyn = jnp.abs(v) >= p.v_switch
    out = {k: jnp.where(use_dyn, dyn[k], ks[k]) for k in dyn}
    return CarState(st_dyn=use_dyn, collision=state.collision, **out)


def apply_standstill(prev: CarState, new: CarState) -> CarState:
    """Collision latch: a latched car does not move (reference ``stop()`` +
    early-return, SURVEY.md §2a "TTC collision check")."""
    frozen = CarState(
        x=prev.x, y=prev.y, theta=prev.theta,
        velocity=jnp.zeros_like(prev.velocity),
        steer_angle=jnp.zeros_like(prev.steer_angle),
        angular_velocity=jnp.zeros_like(prev.angular_velocity),
        slip_angle=jnp.zeros_like(prev.slip_angle),
        st_dyn=jnp.zeros_like(prev.st_dyn),
        collision=prev.collision,
    )
    c = prev.collision
    pick = lambda a, b: jnp.where(c, a, b)
    return CarState(
        x=pick(frozen.x, new.x), y=pick(frozen.y, new.y),
        theta=pick(frozen.theta, new.theta),
        velocity=pick(frozen.velocity, new.velocity),
        steer_angle=pick(frozen.steer_angle, new.steer_angle),
        angular_velocity=pick(frozen.angular_velocity, new.angular_velocity),
        slip_angle=pick(frozen.slip_angle, new.slip_angle),
        st_dyn=jnp.where(c, frozen.st_dyn, new.st_dyn),
        collision=new.collision | c,
    )
