"""Simulation state pytrees (struct-of-arrays).

Reference parity: the reference keeps one ``CarState{x, y, theta, velocity,
steer_angle, angular_velocity, slip_angle, st_dyn}`` struct per simulator
instance (SURVEY.md §2a "Pose / state structs"; lineage file
``car_state.hpp``). The design here is struct-of-arrays: every field is
a ``(...)``-batched jnp array so that ``vmap``/sharding over an agent axis is
the natural layout, and the whole state is a pytree usable with ``lax.scan``,
``jax.grad``, orbax checkpointing, and ``shard_map`` out of the box.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


def _pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)

    def flatten(obj):
        fields = [f.name for f in dataclasses.fields(obj)]
        return tuple(getattr(obj, n) for n in fields), tuple(fields)

    def unflatten(names, leaves):
        return cls(**dict(zip(names, leaves)))

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_pytree_dataclass
class CarState:
    """Full vehicle state. All fields share a common batch shape.

    ``collision`` is the standstill latch: once a TTC check trips, the car is
    stopped and stays stopped until the latch is cleared (reference ``stop()``
    + ``in_collision`` behavior, SURVEY.md §2a "TTC collision check").
    """

    x: Any                 # world x [m]
    y: Any                 # world y [m]
    theta: Any             # heading [rad]
    velocity: Any          # longitudinal speed [m/s]
    steer_angle: Any       # front wheel steering angle [rad]
    angular_velocity: Any  # yaw rate [rad/s]
    slip_angle: Any        # slip angle beta [rad]
    st_dyn: Any            # bool: last step used the dynamic (ST) branch
    collision: Any         # bool: standstill latch

    @property
    def batch_shape(self):
        return jnp.shape(self.x)

    @property
    def pose(self):
        """(..., 3) array of (x, y, theta) — the scan query pose."""
        return jnp.stack([self.x, self.y, self.theta], axis=-1)


def zero_state(batch_shape=(), dtype=jnp.float32) -> CarState:
    """All-zero state (reference initial condition: zeros, no collision)."""
    z = jnp.zeros(batch_shape, dtype)
    f = jnp.zeros(batch_shape, bool)
    return CarState(
        x=z, y=z, theta=z, velocity=z, steer_angle=z,
        angular_velocity=z, slip_angle=z, st_dyn=f, collision=f,
    )


def state_from_pose(x, y, theta) -> CarState:
    """State at a given pose with zero velocity (reference set-pose path)."""
    x = jnp.asarray(x, jnp.float32)
    z = jnp.zeros_like(x)
    f = jnp.zeros(jnp.shape(x), bool)
    return CarState(
        x=x, y=jnp.broadcast_to(jnp.asarray(y, jnp.float32), x.shape),
        theta=jnp.broadcast_to(jnp.asarray(theta, jnp.float32), x.shape),
        velocity=z, steer_angle=z, angular_velocity=z, slip_angle=z,
        st_dyn=f, collision=f,
    )


def set_field(state: CarState, **kw) -> CarState:
    return dataclasses.replace(state, **kw)
