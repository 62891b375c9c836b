"""Device-mesh sharding for multi-chip / multi-host scaling.

The reference is single-process single-thread (SURVEY.md §2b: every row is
"reference: absent"). Scaling model:

  * ``agents`` mesh axis — data parallel: each device owns a slab of cars.
  * ``beams`` mesh axis — the scan's beam dimension is the framework's
    sequence axis (SURVEY.md §5 "long-context analogue"): each device
    computes a contiguous beam wedge of every owned agent's scan. Segment
    tables are replicated (they are small); rays never communicate during
    the sweep, so the only collectives are the reductions that *consume*
    scans (TTC any-beam, losses) and the gradient psum — exactly where XLA
    puts them.

Implementation style: ``shard_map`` with explicit PartitionSpecs so the
collective placement is visible and testable on a CPU fake mesh
(tests/test_sharding.py), per SURVEY.md §4 item 4.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.raymarch_xla import beam_angles
from ..ops.raycast_grad import raycast_all_diff
from ..models.ttc import check_ttc


def make_mesh(devices=None, agents_axis: Optional[int] = None,
              beams_axis: int = 1) -> Mesh:
    """Mesh over the given (default: all) devices.

    With ``agents_axis=None`` all devices not used by ``beams_axis`` go to
    the agents (DP) axis — the right default: beam sharding only pays off
    once per-device agent slabs get small.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % beams_axis:
        raise ValueError(f"{n} devices not divisible by beams_axis={beams_axis}")
    if agents_axis is None:
        agents_axis = n // beams_axis
    if agents_axis * beams_axis != n:
        raise ValueError(f"mesh {agents_axis}x{beams_axis} != {n} devices")
    arr = np.asarray(devices).reshape(agents_axis, beams_axis)
    return Mesh(arr, ("agents", "beams"))


# single definition of the block-width/coverage contract (shared with the
# unsharded scans — see its docstring)
from ..ops.raycast_sectors import sector_block_width as _sector_bb


def make_sharded_scan(mesh: Mesh, segments_or_map, num_beams: int,
                      fov: float, max_range: float = 10.0, kv: int = 0,
                      map_cell: Optional[dict] = None):
    """Build ``scan(poses) -> ranges`` sharded (agents, beams) on the mesh.

    ``segments_or_map``: either the dense (4, K) segment-params array or a
    ``maps.sectors.SectorSegmentMap`` — the sector-culled sweep runs
    unchanged inside each shard: it is pure XLA, and beam wedges are
    angle-contiguous so the per-block (tile, sector) routing stays local
    to the device.

    poses: (A, 3) sharded on 'agents'; returns (A, num_beams) sharded
    ('agents', 'beams'). Differentiable (analytic VJP inside each shard;
    pose cotangents are partial sums over the beam wedge, summed by XLA via
    psum on the 'beams' axis — the "gradient all-reduce" of BASELINE.json,
    here placed automatically by shard_map's reverse-mode transpose).

    The map rides through shard_map as a REPLICATED traced argument (read
    from ``map_cell["map"]`` at call time, like the facade's
    ``make_scan_fn``): closing over it instead embeds the table as a
    compile-time constant — a retrace on every obstacle swap, and a
    ~130 MB constant in the compiled program for berlin-class tables.
    """
    from jax import shard_map
    from ..maps.sectors import SectorSegmentMap
    from ..ops.common import apply_extent_mask

    nb_shards = mesh.shape["beams"]
    if num_beams % nb_shards:
        raise ValueError(f"num_beams={num_beams} not divisible by "
                         f"beams mesh axis {nb_shards}")
    offs_full = beam_angles(num_beams, fov)
    is_sector = isinstance(segments_or_map, SectorSegmentMap)
    if map_cell is None:
        map_cell = {"map": segments_or_map}
    if is_sector:
        bb = _sector_bb(segments_or_map, num_beams, fov)
        from ..ops.raycast_sectors import (raycast_sectors,
                                           resolve_sector_mode)
        sec_mode = resolve_sector_mode("auto")

    def shard_body(m, offs, poses):
        # poses: (A_loc, 3); offs: (B_loc,) this device's beam wedge
        x = poses[:, 0:1]
        y = poses[:, 1:2]
        b_loc = offs.shape[0]
        if is_sector:
            # pad the offset row to the block width up front — free, vs
            # real device-memory copies for six (A, B) arrays;
            # edge-replication matches ops.raycast_sectors._padded_offsets
            # (the sharded wedge length b_loc differs from num_beams, so
            # the pad is computed on the local slice)
            pad_l = (-b_loc) % bb
            if pad_l:
                offs = jnp.concatenate(
                    [offs, jnp.broadcast_to(offs[-1:], (pad_l,))])
        from ..ops.common import fan_cos_sin
        ct, st = fan_cos_sin(poses[:, 2], offs)
        xb = jnp.broadcast_to(x, ct.shape)
        yb = jnp.broadcast_to(y, ct.shape)
        if is_sector:
            r = raycast_sectors(
                m.table, m.meta, m.tiles_shape, m.tile_size,
                m.tile_origin, m.ns, m.kv_sec, poses[:, 0],
                poses[:, 1], xb, yb, ct, st, max_range, bb, 64,
                sec_mode)[:, :b_loc]
            return apply_extent_mask(r, poses[:, 0], poses[:, 1],
                                     m.extent, max_range)
        return raycast_all_diff(m, xb, yb, ct, st, max_range,
                                1024, kv)

    fn = shard_map(shard_body, mesh=mesh,
                   in_specs=(P(), P("beams"), P("agents", None)),
                   out_specs=P("agents", "beams"), check_vma=False)

    def scan(poses):
        return fn(map_cell["map"], offs_full, poses)

    return scan


def make_sharded_step(mesh: Mesh, bundle, with_noise: bool = False,
                      stack=None, map_cell: Optional[dict] = None):
    """Sharded full simulation step over (agents, beams).

    ``map_cell``: like ``make_scan_fn`` — the map pytree is read from
    ``map_cell["map"]`` at call time and traced in as a replicated
    argument, so swapping a same-shape rebuilt map (obstacle add/clear)
    does NOT retrace the sharded step.

    Dynamics and TTC run agent-parallel; the scan is beam-sharded; the TTC
    any-beam reduction crosses the beam axis with a psum inside shard_map.
    Returns ``step(state, action, key) -> StepOutput`` whose arrays carry
    NamedShardings (state/collision on 'agents', ranges on
    ('agents','beams')).

    ``stack``: a ``maps.sectors.StackedSectorMap`` switches the scan to
    MULTI-TRACK serving (BASELINE.json configs[4]: a 65k-agent fleet
    realistically trains across a track distribution): the step signature
    becomes ``step(state, action, map_ids, key=None)`` with ``map_ids``
    (A,) int32 sharded on 'agents', and agent i scans on
    ``stack`` map ``map_ids[i]`` via the fused stacked sweep
    (ops/raycast_sectors.stack_block_ids + raycast_sectors_ids — the same
    sweep as the unsharded ``scan_poses_sectors_multi``, so values are
    bit-identical to it; tests/test_sharding.py). ``bundle`` still
    supplies car/scan/sim params; its segmap is ignored.
    """
    from jax import shard_map
    from ..models import dynamics as dyn
    from ..models.ttc import ttc_tables
    from ..state import set_field
    from ..simulator import StepOutput
    from ..ops.noise import add_scan_noise

    car, sc, sim = bundle.car, bundle.scan, bundle.sim
    num_beams = int(sc.num_beams)
    from ..maps.contours import GeneralSegmentMap
    from ..maps.sectors import SectorSegmentMap
    is_stack = stack is not None
    is_general = is_sector = False
    seg_params = seg_kv = None
    if is_stack:
        from ..ops.raycast_sectors import (raycast_sectors_ids
                                           as _rc_sectors_ids,
                                           stack_block_ids
                                           as _stack_ids,
                                           resolve_sector_mode)
        bb = _sector_bb(stack, num_beams, float(sc.fov))
        sec_mode = resolve_sector_mode("auto")
    else:
        if bundle.segmap is None:
            raise ValueError("sharded step needs the segment backend")
        is_general = isinstance(bundle.segmap, GeneralSegmentMap)
        is_sector = isinstance(bundle.segmap, SectorSegmentMap)
        if is_general:
            from ..ops.raycast_general import raycast_general as _rc_general
        if is_sector:
            from ..ops.raycast_sectors import (raycast_sectors
                                               as _rc_sectors,
                                               resolve_sector_mode)
            smap = bundle.segmap
            bb = _sector_bb(smap, num_beams, float(sc.fov))
            sec_mode = resolve_sector_mode("auto")
        else:
            seg_params = bundle.segmap.params
            seg_kv = getattr(bundle.segmap, "kv", 0)
    nb_shards = mesh.shape["beams"]
    if num_beams % nb_shards:
        raise ValueError("num_beams must divide over the beams axis")
    offs_full = beam_angles(num_beams, float(sc.fov))
    cos_full, dist_full = ttc_tables(num_beams, float(sc.fov), car)

    from ..ops.common import fan_cos_sin, apply_extent_mask
    theta_disc = (int(sc.theta_discretization) if sc.use_theta_table else 0)
    # the map pytree (stack / sector map / segment map) rides through
    # shard_map as a REPLICATED traced argument, never a closure: a
    # closed-over table compiles in as a constant (retrace on obstacle
    # swap; see make_sharded_scan)
    if map_cell is None:
        map_cell = {"map": stack if is_stack else bundle.segmap}

    def shard_body(m, offs, cosines, car_dists, state, v_des, steer_des,
                   key, mid):
        # Everything here sees the LOCAL agent slab + local beam wedge.
        accel, steer_vel = dyn.process_input(
            v_des, steer_des, state, car, kp=sim.speed_kp,
            steer_mode=sim.steer_mode, steer_kp=sim.steer_kp)
        if sim.dynamics == "st":
            new = dyn.st_step(state, accel, steer_vel, car, sim.dt)
        elif sim.dynamics == "ks":
            new = dyn.ks_step(state, accel, steer_vel, car, sim.dt)
        elif sim.dynamics == "ackermann":
            new = dyn.ackermann_step(state, v_des, steer_des, car, sim.dt)
        else:
            raise ValueError(f"unknown dynamics {sim.dynamics!r}")
        new = dyn.apply_standstill(state, new)
        sx = new.x + car.scan_distance_to_base_link * jnp.cos(new.theta)
        sy = new.y + car.scan_distance_to_base_link * jnp.sin(new.theta)
        b_loc = offs.shape[0]
        offs_l = offs
        if is_sector or is_stack:
            # build the fan at the padded block width: padding the offset
            # row is free, padding six (A, B) arrays inside the raycast is
            # real device-memory traffic
            pad_l = (-b_loc) % bb
            if pad_l:
                offs_l = jnp.concatenate(
                    [offs, jnp.broadcast_to(offs[-1:], (pad_l,))])
        ct, st = fan_cos_sin(new.theta, offs_l, theta_disc)
        xb = jnp.broadcast_to(sx[:, None], ct.shape)
        yb = jnp.broadcast_to(sy[:, None], ct.shape)
        if is_stack:
            ids, inside = _stack_ids(m, mid, sx, sy, ct, st, b_loc, bb)
            a_loc = ct.shape[0]
            shp = (a_loc, ct.shape[1] // bb, bb)
            ranges = _rc_sectors_ids(
                m.table, m.meta, ids, m.kv_sec,
                xb.reshape(shp), yb.reshape(shp), ct.reshape(shp),
                st.reshape(shp), float(sc.max_range), 64,
                sec_mode)[:, :b_loc]
            ranges = jnp.where(inside[:, None], ranges,
                               float(sc.max_range))
        elif is_sector:
            ranges = _rc_sectors(
                m.table, m.meta, m.tiles_shape, m.tile_size,
                m.tile_origin, m.ns, m.kv_sec, sx, sy,
                xb, yb, ct, st, float(sc.max_range), bb, 64,
                sec_mode)[:, :b_loc]
        elif is_general:
            ranges = _rc_general(m.params, xb, yb, ct, st,
                                 float(sc.max_range))
        else:
            ranges = raycast_all_diff(m.params, xb, yb, ct, st,
                                      float(sc.max_range), 1024, seg_kv)
        if not is_stack:
            ranges = apply_extent_mask(ranges, sx, sy, m.extent,
                                       float(sc.max_range))
        if with_noise and key is not None:
            kl = jax.random.fold_in(key, jax.lax.axis_index("beams")
                                    + nb_shards
                                    * jax.lax.axis_index("agents"))
            ranges = add_scan_noise(ranges, kl, sc.scan_std_dev)
        # local any-beam TTC, then OR across beam shards (psum of bools)
        hit_local = check_ttc(ranges, new.velocity, cosines, car_dists,
                              sim.ttc_threshold)
        hit = jax.lax.psum(hit_local.astype(jnp.int32), "beams") > 0
        latched = new.collision | hit
        out_state = set_field(
            new,
            velocity=jnp.where(latched, 0.0, new.velocity),
            steer_angle=jnp.where(latched, 0.0, new.steer_angle),
            angular_velocity=jnp.where(latched, 0.0,
                                       new.angular_velocity),
            slip_angle=jnp.where(latched, 0.0, new.slip_angle),
            collision=latched)
        return StepOutput(ranges=ranges, collision=latched,
                          state=out_state)

    state_spec = P("agents")
    fn = shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(), P("beams"), P("beams"), P("beams"), state_spec,
                  P("agents"), P("agents"), P(), P("agents")),
        out_specs=StepOutput(ranges=P("agents", "beams"),
                             collision=state_spec,
                             state=jax.tree.map(lambda _: state_spec,
                                                _state_proto())),
        check_vma=False)

    if is_stack:
        @jax.jit
        def _step(m, state, action, map_ids, key):
            v_des, steer_des = action
            if key is None:
                key = jax.random.PRNGKey(0)
            return fn(m, offs_full, cos_full, dist_full, state, v_des,
                      steer_des, key, jnp.asarray(map_ids, jnp.int32))

        def step(state, action, map_ids, key=None):
            return _step(map_cell["map"], state, action, map_ids, key)
        step.jitted = _step          # retrace introspection (tests)
        return step

    @jax.jit
    def _step(m, state, action, key):
        v_des, steer_des = action
        if key is None:
            key = jax.random.PRNGKey(0)
        # the mid arg only routes the stacked path; a zeros placeholder
        # keeps ONE shard_body signature for both modes
        return fn(m, offs_full, cos_full, dist_full, state, v_des,
                  steer_des, key, jnp.zeros(jnp.shape(state.x), jnp.int32))

    def step(state, action, key=None):
        return _step(map_cell["map"], state, action, key)

    step.jitted = _step              # retrace introspection (tests)
    return step


def _state_proto():
    from ..state import zero_state
    return zero_state(())


def shard_state(mesh: Mesh, state):
    """Place a CarState on the mesh's agents axis."""
    sh = NamedSharding(mesh, P("agents"))
    return jax.tree.map(lambda a: jax.device_put(a, sh), state)
