"""Simulator facade: functional core + reference-style OO wrapper.

Reference parity: the ``RacecarSimulator`` class mirrors the reference
facade's surface (SURVEY.md §1 L4 / §2a "Simulator facade": ``drive``,
``update_pose``, ``run_scan``, ``check_collision``, ``get_state`` /
``set_state``, ``set_pose``, ``add_obstacle`` / ``clear_obstacles``,
``stop``), orchestrating input processing -> dynamics -> scan -> TTC
(§3.2 call stack).

Design: the real API is the *functional core* — ``make_step_fn``
returns one pure, jit-compiled function fusing the whole §3.2 step for an
arbitrary agent batch; the OO wrapper is a thin convenience holding
(state, key) and calling it. Rollouts should use ``parallel.rollout`` which
``lax.scan``s the same step function on device (the reference's per-step
Python->Cython crossing, its throughput ceiling per SURVEY.md §3.5, has no
equivalent here).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .config import CarParams, ScanParams, SimParams
from .state import CarState, zero_state, state_from_pose, set_field
from .models import dynamics as dyn
from .models.ttc import ttc_tables, check_ttc
from .maps.loader import TrackMap, load_builtin, add_obstacle as _add_obs
from .maps.segments import SegmentMap, build_segment_map
from .maps.contours import build_general_segment_map
from .maps.sectors import SectorSegmentMap, build_sector_map
from .ops.raymarch_xla import scan_poses as _scan_edf
from .ops.raycast_segments import scan_poses_segments as _scan_segments
from .ops.raycast_sectors import scan_poses_sectors as _scan_sectors
from .ops.noise import add_scan_noise

# backends whose map object is a compiled segment table (vs the EDF track)
_SEGMENT_BACKENDS = ("segments", "segments_simplified", "sectors")


def _check_backend(backend: str) -> None:
    if backend == "segments_pallas":
        raise ValueError(
            "backend 'segments_pallas' ran a Pallas kernel that has been "
            "removed; use 'sectors' (same exact-boundary values) or 'auto'")



class StepOutput(NamedTuple):
    """Observation bundle from one simulation step."""

    ranges: Any        # (..., num_beams) lidar ranges [m]
    collision: Any     # (...,) bool — latched collision flag
    state: Any         # CarState after the step


class SimBundle(NamedTuple):
    """Everything a compiled step closes over (all pytrees/constants)."""

    track: TrackMap
    segmap: Optional[SegmentMap]
    car: CarParams
    scan: ScanParams
    sim: SimParams
    backend: str = "segments"   # resolved backend ("auto" never stored)


def build_sim(track_or_name, car: CarParams = None, scan: ScanParams = None,
              sim: SimParams = None, backend: str = "segments",
              tile_size: Optional[float] = None,
              sector_ns: int = 16, sector_headroom: int = 0) -> SimBundle:
    """Load/accept a map and precompute everything the step needs.

    backend: "sectors" (per-(tile, angular-sector) culled exact-boundary
    geometry), "auto" (alias for "sectors"), "segments" (dense exact
    geometry, no angular culling), "segments_simplified"
    (contour-simplified geometry: ~1-cell tolerance), "edf"
    (reference-exact DT march), "edf_bilinear" (smooth DT march for map
    gradients, exact autodiff), "edf_implicit" (fast differentiable
    march: nearest-rule hits + implicit-function VJP with the map
    cotangent). Speeds on the card: not measured yet.

    tile_size: culling tile edge in meters; None = per-backend default
    (4.0 for the tiled dense sweeps, 2.0 for the sector backend whose
    parallax pad shrinks with the tile).
    """
    _check_backend(backend)
    track = (load_builtin(track_or_name)
             if isinstance(track_or_name, str) else track_or_name)
    car = car or CarParams()
    scan = scan or ScanParams()
    sim = sim or SimParams()
    if backend == "auto":
        backend = "sectors"
    segmap = None
    if backend == "segments":
        segmap = build_segment_map(
            np.asarray(track.occupancy), track.resolution,
            (track.origin_x, track.origin_y),
            max_range=float(scan.max_range),
            tile_size=tile_size if tile_size is not None else 4.0,
            real_hw=(track.height, track.width))
    elif backend == "segments_simplified":
        segmap = build_general_segment_map(
            np.asarray(track.occupancy), track.resolution,
            (track.origin_x, track.origin_y),
            max_range=float(scan.max_range),
            tile_size=tile_size if tile_size is not None else 4.0,
            real_hw=(track.height, track.width))
    elif backend == "sectors":
        segmap = build_sector_map(
            np.asarray(track.occupancy), track.resolution,
            (track.origin_x, track.origin_y),
            max_range=float(scan.max_range),
            tile_size=tile_size if tile_size is not None else 2.0,
            ns=sector_ns, headroom=sector_headroom,
            real_hw=(track.height, track.width))
    return SimBundle(track=track, segmap=segmap, car=car, scan=scan,
                     sim=sim, backend=backend)


def make_scan_fn(bundle: SimBundle, backend: Optional[str] = None,
                 map_cell: Optional[dict] = None,
                 map_grad: bool = False,
                 agent_chunk: Optional[int] = None) -> Callable[[Any], Any]:
    """Returns ``scan(poses) -> ranges`` for poses (..., 3), noiseless.

    ``backend=None`` uses the backend the bundle was built with (the
    recommended way; build_sim resolves "auto" per map).

    ``agent_chunk`` (sector backend): agents per sequential execution
    chunk for very large single-device batches — ``None`` auto-derives
    from the table capacity so the pre-gathered cull working set stays
    bounded (the 32k/65k configs), ``0`` disables chunking. Values
    are identical either way (ops/raycast_sectors.scan_poses_sectors).

    The map (segment table / EDF) is read from ``map_cell["map"]`` at call
    time and passed into the compiled function as a *traced argument*:
    swapping in a rebuilt map of the same padded shape (the obstacle
    add/clear path, SURVEY.md §3.4) does NOT retrigger compilation.

    ``map_grad=True`` (sector backend only) returns
    ``scan(poses, edf) -> ranges`` instead: the production ∂range/∂map
    path — bit-identical forward values, and ``jax.grad`` w.r.t. the
    ``edf`` argument yields the implicit-function map cotangent at each
    hit (ops/raycast_sectors.scan_poses_sectors_mapgrad). Pass
    ``bundle.track.edf`` (or any EDF of the same boundary, e.g. a map
    estimate being optimized). The ``edf_bilinear``/``edf_implicit``
    backends don't need this flag — their scans are differentiable in the
    map by construction.
    """
    if backend is None:
        backend = bundle.backend
    _check_backend(backend)
    sc = bundle.scan
    theta_disc = sc.theta_discretization if sc.use_theta_table else 0
    if map_grad:
        if backend != "sectors":
            raise ValueError(
                "map_grad=True is the sector backend's hybrid path; "
                f"backend={backend!r} either cannot attach the IFT map "
                "cotangent or (edf_bilinear/edf_implicit) is already "
                "differentiable in the map")
        if bundle.segmap is None or not isinstance(bundle.segmap,
                                                   SectorSegmentMap):
            raise ValueError("bundle was not built with the sector backend")
        from .ops.raycast_sectors import scan_poses_sectors_mapgrad
        if map_cell is None:
            map_cell = {"map": bundle.segmap}
        track = bundle.track
        org = jnp.asarray((track.origin_x, track.origin_y), jnp.float32)
        bounds = (track.height, track.width)

        def scan_fn(poses, edf):
            return scan_poses_sectors_mapgrad(
                map_cell["map"], edf, track.resolution, org, poses,
                num_beams=sc.num_beams, fov=sc.fov,
                max_range=sc.max_range,
                theta_discretization=theta_disc,
                eps=sc.ray_tracing_epsilon, bounds_hw=bounds)
        return scan_fn
    if backend in _SEGMENT_BACKENDS:
        if bundle.segmap is None:
            raise ValueError("bundle built without segment backend")
        if map_cell is None:
            map_cell = {"map": bundle.segmap}
        from .maps.contours import GeneralSegmentMap
        if backend == "sectors" or isinstance(bundle.segmap,
                                              SectorSegmentMap):
            if not (backend == "sectors"
                    and isinstance(bundle.segmap, SectorSegmentMap)):
                raise ValueError(
                    f"backend={backend!r} does not match the bundle's map "
                    f"type {type(bundle.segmap).__name__}; build the bundle "
                    "with build_sim(backend='sectors') to use the sector "
                    "backend (or 'auto' to dispatch per map)")

            def scan_fn(poses):
                return _scan_sectors(
                    map_cell["map"], poses, num_beams=sc.num_beams,
                    fov=sc.fov, max_range=sc.max_range,
                    theta_discretization=theta_disc,
                    agent_chunk=agent_chunk)
            return scan_fn
        if isinstance(bundle.segmap, GeneralSegmentMap):
            from .ops.raycast_general import scan_poses_general

            def scan_fn(poses):
                return scan_poses_general(
                    map_cell["map"], poses, num_beams=sc.num_beams,
                    fov=sc.fov, max_range=sc.max_range,
                    theta_discretization=theta_disc)
            return scan_fn

        def scan_fn(poses):
            return _scan_segments(
                map_cell["map"], poses, num_beams=sc.num_beams, fov=sc.fov,
                max_range=sc.max_range, theta_discretization=theta_disc)
        return scan_fn

    interp = "bilinear" if backend == "edf_bilinear" else sc.interp
    if map_cell is None:
        map_cell = {"map": bundle.track}
    track = bundle.track
    org = jnp.asarray((track.origin_x, track.origin_y), jnp.float32)
    bounds = (track.height, track.width)

    if backend == "edf_implicit":
        # fast differentiable march: nearest-rule hits, implicit-function
        # VJP incl. the map cotangent (ops/raymarch_diff.py)
        from .ops.raymarch_diff import scan_poses_implicit

        def scan_fn(poses):
            return scan_poses_implicit(
                map_cell["map"].edf, track.resolution, org, poses,
                num_beams=sc.num_beams, fov=sc.fov,
                max_range=sc.max_range, eps=sc.ray_tracing_epsilon,
                max_iters=sc.max_march_iters,
                theta_discretization=theta_disc, bounds_hw=bounds)
        return scan_fn

    def scan_fn(poses):
        return _scan_edf(
            map_cell["map"].edf, track.resolution, org, poses,
            num_beams=sc.num_beams, fov=sc.fov, max_range=sc.max_range,
            eps=sc.ray_tracing_epsilon, max_iters=sc.max_march_iters,
            interp=interp, theta_discretization=theta_disc,
            bounds_hw=bounds)
    return scan_fn


def make_step_fn(bundle: SimBundle, backend: Optional[str] = None,
                 with_noise: bool = True,
                 agent_chunk: Optional[int] = None) -> Callable:
    """Build the fused simulation step (reference §3.2, one XLA program).

    ``backend=None`` uses the backend the bundle was built with.
    ``agent_chunk`` is forwarded to the scan (see ``make_scan_fn``).

    Returns ``step(state, action, key=None) -> StepOutput`` where action is
    ``(v_des, steer_des)`` with shapes broadcastable to the state batch.
    The returned function is jit-compiled; vmap/shard over the batch axis is
    implicit (everything is written batched).
    """
    if backend is None:
        backend = bundle.backend
    map_cell = {"map": (bundle.segmap
                        if backend in _SEGMENT_BACKENDS
                        else bundle.track)}
    inner_cell = {"map": None}
    scan_fn = make_scan_fn(bundle, backend, inner_cell,
                           agent_chunk=agent_chunk)
    car, sc, sim = bundle.car, bundle.scan, bundle.sim
    cosines, car_dists = ttc_tables(sc.num_beams, sc.fov, car)
    dynamics = sim.dynamics

    @jax.jit
    def _step(map_obj, state: CarState, action, key=None) -> StepOutput:
        # route the traced map object to scan_fn through the inner cell
        inner_cell["map"] = map_obj
        v_des, steer_des = action
        # 1. input processing (reference drive() + compute_accel)
        accel, steer_vel = dyn.process_input(
            v_des, steer_des, state, car, kp=sim.speed_kp,
            steer_mode=sim.steer_mode, steer_kp=sim.steer_kp)
        # 2. dynamics update (reference update_pose())
        if dynamics == "st":
            new = dyn.st_step(state, accel, steer_vel, car, sim.dt)
        elif dynamics == "ks":
            new = dyn.ks_step(state, accel, steer_vel, car, sim.dt)
        elif dynamics == "ackermann":
            new = dyn.ackermann_step(state, v_des, steer_des, car, sim.dt)
        else:
            raise ValueError(f"unknown dynamics {dynamics!r}")
        new = dyn.apply_standstill(state, new)
        # 3. scan from the lidar origin (scan_distance_to_base_link ahead)
        sx = new.x + car.scan_distance_to_base_link * jnp.cos(new.theta)
        sy = new.y + car.scan_distance_to_base_link * jnp.sin(new.theta)
        poses = jnp.stack([sx, sy, new.theta], axis=-1)
        ranges = scan_fn(poses)
        if with_noise and key is not None:
            # unclamped, matching the reference/oracle noise model
            ranges = add_scan_noise(ranges, key, sc.scan_std_dev)
        # 4. TTC collision -> latch (reference checkCollision + stop())
        hit = check_ttc(ranges, new.velocity, cosines, car_dists,
                        sim.ttc_threshold)
        latched = new.collision | hit
        out_state = set_field(
            new,
            velocity=jnp.where(latched, 0.0, new.velocity),
            steer_angle=jnp.where(latched, 0.0, new.steer_angle),
            angular_velocity=jnp.where(latched, 0.0, new.angular_velocity),
            slip_angle=jnp.where(latched, 0.0, new.slip_angle),
            collision=latched)
        return StepOutput(ranges=ranges, collision=latched, state=out_state)

    def step(state, action, key=None):
        return _step(map_cell["map"], state, action, key)

    step.map_cell = map_cell        # facade swaps maps here (no retrace)
    step.jitted = _step             # exposed for cache introspection/tests
    return step


class RacecarSimulator:
    """Reference-style OO facade over the functional core.

    Mirrors the reference simulator's method surface (SURVEY.md §1 L4) for
    drop-in familiarity; state lives in ``self.state`` as a CarState pytree
    with an arbitrary agent batch shape.
    """

    def __init__(self, track_or_name="levine", car_params: CarParams = None,
                 scan_params: ScanParams = None, sim_params: SimParams = None,
                 backend: str = "segments", batch_shape=(), seed: int = 0,
                 with_noise: bool = True):
        # sector_headroom: interactive use adds/clears obstacles — slack
        # in the cull-list capacity keeps those rebuilds shape-stable
        # (no retrace); build_sim defaults stay tight for benchmarks.
        self.bundle = build_sim(track_or_name, car_params, scan_params,
                                sim_params, backend=backend,
                                sector_headroom=8)
        self._pristine_track = self.bundle.track
        self._pristine_segmap = self.bundle.segmap   # clear = swap, no rebuild
        self.backend = self.bundle.backend     # "auto" resolved per map
        self.with_noise = with_noise
        self.batch_shape = tuple(batch_shape)
        self._rebuild()
        self.state = zero_state(self.batch_shape)
        self.key = jax.random.PRNGKey(seed)
        z = jnp.zeros(self.batch_shape)
        self._action = (z, z)
        self._last: Optional[StepOutput] = None

    # -- internal ---------------------------------------------------------
    def _current_map(self):
        return (self.bundle.segmap
                if self.backend in _SEGMENT_BACKENDS
                else self.bundle.track)

    def _rebuild(self):
        self._step = make_step_fn(self.bundle, self.backend, self.with_noise)
        self._scan_cell = {"map": self._current_map()}
        self._scan = make_scan_fn(self.bundle, self.backend,
                                  self._scan_cell)

    def _swap_or_rebuild(self):
        """After a map mutation: if the rebuilt map has identical pytree
        structure + leaf shapes, swap it into the compiled functions (no
        retrace); otherwise rebuild the jitted closures."""
        new = self._current_map()
        old = self._step.map_cell["map"]

        def sig(m):
            leaves, treedef = jax.tree_util.tree_flatten(m)
            return treedef, tuple(jnp.shape(l) for l in leaves)

        if sig(new) == sig(old):
            self._step.map_cell["map"] = new
            self._scan_cell["map"] = new
        else:
            self._rebuild()

    def _split(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    # -- reference API ----------------------------------------------------
    def drive(self, desired_speed, desired_steer):
        """Set the drive command (reference ``drive``/``setInput``)."""
        b = lambda v: jnp.broadcast_to(jnp.asarray(v, jnp.float32),
                                       self.batch_shape)
        self._action = (b(desired_speed), b(desired_steer))

    def update_pose(self):
        """Advance one dt: dynamics + scan + TTC (reference updatePose)."""
        out = self._step(self.state, self._action,
                         self._split() if self.with_noise else None)
        self.state = out.state
        self._last = out
        return out

    step = update_pose

    def run_scan(self):
        """Scan at the current pose without stepping (reference runScan)."""
        car = self.bundle.car
        sx = self.state.x + car.scan_distance_to_base_link * jnp.cos(self.state.theta)
        sy = self.state.y + car.scan_distance_to_base_link * jnp.sin(self.state.theta)
        poses = jnp.stack([sx, sy, self.state.theta], axis=-1)
        r = self._scan(poses)
        if self.with_noise:
            r = add_scan_noise(r, self._split(),
                               self.bundle.scan.scan_std_dev)
        return r

    get_scan = run_scan

    def check_collision(self):
        """Latched collision flag(s) (reference checkCollision)."""
        if self._last is None:
            return self.state.collision
        return self._last.collision

    def stop(self):
        """Zero motion state, keep pose (reference stop())."""
        z = jnp.zeros(self.batch_shape)
        self.state = set_field(self.state, velocity=z, steer_angle=z,
                               angular_velocity=z, slip_angle=z)
        self._action = (z, z)
        self._last = None

    def set_pose(self, x, y, theta=0.0):
        """Teleport + clear motion and the collision latch (reference
        set-pose; also clears the latch as upstream does on repose)."""
        b = lambda v: jnp.broadcast_to(jnp.asarray(v, jnp.float32),
                                       self.batch_shape)
        self.state = state_from_pose(b(x), b(y), b(theta))
        self._last = None            # stale scan/collision is gone

    reset = set_pose

    def get_state(self) -> CarState:
        return self.state

    def set_state(self, state: CarState):
        self.state = state
        self._last = None

    def _build_segmap(self, track):
        if self.backend not in _SEGMENT_BACKENDS:
            return None
        old = self.bundle.segmap
        if self.backend == "sectors":
            # carry the previous capacity split so the rebuilt table keeps
            # identical leaf shapes whenever it fits (no retrace on
            # obstacle add/clear); _swap_or_rebuild handles overflow by
            # rebuilding the closures after an auto-sized retry.
            try:
                return build_sector_map(
                    np.asarray(track.occupancy), track.resolution,
                    (track.origin_x, track.origin_y),
                    max_range=float(self.bundle.scan.max_range),
                    tile_size=old.tile_size, ns=old.ns,
                    block_half=old.block_half,
                    kvh=(old.kv_sec, old.table.shape[2] - old.kv_sec),
                    real_hw=(track.height, track.width))
            except ValueError:      # capacity overflow: auto-size instead
                return build_sector_map(
                    np.asarray(track.occupancy), track.resolution,
                    (track.origin_x, track.origin_y),
                    max_range=float(self.bundle.scan.max_range),
                    tile_size=old.tile_size, ns=old.ns,
                    block_half=old.block_half,
                    real_hw=(track.height, track.width))
        builder = (build_general_segment_map
                   if self.backend == "segments_simplified"
                   else build_segment_map)
        return builder(
            np.asarray(track.occupancy), track.resolution,
            (track.origin_x, track.origin_y),
            max_range=float(self.bundle.scan.max_range),
            tile_size=(old.tile_size if old is not None else 4.0),
            real_hw=(track.height, track.width))

    def _obstacle_box_segments(self, track, x, y, size):
        """The 4 boundary segments of the rasterized obstacle box, in the
        exact cell snapping of maps.loader.add_obstacle."""
        res = track.resolution
        r = max(1, int(round(size / res / 2)))
        ci = int((y - track.origin_y) / res)
        cj = int((x - track.origin_x) / res)
        i0, i1 = max(0, ci - r), min(track.height, ci + r + 1)
        j0, j1 = max(0, cj - r), min(track.width, cj + r + 1)
        ox, oy = track.origin_x, track.origin_y
        return np.asarray([
            (ox + j0 * res, oy + i0 * res, oy + i1 * res, 1.0),
            (ox + j1 * res, oy + i0 * res, oy + i1 * res, 1.0),
            (oy + i0 * res, ox + j0 * res, ox + j1 * res, 0.0),
            (oy + i1 * res, ox + j0 * res, ox + j1 * res, 0.0)],
            np.float64)

    def add_obstacle(self, x, y, size=0.2):
        """Rasterize an obstacle and update EDF + geometry (reference
        addObstacle; episode-frequency host path, SURVEY.md §3.4). On the
        sector backend the cull-list update is INCREMENTAL (append into
        headroom slots, ~ms) — ray-exact, see maps.sectors.add_segments —
        with a full rebuild fallback when headroom runs out."""
        from .maps.sectors import add_segments
        track = _add_obs(self.bundle.track, x, y, size)
        if self.backend == "sectors":
            try:
                segmap = add_segments(
                    self.bundle.segmap,
                    self._obstacle_box_segments(self.bundle.track, x, y,
                                                size))
            except ValueError:
                segmap = self._build_segmap(track)
        else:
            segmap = self._build_segmap(track)
        self.bundle = self.bundle._replace(track=track, segmap=segmap)
        self._swap_or_rebuild()

    def clear_obstacles(self):
        """Restore the pristine map (reference clearObstacles). The
        pristine geometry is cached, so this is swap-only (no rebuild)."""
        t = self._pristine_track
        self.bundle = self.bundle._replace(track=t,
                                           segmap=self._pristine_segmap)
        self._swap_or_rebuild()

    # camelCase aliases matching the reference lineage's method names
    updatePose = update_pose
    runScan = run_scan
    getScan = run_scan
    checkCollision = check_collision
    getState = get_state
    setState = set_state
    setPose = set_pose
    addObstacle = add_obstacle
    clearObstacles = clear_obstacles
    setInput = drive
