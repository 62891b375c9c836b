"""ROS-format occupancy-grid map loading and the on-device map bundle.

Reference parity: the reference loads ROS map_server assets — a PGM/PNG image
plus a YAML sidecar with ``image, resolution, origin, occupied_thresh,
free_thresh, negate`` — into a row-major occupancy array, then builds the
euclidean distance field from it (SURVEY.md §2a "Map loader & assets",
§3.1 init call stack). This module keeps the file format byte-compatible.

Design: host-side parsing produces a ``TrackMap`` whose occupancy and EDF
live as jnp arrays (shipped to device memory once per map mutation). The EDF
is padded on the right/top to 128-aligned dimensions so downstream sweeps
and XLA gathers see aligned shapes. Padding cells are FREE (a ray leaving the
real map must return max_range, exactly like the reference's out-of-map
exit — occupied padding would fake walls at two edges); consumers test
in-bounds against the real ``(height, width)``, not the padded shape.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .edt import edt

ASSETS_DIR = os.path.join(os.path.dirname(__file__), "assets")
_LANE_ALIGN = 128


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class TrackMap:
    """Map bundle: occupancy + EDF on device, geometry metadata static.

    Registered as a pytree so it can be closed over or passed through jit;
    geometry metadata (shape, resolution, origin) is static aux data so shape
    changes retrigger compilation, while grids are traced leaves.
    """

    occupancy: Any        # (H, W) float32 in [0,1]; padded region = 1.0
    edf: Any              # (H, W) float32 meters-to-nearest-obstacle
    resolution: float     # meters per cell (static)
    origin_x: float       # world coords of cell (0,0) corner (static)
    origin_y: float
    height: int           # original (unpadded) grid dims (static)
    width: int
    name: str = "map"

    def tree_flatten(self):
        return (self.occupancy, self.edf), (
            self.resolution, self.origin_x, self.origin_y,
            self.height, self.width, self.name)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        occ, edf_ = leaves
        res, ox, oy, h, w, name = aux
        return cls(occupancy=occ, edf=edf_, resolution=res, origin_x=ox,
                   origin_y=oy, height=h, width=w, name=name)

    @property
    def padded_shape(self) -> Tuple[int, int]:
        return tuple(self.edf.shape)

    def world_extent(self):
        """((xmin, xmax), (ymin, ymax)) of the unpadded map in meters."""
        return ((self.origin_x, self.origin_x + self.width * self.resolution),
                (self.origin_y, self.origin_y + self.height * self.resolution))


def _align_up(n: int, m: int = _LANE_ALIGN) -> int:
    return ((n + m - 1) // m) * m


def read_pgm(path: str) -> np.ndarray:
    """Minimal P2/P5 PGM reader (no external deps). Returns (H, W) uint8/16."""
    with open(path, "rb") as f:
        data = f.read()
    # Header tokens: magic, width, height, maxval — comments start with '#'.
    tokens, i = [], 0
    while len(tokens) < 4:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i] not in (10, 13):
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    i += 1  # single whitespace after maxval
    if magic == b"P5":
        dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
        img = np.frombuffer(data, dtype=dtype, count=h * w, offset=i)
        return img.reshape(h, w).astype(np.uint16 if maxval >= 256 else np.uint8)
    if magic == b"P2":
        vals = np.array(data[i:].split(), dtype=np.int64)[: h * w]
        return vals.reshape(h, w).astype(np.uint16 if maxval >= 256 else np.uint8)
    raise ValueError(f"unsupported PGM magic {magic!r} in {path}")


def write_pgm(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W) array as binary P5 PGM."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def _read_image(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pgm":
        return read_pgm(path)
    # PNG and friends via PIL when available (reference's berlin map is PNG).
    from PIL import Image
    img = Image.open(path).convert("L")
    return np.asarray(img, dtype=np.uint8)


def occupancy_from_image(img: np.ndarray, negate: int = 0,
                         occupied_thresh: float = 0.65,
                         free_thresh: float = 0.196) -> np.ndarray:
    """ROS map_server trinary semantics → occupancy probability in [0, 1].

    p = (255 - value)/255 unless negate; p > occupied_thresh → 1.0 occupied,
    p < free_thresh → 0.0 free, else unknown → -1 in ROS; the reference (and
    we) treat unknown as occupied for ray-marching safety, encoded 1.0 here,
    with the raw trinary value recoverable from the thresholds if needed.
    """
    maxv = float(img.max()) if img.dtype != np.uint8 else 255.0
    maxv = max(maxv, 1.0)
    v = img.astype(np.float64) / maxv
    p = v if negate else (1.0 - v)
    occ = np.where(p > occupied_thresh, 1.0,
                   np.where(p < free_thresh, 0.0, 1.0))
    return occ.astype(np.float32)


def build_track_map(occupancy: np.ndarray, resolution: float,
                    origin_xy=(0.0, 0.0), name: str = "map",
                    occupied_thresh: float = 0.5) -> TrackMap:
    """Build the device map bundle: pad, EDT, upload.

    ``occupancy`` is (H, W) float32 in [0,1] (row 0 = world bottom, i.e.
    y-up indexing; callers loading image files flip rows first).
    """
    h, w = occupancy.shape
    hp, wp = _align_up(h), _align_up(w)
    occ_p = np.zeros((hp, wp), dtype=np.float32)  # pad = free (see module doc)
    occ_p[:h, :w] = occupancy
    field = edt(occ_p >= occupied_thresh, resolution=resolution)
    return TrackMap(
        occupancy=jnp.asarray(occ_p),
        edf=jnp.asarray(field),
        resolution=float(resolution),
        origin_x=float(origin_xy[0]), origin_y=float(origin_xy[1]),
        height=h, width=w, name=name)


def _yaml_scalar(text: str):
    """One flat YAML scalar or flow list: number, [a, b, c], or string."""
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_yaml_scalar(t) for t in inner.split(",")] if inner else []
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        return text


def parse_map_yaml(text: str) -> dict:
    """Parse a ROS map_server sidecar: flat ``key: value`` lines (``image``,
    ``resolution``, ``origin``, ``negate``, ``occupied_thresh``,
    ``free_thresh``), ``#`` comments, flow lists. Enough for the format,
    so the main path does not need pyyaml; nested YAML raises."""
    meta = {}
    for n, raw in enumerate(text.splitlines(), 1):
        line = raw.split(" #", 1)[0].rstrip()
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if line[0].isspace() or ":" not in line:
            raise ValueError(f"map YAML line {n}: expected a flat "
                             f"'key: value' line, got {raw!r}")
        key, val = line.split(":", 1)
        if not val.strip():
            raise ValueError(f"map YAML line {n}: key {key.strip()!r} "
                             "has no value (nested YAML is not supported)")
        meta[key.strip()] = _yaml_scalar(val)
    return meta


def _read_map_yaml(yaml_path: str) -> dict:
    """The sidecar's keys: pyyaml when it is importable (full YAML), the
    flat parser otherwise."""
    with open(yaml_path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return parse_map_yaml(text)
    return yaml.safe_load(text)


def load_map_yaml(yaml_path: str) -> TrackMap:
    """Load a ROS map YAML + image pair into a TrackMap (reference init path)."""
    meta = _read_map_yaml(yaml_path)
    img_path = meta["image"]
    if not os.path.isabs(img_path):
        img_path = os.path.join(os.path.dirname(yaml_path), img_path)
    img = _read_image(img_path)
    occ = occupancy_from_image(
        img, negate=int(meta.get("negate", 0)),
        occupied_thresh=float(meta.get("occupied_thresh", 0.65)),
        free_thresh=float(meta.get("free_thresh", 0.196)))
    # Image row 0 is the TOP of the map; grid row 0 must be world bottom.
    occ = occ[::-1].copy()
    origin = meta.get("origin", [0.0, 0.0, 0.0])
    name = os.path.splitext(os.path.basename(yaml_path))[0]
    return build_track_map(occ, float(meta["resolution"]),
                           (float(origin[0]), float(origin[1])), name=name)


def load_builtin(name: str) -> TrackMap:
    """Load a bundled map asset by name (e.g. 'levine', 'berlin')."""
    path = os.path.join(ASSETS_DIR, f"{name}.yaml")
    if not os.path.exists(path):
        from .generate import generate_builtin
        generate_builtin(name, ASSETS_DIR)
    return load_map_yaml(path)


def add_obstacle(track: TrackMap, x: float, y: float,
                 size: float = 0.2) -> TrackMap:
    """Rasterize a square obstacle and rebuild the EDF (reference
    ``addObstacle`` path, SURVEY.md §3.4). Host-side + re-upload; obstacles
    mutate at episode frequency, not step frequency."""
    occ = np.asarray(track.occupancy)[: track.height, : track.width].copy()
    r = max(1, int(round(size / track.resolution / 2)))
    ci = int((y - track.origin_y) / track.resolution)
    cj = int((x - track.origin_x) / track.resolution)
    i0, i1 = max(0, ci - r), min(track.height, ci + r + 1)
    j0, j1 = max(0, cj - r), min(track.width, cj + r + 1)
    occ[i0:i1, j0:j1] = 1.0
    return build_track_map(occ, track.resolution,
                           (track.origin_x, track.origin_y), name=track.name)


def clear_obstacles(track: TrackMap, original: TrackMap) -> TrackMap:
    """Reference ``clearObstacles``: restore the pristine map."""
    return original


def sample_free_poses(track: TrackMap, n: int, rng=None,
                      margin: float = 0.3, theta_range=(-np.pi, np.pi)):
    """Sample n collision-free poses (x, y, theta) in open space.

    ``margin``: minimum EDF clearance in meters. Returns (n, 3) float32.
    """
    if rng is None or isinstance(rng, int):
        rng = np.random.RandomState(rng or 0)
    edf = np.asarray(track.edf)[: track.height, : track.width]
    ys, xs = np.where(edf > margin)
    if len(ys) == 0:
        raise ValueError(f"no free cells with clearance > {margin}")
    k = rng.randint(len(ys), size=n)
    x = track.origin_x + (xs[k] + 0.5) * track.resolution
    y = track.origin_y + (ys[k] + 0.5) * track.resolution
    th = rng.uniform(theta_range[0], theta_range[1], n)
    return np.stack([x, y, th], axis=-1).astype(np.float32)
