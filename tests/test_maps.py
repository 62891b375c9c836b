"""Map loader / asset round-trip tests (SURVEY.md §4 item 2, map loader)."""

import os

import numpy as np
import pytest

from pyracecarsimulator_tpu.maps.loader import (
    TrackMap, add_obstacle, build_track_map, load_builtin, load_map_yaml,
    occupancy_from_image, read_pgm, write_pgm)


def test_pgm_roundtrip(tmp_path, rng):
    img = (rng.rand(37, 53) * 255).astype(np.uint8)
    p = str(tmp_path / "t.pgm")
    write_pgm(p, img)
    np.testing.assert_array_equal(read_pgm(p), img)


def test_pgm_ascii(tmp_path):
    p = str(tmp_path / "a.pgm")
    with open(p, "w") as f:
        f.write("P2\n# comment\n3 2\n255\n0 128 255\n10 20 30\n")
    img = read_pgm(p)
    np.testing.assert_array_equal(img, [[0, 128, 255], [10, 20, 30]])


def test_occupancy_semantics():
    img = np.array([[254, 0, 205]], np.uint8)  # free, occupied, unknown
    occ = occupancy_from_image(img)
    assert occ[0, 0] == 0.0       # free
    assert occ[0, 1] == 1.0       # occupied
    assert occ[0, 2] == 1.0       # unknown -> treated occupied


def test_yaml_load_and_orientation(tmp_path):
    # 2 rows: top row occupied, bottom row free. After the loader's flip,
    # grid row 0 (world bottom) must be the free one.
    img = np.zeros((2, 4), np.uint8)
    img[0, :] = 0      # top: occupied (dark)
    img[1, :] = 254    # bottom: free (light)
    write_pgm(str(tmp_path / "m.pgm"), img)
    with open(tmp_path / "m.yaml", "w") as f:
        f.write("image: m.pgm\nresolution: 0.1\norigin: [1.0, 2.0, 0.0]\n"
                "negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.196\n")
    t = load_map_yaml(str(tmp_path / "m.yaml"))
    occ = np.asarray(t.occupancy)
    assert occ[0, 0] == 0.0 and occ[1, 0] == 1.0
    assert (t.origin_x, t.origin_y) == (1.0, 2.0)
    assert t.height == 2 and t.width == 4
    assert t.padded_shape[0] % 128 == 0 and t.padded_shape[1] % 128 == 0


def test_padding_is_free(small_track):
    # Free padding: a ray leaving the real map must see open space (and the
    # march's real-bounds test returns max_range), not phantom walls.
    occ = np.asarray(small_track.occupancy)
    assert (occ[small_track.height:, :] == 0.0).all()
    assert (occ[:, small_track.width:] == 0.0).all()


def test_builtin_maps_generate():
    for name in ("levine", "berlin"):
        t = load_builtin(name)
        occ = np.asarray(t.occupancy)[: t.height, : t.width]
        free_frac = (occ < 0.5).mean()
        assert 0.05 < free_frac < 0.9, (name, free_frac)
        assert np.asarray(t.edf).max() > 0.5  # some open space


def test_add_obstacle_rebuilds_edf(small_track):
    edf0 = np.asarray(small_track.edf)[: small_track.height,
                                       : small_track.width]
    # place obstacle at the most open point inside the real map
    iy, ix = np.unravel_index(np.argmax(edf0), edf0.shape)
    x = small_track.origin_x + (ix + 0.5) * small_track.resolution
    y = small_track.origin_y + (iy + 0.5) * small_track.resolution
    t2 = add_obstacle(small_track, x, y, size=0.3)
    edf1 = np.asarray(t2.edf)
    assert edf1[iy, ix] == 0.0
    assert edf0[iy, ix] > 0.5


_BUNDLED_YAML = {
    "levine": {"image": "levine.pgm", "resolution": 0.05,
               "origin": [-32.5, -32.5, 0.0], "negate": 0,
               "occupied_thresh": 0.65, "free_thresh": 0.196},
    "berlin": {"image": "berlin.pgm", "resolution": 0.05,
               "origin": [-30.0, -30.0, 0.0], "negate": 0,
               "occupied_thresh": 0.65, "free_thresh": 0.196},
}


@pytest.mark.parametrize("name", sorted(_BUNDLED_YAML))
def test_flat_yaml_parser_bundled(name):
    from pyracecarsimulator_tpu.maps.loader import ASSETS_DIR, parse_map_yaml
    with open(os.path.join(ASSETS_DIR, f"{name}.yaml")) as f:
        assert parse_map_yaml(f.read()) == _BUNDLED_YAML[name]


@pytest.mark.parametrize("text,want", [
    ("image: 'my map.pgm'  # quoted, trailing comment\n",
     {"image": "my map.pgm"}),
    ('# header\n\nimage: "m.png"\nnegate: 1\n',
     {"image": "m.png", "negate": 1}),
    ("resolution: 5e-2\norigin: [ -1, 2.5 , 0 ]\n",
     {"resolution": 0.05, "origin": [-1, 2.5, 0]}),
    ("origin: []\nfree_thresh: .25\n", {"origin": [], "free_thresh": 0.25}),
])
def test_flat_yaml_parser_edge_cases(text, want):
    from pyracecarsimulator_tpu.maps.loader import parse_map_yaml
    assert parse_map_yaml(text) == want


@pytest.mark.parametrize("text", ["origin:\n  - 1.0\n", "just text\n"])
def test_flat_yaml_parser_rejects_non_flat(text):
    from pyracecarsimulator_tpu.maps.loader import parse_map_yaml
    with pytest.raises(ValueError, match="line"):
        parse_map_yaml(text)


def test_builtin_loads_without_pyyaml(monkeypatch):
    """The main path needs no pyyaml: with it unimportable, the bundled
    map loads through the flat parser to the same TrackMap."""
    import sys
    ref = load_builtin("levine")
    monkeypatch.setitem(sys.modules, "yaml", None)     # import yaml fails
    t = load_builtin("levine")
    assert (t.resolution, t.origin_x, t.origin_y) == (
        ref.resolution, ref.origin_x, ref.origin_y)
    np.testing.assert_array_equal(np.asarray(t.occupancy),
                                  np.asarray(ref.occupancy))
