"""Checks that need the card (marker ``gpu``; skip elsewhere).

Run on a machine with an NVIDIA GPU:

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyracecarsimulator_tpu.config import ScanParams
from pyracecarsimulator_tpu.maps.loader import sample_free_poses
from pyracecarsimulator_tpu.ops.raycast_sectors import scan_poses_sectors
from pyracecarsimulator_tpu.simulator import build_sim

FOV = 4.712388980384690
pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("name", ["levine", "berlin"])
def test_sector_modes_agree_on_card(gpu_device, name):
    """Every sweep mode compiles for the card and gives the dense values
    (1e-4 m: the sector tolerance of chip_smoke.py)."""
    b = build_sim(name, scan=ScanParams(), backend="auto")
    poses = jnp.asarray(sample_free_poses(b.track, 512,
                                          np.random.RandomState(0)))
    scan = jax.jit(lambda sm, p, mode: scan_poses_sectors(
        sm, p, num_beams=1080, fov=FOV, mode=mode), static_argnums=2)
    r_dense = np.asarray(scan(b.segmap, poses, "dense"))
    for mode in ("auto", "sorted_pt@512", "sorted@256"):
        r = np.asarray(scan(b.segmap, poses, mode))
        assert np.abs(r - r_dense).max() <= 1e-4, mode


def test_chip_smoke_phases_on_card(gpu_device):
    """chip_smoke.py's parity, gradient and march phases at small size."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    built = cs.phase1_build(("levine",))
    sec, dense = built["levine"]
    cs.phase2_parity("levine", sec, dense, agents=256, oracle_agents=32)
    cs.phase3_grad("levine", sec, dense, agents=64)
    cs.phase4_march(sec.track, agents=16)
