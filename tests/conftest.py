"""Test configuration: a deterministic 8-device CPU topology.

Multi-device sharding logic (SURVEY.md §4 item 4) is tested without a
cluster via XLA's host-platform device-count override. Env vars must be set
before jax initializes its backends, hence module scope here.

Tests run on the CPU unless ``JAX_PLATFORMS=cuda`` is set, which is how the
``gpu``-marked tests are run on a card:
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8").strip()
_ON_CARD = os.environ.get("JAX_PLATFORMS") == "cuda"
if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU device; skips the test where there is none (decided
    here, at run time, never at import)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; this run's platform is "
                    f"{devs[0].platform!r}")
    return devs[0]


@pytest.fixture(scope="session")
def small_track():
    """A small synthetic corridor map shared across tests (fast EDT)."""
    from pyracecarsimulator_tpu.maps.loader import build_track_map
    h = w = 192
    occ = np.zeros((h, w), np.float32)
    occ[:4, :] = 1; occ[-4:, :] = 1; occ[:, :4] = 1; occ[:, -4:] = 1
    occ[60:132, 60:132] = 1          # interior block -> corridor loop
    occ[100:104, 20:40] = 1          # a pillar-ish bar in the corridor
    return build_track_map(occ, resolution=0.05, origin_xy=(-4.8, -4.8),
                           name="small")


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same stream regardless of
    # execution order (a shared stream made failures order-dependent)
    return np.random.RandomState(42)
