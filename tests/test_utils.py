"""Checkpoint round-trip + multihost mesh layout + profiling harness."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyracecarsimulator_tpu.state import zero_state, set_field
from pyracecarsimulator_tpu.utils.checkpoint import (
    save_npz, load_npz, save_orbax, load_orbax)
from pyracecarsimulator_tpu.parallel.multihost import make_pod_mesh
from pyracecarsimulator_tpu.utils.profiling import timed_loop


def _state():
    s = zero_state((4,))
    return set_field(s, x=jnp.arange(4.0), velocity=jnp.full((4,), 2.5),
                     collision=jnp.array([True, False, False, True]))


def test_npz_roundtrip(tmp_path):
    s = _state()
    key = jax.random.PRNGKey(42)
    p = str(tmp_path / "ck.npz")
    save_npz(p, s, key, step=17)
    s2, key2, step = load_npz(p)
    for a, b in zip(jax.tree.leaves(s), jax.tree.leaves(s2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(key), np.asarray(key2))
    assert step == 17


def test_orbax_roundtrip(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    s = _state()
    key = jax.random.PRNGKey(3)
    p = str(tmp_path / "orbax_ck")
    save_orbax(p, s, key, step=5)
    s2, key2, step = load_orbax(p, zero_state((4,)))
    for a, b in zip(jax.tree.leaves(s), jax.tree.leaves(s2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert step == 5


def test_pod_mesh_layout():
    mesh = make_pod_mesh(beams_axis=2)
    assert mesh.shape["beams"] == 2
    assert mesh.shape["agents"] == len(jax.devices()) // 2
    with pytest.raises(ValueError):
        make_pod_mesh(beams_axis=3)   # doesn't divide 8


@pytest.mark.parametrize("kwargs", [
    dict(coordinator_address="localhost:12355", num_processes=2,
         process_id=0),
    dict(num_processes=2),
])
def test_multihost_initialize_raises_on_explicit_args(monkeypatch, kwargs):
    """Explicit cluster arguments that cannot be honoured raise (here:
    the backend is already up, so jax.distributed refuses at once)."""
    from pyracecarsimulator_tpu.parallel import multihost
    jax.devices()
    monkeypatch.setattr(multihost, "_initialized", False)
    with pytest.raises(RuntimeError):
        multihost.initialize(**kwargs)
    assert multihost._initialized is False


def test_multihost_initialize_no_args_stays_single_process(monkeypatch):
    from pyracecarsimulator_tpu.parallel import multihost
    jax.devices()
    monkeypatch.setattr(multihost, "_initialized", False)
    multihost.initialize()               # no cluster here: quiet no-op
    assert multihost._initialized is False
    assert jax.process_count() == 1


def test_timed_loop_runs():
    x = jnp.ones((128, 128))
    sec = timed_loop(lambda a: jnp.sum(a * 2.0), x, reps=5)
    assert sec > 0


def test_checkpoint_training_state_roundtrip(tmp_path):
    """Training state (policy params + optax opt state + sim state) is a
    plain pytree, so the checkpoint layer round-trips it unchanged —
    long multi-host sweeps resume mid-training (SURVEY §5 row)."""
    import optax
    import jax.numpy as jnp
    import numpy as np
    from pyracecarsimulator_tpu.state import state_from_pose
    from pyracecarsimulator_tpu.utils.checkpoint import (save_pytree,
                                                         load_pytree)
    params = {"w": jnp.arange(8.0), "b": jnp.float32(0.5)}
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    # advance once so the opt state is non-trivial (adam moments)
    g = {"w": jnp.ones(8), "b": jnp.float32(1.0)}
    upd, opt_state = opt.update(g, opt_state, params)
    sim_state = state_from_pose(jnp.ones(4), jnp.zeros(4), jnp.ones(4))
    bundle = {"params": params, "opt_state": opt_state,
              "sim_state": sim_state, "step": jnp.int32(7)}
    path = str(tmp_path / "train_ckpt")
    save_pytree(path, bundle)
    restored = load_pytree(path, bundle)
    flat_a = jax.tree.leaves(bundle)
    flat_b = jax.tree.leaves(restored)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
