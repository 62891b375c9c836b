"""chip_smoke.py: its phase functions at tiny sizes on the CPU, and its
refusal to run anywhere but on a GPU."""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest

from pyracecarsimulator_tpu.config import ScanParams
from pyracecarsimulator_tpu.simulator import build_sim

_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "chip_smoke.py")
_spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

SCAN = ScanParams(num_beams=128)


@pytest.fixture(scope="module")
def built(small_track):
    """levine from the bundled assets plus the synthetic corridor, both
    at 128 beams: sector bundle + dense exact reference bundle each."""
    out = cs.phase1_build(("levine",), scan=SCAN)
    sec = build_sim(small_track, scan=SCAN, backend="auto")
    out["small"] = (sec, build_sim(small_track, scan=SCAN,
                                   backend="segments"))
    return out


def test_phase0_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        cs.check_device(jax.devices())
    dev = cs.check_device(jax.devices(), platform="cpu")
    assert dev == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


def test_main_stops_at_phase0_without_result(capsys):
    with pytest.raises(RuntimeError, match="needs a GPU"):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("name", ["levine", "small"])
def test_phase2_parity_tiny(built, name):
    sec, dense = built[name]
    d = cs.phase2_parity(name, sec, dense, agents=16, oracle_agents=4)
    assert d["dense"] <= cs.TOL_SECTOR_VS_DENSE
    assert d["within"] >= cs.ORACLE_MIN_FRACTION


def test_phase3_grad_tiny(built):
    sec, dense = built["small"]
    assert cs.phase3_grad("small", sec, dense, agents=8) >= 0.0


def test_phase4_march_tiny(small_track):
    r = cs.phase4_march(small_track, agents=4, scan=SCAN)
    assert r["within"] > 0.99


def test_phase5_rollout_tiny(built):
    sec, _ = built["small"]
    assert cs.phase5_rollout("small", sec, agents=16, steps=4) >= 0


def test_phase6_train_tiny(small_track):
    assert cs.phase6_train(small_track, agents=8, steps=3, updates=2,
                           scan=SCAN) > 0.0


def test_phase7_multi_and_mapgrad_tiny(built):
    r = cs.phase7_multi_and_mapgrad(
        {n: built[n] for n in ("levine", "small")}, agents=16,
        mapgrad_agents=8)
    assert r["multi"] <= cs.TOL_MULTI and r["mapgrad_fwd"] == 0.0


def test_phase_facade_tiny(small_track):
    cs.phase_facade(small_track, scan=SCAN)


def test_four_card_checks_on_cpu_mesh(small_track):
    """The --four path on four of the eight virtual CPU devices."""
    cs.four_card_checks(agents=16, bptt_agents=8, ring_agents=8,
                        track=small_track, scan=SCAN)


def test_contract_line_shape(monkeypatch, capsys):
    """With phase 0 passing, the last stdout line is exactly the JSON
    contract line (phases stubbed: this checks the wiring only)."""
    dev = {"platform": "gpu", "kind": "stub", "count": 4}
    monkeypatch.setattr(cs, "phase0_device", lambda: dev)
    monkeypatch.setattr(cs, "four_card_checks", lambda: None)
    monkeypatch.setattr(
        "pyracecarsimulator_tpu.utils.compile_cache.enable_compile_cache",
        lambda: "stub")
    assert cs.main(["--four"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": dev}
