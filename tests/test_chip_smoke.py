"""``chip_smoke.py`` on the CPU backend: every phase at a tiny size, and the
refusal to run without a GPU. What only the card can show (its compiler,
its precision, its speed) is the script's own run on the card."""

import importlib.util
import os

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_main_refuses_cpu_backend(chip_smoke, capsys):
    assert jax.default_backend() == "cpu"
    assert chip_smoke.main([]) != 0
    # no result line: nothing on stdout
    assert capsys.readouterr().out == ""


PHASES = {
    "single": {},
    "mc_window": {"n_lanes": 64, "n_ref": 16},
    "mc_parity": {"n_lanes": 4},
    "fast_paths": {"n_lanes": 64, "n_ref": 16, "env_lanes": 32,
                   "env_ref": 16, "env_time": 3.0025},
    "multi": {"n_devices": 8, "n_lanes": 64, "lane_slab": 32},
}


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_tiny(chip_smoke, name):
    res = getattr(chip_smoke, f"phase_{name}")(**PHASES[name])
    assert res["phase"] == name
    failed = [c for c in res["checks"] if not c["ok"]]
    assert res["ok"] and not failed, failed
    assert res["steady_s"] > 0 and res["first_call_s"] > 0
