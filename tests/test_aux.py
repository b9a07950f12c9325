"""Auxiliary subsystems: debug mode, checkpoint/resume, scene IO, logging."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig, simulate_summary
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer
from erpl_monte_carlo_sim_tpu.mc.checkpoint import load_summaries, save_summaries
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu.utils.debug import check_finite, debug_mode
from erpl_monte_carlo_sim_tpu.utils.logging import configure, get_logger
from erpl_monte_carlo_sim_tpu.utils.scene_io import (
    load_scene,
    save_scene,
    scene_from_dict,
    scene_to_dict,
)


def test_check_finite():
    check_finite({"a": jnp.ones(3)}, "ok")
    with pytest.raises(FloatingPointError, match="non-finite"):
        check_finite({"a": jnp.array([1.0, jnp.nan])}, "bad")


def test_debug_mode_restores_config():
    prev = jax.config.jax_debug_nans
    with debug_mode(nans=True):
        assert jax.config.jax_debug_nans
    assert jax.config.jax_debug_nans == prev


def test_logging():
    configure()
    log = get_logger("test")
    log.info("structured logging live")  # must not raise


def test_scene_json_roundtrip(tmp_path):
    scene = nominal_scene(liquid_motor())
    path = str(tmp_path / "scene.json")
    save_scene(scene, path)
    loaded = load_scene(path)
    # Physics equivalence: same flight out of the loaded scene
    ic = InitialConditions.vertical_launch()
    cfg = SimConfig(max_time=12.0)
    s1 = jax.jit(simulate_summary, static_argnums=2)(scene, ic, cfg)
    s2 = jax.jit(simulate_summary, static_argnums=2)(loaded, ic, cfg)
    assert float(s1.apogee_altitude) == pytest.approx(
        float(s2.apogee_altitude), rel=1e-12
    )
    # Static fields survive
    assert loaded.motor.mdot_follows_thrust == scene.motor.mdot_follows_thrust
    d = scene_to_dict(scene)
    assert d["rocket"]["dry_mass"] == 113.4


def test_checkpoint_roundtrip(tmp_path):
    scene = nominal_scene(liquid_motor())
    mc = MonteCarloAnalyzer(
        scene=scene,
        sim_config=SimConfig(max_time=12.0, energy_consistent_aero=True),
    )
    ic = InitialConditions.vertical_launch()
    a = mc.run_monte_carlo(ic, n_samples=8, seed=3)
    path = str(tmp_path / "mc.npz")
    save_summaries(path, a, seed=3)
    ck = load_summaries(path)
    np.testing.assert_array_equal(ck["valid_mask"], a["valid_mask"])
    np.testing.assert_allclose(
        np.asarray(ck["summary"].apogee_altitude),
        np.asarray(a["summary"].apogee_altitude),
    )
    assert ck["meta"]["seed"] == 3
    assert ck["meta"]["stats"]["apogee_altitude"]["mean"] == a["apogee_altitude"]["mean"]
    # determinism-by-key resume: re-running the same seed reproduces lanes
    b = mc.run_monte_carlo(ic, n_samples=8, seed=3)
    np.testing.assert_array_equal(
        np.asarray(b["summary"].apogee_altitude),
        np.asarray(ck["summary"].apogee_altitude),
    )
