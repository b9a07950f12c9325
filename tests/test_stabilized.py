"""Opt-in energy-consistent aero: stability under wind, parity when off.

Background (verified by executing the reference): the reference's
wind->body matrix misaligns drag from the relative wind when alpha AND beta
are nonzero, letting aero forces inject energy at high dynamic pressure —
its wind-dispersed flights blow up to 1e37-scale ranges and its own MC
produces ~100% outliers (SURVEY.md §6). ``SimConfig.energy_consistent_aero``
fixes the decomposition; OFF by default for exact parity.
"""

import os

import jax
import numpy as np
import pytest

import erpl_monte_carlo_sim_tpu
from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig, simulate_summary
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer
from erpl_monte_carlo_sim_tpu.models import (
    WindField,
    liquid_motor,
    load_wind_profile_from_csv,
    nominal_scene,
)

# Any forecast does: the repo's own sample profile.
SAMPLE_CSV = os.path.join(
    os.path.dirname(erpl_monte_carlo_sim_tpu.__file__), "data", "sample_wind.csv"
)


@pytest.fixture(scope="module")
def fn():
    return jax.jit(simulate_summary, static_argnums=2)


def test_no_wind_parity_unchanged(fn, golden_flight_liquid):
    """With alpha*beta ~ 0 the corrected decomposition coincides with the
    reference's: the nominal flight must stay within golden tolerance."""
    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    s = fn(scene, ic, SimConfig(energy_consistent_aero=True))
    assert float(s.apogee_altitude) == pytest.approx(
        golden_flight_liquid["apogee_altitude"], rel=1e-4
    )
    # Descent differs slightly (drag direction changes the terminal phase);
    # apogee is the strict parity metric.
    assert float(s.flight_time) == pytest.approx(
        golden_flight_liquid["flight_time"], rel=0.15
    )


def test_csv_wind_flight_stabilized(fn):
    """The configuration that diverges in the reference (and in parity mode)
    must fly a complete, physical flight with the fix on."""
    scene = nominal_scene(liquid_motor())
    alts, wind = load_wind_profile_from_csv(SAMPLE_CSV)
    scene_w = scene.replace(wind=WindField.from_arrays(alts, wind))
    ic = InitialConditions.vertical_launch()

    bad = fn(scene_w, ic, SimConfig())
    good = fn(scene_w, ic, SimConfig(energy_consistent_aero=True))

    # Parity mode reproduces the reference's blow-up...
    assert (not np.isfinite(float(bad.range))) or float(bad.range) > 1e6
    # ...the stabilized mode flies a full physical flight.
    assert float(good.flight_time) > 100.0
    assert float(good.max_speed) < 1500.0
    assert np.isfinite(float(good.range)) and float(good.range) < 50000.0
    assert bool(good.parachute_deployed)
    assert not bool(good.diverged)


@pytest.mark.slow
def test_mc_with_wind_all_valid():
    scene = nominal_scene(liquid_motor())
    alts, wind = load_wind_profile_from_csv(SAMPLE_CSV)
    mc = MonteCarloAnalyzer(
        scene=scene, sim_config=SimConfig(energy_consistent_aero=True)
    )
    mc.base_altitude_profile, mc.base_wind_profile = alts, wind
    ic = {
        "position": [0.0, 0.0, 10.0],
        "velocity": [0.0, 0.0, 0.0],
        "attitude": [0.0, -np.pi / 2 + 0.02, 0.0],
        "angular_velocity": [0.0, 0.0, 0.0],
    }
    a = mc.run_monte_carlo(ic, n_samples=16, seed=0)
    assert a["n_samples"] >= 15  # vs ~1/16 valid in parity mode
    assert 1000.0 < a["apogee_altitude"]["mean"] < 30000.0


def test_speed_guard_flags_divergence(fn):
    """With an explicit speed guard, a blowing-up lane is flagged diverged
    and terminated early instead of integrating garbage to max_time."""
    scene = nominal_scene(liquid_motor())
    alts, wind = load_wind_profile_from_csv(SAMPLE_CSV)
    scene_w = scene.replace(wind=WindField.from_arrays(alts, wind))
    ic = InitialConditions.vertical_launch()
    s = fn(scene_w, ic, SimConfig(speed_guard=1.0e4))
    assert bool(s.diverged)
    assert float(s.flight_time) < 20.0
