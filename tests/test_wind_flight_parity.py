"""Wind-path parity: trajectory probes vs the executed reference with the
CSV forecast, over the pre-divergence window.

Both the reference and this engine (in parity mode) eventually blow up on
this configuration (the drag-misalignment instability, SURVEY.md §6), but
the first ~10 s are well-conditioned: matching them pins the entire wind
code path — CSV interp, crosswind weathercocking, rail-exit aero angles —
against ground truth from running the reference.
"""

import os

import jax
import numpy as np
import pytest

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig, simulate_flight
from erpl_monte_carlo_sim_tpu.models import (
    WindField,
    liquid_motor,
    load_wind_profile_from_csv,
    nominal_scene,
)

SAMPLE_CSV = "/root/reference/rocket_simulation/sample_wind.csv"


@pytest.fixture(scope="module")
def traj():
    # The golden was flown on the upstream project's own forecast; the
    # repo's data/sample_wind.csv is a different profile.
    if not os.path.exists(SAMPLE_CSV):
        pytest.skip("upstream sample_wind.csv absent")
    scene = nominal_scene(liquid_motor())
    alts, wind = load_wind_profile_from_csv(SAMPLE_CSV)
    scene_w = scene.replace(wind=WindField.from_arrays(alts, wind))
    ic = InitialConditions.vertical_launch()
    cfg = SimConfig(max_time=11.0)  # pre-divergence window only
    return jax.jit(simulate_flight, static_argnums=2)(scene_w, ic, cfg)


def test_rail_exit_with_wind(traj, golden_flight_csvwind):
    s, _ = traj
    g = golden_flight_csvwind
    assert float(s.rail.rail_exit_speed) == pytest.approx(g["rail_exit_speed"], rel=1e-5)
    assert float(s.rail.rail_exit_angle_of_attack) == pytest.approx(
        g["rail_exit_aoa"], rel=1e-3
    )
    assert float(s.rail.rail_exit_sideslip) == pytest.approx(
        g["rail_exit_sideslip"], rel=1e-2, abs=1e-6
    )


def test_trajectory_probes_with_wind(traj, golden_flight_csvwind):
    _, t = traj
    valid = np.asarray(t.valid)
    time = np.asarray(t.time)[valid]
    alt = np.asarray(t.position[:, 2])[valid]
    x = np.asarray(t.position[:, 0])[valid]
    y = np.asarray(t.position[:, 1])[valid]
    speed = np.asarray(t.derived["speed"])[valid]
    aoa = np.asarray(t.derived["angle_of_attack"])[valid]
    for probe in golden_flight_csvwind["probes"]:
        if probe["t"] > 10.5:
            continue  # past this the reference's own integration diverges
        i = int(np.argmin(np.abs(time - probe["t"])))
        assert alt[i] == pytest.approx(probe["alt"], rel=2e-3), probe["t"]
        assert speed[i] == pytest.approx(probe["speed"], rel=2e-3), probe["t"]
        assert x[i] == pytest.approx(probe["x"], rel=0.05, abs=0.5), probe["t"]
        assert y[i] == pytest.approx(probe["y"], rel=0.05, abs=0.5), probe["t"]
        assert aoa[i] == pytest.approx(probe["aoa"], abs=3e-3), probe["t"]
