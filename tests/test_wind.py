"""Wind model: query semantics, CSV loading, AR(1) turbulence statistics."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import erpl_monte_carlo_sim_tpu
from erpl_monte_carlo_sim_tpu.models import (
    WindField,
    WindModelParams,
    generate_stochastic_profile,
    load_wind_profile_from_csv,
    perturb_wind_profile,
    power_law_profile,
    wind_at_altitude,
)

# The upstream project's forecast, where mounted: test_csv_loader pins its
# values.
SAMPLE_CSV = "/root/reference/rocket_simulation/sample_wind.csv"
# Any forecast does for the statistics tests: the repo's own profile.
REPO_CSV = os.path.join(
    os.path.dirname(erpl_monte_carlo_sim_tpu.__file__), "data", "sample_wind.csv"
)


def test_zero_field_is_zero_everywhere():
    f = WindField.zero()
    for h in [-10.0, 0.0, 500.0, 30000.0]:
        np.testing.assert_array_equal(np.asarray(wind_at_altitude(f, h)), 0.0)


def test_query_matches_np_interp_per_component():
    rng = np.random.default_rng(3)
    alts = np.linspace(0, 25000, 100)
    wind = rng.normal(size=(100, 3))
    f = WindField.from_arrays(alts, wind)
    for h in [-50.0, 0.0, 137.0, 12500.5, 25000.0, 30000.0]:
        mine = np.asarray(wind_at_altitude(f, jnp.float64(h)))
        ref = np.array([np.interp(h, alts, wind[:, c]) for c in range(3)])
        np.testing.assert_allclose(mine, ref, rtol=1e-9, atol=1e-9)


@pytest.mark.skipif(not os.path.exists(SAMPLE_CSV), reason="sample CSV absent")
def test_csv_loader():
    alts, wind = load_wind_profile_from_csv(SAMPLE_CSV)
    assert alts.shape == (6,) and wind.shape == (6, 3)
    assert alts[0] == 0.0 and alts[-1] == 25000.0
    np.testing.assert_allclose(wind[0], [2.0, 0.0, 0.0])
    np.testing.assert_allclose(wind[-1], [15.0, 3.0, 0.0])


def test_power_law():
    p = WindModelParams()
    v = float(power_law_profile(p, 1000.0, 5.0))
    assert v == pytest.approx(5.0 * (1000.0 / 10.0) ** 0.14, rel=1e-12)


def test_stochastic_profile_reproducible_and_distinct():
    p = WindModelParams()
    alts = jnp.linspace(0.0, 25000.0, 100)
    k1, k2 = jax.random.PRNGKey(0), jax.random.PRNGKey(1)
    a = generate_stochastic_profile(p, k1, alts, 5.0, 0.3)
    b = generate_stochastic_profile(p, k1, alts, 5.0, 0.3)
    c = generate_stochastic_profile(p, k2, alts, 5.0, 0.3)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.allclose(np.asarray(a), np.asarray(c))


def test_stochastic_profile_statistics():
    """Turbulence sigma ~2 m/s at the surface decaying exp(-h/2000), vertical
    x0.3, mean = power-law shear along the chosen direction
    (`environment.py:125-200`)."""
    p = WindModelParams()
    alts = jnp.linspace(0.0, 25000.0, 100)
    direction = 0.7
    keys = jax.random.split(jax.random.PRNGKey(42), 2000)
    profiles = jax.vmap(
        lambda k: generate_stochastic_profile(p, k, alts, 5.0, direction)
    )(keys)
    prof = np.asarray(profiles)  # [2000, 100, 3]

    mean_speed = power_law_profile(p, alts, 5.0)
    expected_u = np.asarray(mean_speed) * np.cos(direction)
    expected_v = np.asarray(mean_speed) * np.sin(direction)
    # Surface point: sigma=2, so SE of mean over 2000 draws ~0.045
    np.testing.assert_allclose(prof[:, 0, 0].mean(), expected_u[0], atol=0.2)
    np.testing.assert_allclose(prof[:, 0, 1].mean(), expected_v[0], atol=0.2)
    assert prof[:, 0, 0].std() == pytest.approx(2.0, abs=0.25)
    assert prof[:, 0, 2].std() == pytest.approx(0.6, abs=0.1)  # vertical x0.3
    # High altitude: turbulence decays to ~0, mean wind remains.
    np.testing.assert_allclose(prof[:, -1, 0].mean(), expected_u[-1], atol=0.05)
    assert prof[:, -1, 0].std() < 0.02


def test_perturb_preserves_forecast_mean():
    p = WindModelParams()
    alts, wind = load_wind_profile_from_csv(REPO_CSV)
    keys = jax.random.split(jax.random.PRNGKey(7), 1000)
    pert = jax.vmap(lambda k: perturb_wind_profile(p, k, alts, wind))(keys)
    pert = np.asarray(pert)
    # Mean over draws approaches the forecast (SE <= 2/sqrt(1000) ~ 0.063)
    np.testing.assert_allclose(pert.mean(axis=0), wind, atol=0.3)
    # Turbulence amplitude decays with altitude
    assert pert[:, 0, 0].std() > pert[:, -1, 0].std() * 5


def _write_csv(path, alts, uvw):
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["altitude", "u", "v", "w"])
        for a, row in zip(alts, uvw):
            w.writerow([a, *row])


def test_ensemble_loader_interpolates_onto_first_grid(tmp_path):
    from erpl_monte_carlo_sim_tpu.models import load_wind_ensemble_from_csvs

    g1 = np.array([0.0, 1000.0, 2000.0])
    m1 = np.array([[1.0, 0.0, 0.0], [2.0, 1.0, 0.0], [3.0, 2.0, 0.0]])
    # member 2 on a DIFFERENT (finer, wider) grid: linear in altitude, so
    # interpolation onto g1 is exact
    g2 = np.linspace(-500.0, 3000.0, 15)
    m2 = np.stack([g2 / 1000.0, -g2 / 2000.0, np.zeros_like(g2)], axis=1)
    p1, p2 = tmp_path / "a.csv", tmp_path / "b.csv"
    _write_csv(p1, g1, m1)
    _write_csv(p2, g2, m2)
    alts, ens = load_wind_ensemble_from_csvs([str(p1), str(p2)])
    assert ens.shape == (2, 3, 3)
    np.testing.assert_array_equal(alts, g1)
    np.testing.assert_allclose(ens[0], m1)
    np.testing.assert_allclose(ens[1, :, 0], g1 / 1000.0, atol=1e-12)
    np.testing.assert_allclose(ens[1, :, 1], -g1 / 2000.0, atol=1e-12)
    with pytest.raises(ValueError, match="at least one"):
        load_wind_ensemble_from_csvs([])


def test_ensemble_sampling_mixture_and_k1_identity():
    """K=1 ensembles reproduce the single-forecast draw bit for bit; a
    K=2 ensemble with far-apart members produces a lane mixture of both,
    deterministic by key."""
    from erpl_monte_carlo_sim_tpu.engine import InitialConditions
    from erpl_monte_carlo_sim_tpu.mc import (
        UncertaintyParams,
        sample_dispersions,
    )
    from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene

    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    # zero the mean-wind offset so profiles differ only via base + AR(1)
    params = UncertaintyParams(wind_speed_range=(0.0, 0.0),
                               wind_direction_range=(0.0, 0.0))
    grid = np.linspace(0.0, 25000.0, 100)
    base = np.stack([np.full(100, 5.0), np.zeros(100), np.zeros(100)],
                    axis=1)
    key = jax.random.PRNGKey(11)
    n = 64
    s1, _, _ = sample_dispersions(key, scene, ic, params, n,
                                  base_wind=(grid, base))
    sk1, _, _ = sample_dispersions(key, scene, ic, params, n,
                                   base_wind=(grid, base[None]))
    np.testing.assert_array_equal(np.asarray(s1.wind.wind),
                                  np.asarray(sk1.wind.wind))

    far = base.copy()
    far[:, 0] = -40.0  # unmistakably different member
    ens = np.stack([base, far], axis=0)
    s2, _, _ = sample_dispersions(key, scene, ic, params, n,
                                  base_wind=(grid, ens))
    u_mean = np.asarray(s2.wind.wind)[:, :, 0].mean(axis=1)
    near_base = u_mean > -10.0
    assert near_base.any() and (~near_base).any()  # both members drawn
    # turbulence sigma ~2 m/s: every lane sits near ONE member's mean
    assert ((np.abs(u_mean - 5.0) < 4.0) | (np.abs(u_mean + 40.0) < 4.0)).all()
    # deterministic by key
    s3, _, _ = sample_dispersions(key, scene, ic, params, n,
                                  base_wind=(grid, ens))
    np.testing.assert_array_equal(np.asarray(s2.wind.wind),
                                  np.asarray(s3.wind.wind))
    # malformed ensembles rejected loudly
    with pytest.raises(ValueError, match="ensemble|base_wind"):
        sample_dispersions(key, scene, ic, params, n,
                           base_wind=(grid, np.zeros((0, 100, 3))))
    with pytest.raises(ValueError, match="base_wind"):
        sample_dispersions(key, scene, ic, params, n,
                           base_wind=(grid, np.zeros((100, 2))))


def test_ensemble_through_analyzer():
    """End-to-end: an ensemble base_wind_profile runs the analyzer and
    re-simulation reproduces the recorded metrics (member choice is
    keyed)."""
    from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
    from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer
    from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene

    an = MonteCarloAnalyzer(scene=nominal_scene(liquid_motor()),
                            sim_config=SimConfig(max_time=2.0),
                            persistent_cache=False)
    grid = np.linspace(0.0, 25000.0, 100)
    base = np.stack([np.full(100, 3.0), np.zeros(100), np.zeros(100)],
                    axis=1)
    an.base_altitude_profile = grid
    an.base_wind_profile = np.stack([base, -2.0 * base], axis=0)
    a = an.run_monte_carlo(InitialConditions.vertical_launch(),
                           n_samples=32, seed=6)
    assert a["n_samples"] > 0
    assert np.isfinite(a["apogee_altitude"]["mean"])
    lane = a["results"][0]["simulation_id"]
    summary, _traj = an.resimulate_trajectories([lane])
    apo = float(np.asarray(summary.apogee_altitude)[0])
    assert apo == pytest.approx(a["results"][0]["apogee_altitude"],
                                abs=0.5)
