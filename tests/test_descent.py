"""Tiered descent/quiet-coast timestep (SimConfig.descent_dt_scale,
ascent_q_threshold): opt-in fast flags for full-flight latency.

The reference integrates the whole flight at a fixed 5 ms RK4 step
(`/root/reference/rocket_simulation/simulator.py:209`); parity mode here
does the same. The tiered flags coarsen only dynamically-quiet phases
(ballistic fall after the apogee transient, canopy descent after the
opening shock, low-q coast ascent), per lane. These tests pin:

  * accuracy: apogee / landing / flight-time deltas orders of magnitude
    below the Monte Carlo dispersion sigmas,
  * the stiff-transient guards (chute opening shock integrates at fine dt),
  * the step-count win (41k -> ~10k steps for the nominal flight),
  * that the stacked-vector equivalence path refuses the flag instead of
    silently ignoring it.
"""

import jax
import numpy as np
import pytest

from erpl_monte_carlo_sim_tpu.engine import (
    InitialConditions,
    SimConfig,
    simulate_summary,
)
from erpl_monte_carlo_sim_tpu.engine.batch import simulate_summary_batch
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene

TIERED = dict(descent_dt_scale=8, ascent_q_threshold=8000.0)


@pytest.fixture(scope="module")
def dispersed_runs():
    """One stabilized dispersed batch, parity vs tiered (full flights)."""
    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    scene_b, ic_b, _ = sample_dispersions(
        jax.random.PRNGKey(7), scene, ic, n=8
    )
    parity = simulate_summary_batch(
        scene_b, ic_b, SimConfig(energy_consistent_aero=True)
    )
    tiered = simulate_summary_batch(
        scene_b, ic_b, SimConfig(energy_consistent_aero=True, **TIERED)
    )
    return parity, tiered


def test_tiered_dt_accuracy_dispersed(dispersed_runs):
    parity, tiered = dispersed_runs
    apo_p = np.asarray(parity.apogee_altitude)
    apo_t = np.asarray(tiered.apogee_altitude)
    # dispersion sigma is ~900 m on this batch; the integration-tier delta
    # must be invisible against it (measured max 0.37 m over 32 lanes)
    np.testing.assert_allclose(apo_t, apo_p, atol=1.5)
    land_p = np.asarray(parity.landing_position)[:, :2]
    land_t = np.asarray(tiered.landing_position)[:, :2]
    assert np.linalg.norm(land_t - land_p, axis=1).max() < 10.0
    ft_p = np.asarray(parity.flight_time)
    ft_t = np.asarray(tiered.flight_time)
    assert np.abs(ft_t - ft_p).max() < 0.5


def test_tiered_dt_same_event_outcomes(dispersed_runs):
    parity, tiered = dispersed_runs
    np.testing.assert_array_equal(
        np.asarray(tiered.parachute_deployed),
        np.asarray(parity.parachute_deployed),
    )
    np.testing.assert_array_equal(
        np.asarray(tiered.diverged), np.asarray(parity.diverged)
    )
    # every lane must still land (ground termination, not max_time runout)
    assert (np.asarray(tiered.flight_time) < 299.0).all()


def test_tiered_dt_step_reduction(dispersed_runs):
    parity, tiered = dispersed_runs
    n_p = np.asarray(parity.n_steps).astype(float)
    n_t = np.asarray(tiered.n_steps).astype(float)
    # the whole point: ~4x fewer loop iterations (measured 25.5k -> 6.4k
    # median on this config); require at least 2.5x to catch regressions
    assert np.median(n_p) / np.median(n_t) > 2.5


def test_stacked_path_refuses_tiered_flag():
    """EVERY stacked-vector entry point must refuse the tiered flags rather
    than silently integrating parity physics under a tiered config."""
    from erpl_monte_carlo_sim_tpu.engine import simulate_flight
    from erpl_monte_carlo_sim_tpu.engine.simulate import simulate_batch_chunked

    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    cfg = SimConfig(descent_dt_scale=8)
    with pytest.raises(ValueError, match="component path"):
        simulate_summary(scene, ic, cfg)
    with pytest.raises(ValueError, match="component path"):
        simulate_flight(scene, ic, cfg)
    ic_b = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (2,) + np.shape(x)).copy(), ic
    )
    with pytest.raises(ValueError, match="component path"):
        simulate_batch_chunked(scene, ic_b, cfg)


def test_tiered_dt_low_apogee_guard():
    """Lanes whose peak stays below apogee_min_altitude keep apod==0 through
    their whole DESCENT; the quiet-coast gate must still fine-step the
    deploy-altitude approach and the chute latch (regression: without the
    para==0/clear guards the latch integrated at 16x dt — flight time off
    by 0.16 s at propellant_mass=7)."""
    from erpl_monte_carlo_sim_tpu.engine.batch import simulate_summary_batch
    from erpl_monte_carlo_sim_tpu.models.rocket import RocketParams

    ic1 = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (1,) + np.shape(x)).copy(),
        InitialConditions.vertical_launch(),
    )
    fast = SimConfig(energy_consistent_aero=True, descent_dt_scale=16,
                     ascent_q_threshold=8000.0)
    parity = SimConfig(energy_consistent_aero=True)
    for pm in (5.0, 7.0):  # apogee ~476 m / ~880 m, both below the 1 km gate
        scene = nominal_scene(liquid_motor(propellant_mass=pm))
        scene = scene.replace(rocket=RocketParams.create(propellant_mass=pm))
        p = simulate_summary_batch(scene, ic1, parity)
        t = simulate_summary_batch(scene, ic1, fast)
        assert float(p.apogee_altitude[0]) < 1000.0  # scenario really is sub-gate
        assert not bool(t.diverged[0]) and not bool(p.diverged[0])
        assert bool(t.parachute_deployed[0]) == bool(p.parachute_deployed[0])
        np.testing.assert_allclose(
            float(t.apogee_altitude[0]), float(p.apogee_altitude[0]), atol=0.05
        )
        # flight time within one coarse quantum (pre-guard: 0.16 s off)
        assert abs(float(t.flight_time[0]) - float(p.flight_time[0])) < 0.1
        # tiering must still engage for these lanes (guard isn't "always fine")
        assert int(t.n_steps[0]) < int(p.n_steps[0]) / 3


@pytest.mark.slow
def test_resimulate_runs_tiered_cfg_exactly():
    """Trajectory re-simulation runs the SAME SimConfig the MC ran (tiered
    flags included, on the component recorder) — re-simulated summaries
    reproduce the MC metrics to float noise, not to a tiered-vs-parity
    accuracy bound. This is the reference's one-engine guarantee
    (`simulator.py:208-293`: it records while it integrates)."""
    from erpl_monte_carlo_sim_tpu.mc.analyzer import MonteCarloAnalyzer

    an = MonteCarloAnalyzer(
        scene=nominal_scene(liquid_motor()),
        sim_config=SimConfig(max_time=8.0, descent_dt_scale=16,
                             ascent_q_threshold=8000.0),
    )
    a = an.run_monte_carlo(InitialConditions.vertical_launch(), n_samples=4)
    summary, traj = an.resimulate_trajectories([0, 1])
    assert np.asarray(traj.position).shape[0] == 2
    for name in ("apogee_altitude", "range", "flight_time", "max_speed"):
        np.testing.assert_allclose(
            np.asarray(getattr(summary, name)),
            np.asarray(getattr(a["summary"], name))[:2], rtol=1e-12,
            err_msg=name,
        )
    # (tiered-step heterogeneity in the recorded trajectory is pinned on a
    # full flight in tests/test_trajectory_batch.py — this 8 s window ends
    # before any lane reaches a quiet phase)


def test_parity_path_unchanged_by_flag_default():
    """descent_dt_scale=1 must not add carries: identical results to the
    pinned goldens is covered elsewhere; here we pin that the tiered flags
    default off."""
    cfg = SimConfig()
    assert cfg.descent_dt_scale == 1
    assert cfg.ascent_q_threshold == 0.0
