"""Component-form batch path (engine/batch.py) vs the vmapped reference path.

``simulate_summary_batch`` runs the SAME physics through a structurally
different program (flat [B] carries, lanes-minor wind tables) — these tests
pin lane-for-lane equivalence with ``jit(vmap(simulate_summary))`` on fully
dispersed batches, including the per-lane stochastic wind tables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from erpl_monte_carlo_sim_tpu.engine import (
    InitialConditions,
    SimConfig,
    simulate_summary,
    simulate_summary_batch,
)
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions, scene_in_axes
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene, solid_motor


def _compare(scene_b, ic_b, axes, cfg, rtol=5e-7):
    ref = jax.jit(
        jax.vmap(simulate_summary, in_axes=(axes, 0, None)), static_argnums=2
    )(scene_b, ic_b, cfg)
    got = simulate_summary_batch(scene_b, ic_b, cfg)

    ref_l = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_l = jax.tree.leaves(got)
    assert len(ref_l) == len(got_l)
    for (path, a), b in zip(ref_l, got_l):
        a = np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(
                b, a, rtol=rtol, atol=1e-6,
                err_msg=f"mismatch at {jax.tree_util.keystr(path)}",
            )
        else:
            np.testing.assert_array_equal(
                b, a, err_msg=f"mismatch at {jax.tree_util.keystr(path)}"
            )


@pytest.mark.parametrize("motor", [
    "liquid",
    pytest.param("solid", marks=pytest.mark.slow),
])
def test_batch_matches_vmap_dispersed(motor):
    scene = nominal_scene(liquid_motor() if motor == "liquid" else solid_motor())
    ic = InitialConditions.vertical_launch()
    scene_b, ic_b, _ = sample_dispersions(
        jax.random.PRNGKey(7), scene, ic, n=32
    )
    axes = scene_in_axes(scene, scene_b)
    # ~1k-step window: rail + boost + early coast, per-lane wind active
    _compare(scene_b, ic_b, axes, SimConfig(max_time=6.0))


@pytest.mark.slow
def test_batch_matches_vmap_full_flight_events():
    # Full flights to landing: parachute latch, coast timeout, ground stop.
    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    scene_b, ic_b, _ = sample_dispersions(
        jax.random.PRNGKey(3), scene, ic, n=8
    )
    axes = scene_in_axes(scene, scene_b)
    _compare(scene_b, ic_b, axes,
             SimConfig(energy_consistent_aero=True), rtol=2e-5)


@pytest.mark.slow
def test_batch_matches_vmap_wind_eval_per_step():
    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    scene_b, ic_b, _ = sample_dispersions(
        jax.random.PRNGKey(11), scene, ic, n=16
    )
    axes = scene_in_axes(scene, scene_b)
    _compare(scene_b, ic_b, axes,
             SimConfig(max_time=6.0, wind_eval_per_step=True))


@pytest.mark.slow
def test_batch_bf16_wind_stats_drift_below_noise():
    # SimConfig.wind_table_bf16 rounds the stored wind table (~0.4% rel) —
    # far below the AR(1) turbulence sigma (~2 m/s). Pin that the summary
    # statistics barely move vs f32 storage.
    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    scene_b, ic_b, _ = sample_dispersions(
        jax.random.PRNGKey(2), scene, ic, n=256
    )
    cfg32 = SimConfig(max_time=6.0)
    cfg16 = SimConfig(max_time=6.0, wind_table_bf16=True)
    a = simulate_summary_batch(scene_b, ic_b, cfg32)
    b = simulate_summary_batch(scene_b, ic_b, cfg16)
    apo_a = np.asarray(a.apogee_altitude)
    apo_b = np.asarray(b.apogee_altitude)
    assert abs(apo_a.mean() - apo_b.mean()) < 0.5  # m; sigma is ~50 m
    assert abs(apo_a.std() - apo_b.std()) / apo_a.std() < 0.02
    np.testing.assert_array_equal(np.asarray(a.diverged), np.asarray(b.diverged))


def test_batch_shared_wind_table():
    # Shared [N,3] wind table (no per-lane dispersion) broadcasts correctly.
    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    n = 4
    ic_b = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), ic)
    axes = jax.tree.map(lambda _: None, scene)
    ref = jax.jit(
        jax.vmap(simulate_summary, in_axes=(None, 0, None)), static_argnums=2
    )(scene, ic_b, SimConfig(max_time=4.0))
    got = simulate_summary_batch(scene, ic_b, SimConfig(max_time=4.0))
    np.testing.assert_allclose(
        np.asarray(got.apogee_altitude), np.asarray(ref.apogee_altitude),
        rtol=5e-7,
    )
    np.testing.assert_allclose(
        np.asarray(got.rail.rail_exit_speed),
        np.asarray(ref.rail.rail_exit_speed), rtol=5e-7,
    )


def test_nan_lane_strict_parity_is_rejected_by_filter():
    """Regression (round-3 review): safe_sqrt must PROPAGATE NaN, not
    launder it to 0.0. In strict-parity mode (terminate_nonfinite=False) a
    lane whose state goes NaN runs to max_steps with its apogee frozen at
    the last finite value; the outlier filter only sees apogee/range/
    flight_time, so range must come out NaN for the filter to reject the
    lane — exactly what the reference's plain np.sqrt does."""
    from erpl_monte_carlo_sim_tpu.mc import outlier_mask

    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    n = 2
    ic_b = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), ic)
    # lane 0 healthy, lane 1 NaN velocity from the start
    vel = np.asarray(ic_b.velocity).copy()
    vel[1] = np.nan
    ic_b = ic_b.replace(velocity=jnp.asarray(vel))
    cfg = SimConfig(max_time=5.0, terminate_nonfinite=False)
    s = simulate_summary_batch(scene, ic_b, cfg)
    assert np.isfinite(np.asarray(s.range)[0])
    assert not np.isfinite(np.asarray(s.range)[1]), (
        "NaN lane's range was laundered to a finite value"
    )
    assert not np.isfinite(np.asarray(s.max_speed)[1])
    valid, _ = outlier_mask(s)
    assert bool(np.asarray(valid)[0])
    assert not bool(np.asarray(valid)[1]), "NaN lane passed the filter"


def test_rk2_integrator_accuracy_and_stability():
    """SimConfig(integrator="rk2") — the fast-mode lever that halves the
    dynamics evaluations per step: midpoint-method apogees on
    a dispersed windowed batch must sit orders of magnitude below the
    dispersion sigma from RK4's, and a FULL nominal flight must stay
    stable through chute opening and land with headline metrics close to
    parity (flight_time is the loosest — the chute descent phase
    integrates differently at O(dt^3))."""
    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    scene_b, ic_b, _ = sample_dispersions(
        jax.random.PRNGKey(0), scene, ic, n=256)
    r4 = simulate_summary_batch(scene_b, ic_b, SimConfig(max_time=6.0))
    r2 = simulate_summary_batch(
        scene_b, ic_b, SimConfig(max_time=6.0, integrator="rk2"))
    a4 = np.asarray(r4.apogee_altitude, np.float64)
    a2 = np.asarray(r2.apogee_altitude, np.float64)
    m = np.isfinite(a4) & np.isfinite(a2)
    assert m.sum() > 200
    sigma = a4[m].std()
    assert np.abs(a2[m] - a4[m]).max() < 1e-3 * sigma

    ic1 = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (1,) + x.shape), ic)
    s4 = simulate_summary_batch(scene, ic1, SimConfig())
    s2 = simulate_summary_batch(scene, ic1, SimConfig(integrator="rk2"))
    assert not bool(np.asarray(s2.diverged)[0])
    assert bool(np.asarray(s2.parachute_deployed)[0])
    apo4 = float(np.asarray(s4.apogee_altitude)[0])
    apo2 = float(np.asarray(s2.apogee_altitude)[0])
    assert apo2 == pytest.approx(apo4, rel=5e-4)  # measured 0.014%
    assert float(np.asarray(s2.range)[0]) == pytest.approx(
        float(np.asarray(s4.range)[0]), rel=0.05)
    assert float(np.asarray(s2.flight_time)[0]) == pytest.approx(
        float(np.asarray(s4.flight_time)[0]), rel=0.10)
