"""End-to-end flight regression vs measured reference behavior.

Golden values were produced by EXECUTING the reference simulator
(scripts/gen_golden.py). BASELINE.json requires <0.1% on apogee/rail-exit
stats; f64 matches far tighter, f32 (the device dtype) is also checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from erpl_monte_carlo_sim_tpu.engine import (
    InitialConditions,
    SimConfig,
    simulate_flight,
    simulate_summary,
)
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene, solid_motor

# ~5-min core-correctness tier (CLAUDE.md): goldens + engine basics.
pytestmark = pytest.mark.smoke

CFG = SimConfig()


def _check_summary(s, g, rel=5e-4):
    assert float(s.apogee_altitude) == pytest.approx(g["apogee_altitude"], rel=rel)
    assert float(s.apogee_time) == pytest.approx(g["apogee_time"], rel=1e-2)
    assert float(s.range) == pytest.approx(g["range"], rel=5e-3)
    assert float(s.flight_time) == pytest.approx(g["flight_time"], rel=1e-2)
    assert float(s.rail.rail_exit_time) == pytest.approx(g["rail_exit_time"], abs=0.011)
    assert float(s.rail.rail_exit_speed) == pytest.approx(g["rail_exit_speed"], rel=1e-4)
    assert float(s.rail.rail_exit_angle_of_attack) == pytest.approx(
        g["rail_exit_aoa"], abs=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(s.rail.rail_exit_position), g["rail_exit_position"], rtol=1e-3,
        atol=1e-6,
    )
    assert not bool(s.diverged)


@pytest.fixture(scope="module")
def summary_fn():
    return jax.jit(simulate_summary, static_argnums=2)


def test_liquid_nominal_f64(summary_fn, golden_flight_liquid):
    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    s = summary_fn(scene, ic, CFG)
    _check_summary(s, golden_flight_liquid, rel=1e-5)
    assert abs(int(s.n_steps) - (golden_flight_liquid["n_steps"] - 1)) <= 20


def test_solid_nominal_f64(summary_fn, golden_flight_solid):
    scene = nominal_scene(solid_motor())
    ic = InitialConditions.vertical_launch()
    s = summary_fn(scene, ic, CFG)
    _check_summary(s, golden_flight_solid, rel=5e-4)


def test_liquid_nominal_f32(summary_fn, golden_flight_liquid):
    """float32 — the device execution dtype — must hold the <0.1% target."""
    scene = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float32)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
        nominal_scene(liquid_motor()),
    )
    ic = InitialConditions.vertical_launch(dtype=jnp.float32)
    s = summary_fn(scene, ic, CFG)
    assert float(s.apogee_altitude) == pytest.approx(
        golden_flight_liquid["apogee_altitude"], rel=1e-3
    )
    assert float(s.range) == pytest.approx(golden_flight_liquid["range"], rel=5e-3)


def test_vmap_consistency(summary_fn, golden_flight_liquid):
    """A vmapped batch of identical lanes must reproduce the single flight —
    the reference's per-process isolation, without processes."""
    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    single = summary_fn(scene, ic, CFG)

    B = 3
    bscene = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + jnp.shape(x)), scene)
    bic = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), ic)
    batched = jax.jit(
        jax.vmap(simulate_summary, in_axes=(0, 0, None)), static_argnums=2
    )(bscene, bic, CFG)

    for b in range(B):
        assert float(batched.apogee_altitude[b]) == pytest.approx(
            float(single.apogee_altitude), rel=1e-10
        )
        assert float(batched.flight_time[b]) == pytest.approx(
            float(single.flight_time), rel=1e-10
        )


def test_trajectory_mode_matches_summary(golden_flight_liquid):
    """simulate_flight (scan + mask) and simulate_summary (while_loop) must
    agree — two loop constructs, one physics."""
    cfg = SimConfig(max_time=120.0)  # enough to reach apogee; keeps scan small
    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    s1 = jax.jit(simulate_summary, static_argnums=2)(scene, ic, cfg)
    s2, traj = jax.jit(simulate_flight, static_argnums=2)(scene, ic, cfg)
    assert float(s1.apogee_altitude) == pytest.approx(
        float(s2.apogee_altitude), rel=1e-12
    )
    assert int(s1.n_steps) == int(s2.n_steps)

    # Trajectory content: apogee from the recorded altitudes matches, and the
    # golden probe points match the reference's recorded trajectory.
    valid = np.asarray(traj.valid)
    alt = np.asarray(traj.position[:, 2])
    assert alt[valid].max() == pytest.approx(float(s1.apogee_altitude), rel=1e-12)

    t = np.asarray(traj.time)
    for probe in golden_flight_liquid["probes"]:
        if probe["t"] > 115.0:
            continue
        i = int(np.argmin(np.abs(t[valid] - probe["t"])))
        assert alt[valid][i] == pytest.approx(probe["alt"], rel=2e-4), probe["t"]
        spd = np.asarray(traj.derived["speed"])[valid][i]
        assert spd == pytest.approx(probe["speed"], rel=2e-3, abs=0.2), probe["t"]
        mass = np.asarray(traj.derived["mass"])[valid][i]
        assert mass == pytest.approx(probe["mass"], rel=1e-4)


def test_parachute_descent(golden_flight_liquid):
    """Below 500 m descending, the chute must cap the descent rate near the
    equilibrium speed sqrt(2 m g / (rho Cd A)) ~ 7.8 m/s."""
    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    s = jax.jit(simulate_summary, static_argnums=2)(scene, ic, CFG)
    assert bool(s.parachute_deployed)
    vz_final = float(s.final_velocity[2])
    m = 113.4
    rho = 1.2
    v_eq = np.sqrt(2 * m * 9.81 / (rho * 2.0 * 15.0))
    assert vz_final == pytest.approx(-v_eq, rel=0.15)
    # Lands at ground threshold
    assert float(s.landing_position[2]) == pytest.approx(0.5, abs=0.1)


def test_divergence_guard():
    """A lane driven unphysical must flag diverged=True and terminate early
    instead of poisoning the batch (engine improvement over the reference)."""
    scene = nominal_scene(liquid_motor())
    # Absurd thrust scale -> escape-velocity style trajectory -> 100 km cutoff
    scene = scene.replace(motor=scene.motor.replace(thrust_scale=jnp.float64(50.0)))
    ic = InitialConditions.vertical_launch()
    s = jax.jit(simulate_summary, static_argnums=2)(scene, ic, CFG)
    # Either the 100 km guard or the nonfinite guard must have fired well
    # before max_time.
    assert float(s.flight_time) < 290.0


def test_solid_trajectory_probes(golden_flight_solid):
    """Probe-level trajectory parity for the solid motor (thrust-curve
    interpolation path) against the executed reference."""
    cfg = SimConfig(max_time=80.0)  # through burnout + well past apogee
    scene = nominal_scene(solid_motor())
    ic = InitialConditions.vertical_launch()
    _, traj = jax.jit(simulate_flight, static_argnums=2)(scene, ic, cfg)
    valid = np.asarray(traj.valid)
    t = np.asarray(traj.time)[valid]
    alt = np.asarray(traj.position[:, 2])[valid]
    spd = np.asarray(traj.derived["speed"])[valid]
    mass = np.asarray(traj.derived["mass"])[valid]
    thrust = np.asarray(traj.derived["thrust"])[valid]
    for probe in golden_flight_solid["probes"]:
        if probe["t"] > 75.0:
            continue
        i = int(np.argmin(np.abs(t - probe["t"])))
        assert alt[i] == pytest.approx(probe["alt"], rel=2e-3), probe["t"]
        assert spd[i] == pytest.approx(probe["speed"], rel=3e-3, abs=0.3), probe["t"]
        assert mass[i] == pytest.approx(probe["mass"], rel=1e-3), probe["t"]
        if abs(probe["t"] - 15.0) > 0.02:  # burnout step-discontinuity edge
            assert thrust[i] == pytest.approx(
                probe["thrust"], rel=1e-3, abs=2.0
            ), probe["t"]
