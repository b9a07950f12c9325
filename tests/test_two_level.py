"""Two-level bias correction (``MonteCarloAnalyzer(two_level_lanes=)`` /
``mc.two_level``): a small COUPLED parity batch measures the fast-flag
integration bias and restores unbiased headline means via the MLMC
identity E[f_parity] = E[f_fast] + E[f_parity - f_fast].

No reference counterpart (the reference has one fixed dt,
`/root/reference/rocket_simulation/simulator.py:209`); this exists so the
batched engine's tiered/fast flags stay honest at lane counts where the mean's
sampling stderr drops below the integration bias.
"""

import jax
import numpy as np
import pytest

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu.mc import (
    MonteCarloAnalyzer,
    parity_twin,
    two_level_block,
)
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene

SCENE = nominal_scene(liquid_motor())
IC = InitialConditions.vertical_launch()
METRICS = ("apogee_altitude", "range", "flight_time")
# wind_eval_per_step is the cheapest fast flag to exercise on a short CPU
# window (per-step vs per-stage wind: small but nonzero deltas everywhere)
CFG_FAST = SimConfig(max_time=6.0, wind_eval_per_step=True)
N = 64


def test_parity_twin_resets_only_fast_flags():
    cfg = SimConfig(max_time=6.0, energy_consistent_aero=True,
                    descent_dt_scale=16, ascent_q_threshold=8000.0,
                    wind_eval_per_step=True, wind_table_bf16=True)
    twin = parity_twin(cfg)
    assert twin.descent_dt_scale == 1
    assert twin.ascent_q_threshold == 0.0
    assert not twin.wind_eval_per_step
    assert not twin.wind_table_bf16
    # deliberate-physics / non-speed fields survive untouched
    assert twin.max_time == 6.0
    assert twin.energy_consistent_aero
    # r5: the midpoint integrator is a fast flag — its flight-time bias is
    # exactly what the correction repairs
    assert parity_twin(SimConfig(max_time=6.0, integrator="rk2")).integrator \
        == "rk4"


def test_validation():
    with pytest.raises(ValueError, match="fast flag"):
        MonteCarloAnalyzer(scene=SCENE, two_level_lanes=N)
    with pytest.raises(ValueError, match=">= 0"):
        MonteCarloAnalyzer(scene=SCENE, sim_config=CFG_FAST,
                           two_level_lanes=-1)
    with pytest.raises(ValueError, match="exclusive"):
        MonteCarloAnalyzer(scene=SCENE, sim_config=CFG_FAST,
                           two_level_lanes=N,
                           importance_shift={"motor_thrust": 1.0})
    with pytest.raises(ValueError, match="fast flag"):
        two_level_block(SCENE, IC, SimConfig(), 8, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def fast_run():
    an = MonteCarloAnalyzer(scene=SCENE, sim_config=CFG_FAST,
                            two_level_lanes=N, persistent_cache=False)
    return an.run_monte_carlo(IC, n_samples=N, seed=3)


def test_corrected_mean_matches_coupled_parity_run(fast_run):
    """corrected_mean == fast mean + measured bias, and it lands within
    the coupled-difference noise of a PARITY analyzer run at the same
    seed/n — the strongest statement a small CPU test can make (the two
    runs share dispersion draws, so their mean gap is itself an estimate
    of the same bias, with the same per-lane-delta stderr)."""
    a = fast_run
    blk = a["two_level"]
    assert blk["n_lanes"] == N
    assert blk["config_delta"] == {"wind_eval_per_step": [True, False]}
    assert blk["mismatched_validity"] == 0

    p = MonteCarloAnalyzer(
        scene=SCENE, sim_config=parity_twin(CFG_FAST),
        persistent_cache=False,
    ).run_monte_carlo(IC, n_samples=N, seed=3)
    # all lanes valid in both -> the coupling argument below is exact
    assert a["n_samples"] == N and p["n_samples"] == N
    assert blk["n_coupled"] == N

    for m in METRICS:
        b = blk[m]
        assert np.isfinite(b["bias"]) and b["bias_stderr"] >= 0.0
        assert b["abs_max_delta"] >= abs(b["bias"])
        assert b["population_sigma"] >= 0.0  # parity-leg spread, for the
        # bias-crossover estimate (scripts/two_level_check.py)
        np.testing.assert_allclose(
            b["corrected_mean"], a[m]["mean"] + b["bias"], rtol=1e-12,
            err_msg=m,
        )
        assert b["corrected_stderr"] >= b["bias_stderr"]
        tol = 6.0 * b["bias_stderr"] * np.sqrt(2.0) + 1e-9
        assert abs(b["corrected_mean"] - p[m]["mean"]) <= tol, m


def test_non_iid_main_run_omits_corrected_stderr(tmp_path):
    """Antithetic lanes are pairwise dependent, so the main run's
    std/sqrt(n) is not its mean's sampling error — the corrected MEAN
    stays valid but the stderr must be omitted with a note, not silently
    misstated (found by review, round 3). The report must render the
    None cleanly."""
    an = MonteCarloAnalyzer(scene=SCENE, sim_config=CFG_FAST,
                            two_level_lanes=32, antithetic=True,
                            persistent_cache=False)
    a = an.run_monte_carlo(IC, n_samples=64, seed=5)
    blk = a["two_level"]
    assert "not i.i.d." in blk["stderr_note"]
    for m in METRICS:
        assert np.isfinite(blk[m]["corrected_mean"])
        assert blk[m]["corrected_stderr"] is None
        assert np.isfinite(blk[m]["bias_stderr"])  # the correction's own
        # stderr is from a plain prng batch and survives

    from erpl_monte_carlo_sim_tpu.reporting import save_report

    save_report(a, str(tmp_path))
    txt = (tmp_path / "monte_carlo_report.txt").read_text()
    assert "stderr n/a: non-i.i.d. sampler" in txt


def test_two_level_in_slabbed_run():
    an = MonteCarloAnalyzer(scene=SCENE, sim_config=CFG_FAST,
                            two_level_lanes=32, persistent_cache=False)
    a = an.run_monte_carlo(IC, n_samples=96, lane_slab=32, seed=1)
    blk = a["two_level"]
    assert blk["n_lanes"] == 32
    for m in METRICS:
        assert np.isfinite(blk[m]["corrected_mean"])
        np.testing.assert_allclose(
            blk[m]["corrected_mean"], a[m]["mean"] + blk[m]["bias"],
            rtol=1e-12, err_msg=m,
        )


def test_report_carries_two_level(fast_run, tmp_path):
    from erpl_monte_carlo_sim_tpu.reporting import save_report

    report = save_report(fast_run, str(tmp_path))
    assert "two_level" in report
    txt = (tmp_path / "monte_carlo_report.txt").read_text()
    assert "Two-Level Bias Correction" in txt
    assert "corrected mean" in txt
    blk = report["two_level"]["apogee_altitude"]
    assert f"{blk['corrected_mean']:.2f}" in txt
