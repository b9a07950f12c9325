"""Measured study: post-stratified forecast-ensemble means (mc/ensemble.py).

Two regimes, same protocol (the repo's standard study format): a K=8
synthetic forecast ensemble (GEFS-member-like spread: per-member wind
speed AND direction). For each of 8 independent keys run n=4096 lanes
and record (a) the plain mixture mean, (b) the post-stratified mean from
analysis["ensemble"]. Truth = pooled run at 16x lanes. Report RMS error
over keys for both estimators next to their reported stderrs
(calibration), plus one run's per-member exceedance table (the
operational deliverable).

* Phase 1 — window regime (max_time=6), metric apogee: the NEGATIVE
  control. Wind barely moves a 6 s apogee, so between-member variance is
  ~0 and post-stratification is expected to buy nothing.
* Phase 2 — full flights to landing (stabilized aero + tiered dt, the
  adaptive_window_study config), metric range: wind drives range by
  hundreds of meters across members, so the member-allocation noise is a
  real slice of the plain mean's variance — the regime the feature is
  for.

Run: PYTHONPATH=. python scripts/ensemble_study.py
"""

import time

import numpy as np

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu.mc import (
    MonteCarloAnalyzer,
    OutlierBounds,
    member_exceedance,
)
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache

K = 8
N = 4096
KEYS = range(8)
TRUTH_N = 65536
IC = InitialConditions.vertical_launch()


def make_ensemble():
    grid = np.linspace(0.0, 25000.0, 100)
    rngm = np.random.default_rng(123)
    speeds = np.linspace(2.0, 16.0, K)
    dirs = rngm.uniform(0.0, 2 * np.pi, K)
    members = []
    for s, d in zip(speeds, dirs):
        # power-law-ish shear like the synthesized profiles
        prof = s * (1.0 + grid / 25000.0) ** 0.6
        members.append(np.stack([prof * np.cos(d), prof * np.sin(d),
                                 np.zeros_like(grid)], axis=1))
    return grid, np.stack(members, axis=0)


def run_phase(label, an, metric, exceed_quantile=4):
    t0 = time.time()
    truth_run = an.run_monte_carlo(IC, n_samples=TRUTH_N, seed=999,
                                   lane_slab=16384)
    truth = truth_run[metric]["mean"]
    truth_ps = truth_run["ensemble"]["post_stratified"][metric]["mean"]
    print(f"\n=== {label} ({metric}) ===")
    print(f"truth (n={TRUTH_N}): plain {truth:.3f}, "
          f"post-strat {truth_ps:.3f}  [{time.time()-t0:.1f} s]")

    plain, ps, ps_se = [], [], []
    for seed in KEYS:
        t0 = time.time()
        a = an.run_monte_carlo(IC, n_samples=N, seed=seed)
        blk = a["ensemble"]["post_stratified"][metric]
        plain.append(a[metric]["mean"])
        ps.append(blk["mean"])
        ps_se.append(blk["stderr"])
        print(f"seed {seed}: plain {plain[-1]:.3f}, post-strat "
              f"{ps[-1]:.3f} +- {blk['stderr']:.3f}  "
              f"[{time.time()-t0:.1f} s]")

    plain = np.array(plain)
    ps = np.array(ps)
    rms_plain = float(np.sqrt(np.mean((plain - truth) ** 2)))
    rms_ps = float(np.sqrt(np.mean((ps - truth_ps) ** 2)))
    n_std = truth_run[metric]["std"] / np.sqrt(N)
    print(f"== {metric} mean, RMS error over {len(plain)} keys at n={N} ==")
    print(f"plain mixture  : {rms_plain:.3f} (iid stderr model {n_std:.3f})")
    print(f"post-stratified: {rms_ps:.3f} "
          f"(reported stderr {np.mean(ps_se):.3f})")
    print(f"ratio plain/ps : {rms_plain / max(rms_ps, 1e-12):.2f}x")

    # operational deliverable: which member carries the risk
    a = an.run_monte_carlo(IC, n_samples=N, seed=0)
    thr = a[metric]["percentiles"][exceed_quantile]
    (row,) = member_exceedance(a, metric, thr)
    print(f"per-member P({metric} > mixture p95 = {thr:.1f}):")
    for m in row["members"]:
        lo, hi = m["ci95"]
        print(f"  member {m['member']}: {m['probability']:.4f} "
              f"[{lo:.4f}, {hi:.4f}] (n={m['n']})")
    psx = row["post_stratified"]
    print(f"  post-stratified mixture: {psx['probability']:.4f} "
          f"+- {psx['stderr']:.4f}")


def main():
    enable_persistent_cache()
    grid, ens = make_ensemble()

    an = MonteCarloAnalyzer(
        scene=nominal_scene(liquid_motor()),
        sim_config=SimConfig(max_time=6.0),
        bounds=OutlierBounds(min_apogee=-1.0),
    )
    an.base_altitude_profile, an.base_wind_profile = grid, ens
    run_phase("window regime (negative control)", an, "apogee_altitude")

    an_full = MonteCarloAnalyzer(
        scene=nominal_scene(liquid_motor()),
        sim_config=SimConfig(energy_consistent_aero=True,
                             descent_dt_scale=16,
                             ascent_q_threshold=8000.0),
    )
    an_full.base_altitude_profile, an_full.base_wind_profile = grid, ens
    run_phase("full flights to landing", an_full, "range")


if __name__ == "__main__":
    main()
