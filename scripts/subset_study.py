"""Subset-simulation deep-tail study (NOTES.md protocol).

Question: does MonteCarloAnalyzer.subset_tail reproduce directly
countable exceedance probabilities, and what does it say in the regime
counting cannot reach — and how does that compare to GPD extrapolation
(mc.tail), the other deep-tail tool in the box?

Protocol (window regime = the 1k-step bench config, apogee; plus one
full-flight range tail):
  1. truth run: 1,048,576 prng lanes -> exact exceedance counts with
     Wilson CIs at thresholds T_a (p ~ 1e-3) and T_b (p ~ 1e-5), GPD fit
     for the extrapolated regime.
  2. subset_tail at T_a, T_b, and a deep T_c (GPD-implied p ~ 1e-8),
     4 seeds each: per-seed estimate + reported cov; the seed spread of
     log10(p) should be consistent with the reported cov.
  3. full flight (fast flags): P(range > T) at a GPD-extrapolated
     ~1e-6 threshold, 2 seeds.

Run: PYTHONPATH=. python scripts/subset_study.py
"""
import json
import time

import numpy as np

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer, exceedance
from erpl_monte_carlo_sim_tpu.mc.tail import tail_from_analysis
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

SCENE = nominal_scene(liquid_motor())
IC = InitialConditions.vertical_launch()
WINDOW = SimConfig(max_time=6.0)
FULL = SimConfig(energy_consistent_aero=True, descent_dt_scale=16,
                 ascent_q_threshold=8000.0)
N_TRUTH = 1_048_576
SEEDS = (0, 1, 2, 3)


def subset_runs(mc, metric, T, seeds, **kw):
    out = []
    for s in seeds:
        t0 = time.time()
        r = mc.subset_tail(IC, metric, T, seed=s, **kw)
        r["wall_s"] = round(time.time() - t0, 2)
        out.append(r)
        print(f"  seed {s}: p={r['probability']:.3e} "
              f"(|valid {r['probability_given_valid']:.3e}) "
              f"cov={r['cov']:.2f} levels={r['n_levels']} "
              f"sims={r['n_sims']} wall={r['wall_s']}s "
              f"stalled={r['stalled']}")
    return out


def spread_check(runs):
    logs = [r["log10_probability"] for r in runs
            if np.isfinite(r["log10_probability"])]
    covs = [r["cov"] for r in runs if np.isfinite(r["cov"])]
    if len(logs) < 2:
        return {}
    return {
        "mean_log10": round(float(np.mean(logs)), 3),
        "seed_std_log10": round(float(np.std(logs, ddof=1)), 3),
        "reported_cov_log10": round(float(np.mean(covs)) / np.log(10), 3),
    }


def main():
    report = {}

    # ---- window regime truth
    mc = MonteCarloAnalyzer(scene=SCENE, sim_config=WINDOW)
    t0 = time.time()
    truth = mc.run_monte_carlo(IC, n_samples=N_TRUTH, seed=100,
                               lane_slab=262_144)
    print(f"truth run: {N_TRUTH} lanes in {time.time() - t0:.1f} s")
    vals = np.concatenate([np.asarray(v, np.float64)
                           for v in [truth["metrics"]["apogee_altitude"]]])
    valid = np.asarray(truth["valid_mask"])
    v = vals[valid & np.isfinite(vals)]
    T_a = float(np.quantile(v, 1 - 1e-3))
    T_b = float(np.quantile(v, 1 - 1e-5))
    direct = exceedance(vals, valid, [T_a, T_b])
    print("direct:", json.dumps(direct))
    report["direct"] = direct

    # GPD fit on the truth run; find a deep threshold at ~1e-8
    grid = np.linspace(T_b, T_b + 3 * (T_b - T_a), 60)
    gpd = tail_from_analysis(truth, "apogee_altitude", grid)
    probs = np.asarray([b["probability"] for b in gpd["exceedance"]],
                       np.float64)
    idx = int(np.argmin(np.abs(np.log10(np.maximum(probs, 1e-300)) + 8)))
    T_c = float(grid[idx])
    report["gpd"] = {
        "fit": gpd["fit"],
        "T_b_prob": float(np.interp(T_b, grid, probs)),
        "T_c": T_c, "T_c_prob": float(probs[idx]),
    }
    print(f"GPD: p(T_b={T_b:.2f}) = {report['gpd']['T_b_prob']:.3e}; "
          f"T_c = {T_c:.2f} at p ~ {probs[idx]:.3e}")

    # ---- subset at the three thresholds
    for name, T in (("T_a", T_a), ("T_b", T_b), ("T_c", T_c)):
        print(f"subset @ {name} = {T:.2f}")
        runs = subset_runs(mc, "apogee_altitude", T, SEEDS,
                           n_per_level=2048, p0=0.125)
        report[f"subset_{name}"] = {
            "threshold": T,
            "runs": [{k: r[k] for k in
                      ("probability", "probability_given_valid", "cov",
                       "n_levels", "n_sims", "wall_s", "stalled", "seed")}
                     for r in runs],
            "spread": spread_check(runs),
        }

    # ---- full-flight range tail (fast flags), GPD-guided deep threshold
    mcf = MonteCarloAnalyzer(scene=SCENE, sim_config=FULL)
    t0 = time.time()
    tf = mcf.run_monte_carlo(IC, n_samples=65_536, seed=200,
                             lane_slab=65_536)
    print(f"full truth: 65536 lanes in {time.time() - t0:.1f} s")
    rv = np.asarray(tf["summary"].range, np.float64) \
        if tf.get("summary") is not None \
        else np.asarray(tf["metrics"]["range"], np.float64)
    rvalid = np.asarray(tf["valid_mask"])
    rr = rv[rvalid & np.isfinite(rv)]
    R_hi = float(np.quantile(rr, 1 - 3e-4))
    rgrid = np.linspace(R_hi, R_hi + 2 * (R_hi - float(np.quantile(
        rr, 0.99))), 60)
    rgpd = tail_from_analysis(tf, "range", rgrid)
    rprobs = np.asarray([b["probability"] for b in rgpd["exceedance"]],
                        np.float64)
    ridx = int(np.argmin(np.abs(np.log10(np.maximum(rprobs, 1e-300)) + 6)))
    R_c = float(rgrid[ridx])
    report["full_range"] = {
        "R_c": R_c, "gpd_prob": float(rprobs[ridx]),
        "direct_at_Rhi": exceedance(rv, rvalid, [R_hi]),
    }
    print(f"full-flight range: R_c = {R_c:.1f} m at GPD p ~ "
          f"{rprobs[ridx]:.3e}")
    runs = subset_runs(mcf, "range", R_c, SEEDS[:2],
                       n_per_level=2048, p0=0.125)
    report["subset_full_range"] = {
        "threshold": R_c,
        "runs": [{k: r[k] for k in
                  ("probability", "probability_given_valid", "cov",
                   "n_levels", "n_sims", "wall_s", "stalled", "seed")}
                 for r in runs],
        "spread": spread_check(runs),
    }

    with open("/tmp/subset_study.json", "w") as f:
        json.dump(report, f, indent=1, default=float)
    print("wrote /tmp/subset_study.json")


if __name__ == "__main__":
    main()
