"""Tail-estimator study: measured accuracy of P(apogee > threshold) on
real flights — plain counting vs GPD extrapolation vs importance
sampling.

Protocol: window regime (1k-step bench config). Truth = pooled plain
counting over TRUTH_SLABS x TRUTH_SLAB lanes at a threshold chosen as a
target quantile of that pool (so the plain-truth tail count is large
enough to trust). Estimators at n lanes over KEYS independent keys:

  * plain counting (the reference's only option),
  * GPD peaks-over-threshold extrapolation from the SAME plain runs
    (mc.tail — paired with counting; no tilt choice, no extra lanes),
  * importance sampling with a motor-thrust tilt (theta ~ 2/3 of the
    threshold z-score, the module-docstring rule).

Report RMS relative error over keys, mean reported stderr / CI width
(calibration), CI coverage, and effective sample sizes.

Run: PYTHONPATH=. python scripts/importance_study.py
"""
import json
import time

import numpy as np

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu.mc import (
    MonteCarloAnalyzer,
    exceedance_from_analysis,
    tail_from_analysis,
)
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

SCENE = nominal_scene(liquid_motor())
IC = InitialConditions.vertical_launch()
CFG = SimConfig(max_time=6.0)
TRUTH_SLABS = 4
TRUTH_SLAB = 16_384
KEYS = list(range(200, 208))
N_EST = 1024
QUANTILE = 99.8  # tail around p ~ 2e-3
THETA = 2.0
N_TAIL = 128  # GPD exceedances: u at p ~ 0.125, a ~60x extrapolation


def main():
    t0 = time.time()
    plain = MonteCarloAnalyzer(scene=SCENE, sim_config=CFG)
    pool = []
    for s in range(TRUTH_SLABS):
        a = plain.run_monte_carlo(IC, n_samples=TRUTH_SLAB, seed=2000 + s)
        apo = np.asarray(a["summary"].apogee_altitude)
        pool.append(apo[np.asarray(a["valid_mask"])])
        print(f"# truth slab {s}: {len(pool[-1])} valid", flush=True)
    pool = np.concatenate(pool)
    thr = float(np.percentile(pool, QUANTILE))
    p_truth = float((pool > thr).mean())
    n_pool = len(pool)
    print(f"# threshold {thr:.1f} m, truth p = {p_truth:.3e} "
          f"({int(p_truth * n_pool)} of {n_pool}; truth rel stderr "
          f"{np.sqrt((1 - p_truth) / (p_truth * n_pool)):.2%})", flush=True)

    mc_is = MonteCarloAnalyzer(scene=SCENE, sim_config=CFG,
                               importance_shift={"motor_thrust": THETA})
    acc = {label: {"errs": [], "stderrs": [], "n_effs": [], "cover": []}
           for label in ("plain", "gpd", "importance")}
    for key in KEYS:
        a = plain.run_monte_carlo(IC, n_samples=N_EST, seed=key)
        row = exceedance_from_analysis(a, "apogee_altitude", [thr])[0]
        p = row["probability"]
        acc["plain"]["errs"].append(p - p_truth)
        acc["plain"]["stderrs"].append(
            np.sqrt(max(p, 1e-12) * (1 - p) / row["n"])
        )
        acc["plain"]["n_effs"].append(p * row.get("n", N_EST))
        lo, hi = row["ci95"]
        acc["plain"]["cover"].append(lo <= p_truth <= hi)

        # GPD from the SAME plain run: paired, no extra lanes
        g = tail_from_analysis(a, "apogee_altitude", [thr],
                               n_tail=N_TAIL)["exceedance"][0]
        acc["gpd"]["errs"].append(g["probability"] - p_truth)
        lo, hi = g["ci95"]
        acc["gpd"]["stderrs"].append((hi - lo) / 3.92)  # CI -> ~stderr
        acc["gpd"]["n_effs"].append(N_TAIL)
        acc["gpd"]["cover"].append(lo <= p_truth <= hi)

        a = mc_is.run_monte_carlo(IC, n_samples=N_EST, seed=key)
        row = exceedance_from_analysis(a, "apogee_altitude", [thr])[0]
        p = row["probability"]
        acc["importance"]["errs"].append(p - p_truth)
        acc["importance"]["stderrs"].append(row["stderr"])
        acc["importance"]["n_effs"].append(row["n_eff_tail"])
        acc["importance"]["cover"].append(
            abs(p - p_truth) <= 1.96 * row["stderr"]
        )
        print(f"# key {key} done ({time.time() - t0:.0f} s)", flush=True)

    rows = {}
    for label, d in acc.items():
        rows[label] = {
            "n": N_EST,
            "rms_rel_err": float(
                np.sqrt(np.mean(np.square(d["errs"]))) / p_truth
            ),
            "mean_stderr_rel": float(np.mean(d["stderrs"]) / p_truth),
            "mean_n_eff_tail": float(np.mean(d["n_effs"])),
            "ci95_coverage": float(np.mean(d["cover"])),
        }
        print(json.dumps({"estimator": label, **rows[label]}), flush=True)

    print(json.dumps({
        "threshold_m": thr, "p_truth": p_truth, "theta": THETA,
        "keys": len(KEYS), "wall_s": round(time.time() - t0, 1),
        "rows": rows,
    }))


if __name__ == "__main__":
    main()
