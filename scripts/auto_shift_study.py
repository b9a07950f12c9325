"""Auto-tilt study: does the design-point tilt (mc.importance.auto_shift)
match the hand-tuned one — with no tuning?

Protocol mirrors scripts/importance_study.py (window regime, pooled plain
truth at a ~2e-3 tail): estimators at n=1024 over 8 keys are

  * plain counting,
  * the hand tilt the original study used (motor_thrust = 2.0, chosen by
    the module-docstring rule from the threshold's KNOWN z-score),
  * the auto tilt: one reverse pass at nominal -> design-point direction
    over ALL tiltable channels, scaled by frac=0.75 — no human input
    beyond (metric, threshold).

Report per estimator: RMS relative error over keys, mean reported stderr
(calibration), CI coverage, mean n_eff_tail; plus what auto chose.

Run: PYTHONPATH=. python -u scripts/auto_shift_study.py
"""
import json
import time

import numpy as np

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu.mc import (
    MonteCarloAnalyzer,
    auto_shift,
    exceedance_from_analysis,
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
QUANTILE = 99.8
HAND = {"motor_thrust": 2.0}


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
    print(f"# threshold {thr:.1f} m, truth p = {p_truth:.3e}", flush=True)

    t1 = time.time()
    shift, info = auto_shift(SCENE, IC, CFG, "apogee_altitude", thr)
    print(json.dumps({"auto_shift": info,
                      "grad_wall_s": round(time.time() - t1, 1)}),
          flush=True)

    analyzers = {
        "plain": plain,
        "hand_tilt": MonteCarloAnalyzer(scene=SCENE, sim_config=CFG,
                                        importance_shift=HAND),
        "auto_tilt": MonteCarloAnalyzer(scene=SCENE, sim_config=CFG,
                                        importance_shift=shift),
    }
    acc = {k: {"errs": [], "stderrs": [], "n_effs": [], "cover": []}
           for k in analyzers}
    for key in KEYS:
        for label, an in analyzers.items():
            a = an.run_monte_carlo(IC, n_samples=N_EST, seed=key)
            row = exceedance_from_analysis(a, "apogee_altitude", [thr])[0]
            p = row["probability"]
            acc[label]["errs"].append(p - p_truth)
            if label == "plain":
                acc[label]["stderrs"].append(
                    np.sqrt(max(p, 1e-12) * (1 - p) / row["n"])
                )
                acc[label]["n_effs"].append(p * row["n"])
                lo, hi = row["ci95"]
                acc[label]["cover"].append(lo <= p_truth <= hi)
            else:
                acc[label]["stderrs"].append(row["stderr"])
                acc[label]["n_effs"].append(row["n_eff_tail"])
                acc[label]["cover"].append(
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
        "threshold_m": thr, "p_truth": p_truth,
        "hand": HAND, "auto": shift, "keys": len(KEYS),
        "wall_s": round(time.time() - t0, 1), "rows": rows,
    }))


if __name__ == "__main__":
    main()
