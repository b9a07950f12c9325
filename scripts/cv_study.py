"""Control-variate study: measured accuracy of the CV-adjusted means
(`MonteCarloAnalyzer(control_variates=True)`) vs plain prng and Sobol.

Protocol (same shape as the QMC studies in NOTES.md): truth = pooled mean
over TRUTH_SLABS x TRUTH_SLAB prng lanes; estimator error = RMS over KEYS
independent keys of (estimate - truth); favorable AND adverse regimes:

  * window: the 1k-step bench config, where the scalar channels carry
    most of the variance (the regime where scalar QMC measured 29-160x) —
    CV should pay big here;
  * full: flights to landing (stabilized + tiered), where AR(1)
    turbulence dominates via weather-cocking — the controls don't see the
    turbulence draws, so CV gains are expected to be modest; report them
    honestly.

Also reports mean(reported stderr) per row so the delta-method error bar
can be checked against the realized RMS (calibration ~1).

Run: PYTHONPATH=. python scripts/cv_study.py
"""
import json
import time

import numpy as np

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

SCENE = nominal_scene(liquid_motor())
IC = InitialConditions.vertical_launch()
METRICS = ("apogee_altitude", "range", "flight_time")
CONFIGS = {
    "window": SimConfig(max_time=6.0),
    "full": SimConfig(
        energy_consistent_aero=True,
        descent_dt_scale=16,
        ascent_q_threshold=8000.0,
    ),
}
TRUTH_SLABS = 2
TRUTH_SLAB = 131_072
KEYS = list(range(100, 108))
NS = (1024, 4096)


def analyzers(cfg):
    return {
        "prng": MonteCarloAnalyzer(scene=SCENE, sim_config=cfg,
                                   control_variates=True),
        # identical lanes to "prng" (sampling is unchanged by CV knobs);
        # only the control set differs
        "prng_w": MonteCarloAnalyzer(scene=SCENE, sim_config=cfg,
                                     control_variates=True,
                                     cv_wind_modes=24),
        "sobol": MonteCarloAnalyzer(scene=SCENE, sim_config=cfg,
                                    sampler="sobol"),
    }


def main():
    t0 = time.time()
    out_rows = []
    for regime, cfg in CONFIGS.items():
        mcs = analyzers(cfg)
        truth_acc = {k: [] for k in METRICS}
        for s in range(TRUTH_SLABS):
            a = mcs["prng"].run_monte_carlo(IC, n_samples=TRUTH_SLAB,
                                            seed=1000 + s)
            for k in METRICS:
                truth_acc[k].append(a[k]["mean"])
            # print the slab means so a killed run's truth is recoverable
            print(f"# {regime} truth slab {s}: "
                  f"{json.dumps({k: truth_acc[k][-1] for k in METRICS})}",
                  flush=True)
        truth = {k: float(np.mean(v)) for k, v in truth_acc.items()}
        print(f"# {regime} truth:", json.dumps(truth), "spread:",
              json.dumps({k: float(np.std(v)) for k, v in truth_acc.items()}),
              flush=True)

        for n in NS:
            rows = {
                "prng": {k: [] for k in METRICS},
                "prng+cv": {k: [] for k in METRICS},
                "prng+cv+wind24": {k: [] for k in METRICS},
                "sobol": {k: [] for k in METRICS},
            }
            stderrs = {k: [] for k in METRICS}
            vrs = {k: [] for k in METRICS}
            for key in KEYS:
                a = mcs["prng"].run_monte_carlo(IC, n_samples=n, seed=key)
                cv = a["control_variates"]
                for k in METRICS:
                    rows["prng"][k].append(cv[k]["plain_mean"] - truth[k])
                    rows["prng+cv"][k].append(cv[k]["mean"] - truth[k])
                    stderrs[k].append(cv[k]["stderr"])
                    vrs[k].append(cv[k]["variance_reduction"])
                w = mcs["prng_w"].run_monte_carlo(IC, n_samples=n, seed=key)
                for k in METRICS:
                    rows["prng+cv+wind24"][k].append(
                        w["control_variates"][k]["mean"] - truth[k]
                    )
                s = mcs["sobol"].run_monte_carlo(IC, n_samples=n, seed=key)
                for k in METRICS:
                    rows["sobol"][k].append(s[k]["mean"] - truth[k])
            for label, errs in rows.items():
                row = {
                    "regime": regime, "n": n, "estimator": label,
                    **{f"rms_{k}":
                       float(np.sqrt(np.mean(np.square(errs[k]))))
                       for k in METRICS},
                }
                if label == "prng+cv":
                    row.update({
                        f"stderr_{k}": float(np.mean(stderrs[k]))
                        for k in METRICS
                    })
                    row.update({
                        f"vr_{k}": float(np.median(vrs[k])) for k in METRICS
                    })
                out_rows.append(row)
                print(json.dumps(row), flush=True)

    print(json.dumps({"keys": len(KEYS),
                      "wall_s": round(time.time() - t0, 1),
                      "rows": out_rows}))


if __name__ == "__main__":
    main()
