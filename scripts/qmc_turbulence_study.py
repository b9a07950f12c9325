"""Turbulence-QMC convergence study: does dimension-ordered Sobol over the
AR(1) wind modes buy full-flight accuracy the scalar-channel Sobol cannot?

Round-2 finding (NOTES.md): scalar-channel sobol gives 29-160x on the
1k-step apogee mean but ZERO gain on full-flight apogee, whose dispersion is
dominated by AR(1) turbulence via weather-cocking. Round-3 adds
``sobol_wind_modes`` (mc.sample_dispersions): the top-K principal components
of the turbulence driver come from scrambled Sobol, the orthogonal tail
stays prng — process distribution exact, variance-dominant directions
stratified.

Protocol (same as the round-2 study): FULL flights to landing, stabilized +
tiered config; truth = pooled mean over TRUTH_LANES prng lanes; estimator
error = RMS over KEYS independent keys of (estimate_mean - truth); report
favorable AND adverse metrics (apogee, range, flight time).

Run: PYTHONPATH=. python scripts/qmc_turbulence_study.py
"""
import json
import time

import jax
import numpy as np

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu.engine.batch import simulate_summary_batch
from erpl_monte_carlo_sim_tpu.mc import outlier_mask, sample_dispersions
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

CFG = SimConfig(
    energy_consistent_aero=True,
    descent_dt_scale=16,
    ascent_q_threshold=8000.0,
)
SCENE = nominal_scene(liquid_motor())
IC = InitialConditions.vertical_launch()
METRICS = ("apogee_altitude", "range", "flight_time")

TRUTH_SLABS = 2          # x 131072 prng lanes
TRUTH_SLAB = 131_072
KEYS = list(range(100, 108))   # 8 independent estimator keys
NS = (1024, 4096)
SAMPLERS = (
    ("prng", dict(sampler="prng")),
    ("sobol", dict(sampler="sobol")),
    ("sobol+wind8", dict(sampler="sobol", sobol_wind_modes=8)),
    ("sobol+wind24", dict(sampler="sobol", sobol_wind_modes=24)),
)


def run_means(key, n, **kw):
    sb, ib, _ = sample_dispersions(jax.random.PRNGKey(key), SCENE, IC, n=n, **kw)
    r = simulate_summary_batch(sb, ib, CFG)
    m, _ = outlier_mask(r)
    m = np.asarray(m)
    out = {}
    for name in METRICS:
        v = np.asarray(getattr(r, name))[m]
        out[name] = float(v.mean())
    out["_n_valid"] = int(m.sum())
    return out


def main():
    t0 = time.time()
    truth_acc = {k: [] for k in METRICS}
    for s in range(TRUTH_SLABS):
        tm = run_means(1000 + s, TRUTH_SLAB)
        for k in METRICS:
            truth_acc[k].append(tm[k])
        print(f"# truth slab {s}: {tm}", flush=True)
    truth = {k: float(np.mean(v)) for k, v in truth_acc.items()}
    truth_spread = {k: float(np.std(v)) for k, v in truth_acc.items()}
    print("# truth:", json.dumps(truth), "spread:", json.dumps(truth_spread),
          flush=True)

    results = []
    for n in NS:
        for label, kw in SAMPLERS:
            errs = {k: [] for k in METRICS}
            for key in KEYS:
                est = run_means(key, n, **kw)
                for k in METRICS:
                    errs[k].append(est[k] - truth[k])
            row = {
                "n": n,
                "sampler": label,
                **{
                    f"rms_{k}": float(np.sqrt(np.mean(np.square(errs[k]))))
                    for k in METRICS
                },
            }
            results.append(row)
            print(json.dumps(row), flush=True)

    print(json.dumps({
        "truth": truth,
        "truth_slab_spread": truth_spread,
        "keys": len(KEYS),
        "wall_s": round(time.time() - t0, 1),
        "rows": results,
    }))


if __name__ == "__main__":
    main()
