"""Wind-speed CV study: do the |w|-at-altitude controls close the
full-flight CV gap?

The round-3 full-flight CV study (NOTES.md) measured an honest negative:
scalar + per-mode-diagonal controls explain only ~25% of apogee variance
because weather-cocking responds to the wind MAGNITUDE — even in the
turbulence, with cross-mode structure a diagonal quadratic basis cannot
span. ``cv_wind_speed`` adds the realized horizontal wind speed/energy at
altitude knots (exact Rice/quadrature means, mc.cv.wind_speed_control_
means). This study measures what they buy, same protocol as the previous
one (truth = TRUTH_SLABS x TRUTH_SLAB pooled prng lanes, RMS of mean
error over KEYS keys at n=N_EST), with nested control subsets finalized
from ONE simulation per key (CV knobs don't change the lanes, only the
regression — so arms share sims and the comparison is paired).

Run: PYTHONPATH=. python scripts/wspd_cv_study.py
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu.engine.batch import simulate_summary_batch
from erpl_monte_carlo_sim_tpu.mc import (
    CVMoments,
    UncertaintyParams,
    control_names,
    cv_slab_moments,
    finalize_cv,
    outlier_mask,
    sample_dispersions,
)
from erpl_monte_carlo_sim_tpu.mc.cv import (
    wind_mode_projector,
    wind_speed_ctrl_leaves,
)
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

SCENE = nominal_scene(liquid_motor())
IC = InitialConditions.vertical_launch()
PARAMS = UncertaintyParams()
CFG = SimConfig(
    energy_consistent_aero=True,
    descent_dt_scale=16,
    ascent_q_threshold=8000.0,
)
METRICS = ("apogee_altitude", "range", "flight_time")
K_MODES = 24
J_KNOTS = 8
TRUTH_SLABS = 2
TRUTH_SLAB = 16_384
KEYS = list(range(100, 106))
N_EST = 1024


def _wind_ctrl(scene_b, sample):
    # same shared builder as the analyzer (mc.cv.wind_speed_ctrl_leaves)
    # so this study measures the estimator production runs actually use
    alt = np.asarray(scene_b.wind.altitudes, np.float64)
    leaves, idx = wind_speed_ctrl_leaves(
        PARAMS, SCENE.wind_model, alt, J_KNOTS, dtype=jnp.float32
    )
    return {
        "wind": scene_b.wind.wind,
        "ws": sample.wind_speed,
        "wd": sample.wind_direction,
        "proj": jnp.asarray(
            wind_mode_projector(SCENE.wind_model, alt, K_MODES),
            jnp.float32,
        ),
        "alt": scene_b.wind.altitudes,
        "model": SCENE.wind_model,
        "base": None,
        **leaves,
    }, alt[idx]


def _sub_acc(acc, idx):
    s = CVMoments()
    s.n = acc.n
    s.mz = acc.mz[idx]
    s.mt = acc.mt.copy()
    s.szz = acc.szz[np.ix_(idx, idx)]
    s.szt = acc.szt[idx]
    s.stt = acc.stt.copy()
    return s


def run_lanes(key_seed, n):
    sb, ib, sample = sample_dispersions(
        jax.random.PRNGKey(key_seed), SCENE, IC, PARAMS, n
    )
    summary = simulate_summary_batch(sb, ib, CFG)
    valid, _ = outlier_mask(summary)
    wc, spd_alts = _wind_ctrl(sb, sample)
    mo = cv_slab_moments(sample, summary, valid, jnp.ones(n, bool),
                         PARAMS, SCENE.motor, wc)
    acc = CVMoments()
    acc.add(jax.device_get(mo))
    return acc, spd_alts


def main():
    t0 = time.time()
    # truth: plain pooled means (no CV needed; mt carries the ratio parts)
    truth_means = {k: [] for k in METRICS}
    for s in range(TRUTH_SLABS):
        acc, spd_alts = run_lanes(1000 + s, TRUTH_SLAB)
        names = control_names(PARAMS, SCENE.motor, K_MODES, spd_alts)
        blk = finalize_cv(acc, names)
        for k in METRICS:
            truth_means[k].append(blk[k]["plain_mean"])
        print(f"# truth slab {s}:",
              json.dumps({k: truth_means[k][-1] for k in METRICS}),
              flush=True)
    truth = {k: float(np.mean(v)) for k, v in truth_means.items()}
    spread = {k: float(np.std(v)) for k, v in truth_means.items()}
    print("# truth:", json.dumps(truth), "slab spread:", json.dumps(spread),
          flush=True)

    # nested control subsets (paired: same sims, different regressions).
    # spd_alts is deterministic (knot indices over the fixed grid) and the
    # truth loop above already produced it — no extra simulation needed.
    names = control_names(PARAMS, SCENE.motor, K_MODES, spd_alts)
    d = len(names)
    n_spd = 2 * len(spd_alts)
    n_turb = 6 * K_MODES
    n_scalar = d - n_spd - n_turb
    subsets = {
        "cv": list(range(n_scalar)),
        "cv+wind24": list(range(n_scalar + n_turb)),
        "cv+wspd8": list(range(n_scalar)) + list(range(d - n_spd, d)),
        "cv+wind24+wspd8": list(range(d)),
    }
    print(f"# controls: {n_scalar} scalar + {n_turb} turb + {n_spd} wspd",
          flush=True)

    errs = {arm: {k: [] for k in METRICS}
            for arm in ["plain", *subsets]}
    vr = {arm: {k: [] for k in METRICS} for arm in subsets}
    stderr = {arm: {k: [] for k in METRICS} for arm in subsets}
    for seed in KEYS:
        acc, _ = run_lanes(seed, N_EST)
        for arm, idx in subsets.items():
            blk = finalize_cv(_sub_acc(acc, idx), [names[i] for i in idx])
            for k in METRICS:
                errs[arm][k].append(blk[k]["mean"] - truth[k])
                vr[arm][k].append(blk[k]["variance_reduction"])
                stderr[arm][k].append(blk[k]["stderr"])
        for k in METRICS:
            errs["plain"][k].append(blk[k]["plain_mean"] - truth[k])
        print(f"# key {seed} done ({time.time() - t0:.0f} s)", flush=True)

    rows = []
    for arm in errs:
        row = {"arm": arm, "n": N_EST,
               **{f"rms_{k}": float(np.sqrt(np.mean(np.square(
                   errs[arm][k])))) for k in METRICS}}
        if arm in vr:
            row.update({f"vr_{k}": float(np.median(vr[arm][k]))
                        for k in METRICS})
            row.update({f"stderr_{k}": float(np.mean(stderr[arm][k]))
                        for k in METRICS})
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"keys": len(KEYS), "truth_spread": spread,
                      "wall_s": round(time.time() - t0, 1), "rows": rows}))


if __name__ == "__main__":
    main()
