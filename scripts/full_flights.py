"""Capstone: 1M full wind-dispersed 6DOF flights TO LANDING on ONE chip.

Re-measurement of the r1 capstone (16.3 min, vmap path, parity dt) on the
r2 component batch core with the tiered-timestep opt-ins: coarse RK4 only
in dynamically-quiet phases (ballistic fall, canopy descent, low-q coast),
fine 5 ms through the rail/burn/transonic/apogee/chute-shock transients
(accuracy pinned in tests/test_descent.py). Stabilized aero
(energy_consistent_aero) keeps 100% of wind-dispersed lanes valid — the
reference's own wind-dispersed runs diverge and get filtered (SURVEY.md §6).

Reference equivalent: ~25 s/flight single-core -> ~18 days on 16 cores.
Measured 2026-08-17: 54.5 s / 19.3k full trajectories/s on one chip
(71.5 s before the jitted-sampling fix).

Run: PYTHONPATH=. python scripts/full_flights.py
"""
import time, json
import jax, numpy as np
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache
from erpl_monte_carlo_sim_tpu.engine import SimConfig, InitialConditions
from erpl_monte_carlo_sim_tpu.engine.batch import simulate_summary_batch
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions, outlier_mask
from erpl_monte_carlo_sim_tpu.models import nominal_scene, liquid_motor

enable_persistent_cache()
SLAB = 262_144
N_SLABS = 4  # 4 x 262144 = 1,048,576 flights

import sys

RK2 = "--rk2" in sys.argv
cfg = SimConfig(
    energy_consistent_aero=True,   # stabilized: no wind-divergence outliers
    descent_dt_scale=16,           # coarse dt in quiet phases only
    ascent_q_threshold=8000.0,     # + quiet coast ascent
    integrator="rk2" if RK2 else "rk4",  # r4: midpoint opt-in, 3.4x
)
scene = nominal_scene(liquid_motor())
ic = InitialConditions.vertical_launch()

# Compile once on the slab shape (persistent cache makes re-runs warm).
sb, ib, _ = sample_dispersions(jax.random.PRNGKey(0), scene, ic, n=SLAB)
np.asarray(simulate_summary_batch(sb, ib, cfg).apogee_altitude)

t0 = time.time()
apo, rng, ft, valid, steps = [], [], [], [], 0
for seed in range(1, N_SLABS + 1):
    sb, ib, _ = sample_dispersions(jax.random.PRNGKey(seed), scene, ic, n=SLAB)
    r = simulate_summary_batch(sb, ib, cfg)
    m, _ = outlier_mask(r)
    apo.append(np.asarray(r.apogee_altitude))
    rng.append(np.asarray(r.range))
    ft.append(np.asarray(r.flight_time))
    valid.append(np.asarray(m))
    steps = max(steps, int(np.asarray(r.n_steps).max()))
t = time.time() - t0

apo = np.concatenate(apo)
rng = np.concatenate(rng)
ft = np.concatenate(ft)
valid = np.concatenate(valid)

# Two-level bias correction (VERDICT r4 weak #5): the tiered/rk2 fast
# flags carry a small deterministic integration bias — flight_time is the
# honest hole (+4.3% chute-phase under rk2) — and at n=1M the sampling
# stderr is far below it. A small COUPLED batch (same draws, fast vs
# parity twin) measures the bias; the headline means below are corrected
# by default so the first number a user reproduces is unbiased.
from erpl_monte_carlo_sim_tpu.mc.two_level import two_level_block

tl = two_level_block(scene, ic, cfg, 4096, jax.random.PRNGKey(99))
n_valid = int(valid.sum())


def corrected(metric, raw_mean):
    b = tl[metric]
    samp_se = {
        "apogee_altitude": apo, "range": rng, "flight_time": ft
    }[metric][valid].std() / np.sqrt(max(n_valid, 1))
    return {
        "raw_mean": round(float(raw_mean), 3),
        "corrected_mean": round(float(raw_mean + b["bias"]), 3),
        "bias": round(b["bias"], 4),
        "bias_stderr": round(b["bias_stderr"], 5),
        "sampling_stderr": round(float(samp_se), 5),
    }


print(json.dumps({
    "total_flights": int(apo.shape[0]),
    "wall_s_incl_sampling": round(t, 1),
    "full_traj_per_s": round(apo.shape[0] / t, 0),
    "max_lane_steps": steps,
    "valid_frac": round(float(valid.mean()), 6),
    "apogee_mean_m": round(float(apo[valid].mean()), 1),
    "apogee_std_m": round(float(apo[valid].std()), 1),
    "range_mean_m": round(float(rng[valid].mean()), 1),
    "flight_time_mean_s": round(float(ft[valid].mean()), 1),
    "two_level": {
        "apogee_altitude": corrected("apogee_altitude", apo[valid].mean()),
        "range": corrected("range", rng[valid].mean()),
        "flight_time": corrected("flight_time", ft[valid].mean()),
        "n_coupled": tl["n_coupled"],
        "wall_s": tl["wall_s"],
    },
    "mode": "stabilized aero + tiered dt (descent_dt_scale=16, q_thresh=8000)"
            + (" + rk2" if RK2 else ""),
    "chips": 1,
    "r1_capstone": "16.3 min (vmap path, parity dt)",
}))
