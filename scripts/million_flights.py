"""North-star demo: 1M dispersed 1k-step 6DOF flights on ONE device.

BASELINE.json target: 1M dispersed flights (>=1k steps) in < 60 s.
Dispersion sampling is INCLUDED in the time. ``--fast`` runs the fast
opt-in stack (rk2 + wind/step + bf16 + wind_table_modes=24 — documented
opt-ins, each accuracy-pinned by test).

Run: PYTHONPATH=. python scripts/million_flights.py [--fast]
"""
import sys
import time, json
import jax, numpy as np
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache
from erpl_monte_carlo_sim_tpu.engine import SimConfig, InitialConditions
from erpl_monte_carlo_sim_tpu.engine.batch import simulate_summary_batch
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions
from erpl_monte_carlo_sim_tpu.models import (compress_wind, nominal_scene,
                                             liquid_motor, wind_mode_basis)

enable_persistent_cache()
FAST = "--fast" in sys.argv
half = 524_288
cfg = SimConfig(max_time=6.0, **(
    dict(integrator="rk2", wind_eval_per_step=True, wind_table_bf16=True)
    if FAST else {}
))
scene = nominal_scene(liquid_motor())
ic = InitialConditions.vertical_launch()
basis = None
if FAST:
    basis = wind_mode_basis(scene.wind_model, np.linspace(0, 25000.0, 100),
                            24)


def prep(seed):
    sb, ib, _ = sample_dispersions(jax.random.PRNGKey(seed), scene, ic,
                                   n=half)
    if basis is not None:
        sb = sb.replace(wind=compress_wind(sb.wind, basis))
    return sb, ib


# compile once (component batch path — the r2 default execution core)
scene_b, ic_b = prep(0)
run = simulate_summary_batch
np.asarray(run(scene_b, ic_b, cfg).apogee_altitude)

t0 = time.time()
apos = []
for seed in [1, 2]:  # 2 x 512k = 1,048,576 flights incl dispersion sampling
    sb, ib = prep(seed)
    r = run(sb, ib, cfg)
    apos.append(np.asarray(r.apogee_altitude))
t = time.time() - t0
apo = np.concatenate(apos)
print(json.dumps({
    "total_flights": int(apo.shape[0]), "steps": 1048,
    "wall_s_incl_sampling": round(t, 1),
    "traj_per_s": round(apo.shape[0] / t, 0),
    "finite_frac": float(np.isfinite(apo).mean()),
    "apogee_mean_m": round(float(np.nanmean(apo)), 2),
    "mode": "rk2 + wind/step + bf16 + modes24" if FAST else "parity",
    "device": jax.devices()[0].device_kind,
    "north_star": "1M 1k-step flights < 60 s",
}))
