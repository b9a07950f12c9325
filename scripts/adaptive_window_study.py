"""Adaptive launch-window study: lanes + wall time, fixed-n vs sequential.

Protocol: one (speed x direction) forecast grid, full flights to landing
(stabilized aero so every wind-dispersed lane survives; tiered dt for
throughput), a range limit that splits the grid into clear-go,
clear-no-go, and boundary candidates. Two sweeps, same seed:

  * FIXED:    n = N_MAX lanes per candidate (the only option the
              reference's fixed-n design offers);
  * ADAPTIVE: N_SLAB-lane slabs per candidate, stopping the moment the
              go/no-go is DECIDED (Wilson 95% CI for P(range > limit)
              entirely on one side of p_limit), budget N_MAX.

Reported per candidate: verdict + lanes used in each mode; totals: lanes
and wall seconds. The claim under test: verdicts AGREE, and the adaptive
sweep concentrates the lane budget on boundary candidates while deciding
obvious ones after the minimum slabs the Wilson bound allows
(~74 valid lanes at k=0 for p_limit=0.05).

Run: PYTHONPATH=. python -u scripts/adaptive_window_study.py
"""
import json
import time

from erpl_monte_carlo_sim_tpu.cli.launch_window import launch_window_sweep
from erpl_monte_carlo_sim_tpu.engine import SimConfig
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache

SPEEDS = [2.0, 6.0, 10.0, 14.0]
DIRECTIONS = [0.0, 90.0, 180.0, 270.0]
N_SLAB = 1024
N_MAX = 8192
P_LIMIT = 0.05
# measured 2048-lane probe (2026-08-19): dispersed range p95 is
# 1298 / 1842 / 2592 m at v = 2 / 6 / 10 m/s, so 2600 m makes v=2,6
# clear-go, v=10 the boundary case, v=14 clear-no-go
RANGE_LIMIT = 2600.0

enable_persistent_cache()

cfg = SimConfig(energy_consistent_aero=True, descent_dt_scale=16,
                ascent_q_threshold=8000.0)

common = dict(
    range_limit=RANGE_LIMIT, p_limit=P_LIMIT, seed=0, sim_config=cfg,
)

t0 = time.time()
fixed = launch_window_sweep(SPEEDS, DIRECTIONS, n=N_MAX, **common)
t_fixed = time.time() - t0
print(f"fixed sweep: {len(fixed['candidates'])} candidates x {N_MAX} "
      f"lanes in {t_fixed:.1f} s", flush=True)

t0 = time.time()
adaptive = launch_window_sweep(SPEEDS, DIRECTIONS, n=N_SLAB,
                               adaptive_max_n=N_MAX, **common)
t_adaptive = time.time() - t0
print(f"adaptive sweep: slab {N_SLAB}, budget {N_MAX}: "
      f"{t_adaptive:.1f} s", flush=True)

rows = []
lanes_fixed = lanes_adaptive = 0
agree = True
for f, a in zip(fixed["candidates"], adaptive["candidates"]):
    assert (f["wind_speed"], f["wind_direction_deg"]) == \
        (a["wind_speed"], a["wind_direction_deg"])
    lanes_fixed += N_MAX
    lanes_adaptive += a["n_used"]
    agree &= (f["go"] == a["go"]) or not a["decided"]
    rows.append({
        "speed": f["wind_speed"], "dir": f["wind_direction_deg"],
        "fixed_go": f["go"],
        "fixed_p": f["p_range_exceed"]["probability"],
        "adaptive_go": a["go"], "decided": a["decided"],
        "n_used": a["n_used"],
        "adaptive_ci": a["p_range_exceed"]["ci95"],
    })
    print(f"  v={f['wind_speed']:4.1f} dir={f['wind_direction_deg']:5.1f}  "
          f"fixed: p={f['p_range_exceed']['probability']:.4f} "
          f"go={f['go']}   adaptive: n={a['n_used']:5d} "
          f"decided={a['decided']} go={a['go']}", flush=True)

out = {
    "speeds": SPEEDS, "directions": DIRECTIONS,
    "range_limit": RANGE_LIMIT, "p_limit": P_LIMIT,
    "n_slab": N_SLAB, "n_max": N_MAX,
    "t_fixed_s": t_fixed, "t_adaptive_s": t_adaptive,
    "lanes_fixed": lanes_fixed, "lanes_adaptive": lanes_adaptive,
    "lane_ratio": lanes_fixed / max(lanes_adaptive, 1),
    "verdicts_agree": agree,
    "candidates": rows,
}
print(json.dumps(out, indent=2))
