"""Capstone: 100,000,000 dispersed 1k-step 6DOF flights on ONE device,
through the PRODUCTION analyzer path (sampling, simulation, outlier
filtering, streaming statistics + mergeable quantile sketch) with O(slab)
host memory.

This is 100x the BASELINE.json config-5 workload (10M lanes) executed
end-to-end on a single device: the auto-slab loop bounds per-call device
work and memory, and past ``stats_stream_threshold`` lanes the per-lane
metric arrays never materialize on the host.

Run: PYTHONPATH=. python scripts/hundred_million_flights.py [--fast]

--fast: the production fast config through the SAME
analyzer path — rk2 + per-step wind + bf16 + wind_table_modes=24 +
two_level_lanes=4096 so the headline means come out bias-CORRECTED
(the fast flags' integration bias is ~30x the n=100M sampling stderr).
"""
import json
import resource
import sys
import time

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache

N = 100_000_000
SLAB = 262_144  # bench.py's operating point
FAST = "--fast" in sys.argv


def main():
    enable_persistent_cache()
    fast_cfg = dict(integrator="rk2", wind_eval_per_step=True,
                    wind_table_bf16=True)
    mc = MonteCarloAnalyzer(
        scene=nominal_scene(liquid_motor()),
        sim_config=SimConfig(max_time=6.0,  # the 1k-step bench config
                             **(fast_cfg if FAST else {})),
        **(dict(wind_table_modes=24, two_level_lanes=4096) if FAST else {}),
    )
    ic = InitialConditions.vertical_launch()
    t0 = time.time()
    # a long run: checkpoint every 16 slabs so a killed process
    # resumes instead of restarting (bit-identical;
    # mc.slab_checkpoint). The file is removed on completion.
    ckpt = ("outputs/hundred_million_fast.ckpt.npz" if FAST
            else "outputs/hundred_million.ckpt.npz")
    a = mc.run_monte_carlo(ic, n_samples=N, lane_slab=SLAB, seed=7,
                           checkpoint_path=ckpt)
    wall = time.time() - t0
    print(json.dumps({
        "total_flights": a["n_total"],
        "valid": a["n_samples"],
        "outliers": a["n_outliers"],
        "steps": 1048,
        "wall_s": round(wall, 1),
        "traj_per_s": round(a["n_total"] / wall, 0),
        "apogee_mean_m": round(a["apogee_altitude"]["mean"], 2),
        "apogee_std_m": round(a["apogee_altitude"]["std"], 2),
        # percentiles list is [5, 25, 50, 75, 95] (mc/stats.py PERCENTILES)
        "apogee_p50_m": round(a["apogee_altitude"]["percentiles"][2], 2),
        "metrics_is_sample": a["metrics_is_sample"],
        "landing_footprint": a["landing_footprint"],
        "host_peak_rss_mb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 0
        ),
        "two_level": a.get("two_level"),
        "mode": "rk2 + wind/step + bf16 + modes24 + two-level" if FAST
                else "parity",
        "chips": 1,
    }))


if __name__ == "__main__":
    main()
