"""Measured Sobol'-index study: which dispersion channel drives flight
metric variance, in the window regime (1k-step bench config) and on full
flights (tiered-dt fast flags — NOTES.md two-level study bounds their
bias at millimeters against 300-680 m population sigmas, irrelevant for
variance SHARES).

Run: PYTHONPATH=. python scripts/sobol_indices_study.py
"""
import json
import time

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu.mc import sobol_indices
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

SCENE = nominal_scene(liquid_motor())
IC = InitialConditions.vertical_launch()
REGIMES = {
    "window": (SimConfig(max_time=6.0), 8192),
    # energy_consistent_aero: under parity aero, full flights in dispersed
    # wind diverge (the reference's own quirk — NOTES.md round 2) and the
    # outlier filter rejects every lane; same choice as every other
    # full-flight study in scripts/.
    "full_flight": (
        SimConfig(energy_consistent_aero=True, descent_dt_scale=16,
                  ascent_q_threshold=8000.0),
        2048,
    ),
}


# full-flight first-order run measured sum(S) 0.27-0.44 (NOTES.md):
# 56-73% of the variance is interactions. These pairs cover every
# 2-subset of the four high-T channels the first-order run flagged
# (wind_direction/wind_speed/angular_velocity/wind_turbulence T in
# 0.30-0.72 with S near 0).
PAIRS = {
    "window": None,
    "full_flight": [
        ("wind_speed", "wind_direction"),
        ("wind_direction", "angular_velocity"),
        ("wind_speed", "angular_velocity"),
        ("wind_direction", "wind_turbulence"),
        ("wind_speed", "wind_turbulence"),
        ("angular_velocity", "wind_turbulence"),
        # pure three-way probes (their pairs are above, as
        # inclusion-exclusion requires): the first-order run left ~0.3
        # of apogee variance beyond singles+pairs, and the pair pattern
        # suggested direction x rate x turbulence
        ("wind_direction", "angular_velocity", "wind_turbulence"),
        ("wind_speed", "wind_direction", "angular_velocity"),
    ],
}


def main():
    for name, (cfg, n) in REGIMES.items():
        t0 = time.time()
        out = sobol_indices(SCENE, IC, cfg, n=n, seed=42, n_boot=200,
                            pairs=PAIRS[name])
        wall = time.time() - t0
        print(f"# {name}: n={n}, n_valid={out['n_valid']}, "
              f"{out['n_sims']} lane-sims, {wall:.0f} s", flush=True)
        for m in ("apogee_altitude", "range", "flight_time"):
            row = {
                "regime": name, "metric": m,
                "sigma": round(out[m]["variance"] ** 0.5, 2),
                "S": {g: round(out[m]["first_order"][g]["S"], 3)
                      for g in out["groups"]},
                "T": {g: round(out[m]["total_order"][g]["T"], 3)
                      for g in out["groups"]},
                "sum_S": round(out[m]["sum_first_order"], 3),
            }
            if "second_order" in out[m]:
                row["S2"] = {
                    p: round(b["interaction"], 3)
                    for p, b in out[m]["second_order"].items()
                }
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
