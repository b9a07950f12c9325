"""Coupled two-level check: population-level bias of the tiered timestep.

The tiered-dt fast flags (descent_dt_scale / ascent_q_threshold) are
accuracy-pinned per lane (tests/test_descent.py: nominal apogee delta
0.000 m, dispersed max 0.37 m against a 915 m sigma). This script
upgrades that to a POPULATION statement with the multilevel idea: run the
SAME dispersed lanes (same keys — coupled by construction) under the
tiered and parity configs and estimate

    bias = E[f_parity - f_tiered]

directly. Because the lanes are coupled, the difference's variance is
tiny and a few thousand lanes resolve the bias to millimeters — far
below what an uncoupled comparison could see under the 900 m-scale
dispersion.

When it matters: the mean's sampling stderr crosses the measured bias
around n ~ (sigma/bias)^2 lanes; below that, tiered means are
statistically indistinguishable from parity at ~4x less step work. For
runs beyond that scale (e.g. the 100M capstone), set
``MonteCarloAnalyzer(two_level_lanes=K)`` — this script is a thin
measurement harness around the SAME estimator that knob runs
(``mc.two_level.two_level_block``); keeping one implementation means the
numbers recorded in NOTES.md describe exactly what production applies.

Run: PYTHONPATH=. python scripts/two_level_check.py
"""
import json
import time

import jax

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu.mc.two_level import METRICS, two_level_block
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

SCENE = nominal_scene(liquid_motor())
IC = InitialConditions.vertical_launch()
TIERED = SimConfig(energy_consistent_aero=True, descent_dt_scale=16,
                   ascent_q_threshold=8000.0)
N = 4096


def main():
    t0 = time.time()
    block = two_level_block(SCENE, IC, TIERED, N, jax.random.PRNGKey(42))
    print(f"# coupled {block['n_coupled']}/{N} valid "
          f"(validity mismatches {block['mismatched_validity']}); "
          f"tiered {block['wall_s_legs']['fast']:.1f} s, "
          f"parity {block['wall_s_legs']['parity']:.1f} s", flush=True)

    rows = {}
    for k in METRICS:
        b = block[k]
        rows[k] = {
            **b,
            # lanes at which the mean's sampling stderr equals the bias
            "n_where_bias_matters": (
                float((b["population_sigma"] / abs(b["bias"])) ** 2)
                if b["bias"] != 0.0 else float("inf")
            ),
        }
        print(json.dumps({"metric": k, **rows[k]}), flush=True)

    print(json.dumps({
        "n_coupled": block["n_coupled"],
        "mismatched_validity": block["mismatched_validity"],
        "wall_s_tiered": block["wall_s_legs"]["fast"],
        "wall_s_parity": block["wall_s_legs"]["parity"],
        "wall_s_total": round(time.time() - t0, 1),
        "rows": rows,
    }))


if __name__ == "__main__":
    main()
