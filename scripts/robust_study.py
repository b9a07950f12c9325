"""Measured design-under-uncertainty demo: nominal vs dispersed fin-span
optimization (mc.optimize_robust), window regime.

Protocol: Armijo line-search ascent (engine.diff.line_search_ascent,
24-evaluation budget) on rocket.fin_span from its nominal 0.2 m, three
objectives — (a) nominal
apogee (cli.optimize_apogee.optimize, B=1), (b) dispersed mean over 512
fixed lanes (SAA, seed 11), (c) dispersed mean - 3*std (risk-averse).

Run: PYTHONPATH=. python scripts/robust_study.py
"""
import time

from erpl_monte_carlo_sim_tpu.cli.optimize_apogee import optimize
from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu.mc import optimize_robust
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

SCENE = nominal_scene(liquid_motor())
IC = InitialConditions.vertical_launch()
CFG = SimConfig(max_time=6.0)


def main():
    t0 = time.time()
    hist = optimize("rocket.fin_span", steps=24, cfg=CFG, verbose=False)
    print("nominal:", [(round(v, 4), round(a, 2)) for v, a, _ in hist],
          f"{time.time() - t0:.0f}s", flush=True)
    for lam in (0.0, 3.0):
        t0 = time.time()
        h = optimize_robust(SCENE, IC, CFG, wrt="rocket.fin_span",
                            n_lanes=512, seed=11, risk_lambda=lam,
                            steps=24)
        print(f"robust lam={lam}:",
              [(round(v, 4), round(o, 2), round(m, 2), round(s, 2))
               for v, o, _, m, s in h], f"{time.time() - t0:.0f}s",
              flush=True)


if __name__ == "__main__":
    main()
