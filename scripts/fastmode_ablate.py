"""Fast-mode ablation: windowed-MC throughput of each SimConfig variant.

Each variant compiles ``engine.batch._run_components`` once and times three
runs at B lanes (1k-step windowed flights):
  baseline      — wind_eval_per_step + wind_table_bf16
  unroll        — SimConfig.unroll=2/4: K masked sub-steps per while
                  iteration (identical results)
  sharedtable   — [3,100,1] broadcast wind table: attribution run that
                  removes per-lane table bytes entirely (NOT a valid MC
                  config — bounds how much of the step is table read)
  rk2*, parity, modes*  — integrator and wind-table variants

Run: PYTHONPATH=. python scripts/fastmode_ablate.py [variant ...]
Writes one JSON line per variant to stdout (with the device kind).
"""
import json
import sys
import time

import numpy as np

import jax

from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig  # noqa: E402
from erpl_monte_carlo_sim_tpu.engine.batch import (  # noqa: E402
    _run_components,
    prepare_batch,
)
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions  # noqa: E402
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene  # noqa: E402

import os

B = int(os.environ.get("ABLATE_B", 262144))
FAST = dict(max_time=6.0, wind_eval_per_step=True, wind_table_bf16=True)

def setup(cfg, shared_table=False, modes=None):
    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    scene_b, ic_b, _ = sample_dispersions(
        jax.random.PRNGKey(0), scene, ic, n=B)
    if modes:
        # mode-compressed per-lane tables (models.wind.WindModes)
        from erpl_monte_carlo_sim_tpu.models import (compress_wind,
                                                     wind_mode_basis)

        q = wind_mode_basis(scene.wind_model,
                            np.asarray(scene_b.wind.altitudes), modes)
        scene_b = scene_b.replace(wind=compress_wind(scene_b.wind, q))
    scene_nw, grid, wT, ics = prepare_batch(scene_b, ic_b)
    if cfg.wind_table_bf16:
        from erpl_monte_carlo_sim_tpu.engine.batch import _bf16_tables

        wT = _bf16_tables(wT)
    if shared_table:
        wT = wT[:, :, :1]  # broadcastable shared table (attribution only)
    return scene_nw, grid, wT, ics


def run_variant(name, cfg, shared_table=False, modes=None):
    scene_nw, grid, wT, ics = setup(cfg, shared_table, modes)
    t_c0 = time.time()
    try:
        lowered = _run_components.lower(scene_nw, grid, wT, cfg, ics)
        comp = lowered.compile()
    except Exception as e:
        print(json.dumps({"variant": name, "error": str(e)[:300]}),
              flush=True)
        return None
    compile_s = time.time() - t_c0
    # warm + 3 timed reps
    r = comp(scene_nw, grid, wT, ics)
    steps = int(np.asarray(r["n_steps"]).max())
    times = []
    for _ in range(3):
        t0 = time.time()
        r = jax.block_until_ready(comp(scene_nw, grid, wT, ics))
        times.append(time.time() - t0)
    t = min(times)
    out = {
        "variant": name,
        "traj_per_s": round(B / t, 1),
        "wall_s": round(t, 4),
        "steps": steps,
        "compile_s": round(compile_s, 1),
        "apogee_mean": round(
            float(np.nanmean(np.asarray(r["apogee_altitude"], np.float64))),
            2),
        "device": jax.devices()[0].device_kind,
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    which = set(sys.argv[1:])

    def want(v):
        return not which or v in which

    if want("baseline"):
        run_variant("baseline", SimConfig(**FAST))
    if want("unroll"):
        for u in (2, 4):
            run_variant(f"unroll{u}", SimConfig(unroll=u, **FAST))
    if want("sharedtable"):
        run_variant("sharedtable", SimConfig(**FAST), shared_table=True)
    if want("rk2"):
        run_variant("rk2", SimConfig(integrator="rk2", **FAST))
    if want("rk2-eps"):
        run_variant("rk2_evalperstep_f32",
                    SimConfig(max_time=6.0, integrator="rk2",
                              wind_eval_per_step=True))
    if want("rk2-bf16"):
        run_variant("rk2_bf16_perstage",
                    SimConfig(max_time=6.0, integrator="rk2",
                              wind_table_bf16=True))
    if want("rk2-parity-wind"):
        # rk2 with parity wind semantics (isolates the integrator's gain)
        run_variant("rk2_paritywind",
                    SimConfig(max_time=6.0, integrator="rk2"))
    if want("parity"):
        run_variant("parity", SimConfig(max_time=6.0))
    if want("modes"):
        # mode-compressed tables on top of rk2+fast; M = K + 2 aux columns, so table bytes scale ~(K+2)/100.
        for k in (12, 24, 48):
            run_variant(f"rk2_modes{k}",
                        SimConfig(integrator="rk2", **FAST), modes=k)
    if want("modes-rk4"):
        run_variant("rk4_modes24", SimConfig(**FAST), modes=24)
    if want("modes-f32"):
        # f32 scores: does bf16 still matter once bytes shrink 4x?
        run_variant("rk2_modes24_f32scores",
                    SimConfig(max_time=6.0, integrator="rk2",
                              wind_eval_per_step=True), modes=24)
    if want("modes-full"):
        # full-rank scores (M=100): isolates layout/matmul overhead from
        # the byte savings (same bytes as the table path, same math path
        # as modes)
        run_variant("rk2_modes_fullrank",
                    SimConfig(integrator="rk2", **FAST), modes=100)


if __name__ == "__main__":
    main()
