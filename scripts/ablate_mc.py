"""MC hot-loop ablation: where does the step time actually go?

Runs the headline Monte Carlo config (bench.py: B lanes, ~1k steps) with
individual cost centers stubbed out, and prints ms/step + traj/s for each
variant. Stubs are monkeypatches of the symbol in the consuming module
namespace, applied before tracing, so each variant is a separate compile
of the same source tree.

Variants:
  parity         — baseline (SimConfig defaults)
  wps            — wind_eval_per_step=True (1 wind eval/step instead of 4)
  shared_wind    — wind table SHARED across lanes (axes=None): measures the
                   per-lane [B,100,3] memory traffic + [B,100] tent arithmetic
  wind_const     — wind query replaced by a constant: removes tent math too
  wind_bf16      — per-lane wind table stored bf16 (compute still f32)
  aero_const     — aero_coefficients replaced by constants (keeps wind/atmo)
  atmo_const     — atmosphere_properties replaced by constants
  batch_32k      — parity at B/4 (separates bandwidth/compute from
                   per-iteration overhead)

Usage: PYTHONPATH=. python scripts/ablate_mc.py
"""

import json
import sys
import time

import numpy as np


def _timeit(run, *args):
    import jax

    r = jax.block_until_ready(run(*args))
    times = []
    for _ in range(3):
        t0 = time.time()
        r = jax.block_until_ready(run(*args))
        times.append(time.time() - t0)
    steps = int(np.asarray(r.n_steps).max())
    return min(times), steps, float(np.median(np.asarray(r.apogee_altitude)))


def main():
    import jax
    import jax.numpy as jnp

    from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from erpl_monte_carlo_sim_tpu.engine import (
        InitialConditions, SimConfig, simulate_summary,
    )
    from erpl_monte_carlo_sim_tpu.engine import dynamics as dyn_mod
    from erpl_monte_carlo_sim_tpu.mc import sample_dispersions, scene_in_axes
    from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene
    from erpl_monte_carlo_sim_tpu.models.atmosphere import AtmosProperties
    from erpl_monte_carlo_sim_tpu.models.rocket import AeroCoefficients

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 131072
    only = sys.argv[2].split(",") if len(sys.argv) > 2 else None
    cfg = SimConfig(max_time=6.0)

    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    scene_b, ic_b, _ = sample_dispersions(jax.random.PRNGKey(0), scene, ic, n=B)
    axes = scene_in_axes(scene, scene_b)

    def make_run(cfg_v, axes_v=None, scene_v=None, ic_v=None):
        run = jax.jit(
            jax.vmap(simulate_summary,
                     in_axes=(axes_v if axes_v is not None else axes, 0, None)),
            static_argnums=2,
        )
        return lambda: run(scene_v if scene_v is not None else scene_b,
                           ic_v if ic_v is not None else ic_b, cfg_v)

    results = {}

    def report(name, fn):
        if only and name not in only:
            return
        t, steps, apo = _timeit(fn)
        results[name] = {
            "wall_s": round(t, 4),
            "traj_per_s": round(B / t, 1) if name != "batch_32k"
            else round((B // 4) / t, 1),
            "ms_per_step": round(1e3 * t / steps, 4),
            "apogee_med": round(apo, 1),
        }
        print(f"{name}: {json.dumps(results[name])}", flush=True)

    # --- baseline + config variants (no patching)
    report("parity", make_run(cfg))
    report("wps", make_run(SimConfig(max_time=6.0, wind_eval_per_step=True)))

    # shared wind: vmap axes None for the wind subtree
    axes_shared = axes.replace(wind=None)
    report("shared_wind", make_run(cfg, axes_v=axes_shared,
                                   scene_v=scene_b.replace(wind=scene.wind)))

    # bf16 wind table
    wind_bf16 = scene_b.wind.replace(
        wind=scene_b.wind.wind.astype(jnp.bfloat16))
    report("wind_bf16", make_run(cfg, scene_v=scene_b.replace(wind=wind_bf16)))

    # --- stub variants (monkeypatch in the dynamics module namespace)
    def stub_wind(field, altitude):
        z = jnp.zeros_like(altitude)
        return jnp.stack([z + 3.0, z + 1.0, z * 0.0], axis=-1)

    def stub_aero(rocket, mach, alpha, beta, center_of_mass, power_on):
        one = jnp.ones_like(mach)
        return AeroCoefficients(
            cd=0.5 * one, cl=0.1 * alpha, cm=0.0 * one,
            cp=3.0 * one, cn=0.1 * one, cy=-0.1 * beta,
            croll=0.0 * one, cpitch=-2.0 * alpha, cyaw=2.0 * beta,
        )

    def stub_atmo(atm, altitude):
        one = jnp.ones_like(altitude)
        return AtmosProperties(
            temperature=250.0 * one, pressure=50000.0 * one,
            density=0.7 * one, speed_of_sound=310.0 * one,
        )

    try:
        report_patch = [
            ("wind_const", dyn_mod, "wind_at_altitude", stub_wind),
            ("aero_const", dyn_mod, "aero_coefficients", stub_aero),
            ("atmo_const", dyn_mod, "atmosphere_properties", stub_atmo),
        ]
        for name, mod, sym, stub in report_patch:
            if only and name not in only:
                continue
            orig = getattr(mod, sym)
            setattr(mod, sym, stub)
            try:
                report(name, make_run(cfg))
            finally:
                setattr(mod, sym, orig)
    finally:
        pass

    # smaller batch: per-iteration overhead vs throughput
    if not only or "batch_32k" in (only or []):
        b4 = B // 4
        scene_4, ic_4, _ = sample_dispersions(
            jax.random.PRNGKey(0), scene, ic, n=b4)
        axes_4 = scene_in_axes(scene, scene_4)
        report("batch_32k", make_run(cfg, axes_v=axes_4, scene_v=scene_4,
                                     ic_v=ic_4))

    print("ALL: " + json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
