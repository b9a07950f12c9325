#!/usr/bin/env python
"""Headline benchmark: Monte Carlo trajectories/sec/chip at 1k-step flights.

Run on the GPU: ``python bench.py [B]``.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Baseline (BASELINE.md): the reference integrates ~1,640 RK4 steps/s on one
CPU core including its extraction loop, i.e. ~1.64 flights/s at 1k steps.
``vs_baseline`` is speedup per chip over that single-core number.

The benchmarked config matches BASELINE.json config 3: fully dispersed lanes
(mass/thrust/density multipliers, per-lane stochastic wind profiles, IC
offsets) on one chip, ~1k RK4 steps each, full summary statistics.
"""

import json
import sys
import time

import numpy as np


def main() -> None:
    import jax

    from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache
    from erpl_monte_carlo_sim_tpu.utils.device import card_info, device_info

    enable_persistent_cache()
    from erpl_monte_carlo_sim_tpu.engine import (
        InitialConditions,
        SimConfig,
        simulate_summary_batch,
    )
    from erpl_monte_carlo_sim_tpu.mc import sample_dispersions
    from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene

    # 262144 lanes: the operating point carried over from the previous
    # device (16 GB); not yet re-found on the GPU.
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 262144
    # ~1k main-loop steps: rail exit ~0.87 s + 1024 * 5 ms
    cfg = SimConfig(max_time=6.0)

    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    scene_b, ic_b, _ = sample_dispersions(jax.random.PRNGKey(0), scene, ic, n=B)

    # Component-form batch path (engine/batch.py): flat [B] carries,
    # lanes-minor wind tables.
    def run(scene_b, ic_b, cfg):
        return jax.block_until_ready(
            simulate_summary_batch(scene_b, ic_b, cfg))

    r = run(scene_b, ic_b, cfg)  # warm-up / compile

    times = []
    for _ in range(3):
        t0 = time.time()
        r = run(scene_b, ic_b, cfg)
        times.append(time.time() - t0)
    t = min(times)
    steps = int(np.asarray(r.n_steps).max())

    # Fast mode (documented opt-ins, both sub-noise for dispersed MC):
    # one wind eval per step + bf16 wind-table storage.
    fast_cfg = SimConfig(max_time=6.0, wind_eval_per_step=True,
                         wind_table_bf16=True)
    run(scene_b, ic_b, fast_cfg)
    fast_times = []
    for _ in range(3):
        t0 = time.time()
        run(scene_b, ic_b, fast_cfg)
        fast_times.append(time.time() - t0)
    t_fast = min(fast_times)

    # RK2 fast mode: midpoint integrator on top of the fast flags — half
    # the dynamics evaluations. Accuracy pinned in tests/test_batch.py
    # (windowed apogee deltas ~1e-4 m vs 59 m dispersion sigma).
    rk2_cfg = SimConfig(max_time=6.0, wind_eval_per_step=True,
                        wind_table_bf16=True, integrator="rk2")
    run(scene_b, ic_b, rk2_cfg)
    rk2_times = []
    for _ in range(3):
        t0 = time.time()
        run(scene_b, ic_b, rk2_cfg)
        rk2_times.append(time.time() - t0)
    t_rk2 = min(rk2_times)

    # Mode-compressed wind tables on top of rk2 fast: per-lane wind
    # carried as 24 AR(1)-mode scores against a shared orthonormal basis
    # (models.wind.WindModes; analyzer knob wind_table_modes=24). Exact at
    # full rank, stats drift pinned in tests/test_wind_modes.py.
    from erpl_monte_carlo_sim_tpu.models import compress_wind, wind_mode_basis

    q24 = wind_mode_basis(scene.wind_model,
                          np.asarray(scene_b.wind.altitudes), 24)
    scene_m = scene_b.replace(wind=compress_wind(scene_b.wind, q24))
    run(scene_m, ic_b, rk2_cfg)
    modes_times = []
    for _ in range(3):
        t0 = time.time()
        run(scene_m, ic_b, rk2_cfg)
        modes_times.append(time.time() - t0)
    t_modes = min(modes_times)

    # Single-flight p50 latency (full nominal flight to landing). Headline
    # number uses the tiered-timestep fast flags (descent_dt_scale /
    # ascent_q_threshold: coarse RK4 only in dynamically-quiet phases;
    # apogee delta < 0.1 m, landing delta < 1 m vs parity — see
    # tests/test_descent.py); the parity 5 ms-everywhere number is reported
    # alongside.
    full_cfg = SimConfig(descent_dt_scale=16, ascent_q_threshold=8000.0)
    parity_cfg = SimConfig()
    ic_1 = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (1,) + np.shape(x)).copy(), ic
    )

    s = run(scene, ic_1, full_cfg)
    lat = []
    for _ in range(3):
        t0 = time.time()
        s = run(scene, ic_1, full_cfg)
        lat.append(time.time() - t0)

    sp = run(scene, ic_1, parity_cfg)
    lat_parity = []
    for _ in range(3):
        t0 = time.time()
        sp = run(scene, ic_1, parity_cfg)
        lat_parity.append(time.time() - t0)

    value = B / t
    baseline = 1.64  # reference-equivalent 1k-step flights/s on 1 CPU core

    # ---- bytes/lane-step model: each of the 4 RK4 stage evals reads the
    # full [3, N, B] per-lane wind table (the tent basis touches every
    # knot); the true carry is ~25 flat [B] f32/int32 arrays read+written
    # once per step. No device peak is assumed: this is the modelled rate,
    # not a share of any roofline.
    n_knots = int(np.asarray(scene_b.wind.altitudes).shape[0])
    stage_evals = 1 if cfg.wind_eval_per_step else 4
    wind_elem = 2 if cfg.wind_table_bf16 else 4
    model_bytes_per_step = (
        stage_evals * 3 * n_knots * wind_elem  # wind table reads
        + 2 * 25 * 4                           # carry read+write
    )
    achieved_gbps = value * steps * model_bytes_per_step / 1e9
    # Optional cross-check straight from XLA's cost model (bytes accessed
    # for one execution; the while body is counted once, so this is the
    # per-iteration figure the 1.9 GB/iter r1 analysis used).
    xla_bytes_per_iter = None
    try:
        from erpl_monte_carlo_sim_tpu.engine.batch import (
            _run_components,
            prepare_batch,
        )

        scene_nw, grid, wT, ics = prepare_batch(scene_b, ic_b)
        ca = (
            _run_components.lower(scene_nw, grid, wT, cfg, ics)
            .compile()
            .cost_analysis()
        )
        if isinstance(ca, list):
            ca = ca[0]
        xla_bytes_per_iter = float(ca.get("bytes accessed", float("nan")))
    except Exception:
        pass

    print(json.dumps({
        "metric": "mc_trajectories_per_sec_per_chip_1k_steps",
        "value": round(value, 1),
        "unit": "trajectories/s/chip",
        "vs_baseline": round(value / baseline, 1),
        "batch": B,
        "steps": steps,
        "wall_s": round(t, 4),
        "fast_mode_traj_per_s": round(B / t_fast, 1),
        "rk2_fast_mode_traj_per_s": round(B / t_rk2, 1),
        "rk2_modes24_traj_per_s": round(B / t_modes, 1),
        "single_flight_p50_s": round(sorted(lat)[1], 3),
        "single_flight_mode": "tiered dt (descent_dt_scale=16, ascent_q_threshold=8000)",
        "single_flight_parity_p50_s": round(sorted(lat_parity)[1], 3),
        "single_flight_apogee_m": round(float(np.asarray(s.apogee_altitude)[0]), 1),
        "single_flight_parity_apogee_m": round(
            float(np.asarray(sp.apogee_altitude)[0]), 1),
        "model_bytes_per_step": model_bytes_per_step,
        "achieved_gbps": round(achieved_gbps, 1),
        "xla_bytes_per_iter": xla_bytes_per_iter,
        "device": device_info(),
        "card": card_info(),
    }))


if __name__ == "__main__":
    main()
