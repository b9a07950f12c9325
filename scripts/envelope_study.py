"""Flight-envelope study: cost + fidelity of population bands on the device.

Protocol: a full-flight Monte Carlo (stabilized aero so wind-dispersed
lanes all survive; tiered dt for throughput) at N_MC lanes gives the
summary truth; the envelope then re-simulates N_ENV of those lanes with
trajectory recording in CHUNK-sized batches and reduces each chunk on
device. Reported:

  * wall time per chunk + end-to-end (the envelope's cost model is
    ~linear in chunks: each chunk is one recording run + two O(B*T)
    binning kernels with O(n_bins) readbacks);
  * fidelity cross-checks against the MC summaries of the SAME lanes:
    the envelope's population-max altitude vs max(apogee) (exact match
    modulo record stride), and the altitude p50 band's peak vs the
    median apogee (quantile-sketch error, bounded by bucket width).

Run: PYTHONPATH=. python -u scripts/envelope_study.py \
         [--inline] [--chunk N] [--n-env N] [--hist-stride N]

--inline: frameless in-loop binning for every chunk after the
calibration chunk (engine.batch.simulate_envelope_batch) — no [T, B]
frame buffers, so chunks scale past the frame path's device-memory
ceiling toward the physics path's operating point.
"""
import argparse
import json
import time

import numpy as np

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu.mc import EnvelopeConfig, MonteCarloAnalyzer
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache

_ap = argparse.ArgumentParser()
_ap.add_argument("--inline", action="store_true")
_ap.add_argument("--chunk", type=int, default=4096)
_ap.add_argument("--n-env", type=int, default=8192)
_ap.add_argument("--hist-stride", type=int, default=1)
_args = _ap.parse_args()

N_MC = 65536
N_ENV = _args.n_env
CHUNK = _args.chunk
STRIDE = 8

enable_persistent_cache()

cfg = SimConfig(energy_consistent_aero=True, descent_dt_scale=16,
                ascent_q_threshold=8000.0)
an = MonteCarloAnalyzer(scene=nominal_scene(liquid_motor()), sim_config=cfg)
ic = InitialConditions.vertical_launch()

t0 = time.time()
a = an.run_monte_carlo(ic, n_samples=N_MC, seed=0)
# force host sync happened inside (summary_np); timing is honest
t_mc = time.time() - t0
print(f"MC: {N_MC} full-flight lanes in {t_mc:.1f} s "
      f"({a['n_samples']} valid)", flush=True)

valid = np.asarray(a["valid_mask"])
ids = np.nonzero(valid)[0][:N_ENV]
apogees = np.asarray(a["summary"].apogee_altitude)[ids]

env_cfg = EnvelopeConfig(bin_dt=1.0, record_stride=STRIDE,
                         hist_frame_stride=_args.hist_stride)
t0 = time.time()
chunk_times = []
# instrument per-chunk cost by driving the accumulator directly
from erpl_monte_carlo_sim_tpu.engine.batch import simulate_envelope_batch
from erpl_monte_carlo_sim_tpu.mc.envelope import EnvelopeAccumulator
import dataclasses

rcfg = dataclasses.replace(cfg, record_derived=True, record_stride=STRIDE)
acc = EnvelopeAccumulator(rcfg, env_cfg)
first = 0
if _args.inline:
    # calibration chunk: frame-based, capped at the frame path's safe
    # operating point — inline chunks can then be as large as physics
    # allows (the frame path OOMs above 4096 under this config)
    cal = min(CHUNK, 4096)
    tc = time.time()
    _, traj = an.resimulate_trajectories(ids[:cal], rcfg)
    acc.add(traj)
    an._resim_memo = None
    chunk_times.append(time.time() - tc)
    print(f"  calibration chunk ({cal} lanes, frame-based): "
          f"{chunk_times[-1]:.1f} s", flush=True)
    first = cal
for start in range(first, ids.size, CHUNK):
    tc = time.time()
    sel = ids[start:start + CHUNK]
    if _args.inline and acc._edges is not None:
        scene_sel, ic_sel = an._select_lanes(sel)
        lo, width = acc._edges
        _, agg = simulate_envelope_batch(
            scene_sel, ic_sel, rcfg, channels=env_cfg.channels,
            n_bins=acc.n_bins, n_buckets=env_cfg.n_buckets,
            bin_dt=env_cfg.bin_dt, lo=lo, width=width,
            hist_every=max(1, env_cfg.hist_frame_stride),
        )
        acc.add_aggregates(agg, sel.size)
    else:
        _, traj = an.resimulate_trajectories(sel, rcfg)
        acc.add(traj)
        an._resim_memo = None
    chunk_times.append(time.time() - tc)
    print(f"  chunk {start // CHUNK}: {chunk_times[-1]:.1f} s", flush=True)
env = acc.result()
t_env = time.time() - t0

alt = env["channels"]["altitude"]
pop_max = np.nanmax(np.asarray(alt["max"], float))
p50_peak = np.nanmax(np.asarray(alt["percentiles"]["50"], float))
p95_peak = np.nanmax(np.asarray(alt["percentiles"]["95"], float))
mach_max = np.nanmax(np.asarray(env["channels"]["mach"]["max"], float))
live_bins = int((np.asarray(alt["n"]) > 0).sum())

out = {
    "n_mc": N_MC, "t_mc_s": round(t_mc, 1),
    "n_env": int(ids.size), "chunk": CHUNK, "stride": STRIDE,
    "t_env_s": round(t_env, 1),
    "chunk_s": [round(x, 1) for x in chunk_times],
    "live_bins": live_bins,
    "env_pop_max_alt": round(float(pop_max), 1),
    "mc_max_apogee": round(float(apogees.max()), 1),
    "env_p50_peak_alt": round(float(p50_peak), 1),
    "mc_median_apogee": round(float(np.median(apogees)), 1),
    "env_p95_peak_alt": round(float(p95_peak), 1),
    "mc_p95_apogee": round(float(np.percentile(apogees, 95)), 1),
    "mach_pop_max": round(float(mach_max), 3),
    "clipped_frac_alt": alt["clipped_frac"],
}
print(json.dumps(out, indent=2), flush=True)
