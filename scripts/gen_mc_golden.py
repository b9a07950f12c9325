"""Distribution-level MC parity goldens: execute the REFERENCE's own Monte
Carlo path (`monte_carlo.py:156-335` — `_generate_parameter_samples` +
`_run_single_simulation`) and record, per lane, (a) the realized dispersion
parameters, (b) the realized per-lane wind profile table, and (c) the flight
summary metrics. The pytest side then certifies BOTH:

  1. lane-matched physics parity — inject the recorded parameters + wind
     tables into this framework's batched engine and compare per-lane and
     population statistics (no sampling noise in the comparison), and
  2. dispersion-semantics parity — run this framework's own sampler at large
     n with the same sigmas and check the reference sample statistics fall
     inside the framework's confidence intervals.

Configurations (VERDICT r3 item 1):
  calm     — SolidMotor, zero wind (turbulence_intensity=0, wind_speed 0),
             zero attitude/rate/velocity offsets; mass/motor/density
             dispersions only. Per-lane deterministic, chaos-free — the
             STATISTICAL anchor (500 lanes committed since r5).
  forecast — LiquidMotor + sample_wind.csv forecast, full default
             uncertainty params, perturbed wind per lane (the example.py
             MC configuration, `example.py:57-66`). Measured r4: the
             reference integrator DIVERGES mid-boost on 213/220 lanes
             (over-stable weathercock + energy-injection instability) —
             these goldens certify divergence-RATE parity, not statistics.
  mildwind — liquid + synthetic wind capped at 2 m/s: built as the
             intended stable full-channel config, but measured to diverge
             exactly like forecast (ANY lateral perturbation — a 0.005 rad
             tilt or a random-direction breeze — destabilizes the
             reference's boost phase; only axisymmetric configs are
             numerically meaningful). Kept as a config for reproducing
             that finding; no golden is committed.

Run (serial, ~19 s/flight on this host):
  python scripts/gen_mc_golden.py --config calm --n 500
  python scripts/gen_mc_golden.py --config forecast --n 220

Output: tests/golden/mc_<config>.jsonl — one JSON object per lane, written
incrementally (resume-safe: lanes already present are skipped).

Needs a checkout of the upstream project (smcconoughey/erpl_monte_carlo_sim):
its ``rocket_simulation/`` directory is put on ``sys.path`` below and its
``sample_wind.csv`` is read. Without it this script cannot run; the tests use
the goldens committed under tests/golden/ and skip the comparisons that need
the upstream forecast file itself.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, "/root/reference/rocket_simulation")

from rocket import Rocket  # noqa: E402
from motor import SolidMotor, LiquidMotor  # noqa: E402
from environment import StandardAtmosphere, WindModel  # noqa: E402
from monte_carlo import MonteCarloAnalyzer  # noqa: E402

OUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "golden")

IC = {
    "position": [0.0, 0.0, 10.0],
    "velocity": [0.0, 0.0, 0.0],
    "attitude": [0.0, -np.pi / 2 + 0.02, 0.0],
    "angular_velocity": [0.0, 0.0, 0.0],
}


def build_analyzer(config):
    rocket = Rocket()
    atm = StandardAtmosphere()
    wm = WindModel()
    if config == "calm":
        motor = SolidMotor()
        # Calm: kill every stochastic channel except mass/motor/density.
        wm.turbulence_intensity = 0.0
        mc = MonteCarloAnalyzer(rocket, motor, atm, wm)
        mc.uncertainty_params["initial_velocity"] = [0.0, 0.0, 0.0]
        mc.uncertainty_params["initial_attitude"] = [0.0, 0.0, 0.0]
        mc.uncertainty_params["initial_angular_velocity"] = [0.0, 0.0, 0.0]
        mc.uncertainty_params["wind_speed_range"] = [0.0, 0.0]
    elif config == "forecast":
        motor = LiquidMotor()
        mc = MonteCarloAnalyzer(rocket, motor, atm, wm)
        alt_prof, wind_prof = wm.load_wind_profile_from_csv(
            "/root/reference/rocket_simulation/sample_wind.csv")
        mc.base_altitude_profile = alt_prof
        mc.base_wind_profile = wind_prof
    elif config == "mildwind":
        # Full dispersion set (IC offsets, synthetic turbulent wind,
        # liquid motor, density) in the wind regime where the reference
        # integrator is numerically stable: the measured forecast config
        # (~15 m/s winds aloft) diverges mid-boost on >90% of lanes —
        # the documented over-stable weathercock instability
        # (`monte_carlo.py:40-44`; SimConfig.energy_consistent_aero's
        # rationale) — so wind_speed_range is capped at 2 m/s here.
        motor = LiquidMotor()
        mc = MonteCarloAnalyzer(rocket, motor, atm, wm)
        mc.uncertainty_params["wind_speed_range"] = [0.0, 2.0]
    else:
        raise ValueError(config)
    return mc


def realized_multipliers(mc, params):
    """Re-derive the REALIZED motor multipliers the reference applied
    (ratio of perturbed to nominal attributes, `motor.py:95-186`)."""
    rs = np.random.RandomState(params["random_seed"])
    pm = mc.motor.perturb_for_monte_carlo(rs)
    if isinstance(mc.motor, SolidMotor):
        thrust_mult = pm.average_thrust / mc.motor.average_thrust
        mdot_mult = pm.mass_flow_rate / mc.motor.mass_flow_rate
    else:
        thrust_mult = pm.thrust_vacuum / mc.motor.thrust_vacuum
        mdot_mult = pm.mass_flow_rate / mc.motor.mass_flow_rate
    return float(thrust_mult), float(mdot_mult)


def lane_record(mc, params, i):
    res = mc._run_single_simulation(dict(IC), params, i)
    if res is None:
        return {"id": i, "failed": True}
    # Wind profile actually used: regenerate with the same RandomState
    # sequence the reference used inside _run_single_simulation
    # (`monte_carlo.py:264-288`).
    if mc.base_wind_profile is not None:
        grid = np.asarray(mc.base_altitude_profile, float)
        wp = mc.wind_model.perturb_wind_profile(
            grid, mc.base_wind_profile,
            random_state=np.random.RandomState(params["random_seed"]))
        wp = wp.copy()
        wp[:, 0] += params["wind_speed"] * np.cos(params["wind_direction"])
        wp[:, 1] += params["wind_speed"] * np.sin(params["wind_direction"])
    else:
        grid = np.linspace(0, 25000, 100)
        wp = mc.wind_model.generate_stochastic_profile(
            grid, params["wind_speed"], params["wind_direction"],
            random_state=np.random.RandomState(params["random_seed"]))
    thrust_mult, mdot_mult = realized_multipliers(mc, params)
    spd = np.asarray(res["speed"], float)
    pos = np.asarray(res["position"], float)
    return {
        "id": i,
        "failed": False,
        "params": {
            "pos_off": [float(v) for v in params["initial_position_offset"]],
            "vel_off": [float(v) for v in params["initial_velocity_offset"]],
            "att_off": [float(v) for v in params["initial_attitude_offset"]],
            "omg_off": [float(v) for v in
                        params["initial_angular_velocity_offset"]],
            "mass_mult": float(params["mass_multiplier"]),
            "thrust_mult_recorded": float(params["thrust_multiplier"]),
            "motor_thrust_mult": thrust_mult,
            "motor_mdot_mult": mdot_mult,
            "wind_speed": float(params["wind_speed"]),
            "wind_direction": float(params["wind_direction"]),
            "density_mult": float(params["density_multiplier"]),
        },
        "wind_grid": [float(v) for v in grid],
        "wind_profile": [[float(c) for c in row] for row in wp],
        "metrics": {
            "apogee_altitude": float(res["apogee_altitude"]),
            "apogee_time": float(res["apogee_time"]),
            "range": float(res["range"]),
            "flight_time": float(res["flight_time"]),
            "rail_exit_time": float(res["rail_exit_time"]),
            "rail_exit_speed": float(res["rail_exit_speed"]),
            "max_speed": float(spd.max()),
            "landing_x": float(pos[0, -1]),
            "landing_y": float(pos[1, -1]),
        },
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=["calm", "forecast", "mildwind"],
                    required=True)
    ap.add_argument("--n", type=int, default=220)
    args = ap.parse_args()

    mc = build_analyzer(args.config)
    out_path = os.path.join(OUT_DIR, f"mc_{args.config}.jsonl")
    done = set()
    if os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["id"])
                except (json.JSONDecodeError, KeyError):
                    pass
    samples = mc._generate_parameter_samples(args.n)
    with open(out_path, "a") as f:
        for i in range(args.n):
            if i in done:
                continue
            rec = lane_record(mc, samples[i], i)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            if (i + 1) % 10 == 0:
                print(f"[{args.config}] {i + 1}/{args.n}", flush=True)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
