"""Generate golden values by executing the reference implementation.

Run once:  python scripts/gen_golden.py
Writes JSON files under tests/golden/ that the pytest suite compares against.

Needs a checkout of the upstream project (smcconoughey/erpl_monte_carlo_sim):
its ``rocket_simulation/`` directory is put on ``sys.path`` below and its
``sample_wind.csv`` is read. Without it this script cannot run; the tests use
the goldens committed under tests/golden/ and skip the comparisons that need
the upstream forecast file itself.
"""
import json
import os
import sys
import numpy as np

sys.path.insert(0, "/root/reference/rocket_simulation")

from rocket import Rocket
from motor import SolidMotor, LiquidMotor
from environment import StandardAtmosphere, WindModel
from simulator import FlightSimulator
import utils as ref_utils

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "golden")


def unit_goldens():
    g = {}
    atm = StandardAtmosphere()
    alts = [0.0, 10.0, 500.0, 1000.0, 5000.0, 10999.0, 11000.0, 11001.0,
            15000.0, 19999.0, 20000.0, 20001.0, 24000.0, 25000.0, 25001.0,
            30000.0, 31999.0, 32000.0, 32001.0, 40000.0, 50000.0, 80000.0, -5.0]
    g["atmosphere"] = {
        "altitudes": alts,
        "properties": [
            {k: float(v) for k, v in atm.get_properties(a).items()} for a in alts
        ],
        "gravity": [float(atm.get_gravity(a)) for a in alts],
    }

    rk = Rocket()
    g["rocket"] = {
        "cp_location": float(rk.cp_location),
        "reference_area": float(rk.reference_area),
        "mass_props": {},
        "aero": [],
        "stability_margin": {},
        "dynamic_cp": [],
    }
    for frac in [1.0, 0.75, 0.5, 0.25, 0.1, 0.0]:
        mp = rk.get_mass_properties(frac)
        g["rocket"]["mass_props"][str(frac)] = {k: float(v) for k, v in mp.items()}
        g["rocket"]["stability_margin"][str(frac)] = float(rk.get_stability_margin(frac))
    cases = []
    for mach in [0.0, 0.3, 0.8, 0.95, 1.0, 1.05, 1.2, 2.5, 3.5]:
        for alpha in [0.0, 0.05, -0.05, 0.3, -0.3, 0.5, 0.9]:
            for beta in [0.0, 0.1, -0.2]:
                for frac in [1.0, 0.0]:
                    mp = rk.get_mass_properties(frac)
                    co = rk.get_aerodynamic_coefficients(mach, alpha, beta, mp, power_on=(frac > 0))
                    cases.append({
                        "mach": mach, "alpha": alpha, "beta": beta, "frac": frac,
                        "coeffs": {k: float(v) for k, v in co.items()},
                    })
    g["rocket"]["aero"] = cases
    for mach in [0.0, 0.5, 0.9, 1.0, 1.1, 1.6, 2.5, 4.0]:
        g["rocket"]["dynamic_cp"].append([mach, float(rk.get_dynamic_cp(mach))])

    sm = SolidMotor()
    lm = LiquidMotor()
    g["motor"] = {"solid": {}, "liquid": {}}
    tp = [(-1.0, 101325.0), (0.0, 101325.0), (0.1, 101325.0), (0.35, 90000.0),
          (1.5, 80000.0), (6.0, 50000.0), (11.0, 20000.0), (13.0, 5000.0),
          (14.5, 1000.0), (15.0, 101325.0), (15.1, 101325.0), (20.0, 0.0)]
    g["motor"]["solid"] = {
        "burn_time": float(sm.burn_time),
        "nozzle_exit_area": float(sm.nozzle_exit_area),
        "average_thrust": float(sm.average_thrust),
        "thrust": [[t, p, float(sm.get_thrust(t, p))] for t, p in tp],
        "thrust_nop": [[t, float(sm.get_thrust(t))] for t, _ in tp],
        "mdot": [[t, float(sm.get_mass_flow_rate(t))] for t, _ in tp],
        "prop_remaining": [[t, float(sm.get_propellant_remaining(t))] for t, _ in tp],
    }
    g["motor"]["liquid"] = {
        "burn_time": float(lm.burn_time),
        "nozzle_exit_area": float(lm.nozzle_exit_area),
        "thrust": [[t, p, float(lm.get_thrust(t, p))] for t, p in tp],
        "mdot": [[t, float(lm.get_mass_flow_rate(t))] for t, _ in tp],
        "prop_remaining": [[t, float(lm.get_propellant_remaining(t))] for t, _ in tp],
    }

    # math kernel goldens
    angsets = [[0.0, 0.0, 0.0], [0.1, -0.2, 0.3], [0.0, -np.pi/2 + 0.02, 0.0],
               [1.0, 0.5, -1.2], [-0.4, 1.1, 2.8]]
    g["math"] = {"euler_quat": [], "wind_to_body": [], "qrate": []}
    for a in angsets:
        q = ref_utils.euler_to_quaternion(*a)
        e = ref_utils.quaternion_to_euler(q)
        R = ref_utils.quaternion_to_rotation_matrix(q)
        g["math"]["euler_quat"].append({
            "euler": a, "quat_wxyz": q.tolist(), "euler_back": e.tolist(),
            "rotmat": R.tolist(),
        })
    for al, be in [(0.0, 0.0), (0.2, -0.1), (-0.7, 0.4)]:
        g["math"]["wind_to_body"].append({
            "alpha": al, "beta": be,
            "matrix": ref_utils.wind_to_body_matrix(al, be).tolist(),
        })
    for omega, q in [([0.1, -0.2, 0.3], [1.0, 0.0, 0.0, 0.0]),
                     ([0.5, 0.5, -0.5], [0.9, 0.1, -0.2, 0.3])]:
        qr = ref_utils.angular_velocity_to_quaternion_rate(np.array(omega), np.array(q))
        g["math"]["qrate"].append({"omega": omega, "q": q, "qdot": qr.tolist()})

    vb_cases = [[10.0, 0.0, 0.0], [100.0, 5.0, -3.0], [1e-7, 2.0, 1e-7],
                [-50.0, 1.0, 20.0], [0.0, 0.0, 0.0]]
    g["math"]["aero_angles"] = [
        {"vb": v,
         "alpha": float(ref_utils.angle_of_attack(np.array(v))),
         "beta": float(ref_utils.sideslip_angle(np.array(v)))}
        for v in vb_cases
    ]
    g["math"]["mach"] = [
        {"v": v, "T": T, "mach": float(ref_utils.mach_number(np.array(v), T))}
        for v, T in [([100.0, 0.0, 0.0], 288.15), ([200.0, 50.0, -30.0], 216.65)]
    ]

    with open(f"{OUT}/units.json", "w") as f:
        json.dump(g, f, indent=1)
    print("wrote units.json")


def flight_golden(motor_kind, wind, name):
    rocket = Rocket()
    motor = LiquidMotor() if motor_kind == "liquid" else SolidMotor()
    atm = StandardAtmosphere()
    wm = WindModel()
    ic = {
        "position": [0.0, 0.0, 10.0],
        "velocity": [0.0, 0.0, 0.0],
        "attitude": [0.0, -np.pi/2 + 0.02, 0.0],
        "angular_velocity": [0.0, 0.0, 0.0],
    }
    sim = FlightSimulator(rocket, motor, atm, wm)
    if wind:
        alt_prof, wind_prof = wm.load_wind_profile_from_csv(
            "/root/reference/rocket_simulation/sample_wind.csv")
        res = sim.simulate_flight(ic, wind_prof, alt_prof)
    else:
        res = sim.simulate_flight(ic)

    t = np.asarray(res["time"])
    alt = np.asarray(res["altitude"])
    spd = np.asarray(res["speed"])
    pos = np.asarray(res["position"])
    # sample trajectory at fixed times
    probe_times = [0.0, 1.0, 5.0, 10.0, 14.0, 15.0, 20.0, 40.0, 60.0, 80.0,
                   100.0, 150.0, 200.0]
    probes = []
    for pt in probe_times:
        if pt <= t[-1]:
            i = int(np.argmin(np.abs(t - pt)))
            probes.append({
                "t": float(t[i]), "alt": float(alt[i]), "speed": float(spd[i]),
                "x": float(pos[0, i]), "y": float(pos[1, i]),
                "prop_frac": float(res["propellant_fraction"][i]),
                "mass": float(res["mass"][i]),
                "aoa": float(res["angle_of_attack"][i]),
                "cd": float(res["cd"][i]),
                "thrust": float(res["thrust"][i]),
            })
    g = {
        "apogee_altitude": float(res["apogee_altitude"]),
        "apogee_time": float(res["apogee_time"]),
        "range": float(res["range"]),
        "flight_time": float(res["flight_time"]),
        "rail_exit_time": float(res["rail_exit_time"]),
        "rail_exit_speed": float(res["rail_exit_speed"]),
        "rail_exit_position": [float(v) for v in res["rail_exit_position"]],
        "rail_exit_velocity": [float(v) for v in res["rail_exit_velocity"]],
        "rail_exit_aoa": float(res["rail_exit_angle_of_attack"]),
        "rail_exit_sideslip": float(res["rail_exit_sideslip"]),
        "n_steps": int(len(t)),
        "probes": probes,
    }
    with open(f"{OUT}/flight_{name}.json", "w") as f:
        json.dump(g, f, indent=1)
    print(f"wrote flight_{name}.json apogee={g['apogee_altitude']:.1f} "
          f"range={g['range']:.1f} ft={g['flight_time']:.1f}")


if __name__ == "__main__":
    unit_goldens()
    flight_golden("liquid", wind=False, name="liquid_nowind")
    flight_golden("solid", wind=False, name="solid_nowind")
    flight_golden("liquid", wind=True, name="liquid_csvwind")
