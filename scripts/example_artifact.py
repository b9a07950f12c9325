"""Record of one run of the full reference workflow (`example.py` — single
flight + forecast-perturbed 50-sample MC + report + all plots).

Runs `erpl_monte_carlo_sim_tpu.example.main` twice (parity and
--stabilized), times each, fingerprints every produced file (sha256 +
size), and writes headline numbers with the device kind to
outputs/example_artifact.json.

Run: PYTHONPATH=. python scripts/example_artifact.py
"""
import glob
import hashlib
import json
import os
import time

import jax

from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache


def run_one(stabilized: bool) -> dict:
    from erpl_monte_carlo_sim_tpu import example

    t0 = time.time()
    results, analysis, output_dir = example.main(
        n_samples=50, stabilized=stabilized)
    wall = time.time() - t0
    files = {}
    for path in sorted(glob.glob(os.path.join(output_dir, "**"),
                                 recursive=True)):
        if os.path.isfile(path):
            digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
            files[os.path.relpath(path, output_dir)] = {
                "sha256": digest, "bytes": os.path.getsize(path),
            }
    return {
        "stabilized": stabilized,
        "wall_s": round(wall, 1),
        "output_dir": output_dir,
        "n_files": len(files),
        "files": files,
        "single_flight": {
            "apogee_m": float(results["apogee_altitude"]),
            "range_m": float(results["range"]),
            "flight_time_s": float(results["flight_time"]),
        },
        "mc": {
            "n_valid": int(analysis["n_samples"]),
            "n_outliers": int(analysis["n_outliers"]),
            "apogee_mean_m": float(analysis["apogee_altitude"]["mean"]),
        },
    }


def main():
    enable_persistent_cache()
    out = {
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind},
        "runs": [run_one(False), run_one(True)],
    }
    os.makedirs("outputs", exist_ok=True)
    with open(os.path.join("outputs", "example_artifact.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "runs"}))
    for r in out["runs"]:
        print(json.dumps({k: v for k, v in r.items() if k != "files"}))


if __name__ == "__main__":
    main()
