"""Quantify sobol-sampling overhead at slab scale (VERDICT r2 item 6).

Both sampler paths now run as ONE jitted dispatch: the sobol draw is
generated ON DEVICE (ops/sobol.py — Gray-code XOR construction +
hash-based Owen scrambling) and fuses with the scene assembly; the only
host work left is the small AR(1) SVD for turbulence-mode QMC. The
pre-device-path numbers (host scipy Sobol + ndtri): 0.89 s/262k slab
scalar, 4.3 s/slab with wind24. This measures the current cost per slab
so it stays a recorded number, not a guess.

Run: PYTHONPATH=. python scripts/measure_sobol_overhead.py
"""
import json
import time

import jax

from erpl_monte_carlo_sim_tpu.engine import InitialConditions
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()
SCENE = nominal_scene(liquid_motor())
IC = InitialConditions.vertical_launch()
N = 262_144


def timed(label, **kw):
    # warm-up (compiles the jitted prng path / populates sobol direction nums)
    jax.block_until_ready(
        sample_dispersions(jax.random.PRNGKey(0), SCENE, IC, n=N, **kw))
    times = []
    for i in range(3):
        t0 = time.time()
        jax.block_until_ready(sample_dispersions(
            jax.random.PRNGKey(i + 1), SCENE, IC, n=N, **kw
        ))
        times.append(time.time() - t0)
    out = {"label": label, "n": N, "best_s": round(min(times), 3),
           "times_s": [round(t, 3) for t in times]}
    print(json.dumps(out), flush=True)
    return out


def main():
    rows = [
        timed("prng (jitted)"),
        timed("sobol scalar", sampler="sobol"),
        timed("sobol+wind8", sampler="sobol", sobol_wind_modes=8),
        timed("sobol+wind24", sampler="sobol", sobol_wind_modes=24),
    ]
    base = rows[0]["best_s"]
    print(json.dumps({
        "slab": N,
        "overhead_vs_prng_s": {
            r["label"]: round(r["best_s"] - base, 3) for r in rows[1:]
        },
        "note": "per-262k-slab sampling cost; sim itself is ~1.7 s/slab "
                "(bench parity)",
    }))


if __name__ == "__main__":
    main()
