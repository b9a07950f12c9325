"""Two-level (coupled) bias correction for tiered-timestep runs.

The fast flags (``SimConfig.descent_dt_scale`` / ``ascent_q_threshold`` /
``wind_eval_per_step`` / ``wind_table_bf16``) trade a tiny deterministic
integration bias for ~4x less step work; per-lane accuracy is pinned in
``tests/test_descent.py``. At large n the population mean's sampling
stderr eventually drops BELOW that bias, and the fast run's headline
means stop being statistically exchangeable with parity ones (the
crossover is around n ~ (sigma/bias)^2 lanes — see
``scripts/two_level_check.py`` for the measured numbers).

The standard repair is the two-level / multilevel-Monte-Carlo identity

    E[f_parity] = E[f_fast] + E[f_parity - f_fast],

estimated with the full-n fast run plus a SMALL batch of COUPLED lanes:
the same dispersion draws simulated under both configs. Because the
lanes are coupled, the difference ``f_parity - f_fast`` has a variance
orders of magnitude below the population variance, so a few thousand
correction lanes pin the bias far under the population sigma — the fast
path keeps its throughput at 100M-lane scale without giving up unbiased
means.

Reference counterpart: none — the reference integrates everything at one
fixed dt (`/root/reference/rocket_simulation/simulator.py:209`). This
block exists precisely because the batched rebuild added tiered
stepping as an opt-in.

The correction batch always draws with ``sampler="prng"`` (plain
i.i.d.): its job is an honest, assumption-free stderr on the bias, and
QMC/antithetic structure in 64-4096 lanes would complicate that for no
useful gain. The correction key is decorrelated from every main-run slab
by folding in a fixed large constant (slab indices are small integers).
"""

from __future__ import annotations

import dataclasses
import time

import jax
import numpy as np

from .dispersions import UncertaintyParams, sample_dispersions
from .filter import OutlierBounds, outlier_mask

__all__ = ["FAST_FIELDS", "parity_twin", "two_level_block", "METRICS"]

# SimConfig fields that change the integrated physics for speed. The other
# opt-ins are either deliberate physics choices (energy_consistent_aero)
# or metadata-only for filtered lanes (terminate_nonfinite, speed_guard),
# and unroll/record_* are exact by construction.
FAST_FIELDS = (
    "descent_dt_scale",
    "ascent_q_threshold",
    "wind_eval_per_step",
    "wind_table_bf16",
    # r5: the midpoint integrator is a fast flag too — its one honest
    # accuracy hole is flight time (+4.3% chute-phase on the full nominal
    # flight, NOTES.md r4), which is EXACTLY what the two-level identity
    # repairs; the parity twin resets it to RK4.
    "integrator",
)

METRICS = ("apogee_altitude", "range", "flight_time")

# fold_in constant for the correction batch key: far outside the dense
# small-integer range used for slab indices (mc/analyzer._run_slabbed).
_KEY_SALT = 0x2B1A5C0



def parity_twin(cfg):
    """``cfg`` with every fast flag reset to its exact-parity default."""
    defaults = type(cfg)()
    return dataclasses.replace(
        cfg, **{f: getattr(defaults, f) for f in FAST_FIELDS}
    )


def two_level_block(
    scene,
    ic,
    cfg,
    n: int,
    key,
    *,
    params: UncertaintyParams = UncertaintyParams(),
    bounds: OutlierBounds = OutlierBounds(),
    base_wind=None,
    wind_grid_points: int = 100,
    wind_grid_top: float = 25000.0,
    fast_transform=None,
) -> dict:
    """Run ``n`` coupled lanes under ``cfg`` and its parity twin; estimate
    the per-metric bias ``E[f_parity - f_fast]``.

    Returns a JSON-ready dict: per metric ``bias``, ``bias_stderr``,
    ``abs_max_delta``, ``population_sigma`` (parity-leg spread, for the
    "at what n does the bias matter" crossover); plus coupling diagnostics
    and per-leg wall times. Callers add the ``corrected_mean``/
    ``corrected_stderr`` fields from their own main-run statistics (see
    ``MonteCarloAnalyzer._two_level``).

    ``fast_transform``: optional ``scene_b -> scene_b`` applied to the FAST
    leg only — the hook for batch-level fast-path representations that
    live outside SimConfig (``wind_table_modes`` compression: the analyzer
    passes its own ``_compress_for_sim`` so the measured bias covers the
    compression too, r5). The parity leg always runs the realized scene.
    """
    from ..engine.batch import simulate_summary_batch

    twin = parity_twin(cfg)
    if twin == cfg and fast_transform is None:
        raise ValueError(
            "two-level correction needs at least one fast flag set "
            f"(one of {FAST_FIELDS}) or a fast_transform; the config is "
            "already exact parity"
        )
    t0 = time.time()
    corr_key = jax.random.fold_in(key, _KEY_SALT)
    scene_b, ic_b, _ = sample_dispersions(
        corr_key, scene, ic, params, n, base_wind=base_wind,
        wind_grid_points=wind_grid_points, wind_grid_top=wind_grid_top,
    )
    runs = {}
    leg_wall = {}
    for label, c in (("fast", cfg), ("parity", twin)):
        t1 = time.time()
        leg_scene = scene_b
        if label == "fast" and fast_transform is not None:
            leg_scene = fast_transform(scene_b)
        s = simulate_summary_batch(leg_scene, ic_b, c)
        m, _ = outlier_mask(s, bounds)
        # np.asarray waits for the device, so leg timing is synchronized
        runs[label] = (
            {k: np.asarray(getattr(s, k)) for k in METRICS}, np.asarray(m)
        )
        leg_wall[label] = round(time.time() - t1, 3)
    both = runs["fast"][1] & runs["parity"][1]
    n_coupled = int(both.sum())
    block = {
        "n_lanes": int(n),
        "n_coupled": n_coupled,
        # lanes whose VALIDITY flips between configs (borderline outliers);
        # excluded from the coupled estimate, counted for transparency
        "mismatched_validity": int(
            (runs["fast"][1] != runs["parity"][1]).sum()
        ),
        "config_delta": {
            f: [getattr(cfg, f), getattr(twin, f)]
            for f in FAST_FIELDS if getattr(cfg, f) != getattr(twin, f)
        },
        "wall_s": 0.0,  # filled below
        "wall_s_legs": leg_wall,
    }
    for k in METRICS:
        par = runs["parity"][0][k][both]
        d = par - runs["fast"][0][k][both]
        if n_coupled >= 2:
            bias = float(d.mean())
            stderr = float(d.std(ddof=1) / np.sqrt(n_coupled))
            amax = float(np.abs(d).max())
            sigma = float(par.std())
        else:  # degenerate run (everything filtered) — NaN, never crash
            bias = stderr = amax = sigma = float("nan")
        block[k] = {
            "bias": bias, "bias_stderr": stderr, "abs_max_delta": amax,
            "population_sigma": sigma,
        }
    block["wall_s"] = round(time.time() - t0, 3)
    return block
