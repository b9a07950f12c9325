"""Variance-based global sensitivity analysis (Sobol' indices).

Answers "WHICH dispersion channel drives the spread?" — the question the
reference's ``parameter_ranges_observed`` block
(`/root/reference/rocket_simulation/monte_carlo.py:400-473`) gestures at
but never quantifies, and the natural companion to this repo's two local
tools: gradient sensitivities (engine/diff.py — local slopes at the
nominal point) and control variates (mc/cv.py — the linear-response
share). First-order indices S_i give the variance share explained by
channel i alone; total-order indices T_i include every interaction a
channel participates in. T_i >> S_i flags the nonlinear channels where
linear tools (CV, gradients) stop working — measured here: wind
turbulence's apogee effect is almost purely interaction (NOTES.md).

Method: Saltelli pick-freeze with Jansen estimators (Jansen 1999;
Saltelli et al. 2010, "Variance based sensitivity analysis of model
output", eqs. (b)/(f) — the recommended pair):

    S_i = mean(f_B * (f_ABi - f_A)) / V
    T_i = mean((f_A - f_ABi)^2) / (2 V)

with A, B two independent draw matrices and AB_i equal to A except
channel group i's columns, which come from B. Cost: (k_active + 2)
batched simulations of ``n`` lanes each — embarrassingly batch-friendly
(each matrix is one ``simulate_summary_batch`` dispatch).

``pairs=[(g1, g2), ...]`` additionally swaps BOTH groups of each listed
pair at once (matrix AB_{ij}), one extra simulation per pair. The same
first-order estimator applied to the pair swap yields the CLOSED
second-order index S^c_{ij} = (V_i + V_j + V_ij)/V, from which the pure
interaction share S_ij = S^c_{ij} - S_i - S_j follows (Saltelli et al.
2010 §3.3). Subsets of ANY size are accepted the same way — a triple
(g1, g2, g3) yields the pure three-way share by inclusion-exclusion,
provided its pairs are requested too. The measured full-flight
decomposition (NOTES.md) has sum(S) of only 0.27-0.44 — 56-73% of the
variance is interactions — so naming WHICH subsets carry it is the
payoff of this option.

Channel groups mirror ``mc.dispersions`` exactly (the pick-freeze draws
feed the same ``_build_scene`` assembly the production sampler uses, so
the physics and quirks are identical by construction):

  * the 19 scalar channels, grouped by meaning (position, velocity,
    attitude, angular_velocity: 3 dims each; mass, motor_thrust,
    motor_flow, density: Gaussian multipliers; wind_speed,
    wind_direction: uniform offsets),
  * ``wind_turbulence``: the per-lane AR(1) driver noise (grid-knots x 3
    standard normals), frozen/swapped as ONE group via the explicit
    ``noise=`` path of ``models.wind`` (`environment.py:125-200` is the
    reference process being attributed).

Groups that cannot move the output are skipped, not reported as zero:
zero-sigma channels (the default ``initial_position`` sigma is 0) and
``motor_flow`` on solid motors (mdot follows thrust — the same inertness
``mc.cv`` and ``importance_shift`` already special-case). The
reference's recorded-but-unused ``thrust_multiplier`` quirk has no group
by construction (it never acts on the scene).

Validity: lanes are Jansen-paired across matrices, so one diverged lane
anywhere poisons every estimator row it touches; rows are kept only when
VALID IN EVERY MATRIX (the same outlier filter as the analyzer), and
``n_valid`` reports the surviving count. Estimates are conditioned on
that joint-valid population — same convention as every other stats
block (documented bias vs the unconditional population is the outlier
rate's job to keep small).
"""

from __future__ import annotations

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np

from ..engine.batch import simulate_summary_batch
from .dispersions import UncertaintyParams, _build_scene
from .filter import OutlierBounds, outlier_mask

__all__ = ["sobol_indices", "jansen_estimates", "active_groups",
           "select_interaction_pairs", "pure_interactions"]

_SCALAR_GROUPS = (
    # (group, ch key, kind, dims): kind "normal" draws z ~ N(0,1)*sigma,
    # "mult" draws 1 + z*sigma, "uniform" draws lo + (hi-lo)*u
    ("position", "pos_off", "normal", 3),
    ("velocity", "vel_off", "normal", 3),
    ("attitude", "att_off", "normal", 3),
    ("angular_velocity", "omg_off", "normal", 3),
    ("mass", "mass_mult", "mult", 1),
    ("motor_thrust", "motor_thrust_mult", "mult", 1),
    ("motor_flow", "motor_flow_mult", "mult", 1),
    ("wind_speed", "wind_speed", "uniform", 1),
    ("wind_direction", "wind_dir", "uniform", 1),
    ("density", "density_mult", "mult", 1),
)
METRICS = ("apogee_altitude", "range", "flight_time")


def _group_sigmas(scene, params: UncertaintyParams) -> dict:
    return {
        "position": params.initial_position,
        "velocity": params.initial_velocity,
        "attitude": params.initial_attitude,
        "angular_velocity": params.initial_angular_velocity,
        "mass": params.mass_uncertainty,
        "motor_thrust": float(np.asarray(scene.motor.thrust_uncertainty)),
        "motor_flow": float(np.asarray(scene.motor.mass_flow_uncertainty)),
        "wind_speed": params.wind_speed_range[1] - params.wind_speed_range[0],
        "wind_direction": (params.wind_direction_range[1]
                           - params.wind_direction_range[0]),
        "density": params.atmospheric_density_uncertainty,
    }


def active_groups(scene, params: UncertaintyParams = UncertaintyParams(),
                  turbulence: bool = True) -> list:
    """The channel groups that can actually move the output for this
    scene/params combination (zero-sigma groups and the solid motor's
    inert flow multiplier are excluded)."""
    sig = _group_sigmas(scene, params)
    out = []
    for g, _, _, _ in _SCALAR_GROUPS:
        if not np.any(np.asarray(sig[g], np.float64) != 0.0):
            continue
        if g == "motor_flow" and bool(np.asarray(
                scene.motor.mdot_follows_thrust)):
            continue  # drawn but never acts (mdot follows thrust)
        out.append(g)
    if turbulence and float(np.asarray(
            scene.wind_model.turbulence_intensity)) > 0.0:
        out.append("wind_turbulence")
    return out


def _draw_matrix(key, n: int, knots: int, dtype) -> dict:
    """One full standardized draw: z ~ N(0,1) for Gaussian groups,
    u ~ U(0,1) for uniform groups, [n, knots, 3] AR(1) driver noise."""
    d = {}
    for i, (g, _, kind, dims) in enumerate(_SCALAR_GROUPS):
        k = jax.random.fold_in(key, i)
        shape = (n, dims) if dims > 1 else (n,)
        d[g] = (jax.random.uniform(k, shape, dtype=dtype)
                if kind == "uniform"
                else jax.random.normal(k, shape, dtype=dtype))
    d["wind_turbulence"] = jax.random.normal(
        jax.random.fold_in(key, len(_SCALAR_GROUPS)), (n, knots, 3),
        dtype=dtype,
    )
    return d


def _assemble(scene, ic, params, draws, grid, base_wind, dtype):
    """Standardized draws -> batched (Scene, InitialConditions) through
    the SAME ``_build_scene`` the production sampler uses."""
    sig = _group_sigmas(scene, params)
    n = draws["mass"].shape[0]
    ch = {}
    for g, ch_key, kind, dims in _SCALAR_GROUPS:
        z = draws[g]
        if kind == "normal":
            ch[ch_key] = z * jnp.asarray(sig[g], dtype)
        elif kind == "mult":
            ch[ch_key] = 1.0 + z * jnp.asarray(sig[g], dtype)
        else:  # uniform
            lo, hi = {
                "wind_speed": params.wind_speed_range,
                "wind_direction": params.wind_direction_range,
            }[g]
            ch[ch_key] = lo + (hi - lo) * z
    # the reference's recorded-but-unused thrust multiplier: inert, so it
    # gets no pick-freeze group; keep the schema slot at its mean
    ch["thrust_mult_recorded"] = jnp.ones(n, dtype)
    # explicit AR(1) driver noise rides the QMC plumbing with an identity
    # basis: _build_scene computes noise = vt.T @ b_lead = b_lead
    knots = grid.shape[0]
    ch["b_lead"] = draws["wind_turbulence"]
    ch["vt"] = jnp.eye(knots, dtype=dtype)
    # turb_key is unused when direction + noise are explicit; pass a fixed
    # key so assembly is a pure function of the draws
    scene_b, ic_b, _ = _build_scene(scene, ic, ch, jax.random.PRNGKey(0),
                                    base_wind, grid)
    return scene_b, ic_b


def select_interaction_pairs(gaps: dict, threshold: float = 0.1,
                             max_groups: int = 4) -> list:
    """Pure pair-selection rule for ``pairs="auto"``: groups whose
    total-minus-first-order gap (their interaction budget) reaches
    ``threshold`` are candidates; the top ``max_groups`` by gap form all
    2-subsets, in the stable order of ``gaps``'s keys. Deterministic."""
    order = list(gaps)
    cand = [g for g in order if gaps[g] >= threshold]
    cand = sorted(cand, key=lambda g: -gaps[g])[:max_groups]
    cand.sort(key=order.index)
    return [(g1, g2) for i, g1 in enumerate(cand) for g2 in cand[i + 1:]]


def pure_interactions(est: dict, subsets: list) -> dict:
    """Pure interaction share per requested subset from a
    ``jansen_estimates`` output whose ``f_abs`` included the subset
    swaps: the closed subset index minus every strictly smaller effect
    inside it — singles from first order, smaller subsets from the pure
    values already computed (inclusion-exclusion, size order; the caller
    must have requested every sub-subset of any |U| > 2 entry)."""
    pure = {}
    for p in sorted(subsets, key=len):
        val = est["groups"][p]["S"] - sum(
            est["groups"][g]["S"] for g in p
        )
        for q, qv in pure.items():
            if set(q) < set(p):
                val -= qv
        pure[p] = val
    return pure


def jansen_estimates(f_a, f_b, f_abs: dict) -> dict:
    """Pure estimator math on already-masked metric vectors: Jansen
    first-order/total indices per group plus the variance they share.
    Separated from the simulation plumbing so it is unit-testable against
    models with known indices."""
    f_a = np.asarray(f_a, np.float64)
    f_b = np.asarray(f_b, np.float64)
    pooled = np.concatenate([f_a, f_b])
    mean = pooled.mean()
    var = pooled.var()
    out = {"mean": float(mean), "variance": float(var), "groups": {}}
    if var <= 0.0:
        # constant output: no variance to attribute
        for g in f_abs:
            out["groups"][g] = {"S": 0.0, "T": 0.0}
        return out
    a, b = f_a - mean, f_b - mean
    for g, f_ab in f_abs.items():
        ab = np.asarray(f_ab, np.float64) - mean
        out["groups"][g] = {
            "S": float(np.mean(b * (ab - a)) / var),
            "T": float(np.mean((a - ab) ** 2) / (2.0 * var)),
        }
    return out


def sobol_indices(
    scene,
    ic,
    sim_config,
    *,
    params: UncertaintyParams = UncertaintyParams(),
    n: int = 2048,
    seed: int = 0,
    metrics: tuple = METRICS,
    groups: list | None = None,
    base_wind: tuple | None = None,
    wind_grid_points: int = 100,
    wind_grid_top: float = 25000.0,
    bounds: OutlierBounds = OutlierBounds(),
    n_boot: int = 500,
    pairs: list | str | None = None,
) -> dict:
    """Sobol' variance decomposition of the dispersed flight metrics.

    Runs (k_active + 2 + n_pairs) batched simulations of ``n`` lanes
    (matrices A, B, one AB_i per group, one AB_ij per requested pair)
    and returns, per metric::

        {"mean", "variance",
         "first_order": {group: {"S", "ci95"}},
         "total_order": {group: {"T", "ci95"}},
         "second_order": {"g1*g2": {"closed", "interaction", "ci95"}},
         "sum_first_order"}

    plus ``groups`` (the active groups analyzed), ``pairs``, ``n``,
    ``n_valid`` (lanes jointly valid across ALL matrices — the estimator
    population), and ``n_sims`` (total simulated lanes, for budgeting).
    ``second_order`` CIs are on the pure-interaction share
    (closed - S_i - S_j), the quantity one asks the pair option for.

    ``groups=None`` analyzes every active group (``active_groups``).
    ``pairs="auto"`` selects the pairs itself from the first-order run:
    all 2-subsets of the (at most 4) groups whose total-minus-first-order
    gap reaches 0.1 (``select_interaction_pairs``) — near-additive
    regimes get no pair sims at all.
    Deterministic in ``(seed, n, config)`` like every other sampler path.
    Bootstrap CIs resample lanes jointly (the A/B/AB rows of one lane
    stay paired), so they carry the pick-freeze correlation structure.
    """
    if groups is None:
        groups = active_groups(scene, params)
    else:
        known = set(active_groups(scene, params))
        bad = [g for g in groups if g not in known]
        if bad:
            raise ValueError(
                f"unknown or inert groups {bad}; active groups for this "
                f"scene are {sorted(known)}"
            )
    if not groups:
        raise ValueError("no active dispersion channels to analyze")
    auto_pairs = pairs == "auto"
    if not auto_pairs:
        pairs = [tuple(p) for p in (pairs or [])]
        for p in pairs:
            if (len(p) < 2 or len(set(p)) != len(p)
                    or not set(p) <= set(groups)):
                raise ValueError(
                    f"pair {p} must name >= 2 DISTINCT analyzed groups "
                    f"(analyzed: {sorted(groups)})"
                )
        sets = [frozenset(p) for p in pairs]
        if len(set(sets)) != len(sets):
            raise ValueError("duplicate pair/subset requested")
        for p, fs in zip(pairs, sets):
            if len(p) > 2:
                # inclusion-exclusion needs every smaller interaction
                missing = [
                    q for k in range(2, len(p))
                    for q in itertools.combinations(p, k)
                    if frozenset(q) not in sets
                ]
                if missing:
                    raise ValueError(
                        f"subset {p} needs its sub-subsets {missing} "
                        "requested too (inclusion-exclusion)"
                    )
    dtype = jnp.asarray(scene.rocket.dry_mass).dtype
    if base_wind is not None:
        base_wind = (jnp.asarray(base_wind[0], dtype),
                     jnp.asarray(base_wind[1], dtype))
        grid = base_wind[0]
    else:
        grid = jnp.linspace(0.0, wind_grid_top, wind_grid_points,
                            dtype=dtype)

    key = jax.random.PRNGKey(seed)
    draws_a = _draw_matrix(jax.random.fold_in(key, 0), n, grid.shape[0],
                           dtype)
    draws_b = _draw_matrix(jax.random.fold_in(key, 1), n, grid.shape[0],
                           dtype)

    def run(draws):
        scene_b, ic_b = _assemble(scene, ic, params, draws, grid,
                                  base_wind, dtype)
        summary = simulate_summary_batch(scene_b, ic_b, sim_config)
        valid, _ = outlier_mask(summary, bounds)
        vals = {m: np.asarray(getattr(summary, m), np.float64)
                for m in metrics}
        return vals, np.asarray(valid)

    f_a, valid = run(draws_a)
    f_b, v = run(draws_b)
    valid = valid & v
    f_ab = {}
    for g in groups:
        f_ab[g], v = run({**draws_a, g: draws_b[g]})
        valid &= v
    if auto_pairs:
        # interaction budget per group from the matrices already run,
        # on the jointly-valid-so-far lanes; the final estimates below
        # still use the full joint mask including the pair matrices
        if int(valid.sum()) < 16:
            raise ValueError(
                f"only {int(valid.sum())} of {n} lanes are jointly valid "
                "before pair selection; raise n or loosen the bounds"
            )
        gaps = {}
        for g in groups:
            gap = 0.0
            for m in metrics:
                e = jansen_estimates(
                    f_a[m][valid], f_b[m][valid],
                    {g: f_ab[g][m][valid]},
                )["groups"][g]
                gap = max(gap, e["T"] - e["S"])
            gaps[g] = gap
        pairs = select_interaction_pairs(gaps)
    f_ab2 = {}
    for p in pairs:
        f_ab2[p], v = run({**draws_a, **{g: draws_b[g] for g in p}})
        valid &= v
    n_valid = int(valid.sum())
    if n_valid < 16:
        raise ValueError(
            f"only {n_valid} of {n} lanes are jointly valid across all "
            "matrices; raise n or loosen the outlier bounds"
        )

    rng = np.random.default_rng(seed)
    boot_idx = (rng.integers(0, n_valid, (n_boot, n_valid))
                if n_boot > 0 else None)
    out = {
        "n": int(n),
        "n_valid": n_valid,
        "n_sims": int(n * (2 + len(groups) + len(pairs))),
        "groups": list(groups),
        "pairs": ["*".join(p) for p in pairs],
    }

    def _pure_interactions(e):
        return pure_interactions(e, pairs)

    for m in metrics:
        fa, fb = f_a[m][valid], f_b[m][valid]
        fabs = {g: f_ab[g][m][valid] for g in groups}
        fabs.update({p: f_ab2[p][m][valid] for p in pairs})
        est = jansen_estimates(fa, fb, fabs)
        block = {
            "mean": est["mean"],
            "variance": est["variance"],
            "first_order": {}, "total_order": {},
        }
        keys = list(groups) + pairs
        ci = {k: {"S": [None, None], "T": [None, None]} for k in keys}
        if n_boot > 0:
            reps = {k: {"S": np.empty(n_boot), "T": np.empty(n_boot)}
                    for k in keys}
            for r in range(n_boot):
                i = boot_idx[r]
                e = jansen_estimates(fa[i], fb[i],
                                     {k: fabs[k][i] for k in keys})
                for g in groups:
                    reps[g]["S"][r] = e["groups"][g]["S"]
                    reps[g]["T"][r] = e["groups"][g]["T"]
                pr = _pure_interactions(e)
                for p in pairs:
                    # CI on the INTERACTION share, not the closed index
                    reps[p]["S"][r] = pr[p]
            for k in keys:
                for which in (("S", "T") if k in groups else ("S",)):
                    lo, hi = np.percentile(reps[k][which], [2.5, 97.5])
                    ci[k][which] = [float(lo), float(hi)]
        for g in groups:
            block["first_order"][g] = {"S": est["groups"][g]["S"],
                                       "ci95": ci[g]["S"]}
            block["total_order"][g] = {"T": est["groups"][g]["T"],
                                       "ci95": ci[g]["T"]}
        if pairs:
            pure = _pure_interactions(est)
            block["second_order"] = {
                "*".join(p): {
                    "closed": est["groups"][p]["S"],
                    "interaction": pure[p],
                    "ci95": ci[p]["S"],
                }
                for p in pairs
            }
        block["sum_first_order"] = float(
            sum(est["groups"][g]["S"] for g in groups)
        )
        out[m] = block
    return out
