"""Regression control variates over the dispersion channels.

Variance reduction the reference cannot offer (its per-sample params go
through a process pool and are never jointly visible,
`/root/reference/rocket_simulation/monte_carlo.py:156-335`): every drawn
dispersion channel has an analytically KNOWN mean under the sampling
distribution, so any linear combination of (standardized) draws is a
valid control variate — subtracting the fitted response `beta . z` from a
metric removes the variance the metric shares with the inputs while
leaving the estimated mean unbiased (up to the O(d/n) plug-in-beta bias,
see below). This captures the same linear-response structure that makes
scrambled-Sobol effective (NOTES.md QMC studies), but works on plain
prng draws, composes with slabbed/streaming runs, and yields a direct
standard error for the adjusted mean.

Filtering correctness: Monte Carlo statistics condition on the outlier
filter, and E[z | valid] is NOT zero (e.g. high-thrust lanes diverge more
often), so naively adjusting the valid-lane mean would bias it. The
estimator here is the RATIO form: both the numerator mean(metric * 1??)
and the denominator mean(1??) are CV-adjusted over ALL lanes (where E[z]
is exactly zero), and the reported mean is their ratio — asymptotically
unbiased for E[metric | valid] with variance from the delta method.

Accumulation is slab-mergeable: each slab contributes CENTERED second
moments about its own mean (f32-safe, same rationale as
``mc.stats.FootprintAccumulator``) merged with Chan's parallel update in
f64, so a 100M-lane run carries O(d^2) host state and the result is
independent of slab count.

Caveats (documented, not hidden):
  * beta is fit on the same sample it adjusts — the classic plug-in
    control-variate estimator. Its bias is O(d/n); with the default ~40
    controls keep n >= a few thousand (``finalize`` reports
    ``n_per_control`` so the regime is visible).
  * stderr formulas assume i.i.d. lanes: exact for ``sampler="prng"``,
    conservative-to-invalid for sobol (use ``qmc_error`` there) and
    antithetic (pairs are dependent; the reduction is understated).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["CVMoments", "control_names", "cv_slab_moments", "finalize_cv",
           "wind_speed_knots", "wind_speed_control_means",
           "wind_speed_ctrl_leaves"]

# Metric targets adjusted by the CV block. landing x/y give the footprint
# mean an adjusted twin; "valid" is the ratio denominator.
TARGETS = ("apogee_altitude", "range", "flight_time",
           "landing_x", "landing_y", "valid")


def _uniform_channels(params):
    """Static description of the two uniform channels; returns
    (ws_active, ws_mid, ws_scale, dir_active, moments) where moments are
    the exact E[cos], E[sin], E[cos2], E[sin2] over the direction range."""
    lo, hi = float(params.wind_speed_range[0]), float(params.wind_speed_range[1])
    ws_active = hi > lo
    ws_mid = 0.5 * (lo + hi)
    ws_scale = (hi - lo) / math.sqrt(12.0) if ws_active else 1.0
    dlo, dhi = (float(params.wind_direction_range[0]),
                float(params.wind_direction_range[1]))
    dir_active = dhi > dlo
    if dir_active:
        w = dhi - dlo
        moments = (
            (math.sin(dhi) - math.sin(dlo)) / w,
            (math.cos(dlo) - math.cos(dhi)) / w,
            (math.sin(2 * dhi) - math.sin(2 * dlo)) / (2 * w),
            (math.cos(2 * dlo) - math.cos(2 * dhi)) / (2 * w),
        )
    else:
        moments = (0.0, 0.0, 0.0, 0.0)
    return ws_active, ws_mid, ws_scale, dir_active, moments


def control_names(params, motor, wind_modes: int = 0,
                  wind_speed_alts=()) -> list:
    """Names of the control columns, in the order ``_controls`` emits them.

    ``wind_modes`` must equal the EFFECTIVE mode count — the projector's
    column count (``wind_mode_projector`` clamps to the grid size), not the
    requested one; a mismatch silently mislabels every column after the
    boundary. The analyzer handles this via ``_cv_names``.
    ``wind_speed_alts``: the knot ALTITUDES actually used (deduplicated —
    ``wind_speed_knots`` can return fewer than requested)."""
    names = []
    for base, sig in (
        ("pos", params.initial_position), ("vel", params.initial_velocity),
        ("att", params.initial_attitude),
        ("omg", params.initial_angular_velocity),
    ):
        for i, s in enumerate(sig):
            if float(s) > 0.0:
                names.append(f"{base}_{'xyz'[i]}")
    names += ["mass", "motor_thrust"]
    if not motor.mdot_follows_thrust:
        names.append("motor_flow")
    names.append("density")
    ws_active, _, _, dir_active, _ = _uniform_channels(params)
    if ws_active:
        names.append("wind_speed")
    if dir_active:
        names += ["cos_dir", "sin_dir"]
    if ws_active and dir_active:
        names += ["wind_x", "wind_y"]
    gaussians = [n for n in names if n.split("_")[0] in
                 ("pos", "vel", "att", "omg", "mass", "motor", "density")]
    names += [f"{n}^2" for n in gaussians]
    if ws_active:
        names.append("wind_speed^2")
    if dir_active:
        names += ["cos_2dir", "sin_2dir"]
    for k in range(wind_modes):
        names += [f"turb_{c}_m{k}" for c in "uvw"]
    for k in range(wind_modes):
        names += [f"turb_{c}_m{k}^2" for c in "uvw"]
    spd = [f"wspd@{a:.0f}m" for a in wind_speed_alts]
    if len(set(spd)) < len(spd):
        # fine grids can round adjacent knots to the same integer meter;
        # duplicate names would silently merge beta entries in finalize_cv
        spd = [f"wspd@{a:.2f}m" for a in wind_speed_alts]
    if len(set(spd)) < len(spd):  # sub-centimeter spacing: index-qualify
        spd = [f"wspd{i}@{a:.2f}m" for i, a in enumerate(wind_speed_alts)]
    names += spd
    names += [f"{s}^2" for s in spd]
    return names


def wind_mode_projector(wind_model, altitudes, k_modes: int) -> np.ndarray:
    """[N, K] projector P with ``scores = P^T turb_component`` standard
    normal under the sampling distribution.

    The AR(1) turbulence is ``turb = A z`` (``models.wind.
    ar1_transfer_matrix``; vertical component 0.3*A), so with A = U S V^T
    the statistic ``u_k^T turb / s_k = v_k^T z`` is exactly N(0, 1) and
    independent across modes/components — a valid control with known
    mean REGARDLESS of sampler (prng, sobol, antithetic). Host-side SVD,
    lane-count independent (~ms at N=100). ``k_modes`` is clamped to the
    grid size; use the returned column count when building the matching
    ``control_names`` list.
    """
    from ..models.wind import ar1_transfer_matrix

    a = ar1_transfer_matrix(wind_model, np.asarray(altitudes, np.float64))
    u, s, _ = np.linalg.svd(a)
    k = min(int(k_modes), len(s))
    return u[:, :k] / s[:k]


def wind_speed_knots(n_grid: int, j: int) -> np.ndarray:
    """``j`` evenly spaced knot INDICES over an ``n_grid``-point altitude
    grid (deduplicated, so the returned count can be < j on tiny grids)."""
    return np.unique(np.round(np.linspace(0, n_grid - 1, int(j))).astype(int))


def _rice_mean(nu, sigma):
    """E|m + t| for a 2-D isotropic Gaussian t ~ N(0, sigma^2 I) around a
    mean of magnitude ``nu`` (the Rice-distribution mean), vectorized and
    stable via exponentially scaled Bessel functions."""
    from scipy.special import i0e, i1e

    nu = np.asarray(nu, np.float64)
    if sigma <= 0.0:
        return nu.copy()
    t = nu * nu / (2.0 * sigma * sigma)
    return (sigma * math.sqrt(math.pi / 2.0)
            * ((1.0 + t) * i0e(t / 2.0) + t * i1e(t / 2.0)))


def wind_speed_control_means(params, wind_model, altitudes, idx,
                             base=None) -> tuple:
    """Exact sampling-distribution means of the horizontal wind speed
    ``|w_uv(h_i)|`` and energy ``|w_uv(h_i)|^2`` at grid knots ``idx``.

    Conditioned on the uniform (wind_speed, wind_direction) draws the
    horizontal wind at a knot is 2-D isotropic Gaussian around the mean
    profile (AR(1) turbulence, per-component sigma from the transfer-matrix
    row norm — ``models.wind.ar1_transfer_matrix``), so E|w| is the Rice
    mean and E|w|^2 adds 2 sigma^2; the uniform channels integrate out by
    Gauss-Legendre quadrature (the integrand is smooth, 48 nodes are exact
    to ~1e-14 — far below f32 lane arithmetic). Mirrors
    ``mc.dispersions._build_scene``: synthesized profiles use the power-law
    shear projected on the direction draw, forecast runs add the uniform
    offset to the base at every knot. Returns ``(e_spd[J], e_energy[J],
    sigma[J])`` as float64 host arrays.
    """
    from ..models.wind import ar1_transfer_matrix

    alt = np.asarray(altitudes, np.float64)
    idx = np.asarray(idx, int)
    a = ar1_transfer_matrix(wind_model, alt)
    sig = np.sqrt((a * a).sum(axis=1))[idx]  # per-component turb sigma

    lo, hi = (float(params.wind_speed_range[0]),
              float(params.wind_speed_range[1]))
    dlo, dhi = (float(params.wind_direction_range[0]),
                float(params.wind_direction_range[1]))

    def gl(a_, b_, n=48):
        if b_ <= a_:
            return np.array([a_]), np.array([1.0])
        x, w = np.polynomial.legendre.leggauss(n)
        return 0.5 * (b_ - a_) * x + 0.5 * (a_ + b_), w / w.sum()

    ws, wws = gl(lo, hi)
    wd, wwd = gl(dlo, dhi)
    e_spd = np.empty(len(idx))
    e_en = np.empty(len(idx))
    if base is None:
        # synthesized: |mean| = ws * c_i, independent of direction
        from ..models.wind import power_law_profile

        c = np.asarray(power_law_profile(wind_model, alt[idx], 1.0),
                       np.float64)
        for j in range(len(idx)):
            nu = ws * c[j]
            e_spd[j] = wws @ _rice_mean(nu, sig[j])
            e_en[j] = wws @ (nu * nu) + 2.0 * sig[j] ** 2
    else:
        b = np.asarray(base, np.float64)[idx, :2]
        cosd, sind = np.cos(wd), np.sin(wd)
        for j in range(len(idx)):
            # |mean|(ws, wd) on the quadrature grid
            mu = np.sqrt(
                (b[j, 0] + ws[:, None] * cosd[None, :]) ** 2
                + (b[j, 1] + ws[:, None] * sind[None, :]) ** 2
            )
            e_spd[j] = wws @ (_rice_mean(mu, sig[j]) @ wwd)
            e_en[j] = wws @ ((mu * mu) @ wwd) + 2.0 * sig[j] ** 2
    return e_spd, e_en, sig


def wind_speed_ctrl_leaves(params, wind_model, altitudes, j, base=None,
                           dtype=jnp.float32) -> tuple:
    """The wind-speed control leaves of the ``wind_ctrl`` pytree
    (``spd_idx``/``spd_mean``/``spd_en_mean``/``spd_scale``/
    ``spd_en_scale``), built in ONE place for the analyzer, the
    kernel-level tests, and the study scripts — the scale constants below
    condition the regression that production runs, tests, and measured
    studies must all share. Returns ``(leaves, idx)``.

    Scales are deterministic O(std) values from the exact first two
    moments (scale choice cannot bias the mean; it only conditions the
    regression): std|w| from the moments, std|w|^2 by first-order
    propagation, floored so near-calm knots stay well-conditioned.
    """
    alt = np.asarray(altitudes, np.float64)
    idx = wind_speed_knots(len(alt), j)
    e_spd, e_en, _ = wind_speed_control_means(params, wind_model, alt, idx,
                                              base=base)
    std = np.sqrt(np.maximum(e_en - e_spd * e_spd, 1e-6))
    scale = np.maximum(std, 0.05)
    scale_en = np.maximum(2.0 * e_spd * std + 2.0 * std * std, 0.1)
    leaves = {
        "spd_idx": jnp.asarray(idx),
        "spd_mean": jnp.asarray(e_spd, dtype),
        "spd_en_mean": jnp.asarray(e_en, dtype),
        "spd_scale": jnp.asarray(scale, dtype),
        "spd_en_scale": jnp.asarray(scale_en, dtype),
    }
    return leaves, idx


def _wind_speed_controls(wind_ctrl, dtype):
    """[n, 2J] columns: realized horizontal wind speed and energy at the
    knots minus their exact means, on deterministic O(1) scales (scale
    choice cannot bias the mean; it only conditions the regression)."""
    w = jnp.asarray(wind_ctrl["wind"], dtype)  # [n, N, 3]
    idx = wind_ctrl["spd_idx"]
    e_spd = jnp.asarray(wind_ctrl["spd_mean"], dtype)  # [J]
    e_en = jnp.asarray(wind_ctrl["spd_en_mean"], dtype)
    scl = jnp.asarray(wind_ctrl["spd_scale"], dtype)
    scl_en = jnp.asarray(wind_ctrl["spd_en_scale"], dtype)
    u = w[:, idx, 0]
    v = w[:, idx, 1]
    en = u * u + v * v
    spd = jnp.sqrt(en)
    return jnp.concatenate([
        (spd - e_spd[None, :]) / scl[None, :],
        (en - e_en[None, :]) / scl_en[None, :],
    ], axis=1)


def _wind_scores(wind_ctrl, dtype):
    """[n, 3K] turbulence-mode scores from the REALIZED per-lane wind
    tables: subtract each lane's deterministic mean profile (power-law
    shear for synthesized profiles, base forecast + uniform offset for
    perturbed ones — mirrors ``mc.dispersions._build_scene``), project the
    residual turbulence on the AR(1) principal directions. Output columns
    are standard normal with exactly zero expectation."""
    from ..models.wind import power_law_profile

    w = jnp.asarray(wind_ctrl["wind"], dtype)  # [n, N, 3]
    ws = jnp.asarray(wind_ctrl["ws"], dtype)
    wd = jnp.asarray(wind_ctrl["wd"], dtype)
    proj = jnp.asarray(wind_ctrl["proj"], dtype)  # [N, K]
    cosd, sind = jnp.cos(wd), jnp.sin(wd)
    if wind_ctrl.get("base") is not None:
        base = jnp.asarray(wind_ctrl["base"], dtype)  # [N, 3]
        off = jnp.stack([ws * cosd, ws * sind, jnp.zeros_like(ws)], axis=-1)
        turb = w - base[None, :, :] - off[:, None, :]
    else:
        speed = power_law_profile(
            wind_ctrl["model"], wind_ctrl["alt"][None, :], ws[:, None]
        )  # [n, N]
        mean_uv = jnp.stack(
            [speed * cosd[:, None], speed * sind[:, None]], axis=-1
        )
        turb = w - jnp.concatenate(
            [mean_uv, jnp.zeros_like(mean_uv[..., :1])], axis=-1
        )
    # scores[n, k, c] = proj[:, k] . turb[n, :, c]; vertical runs at 0.3x
    s = jnp.einsum("nic,ik->nkc", turb, proj,
                   precision=jax.lax.Precision.HIGHEST)
    s = s / jnp.asarray([1.0, 1.0, 0.3], dtype)
    return s.reshape(s.shape[0], -1)


def _controls(sample, params, motor, wind_ctrl=None):
    """[n, d] matrix of controls with EXACT zero mean under sampling.

    Gaussian channels standardize to z = (x - mu)/sigma; uniform wind
    speed to a unit-variance centered draw; wind direction contributes
    first/second circular harmonics minus their analytic means; the
    wind-offset interactions s*cos(d) use E[s]E[cos d] (independent
    draws). Second-order diagonal terms (z^2 - 1 etc.) capture curvature.
    Channels whose sigma/range is statically zero are omitted; the dead
    ``thrust_multiplier`` quirk channel and (for solid motors) the unused
    flow multiplier never enter.
    """
    cols = []
    for arr, sig in (
        (sample.initial_position_offset, params.initial_position),
        (sample.initial_velocity_offset, params.initial_velocity),
        (sample.initial_attitude_offset, params.initial_attitude),
        (sample.initial_angular_velocity_offset,
         params.initial_angular_velocity),
    ):
        for i, s in enumerate(sig):
            if float(s) > 0.0:
                cols.append(arr[:, i] / float(s))
    # multipliers: sigma may be a traced scalar (motor fields); a zero
    # sigma makes the draw identically 1, so the guarded division yields a
    # zero column that finalize_cv drops by its variance.
    def mult(x, sig):
        return (x - 1.0) / jnp.maximum(jnp.asarray(sig, x.dtype), 1e-30)

    cols.append(mult(sample.mass_multiplier,
                     float(params.mass_uncertainty)
                     if float(params.mass_uncertainty) > 0 else 1e-30))
    cols.append(mult(sample.motor_thrust_multiplier,
                     motor.thrust_uncertainty))
    if not motor.mdot_follows_thrust:
        cols.append(mult(sample.motor_flow_multiplier,
                         motor.mass_flow_uncertainty))
    cols.append(mult(sample.density_multiplier,
                     float(params.atmospheric_density_uncertainty)
                     if float(params.atmospheric_density_uncertainty) > 0
                     else 1e-30))

    ws_active, ws_mid, ws_scale, dir_active, (ec, es, ec2, es2) = (
        _uniform_channels(params)
    )
    n_gauss = len(cols)
    if ws_active:
        ws = (sample.wind_speed - ws_mid) / ws_scale
        cols.append(ws)
    if dir_active:
        c = jnp.cos(sample.wind_direction) - ec
        s = jnp.sin(sample.wind_direction) - es
        cols += [c, s]
    if ws_active and dir_active:
        e_speed = ws_mid  # E[s] of the uniform speed draw
        cols.append(sample.wind_speed * jnp.cos(sample.wind_direction)
                    - e_speed * ec)
        cols.append(sample.wind_speed * jnp.sin(sample.wind_direction)
                    - e_speed * es)
    # diagonal second order
    cols += [cols[i] ** 2 - 1.0 for i in range(n_gauss)]
    if ws_active:
        cols.append(ws ** 2 - 1.0)  # unit-variance uniform: E[ws^2] = 1
    if dir_active:
        cols.append(jnp.cos(2.0 * sample.wind_direction) - ec2)
        cols.append(jnp.sin(2.0 * sample.wind_direction) - es2)
    z = jnp.stack(cols, axis=1)
    if wind_ctrl is not None and wind_ctrl.get("proj") is not None:
        # turbulence-mode scores (+ squares: weather-cocking losses are
        # roughly even in crosswind, so the quadratic terms carry much of
        # the apogee response); E[s] = 0 and E[s^2] = 1 exactly
        s = _wind_scores(wind_ctrl, z.dtype)
        z = jnp.concatenate([z, s, s ** 2 - 1.0], axis=1)
    if wind_ctrl is not None and wind_ctrl.get("spd_idx") is not None:
        # realized wind speed/energy at altitude knots: EVEN in the
        # turbulence, with cross-mode and mean x turbulence structure the
        # per-mode diagonal squares cannot span — the weather-cocking
        # response is ~|w|, not w (NOTES.md full-flight CV study)
        z = jnp.concatenate([z, _wind_speed_controls(wind_ctrl, z.dtype)],
                            axis=1)
    return z


def _targets(summary, valid, dtype):
    """[n, T] target stack: metrics zeroed off the jointly-finite valid
    lanes, plus the validity indicator (the ratio denominator)."""
    lp = summary.landing_position
    fin = (valid & jnp.isfinite(summary.apogee_altitude)
           & jnp.isfinite(summary.range) & jnp.isfinite(summary.flight_time)
           & jnp.isfinite(lp[:, 0]) & jnp.isfinite(lp[:, 1]))
    return jnp.stack([
        jnp.where(fin, summary.apogee_altitude, 0.0),
        jnp.where(fin, summary.range, 0.0),
        jnp.where(fin, summary.flight_time, 0.0),
        jnp.where(fin, lp[:, 0], 0.0),
        jnp.where(fin, lp[:, 1], 0.0),
        fin.astype(dtype),
    ], axis=1).astype(dtype)


@partial(jax.jit, static_argnames=("params",))
def cv_slab_moments(sample, summary, valid, include, params, motor,
                    wind_ctrl=None):
    """One slab's centered CV moments, reduced ON DEVICE.

    Readback is O(d^2) scalars (d ~ 40), not O(n d): (n_inc, mean_z [d],
    mean_t [T], Szz [d,d], Szt [d,T], Stt [T,T]) with the S-matrices
    centered about this slab's own means (f32 raw cross-moments of
    25 km-scale metrics over 262k lanes would lose ~3 digits).
    ``include`` masks padding lanes of a ragged final slab. The z'z
    reduction is one [d,n]x[n,d] matmul on the device, not a host loop,
    at HIGHEST precision (a reduced-precision f32 Gram matrix would eat
    the variance-reduction factors the analyzer reports).
    """
    z = _controls(sample, params, motor, wind_ctrl)
    t = _targets(summary, valid, z.dtype)
    inc = include.astype(z.dtype)[:, None]
    n = jnp.sum(include)
    nf = jnp.maximum(n, 1).astype(z.dtype)
    z = z * inc  # zero excluded lanes so they drop out of every sum
    t = t * inc
    mz = jnp.sum(z, axis=0) / nf
    mt = jnp.sum(t, axis=0) / nf
    zc = (z - mz) * inc
    tc = (t - mt) * inc
    hi = jax.lax.Precision.HIGHEST
    return (n, mz, mt, jnp.matmul(zc.T, zc, precision=hi),
            jnp.matmul(zc.T, tc, precision=hi),
            jnp.matmul(tc.T, tc, precision=hi))


class CVMoments:
    """f64 host accumulator for slab CV moments (Chan's parallel merge,
    generalized to the cross-moment matrices)."""

    def __init__(self):
        self.n = 0
        self.mz = self.mt = None
        self.szz = self.szt = self.stt = None

    def add(self, moments) -> None:
        # copy=True: device_get hands back read-only buffers, and the
        # merge mutates these in place
        n, mz, mt, szz, szt, stt = (np.array(m, np.float64)
                                    for m in moments)
        n = int(n)
        if n == 0:
            return
        if self.n == 0:
            self.n, self.mz, self.mt = n, mz, mt
            self.szz, self.szt, self.stt = szz, szt, stt
            return
        na, nb = self.n, n
        tot = na + nb
        dz = mz - self.mz
        dt = mt - self.mt
        w = na * nb / tot
        self.szz += szz + np.outer(dz, dz) * w
        self.szt += szt + np.outer(dz, dt) * w
        self.stt += stt + np.outer(dt, dt) * w
        self.mz += dz * nb / tot
        self.mt += dt * nb / tot
        self.n = tot


def _ratio_stats(mu, cov, a, iv, n):
    """Delta-method mean/stderr of target a's valid-lane mean (ratio of
    adjusted means numerator/denominator)."""
    d = mu[iv]
    if d <= 0.0:
        return float("nan"), float("nan")
    r = mu[a] / d
    var = (cov[a, a] - 2.0 * r * cov[a, iv] + r * r * cov[iv, iv]) / (
        n * d * d
    )
    return float(r), float(np.sqrt(max(var, 0.0)))


def finalize_cv(acc: CVMoments, names: list) -> dict:
    """Solve the regression and emit the analysis block.

    Returns, per metric: the CV-adjusted valid-lane mean with its delta-
    method stderr, the plain (unadjusted) mean/stderr from the same
    moments, and the measured variance-reduction factor; plus the fitted
    ``beta`` per control (a free global sensitivity readout: beta[k] is
    the metric's linear response to one sigma of control k).
    """
    if acc.n == 0:
        return {"n": 0, "controls": names}
    n = acc.n
    mu_t = acc.mt
    sigma_tt = acc.stt / n
    out = {"n": n, "controls": list(names)}
    iv = TARGETS.index("valid")

    plain = {}
    for a, name in enumerate(TARGETS[:-1]):
        plain[name] = _ratio_stats(mu_t, sigma_tt, a, iv, n)

    # Drop constant columns (statically-zero sigmas already never enter;
    # this catches traced zero sigmas and degenerate draws), then solve
    # with a relative ridge for conditioning.
    var_z = np.diag(acc.szz) / n
    keep = var_z > 1e-12 * max(var_z.max(), 1e-30)
    d_kept = int(keep.sum())
    out["n_per_control"] = float(n / max(d_kept, 1))
    if d_kept == 0 or n < 4 * d_kept:
        # Not enough lanes to fit beta honestly: report plain stats only.
        out["insufficient_samples"] = True
        for name, (m, se) in plain.items():
            out[name] = {"mean": m, "stderr": se, "plain_mean": m,
                         "plain_stderr": se, "variance_reduction": 1.0}
        return out

    szz = acc.szz[np.ix_(keep, keep)] / n
    szt = acc.szt[keep] / n
    ridge = 1e-9 * np.trace(szz) / d_kept
    beta = np.linalg.solve(szz + ridge * np.eye(d_kept), szt)  # [d,T]
    # adjusted target means: E[z] = 0 exactly, so subtract beta . mean(z)
    mu_adj = mu_t - beta.T @ acc.mz[keep]
    resid = sigma_tt - szt.T @ beta  # residual covariance of targets
    # guard tiny negative diagonals from cancellation
    np.fill_diagonal(resid, np.maximum(np.diag(resid), 0.0))

    kept_names = [nm for nm, k in zip(names, keep) if k]
    out["kept_controls"] = kept_names
    for a, name in enumerate(TARGETS[:-1]):
        mean, se = _ratio_stats(mu_adj, resid, a, iv, n)
        pm, pse = plain[name]
        vr = (pse / se) ** 2 if se > 0 and np.isfinite(se) else float("nan")
        out[name] = {
            "mean": mean, "stderr": se,
            "plain_mean": pm, "plain_stderr": pse,
            "variance_reduction": vr,
            "beta": {nm: float(b) for nm, b in zip(kept_names, beta[:, a])},
        }
    return out
