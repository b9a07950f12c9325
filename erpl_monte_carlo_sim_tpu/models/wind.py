"""Wind field model: profile tables, stochastic turbulence, CSV forecasts.

Functional parity with `/root/reference/rocket_simulation/environment.py:110-276`
(WindModel), re-designed for batching:

  * a wind field is a frozen pytree of ``(altitudes[N], wind[N,3])`` — the
    in-flight query is ONE fused searchsorted+gather (`interpolate_vec`)
    instead of three ``np.interp`` calls,
  * the "no wind" case is a 2-point zero table, so the jitted dynamics step
    has no wind/no-wind branch at all,
  * the AR(1) altitude-correlated turbulence generator
    (`environment.py:125-200`) is a ``lax.scan`` over the altitude grid
    driven by ``jax.random`` keys — reproducible by construction and
    vmappable over a Monte Carlo batch of keys,
  * the perturb-a-forecast variant (`environment.py:218-265`) shares the same
    scan core (the reference duplicates the loop).

Distribution parity (not bitwise parity — the reference uses NumPy MT19937):
sigma = 2 m/s decaying exp(-h/2000), correlation exp(-dh/100) clipped to
[0.1, 0.95], innovation sigma*sqrt(max(1-rho^2, 0.01)), vertical x0.3.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import struct
from ..ops.interp import interpolate_vec

__all__ = [
    "WindField",
    "WindModes",
    "WindModelParams",
    "wind_at_altitude",
    "power_law_profile",
    "generate_stochastic_profile",
    "perturb_wind_profile",
    "ar1_transfer_matrix",
    "wind_mode_basis",
    "compress_wind",
    "load_wind_profile_from_csv",
    "load_wind_ensemble_from_csvs",
]


@struct.dataclass
class WindField:
    """Altitude-indexed wind table. ``altitudes[N]`` ascending, ``wind[N,3]``."""

    altitudes: jnp.ndarray
    wind: jnp.ndarray

    @classmethod
    def zero(cls, dtype=jnp.float32) -> "WindField":
        """A no-wind field (the reference's ``wind_profile=None`` path,
        `simulator.py:333-338`) as a degenerate 2-point zero table."""
        return cls(
            altitudes=jnp.array([0.0, 1.0], dtype=dtype),
            wind=jnp.zeros((2, 3), dtype=dtype),
        )

    @classmethod
    def from_arrays(cls, altitudes, wind) -> "WindField":
        return cls(altitudes=jnp.asarray(altitudes), wind=jnp.asarray(wind))


@struct.dataclass
class WindModelParams:
    """Turbulence-generation constants (`environment.py:113-116`)."""

    power_law_exponent: jnp.ndarray = 0.14
    turbulence_intensity: jnp.ndarray = 2.0  # m/s
    correlation_length: jnp.ndarray = 100.0  # m


def wind_at_altitude(field: WindField, altitude) -> jnp.ndarray:
    """Interpolated [u, v, w] at ``altitude`` (`environment.py:267-276`)."""
    return interpolate_vec(altitude, field.altitudes, field.wind)


def power_law_profile(p: WindModelParams, altitude, reference_wind_speed,
                      reference_altitude=10.0) -> jnp.ndarray:
    """Power-law shear profile (`environment.py:118-123`; the reference's
    if/else branches are identical, so this is one expression)."""
    return reference_wind_speed * (altitude / reference_altitude) ** p.power_law_exponent


def _ar1_scan(p: WindModelParams, key, altitudes, mean_uv, mean_w=None,
              noise=None):
    """Shared AR(1) turbulence core over an altitude grid.

    ``mean_uv``: [N,2] mean horizontal wind; ``mean_w``: [N] mean vertical
    (zero for synthesized profiles). ``noise``: optional [N,3] standard
    normals to drive the recursion instead of drawing from ``key`` — the
    injection point for dimension-ordered QMC (mc.dispersions builds
    quasi-random z with exact N(0,I) marginals; the process distribution is
    unchanged because turbulence is linear in z). Returns [N,3] total wind.
    """
    n = altitudes.shape[0]
    dtype = mean_uv.dtype
    if mean_w is None:
        mean_w = jnp.zeros((n,), dtype=dtype)

    sigma = p.turbulence_intensity * jnp.exp(-altitudes / 2000.0)
    dh = jnp.maximum(jnp.diff(altitudes, prepend=altitudes[:1]), 1e-6)
    rho = jnp.clip(jnp.exp(-dh / p.correlation_length), 0.1, 0.95)
    innov_sigma = sigma * jnp.sqrt(jnp.maximum(1.0 - rho**2, 0.01))

    if noise is None:
        noise = jax.random.normal(key, (n, 3), dtype=dtype)
    else:
        noise = jnp.asarray(noise, dtype)

    # First point: independent draw at full sigma (`environment.py:155-164`).
    turb0 = jnp.array([1.0, 1.0, 0.3], dtype=dtype) * sigma[0] * noise[0]

    def step(turb_prev, inputs):
        rho_i, innov_i, noise_i = inputs
        scale = innov_i * jnp.array([1.0, 1.0, 0.3], dtype=dtype)
        turb = rho_i * turb_prev + scale * noise_i
        return turb, turb

    _, turb_rest = jax.lax.scan(
        step, turb0, (rho[1:], innov_sigma[1:], noise[1:])
    )
    turb = jnp.concatenate([turb0[None, :], turb_rest], axis=0)
    mean = jnp.concatenate([mean_uv, mean_w[:, None]], axis=1)
    return mean + turb


def generate_stochastic_profile(
    p: WindModelParams,
    key: jax.Array,
    altitudes,
    base_wind_speed,
    base_wind_direction=None,
    noise=None,
) -> jnp.ndarray:
    """Synthesize a stochastic wind profile (`environment.py:125-200`).

    Mean wind is the power-law shear projected on ``base_wind_direction``
    (drawn uniform [0, 2pi) from ``key`` when None); turbulence is the AR(1)
    process above. Returns [N, 3].
    """
    altitudes = jnp.asarray(altitudes)
    dir_key, turb_key = jax.random.split(key)
    if base_wind_direction is None:
        base_wind_direction = jax.random.uniform(
            dir_key, (), minval=0.0, maxval=2.0 * jnp.pi
        )
    speed = power_law_profile(p, altitudes, base_wind_speed)
    mean_uv = jnp.stack(
        [speed * jnp.cos(base_wind_direction), speed * jnp.sin(base_wind_direction)],
        axis=1,
    )
    return _ar1_scan(p, turb_key, altitudes, mean_uv, noise=noise)


def perturb_wind_profile(
    p: WindModelParams, key: jax.Array, altitudes, base_profile, noise=None
) -> jnp.ndarray:
    """Add AR(1) turbulence around a forecast (`environment.py:218-265`).

    ``base_profile`` is [N,3]; all three components (including w) keep their
    forecast mean, matching the reference.
    """
    altitudes = jnp.asarray(altitudes)
    base_profile = jnp.asarray(base_profile)
    return _ar1_scan(
        p, key, altitudes, base_profile[:, :2], mean_w=base_profile[:, 2],
        noise=noise,
    )


@struct.dataclass
class WindModes:
    """Mode-compressed per-lane wind tables (opt-in fast-mode layout).

    The AR(1) turbulence is LINEAR in its standard-normal driver
    (``turb = A @ z``, see `ar1_transfer_matrix`), so a Monte Carlo batch of
    per-lane [N,3] wind tables lives — up to truncation — in the span of a
    SHARED orthonormal basis ``Q [N, M]`` (top-K left singular vectors of A
    plus the mean-structure columns: constant offset, power-law shear shape,
    optional forecast/ensemble profiles). Each lane then carries only its
    per-component mode scores ``scores [B, M, 3] = einsum('nm,bnc->bmc', Q,
    wind_tables)``, and the in-flight query is

        wind_c(h) = sum_m  Q_m(h) * scores[m, c]

    with ``Q_m(h)`` the shared tent-interpolated basis row — per-lane memory
    traffic per wind eval drops from 3N to 3M table elements (N=100,
    M=K+aux ~ 26 at the default K=24), which is the measured residual
    ceiling of rk2 fast mode (NOTES.md r4 ablation: zero-table-byte
    attribution +19%). EXACT when M >= N (Q square-orthonormal); at K < N
    an opt-in documented approximation whose stats drift is pinned by test
    like ``wind_table_bf16``'s.

    Replaces the same reference query loop (`environment.py:267-276`) as
    ``WindField`` — this is a storage layout, not a physics change.
    """

    altitudes: jnp.ndarray   # [N] shared grid
    basis: jnp.ndarray       # [N, M] shared orthonormal columns
    scores: jnp.ndarray      # [B, M, 3] per-lane mode scores


def wind_mode_basis(p: WindModelParams, altitudes, k: int,
                    extra_profiles=None) -> np.ndarray:
    """Shared [N, M] orthonormal basis for `WindModes` (host-side NumPy).

    Columns, in order: (a) the mean-structure directions — a constant
    column (forecast speed/direction offsets, `monte_carlo.py:276-279`),
    the power-law shear shape (`environment.py:118-123`), and any
    ``extra_profiles`` columns (a [N,3] forecast or [Km,N,3] ensemble whose
    per-component profiles each contribute a column) — then (b) the top-k
    left singular vectors of the AR(1) transfer matrix (the directions
    carrying the most turbulence variance; same SVD infrastructure as
    ``sobol_wind_modes``). Orthonormalized by modified Gram-Schmidt with
    near-dependent columns dropped, so the mean structure is captured
    EXACTLY at any k and projection is a plain transpose-matmul.
    """
    alt = np.asarray(altitudes, np.float64)
    n = alt.shape[0]
    k = int(min(max(k, 0), n))
    cols = [np.ones(n)]
    # power-law shape: reference_altitude=10 m, exponent from params
    # (`power_law_profile`); amplitude is per-lane, shape is shared.
    expo = float(np.asarray(p.power_law_exponent))
    cols.append(np.maximum(alt / 10.0, 0.0) ** expo)
    if extra_profiles is not None:
        prof = np.asarray(extra_profiles, np.float64)
        if prof.ndim == 2:
            prof = prof[None]
        for member in prof:          # [N, 3]
            for c in range(member.shape[1]):
                col = member[:, c]
                if np.abs(col).max() > 0.0:
                    cols.append(col)
    if k > 0:
        a_mat = ar1_transfer_matrix(p, alt)
        u_svd, _, _ = np.linalg.svd(a_mat)
        cols.extend(u_svd[:, :k].T)
    # Modified Gram-Schmidt with drop: mean columns first guarantees their
    # exact capture; dependent turbulence directions merge harmlessly.
    q_cols = []
    for col in cols:
        v = col.astype(np.float64).copy()
        for q in q_cols:
            v -= (q @ v) * q
        nrm = np.linalg.norm(v)
        if nrm > 1e-10 * max(np.linalg.norm(col), 1.0):
            q_cols.append(v / nrm)
        if len(q_cols) >= n:
            break
    return np.stack(q_cols, axis=1)


def compress_wind(field: WindField, basis) -> WindModes:
    """Project a batched ``WindField`` ([B,N,3] per-lane tables) onto the
    shared orthonormal ``basis [N,M]`` -> ``WindModes`` scores [B,M,3].

    Jit-friendly (one matmul); with a square basis (M=N) the projection is
    exact to float roundoff. The one-time cost replaces B*N*3 table bytes
    with B*M*3 score bytes in every downstream wind eval.
    """
    wind = jnp.asarray(field.wind)
    if wind.ndim != 3:
        raise ValueError(
            "compress_wind needs a per-lane [B,N,3] table; shared tables "
            "are already cheap (broadcast lane axis)"
        )
    q = jnp.asarray(basis, wind.dtype)
    scores = jnp.einsum("nm,bnc->bmc", q, wind,
                        precision=jax.lax.Precision.HIGHEST)
    return WindModes(altitudes=jnp.asarray(field.altitudes), basis=q,
                     scores=scores)


def ar1_transfer_matrix(p: WindModelParams, altitudes) -> np.ndarray:
    """Lower-triangular [N,N] map A with ``turb_horizontal = A @ z`` for the
    ``_ar1_scan`` recursion (host-side NumPy; the vertical component is
    0.3*A with the same structure).

    turb_0 = sigma_0 z_0;  turb_i = rho_i turb_{i-1} + innov_i z_i
    =>  A[i, j] = s_j * prod_{m=j+1..i} rho_m   (s_0 = sigma_0, else innov)

    Used by mc.dispersions to order QMC dimensions along the process'
    principal components: the right-singular vectors of A are the directions
    of z that carry the most turbulence variance, so Sobol stratifies those
    and the tail stays pseudo-random. Must mirror ``_ar1_scan``'s constants
    exactly (same sigma decay, dh prepend, rho clip, innovation floor).
    """
    alt = np.asarray(altitudes, np.float64)
    ti = float(np.asarray(p.turbulence_intensity))
    cl = float(np.asarray(p.correlation_length))
    sigma = ti * np.exp(-alt / 2000.0)
    dh = np.maximum(np.diff(alt, prepend=alt[:1]), 1e-6)
    rho = np.clip(np.exp(-dh / cl), 0.1, 0.95)
    innov = sigma * np.sqrt(np.maximum(1.0 - rho**2, 0.01))
    s_ = innov.copy()
    s_[0] = sigma[0]
    # prod_{m=j+1..i} rho_m = exp(logP[i] - logP[j]) with logP[i] = sum_{m<=i}
    logp = np.concatenate([[0.0], np.cumsum(np.log(rho[1:]))])
    ratio = np.exp(logp[:, None] - logp[None, :])
    return np.tril(ratio * s_[None, :])


def load_wind_profile_from_csv(file_path: str):
    """Load an ``altitude,u,v[,w]`` CSV forecast (`environment.py:202-216`).

    Host-side IO (NumPy); returns plain ndarrays for WindField.from_arrays.
    """
    data = np.genfromtxt(file_path, delimiter=",", names=True)
    altitudes = np.atleast_1d(data["altitude"])
    if "w" in data.dtype.names:
        wind = np.vstack([data["u"], data["v"], data["w"]]).T
    else:
        wind = np.vstack([data["u"], data["v"], np.zeros_like(altitudes)]).T
    return altitudes, wind


def load_wind_ensemble_from_csvs(file_paths):
    """Load a forecast ENSEMBLE from per-member CSVs (same format as
    ``load_wind_profile_from_csv``) onto the FIRST member's altitude grid.

    Members on different grids are linearly interpolated per component
    with endpoint clamping (the reference's universal interp convention,
    `utils.py:147-149`). Returns ``(altitudes[N], wind[K,N,3])`` — feed
    the pair straight to ``MonteCarloAnalyzer.base_altitude_profile`` /
    ``base_wind_profile``; each Monte Carlo lane then perturbs a uniformly
    drawn member. No reference counterpart (it holds exactly one forecast,
    `monte_carlo.py:31-32`).
    """
    paths = list(file_paths)
    if not paths:
        raise ValueError("need at least one ensemble member CSV")
    grid, first = load_wind_profile_from_csv(paths[0])
    members = [first]
    for p in paths[1:]:
        alts, wind = load_wind_profile_from_csv(p)
        members.append(np.stack(
            [np.interp(grid, alts, wind[:, c]) for c in range(3)], axis=1
        ))
    return grid, np.stack(members, axis=0)
