"""Monte Carlo dispersion sampling: one pytree of keys in, one batched Scene out.

Functional parity with the reference's sampling + per-run perturbation
(`/root/reference/rocket_simulation/monte_carlo.py:156-335`,
`motor.py:95-125,171-186`), re-designed for batched execution:

  * ``np.random.seed(i)`` per sample becomes ``jax.random.split`` per lane —
    reproducible by construction and resumable (re-sampling any lane from the
    run key regenerates it exactly),
  * per-object ``deepcopy`` + attribute mutation becomes a vectorized draw
    feeding ``Scene`` leaves with a leading batch axis,
  * thrust dispersion factors out into the scalar ``MotorParams.thrust_scale``
    (see models/motor.py) so the curve tables stay SHARED across the batch,
  * each lane gets its own wind profile (perturbed forecast or synthesized
    AR(1) profile) on a SHARED altitude grid — the only per-lane table.

Reference quirks preserved:
  * ``thrust_multiplier`` is drawn at the analyzer level but NEVER used — the
    motor is perturbed by its own uncertainty draws (`monte_carlo.py:170` vs
    `monte_carlo.py:320-324`). We draw the effective motor multipliers and
    keep a ``thrust_multiplier`` field in the sample record for report parity.
  * the solid motor's burn-time draw is dead: the analyzer re-syncs
    ``burn_time = propellant_mass / mass_flow_rate`` after perturbation
    (`monte_carlo.py:258-260`), overriding it. We apply the re-sync directly.
  * the density multiplier, a no-op in the reference (`monte_carlo.py:326-335`),
    actually scales density here via ``AtmosphereParams.density_scale``.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Optional

import jax
import jax.numpy as jnp

from ..utils import struct
from ..engine.state import InitialConditions
from ..models.scene import Scene
from ..models.wind import (
    WindField,
    generate_stochastic_profile,
    perturb_wind_profile,
)

__all__ = ["UncertaintyParams", "DispersionSample", "sample_dispersions",
           "scene_in_axes", "inject_reference_lanes"]


@dataclasses.dataclass(frozen=True)
class UncertaintyParams:
    """Dispersion sigmas/ranges (`monte_carlo.py:35-48` defaults)."""

    initial_position: tuple = (0.0, 0.0, 0.0)  # m, sigma
    initial_velocity: tuple = (0.1, 0.1, 0.1)  # m/s, sigma
    initial_attitude: tuple = (0.005, 0.005, 0.005)  # rad, sigma
    initial_angular_velocity: tuple = (0.005, 0.005, 0.005)  # rad/s, sigma
    mass_uncertainty: float = 0.02
    thrust_uncertainty: float = 0.03  # recorded; motor uses its own (quirk)
    wind_speed_range: tuple = (0.0, 5.0)  # m/s, uniform
    wind_direction_range: tuple = (0.0, 6.283185307179586)  # rad, uniform
    atmospheric_density_uncertainty: float = 0.05

    def as_dict(self) -> dict:
        """Report-schema-compatible dict (`monte_carlo.py:495`)."""
        return {
            "initial_position": list(self.initial_position),
            "initial_velocity": list(self.initial_velocity),
            "initial_attitude": list(self.initial_attitude),
            "initial_angular_velocity": list(self.initial_angular_velocity),
            "mass_uncertainty": self.mass_uncertainty,
            "thrust_uncertainty": self.thrust_uncertainty,
            "wind_speed_range": list(self.wind_speed_range),
            "wind_direction_range": list(self.wind_direction_range),
            "atmospheric_density_uncertainty": self.atmospheric_density_uncertainty,
        }


@struct.dataclass
class DispersionSample:
    """The drawn parameters, per lane — the reference's per-sample ``params``
    dict (`monte_carlo.py:164-175`) as an SoA pytree. Feeds the
    ``parameter_ranges_observed`` report block."""

    initial_position_offset: jnp.ndarray  # [n, 3]
    initial_velocity_offset: jnp.ndarray  # [n, 3]
    initial_attitude_offset: jnp.ndarray  # [n, 3]
    initial_angular_velocity_offset: jnp.ndarray  # [n, 3]
    mass_multiplier: jnp.ndarray  # [n]
    thrust_multiplier: jnp.ndarray  # [n] (recorded-but-unused quirk)
    motor_thrust_multiplier: jnp.ndarray  # [n] (the one that acts)
    motor_flow_multiplier: jnp.ndarray  # [n]
    wind_speed: jnp.ndarray  # [n]
    wind_direction: jnp.ndarray  # [n]
    density_multiplier: jnp.ndarray  # [n]
    random_seed: jnp.ndarray  # [n] lane index, schema parity
    # forecast-ensemble member index per lane (all zeros without an
    # ensemble base_wind) — feeds mc.ensemble's post-stratified stats
    wind_member: jnp.ndarray  # [n] int32


def _sample_impl(
    key: jax.Array,
    scene: Scene,
    ic: InitialConditions,
    params: UncertaintyParams = UncertaintyParams(),
    n: int = 1000,
    base_wind: Optional[tuple] = None,
    wind_grid_points: int = 100,
    wind_grid_top: float = 25000.0,
    dtype=None,
    antithetic: bool = False,
    sampler: str = "prng",
    sobol_scrambles: int = 1,
    sobol_wind_modes: int = 0,
    importance_shift: tuple = (),
):
    """Draw ``n`` dispersed (Scene, InitialConditions) lanes.

    ``base_wind``: optional ``(altitudes[N], wind[N,3])`` forecast — each lane
    perturbs it with AR(1) turbulence plus a uniform (speed, direction) offset
    (`monte_carlo.py:268-280`). Without it, each lane synthesizes a stochastic
    profile on a 100-point 0-25 km grid (`monte_carlo.py:282-288`).
    An ENSEMBLE of forecasts — ``wind[K,N,3]`` — makes each lane perturb a
    uniformly drawn member instead (mixture-of-forecasts dispersion; no
    reference counterpart — it can hold one forecast,
    `monte_carlo.py:31-32`). Member choice is keyed, so re-simulation by
    lane id reproduces it.

    ``antithetic``: variance reduction the reference cannot offer — each
    Gaussian/uniform draw for the second half of the batch is the mirror of
    the first half (n must be even). Marginal distributions are unchanged;
    the variance of batch means drops because parameter effects cancel in
    pairs. Per-lane wind turbulence keys remain independent.

    ``sobol_scrambles``: with ``sampler="sobol"``, partition the batch into
    this many contiguous blocks, each drawn from its OWN independently
    scrambled Sobol sequence (randomized QMC). Block means are then i.i.d.
    estimates of the target, so their spread gives a statistically valid
    error bar for the QMC result — a single scramble's in-sample std/sqrt(n)
    is NOT a valid QMC error estimate. ``n`` must divide evenly.

    ``sampler``: ``"prng"`` (default, reference-equivalent pseudo-random) or
    ``"sobol"`` — scrambled-Sobol quasi-Monte Carlo over the 19 scalar
    dispersion channels (IC offsets, mass/thrust/flow/density multipliers,
    wind speed/direction). Low-discrepancy points stratify the parameter
    space, so batch statistics converge ~O(1/n) instead of O(1/sqrt(n)) in
    the linear-response regime; marginal distributions are identical
    (inverse-CDF transform). Deterministic in ``key``: the key seeds the
    scramble. Not combinable with antithetic (scrambled Sobol is already
    balanced).

    ``sobol_wind_modes``: with ``sampler="sobol"``, ALSO stratify the
    leading K principal components of each lane's AR(1) wind turbulence
    (3K extra Sobol dimensions: u, v, w per mode). The turbulence is linear
    in its standard-normal driver z (``turb = A z``,
    ``models.wind.ar1_transfer_matrix``), so drawing the top-K
    right-singular directions of A from scrambled Sobol and the orthogonal
    tail from prng keeps the process distribution EXACT while
    low-discrepancy points cover the directions that carry the most
    turbulence variance — the dimension-ordering QMC move the reference's
    300-dim noise could never support (`environment.py:125-200`). 0 = off
    (turbulence fully pseudo-random, the pre-round-3 behavior).

    ``importance_shift``: sorted tuple of ``(channel, sigmas)`` pairs —
    exponential tilting for rare-event estimation. Each named Gaussian
    multiplier channel (``mass`` | ``motor_thrust`` | ``motor_flow`` |
    ``density``) is drawn with its mean shifted by ``sigmas`` standard
    deviations; the likelihood ratio back to the nominal distribution is
    ``exp(sum_c(-theta_c z_c + theta_c^2/2))`` with ``z_c`` the recorded
    standardized draw (see ``mc.importance.log_weights`` — recoverable
    post-hoc from the sample, so the pytree schema is unchanged).
    Prng-only; incompatible with antithetic/sobol.

    Returns ``(batched_scene, batched_ic, sample: DispersionSample)``.
    """
    if dtype is None:
        dtype = jnp.asarray(scene.rocket.dry_mass).dtype
    # Argument validation lives in _validate_sampling (the public
    # sample_dispersions runs it for both sampler paths); only the
    # internal routing invariant is asserted here.
    if sampler == "sobol":
        raise ValueError("_sample_impl is the prng path; use _sample_sobol")
    keys = jax.random.split(key, 12)

    def mirror(draws, center):
        if not antithetic:
            return draws
        half = draws[: n // 2]
        return jnp.concatenate([half, 2 * center - half], axis=0)

    def normal(k, shape, sigma):
        d = jax.random.normal(k, shape, dtype=dtype) * jnp.asarray(sigma, dtype)
        return mirror(d, 0.0)

    def uniform(k, lo, hi):
        return mirror(
            jax.random.uniform(k, (n,), dtype=dtype, minval=lo, maxval=hi),
            0.5 * (lo + hi),
        )

    shift = dict(importance_shift)

    def tilted(k, sigma, name):
        # mean-shifted Gaussian multiplier: 1 + sigma*(z + theta)
        s = jnp.asarray(sigma, dtype)
        return 1.0 + normal(k, (n,), s) + s * shift.get(name, 0.0)

    ch = {
        "pos_off": normal(keys[0], (n, 3), params.initial_position),
        "vel_off": normal(keys[1], (n, 3), params.initial_velocity),
        "att_off": normal(keys[2], (n, 3), params.initial_attitude),
        "omg_off": normal(keys[3], (n, 3), params.initial_angular_velocity),
        "mass_mult": tilted(keys[4], params.mass_uncertainty, "mass"),
        "thrust_mult_recorded": 1.0 + normal(
            keys[5], (n,), params.thrust_uncertainty
        ),
        "motor_thrust_mult": tilted(
            keys[6], scene.motor.thrust_uncertainty, "motor_thrust"
        ),
        "motor_flow_mult": tilted(
            keys[7], scene.motor.mass_flow_uncertainty, "motor_flow"
        ),
        "wind_speed": uniform(keys[8], params.wind_speed_range[0],
                              params.wind_speed_range[1]),
        "wind_dir": uniform(keys[9], params.wind_direction_range[0],
                            params.wind_direction_range[1]),
        "density_mult": tilted(
            keys[10], params.atmospheric_density_uncertainty, "density"
        ),
    }
    if base_wind is not None:
        grid = jnp.asarray(base_wind[0], dtype)
    else:
        grid = jnp.linspace(0.0, wind_grid_top, wind_grid_points, dtype=dtype)
    return _build_scene(scene, ic, ch, keys[11], base_wind, grid)


def _sample_sobol(
    key, scene, ic, params, n, base_wind, wind_grid_points, wind_grid_top,
    dtype, sobol_scrambles, sobol_wind_modes,
):
    """Scrambled-Sobol draw — ONE jitted dispatch, fully device-resident.

    History: the first sobol path ran EVERYTHING eagerly; a later one
    jitted the scene assembly but kept scipy's host-side Sobol + ndtri.
    This version generates the
    scrambled-Sobol matrix on device (`ops/sobol.py`: Gray-code XOR
    construction + hash-based Owen scrambling, Joe-Kuo direction numbers
    baked from the public table), so the draw fuses into the same dispatch
    as the scene assembly. The only remaining host work is the [N,N]
    SVD of the AR(1) transfer matrix for dimension-ordered turbulence QMC
    (~ms, lane-count independent). Columns are consumed in a FIXED order so
    a given (key, n, config) always regenerates identical lanes
    (determinism-by-key).
    """
    import numpy as _np

    if dtype is None:
        dtype = jnp.asarray(scene.rocket.dry_mass).dtype
    if base_wind is not None:
        grid_np = _np.asarray(base_wind[0], _np.float64)
        base_wind = (jnp.asarray(base_wind[0], dtype),
                     jnp.asarray(base_wind[1], dtype))
    else:
        grid_np = _np.linspace(0.0, float(wind_grid_top),
                               int(wind_grid_points))
    grid = jnp.asarray(grid_np, dtype)

    vt = None
    if sobol_wind_modes > 0:
        # Dimension-ordered turbulence QMC: z = V b with V the right-
        # singular vectors of the AR(1) transfer matrix; b's top-K rows come
        # from the Sobol matrix (inverse normal CDF), the tail from prng.
        # V orthogonal + b ~ N(0, I) marginals => z ~ N(0, I) exactly.
        from ..models.wind import ar1_transfer_matrix

        A = ar1_transfer_matrix(scene.wind_model, grid_np)
        _, _, vt_np = _np.linalg.svd(A)
        vt = jnp.asarray(vt_np, dtype)

    return _sample_sobol_jit(
        key, scene, ic, grid, base_wind, vt,
        params=params, n=n, dtype=dtype,
        sobol_scrambles=sobol_scrambles, sobol_wind_modes=sobol_wind_modes,
    )


def _sample_sobol_impl(
    key, scene, ic, grid, base_wind, vt, *, params, n, dtype,
    sobol_scrambles, sobol_wind_modes,
):
    """Traced tail of the sobol path: device Sobol matrix -> inverse-CDF
    channels -> shared scene assembly."""
    from jax.scipy.special import ndtri

    from ..ops.sobol import sobol_uniform

    keys = jax.random.split(key, 12)
    d_sobol = 19 + 3 * int(sobol_wind_modes)
    u = sobol_uniform(keys[0], n, d_sobol, sobol_scrambles, dtype=dtype)
    state = {"next": 0}

    def take(k):
        i = state["next"]
        state["next"] = i + k
        return u[:, i:i + k]

    def normal(shape, sigma):
        cols = shape[1] if len(shape) > 1 else 1
        z = ndtri(take(cols)).reshape(shape)
        return z * jnp.asarray(sigma, dtype)

    def uniform(lo, hi):
        return lo + (hi - lo) * take(1)[:, 0]

    ch = {
        "pos_off": normal((n, 3), params.initial_position),
        "vel_off": normal((n, 3), params.initial_velocity),
        "att_off": normal((n, 3), params.initial_attitude),
        "omg_off": normal((n, 3), params.initial_angular_velocity),
        "mass_mult": 1.0 + normal((n,), params.mass_uncertainty),
        "thrust_mult_recorded": 1.0 + normal((n,), params.thrust_uncertainty),
        "motor_thrust_mult": 1.0 + normal(
            (n,), jnp.asarray(scene.motor.thrust_uncertainty, dtype)
        ),
        "motor_flow_mult": 1.0 + normal(
            (n,), jnp.asarray(scene.motor.mass_flow_uncertainty, dtype)
        ),
        "wind_speed": uniform(params.wind_speed_range[0],
                              params.wind_speed_range[1]),
        "wind_dir": uniform(params.wind_direction_range[0],
                            params.wind_direction_range[1]),
        "density_mult": 1.0 + normal(
            (n,), params.atmospheric_density_uncertainty
        ),
    }
    if sobol_wind_modes > 0:
        k_modes = min(int(sobol_wind_modes), int(grid.shape[0]))
        ch["b_lead"] = ndtri(take(3 * int(sobol_wind_modes)))[
            :, : 3 * k_modes
        ].reshape(n, k_modes, 3)
        ch["vt"] = vt
    return _build_scene(scene, ic, ch, keys[11], base_wind, grid)


_sample_sobol_jit = jax.jit(
    _sample_sobol_impl,
    static_argnames=("params", "n", "dtype", "sobol_scrambles",
                     "sobol_wind_modes"),
)


def _build_scene(scene, ic, ch, turb_key, base_wind, grid):
    """Assemble the batched (Scene, InitialConditions, DispersionSample)
    from channel draws — the traced tail shared by the prng and sobol
    paths (the perturbation semantics of `monte_carlo.py:225-335`)."""
    n = ch["mass_mult"].shape[0]
    dtype = ch["pos_off"].dtype
    mass_mult = ch["mass_mult"]
    wind_speed = ch["wind_speed"]
    wind_dir = ch["wind_dir"]

    # --- rocket: dry + propellant mass scale together (`monte_carlo.py:308-318`)
    rocket = scene.rocket.replace(
        dry_mass=scene.rocket.dry_mass * mass_mult,
        propellant_mass=scene.rocket.propellant_mass * mass_mult,
    )

    # --- motor: thrust scale, mass-flow scale; SOLID scales mdot with thrust
    # (`motor.py:119`), LIQUID draws an independent flow multiplier
    # (`motor.py:175-183`) — both paths then re-sync propellant mass & burn
    # time (`monte_carlo.py:258-260`).
    mdot_mult = (
        ch["motor_thrust_mult"] if scene.motor.mdot_follows_thrust
        else ch["motor_flow_mult"]
    )
    new_prop_mass = scene.rocket.propellant_mass * mass_mult
    new_mdot = scene.motor.mass_flow_rate * mdot_mult
    motor = scene.motor.replace(
        thrust_scale=scene.motor.thrust_scale * ch["motor_thrust_mult"],
        mass_flow_rate=new_mdot,
        propellant_mass=new_prop_mass,
        burn_time=new_prop_mass / new_mdot,
    )

    # --- atmosphere: density dispersion that actually works
    atmosphere = scene.atmosphere.replace(
        density_scale=scene.atmosphere.density_scale * ch["density_mult"]
    )

    # --- wind: per-lane profile on a shared grid
    lane_keys = jax.random.split(turb_key, n)
    qmc_noise = None
    if "noise" in ch:
        # Fully explicit [n, N, 3] standard-normal AR(1) driver — the
        # deterministic u -> scene path (sample_from_normals) that subset
        # simulation's MCMC needs. Mutually exclusive with b_lead.
        qmc_noise = jnp.asarray(ch["noise"], dtype)
    elif "b_lead" in ch:
        b_lead = ch["b_lead"]
        n_knots = grid.shape[0]
        k_modes = b_lead.shape[1]
        b_tail = jax.random.normal(
            jax.random.fold_in(turb_key, 1), (n, n_knots - k_modes, 3),
            dtype=dtype,
        )
        b = jnp.concatenate([jnp.asarray(b_lead, dtype), b_tail], axis=1)
        qmc_noise = jnp.einsum(
            "ij,njc->nic", jnp.asarray(ch["vt"].T, dtype), b,
            precision=jax.lax.Precision.HIGHEST,
        )

    member = jnp.zeros(n, jnp.int32)
    if base_wind is not None:
        base_profile = jnp.asarray(base_wind[1], dtype)
        if base_profile.ndim == 3:
            # Forecast ENSEMBLE [K,N,3]: each lane perturbs a uniformly
            # drawn member — the mixture-of-forecasts dispersion real
            # launch ops run (e.g. GEFS members). One [n,N,3] gather at
            # sampling time; the hot loop still sees one per-lane table.
            # Keyed off its own fold so K=1 reproduces the single-forecast
            # draw bit for bit (pinned by test).
            member = jax.random.randint(
                jax.random.fold_in(turb_key, 2), (n,), 0,
                base_profile.shape[0], dtype=jnp.int32,
            )
            lane_base = base_profile[member]
            if qmc_noise is None:
                profiles = jax.vmap(
                    lambda k, bp: perturb_wind_profile(
                        scene.wind_model, k, grid, bp
                    )
                )(lane_keys, lane_base)
            else:
                profiles = jax.vmap(
                    lambda k, bp, nz: perturb_wind_profile(
                        scene.wind_model, k, grid, bp, noise=nz
                    )
                )(lane_keys, lane_base, qmc_noise)
        elif qmc_noise is None:
            profiles = jax.vmap(
                lambda k: perturb_wind_profile(scene.wind_model, k, grid, base_profile)
            )(lane_keys)
        else:
            profiles = jax.vmap(
                lambda k, nz: perturb_wind_profile(
                    scene.wind_model, k, grid, base_profile, noise=nz
                )
            )(lane_keys, qmc_noise)
        offset = jnp.stack(
            [wind_speed * jnp.cos(wind_dir), wind_speed * jnp.sin(wind_dir),
             jnp.zeros_like(wind_speed)],
            axis=-1,
        )
        profiles = profiles + offset[:, None, :]
    else:
        if qmc_noise is None:
            profiles = jax.vmap(
                lambda k, ws, wd: generate_stochastic_profile(
                    scene.wind_model, k, grid, ws, wd
                )
            )(lane_keys, wind_speed, wind_dir)
        else:
            profiles = jax.vmap(
                lambda k, ws, wd, nz: generate_stochastic_profile(
                    scene.wind_model, k, grid, ws, wd, noise=nz
                )
            )(lane_keys, wind_speed, wind_dir, qmc_noise)
    wind = WindField(altitudes=grid, wind=profiles)

    batched_scene = Scene(
        rocket=rocket, motor=motor, atmosphere=atmosphere, wind=wind,
        wind_model=scene.wind_model,
    )

    batched_ic = InitialConditions(
        position=jnp.asarray(ic.position, dtype) + ch["pos_off"],
        velocity=jnp.asarray(ic.velocity, dtype) + ch["vel_off"],
        attitude=jnp.asarray(ic.attitude, dtype) + ch["att_off"],
        angular_velocity=jnp.asarray(ic.angular_velocity, dtype)
        + ch["omg_off"],
    )

    sample = DispersionSample(
        initial_position_offset=ch["pos_off"],
        initial_velocity_offset=ch["vel_off"],
        initial_attitude_offset=ch["att_off"],
        initial_angular_velocity_offset=ch["omg_off"],
        mass_multiplier=mass_mult,
        thrust_multiplier=ch["thrust_mult_recorded"],
        motor_thrust_multiplier=ch["motor_thrust_mult"],
        motor_flow_multiplier=ch["motor_flow_mult"],
        wind_speed=wind_speed,
        wind_direction=wind_dir,
        density_multiplier=ch["density_mult"],
        random_seed=jnp.arange(n),
        wind_member=member,
    )
    return batched_scene, batched_ic, sample


def inject_reference_lanes(scene: Scene, ic: InitialConditions, params: dict,
                           wind_grid, wind_profiles):
    """Batched (Scene, InitialConditions) from EXPLICIT per-lane dispersion
    values and wind tables — the lane-matched injection path of the MC
    distribution-parity certificate (tests/golden/mc_*.jsonl, generated by
    executing the reference's own `_run_single_simulation`,
    `monte_carlo.py:225-335`, via scripts/gen_mc_golden.py).

    ``params`` holds [n] arrays: ``mass_mult``, ``motor_thrust_mult``,
    ``motor_mdot_mult``, ``density_mult`` and [n, 3] ``pos_off``/
    ``vel_off``/``att_off``/``omg_off``; ``wind_profiles`` is [n, N, 3] on
    the shared ``wind_grid`` [N]. Perturbation semantics mirror
    ``_build_scene`` exactly (mass scales dry+prop, burn-time re-sync,
    functional density scale) — the difference is that every realized
    value comes from the recorded reference run instead of being drawn,
    so population statistics compare with ZERO sampling noise.
    """
    dtype = jnp.asarray(scene.rocket.dry_mass).dtype
    p = {k: jnp.asarray(v, dtype) for k, v in params.items()}
    mass_mult = p["mass_mult"]
    rocket = scene.rocket.replace(
        dry_mass=scene.rocket.dry_mass * mass_mult,
        propellant_mass=scene.rocket.propellant_mass * mass_mult,
    )
    new_prop = scene.rocket.propellant_mass * mass_mult
    new_mdot = scene.motor.mass_flow_rate * p["motor_mdot_mult"]
    motor = scene.motor.replace(
        thrust_scale=scene.motor.thrust_scale * p["motor_thrust_mult"],
        mass_flow_rate=new_mdot,
        propellant_mass=new_prop,
        burn_time=new_prop / new_mdot,
    )
    atmosphere = scene.atmosphere.replace(
        density_scale=scene.atmosphere.density_scale * p["density_mult"]
    )
    wind = WindField(
        altitudes=jnp.asarray(wind_grid, dtype),
        wind=jnp.asarray(wind_profiles, dtype),
    )
    batched_scene = Scene(rocket=rocket, motor=motor, atmosphere=atmosphere,
                          wind=wind, wind_model=scene.wind_model)
    batched_ic = InitialConditions(
        position=jnp.asarray(ic.position, dtype) + p["pos_off"],
        velocity=jnp.asarray(ic.velocity, dtype) + p["vel_off"],
        attitude=jnp.asarray(ic.attitude, dtype) + p["att_off"],
        angular_velocity=jnp.asarray(ic.angular_velocity, dtype)
        + p["omg_off"],
    )
    return batched_scene, batched_ic


def select_lane(batched: Scene, base: Scene, lane) -> Scene:
    """Extract one lane's unbatched Scene from a dispersed batch (leaves that
    gained a batch axis are indexed; shared tables pass through)."""
    import jax

    base_leaves = jax.tree.leaves(base)
    batch_leaves = jax.tree.leaves(batched)
    sel = [
        b[lane] if jnp.ndim(b) > jnp.ndim(bb) else b
        for bb, b in zip(base_leaves, batch_leaves)
    ]
    return jax.tree.unflatten(jax.tree.structure(batched), sel)


# One jit object for the prng path, shared by every caller: executed
# eagerly, sampling is dozens of individually-dispatched ops plus an eager
# AR(1) scan; under jit it is one dispatch. The sobol path has its
# own jit object above (device Sobol generation via ops/sobol.py).
_sample_impl_jit = jax.jit(
    _sample_impl,
    static_argnames=("params", "n", "wind_grid_points", "wind_grid_top",
                     "dtype", "antithetic", "sampler", "sobol_scrambles",
                     "sobol_wind_modes", "importance_shift"),
)


_SAMPLE_SIG = inspect.signature(_sample_impl)


def _validate_sampling(a: dict) -> None:
    """Shared argument validation for both sampler paths."""
    n = a["n"]
    if a["antithetic"] and n % 2 != 0:
        raise ValueError("antithetic sampling needs an even n")
    if a["base_wind"] is not None:
        import numpy as _np

        alts = _np.asarray(a["base_wind"][0])
        prof = _np.asarray(a["base_wind"][1])
        if prof.ndim not in (2, 3) or prof.shape[-1] != 3 \
                or prof.shape[-2] != alts.shape[0]:
            raise ValueError(
                "base_wind must be (altitudes[N], wind[N,3]) or an "
                f"ensemble (altitudes[N], wind[K,N,3]); got altitudes"
                f"{alts.shape}, wind{prof.shape}"
            )
        if prof.ndim == 3 and prof.shape[0] < 1:
            raise ValueError("base_wind ensemble needs at least one member")
    if a["sampler"] not in ("prng", "sobol"):
        raise ValueError(f"unknown sampler {a['sampler']!r}")
    if a["sampler"] == "sobol" and a["antithetic"]:
        raise ValueError("sobol sampling is already balanced; drop antithetic")
    if a["sobol_scrambles"] < 1 or (
        a["sampler"] == "sobol" and n % a["sobol_scrambles"]
    ):
        raise ValueError("n must be a positive multiple of sobol_scrambles")
    if a["sobol_wind_modes"] and a["sampler"] != "sobol":
        raise ValueError("sobol_wind_modes requires sampler='sobol'")
    if a["importance_shift"]:
        import numpy as _np

        motor = a["scene"].motor
        params = a["params"]
        sigmas = {
            "mass": float(params.mass_uncertainty),
            "motor_thrust": float(_np.asarray(motor.thrust_uncertainty)),
            "motor_flow": float(_np.asarray(motor.mass_flow_uncertainty)),
            "density": float(params.atmospheric_density_uncertainty),
        }
        bad = [c for c, _ in a["importance_shift"] if c not in sigmas]
        if bad:
            raise ValueError(
                f"unknown importance channels {bad}; tiltable Gaussian "
                f"multiplier channels are {sorted(sigmas)}"
            )
        if a["sampler"] != "prng" or a["antithetic"]:
            raise ValueError(
                "importance_shift requires sampler='prng' without antithetic"
            )
        for c, _ in a["importance_shift"]:
            # fail BEFORE the (possibly minutes-long) simulation: a
            # zero-sigma channel cannot be tilted, and the solid motor's
            # flow multiplier is drawn but never acts (mdot follows
            # thrust) — tilting it adds exp(theta^2) weight variance with
            # zero extra tail hits, strictly worse than plain counting.
            if sigmas[c] <= 0.0:
                raise ValueError(
                    f"importance channel {c!r} has zero sigma; it cannot "
                    "be tilted"
                )
            if c == "motor_flow" and motor.mdot_follows_thrust:
                raise ValueError(
                    "motor_flow is inert for this motor (mdot follows "
                    "thrust); tilting it only adds weight variance"
                )
    if a["sampler"] == "sobol":
        from ..ops.sobol import max_dims

        d = 19 + 3 * a["sobol_wind_modes"]
        if d > max_dims():
            raise ValueError(
                f"sobol draw needs {d} dimensions but the baked direction-"
                f"number table has {max_dims()}; lower sobol_wind_modes or "
                "regenerate with scripts/gen_sobol_directions.py"
            )


def sample_dispersions(*args, **kwargs):
    """Draw ``n`` dispersed (Scene, InitialConditions) lanes — see
    ``_sample_impl`` for the full signature and contract. Both sampler paths
    run as ONE jitted dispatch (keyed on the static sampling configuration);
    the sobol path's only host work is the small AR(1) SVD for
    dimension-ordered turbulence QMC. Defaults are bound from
    ``_sample_impl``'s own signature so the two can never drift."""
    bound = _SAMPLE_SIG.bind(*args, **kwargs)
    bound.apply_defaults()
    a = dict(bound.arguments)
    _validate_sampling(a)
    if a["sampler"] == "sobol":
        return _sample_sobol(
            a["key"], a["scene"], a["ic"], a["params"], a["n"],
            a["base_wind"], a["wind_grid_points"], a["wind_grid_top"],
            a["dtype"], a["sobol_scrambles"], a["sobol_wind_modes"],
        )
    if a["base_wind"] is not None:
        a["base_wind"] = (
            jnp.asarray(a["base_wind"][0]), jnp.asarray(a["base_wind"][1])
        )
    return _sample_impl_jit(**a)


def normal_dims(wind_grid_points: int = 100) -> int:
    """Dimension of the standard-normal parameterization consumed by
    :func:`sample_from_normals`: 19 scalar dispersion channels (17
    Gaussian + 2 uniform via the probit transform) + ``3 * N`` AR(1)
    turbulence drivers on the ``N``-knot wind grid."""
    return 19 + 3 * int(wind_grid_points)


def _sample_normals_impl(u, scene, ic, grid, base_wind, *, params, dtype):
    """Traced u -> (scene, ic, sample) map. Column layout (fixed contract,
    mirrors the sobol path's consumption order): pos[3], vel[3], att[3],
    omega[3], mass, thrust_recorded, motor_thrust, motor_flow, wind_speed,
    wind_direction, density (19 scalars), then the [N, 3] turbulence
    driver row-major. Every marginal matches the prng path exactly
    (Gaussians are sigma * u; uniforms are lo + (hi - lo) * ndtr(u); the
    AR(1) scan consumes its driver unchanged)."""
    from jax.scipy.special import ndtr

    n = u.shape[0]
    u = jnp.asarray(u, dtype)
    state = {"next": 0}

    def take(k):
        i = state["next"]
        state["next"] = i + k
        return u[:, i:i + k]

    def normal(shape, sigma):
        cols = shape[1] if len(shape) > 1 else 1
        return take(cols).reshape(shape) * jnp.asarray(sigma, dtype)

    def uniform(lo, hi):
        return lo + (hi - lo) * ndtr(take(1)[:, 0])

    ch = {
        "pos_off": normal((n, 3), params.initial_position),
        "vel_off": normal((n, 3), params.initial_velocity),
        "att_off": normal((n, 3), params.initial_attitude),
        "omg_off": normal((n, 3), params.initial_angular_velocity),
        "mass_mult": 1.0 + normal((n,), params.mass_uncertainty),
        "thrust_mult_recorded": 1.0 + normal((n,), params.thrust_uncertainty),
        "motor_thrust_mult": 1.0 + normal(
            (n,), jnp.asarray(scene.motor.thrust_uncertainty, dtype)
        ),
        "motor_flow_mult": 1.0 + normal(
            (n,), jnp.asarray(scene.motor.mass_flow_uncertainty, dtype)
        ),
        "wind_speed": uniform(params.wind_speed_range[0],
                              params.wind_speed_range[1]),
        "wind_dir": uniform(params.wind_direction_range[0],
                            params.wind_direction_range[1]),
        "density_mult": 1.0 + normal(
            (n,), params.atmospheric_density_uncertainty
        ),
    }
    n_knots = grid.shape[0]
    ch["noise"] = take(3 * n_knots).reshape(n, n_knots, 3)
    # turb_key is unused on the explicit-noise path (no ensemble members
    # here — sample_from_normals rejects them); any fixed key works.
    return _build_scene(scene, ic, ch, jax.random.PRNGKey(0), base_wind,
                        grid)


_sample_normals_jit = jax.jit(
    _sample_normals_impl, static_argnames=("params", "dtype"),
)


def sample_from_normals(u, scene, ic,
                        params: UncertaintyParams = UncertaintyParams(),
                        base_wind=None, wind_grid_points: int = 100,
                        wind_grid_top: float = 25000.0, dtype=None):
    """DETERMINISTIC dispersion map: a ``[n, d]`` matrix of standard
    normals -> ``n`` dispersed (Scene, InitialConditions, sample) lanes,
    ``d = normal_dims(N)``.

    This is the whole dispersion distribution re-expressed as a smooth
    push-forward of N(0, I_d) — the representation MCMC-based rare-event
    methods need (``mc.subset``): conditional resampling moves in u-space,
    where the prior is isotropic Gaussian and pCN proposals are exact.
    Same perturbation semantics as ``sample_dispersions`` (same
    ``_build_scene`` tail, `monte_carlo.py:225-335`); marginals are
    identical to the prng path. Forecast ENSEMBLES are rejected — the
    member index is discrete and has no place on the continuous u-space
    (condition on one member and run per member instead)."""
    u = jnp.asarray(u)
    if u.ndim != 2:
        raise ValueError(f"u must be [n, d]; got shape {tuple(u.shape)}")
    if dtype is None:
        dtype = jnp.asarray(scene.rocket.dry_mass).dtype
    if base_wind is not None:
        import numpy as _np

        prof = _np.asarray(base_wind[1])
        if prof.ndim == 3:
            raise ValueError(
                "sample_from_normals does not support forecast ensembles "
                "(discrete member index); condition on a single member"
            )
        grid = jnp.asarray(base_wind[0], dtype)
        base_wind = (grid, jnp.asarray(base_wind[1], dtype))
    else:
        grid = jnp.linspace(0.0, float(wind_grid_top),
                            int(wind_grid_points), dtype=dtype)
    d = normal_dims(int(grid.shape[0]))
    if int(u.shape[1]) != d:
        raise ValueError(
            f"u has {u.shape[1]} columns but this configuration needs "
            f"d = normal_dims({int(grid.shape[0])}) = {d}"
        )
    return _sample_normals_jit(u, scene, ic, grid, base_wind,
                               params=params, dtype=dtype)


def scene_in_axes(base: Scene, batched: Scene) -> Scene:
    """Build the vmap ``in_axes`` pytree for a dispersed scene: axis 0 for
    leaves that gained a batch dimension, None for shared leaves (tables)."""
    def axis(b, v):
        return 0 if jnp.ndim(v) > jnp.ndim(b) else None

    def map_dc(b, v):
        if dataclasses.is_dataclass(b) and not isinstance(b, type):
            kwargs = {}
            for f in dataclasses.fields(b):
                if not f.metadata.get("pytree_node", True):
                    # static field: must keep its value so the axes pytree's
                    # treedef matches the argument's
                    kwargs[f.name] = getattr(b, f.name)
                else:
                    kwargs[f.name] = map_dc(getattr(b, f.name), getattr(v, f.name))
            return type(b)(**kwargs)
        return axis(b, v)

    return map_dc(base, batched)
