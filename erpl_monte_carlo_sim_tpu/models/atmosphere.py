"""US-Standard-1976-style layered atmosphere as a branch-free pytree model.

Functional parity with `/root/reference/rocket_simulation/environment.py:8-108`
(five pressure regimes with the reference's exact layer formulas, including
its quirks: the 25 km anchor temperature of 216.65 K used in the 25-32 km
gradient layer, the 228.65 K / 180 K temperature clamps, and the hard-coded
868.02 Pa pressure anchor at 32 km), re-designed as a pure function over a
frozen dataclass so that:

  * all five regimes are evaluated branch-free and selected with ``jnp.where``
    (XLA fuses the whole thing into the dynamics step; no data-dependent
    control flow under ``jit``/``vmap``),
  * every intermediate is clamped so lanes far outside a regime still produce
    finite values in the *untaken* branch (keeps ``jax_debug_nans`` and
    gradients clean),
  * the Monte Carlo density dispersion is an actual ``density_scale`` factor.
    (In the reference this knob was a functional no-op: `monte_carlo.py:326-335`
    scales ``sea_level_density`` but `environment.py:93` computes rho = p/(RT)
    and never reads it. Here the advertised 5% density dispersion works.)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..utils import struct
from ..ops.frames import GAMMA_AIR, R_AIR

__all__ = ["AtmosphereParams", "AtmosProperties", "atmosphere_properties", "gravity_at"]

EARTH_RADIUS = 6.371e6  # m (`environment.py:107`)


@struct.dataclass
class AtmosphereParams:
    """Frozen scene parameters for the layered standard atmosphere.

    Defaults mirror `environment.py:11-24`. All fields are jnp-compatible
    scalars so the whole params object vmaps over a Monte Carlo batch.
    """

    sea_level_pressure: jnp.ndarray = 101325.0  # Pa
    sea_level_temperature: jnp.ndarray = 288.15  # K
    temperature_lapse_rate: jnp.ndarray = 0.0065  # K/m
    gas_constant: jnp.ndarray = R_AIR  # J/(kg K)
    gravity: jnp.ndarray = 9.80665  # m/s^2 (surface reference)
    gamma: jnp.ndarray = GAMMA_AIR
    troposphere_height: jnp.ndarray = 11000.0  # m
    stratosphere_height: jnp.ndarray = 20000.0  # m
    stratosphere_temp: jnp.ndarray = 216.65  # K
    # Functional replacement for the reference's dead `sea_level_density`
    # multiplier (see module docstring). 1.0 = nominal.
    density_scale: jnp.ndarray = 1.0

    @classmethod
    def create(cls, density_scale: float = 1.0) -> "AtmosphereParams":
        return cls(density_scale=jnp.asarray(density_scale))


class AtmosProperties(NamedTuple):
    temperature: jnp.ndarray
    pressure: jnp.ndarray
    density: jnp.ndarray
    speed_of_sound: jnp.ndarray


def atmosphere_properties(p: AtmosphereParams, altitude) -> AtmosProperties:
    """Atmospheric state at ``altitude`` (m). Branch-free, vmap-safe.

    Regime layout (parity with `environment.py:26-96`):
      h <= 11 km   troposphere, linear lapse + power-law pressure
      11-20 km     isothermal 216.65 K, exponential pressure
      20-25 km     isothermal continuation (reference keeps T formula
                   216.65 + 0.001 (h-20k) for *temperature* but integrates
                   pressure isothermally at 216.65 K)
      25-32 km     gradient layer, anchor T=216.65 at 25 km, 0.0028 K/m
                   exponent in the pressure power law
      > 32 km      mesosphere: T = max(228.65 - 0.0028 (h-32k), 180),
                   p = 868.02 * exp(-(h-32k)/H), H = R T / g
    """
    h = jnp.asarray(altitude)
    g = p.gravity
    R = p.gas_constant
    L = p.temperature_lapse_rate
    T0 = p.sea_level_temperature
    P0 = p.sea_level_pressure
    Ts = p.stratosphere_temp
    h_trop = p.troposphere_height
    h_strat = p.stratosphere_height

    pow_exp = g / (R * L)  # ~5.2558

    # Layer-boundary pressures (scalars derived from params; XLA folds these
    # to constants for unperturbed scenes, and they broadcast under vmap for
    # perturbed ones).
    p11 = P0 * (Ts / T0) ** pow_exp
    p20 = p11 * jnp.exp(-g * (h_strat - h_trop) / (R * Ts))
    p25 = p20 * jnp.exp(-g * 5000.0 / (R * Ts))

    # --- temperatures per regime (clamped so out-of-regime lanes stay finite)
    t_tropo = T0 - L * h
    t_iso = jnp.broadcast_to(Ts, jnp.shape(h))
    # 20-32 km: linear increase capped at 228.65 K (`environment.py:52-53`)
    t_upper = jnp.minimum(Ts + 0.001 * (h - h_strat), 228.65)
    # > 32 km mesosphere with 180 K floor (`environment.py:84-85`)
    t_meso = jnp.maximum(228.65 - 0.0028 * (h - 32000.0), 180.0)

    # --- pressures per regime
    # Troposphere: clamp T > 0 so the fractional power stays finite for
    # lanes whose altitude is wildly out of range (untaken branch).
    t_tropo_safe = jnp.maximum(t_tropo, 1.0)
    p_tropo = P0 * (t_tropo_safe / T0) ** pow_exp
    p_iso = p11 * jnp.exp(-g * (h - h_trop) / (R * Ts))
    p_2025 = p20 * jnp.exp(-g * (h - h_strat) / (R * Ts))
    # 25-32 km gradient layer: anchor temperature in the power law is the
    # *stratosphere* temp, not the actual 25 km temperature — reference quirk
    # preserved (`environment.py:71-81`).
    t_upper_safe = jnp.maximum(t_upper, 1.0)
    p_2532 = p25 * (t_upper_safe / Ts) ** (g / (R * 0.0028))
    scale_height = R * t_meso / g
    p_meso = 868.02 * jnp.exp(-(h - 32000.0) / scale_height)

    temperature = jnp.where(
        h <= h_trop,
        t_tropo,
        jnp.where(
            h <= h_strat,
            t_iso,
            jnp.where(h <= 32000.0, t_upper, t_meso),
        ),
    )
    pressure = jnp.where(
        h <= h_trop,
        p_tropo,
        jnp.where(
            h <= h_strat,
            p_iso,
            jnp.where(
                h <= 25000.0,
                p_2025,
                jnp.where(h <= 32000.0, p_2532, p_meso),
            ),
        ),
    )

    density = pressure / (R * temperature) * p.density_scale
    speed_of_sound = jnp.sqrt(p.gamma * R * temperature)
    return AtmosProperties(temperature, pressure, density, speed_of_sound)


def gravity_at(p: AtmosphereParams, altitude) -> jnp.ndarray:
    """Inverse-square gravity (`environment.py:105-108`)."""
    return p.gravity * (EARTH_RADIUS / (EARTH_RADIUS + altitude)) ** 2
