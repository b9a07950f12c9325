"""Motor / propulsion model as a unified pytree.

Functional parity with `/root/reference/rocket_simulation/motor.py:8-186`
(SolidMotor and LiquidMotor), re-designed for batching as ONE parameterization.

Both reference motors reduce to the same thrust law:

    thrust(t, p_amb) = interp(t, curve_time, curve_thrust_sl)
                       + nozzle_exit_area * (101325 - p_amb),   0 <= t <= burn

  * SolidMotor: the curve is its 10-knot normalized profile x average thrust
    (`motor.py:31-41,69-76`).
  * LiquidMotor: ``thrust_vacuum - Ae * p`` == ``thrust_sl + Ae*(101325 - p)``
    (`motor.py:143-156`), i.e. a FLAT sea-level curve. One code path, no
    per-motor-type branching inside the jitted step.

Mass flow is constant over the burn (`motor.py:78-84,158-161`); propellant
remaining is the linear ramp (`motor.py:86-93`).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils import struct
from ..ops.interp import interpolate_1d

__all__ = ["MotorParams", "solid_motor", "liquid_motor", "thrust_at",
           "mass_flow_rate_at", "propellant_remaining"]

P_SL = 101325.0  # Pa

# SolidMotor thrust curve (`motor.py:31-38`): knots in seconds and
# thrust/average_thrust.
_SOLID_CURVE_T = (0.0, 0.2, 0.5, 1.0, 2.0, 5.0, 8.0, 12.0, 14.0, 15.0)
_SOLID_CURVE_NORM = (0.0, 2.2, 2.0, 1.8, 1.5, 1.2, 1.0, 0.8, 0.3, 0.0)

LBF_TO_N = 4.44822


@struct.dataclass
class MotorParams:
    """Unified motor parameters (solid or liquid — same thrust law).

    ``curve_time``/``curve_thrust_sl`` define the sea-level-referenced thrust
    profile; ``nozzle_exit_area`` supplies the altitude compensation.
    """

    curve_time: jnp.ndarray
    curve_thrust_sl: jnp.ndarray
    nozzle_exit_area: jnp.ndarray
    burn_time: jnp.ndarray
    mass_flow_rate: jnp.ndarray
    propellant_mass: jnp.ndarray
    # Monte Carlo thrust dispersion. The reference perturbs a motor by
    # scaling the whole thrust curve AND the nozzle exit area by one
    # multiplier (`motor.py:104-108,123,175-183`), which factors out:
    #     thrust = scale * (interp(t) + Ae * (101325 - p)).
    # Keeping it as a scalar lets the Monte Carlo batch SHARE the curve
    # tables — per-lane tables would force batched gathers in the hot loop
    # (their cost on the GPU is not measured yet).
    thrust_scale: jnp.ndarray = 1.0
    # Metadata kept for report-schema parity (never read in the hot loop).
    total_impulse: jnp.ndarray = 0.0
    thrust_sea_level: jnp.ndarray = 0.0
    thrust_vacuum: jnp.ndarray = 0.0
    # Dispersion sigmas (`motor.py:50-52,149-150`).
    thrust_uncertainty: jnp.ndarray = 0.05
    burn_time_uncertainty: jnp.ndarray = 0.02
    total_impulse_uncertainty: jnp.ndarray = 0.03
    mass_flow_uncertainty: jnp.ndarray = 0.03
    # Static dispersion semantics: solid motors scale mass flow WITH the
    # thrust multiplier (`motor.py:119`); liquids draw an independent flow
    # multiplier (`motor.py:175-183`).
    mdot_follows_thrust: bool = struct.field(pytree_node=False, default=False)
    # Metadata (reference report schema has a `name`, `motor.py:12,136`)
    name: str = struct.field(pytree_node=False, default="Motor")


def solid_motor(
    total_impulse: float = 156297.0,
    burn_time: float = 15.0,
    propellant_mass: float = 63.5,
    mass_flow_rate: float = 4.26,
    thrust_sea_level: float = 2290 * LBF_TO_N,
    thrust_vacuum: float = 2590 * LBF_TO_N,
) -> MotorParams:
    """SolidMotor defaults (`motor.py:11-52`)."""
    average_thrust = total_impulse / burn_time
    nozzle_exit_area = (thrust_vacuum - thrust_sea_level) / P_SL
    curve_t = jnp.array(_SOLID_CURVE_T)
    curve_thrust = jnp.array(_SOLID_CURVE_NORM) * average_thrust
    return MotorParams(
        curve_time=curve_t,
        curve_thrust_sl=curve_thrust,
        nozzle_exit_area=jnp.asarray(nozzle_exit_area),
        burn_time=jnp.asarray(burn_time),
        mass_flow_rate=jnp.asarray(mass_flow_rate),
        propellant_mass=jnp.asarray(propellant_mass),
        total_impulse=jnp.asarray(total_impulse),
        thrust_sea_level=jnp.asarray(thrust_sea_level),
        thrust_vacuum=jnp.asarray(thrust_vacuum),
        mdot_follows_thrust=True,
        name="Solid Motor",
    )


def liquid_motor(
    thrust_vacuum: float = 2590 * LBF_TO_N,
    thrust_sea_level: float = 2290 * LBF_TO_N,
    mass_flow_rate: float = 4.26,
    propellant_mass: float = 63.5,
) -> MotorParams:
    """LiquidMotor defaults (`motor.py:131-150`).

    burn_time = propellant_mass / mass_flow_rate; the thrust curve is flat at
    the sea-level value so interp + Ae*(101325 - p) reproduces
    ``thrust_vacuum - Ae * p`` exactly.
    """
    nozzle_exit_area = (thrust_vacuum - thrust_sea_level) / P_SL
    burn_time = propellant_mass / mass_flow_rate
    total_impulse = thrust_vacuum * burn_time
    curve_t = jnp.array([0.0, 1.0])
    curve_thrust = jnp.array([thrust_sea_level, thrust_sea_level])
    return MotorParams(
        curve_time=curve_t,
        curve_thrust_sl=curve_thrust,
        nozzle_exit_area=jnp.asarray(nozzle_exit_area),
        burn_time=jnp.asarray(burn_time),
        mass_flow_rate=jnp.asarray(mass_flow_rate),
        propellant_mass=jnp.asarray(propellant_mass),
        total_impulse=jnp.asarray(total_impulse),
        thrust_sea_level=jnp.asarray(thrust_sea_level),
        thrust_vacuum=jnp.asarray(thrust_vacuum),
        thrust_uncertainty=jnp.asarray(0.05),
        mass_flow_uncertainty=jnp.asarray(0.03),
        name="Liquid Motor",
    )


def thrust_at(m: MotorParams, time, ambient_pressure) -> jnp.ndarray:
    """Thrust (N) at ``time`` since ignition with altitude compensation.

    Parity: `motor.py:54-76` (solid) and `motor.py:152-156` (liquid);
    zero outside ``0 <= t <= burn_time`` (inclusive upper bound, matching
    the reference's ``time > burn_time`` early-out).
    """
    t = jnp.asarray(time)
    base = interpolate_1d(t, m.curve_time, m.curve_thrust_sl)
    correction = m.nozzle_exit_area * (P_SL - ambient_pressure)
    in_burn = (t >= 0.0) & (t <= m.burn_time)
    return jnp.where(in_burn, m.thrust_scale * (base + correction), 0.0)


def mass_flow_rate_at(m: MotorParams, time) -> jnp.ndarray:
    """Constant mass flow during the burn (`motor.py:78-84,158-161`)."""
    t = jnp.asarray(time)
    in_burn = (t >= 0.0) & (t <= m.burn_time)
    return jnp.where(in_burn, m.mass_flow_rate, 0.0)


def propellant_remaining(m: MotorParams, time) -> jnp.ndarray:
    """Linear propellant-remaining fraction (`motor.py:86-93`)."""
    t = jnp.asarray(time)
    return jnp.clip(1.0 - t / m.burn_time, 0.0, 1.0)
