"""Guided launch-rail phase (1-DOF forward Euler along the rail direction).

Functional parity with `/root/reference/rocket_simulation/simulator.py:42-125`
(``_simulate_launch_rail``), re-designed as a ``lax.while_loop``:

  * the loop carry is (position, speed, distance, step, prop_frac) — under
    ``vmap`` JAX's while-loop batching runs until EVERY lane has left the
    rail and masks finished lanes automatically, so the batch gets the
    reference's variable-length rail semantics with fixed-shape code,
  * only the axial component of relative velocity contributes drag
    (crosswind is reacted by the rail hardware), alpha = 0, power-on drag,
  * the attitude is frozen; the rocket translates along body +x.

A static ``cfg.max_rail_steps`` bound guards against a lane whose thrust
never overcomes gravity (the reference would loop until burnout; we cap at
the same order of magnitude).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import struct
from ..models.atmosphere import atmosphere_properties, gravity_at
from ..models.motor import propellant_remaining, thrust_at
from ..models.rocket import aero_coefficients, mass_properties
from ..models.scene import Scene
from ..models.wind import wind_at_altitude
from ..ops.frames import angle_of_attack, mach_number, sideslip_angle
from ..ops.math import bcast_where
from ..ops.quaternion import (
    quaternion_to_euler,
    quaternion_to_rotation_matrix,
    rotate_by_matrix_t,
)
from .config import SimConfig
from .state import FlightState

__all__ = ["RailInfo", "simulate_rail", "simulate_rail_masked"]


@struct.dataclass
class RailInfo:
    """Rail-exit diagnostics (`simulator.py:102-124`)."""

    rail_exit_time: jnp.ndarray
    rail_exit_position: jnp.ndarray
    rail_exit_velocity: jnp.ndarray
    rail_exit_speed: jnp.ndarray
    rail_exit_euler: jnp.ndarray
    rail_exit_angle_of_attack: jnp.ndarray
    rail_exit_sideslip: jnp.ndarray
    wind_at_exit: jnp.ndarray


def simulate_rail(scene: Scene, cfg: SimConfig, state0: FlightState):
    """Integrate the rail phase; returns ``(state_at_exit, rail_time, RailInfo)``.

    Exit condition matches the reference (`simulator.py:63`): leave when
    ``distance >= rail_length`` OR ``t >= burn_time``.
    """
    quat = state0.quaternion
    R = quaternion_to_rotation_matrix(quat)
    direction = R[..., :, 0]  # body +x in inertial (`simulator.py:57`)

    dt = cfg.rail_dt
    pos0 = state0.position
    speed0 = jnp.sum(state0.velocity * direction, axis=-1)
    zero = jnp.zeros_like(speed0)

    def cond(carry):
        pos, speed, dist, step, frac = carry
        t = step.astype(pos.dtype) * dt
        return jnp.logical_and(
            jnp.logical_and(dist < cfg.rail_length, t < scene.motor.burn_time),
            step < cfg.max_rail_steps,
        )

    def body(carry):
        pos, speed, dist, step, frac = carry
        t = step.astype(pos.dtype) * dt

        mp = mass_properties(scene.rocket, frac)
        atm = atmosphere_properties(scene.atmosphere, pos[..., 2])
        wind = wind_at_altitude(scene.wind, pos[..., 2])

        rel_vel = direction * speed[..., None] - wind
        rel_speed = jnp.sum(rel_vel * direction, axis=-1)
        mach = mach_number(rel_vel, atm.temperature)
        coeffs = aero_coefficients(
            scene.rocket, mach, 0.0, 0.0,
            center_of_mass=mp.center_of_mass, power_on=True,
        )
        drag = 0.5 * atm.density * rel_speed**2 * coeffs.cd * scene.rocket.reference_area

        thrust = thrust_at(scene.motor, t, atm.pressure)
        g = gravity_at(scene.atmosphere, pos[..., 2])
        accel = (thrust - mp.mass * g - drag) / mp.mass

        # Forward-Euler update in the reference's exact order
        # (`simulator.py:90-96`): speed first, then position/distance with
        # the NEW speed, then time, then propellant from the new time.
        speed = speed + accel * dt
        pos = pos + direction * (speed * dt)[..., None]
        dist = dist + speed * dt
        step = step + 1
        t_new = step.astype(pos.dtype) * dt
        frac = propellant_remaining(scene.motor, t_new)
        return pos, speed, dist, step, frac

    step0 = jnp.zeros_like(speed0, dtype=jnp.int32)
    pos, speed, dist, step, frac = jax.lax.while_loop(
        cond, body, (pos0, speed0, zero, step0, state0.propellant_fraction)
    )
    rail_time = step.astype(pos.dtype) * dt
    velocity = direction * speed[..., None]

    state_exit = FlightState(
        position=pos,
        velocity=velocity,
        quaternion=quat,
        angular_velocity=state0.angular_velocity,
        propellant_fraction=frac,
    )

    # Rail-exit diagnostics (`simulator.py:102-124`).
    wind_exit = wind_at_altitude(scene.wind, pos[..., 2])
    vel_rel = velocity - wind_exit
    vel_body = rotate_by_matrix_t(R, vel_rel)
    info = RailInfo(
        rail_exit_time=rail_time,
        rail_exit_position=pos,
        rail_exit_velocity=velocity,
        rail_exit_speed=jnp.linalg.norm(velocity, axis=-1),
        rail_exit_euler=quaternion_to_euler(quat),
        rail_exit_angle_of_attack=angle_of_attack(vel_body),
        rail_exit_sideslip=sideslip_angle(vel_body),
        wind_at_exit=wind_exit,
    )
    return state_exit, rail_time, info


def simulate_rail_masked(scene: Scene, cfg: SimConfig, state0: FlightState):
    """Rail phase on an already-batched [B] (or [TILE]) lane axis with a
    SCALAR-cond while_loop and explicit per-lane masking.

    The twin of `simulate_rail` for contexts without vmap: the
    host-chunked batch runner. Identical per-step math
    (`simulator.py:63-96`)."""
    quat = state0.quaternion
    R = quaternion_to_rotation_matrix(quat)
    direction = R[..., :, 0]
    dt = cfg.rail_dt
    speed0 = jnp.sum(state0.velocity * direction, axis=-1)
    zero = jnp.zeros_like(speed0)

    def active(carry):
        pos, speed, dist, step, frac = carry
        t = step.astype(pos.dtype) * dt
        return (dist < cfg.rail_length) & (t < scene.motor.burn_time) & (
            step < cfg.max_rail_steps
        )

    def cond(carry):
        return jnp.any(active(carry))

    def body(carry):
        pos, speed, dist, step, frac = carry
        on = active(carry)
        t = step.astype(pos.dtype) * dt

        mp = mass_properties(scene.rocket, frac)
        atm = atmosphere_properties(scene.atmosphere, pos[..., 2])
        wind = wind_at_altitude(scene.wind, pos[..., 2])
        rel_vel = direction * speed[..., None] - wind
        rel_speed = jnp.sum(rel_vel * direction, axis=-1)
        mach = mach_number(rel_vel, atm.temperature)
        coeffs = aero_coefficients(
            scene.rocket, mach, 0.0, 0.0,
            center_of_mass=mp.center_of_mass, power_on=True,
        )
        drag = (
            0.5 * atm.density * rel_speed**2 * coeffs.cd * scene.rocket.reference_area
        )
        thrust = thrust_at(scene.motor, t, atm.pressure)
        g = gravity_at(scene.atmosphere, pos[..., 2])
        accel = (thrust - mp.mass * g - drag) / mp.mass

        new_speed = speed + accel * dt
        new_pos = pos + direction * (new_speed * dt)[..., None]
        new_dist = dist + new_speed * dt
        new_step = step + 1
        new_frac = propellant_remaining(
            scene.motor, new_step.astype(pos.dtype) * dt
        )
        sel = lambda a, b: jnp.where(on, a, b)
        return (
            bcast_where(on, new_pos, pos),
            sel(new_speed, speed),
            sel(new_dist, dist),
            sel(new_step, step),
            sel(new_frac, frac),
        )

    step0 = jnp.zeros_like(speed0, dtype=jnp.int32)
    pos, speed, dist, step, frac = jax.lax.while_loop(
        cond, body, (state0.position, speed0, zero, step0, state0.propellant_fraction)
    )
    rail_time = step.astype(pos.dtype) * dt
    velocity = direction * speed[..., None]
    state = FlightState(
        position=pos, velocity=velocity, quaternion=quat,
        angular_velocity=state0.angular_velocity, propellant_fraction=frac,
    )
    wind_exit = wind_at_altitude(scene.wind, pos[..., 2])
    vel_body = rotate_by_matrix_t(R, velocity - wind_exit)
    info = RailInfo(
        rail_exit_time=rail_time,
        rail_exit_position=pos,
        rail_exit_velocity=velocity,
        rail_exit_speed=jnp.linalg.norm(velocity, axis=-1),
        rail_exit_euler=quaternion_to_euler(quat),
        rail_exit_angle_of_attack=angle_of_attack(vel_body),
        rail_exit_sideslip=sideslip_angle(vel_body),
        wind_at_exit=wind_exit,
    )
    return state, rail_time, info
