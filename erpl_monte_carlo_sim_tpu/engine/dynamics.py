"""6DOF rigid-body dynamics right-hand side (pure, branch-free, vmap-safe).

Functional parity with `/root/reference/rocket_simulation/simulator.py:295-460`
(``_rocket_dynamics``), re-designed for XLA:

  * every ``if`` becomes a ``jnp.where`` mask; in particular the reference's
    STATEFUL parachute latch (a mutation of ``self.parachute_deployed`` inside
    the RHS, `simulator.py:366-369`) becomes an explicit boolean threaded
    through the function — each RK4 stage receives the latch produced by the
    previous stage, reproducing the reference's mutation order exactly,
  * wind is always queried from a table (no-wind = zero table), so there is
    a single code path,
  * all denominators are guarded so the *untaken* side of every mask is
    finite (clean under ``jax_debug_nans`` and differentiable).

The whole function is a straight-line chain of elementwise ops and tiny
gathers — under ``vmap`` it becomes [B]-wide vector code that XLA fuses into
one kernel per RK4 stage.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..models.atmosphere import atmosphere_properties, gravity_at
from ..models.motor import mass_flow_rate_at, thrust_at
from ..models.rocket import aero_coefficients, mass_properties
from ..models.scene import Scene
from ..models.wind import wind_at_altitude
from ..ops.frames import angle_of_attack, mach_number, sideslip_angle, wind_to_body_matrix
from ..ops.quaternion import (
    angular_velocity_to_quaternion_rate,
    normalize_quaternion,
    quaternion_to_rotation_matrix,
    rotate_by_matrix,
    rotate_by_matrix_t,
)
from .config import SimConfig
from .state import FlightState
from ..ops.math import bcast_where, safe_norm

__all__ = ["rocket_dynamics"]


def rocket_dynamics(
    scene: Scene,
    cfg: SimConfig,
    t,
    s: FlightState,
    parachute_deployed,
    wind_override=None,
):
    """Compute the state derivative and the updated parachute latch.

    Returns ``(s_dot: FlightState, parachute_deployed': bool array)``.
    ``wind_override``: pre-computed wind vector (the per-step wind
    optimization, see ``SimConfig.wind_eval_per_step``).
    """
    rocket = scene.rocket
    position = s.position
    velocity = s.velocity
    # Clamp propellant fraction (`simulator.py:304-305`) and normalize the
    # quaternion (`simulator.py:307-308`) exactly like the reference RHS.
    prop_frac = jnp.maximum(s.propellant_fraction, 0.0)
    quat = normalize_quaternion(s.quaternion)
    omega = s.angular_velocity

    mp = mass_properties(rocket, prop_frac)
    mass = mp.mass  # prop_frac >= 0 ensures mass >= dry mass (`simulator.py:314-318`)

    R = quaternion_to_rotation_matrix(quat)  # body -> inertial

    altitude = position[..., 2]
    atm = atmosphere_properties(scene.atmosphere, altitude)

    if wind_override is None:
        wind_velocity = wind_at_altitude(scene.wind, altitude)
    else:
        wind_velocity = wind_override
    velocity_relative = velocity - wind_velocity
    velocity_body = rotate_by_matrix_t(R, velocity_relative)

    mach = mach_number(velocity_relative, atm.temperature)
    alpha = angle_of_attack(velocity_body)
    beta = sideslip_angle(velocity_body)
    rel_speed = safe_norm(velocity_relative)
    q_dynamic = 0.5 * atm.density * rel_speed**2

    # --- thrust: gated on propellant AND burn time (`simulator.py:359-363`)
    burning = (prop_frac > 0.0) & (t <= scene.motor.burn_time)
    thrust = jnp.where(burning, thrust_at(scene.motor, t, atm.pressure), 0.0)

    # --- parachute latch (`simulator.py:366-369`): once set, stays set.
    deploy_now = (
        (altitude <= rocket.parachute_deployment_altitude)
        & (velocity[..., 2] < 0.0)
    )
    parachute = jnp.logical_or(parachute_deployed, deploy_now)

    # --- parachute drag branch (`simulator.py:372-377`): opposes body-frame
    # relative velocity; replaces ALL aero forces and moments.
    body_speed = safe_norm(velocity_body)
    safe_body_speed = jnp.maximum(body_speed, 1e-12)
    chute_mag = (
        0.5 * atm.density * body_speed**2 * rocket.parachute_cd * rocket.parachute_area
    )
    chute_force = -chute_mag[..., None] * velocity_body / safe_body_speed[..., None]
    chute_force = bcast_where(body_speed > 0.0, chute_force, 0.0)

    # --- aero branch (`simulator.py:378-411`)
    coeffs = aero_coefficients(
        rocket, mach, alpha, beta,
        center_of_mass=mp.center_of_mass,
        power_on=(prop_frac > 0.0),
    )
    drag = q_dynamic * coeffs.cd * rocket.reference_area
    lift = q_dynamic * coeffs.cl * rocket.reference_area
    side = q_dynamic * coeffs.cy * rocket.reference_area
    R_wb = wind_to_body_matrix(alpha, beta)
    if cfg.energy_consistent_aero:
        # Drag strictly anti-parallel to the relative flow; lift/side from
        # the reference matrix, projected perpendicular to the flow so they
        # can do no work (see SimConfig.energy_consistent_aero).
        v_hat = velocity_body / jnp.maximum(
            safe_norm(velocity_body, keepdims=True), 1e-12
        )
        ls_force = rotate_by_matrix(
            R_wb, jnp.stack([jnp.zeros_like(drag), -side, -lift], axis=-1)
        )
        ls_along = jnp.sum(ls_force * v_hat, axis=-1, keepdims=True)
        aero_force = -drag[..., None] * v_hat + (ls_force - ls_along * v_hat)
    else:
        aero_force = rotate_by_matrix(
            R_wb, jnp.stack([-drag, -side, -lift], axis=-1)
        )
    has_q = q_dynamic > 0.0
    aero_force = bcast_where(has_q, aero_force, 0.0)

    moment_scale = q_dynamic * rocket.reference_area * rocket.reference_diameter
    aero_moments = jnp.stack(
        [
            moment_scale * coeffs.croll,
            moment_scale * coeffs.cpitch,
            moment_scale * coeffs.cyaw,
        ],
        axis=-1,
    )
    aero_moments = bcast_where(has_q, aero_moments, 0.0)

    # Select parachute vs aero (mutually exclusive, `simulator.py:372-378`).
    forces_body = bcast_where(parachute, chute_force, aero_force)
    moments_body = bcast_where(parachute, jnp.zeros_like(aero_moments), aero_moments)

    # Thrust along body +x (`simulator.py:363`).
    thrust_vec = jnp.stack(
        [thrust, jnp.zeros_like(thrust), jnp.zeros_like(thrust)], axis=-1
    )
    forces_body = forces_body + thrust_vec

    # Pitch/yaw rotational damping — applied in BOTH branches
    # (`simulator.py:413-415` sits outside the if/elif).
    damping = jnp.stack(
        [
            jnp.zeros_like(omega[..., 0]),
            -cfg.pitch_damping * omega[..., 1],
            -cfg.yaw_damping * omega[..., 2],
        ],
        axis=-1,
    )
    moments_body = moments_body + damping

    # Inertial forces + inverse-square gravity (`simulator.py:417-422`).
    forces_inertial = rotate_by_matrix(R, forces_body)
    g = gravity_at(scene.atmosphere, altitude)
    gravity_vec = jnp.stack(
        [jnp.zeros_like(g), jnp.zeros_like(g), -mass * g], axis=-1
    )
    forces_inertial = forces_inertial + gravity_vec

    acceleration = forces_inertial / mass[..., None]

    # Euler rigid-body rotational equations (`simulator.py:431-436`).
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    ang_accel = jnp.stack(
        [
            (moments_body[..., 0] - (mp.Izz - mp.Iyy) * wy * wz) / mp.Ixx,
            (moments_body[..., 1] - (mp.Ixx - mp.Izz) * wz * wx) / mp.Iyy,
            (moments_body[..., 2] - (mp.Iyy - mp.Ixx) * wx * wy) / mp.Izz,
        ],
        axis=-1,
    )

    quaternion_rate = angular_velocity_to_quaternion_rate(omega, quat)

    # Propellant consumption with the 10 ms burnout ramp
    # (`simulator.py:442-450`): nominal rate -mdot/prop_mass, but when less
    # than 10 ms of propellant remains, ramp out over exactly 10 ms.
    mdot = mass_flow_rate_at(scene.motor, t)
    nominal_rate = -mdot / rocket.propellant_mass
    safe_rate = jnp.where(nominal_rate != 0.0, nominal_rate, -1.0)
    remaining_time = prop_frac / jnp.abs(safe_rate)
    remaining_time = jnp.where(nominal_rate != 0.0, remaining_time, jnp.inf)
    ramp_rate = -prop_frac / 0.01
    prop_rate = jnp.where(remaining_time < 0.01, ramp_rate, nominal_rate)
    prop_rate = jnp.where(burning, prop_rate, 0.0)

    s_dot = FlightState(
        position=velocity,
        velocity=acceleration,
        quaternion=quaternion_rate,
        angular_velocity=ang_accel,
        propellant_fraction=prop_rate,
    )
    return s_dot, parachute
