"""Top-level flight entry points.

Two paths over the same physics:

  * ``simulate_summary`` — the Monte Carlo hot path. One ``lax.while_loop``
    whose carry holds the state plus running summaries; NOTHING per-step is
    materialized. Under ``vmap`` the loop runs until every lane terminates
    (JAX's while-loop batching masks finished lanes), giving batch-level
    early exit — the batched replacement for the reference's per-process
    early ``break``s (`simulator.py:216-264`).

  * ``simulate_flight`` — the trajectory path (plots, per-sim JSON, post-hoc
    CLIs). A fixed-length ``lax.scan`` with a done mask that records the
    state PLUS all derived quantities the reference recomputes in its second
    hot loop (`simulator.py:462-584`) — fused into the same step, so the
    reference's ~5 dynamics-evaluations-of-work per step become 5 (4 RK4
    stages + 1 derived) with zero Python re-evaluation.

Both start with the guided-rail phase and offset reported times by the rail
exit time, matching `simulator.py:169,273`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils import struct
from ..models.atmosphere import atmosphere_properties
from ..models.motor import thrust_at
from ..models.rocket import aero_coefficients, dynamic_cp, mass_properties
from ..models.scene import Scene
from ..models.wind import wind_at_altitude
from ..ops.frames import angle_of_attack, mach_number, sideslip_angle
from ..ops.quaternion import (
    quaternion_to_euler,
    quaternion_to_rotation_matrix,
    rotate_by_matrix_t,
)
from .config import SimConfig
from .integrator import StepCarry, advance, init_carry
from .rail import RailInfo, simulate_rail
from .state import FlightState, InitialConditions, initial_state

__all__ = ["FlightSummary", "Trajectory", "simulate_summary", "simulate_flight", "simulate_batch_chunked"]


@struct.dataclass
class FlightSummary:
    """Per-flight scalar outputs (the reference's headline metrics,
    `simulator.py:579-583`, plus rail diagnostics and robustness flags)."""

    apogee_altitude: jnp.ndarray
    apogee_time: jnp.ndarray  # offset by rail time, like the reference
    range: jnp.ndarray
    flight_time: jnp.ndarray  # offset by rail time
    landing_position: jnp.ndarray  # [3] final state position
    final_velocity: jnp.ndarray  # [3]
    max_speed: jnp.ndarray
    parachute_deployed: jnp.ndarray
    diverged: jnp.ndarray
    n_steps: jnp.ndarray
    rail: RailInfo


@struct.dataclass
class Trajectory:
    """Fixed-length recorded history ([T, ...] leaves) with a valid mask.

    ``valid[k]`` is True for steps that the reference would have recorded
    (i.e. before the lane terminated). Index 0 is the rail-exit state.
    """

    time: jnp.ndarray  # [T] offset by rail time (0 at rail exit)
    position: jnp.ndarray  # [T, 3]
    velocity: jnp.ndarray  # [T, 3]
    quaternion: jnp.ndarray  # [T, 4]
    angular_velocity: jnp.ndarray  # [T, 3]
    propellant_fraction: jnp.ndarray  # [T]
    valid: jnp.ndarray  # [T] bool
    derived: dict  # optional per-step derived quantities (may be empty)


def _summary_from_carry(carry: StepCarry, rail_info: RailInfo) -> FlightSummary:
    ev = carry.events
    pos = carry.state.position
    rng = jnp.sqrt(pos[..., 0] ** 2 + pos[..., 1] ** 2)
    return FlightSummary(
        apogee_altitude=ev.max_altitude,
        apogee_time=ev.t_at_max_altitude - carry.rail_time,
        range=rng,
        flight_time=ev.end_time - carry.rail_time,
        landing_position=pos,
        final_velocity=carry.state.velocity,
        max_speed=ev.max_speed,
        parachute_deployed=ev.parachute_deployed,
        diverged=ev.diverged,
        n_steps=carry.step,
        rail=rail_info,
    )


def _require_parity_dt(cfg: SimConfig) -> None:
    """The tiered timestep (descent_dt_scale) is implemented on the
    component path (engine.batch.simulate_summary_batch), which is the
    default execution backend. The stacked-vector paths here are kept for
    equivalence testing and trajectory recording at parity settings only —
    refuse the flag rather than silently integrating different physics."""
    if cfg.descent_dt_scale != 1:
        raise ValueError(
            "descent_dt_scale is implemented on the component path "
            "(engine.batch.simulate_summary_batch); this stacked-vector "
            "path supports parity settings only. Use descent_dt_scale=1 "
            "(e.g. dataclasses.replace(cfg, descent_dt_scale=1, "
            "ascent_q_threshold=0.0))."
        )


def simulate_summary(
    scene: Scene, ic: InitialConditions, cfg: SimConfig = SimConfig()
) -> FlightSummary:
    """Full flight -> scalar summary. Jit/vmap/pjit-safe, no trajectories."""
    _require_parity_dt(cfg)
    state0 = initial_state(ic)
    state_exit, rail_time, rail_info = simulate_rail(scene, cfg, state0)
    carry0 = init_carry(state_exit, rail_time)

    def cond(carry: StepCarry):
        t = carry.rail_time + carry.step.astype(carry.rail_time.dtype) * cfg.dt
        return jnp.logical_and(
            jnp.logical_and(~carry.events.done, t < cfg.max_time),
            carry.step < cfg.max_steps,
        )

    def masked_advance(carry: StepCarry) -> StepCarry:
        run = cond(carry)
        new = advance(scene, cfg, carry)
        return jax.tree.map(
            lambda a, b: jnp.where(
                jnp.reshape(run, jnp.shape(run) + (1,) * (jnp.ndim(a) - jnp.ndim(run))),
                a, b,
            ),
            new, carry,
        )

    if cfg.unroll <= 1:
        carry = jax.lax.while_loop(
            cond, lambda c: advance(scene, cfg, c), carry0
        )
    else:
        def body(carry: StepCarry):
            for _ in range(cfg.unroll):
                carry = masked_advance(carry)
            return carry

        carry = jax.lax.while_loop(lambda c: jnp.any(cond(c)), body, carry0)
    return _summary_from_carry(carry, rail_info)


def _derived_quantities(scene: Scene, cfg: SimConfig, t_abs, state: FlightState):
    """Per-step derived outputs, matching the reference's extraction loop
    (`simulator.py:511-552`) field-for-field."""
    mp = mass_properties(scene.rocket, state.propellant_fraction)
    alt = state.position[..., 2]
    atm = atmosphere_properties(scene.atmosphere, alt)
    wind = wind_at_altitude(scene.wind, alt)
    vel_rel = state.velocity - wind
    R = quaternion_to_rotation_matrix(state.quaternion)
    vel_body = rotate_by_matrix_t(R, vel_rel)
    mach = mach_number(vel_rel, atm.temperature)
    aoa = angle_of_attack(vel_body)
    beta = sideslip_angle(vel_body)
    cp_val = dynamic_cp(scene.rocket, mach)
    coeffs = aero_coefficients(
        scene.rocket, mach, aoa, beta,
        center_of_mass=mp.center_of_mass,
        power_on=(state.propellant_fraction > 0.0),
    )
    q_dyn = 0.5 * atm.density * jnp.linalg.norm(vel_rel, axis=-1) ** 2
    # NOTE: the reference's extraction loop calls get_thrust WITHOUT the
    # burn-time/propellant gating of the RHS and with the OFFSET time
    # (`simulator.py:543`), so the recorded thrust history reflects that —
    # we reproduce it (t_abs here is already offset by the caller).
    thrust = thrust_at(scene.motor, t_abs, atm.pressure)
    return {
        "mass": mp.mass,
        "center_of_mass": mp.center_of_mass,
        "Ixx": mp.Ixx,
        "Iyy": mp.Iyy,
        "Izz": mp.Izz,
        "euler_angles": quaternion_to_euler(state.quaternion),
        "thrust": thrust,
        "drag": q_dyn * coeffs.cd * scene.rocket.reference_area,
        "cd": coeffs.cd,
        "cl": coeffs.cl,
        "cm": coeffs.cm,
        "cp_location_dynamic": cp_val,
        "stability_margin": (cp_val - mp.center_of_mass) / scene.rocket.reference_diameter,
        "angle_of_attack": aoa,
        "sideslip_angle": beta,
        "speed": jnp.linalg.norm(state.velocity, axis=-1),
        "altitude": alt,
        "mach": mach,
    }


def simulate_flight(
    scene: Scene, ic: InitialConditions, cfg: SimConfig = SimConfig()
):
    """Full flight with recorded trajectory.

    Returns ``(summary: FlightSummary, trajectory: Trajectory)``. The
    trajectory has static length ``cfg.max_steps + 1`` with a ``valid`` mask;
    hosts trim it with ``reporting.results.to_results_dict``.
    """
    _require_parity_dt(cfg)
    state0 = initial_state(ic)
    state_exit, rail_time, rail_info = simulate_rail(scene, cfg, state0)
    carry0 = init_carry(state_exit, rail_time)

    def record(carry: StepCarry):
        t_off = carry.step.astype(rail_time.dtype) * cfg.dt
        out = {
            "time": t_off,
            "position": carry.state.position,
            "velocity": carry.state.velocity,
            "quaternion": carry.state.quaternion,
            "angular_velocity": carry.state.angular_velocity,
            "propellant_fraction": carry.state.propellant_fraction,
        }
        if cfg.record_derived:
            # The reference extraction uses the offset time for thrust
            # (`simulator.py:543`).
            out["derived"] = _derived_quantities(scene, cfg, t_off, carry.state)
        return out

    def masked_advance(carry: StepCarry):
        active = ~carry.events.done
        t = carry.rail_time + carry.step.astype(carry.rail_time.dtype) * cfg.dt
        run = active & (t < cfg.max_time)
        new_carry = advance(scene, cfg, carry)
        carry = jax.tree.map(
            lambda new, old: jnp.where(
                jnp.reshape(run, run.shape + (1,) * (new.ndim - run.ndim)), new, old
            ),
            new_carry,
            carry,
        )
        return carry, run

    stride = max(1, cfg.record_stride)

    def step_fn(carry: StepCarry, _):
        carry, ran = masked_advance(carry)
        if stride > 1:
            def inner(_, c):
                return masked_advance(c)[0]
            carry = jax.lax.fori_loop(0, stride - 1, inner, carry)
        rec = record(carry)
        rec["valid"] = ran  # at least the first sub-step executed
        return carry, rec

    n_records = -(-cfg.max_steps // stride)
    carry, recs = jax.lax.scan(step_fn, carry0, None, length=n_records)

    rec0 = record(carry0)
    rec0["valid"] = jnp.ones_like(carry0.events.done)

    def prepend(first, rest):
        return jnp.concatenate([first[None], rest], axis=0)

    full = jax.tree.map(prepend, rec0, recs)
    derived = full.pop("derived") if cfg.record_derived else {}
    valid = full.pop("valid")
    traj = Trajectory(
        time=full["time"],
        position=full["position"],
        velocity=full["velocity"],
        quaternion=full["quaternion"],
        angular_velocity=full["angular_velocity"],
        propellant_fraction=full["propellant_fraction"],
        valid=valid,
        derived=derived,
    )
    return _summary_from_carry(carry, rail_info), traj


def _chunk_lane_active(carry: StepCarry, cfg: SimConfig):
    t = carry.rail_time + carry.step.astype(carry.rail_time.dtype) * cfg.dt
    return (~carry.events.done) & (t < cfg.max_time) & (
        carry.step < cfg.max_steps
    )


@functools.partial(jax.jit, static_argnums=(2, 3))
def _run_chunk(scene, carry: StepCarry, cfg: SimConfig, chunk_steps: int):
    """One bounded chunk of exactly-masked RK4 steps. MODULE-LEVEL jit:
    defining (and jitting) this inside simulate_batch_chunked would key the
    jit cache on a fresh closure per call, recompiling the whole-flight
    chunk program on every invocation — including once per slab in the
    analyzer's slab loop."""
    def cond(ck):
        c, k = ck
        return jnp.logical_and(k < chunk_steps,
                               jnp.any(_chunk_lane_active(c, cfg)))

    def body(ck):
        c, k = ck
        run = _chunk_lane_active(c, cfg)
        new = advance(scene, cfg, c)
        c = jax.tree.map(
            lambda a, b: jnp.where(
                jnp.reshape(
                    run, jnp.shape(run) + (1,) * (jnp.ndim(a) - jnp.ndim(run))
                ),
                a, b,
            ),
            new, c,
        )
        return c, k + 1

    carry, _ = jax.lax.while_loop(cond, body, (carry, jnp.int32(0)))
    return carry, jnp.any(_chunk_lane_active(carry, cfg))


def simulate_batch_chunked(
    scene_b: Scene,
    ic_b: InitialConditions,
    cfg: SimConfig = SimConfig(),
    chunk_steps: int = 8192,
    progress=None,
):
    """Batch summaries via host-chunked device execution.

    Operates directly on an already-batched scene/ICs (no vmap — the physics
    is shape-polymorphic), advancing at most ``chunk_steps`` exactly-masked
    RK4 steps per jitted call and checking lane liveness on the host between
    chunks. Two reasons to use this over one giant ``while_loop``:

      * bounds per-call device time,
      * gives the host a progress callback every chunk (``progress(k, n)``),
        the batched analogue of the reference's every-100-samples prints.

    Results are identical to ``vmap(simulate_summary)`` lane-for-lane.
    """
    _require_parity_dt(cfg)
    import numpy as np

    from .rail import simulate_rail_masked

    state0 = initial_state(ic_b)
    state_exit, rail_time, rail_info = simulate_rail_masked(scene_b, cfg, state0)
    carry0 = init_carry(state_exit, rail_time)

    carry = carry0
    chunk_idx = 0
    max_chunks = -(-cfg.max_steps // chunk_steps) + 1
    while True:
        carry, any_active = _run_chunk(scene_b, carry, cfg, chunk_steps)
        chunk_idx += 1
        if progress is not None:
            progress(chunk_idx, max_chunks)
        if not bool(np.asarray(any_active)) or chunk_idx >= max_chunks:
            break
    return _summary_from_carry(carry, rail_info)
