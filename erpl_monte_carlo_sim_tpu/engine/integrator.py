"""RK4 step + branch-free event state machine.

The reference's main loop (`/root/reference/rocket_simulation/simulator.py:
208-264`) is a Python ``while`` with inline ``break``s and a stateful
parachute latch mutated inside the RHS. Here the same semantics are a pure
``(carry) -> (carry)`` step:

  * classic RK4 with the parachute latch THREADED through the four stage
    evaluations in order (k1 -> k2 -> k3 -> k4), reproducing the reference's
    in-RHS mutation sequencing exactly,
  * quaternion renormalization after every step (`simulator.py:227`),
  * all termination conditions (ground, 100 km, tiered coast timeout) and
    apogee detection are boolean masks carried in ``EventState`` — vmap-safe,
  * running summaries (apogee = running max altitude with first-max time,
    max speed/mach) are folded into the carry so the Monte Carlo path never
    materializes trajectories (kills the reference's second hot loop AND its
    per-step Python list appends).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils import struct
from ..models.scene import Scene
from .config import SimConfig
from .dynamics import rocket_dynamics
from .state import FlightState
from ..ops.math import safe_norm
from ..ops.quaternion import normalize_quaternion

__all__ = ["EventState", "StepCarry", "rk4_step", "init_carry", "advance"]


@struct.dataclass
class EventState:
    """Branch-free event flags + running summaries (one lane each)."""

    parachute_deployed: jnp.ndarray  # bool
    apogee_detected: jnp.ndarray  # bool
    apogee_time: jnp.ndarray  # absolute t at detection (coast timer base)
    max_coast_time: jnp.ndarray  # tiered coast budget chosen at detection
    done: jnp.ndarray  # bool — lane terminated
    diverged: jnp.ndarray  # bool — lane went non-finite
    # Running summaries over recorded states
    max_altitude: jnp.ndarray
    t_at_max_altitude: jnp.ndarray  # absolute t
    max_speed: jnp.ndarray
    max_mach_proxy: jnp.ndarray  # max speed / a(sea level) — cheap extra
    end_time: jnp.ndarray  # absolute t at termination


@struct.dataclass
class StepCarry:
    state: FlightState
    step: jnp.ndarray  # int32 — absolute t = rail_time + step * dt
    rail_time: jnp.ndarray
    events: EventState


def init_carry(state_exit: FlightState, rail_time, speed_of_sound_sl=340.294
               ) -> StepCarry:
    """Carry at rail exit. The rail-exit state is 'recorded' (the reference
    appends it before the loop, `simulator.py:213-214`), so summaries start
    from it."""
    alt = state_exit.position[..., 2]
    speed = safe_norm(state_exit.velocity)
    f = jnp.asarray(rail_time)
    b = jnp.zeros_like(alt, dtype=bool)
    events = EventState(
        parachute_deployed=b,
        apogee_detected=b,
        apogee_time=jnp.zeros_like(f),
        max_coast_time=jnp.zeros_like(f),
        done=b,
        diverged=b,
        max_altitude=alt,
        t_at_max_altitude=f,
        max_speed=speed,
        max_mach_proxy=speed / speed_of_sound_sl,
        end_time=f,
    )
    return StepCarry(
        state=state_exit,
        step=jnp.zeros_like(alt, dtype=jnp.int32),
        rail_time=f,
        events=events,
    )


def rk4_step(scene: Scene, cfg: SimConfig, t, state: FlightState, parachute):
    """One RK4 step of length ``cfg.dt`` with the threaded parachute latch.

    Parity: `simulator.py:216-227` (stage structure and quaternion renorm).
    """
    dt = cfg.dt
    wind = None
    if cfg.wind_eval_per_step:
        from ..models.wind import wind_at_altitude

        wind = wind_at_altitude(scene.wind, state.position[..., 2])
    k1, p1 = rocket_dynamics(scene, cfg, t, state, parachute, wind)
    k2, p2 = rocket_dynamics(
        scene, cfg, t + 0.5 * dt, state + (0.5 * dt) * k1, p1, wind
    )
    k3, p3 = rocket_dynamics(
        scene, cfg, t + 0.5 * dt, state + (0.5 * dt) * k2, p2, wind
    )
    k4, p4 = rocket_dynamics(scene, cfg, t + dt, state + dt * k3, p3, wind)
    new = state + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    new = new.replace(quaternion=normalize_quaternion(new.quaternion))
    return new, p4


def _update_events(cfg: SimConfig, t_new, state: FlightState, ev: EventState,
                   parachute) -> EventState:
    """Apply the reference's post-step event logic (`simulator.py:233-264`)."""
    alt = state.position[..., 2]
    vz = state.velocity[..., 2]
    speed = safe_norm(state.velocity)

    # Running summaries (strict > keeps the FIRST max, matching np.argmax).
    better = alt > ev.max_altitude
    max_altitude = jnp.where(better, alt, ev.max_altitude)
    t_at_max = jnp.where(better, t_new, ev.t_at_max_altitude)
    max_speed = jnp.maximum(ev.max_speed, speed)
    max_mach = jnp.maximum(ev.max_mach_proxy, speed / 340.294)

    # Apogee detection + tiered coast budget (`simulator.py:246-257`).
    detect = (alt > cfg.apogee_min_altitude) & (vz < 0.0) & ~ev.apogee_detected
    coast_budget = jnp.where(
        alt > cfg.coast_alt_hi,
        cfg.coast_time_hi,
        jnp.where(alt > cfg.coast_alt_mid, cfg.coast_time_mid, cfg.coast_time_lo),
    )
    apogee_detected = ev.apogee_detected | detect
    apogee_time = jnp.where(detect, t_new, ev.apogee_time)
    max_coast_time = jnp.where(detect, coast_budget, ev.max_coast_time)

    # Termination (`simulator.py:237-264`).
    ground = (alt <= cfg.ground_altitude) & (vz <= 0.0)
    excessive = alt > cfg.excessive_altitude
    coast_done = (
        apogee_detected
        & (alt > cfg.coast_alt_mid)
        & ((t_new - apogee_time) > max_coast_time)
    )
    finite = jnp.isfinite(alt) & jnp.isfinite(vz) & jnp.isfinite(speed)
    sane = speed < cfg.speed_guard
    diverged = ev.diverged | (
        (~finite | ~sane) if cfg.terminate_nonfinite else False
    )

    newly_done = ground | excessive | coast_done | (diverged & ~ev.diverged)
    done = ev.done | newly_done
    end_time = jnp.where(ev.done, ev.end_time, t_new)

    return EventState(
        parachute_deployed=parachute,
        apogee_detected=apogee_detected,
        apogee_time=apogee_time,
        max_coast_time=max_coast_time,
        done=done,
        diverged=diverged,
        max_altitude=max_altitude,
        t_at_max_altitude=t_at_max,
        max_speed=max_speed,
        max_mach_proxy=max_mach,
        end_time=end_time,
    )


def advance(scene: Scene, cfg: SimConfig, carry: StepCarry) -> StepCarry:
    """One full main-loop iteration: RK4 step + events. Pure; callers decide
    the loop construct (``while_loop`` for summaries, ``scan`` for
    trajectories) and the done-masking."""
    t = carry.rail_time + carry.step.astype(carry.rail_time.dtype) * cfg.dt
    new_state, parachute = rk4_step(
        scene, cfg, t, carry.state, carry.events.parachute_deployed
    )
    step_new = carry.step + 1
    t_new = carry.rail_time + step_new.astype(carry.rail_time.dtype) * cfg.dt
    events = _update_events(cfg, t_new, new_state, carry.events, parachute)
    return StepCarry(
        state=new_state, step=step_new, rail_time=carry.rail_time, events=events
    )
