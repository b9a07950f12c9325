"""Batched whole-flight summaries on the flat component representation.

Drop-in equivalent of ``jit(vmap(simulate_summary))`` for the Monte Carlo
hot path: the vmapped stacked-vector path compiles to ~560 fusions whose
boundaries spill [B,3]/[B,4] intermediates with a padded minor dimension of
3. This path runs ``engine.component.flight_components`` directly under
``jit`` with every loop-carried value a flat [B] array and the per-lane
wind table stored lanes-minor [3, N, B], so B is the contiguous axis.

Replaces the same reference code as ``simulate_summary``
(`/root/reference/rocket_simulation/simulator.py:42-125,208-264`); results
match the vmapped path lane-for-lane (see tests/test_batch.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..models.scene import Scene
from ..models.wind import WindModes
from ..ops.quaternion import quaternion_to_euler
from .component import (
    flight_components,
    flight_components_envelope,
    flight_components_trajectory,
    tent_weights_lanes_minor,
    wind_tent_lanes_minor,
)
from .config import SimConfig
from .rail import RailInfo
from .simulate import FlightSummary, Trajectory
from .state import InitialConditions

__all__ = ["simulate_summary_batch", "simulate_flight_batch",
           "simulate_envelope_batch", "prepare_batch"]


def prepare_batch(scene_b: Scene, ic_b: InitialConditions):
    """Split a batched scene into (scene-without-wind, grid[N], wind[3,N,B]
    or [3,N,1], ics 12-tuple) — the component path's input layout. The
    [B,N,3] -> [3,N,B] transpose is a one-time cost outside the step loop.
    A SHARED [N,3] table stays [3,N,1]: the tent-basis product broadcasts
    the lane axis, so the (logically tiny) shared table is never
    materialized per-lane (~315 MB of device memory at B=262k for 1.2 KB
    of data)."""
    wind = scene_b.wind
    scene_nw = scene_b.replace(wind=None)
    grid = jnp.asarray(wind.altitudes)
    if isinstance(wind, WindModes):
        # Mode-compressed layout: shared basis [N,M] + per-lane scores
        # carried lanes-minor [3,M,B] (same reasoning as the [3,N,B] table
        # layout). The dict keys make the
        # jitted wind_fn's dispatch structural, not positional.
        wT = {
            "basis": jnp.asarray(wind.basis),
            "scores": jnp.transpose(jnp.asarray(wind.scores), (2, 1, 0)),
        }
    else:
        warr = jnp.asarray(wind.wind)
        if warr.ndim == 2:  # shared [N,3] table -> lane axis broadcasts
            wT = warr.T[:, :, None]
        else:  # [B,N,3] per-lane
            wT = jnp.transpose(warr, (2, 1, 0))
    ics = tuple(
        jnp.asarray(arr[:, c])
        for arr in (ic_b.position, ic_b.velocity, ic_b.attitude,
                    ic_b.angular_velocity)
        for c in range(3)
    )
    return scene_nw, grid, wT, ics


def _make_wind_fn(grid, wT):
    """Wind query closure over either layout.

    Dict = mode-compressed (`models.wind.WindModes` via prepare_batch):
    per-lane bytes are the [3,M,B] scores; the shared [N,M] basis is tent-
    interpolated at the per-lane altitude by one small matmul. Array =
    the [3,N,B] per-lane (or [3,N,1] shared) table layout.
    """
    if isinstance(wT, dict):
        basis = wT["basis"]    # [N, M] shared
        scores = wT["scores"]  # [3, M, B] per-lane

        def wind_fn(alt):
            su, sv, sw = scores[0], scores[1], scores[2]
            if su.dtype != alt.dtype:
                # bf16-stored scores (SimConfig.wind_table_bf16): the
                # upcast fuses into the score contraction.
                su = su.astype(alt.dtype)
                sv = sv.astype(alt.dtype)
                sw = sw.astype(alt.dtype)
            w = tent_weights_lanes_minor(alt, grid)              # [N,B]
            bval = jnp.einsum("nm,nb->mb", basis.astype(alt.dtype), w,
                              precision=jax.lax.Precision.HIGHEST)
            return (
                jnp.sum(bval * su, axis=0),
                jnp.sum(bval * sv, axis=0),
                jnp.sum(bval * sw, axis=0),
            )

        return wind_fn

    def wind_fn(alt):
        u, v, w = wT[0], wT[1], wT[2]
        if u.dtype != alt.dtype:
            # bf16-stored table (SimConfig.wind_table_bf16): the upcast
            # fuses into the tent multiply — no f32 copy materializes.
            u = u.astype(alt.dtype)
            v = v.astype(alt.dtype)
            w = w.astype(alt.dtype)
        return wind_tent_lanes_minor(alt, grid, u, v, w)

    return wind_fn


@functools.partial(jax.jit, static_argnums=3)
def _run_components(scene_nw, grid, wT, cfg, ics):
    return flight_components(scene_nw, cfg, _make_wind_fn(grid, wT), ics)


@functools.partial(jax.jit, static_argnums=3)
def _run_components_trajectory(scene_nw, grid, wT, cfg, ics):
    return flight_components_trajectory(
        scene_nw, cfg, _make_wind_fn(grid, wT), ics
    )


@functools.partial(jax.jit, static_argnums=(3, 5, 6, 7, 11))
def _run_components_envelope(scene_nw, grid, wT, cfg, ics, channels, n_bins,
                             n_buckets, bin_dt, lo, width, hist_every):
    return flight_components_envelope(
        scene_nw, cfg, _make_wind_fn(grid, wT), ics, channels, n_bins,
        n_buckets, bin_dt, lo, width, hist_every,
    )


def simulate_envelope_batch(scene_b, ic_b, cfg: SimConfig, *, channels,
                            n_bins, n_buckets, bin_dt, lo, width,
                            hist_every: int = 1):
    """[B]-batched flights reduced IN-LOOP to per-time-bin envelope
    aggregates — no [T, B] frame buffers (the chunk-size OOM ceiling of
    the record-then-bin path; see ``engine.component.
    flight_components_envelope``). Same masked steps and recording cadence
    as ``simulate_flight_batch``. Requires pre-calibrated histogram edges
    ``lo``/``width`` [C, n_bins] (``mc.EnvelopeAccumulator`` calibrates on
    a frame-based first chunk). Returns ``(summary: FlightSummary, agg)``
    for ``EnvelopeAccumulator.add_aggregates``.
    """
    scene_nw, grid, wT, ics = prepare_batch(scene_b, ic_b)
    if cfg.wind_table_bf16:
        wT = _bf16_tables(wT)
    res, agg = _run_components_envelope(
        scene_nw, grid, wT, cfg, ics, tuple(channels), int(n_bins),
        int(n_buckets), bin_dt, lo, width, int(hist_every),
    )
    return _summary_pytree(res), agg


def simulate_summary_batch(
    scene_b: Scene, ic_b: InitialConditions, cfg: SimConfig = SimConfig()
) -> FlightSummary:
    """[B]-batched flight summaries via the component-form core.

    Accepts the same batched (scene, ics) as ``vmap(simulate_summary)``
    (shared scene leaves stay unbatched; broadcasting handles both), and
    returns an identical ``FlightSummary`` pytree.
    """
    scene_nw, grid, wT, ics = prepare_batch(scene_b, ic_b)
    if cfg.wind_table_bf16:
        wT = _bf16_tables(wT)
    res = _run_components(scene_nw, grid, wT, cfg, ics)
    return _summary_pytree(res)


def _bf16_tables(wT):
    """wind_table_bf16: halve the per-lane bytes — the [3,N,B] table, or
    just the scores in the mode-compressed layout (the shared basis stays
    f32: it is tiny and shared, and keeping it full precision halves the
    compounding of rounding error through the two-stage contraction)."""
    if isinstance(wT, dict):
        return {**wT, "scores": wT["scores"].astype(jnp.bfloat16)}
    return wT.astype(jnp.bfloat16)


def _summary_pytree(res: dict) -> FlightSummary:
    def stack3(x, y, z):
        return jnp.stack([res[x], res[y], res[z]], axis=-1)

    quat = jnp.stack([res["quat_w"], res["quat_x"], res["quat_y"],
                      res["quat_z"]], axis=-1)
    rail = RailInfo(
        rail_exit_time=res["rail_exit_time"],
        rail_exit_position=stack3("rail_px", "rail_py", "rail_pz"),
        rail_exit_velocity=stack3("rail_vx", "rail_vy", "rail_vz"),
        rail_exit_speed=res["rail_exit_speed"],
        rail_exit_euler=quaternion_to_euler(quat),
        rail_exit_angle_of_attack=res["rail_exit_angle_of_attack"],
        rail_exit_sideslip=res["rail_exit_sideslip"],
        wind_at_exit=stack3("rail_wu", "rail_wv", "rail_ww"),
    )
    return FlightSummary(
        apogee_altitude=res["apogee_altitude"],
        apogee_time=res["apogee_time"],
        range=res["range"],
        flight_time=res["flight_time"],
        landing_position=stack3("final_px", "final_py", "final_pz"),
        final_velocity=stack3("final_vx", "final_vy", "final_vz"),
        max_speed=res["max_speed"],
        parachute_deployed=res["parachute_deployed"].astype(bool),
        diverged=res["diverged"].astype(bool),
        n_steps=res["n_steps"],
        rail=rail,
    )


def simulate_flight_batch(
    scene_b: Scene, ic_b: InitialConditions, cfg: SimConfig = SimConfig()
):
    """[B]-batched flights WITH recorded trajectories on the component core.

    The trajectory twin of ``simulate_summary_batch`` — same engine, same
    masked steps, so it honors every SimConfig flag including the tiered
    timestep (which the stacked-vector ``simulate_flight`` refuses). Returns
    ``(summary: FlightSummary, trajectory: Trajectory)`` with the same
    ``[B, T, ...]`` leaf layout as ``vmap(simulate_flight)``; the summary
    matches ``simulate_summary_batch`` on the same inputs to float noise.

    Replaces the reference's record-as-you-integrate single engine
    (`/root/reference/rocket_simulation/simulator.py:208-293,462-584`).
    """
    scene_nw, grid, wT, ics = prepare_batch(scene_b, ic_b)
    if cfg.wind_table_bf16:
        wT = _bf16_tables(wT)
    res, recs = _run_components_trajectory(scene_nw, grid, wT, cfg, ics)
    summary = _summary_pytree(res)

    # [T, ...] time-major flat components -> the [B, T, ...] Trajectory
    # layout (one transpose outside the loop; lanes stay minor in the scan).
    def bt(x):  # [T, B] -> [B, T] (prepare_batch guarantees batched inputs)
        return jnp.moveaxis(x, 0, 1)

    def stack3(x, y, z):
        return jnp.stack([bt(x), bt(y), bt(z)], axis=-1)

    derived = {}
    if cfg.record_derived:
        d = recs["derived"]
        derived = {k: bt(v) for k, v in d.items()
                   if not k.startswith("euler_")}
        if "euler_roll" in d:  # absent when record_channels filtered it
            derived["euler_angles"] = stack3(
                d["euler_roll"], d["euler_pitch"], d["euler_yaw"]
            )
    traj = Trajectory(
        time=bt(recs["time"]),
        position=stack3(recs["px"], recs["py"], recs["pz"]),
        velocity=stack3(recs["vx"], recs["vy"], recs["vz"]),
        quaternion=jnp.stack(
            [bt(recs["qw"]), bt(recs["qx"]), bt(recs["qy"]), bt(recs["qz"])],
            axis=-1,
        ),
        angular_velocity=stack3(recs["ox"], recs["oy"], recs["oz"]),
        propellant_fraction=bt(recs["frac"]),
        valid=bt(recs["valid"]),
        derived=derived,
    )
    return summary, traj
