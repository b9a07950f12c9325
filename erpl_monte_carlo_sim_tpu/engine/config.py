"""Integration / event configuration (static, hashable).

Mirrors the reference's hard-coded integrator knobs
(`/root/reference/rocket_simulation/simulator.py:18-40,209,237-264`) as one
frozen dataclass. It is passed to the jitted entry points as a STATIC
argument: every field is baked into the compiled program as a constant, so
there is no data-dependent control flow and no per-step scalar traffic.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["SimConfig"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static integration parameters.

    Defaults reproduce the reference exactly:
      * main RK4 step 5 ms (`simulator.py:209` caps dt_initial at 0.005),
      * rail forward-Euler step 10 ms (`simulator.py:20,61`),
      * 18.288 m rail (`simulator.py:42`),
      * 300 s max flight (`simulator.py:19`),
      * pitch/yaw damping 20 N m s/rad (`simulator.py:36-37`),
      * ground at 0.5 m with descending velocity (`simulator.py:237-239`),
      * 100 km unphysical-altitude cutoff (`simulator.py:241-244`),
      * apogee detection above 1 km + tiered coast timeouts 60/120/300 s
        above 50/25 km (`simulator.py:246-264`).
    """

    dt: float = 0.005
    rail_dt: float = 0.01
    max_time: float = 300.0
    rail_length: float = 18.288
    max_rail_steps: int = 4096  # static bound; reference rail exits in ~90 steps

    pitch_damping: float = 20.0
    yaw_damping: float = 20.0

    ground_altitude: float = 0.5
    excessive_altitude: float = 100000.0
    apogee_min_altitude: float = 1000.0
    coast_alt_hi: float = 50000.0
    coast_alt_mid: float = 25000.0
    coast_time_hi: float = 60.0
    coast_time_mid: float = 120.0
    coast_time_lo: float = 300.0

    # Engine improvement over the reference: terminate a lane as diverged the
    # moment its state stops being finite (the reference runs NaN lanes to
    # max_time and relies on the outlier filter; see SURVEY.md §6).
    terminate_nonfinite: bool = True
    # Optional divergence guard: speeds beyond this flag the lane diverged
    # (finite-but-absurd states). Default inf = reference parity: a lane that
    # spikes but lands with in-bounds metrics stays "valid", exactly as the
    # reference's outlier filter would treat it.
    speed_guard: float = float("inf")  # m/s

    # OPT-IN (default False = exact reference parity): evaluate wind ONCE
    # per RK4 step (at the step's starting altitude) instead of once per
    # stage. Altitude moves ~2 m within a step, so the wind difference is
    # ~0.01 m/s on a 100-point profile — far below the dispersion sigma —
    # while the per-lane wind table is the Monte Carlo hot loop's dominant
    # bandwidth consumer.
    wind_eval_per_step: bool = False

    # OPT-IN (default False = exact reference parity): store the per-lane
    # wind table in bfloat16 (compute stays f32 — the upcast fuses into the
    # tent-basis multiply). The table is the Monte Carlo hot loop's dominant
    # memory traffic once the component path removed the padding spills.
    # Wind values are AR(1) dispersion noise with sigma ~2 m/s;
    # bf16 rounding (~0.4% relative) is far below that — median apogee
    # shifts <0.01 m (pinned by tests/test_batch.py).
    wind_table_bf16: bool = False

    # OPT-IN (default "rk4" = exact reference parity, `simulator.py:216-227`):
    # "rk2" integrates with the midpoint method — TWO dynamics evaluations
    # per step instead of four, halving the dynamics evaluations. Accuracy:
    # local error O(dt^3) vs RK4's O(dt^5); at dt=5 ms the boost/coast
    # dynamics (weathercock periods >= 0.2 s) are resolved to far below
    # dispersion sigma — measured deltas pinned in tests/test_batch.py.
    # CAUTION: the chute-opening transient's |lambda|*dt approaches the
    # midpoint method's real-axis stability bound at full speed; use for
    # windowed MC (no chute) or with descent_dt_scale's fine-dt settle
    # windows, and validate full-flight configs against parity. Checked
    # at scale (NOTES.md): 65,536 dispersed FULL flights to landing
    # under stabilized + tiered flags — zero divergences, every chute
    # deployed, population apogee mean/std within 0.05 m of rk4's,
    # lane-matched deltas median 0.2 m vs a 684 m dispersion sigma.
    integrator: str = "rk4"

    # OPT-IN (default False = exact reference parity): energy-consistent
    # aero force decomposition. The reference's wind->body matrix does not
    # map drag exactly opposite the relative wind when alpha AND beta are
    # both nonzero (`utils.py:175-205`: column 1 is (ca*cb, ca*sb, -sa) but
    # the flow direction is (cb*ca, sb, cb*sa)), so at high dynamic pressure
    # the misaligned 'drag' can do positive work — the physical driver of
    # the reference's wind-divergence (SURVEY.md §6). With this flag, drag
    # is applied strictly anti-parallel to the body-frame relative velocity
    # and lift/side are projected onto the perpendicular plane, so aero
    # forces can never inject translational energy.
    energy_consistent_aero: bool = False

    # OPT-IN (default 1 = exact reference parity): integrate settled descent
    # phases with dt * this factor. The reference holds dt=5 ms for the whole
    # flight (`simulator.py:209`), but ~2/3 of a full flight is descent:
    # ballistic free-fall from apogee (quasi-steady, attitude oscillation
    # periods of seconds) and parachute descent at terminal velocity. Both
    # are integrated accurately at much coarser steps; the two stiff
    # transients (apogee pitch-over, chute opening shock at ~200 m/s where
    # RK4 would go unstable: dt*rho*v*CdA/m > 2.8) keep the fine dt via the
    # settle windows below. Per-lane: each Monte Carlo lane switches on its
    # own event times. Component path (engine/batch.py) only. Measured at
    # scale=8 on the nominal full flight: apogee bit-identical, landing
    # delta well under the dispersion sigma (tests/test_descent.py).
    descent_dt_scale: int = 1
    # Seconds of fine-dt integration after apogee detection / parachute
    # deployment before the coarse step engages.
    descent_settle_time: float = 2.0
    # OPT-IN extension of descent_dt_scale (no effect at scale 1; 0.0 = off
    # = parity): also coarse-step the QUIET COAST ASCENT, gated per lane on
    # estimated dynamic pressure 0.5*rho*|v|^2 < this threshold [Pa] after
    # burnout. The weather-cocking pitch frequency scales with sqrt(q), so
    # low q means attitude oscillation periods of many seconds — safely
    # resolved at dt * descent_dt_scale. Near apogee q -> 0, which is where
    # most coast steps are spent. Accuracy measured in tests/test_descent.py.
    ascent_q_threshold: float = 0.0

    # Summary mode: integrate this many exactly-masked RK4 steps per
    # while_loop iteration. Results are IDENTICAL to unroll=1 (every
    # sub-step applies its own done/termination mask); the aim is to
    # amortize per-iteration loop overhead in small-batch and
    # single-flight runs. Its effect on the GPU is not measured yet.
    unroll: int = 1

    # Trajectory mode: record the derived per-step quantities the reference
    # recomputes in its second hot loop (`simulator.py:462-584`), fused into
    # the scan instead.
    record_derived: bool = True
    # Trajectory mode: record every Nth step (1 = reference-exact history).
    # At 5 ms steps a full flight is ~41k samples; a stride of 10-100 bounds
    # device memory when recording trajectory clouds for large batches (SURVEY.md §7
    # "memory for trajectories"). Physics is unaffected — only recording.
    record_stride: int = 1
    # Trajectory mode: with record_derived, record ONLY these derived
    # channels (None = all of them, the reference-complete history).
    # The unrecorded channels' computations dead-code-eliminate inside
    # the jitted recorder, and each dropped channel saves a [T, B] device
    # buffer — the flight-envelope path needs 5 of the ~20 derived
    # channels (r4 recording-path ablation, NOTES.md). State channels
    # (position/velocity/quaternion/rates/time/valid) always record.
    record_channels: tuple | None = None

    def __post_init__(self):
        # string-enum validation (same convention as dispersions' sampler):
        # a typo like "RK2" or "midpoint" must be loud, not silently RK4
        if self.integrator not in ("rk4", "rk2"):
            raise ValueError(
                f"integrator must be 'rk4' or 'rk2', got {self.integrator!r}"
            )

    @property
    def max_steps(self) -> int:
        """Static bound on main-loop steps (reference worst case: rail_time~0)."""
        return int(math.ceil(self.max_time / self.dt))
