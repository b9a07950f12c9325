"""Vehicle geometry, mass properties, and aerodynamics as a pytree model.

Functional parity with `/root/reference/rocket_simulation/rocket.py:8-223`,
re-designed for batching:

  * configuration is a frozen dataclass of jnp scalars/arrays (vmaps over a
    Monte Carlo batch; no mutable attribute bags),
  * the Barrowman static CP is computed once at scene-construction time in
    plain Python (`barrowman_cp`) and stored as a field,
  * Mach tables (Cd0/CdA, CP shift) are gather-friendly arrays queried with
    clamped linear interpolation,
  * the stall model and power-off drag factor are branch-free ``jnp.where``
    selections so the whole coefficient build-up fuses into the dynamics step.

Reference quirks preserved on purpose (documented where they occur):
  * ``Izz`` always mirrors ``Iyy`` — the configured ``Izz_dry`` is never used
    in mass-property queries (`rocket.py:126-128`),
  * the pitch-moment coefficient ``cm`` is NOT stall-limited; it keeps the
    linear ``-cl_alpha * static_margin * alpha`` form at any alpha
    (`rocket.py:189-197`), and ``cyaw`` likewise uses raw beta
    (`rocket.py:206`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from ..utils import struct
from ..ops.interp import interpolate_1d

__all__ = [
    "RocketParams",
    "MassProperties",
    "AeroCoefficients",
    "barrowman_cp",
    "barrowman_cp_traced",
    "refresh_derived",
    "mass_properties",
    "dynamic_cp",
    "aero_coefficients",
    "stability_margin",
]

# Default tables (`rocket.py:43-53`).
_CD_MACH = (0.0, 0.5, 0.8, 1.0, 1.2, 1.5, 2.0, 3.0)
_CD0 = (0.4, 0.42, 0.48, 0.65, 0.52, 0.45, 0.40, 0.38)
_CDA = (1.2, 1.25, 1.3, 1.4, 1.35, 1.25, 1.2, 1.15)
_CP_SHIFT_MACH = (0.0, 0.8, 1.0, 1.2, 2.0, 3.0)
_CP_SHIFT = (0.0, -0.05, -0.1, -0.05, 0.0, 0.0)


@struct.dataclass
class RocketParams:
    """Frozen vehicle parameters. Defaults mirror `rocket.py:11-66`."""

    # Metadata (reference report schema has a `name`, `rocket.py:12`)
    name: str = struct.field(pytree_node=False, default="Sounding Rocket")

    # Geometry
    length: jnp.ndarray = 7.62
    diameter: jnp.ndarray = 0.219
    nose_length: jnp.ndarray = 0.2
    fin_span: jnp.ndarray = 0.2
    fin_root_chord: jnp.ndarray = 0.20
    fin_tip_chord: jnp.ndarray = 0.1
    fin_count: jnp.ndarray = 4.0
    fin_sweep_angle: jnp.ndarray = 0.0
    fin_cant_angle: jnp.ndarray = 0.0

    # Mass
    dry_mass: jnp.ndarray = 113.4
    propellant_mass: jnp.ndarray = 63.5
    center_of_mass_dry: jnp.ndarray = 5.8
    Ixx_dry: jnp.ndarray = 45.0
    Iyy_dry: jnp.ndarray = 971.9
    Izz_dry: jnp.ndarray = 971.693  # kept for schema parity; see module notes

    # Aero references
    reference_area: jnp.ndarray = math.pi * (0.219 / 2) ** 2
    reference_diameter: jnp.ndarray = 0.219

    # Mach tables
    cd_mach: jnp.ndarray = struct.field(default_factory=lambda: jnp.array(_CD_MACH))
    cd0_table: jnp.ndarray = struct.field(default_factory=lambda: jnp.array(_CD0))
    cda_table: jnp.ndarray = struct.field(default_factory=lambda: jnp.array(_CDA))
    cp_shift_mach: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.array(_CP_SHIFT_MACH)
    )
    cp_shift_table: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.array(_CP_SHIFT)
    )

    # Barrowman static CP (precomputed; see ``create``)
    cp_location: jnp.ndarray = 0.0

    # Recovery system (`rocket.py:59-61`)
    parachute_area: jnp.ndarray = 15.0
    parachute_cd: jnp.ndarray = 2.0
    parachute_deployment_altitude: jnp.ndarray = 500.0

    power_off_drag_factor: jnp.ndarray = 1.2

    # OPT-IN stabilization (default False = exact reference parity): the
    # reference tapers lift/normal/side forces past stall but leaves the
    # pitch/yaw MOMENTS on the unbounded linear form (`rocket.py:189-206`),
    # which drives a physical tumble instability under crosswind at high
    # dynamic pressure (verified: the reference integrator itself blows up
    # to 1e37-scale ranges; dt-independent). With this flag the same stall
    # taper is applied to cm/cyaw — physically, stalled fins lose moment
    # authority exactly like they lose lift.
    stall_limited_moments: bool = struct.field(pytree_node=False, default=False)

    @classmethod
    def create(cls, **overrides) -> "RocketParams":
        """Build params with derived fields (reference area, Barrowman CP)."""
        params = cls(**overrides)
        d = float(params.diameter)
        area = math.pi * (d / 2) ** 2
        params = params.replace(reference_area=area, reference_diameter=d)
        return params.replace(cp_location=barrowman_cp(params))


def barrowman_cp(p: RocketParams) -> float:
    """Barrowman static center of pressure (config-time, plain Python).

    Parity: `rocket.py:68-103`. Nose CN=2 at 0.666*nose_length; cylindrical
    body contributes nothing; trapezoidal fins at quarter-MAC.
    """
    cn_nose = 2.0
    x_nose = 0.666 * float(p.nose_length)

    cr = float(p.fin_root_chord)
    ct = float(p.fin_tip_chord)
    s = float(p.fin_span)
    sweep = float(p.fin_sweep_angle)
    n = float(p.fin_count)
    diameter = float(p.diameter)
    ref_area = float(p.reference_area)
    length = float(p.length)

    fin_area = 0.5 * (cr + ct) * s
    lam = ct / cr if cr != 0 else 0.0
    cn_fins = 2.0 * n * (1.0 + diameter / (2.0 * s)) * (fin_area / ref_area)
    mac = (2.0 / 3.0) * cr * (1.0 + lam + lam**2) / (1.0 + lam)
    y_bar = s * (1.0 + 2.0 * lam) / (3.0 * (1.0 + lam))
    x_fins = (length - cr) + y_bar * math.tan(sweep) + 0.25 * mac

    cn_total = cn_nose + cn_fins
    if cn_total > 0:
        return (cn_nose * x_nose + cn_fins * x_fins) / cn_total
    return length / 2.0


def barrowman_cp_traced(p: RocketParams) -> jnp.ndarray:
    """``barrowman_cp`` as a traced jnp computation — same formula, no
    float() casts, so design gradients (``mc.robust``, the optimizer
    CLIs) can flow through the CP location. Agrees with the config-time
    Python value to dtype precision (pinned by test); branch guards
    become ``where`` so zero-chord/degenerate geometry stays finite.
    """
    cn_nose = 2.0
    x_nose = 0.666 * jnp.asarray(p.nose_length)

    cr = jnp.asarray(p.fin_root_chord)
    ct = jnp.asarray(p.fin_tip_chord)
    s = jnp.asarray(p.fin_span)
    sweep = jnp.asarray(p.fin_sweep_angle)
    n = jnp.asarray(p.fin_count)
    diameter = jnp.asarray(p.diameter)
    ref_area = jnp.asarray(p.reference_area)
    length = jnp.asarray(p.length)

    fin_area = 0.5 * (cr + ct) * s
    lam = jnp.where(cr != 0, ct / jnp.where(cr != 0, cr, 1.0), 0.0)
    # double-where guard on the span division (cf. ops.math.safe_sqrt):
    # at s == 0 the primal already resolves to length/2 via the cn_total
    # guard below, but the unguarded d/(2*s) would leak NaN into REVERSE
    # mode (0-cotangent * inf intermediate) — a finless scene would NaN
    # every design gradient.
    s_ok = s > 0
    cn_fins = jnp.where(
        s_ok,
        2.0 * n * (1.0 + diameter / (2.0 * jnp.where(s_ok, s, 1.0)))
        * (fin_area / ref_area),
        0.0,
    )
    mac = (2.0 / 3.0) * cr * (1.0 + lam + lam**2) / (1.0 + lam)
    y_bar = s * (1.0 + 2.0 * lam) / (3.0 * (1.0 + lam))
    x_fins = (length - cr) + y_bar * jnp.tan(sweep) + 0.25 * mac

    cn_total = cn_nose + cn_fins
    cp = jnp.where(
        cn_total > 0,
        (cn_nose * x_nose + cn_fins * x_fins)
        / jnp.where(cn_total > 0, cn_total, 1.0),
        length / 2.0,
    )
    # s == 0: the config-time barrowman_cp raises ZeroDivisionError here
    # (Python floats); the traced twin defines the degenerate value as the
    # same length/2 fallback its cn_total guard uses, with a finite
    # gradient (pinned by test_finless_design_gradient_finite).
    return jnp.where(s_ok, cp, length / 2.0)


def refresh_derived(p: RocketParams) -> RocketParams:
    """Recompute the derived geometry fields (reference area/diameter,
    Barrowman CP) from the primary ones, traced. ``create()`` does this
    once in Python at config time; design-optimization writes
    (``mc.robust``, ``cli.optimize_apogee``) call this after changing a
    geometry leaf so the gradient carries the full effect — including CP
    travel and the stability-margin change, not just the sim-time lift
    terms."""
    d = jnp.asarray(p.diameter)
    p = p.replace(reference_area=jnp.pi * (d / 2.0) ** 2,
                  reference_diameter=d)
    return p.replace(cp_location=barrowman_cp_traced(p))


class MassProperties(NamedTuple):
    mass: jnp.ndarray
    center_of_mass: jnp.ndarray
    Ixx: jnp.ndarray
    Iyy: jnp.ndarray
    Izz: jnp.ndarray


def mass_properties(p: RocketParams, propellant_fraction) -> MassProperties:
    """Time-varying mass/CG/inertia from propellant remaining.

    Parity: `rocket.py:110-136`. Propellant CG sits 0.5 m forward of the dry
    CG; slab inertia model with a 2 m propellant column; Izz := Iyy.
    """
    current_prop = p.propellant_mass * propellant_fraction
    total_mass = p.dry_mass + current_prop
    prop_cg = p.center_of_mass_dry - 0.5
    cg = (p.dry_mass * p.center_of_mass_dry + current_prop * prop_cg) / total_mass

    prop_length = 2.0
    prop_ixx = current_prop * (p.diameter / 4.0) ** 2
    prop_iyy = current_prop * (prop_length**2 / 12.0 + (prop_cg - cg) ** 2)
    ixx = p.Ixx_dry + prop_ixx
    iyy = p.Iyy_dry + prop_iyy
    return MassProperties(total_mass, cg, ixx, iyy, iyy)


def dynamic_cp(p: RocketParams, mach) -> jnp.ndarray:
    """Mach-shifted center of pressure (`rocket.py:105-108`)."""
    shift = interpolate_1d(mach, p.cp_shift_mach, p.cp_shift_table)
    return p.cp_location + shift


def stability_margin(p: RocketParams, propellant_fraction) -> jnp.ndarray:
    """Static stability margin in calibers (`rocket.py:220-223`).

    Uses the static (Mach-0) CP like the reference.
    """
    mp = mass_properties(p, propellant_fraction)
    return (p.cp_location - mp.center_of_mass) / p.reference_diameter


class AeroCoefficients(NamedTuple):
    cd: jnp.ndarray
    cl: jnp.ndarray
    cm: jnp.ndarray
    cp: jnp.ndarray
    cn: jnp.ndarray
    cy: jnp.ndarray
    croll: jnp.ndarray
    cpitch: jnp.ndarray
    cyaw: jnp.ndarray


def aero_coefficients(
    p: RocketParams,
    mach,
    alpha,
    beta=0.0,
    center_of_mass=None,
    power_on=True,
) -> AeroCoefficients:
    """Full aerodynamic coefficient build-up, branch-free.

    Parity: `rocket.py:138-218` — Cd0/CdA Mach tables with quadratic-alpha
    drag, x1.2 power-off drag, finite-wing lift slope with compressibility
    and sweep, 15 deg -> 45 deg stall taper on cl/cy/cn (cm/cyaw deliberately
    NOT stall-limited, matching the reference), moments from the dynamic-CP
    static margin.

    ``power_on`` may be a traced boolean array (vmap lanes burn out at
    different times). ``center_of_mass`` defaults to the dry CG like the
    reference's ``mass_props=None`` path.
    """
    mach = jnp.asarray(mach)
    alpha = jnp.asarray(alpha)
    beta = jnp.asarray(beta)
    if center_of_mass is None:
        center_of_mass = p.center_of_mass_dry

    cd0 = interpolate_1d(mach, p.cd_mach, p.cd0_table)
    cda = interpolate_1d(mach, p.cd_mach, p.cda_table)
    cd = cd0 + cda * alpha**2
    cd = jnp.where(power_on, cd, cd * p.power_off_drag_factor)

    stall_angle = jnp.radians(15.0)
    max_angle = jnp.radians(45.0)
    abs_alpha = jnp.abs(alpha)
    stalled = abs_alpha > stall_angle
    stall_factor = jnp.maximum(
        0.0, 1.0 - (abs_alpha - stall_angle) / (max_angle - stall_angle)
    )

    # Finite-wing lift slope with compressibility (`rocket.py:171-181`).
    # The reference's sub/supersonic branches are algebraically identical:
    # sqrt(|1 - M^2|) == sqrt(|M^2 - 1|).
    cr = p.fin_root_chord
    ct = p.fin_tip_chord
    s = p.fin_span
    fin_area = 0.5 * (cr + ct) * s
    aspect_ratio = 2.0 * s**2 / fin_area
    beta_m = jnp.sqrt(jnp.abs(1.0 - mach**2))
    cos_sweep = jnp.cos(p.fin_sweep_angle)
    denom = 2.0 + jnp.sqrt(
        4.0 + (aspect_ratio * beta_m / jnp.maximum(cos_sweep, 1e-6)) ** 2
    )
    cl_alpha = (2.0 * jnp.pi * aspect_ratio / denom) * cos_sweep

    cl_linear = cl_alpha * alpha
    cl_stalled = cl_alpha * stall_angle * stall_factor * jnp.sign(alpha)
    cl = jnp.where(stalled, cl_stalled, cl_linear)
    cd = jnp.where(
        stalled,
        cd * (1.0 + 0.5 * (abs_alpha - stall_angle) / (max_angle - stall_angle)),
        cd,
    )

    cp_current = dynamic_cp(p, mach)
    sm = cp_current - center_of_mass
    cm = -cl_alpha * sm * alpha  # NOT stall-limited (reference quirk)

    cy = jnp.where(stalled, cl_alpha * beta * stall_factor, cl_alpha * beta)
    cn = jnp.where(stalled, cl_stalled, cl_alpha * alpha)
    cyaw = -cl_alpha * sm * beta  # raw beta (reference quirk)

    if p.stall_limited_moments:
        # Opt-in: saturate the restoring moments at their stall-onset value
        # and taper with the same stall factor as the forces.
        cm_sat = -cl_alpha * sm * stall_angle * stall_factor * jnp.sign(alpha)
        cm = jnp.where(stalled, cm_sat, cm)
        abs_beta = jnp.abs(beta)
        beta_stalled = abs_beta > stall_angle
        beta_sf = jnp.maximum(
            0.0, 1.0 - (abs_beta - stall_angle) / (max_angle - stall_angle)
        )
        cyaw_sat = -cl_alpha * sm * stall_angle * beta_sf * jnp.sign(beta)
        cyaw = jnp.where(beta_stalled, cyaw_sat, cyaw)

    zero = jnp.zeros_like(cd)
    return AeroCoefficients(
        cd=cd, cl=cl, cm=cm, cp=cp_current, cn=cn, cy=cy,
        croll=zero, cpitch=cm, cyaw=cyaw,
    )
