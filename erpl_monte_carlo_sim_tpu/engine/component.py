"""Component-form whole-flight core: every quantity is a flat [...] array.

Why this exists: the stacked-vector path's main loop compiles to ~560
fusions whose boundaries spill [B,3]/[B,4]/[B,3,3] intermediates to device
memory, with a minor dimension of 3 that the device layout pads. Keeping
EVERY loop-carried and spilled quantity as a flat [B] f32/int32 vector
removes the padding and most relayouts.

The same functions run in two contexts (shape-polymorphic, pure jnp):
  * under plain ``jit`` on [B]-wide arrays — ``engine.batch``, the Monte
    Carlo hot path,
  * at B=1 for low-latency single flights.

Wind access is a caller-provided closure ``wind_fn(alt) -> (u, v, w)`` so
each caller picks its table layout (``engine.batch``: a lanes-minor
[3,N,B] table, or mode scores against a shared basis).

The physics formulas mirror the reference (cited per function); the
structural redesign is the flat-component representation. See
`/root/reference/rocket_simulation/utils.py:100-121,175-205`,
`simulator.py:42-125,208-264,295-460`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.atmosphere import atmosphere_properties, gravity_at
from ..models.motor import mass_flow_rate_at, propellant_remaining, thrust_at
from ..models.rocket import aero_coefficients, dynamic_cp, mass_properties
from ..ops.math import safe_sqrt

__all__ = [
    "quat_normalize_c",
    "rotmat_c",
    "qdot_c",
    "wind_tent_lanes_minor",
    "dynamics_c",
    "rk4_c",
    "derived_c",
    "flight_components",
    "flight_components_trajectory",
]


# --------------------------------------------------------------------------
# component-form building blocks (all args/returns are [...] arrays)
# --------------------------------------------------------------------------

def quat_normalize_c(qw, qx, qy, qz):
    """`utils.py:76-82` with the identity fallback."""
    n = jnp.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    ok = n > 1e-12
    inv = 1.0 / jnp.where(ok, n, 1.0)
    return (
        jnp.where(ok, qw * inv, 1.0),
        jnp.where(ok, qx * inv, 0.0),
        jnp.where(ok, qy * inv, 0.0),
        jnp.where(ok, qz * inv, 0.0),
    )


def rotmat_c(qw, qx, qy, qz):
    """Body->inertial DCM components (`utils.py:100-111`), post-normalize."""
    qw, qx, qy, qz = quat_normalize_c(qw, qx, qy, qz)
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    return (r00, r01, r02, r10, r11, r12, r20, r21, r22)


def qdot_c(qw, qx, qy, qz, ox, oy, oz):
    """Quaternion kinematics + Baumgarte correction (`utils.py:114-121`)."""
    dw = 0.5 * (-qx * ox - qy * oy - qz * oz)
    dx = 0.5 * (qw * ox + qy * oz - qz * oy)
    dy = 0.5 * (qw * oy - qx * oz + qz * ox)
    dz = 0.5 * (qw * oz + qx * oy - qy * ox)
    err = qw * qw + qx * qx + qy * qy + qz * qz - 1.0
    return (
        dw - 0.5 * err * qw,
        dx - 0.5 * err * qx,
        dy - 0.5 * err * qy,
        dz - 0.5 * err * qz,
    )


def tent_weights_lanes_minor(alt, grid):
    """Clamped-linear tent weights [N,B] for per-lane altitudes ``alt [B]``
    on the shared ``grid [N]`` — the gather-free interpolation core shared
    by the table query (`wind_tent_lanes_minor`) and the mode-compressed
    query (`engine.batch`'s WindModes path)."""
    n = grid.shape[0]
    xc = jnp.clip(alt, grid[0], grid[n - 1])[None, :]  # [1,B]
    dg = jnp.maximum(grid[1:] - grid[:-1], 1e-30)
    left = jnp.concatenate([jnp.ones_like(dg[:1]), dg])[:, None]    # [N,1]
    right = jnp.concatenate([dg, jnp.ones_like(dg[:1])])[:, None]   # [N,1]
    gcol = grid[:, None]
    up = (xc - (gcol - left)) / left
    down = ((gcol + right) - xc) / right
    return jnp.clip(jnp.minimum(up, down), 0.0, 1.0)  # [N,B]


def wind_tent_lanes_minor(alt, grid, wu, wv, ww):
    """Tent-basis wind query, lanes-MINOR layout: grid [N], wu/wv/ww [N,B],
    alt [B]. B is the contiguous (minor) axis, so every [N,B] operand is
    read with unit stride and the reduction runs over the major knot
    axis."""
    w = tent_weights_lanes_minor(alt, grid)
    return (
        jnp.sum(w * wu, axis=0),
        jnp.sum(w * wv, axis=0),
        jnp.sum(w * ww, axis=0),
    )


def dynamics_c(scene, cfg, wind_fn, t, st, para):
    """Component-form RHS (`simulator.py:295-460`). ``st`` is the state
    tuple; returns (derivative tuple, new parachute latch[int32])."""
    (px, py, pz, vx, vy, vz, qw, qx, qy, qz, ox, oy, oz, frac) = st
    rocket = scene.rocket

    frac = jnp.maximum(frac, 0.0)
    qw, qx, qy, qz = quat_normalize_c(qw, qx, qy, qz)
    R = rotmat_c(qw, qx, qy, qz)
    (r00, r01, r02, r10, r11, r12, r20, r21, r22) = R

    mp = mass_properties(rocket, frac)
    atm = atmosphere_properties(scene.atmosphere, pz)

    wu_h, wv_h, ww_h = wind_fn(pz)
    rvx = vx - wu_h
    rvy = vy - wv_h
    rvz = vz - ww_h
    # body frame: R^T @ v_rel
    ub = r00 * rvx + r10 * rvy + r20 * rvz
    vb = r01 * rvx + r11 * rvy + r21 * rvz
    wb = r02 * rvx + r12 * rvy + r22 * rvz

    rel_sq = rvx * rvx + rvy * rvy + rvz * rvz
    rel_speed = safe_sqrt(rel_sq)
    mach = rel_speed / atm.speed_of_sound
    # aero angles (`utils.py:160-172`); the double-where on the atan2 args
    # keeps reverse-mode finite at the degenerate point (atan2's vjp is
    # 0/0 when both args are exactly zero) without touching the primal
    degen = (jnp.abs(ub) < 1e-6) & (jnp.abs(wb) < 1e-6)
    alpha = jnp.where(degen, 0.0, jnp.arctan2(jnp.where(degen, 1.0, wb),
                                              jnp.where(degen, 1.0, ub)))
    v_xz = safe_sqrt(ub * ub + wb * wb)
    bdeg = v_xz < 1e-6
    beta = jnp.where(bdeg, 0.0, jnp.arctan2(jnp.where(bdeg, 1.0, vb),
                                            jnp.where(bdeg, 1.0, v_xz)))
    q_dyn = 0.5 * atm.density * rel_sq

    burning = (frac > 0.0) & (t <= scene.motor.burn_time)
    thrust = jnp.where(burning, thrust_at(scene.motor, t, atm.pressure), 0.0)

    # parachute latch (`simulator.py:366-369`), int32 representation
    deploy = (pz <= rocket.parachute_deployment_altitude) & (vz < 0.0)
    para = jnp.maximum(para, deploy.astype(jnp.int32))
    is_chute = para > 0

    # chute drag opposes body-frame rel velocity (`simulator.py:372-377`)
    body_speed = safe_sqrt(ub * ub + vb * vb + wb * wb)
    chute_coef = jnp.where(
        body_speed > 0.0,
        -0.5 * atm.density * body_speed * rocket.parachute_cd
        * rocket.parachute_area,
        0.0,
    )  # = -(0.5 rho |v|^2 Cd A)/|v|
    cfx = chute_coef * ub
    cfy = chute_coef * vb
    cfz = chute_coef * wb

    coeffs = aero_coefficients(
        rocket, mach, alpha, beta,
        center_of_mass=mp.center_of_mass, power_on=(frac > 0.0),
    )
    drag = q_dyn * coeffs.cd * rocket.reference_area
    lift = q_dyn * coeffs.cl * rocket.reference_area
    side = q_dyn * coeffs.cy * rocket.reference_area
    # wind->body matrix applied to (-drag, -side, -lift) (`utils.py:175-205`)
    ca = jnp.cos(alpha)
    sa = jnp.sin(alpha)
    cb = jnp.cos(beta)
    sb = jnp.sin(beta)
    afx = ca * cb * (-drag) + (-sb) * (-side) + sa * cb * (-lift)
    afy = ca * sb * (-drag) + cb * (-side) + sa * sb * (-lift)
    afz = -sa * (-drag) + ca * (-lift)
    has_q = q_dyn > 0.0
    afx = jnp.where(has_q, afx, 0.0)
    afy = jnp.where(has_q, afy, 0.0)
    afz = jnp.where(has_q, afz, 0.0)

    if cfg.energy_consistent_aero:
        inv_bs = 1.0 / jnp.maximum(body_speed, 1e-12)
        vhx = ub * inv_bs
        vhy = vb * inv_bs
        vhz = wb * inv_bs
        lsx = (-sb) * (-side) + sa * cb * (-lift)
        lsy = cb * (-side) + sa * sb * (-lift)
        lsz = ca * (-lift)
        lsx = jnp.where(has_q, lsx, 0.0)
        lsy = jnp.where(has_q, lsy, 0.0)
        lsz = jnp.where(has_q, lsz, 0.0)
        along = lsx * vhx + lsy * vhy + lsz * vhz
        afx = -drag * vhx + (lsx - along * vhx)
        afy = -drag * vhy + (lsy - along * vhy)
        afz = -drag * vhz + (lsz - along * vhz)
        afx = jnp.where(has_q, afx, 0.0)
        afy = jnp.where(has_q, afy, 0.0)
        afz = jnp.where(has_q, afz, 0.0)

    fx = jnp.where(is_chute, cfx, afx) + thrust
    fy = jnp.where(is_chute, cfy, afy)
    fz = jnp.where(is_chute, cfz, afz)

    mscale = q_dyn * rocket.reference_area * rocket.reference_diameter
    my = jnp.where(is_chute | ~has_q, 0.0, mscale * coeffs.cpitch)
    mz = jnp.where(is_chute | ~has_q, 0.0, mscale * coeffs.cyaw)
    mx = jnp.zeros_like(my)  # croll == 0 (`rocket.py:215`)
    # damping outside the branch (`simulator.py:413-415`)
    my = my - cfg.pitch_damping * oy
    mz = mz - cfg.yaw_damping * oz

    # inertial forces: R @ f_body, minus m g ez (`simulator.py:417-422`)
    fix = r00 * fx + r01 * fy + r02 * fz
    fiy = r10 * fx + r11 * fy + r12 * fz
    fiz = r20 * fx + r21 * fy + r22 * fz
    g = gravity_at(scene.atmosphere, pz)
    inv_m = 1.0 / mp.mass
    ax = fix * inv_m
    ay = fiy * inv_m
    az = (fiz - mp.mass * g) * inv_m

    # Euler rotational equations (`simulator.py:431-436`)
    dox = (mx - (mp.Izz - mp.Iyy) * oy * oz) / mp.Ixx
    doy = (my - (mp.Ixx - mp.Izz) * oz * ox) / mp.Iyy
    doz = (mz - (mp.Iyy - mp.Ixx) * ox * oy) / mp.Izz

    dqw, dqx, dqy, dqz = qdot_c(qw, qx, qy, qz, ox, oy, oz)

    # propellant with the 10 ms burnout ramp (`simulator.py:442-450`)
    mdot = mass_flow_rate_at(scene.motor, t)
    nominal = -mdot / rocket.propellant_mass
    safe = jnp.where(nominal != 0.0, nominal, -1.0)
    remaining = jnp.where(nominal != 0.0, frac / jnp.abs(safe), jnp.inf)
    dfrac = jnp.where(remaining < 0.01, -frac / 0.01, nominal)
    dfrac = jnp.where(burning, dfrac, 0.0)

    deriv = (vx, vy, vz, ax, ay, az, dqw, dqx, dqy, dqz, dox, doy, doz, dfrac)
    return deriv, para


def rk4_c(scene, cfg, wind_fn, t, st, para, dt=None):
    """RK4 with the parachute latch threaded through the stages
    (`simulator.py:216-227`). ``dt`` may be a traced per-lane array
    (descent_dt_scale); None means the static cfg.dt."""
    if dt is None:
        dt = cfg.dt

    def axpy(a, k):
        return tuple(s + a * d for s, d in zip(st, k))

    if cfg.wind_eval_per_step:
        # one wind eval at the step's starting altitude (SimConfig flag)
        w = wind_fn(st[2])
        eval_wind = lambda alt: w
    else:
        eval_wind = wind_fn

    k1, para = dynamics_c(scene, cfg, eval_wind, t, st, para)
    k2, para = dynamics_c(scene, cfg, eval_wind, t + 0.5 * dt,
                          axpy(0.5 * dt, k1), para)
    if cfg.integrator == "rk2":
        # midpoint method (SimConfig.integrator): two dynamics evals —
        # the fast-mode compute bound is the eval count (r4 ablation)
        new = tuple(s + dt * b for s, b in zip(st, k2))
        qw, qx, qy, qz = quat_normalize_c(new[6], new[7], new[8], new[9])
        return new[:6] + (qw, qx, qy, qz) + new[10:], para
    k3, para = dynamics_c(scene, cfg, eval_wind, t + 0.5 * dt,
                          axpy(0.5 * dt, k2), para)
    k4, para = dynamics_c(scene, cfg, eval_wind, t + dt, axpy(dt, k3), para)
    new = tuple(
        s + (dt / 6.0) * (a + 2 * b + 2 * c + d)
        for s, a, b, c, d in zip(st, k1, k2, k3, k4)
    )
    qw, qx, qy, qz = quat_normalize_c(new[6], new[7], new[8], new[9])
    return new[:6] + (qw, qx, qy, qz) + new[10:], para


def derived_c(scene, cfg, wind_fn, t_off, st) -> dict:
    """Component-form per-step derived quantities, matching the reference's
    extraction loop (`simulator.py:511-552`) and the stacked twin
    ``engine.simulate._derived_quantities`` field-for-field. All outputs are
    flat [...] arrays (``euler_*`` split per component so the trajectory
    scan never carries a minor-dim-3 array; the caller restacks once).

    ``t_off`` is the time since rail exit: the reference's extraction loop
    evaluates thrust UNGATED at the offset time (`simulator.py:543`)."""
    (px, py, pz, vx, vy, vz, qw, qx, qy, qz, ox, oy, oz, frac) = st
    rocket = scene.rocket
    mp = mass_properties(rocket, frac)
    atm = atmosphere_properties(scene.atmosphere, pz)
    wu, wv, ww = wind_fn(pz)
    rvx, rvy, rvz = vx - wu, vy - wv, vz - ww
    R = rotmat_c(qw, qx, qy, qz)
    ub = R[0] * rvx + R[3] * rvy + R[6] * rvz
    vb = R[1] * rvx + R[4] * rvy + R[7] * rvz
    wb = R[2] * rvx + R[5] * rvy + R[8] * rvz
    rel_sq = rvx * rvx + rvy * rvy + rvz * rvz
    mach = safe_sqrt(rel_sq) / atm.speed_of_sound
    degen = (jnp.abs(ub) < 1e-6) & (jnp.abs(wb) < 1e-6)
    aoa = jnp.where(degen, 0.0, jnp.arctan2(jnp.where(degen, 1.0, wb),
                                            jnp.where(degen, 1.0, ub)))
    v_xz = safe_sqrt(ub * ub + wb * wb)
    bdeg = v_xz < 1e-6
    beta = jnp.where(bdeg, 0.0, jnp.arctan2(jnp.where(bdeg, 1.0, vb),
                                            jnp.where(bdeg, 1.0, v_xz)))
    cp_val = dynamic_cp(rocket, mach)
    coeffs = aero_coefficients(
        rocket, mach, aoa, beta,
        center_of_mass=mp.center_of_mass, power_on=(frac > 0.0),
    )
    q_dyn = 0.5 * atm.density * rel_sq
    thrust = thrust_at(scene.motor, t_off, atm.pressure)

    # euler from quaternion, component form — identical math to
    # ops.quaternion.quaternion_to_euler (`utils.py:46-70,139-144`)
    sinp = 2.0 * (qw * qy - qz * qx)
    pitch = jnp.where(
        jnp.abs(sinp) >= 1,
        jnp.sign(sinp) * (jnp.pi / 2),
        jnp.arcsin(jnp.clip(sinp, -1.0, 1.0)),
    )
    return {
        "mass": mp.mass,
        "center_of_mass": mp.center_of_mass,
        "Ixx": mp.Ixx,
        "Iyy": mp.Iyy,
        "Izz": mp.Izz,
        "euler_roll": jnp.arctan2(2.0 * (qw * qx + qy * qz),
                                  1.0 - 2.0 * (qx * qx + qy * qy)),
        "euler_pitch": pitch,
        "euler_yaw": jnp.arctan2(2.0 * (qw * qz + qx * qy),
                                 1.0 - 2.0 * (qy * qy + qz * qz)),
        "thrust": thrust,
        "drag": q_dyn * coeffs.cd * rocket.reference_area,
        "cd": coeffs.cd,
        "cl": coeffs.cl,
        "cm": coeffs.cm,
        "cp_location_dynamic": cp_val,
        "stability_margin": (cp_val - mp.center_of_mass)
        / rocket.reference_diameter,
        "angle_of_attack": aoa,
        "sideslip_angle": beta,
        "speed": safe_sqrt(vx * vx + vy * vy + vz * vz),
        "altitude": pz,
        "mach": mach,
    }


def _flight_setup(scene, cfg, wind_fn, ics, rail_scan_steps=None):
    """Shared rail phase + main-loop closures for all three drivers
    (while-loop summaries, scan trajectory recorder, differentiable scan).

    Returns ``(carry0, aux)`` where ``carry0 = (state tuple, event dict)``
    and ``aux`` provides ``lane_active``/``main_body``/``t_of`` closures,
    the rail diagnostics, and a ``summarize(st, ev)`` closure building the
    flight_components output dict.

    ``rail_scan_steps``: run the rail phase as a fixed-length checkpointed
    ``lax.scan`` of exactly-masked steps instead of a ``while_loop`` —
    identical results (the body is masked on ``rail_active``; the reference
    exits the rail in ~90 steps), but reverse-mode differentiable for
    ``engine.diff``.
    """
    (px, py, pz, vx, vy, vz, roll, pitch, yaw, ox, oy, oz) = ics

    # initial quaternion from euler (`utils.py:14-35,129-136`)
    cr, sr = jnp.cos(roll / 2), jnp.sin(roll / 2)
    cp, sp = jnp.cos(pitch / 2), jnp.sin(pitch / 2)
    cy, sy = jnp.cos(yaw / 2), jnp.sin(yaw / 2)
    qw = cr * cp * cy + sr * sp * sy
    qx = sr * cp * cy - cr * sp * sy
    qy = cr * sp * cy + sr * cp * sy
    qz = cr * cp * sy - sr * sp * cy

    # direction = R[:,0]
    r = rotmat_c(qw, qx, qy, qz)
    dx, dy, dz = r[0], r[3], r[6]

    # ---------------- rail phase (`simulator.py:42-125`)
    dt_r = cfg.rail_dt
    speed0 = vx * dx + vy * dy + vz * dz
    zero = jnp.zeros_like(speed0)

    def rail_active(c):
        rpx, rpy, rpz, spd, dist, stp, frac = c
        t = stp.astype(spd.dtype) * dt_r
        return (dist < cfg.rail_length) & (t < scene.motor.burn_time) & (
            stp < cfg.max_rail_steps
        )

    def rail_body(c):
        rpx, rpy, rpz, spd, dist, stp, frac = c
        on = rail_active(c)
        t = stp.astype(spd.dtype) * dt_r
        mp = mass_properties(scene.rocket, frac)
        atm = atmosphere_properties(scene.atmosphere, rpz)
        wuh, wvh, wwh = wind_fn(rpz)
        rvx = dx * spd - wuh
        rvy = dy * spd - wvh
        rvz = dz * spd - wwh
        rel_speed_axial = rvx * dx + rvy * dy + rvz * dz
        mach = safe_sqrt(rvx * rvx + rvy * rvy + rvz * rvz) / atm.speed_of_sound
        coeffs = aero_coefficients(
            scene.rocket, mach, 0.0, 0.0,
            center_of_mass=mp.center_of_mass, power_on=True,
        )
        drag = (0.5 * atm.density * rel_speed_axial**2 * coeffs.cd
                * scene.rocket.reference_area)
        thrust = thrust_at(scene.motor, t, atm.pressure)
        g = gravity_at(scene.atmosphere, rpz)
        accel = (thrust - mp.mass * g - drag) / mp.mass
        nspd = spd + accel * dt_r
        sel = lambda a, b: jnp.where(on, a, b)
        nstp = stp + 1
        return (
            sel(rpx + dx * nspd * dt_r, rpx),
            sel(rpy + dy * nspd * dt_r, rpy),
            sel(rpz + dz * nspd * dt_r, rpz),
            sel(nspd, spd),
            sel(dist + nspd * dt_r, dist),
            sel(nstp, stp),
            sel(propellant_remaining(
                scene.motor, nstp.astype(spd.dtype) * dt_r), frac),
        )

    rail0 = (px, py, pz, speed0, zero, jnp.zeros_like(speed0, jnp.int32),
             jnp.ones_like(speed0))
    if rail_scan_steps is None:
        rail_out = jax.lax.while_loop(
            lambda c: jnp.any(rail_active(c)), rail_body, rail0
        )
    else:
        rail_out, _ = jax.lax.scan(
            jax.checkpoint(lambda c, _: (rail_body(c), None)),
            rail0, None, length=rail_scan_steps,
        )
    rpx, rpy, rpz, spd, dist, rstp, frac = rail_out
    rail_time = rstp.astype(spd.dtype) * dt_r
    vx = dx * spd
    vy = dy * spd
    vz = dz * spd

    # rail-exit diagnostics
    wuh, wvh, wwh = wind_fn(rpz)
    rvx, rvy, rvz = vx - wuh, vy - wvh, vz - wwh
    ub = r[0] * rvx + r[3] * rvy + r[6] * rvz
    vb = r[1] * rvx + r[4] * rvy + r[7] * rvz
    wb = r[2] * rvx + r[5] * rvy + r[8] * rvz
    degen = (jnp.abs(ub) < 1e-6) & (jnp.abs(wb) < 1e-6)
    rail_aoa = jnp.where(degen, 0.0, jnp.arctan2(jnp.where(degen, 1.0, wb),
                                                 jnp.where(degen, 1.0, ub)))
    v_xz = safe_sqrt(ub * ub + wb * wb)
    sdeg = v_xz < 1e-6
    rail_slip = jnp.where(sdeg, 0.0, jnp.arctan2(jnp.where(sdeg, 1.0, vb),
                                                 jnp.where(sdeg, 1.0, v_xz)))
    rail_speed = safe_sqrt(vx * vx + vy * vy + vz * vz)

    # ---------------- main loop (`simulator.py:208-264`)
    st = (rpx, rpy, rpz, vx, vy, vz, qw, qx, qy, qz, ox, oy, oz, frac)
    i0 = jnp.zeros_like(spd, jnp.int32)
    f0 = jnp.zeros_like(spd)
    ev = dict(
        step=i0, para=i0, apod=i0, done=i0, div=i0,
        apo_t=f0, max_coast=f0,
        max_alt=rpz, t_max=rail_time,
        max_spd=rail_speed, end_t=rail_time,
    )
    # descent_dt_scale > 1 needs true time as a carry (dt varies per lane)
    # plus the chute-deploy time; parity (scale=1) derives t from the step
    # counter so its carry — and its per-iteration strand count — is
    # unchanged.
    tiered = cfg.descent_dt_scale > 1
    if tiered:
        ev["t"] = rail_time + f0
        ev["dep_t"] = jnp.full_like(f0, jnp.inf)

    def t_of(ev):
        if tiered:
            return ev["t"]
        return rail_time + ev["step"].astype(spd.dtype) * cfg.dt

    def lane_active(c):
        st, ev = c
        return (ev["done"] == 0) & (t_of(ev) < cfg.max_time) & (
            ev["step"] < cfg.max_steps
        )

    def main_body(c):
        st, ev = c
        run = lane_active(c)
        t = t_of(ev)
        if tiered:
            # Coarse step only in settled descent, per lane: (a) ballistic
            # fall, once the apogee pitch-over transient has passed and the
            # lane cannot reach the chute-deploy altitude within 1.5 coarse
            # steps (the opening shock at ~200 m/s is stiff — RK4 needs the
            # fine dt through the latch), (b) under canopy after the opening
            # transient settles (terminal descent: lambda*dt << 1).
            dt_big = cfg.dt * cfg.descent_dt_scale
            settle = cfg.descent_settle_time
            fall_speed = jnp.maximum(-st[5], 0.0)
            clear = st[2] > (scene.rocket.parachute_deployment_altitude
                             + 1.5 * fall_speed * dt_big)
            ballistic = (
                (ev["apod"] > 0) & (ev["para"] == 0)
                & (t - ev["apo_t"] > settle) & clear
            )
            chuted = (ev["para"] > 0) & (t - ev["dep_t"] > settle)
            coarse = ballistic | chuted
            if cfg.ascent_q_threshold > 0.0:
                # quiet coast ascent: post-burnout, pre-apogee, low dynamic
                # pressure (attitude oscillation ~ sqrt(q) -> slow). Guards:
                # a lane whose peak never exceeds apogee_min_altitude keeps
                # apod==0 through its whole DESCENT, so this term must also
                # require the chute latch unfired and the deploy-altitude
                # margin (``clear``) — otherwise marginal low-apogee lanes
                # would coarse-step through the stiff opening shock.
                atm_g = atmosphere_properties(scene.atmosphere, st[2])
                q_est = 0.5 * atm_g.density * (
                    st[3] * st[3] + st[4] * st[4] + st[5] * st[5]
                )
                coarse = coarse | (
                    (t > scene.motor.burn_time) & (ev["apod"] == 0)
                    & (ev["para"] == 0) & clear
                    & (q_est < cfg.ascent_q_threshold)
                )
            dt_lane = jnp.where(coarse, dt_big, cfg.dt)
            new_st, para = rk4_c(scene, cfg, wind_fn, t, st, ev["para"],
                                 dt=dt_lane)
            t_new = t + dt_lane
        step_new = ev["step"] + 1
        if not tiered:
            new_st, para = rk4_c(scene, cfg, wind_fn, t, st, ev["para"])
            # same rounding as the parity t_of derivation (golden-pinned)
            t_new = rail_time + step_new.astype(spd.dtype) * cfg.dt
        alt = new_st[2]
        vzn = new_st[5]
        speed = safe_sqrt(
            new_st[3] ** 2 + new_st[4] ** 2 + new_st[5] ** 2
        )

        better = alt > ev["max_alt"]
        max_alt = jnp.where(better, alt, ev["max_alt"])
        t_max = jnp.where(better, t_new, ev["t_max"])
        max_spd = jnp.maximum(ev["max_spd"], speed)

        detect = (alt > cfg.apogee_min_altitude) & (vzn < 0.0) & (ev["apod"] == 0)
        coast_budget = jnp.where(
            alt > cfg.coast_alt_hi, cfg.coast_time_hi,
            jnp.where(alt > cfg.coast_alt_mid, cfg.coast_time_mid,
                      cfg.coast_time_lo),
        )
        apod = jnp.maximum(ev["apod"], detect.astype(jnp.int32))
        apo_t = jnp.where(detect, t_new, ev["apo_t"])
        max_coast = jnp.where(detect, coast_budget, ev["max_coast"])

        ground = (alt <= cfg.ground_altitude) & (vzn <= 0.0)
        excessive = alt > cfg.excessive_altitude
        coast_done = (apod > 0) & (alt > cfg.coast_alt_mid) & (
            (t_new - apo_t) > max_coast
        )
        finite = jnp.isfinite(alt) & jnp.isfinite(vzn) & jnp.isfinite(speed)
        sane = speed < cfg.speed_guard
        newly_div = (~finite | ~sane) if cfg.terminate_nonfinite else (
            jnp.zeros_like(finite)
        )
        div = jnp.maximum(ev["div"], newly_div.astype(jnp.int32))
        done = jnp.maximum(
            ev["done"],
            (ground | excessive | coast_done).astype(jnp.int32)
            | newly_div.astype(jnp.int32),
        )
        end_t = jnp.where(ev["done"] > 0, ev["end_t"], t_new)

        new_ev = dict(
            step=step_new, para=para, apod=apod, done=done, div=div,
            apo_t=apo_t, max_coast=max_coast, max_alt=max_alt, t_max=t_max,
            max_spd=max_spd, end_t=end_t,
        )
        if tiered:
            new_ev["t"] = t_new
            new_ev["dep_t"] = jnp.where(
                para > ev["para"], t_new, ev["dep_t"]
            )
        sel = lambda a, b: jnp.where(run, a, b)
        st_out = tuple(sel(a, b) for a, b in zip(new_st, st))
        ev_out = {k: sel(new_ev[k], ev[k]) for k in ev}
        return st_out, ev_out

    def summarize(fst, fev):
        fpx, fpy, fpz, fvx, fvy, fvz = fst[:6]
        rng = safe_sqrt(fpx * fpx + fpy * fpy)
        return {
            "apogee_altitude": fev["max_alt"],
            "apogee_time": fev["t_max"] - rail_time,
            "range": rng,
            "flight_time": fev["end_t"] - rail_time,
            "final_px": fpx, "final_py": fpy, "final_pz": fpz,
            "final_vx": fvx, "final_vy": fvy, "final_vz": fvz,
            "max_speed": fev["max_spd"],
            "parachute_deployed": fev["para"],
            "diverged": fev["div"],
            "n_steps": fev["step"],
            "rail_exit_time": rail_time,
            "rail_exit_speed": rail_speed,
            "rail_exit_angle_of_attack": rail_aoa,
            "rail_exit_sideslip": rail_slip,
            "rail_px": rpx, "rail_py": rpy, "rail_pz": rpz,
            "rail_vx": vx, "rail_vy": vy, "rail_vz": vz,
            "rail_wu": wuh, "rail_wv": wvh, "rail_ww": wwh,
            "quat_w": qw, "quat_x": qx, "quat_y": qy, "quat_z": qz,
        }

    aux = dict(
        lane_active=lane_active, main_body=main_body, t_of=t_of,
        rail_time=rail_time, summarize=summarize,
    )
    return (st, ev), aux


def flight_components(scene, cfg, wind_fn, ics) -> dict:
    """Full flight (rail + RK4 main loop + events) on flat components.

    ``ics``: 12 arrays (px, py, pz, vx, vy, vz, roll, pitch, yaw, ox, oy,
    oz), each [...]-shaped. Returns a dict of same-shaped arrays: the Monte
    Carlo summary metrics, rail diagnostics, and the final position/velocity
    (int32 for flags/counters). NOTE: ``quat_w..quat_z`` are the RAIL-EXIT
    attitude (== the launch attitude; the rail phase does not rotate), used
    by ``engine.batch`` for ``rail_exit_euler`` — NOT the landing attitude,
    which is not a reference summary metric and is not returned.
    """
    carry0, aux = _flight_setup(scene, cfg, wind_fn, ics)
    main_body = aux["main_body"]

    def body(c):
        for _ in range(max(1, cfg.unroll)):
            # unroll>1: K exactly-masked sub-steps per iteration — identical
            # results (main_body selects per-lane on ``lane_active``).
            c = main_body(c)
        return c

    st, ev = jax.lax.while_loop(
        lambda c: jnp.any(aux["lane_active"](c)), body, carry0
    )
    return aux["summarize"](st, ev)


def flight_components_trajectory(scene, cfg, wind_fn, ics):
    """Full flight with strided trajectory recording on the SAME core that
    runs Monte Carlo summaries — including the tiered-dt flags
    (``descent_dt_scale``/``ascent_q_threshold``), so exported histories
    integrate exactly the physics the summary run measured (the reference's
    one-engine-records-while-it-integrates behavior,
    `simulator.py:208-293,462-584`).

    Returns ``(summary_dict, records)``: ``summary_dict`` is identical to
    ``flight_components`` output evaluated on the same masked steps (the
    scan applies the same exactly-masked ``main_body``; extra post-
    termination iterations are no-ops), and ``records`` is a dict of
    time-major ``[T, ...]`` flat component arrays (T = ceil(max_steps /
    record_stride) + 1; index 0 is the rail-exit state) with a ``valid``
    mask. Flat [T, B] layout on purpose: a stacked [T, B, 3] scan output
    would carry a padded minor dimension of 3;
    ``engine.batch.simulate_flight_batch`` restacks once, outside the loop.
    """
    carry0, aux = _flight_setup(scene, cfg, wind_fn, ics)
    lane_active = aux["lane_active"]
    main_body = aux["main_body"]
    t_of = aux["t_of"]
    rail_time = aux["rail_time"]
    stride = max(1, cfg.record_stride)

    def record(c):
        st, ev = c
        t_off = t_of(ev) - rail_time
        out = {
            "time": t_off,
            "px": st[0], "py": st[1], "pz": st[2],
            "vx": st[3], "vy": st[4], "vz": st[5],
            "qw": st[6], "qx": st[7], "qy": st[8], "qz": st[9],
            "ox": st[10], "oy": st[11], "oz": st[12],
            "frac": st[13],
        }
        if cfg.record_derived:
            derived = derived_c(scene, cfg, wind_fn, t_off, st)
            if cfg.record_channels is not None:
                # unreferenced channels DCE inside the jit; each one
                # dropped saves its [T, B] buffer and its compute.
                # Any euler request ("euler_angles" or a component)
                # selects ALL three components — batch.py restacks them
                # as one [.., 3] array and needs the full set.
                keep = set(cfg.record_channels)
                if keep & {"euler_angles", "euler_roll", "euler_pitch",
                           "euler_yaw"}:
                    keep |= {"euler_roll", "euler_pitch", "euler_yaw"}
                derived = {k: v for k, v in derived.items() if k in keep}
            out["derived"] = derived
        return out

    n_records = -(-cfg.max_steps // stride)

    rec0 = record(carry0)
    rec0["valid"] = jnp.ones_like(lane_active(carry0))
    # Preallocated [T, ...] record buffers, written in place by
    # dynamic_update_slice inside a while_loop that EXITS as soon as every
    # lane has terminated — the round-3 recorder was a fixed-length scan
    # that always executed all max_steps masked sub-steps, which made
    # tiered-dt recording pay for the steps the tiering saved. Frames
    # after the exit are
    # backfilled with the frozen terminal record below — bit-identical to
    # what the full-length scan recorded (masked steps are no-ops, so
    # every post-termination frame repeats the frozen state).
    bufs = jax.tree.map(
        lambda x: jnp.zeros((n_records + 1,) + x.shape, x.dtype)
        .at[0].set(x),
        rec0,
    )

    def write(bufs, i, rec):
        return jax.tree.map(
            lambda b, r: jax.lax.dynamic_update_slice(
                b, r[None].astype(b.dtype),
                (i,) + (0,) * (b.ndim - 1),
            ),
            bufs, rec,
        )

    def cond(state):
        c, i, _ = state
        return (i <= n_records) & jnp.any(lane_active(c))

    def body(state):
        c, i, bufs = state
        ran = lane_active(c)  # True iff the first sub-step advances
        c = main_body(c)
        if stride > 1:
            c = jax.lax.fori_loop(
                0, stride - 1, lambda _, cc: main_body(cc), c
            )
        rec = record(c)
        rec["valid"] = ran
        return c, i + 1, write(bufs, i, rec)

    carry, i_stop, bufs = jax.lax.while_loop(cond, body, (carry0, 1, bufs))

    # backfill frames [i_stop, n_records]: the frozen terminal record
    rec_fin = record(carry)
    rec_fin["valid"] = lane_active(carry)  # all False at exit
    tail = jnp.arange(n_records + 1) >= i_stop
    full = jax.tree.map(
        lambda b, r: jnp.where(
            tail.reshape((n_records + 1,) + (1,) * (b.ndim - 1)),
            r[None].astype(b.dtype), b,
        ),
        bufs, rec_fin,
    )
    st, ev = carry
    return aux["summarize"](st, ev), full


def flight_components_envelope(scene, cfg, wind_fn, ics, channels, n_bins,
                               n_buckets, bin_dt, lo, width, hist_every=1):
    """Whole-flight per-time-bin envelope aggregates WITHOUT materializing
    trajectory frames (round 5; replaces the record-then-bin pipeline over
    `simulator.py:462-584` for envelope chunks).

    The [T, B] frame buffers are what cap envelope chunks (device memory
    runs out at a few thousand lanes) while the summary-only physics
    scales to far wider batches.
    Here the recording cadence of ``flight_components_trajectory`` is kept
    — same masked steps, same ``record_stride``, same initial frame, same
    ``ran`` validity — but each record step folds its [B] channel values
    straight into per-time-bin accumulators carried through the while
    loop:

      * count/mean/M2 via a per-step batched Welford merge (one-hot
        contractions at HIGHEST precision; numerically the Chan update ``mc.envelope``'s host
        merge uses, applied per record step instead of per chunk),
      * min/max via K-blocked one-hot reduces (a whole-K selector gets
        materialized by XLA — the r4 OOM lesson, NOTES.md),
      * fixed-edge histograms via the two-sided bf16 one-hot contraction
        (f32 accumulation, counts exact) — edges must be pre-calibrated
        (``mc.envelope.EnvelopeAccumulator`` calibrates on a first
        frame-based chunk). ``hist_every``: fold the histogram only every
        Nth record step (the in-loop twin of
        ``EnvelopeConfig.hist_frame_stride``; the skipped steps still
        trace the contraction but multiply it by zero).

    Returns ``(summary_dict, agg)`` with ``agg`` a dict of
    ``n/mean/m2/min/max [C, n_bins]``, ``hist [C, n_bins, n_buckets]``
    (f32), ``clipped [C]`` — the exact per-chunk quantities
    ``EnvelopeAccumulator.add_aggregates`` merges. ``channels`` are
    ``derived_c`` output names (must include any the caller bins);
    ``n_bins``/``n_buckets``/``channels``/``hist_every`` are static.
    """
    carry0, aux = _flight_setup(scene, cfg, wind_fn, ics)
    lane_active = aux["lane_active"]
    main_body = aux["main_body"]
    t_of = aux["t_of"]
    rail_time = aux["rail_time"]
    stride = max(1, cfg.record_stride)
    hist_every = max(1, int(hist_every))
    n_ch = len(channels)
    k_ax = jnp.arange(n_bins)
    dtype = carry0[0][0].dtype
    lo_a = jnp.asarray(lo, dtype)
    width_a = jnp.asarray(width, dtype)
    big = jnp.asarray(jnp.inf, dtype)

    acc0 = {
        "n": jnp.zeros((n_ch, n_bins), dtype),
        "mean": jnp.zeros((n_ch, n_bins), dtype),
        "m2": jnp.zeros((n_ch, n_bins), dtype),
        "min": jnp.full((n_ch, n_bins), jnp.inf, dtype),
        "max": jnp.full((n_ch, n_bins), -jnp.inf, dtype),
        "hist": jnp.zeros((n_ch, n_bins, n_buckets), jnp.float32),
        "clipped": jnp.zeros((n_ch,), jnp.float32),
    }

    def accumulate(acc, c, ran, hist_w):
        st, ev = c
        t_off = t_of(ev) - rail_time
        d = derived_c(scene, cfg, wind_fn, t_off, st)
        vals = jnp.stack([d[ch] for ch in channels])  # [C, B]
        ids = jnp.clip(jnp.floor(t_off / bin_dt).astype(jnp.int32),
                       0, n_bins - 1)
        ohf = ((ids[:, None] == k_ax) & ran[:, None]).astype(dtype)  # [B,K]
        m = jnp.isfinite(vals)
        mv = m.astype(dtype)
        v0 = jnp.where(m, vals, 0.0)
        n_b = jnp.einsum("cb,bk->ck", mv, ohf,
                         precision=jax.lax.Precision.HIGHEST)
        s_b = jnp.einsum("cb,bk->ck", v0, ohf,
                         precision=jax.lax.Precision.HIGHEST)
        mean_b = s_b / jnp.maximum(n_b, 1.0)
        mb_lane = jnp.einsum("ck,bk->cb", mean_b, ohf,
                             precision=jax.lax.Precision.HIGHEST)
        dcen = (v0 - mb_lane) * mv
        m2_b = jnp.einsum("cb,bk->ck", dcen * dcen, ohf,
                          precision=jax.lax.Precision.HIGHEST)
        tot = acc["n"] + n_b
        safe = jnp.maximum(tot, 1.0)
        delta = mean_b - acc["mean"]

        # min/max: K-blocked, own selector per reduction (see docstring)
        block = 64
        n_blocks = -(-n_bins // block)
        starts = jnp.arange(n_blocks) * block

        def block_min(k0):
            sel = (ids[:, None] == (k0 + jnp.arange(block))) \
                & ran[:, None]                                 # [B, block]
            return jnp.min(
                jnp.where(sel[None] & m[:, :, None], vals[:, :, None], big),
                axis=1,
            )                                                  # [C, block]

        def block_max(k0):
            sel = (ids[:, None] == (k0 + jnp.arange(block))) \
                & ran[:, None]
            return jnp.max(
                jnp.where(sel[None] & m[:, :, None], vals[:, :, None], -big),
                axis=1,
            )

        vmin_b = jnp.moveaxis(jax.lax.map(block_min, starts), 0, 1)
        vmax_b = jnp.moveaxis(jax.lax.map(block_max, starts), 0, 1)
        vmin_b = vmin_b.reshape(n_ch, -1)[:, :n_bins]
        vmax_b = vmax_b.reshape(n_ch, -1)[:, :n_bins]

        # fixed-edge histogram, masked identically to the frame-path
        # kernel (_bin_histogram_mc): bin indicator carries ran, bucket
        # indicator carries finiteness
        lo_lane = jnp.einsum("ck,bk->cb", lo_a, ohf,
                             precision=jax.lax.Precision.HIGHEST)
        w_lane = jnp.einsum("ck,bk->cb", width_a, ohf,
                            precision=jax.lax.Precision.HIGHEST)
        frac = (v0 - lo_lane) / jnp.maximum(w_lane, 1e-30)
        bucket = jnp.clip(frac.astype(jnp.int32), 0, n_buckets - 1)
        contribs = []
        for ci in range(n_ch):
            ohu = ((bucket[ci][:, None] == jnp.arange(n_buckets))
                   & m[ci][:, None]).astype(jnp.bfloat16)       # [B, U]
            contribs.append(jnp.einsum(
                "bk,bu->ku", ohf.astype(jnp.bfloat16), ohu,
                preferred_element_type=jnp.float32,
            ))
        clipped = jnp.where(m & ((frac < 0.0) | (frac >= n_buckets)),
                            1.0, 0.0)
        clip_add = jnp.einsum("cb,bk->ck", clipped, ohf,
                              precision=jax.lax.Precision.HIGHEST).sum(axis=1)
        hw = hist_w.astype(jnp.float32)

        return {
            "n": tot,
            "mean": acc["mean"] + delta * n_b / safe,
            "m2": acc["m2"] + m2_b + delta * delta * acc["n"] * n_b / safe,
            "min": jnp.minimum(acc["min"], vmin_b),
            "max": jnp.maximum(acc["max"], vmax_b),
            "hist": acc["hist"] + hw * jnp.stack(contribs),
            "clipped": acc["clipped"] + hw * clip_add.astype(jnp.float32),
        }

    n_records = -(-cfg.max_steps // stride)
    ones = jnp.ones_like(lane_active(carry0))
    acc0 = accumulate(acc0, carry0, ones,
                      jnp.asarray(1.0, jnp.float32))  # the initial frame

    def cond(state):
        c, i, _ = state
        return (i <= n_records) & jnp.any(lane_active(c))

    def body(state):
        c, i, acc = state
        ran = lane_active(c)
        c = main_body(c)
        if stride > 1:
            c = jax.lax.fori_loop(
                0, stride - 1, lambda _, cc: main_body(cc), c
            )
        hist_w = ((i % hist_every) == 0).astype(jnp.float32)
        acc = accumulate(acc, c, ran, hist_w)
        return c, i + 1, acc

    carry, _, acc = jax.lax.while_loop(cond, body, (carry0, 1, acc0))
    st, ev = carry
    return aux["summarize"](st, ev), acc
