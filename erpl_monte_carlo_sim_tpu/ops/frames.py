"""Aerodynamic angles, frame transforms, and flow quantities (vmap-safe).

Functional parity with `/root/reference/rocket_simulation/utils.py:147-205`,
written as branch-free jnp so they fuse into the jitted dynamics step.
"""

from __future__ import annotations

import jax.numpy as jnp

from .math import safe_norm

GAMMA_AIR = 1.4
R_AIR = 287.053  # J/(kg K)

__all__ = [
    "mach_number",
    "angle_of_attack",
    "sideslip_angle",
    "wind_to_body_matrix",
    "GAMMA_AIR",
    "R_AIR",
]


def mach_number(velocity: jnp.ndarray, temperature) -> jnp.ndarray:
    """Mach number from a velocity vector and static temperature.

    Parity: `utils.py:152-157` (gamma=1.4, R=287.053).
    ``velocity`` has shape ``(..., 3)``.
    """
    speed_of_sound = jnp.sqrt(GAMMA_AIR * R_AIR * temperature)
    return safe_norm(velocity) / speed_of_sound


def angle_of_attack(velocity_body: jnp.ndarray) -> jnp.ndarray:
    """Signed angle of attack atan2(w, u); 0 when both u,w are ~0.

    Parity: `utils.py:160-164` — returns 0 only when |u|<1e-6 AND |w|<1e-6
    (note atan2(0, -eps) = pi, so the guard matters).
    """
    u = velocity_body[..., 0]
    w = velocity_body[..., 2]
    degenerate = (jnp.abs(u) < 1e-6) & (jnp.abs(w) < 1e-6)
    # Sanitize the guarded branch's inputs: atan2's vjp at (0, 0) is NaN
    # and 0-cotangent * NaN poisons reverse-mode (engine/diff.py). Primal
    # unchanged: the degenerate output is the same literal 0.
    u_s = jnp.where(degenerate, 1.0, u)
    w_s = jnp.where(degenerate, 0.0, w)
    return jnp.where(degenerate, 0.0, jnp.arctan2(w_s, u_s))


def sideslip_angle(velocity_body: jnp.ndarray) -> jnp.ndarray:
    """Signed sideslip atan2(v, sqrt(u^2+w^2)); 0 when the xz speed is ~0.

    Parity: `utils.py:167-172`.
    """
    u = velocity_body[..., 0]
    v = velocity_body[..., 1]
    w = velocity_body[..., 2]
    sq = u * u + w * w
    degenerate = sq < 1e-12  # == (sqrt(sq) < 1e-6), sqrt monotonic
    # Grad-safe double-where (see angle_of_attack): sqrt never sees 0 and
    # atan2 never sees (0, 0); primal values are unchanged.
    v_xz = jnp.sqrt(jnp.where(degenerate, 1.0, sq))
    v_s = jnp.where(degenerate, 0.0, v)
    return jnp.where(degenerate, 0.0, jnp.arctan2(v_s, v_xz))


def wind_to_body_matrix(alpha, beta) -> jnp.ndarray:
    """Rotation matrix from wind axes (x along relative wind) to body axes.

    Parity: `utils.py:175-205`. Positive alpha = nose-up, positive beta =
    nose-right. Returns shape ``(..., 3, 3)``.
    """
    alpha = jnp.asarray(alpha)
    ca, sa = jnp.cos(alpha), jnp.sin(alpha)
    cb, sb = jnp.cos(beta), jnp.sin(beta)
    zero = jnp.zeros_like(ca * cb)
    row0 = jnp.stack([ca * cb, -sb * jnp.ones_like(ca), sa * cb], axis=-1)
    row1 = jnp.stack([ca * sb, cb * jnp.ones_like(ca), sa * sb], axis=-1)
    row2 = jnp.stack([-sa * jnp.ones_like(cb), zero, ca * jnp.ones_like(cb)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)
