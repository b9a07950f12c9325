"""Quaternion algebra and attitude kinematics (pure jnp, vmap-safe).

Functional parity with the reference math kernel
(`/root/reference/rocket_simulation/utils.py:8-144`), re-designed as pure,
branch-free JAX functions over `[w, x, y, z]` quaternions so they batch
cleanly under `vmap` and trace once under `jit`.

Conventions (pinned — see SURVEY.md §2 "Attitude/frame conventions"):
  * quaternion storage order is ``[w, x, y, z]``
  * Euler order is intrinsic "xyz" (roll, pitch, yaw)
  * body +x is the longitudinal/thrust axis; a vertical launch is
    pitch ≈ -pi/2 in the ENU-ish inertial frame (z up).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "normalize_quaternion",
    "quaternion_multiply",
    "quaternion_to_rotation_matrix",
    "angular_velocity_to_quaternion_rate",
    "euler_to_quaternion",
    "quaternion_to_euler",
    "rotate_by_matrix",
    "rotate_by_matrix_t",
]


def normalize_quaternion(q: jnp.ndarray) -> jnp.ndarray:
    """Normalize quaternion(s) to unit length; degenerate -> identity.

    Parity: `utils.py:76-82` (identity fallback below norm 1e-12).
    `q` has shape ``(..., 4)``.
    """
    norm = jnp.linalg.norm(q, axis=-1, keepdims=True)
    # identity built by concat: elementwise, no scatter
    identity = jnp.concatenate(
        [jnp.ones_like(q[..., :1]), jnp.zeros_like(q[..., 1:])], axis=-1
    )
    safe = jnp.where(norm > 1e-12, norm, 1.0)
    return jnp.where(norm > 1e-12, q / safe, identity)


def quaternion_multiply(q1: jnp.ndarray, q2: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product of ``[w,x,y,z]`` quaternions (`utils.py:85-97`)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quaternion_to_rotation_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Body->inertial DCM from a ``[w,x,y,z]`` quaternion.

    Normalizes first, exactly like the reference (`utils.py:100-111`).
    Returns shape ``(..., 3, 3)``.
    """
    q = normalize_quaternion(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    row0 = jnp.stack([r00, r01, r02], axis=-1)
    row1 = jnp.stack([r10, r11, r12], axis=-1)
    row2 = jnp.stack([r20, r21, r22], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def rotate_by_matrix(R: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """``R @ v`` for batched 3x3 matrices and 3-vectors.

    Written as explicit sum-of-products: a [B,3,3]x[B,3] einsum would lower
    to a batched matmul of degenerate 3x3 tiles; this form is 9 fused
    elementwise multiply-adds.
    """
    return jnp.stack(
        [
            R[..., 0, 0] * v[..., 0] + R[..., 0, 1] * v[..., 1] + R[..., 0, 2] * v[..., 2],
            R[..., 1, 0] * v[..., 0] + R[..., 1, 1] * v[..., 1] + R[..., 1, 2] * v[..., 2],
            R[..., 2, 0] * v[..., 0] + R[..., 2, 1] * v[..., 1] + R[..., 2, 2] * v[..., 2],
        ],
        axis=-1,
    )


def rotate_by_matrix_t(R: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """``R.T @ v`` for batched 3x3 matrices and 3-vectors (elementwise form)."""
    return jnp.stack(
        [
            R[..., 0, 0] * v[..., 0] + R[..., 1, 0] * v[..., 1] + R[..., 2, 0] * v[..., 2],
            R[..., 0, 1] * v[..., 0] + R[..., 1, 1] * v[..., 1] + R[..., 2, 1] * v[..., 2],
            R[..., 0, 2] * v[..., 0] + R[..., 1, 2] * v[..., 1] + R[..., 2, 2] * v[..., 2],
        ],
        axis=-1,
    )


def angular_velocity_to_quaternion_rate(
    omega: jnp.ndarray, q: jnp.ndarray
) -> jnp.ndarray:
    """Quaternion kinematics with Baumgarte norm correction (gain 0.5).

    q_dot = 0.5 * q (x) [0, omega]  -  0.5 * (q.q - 1) * q
    Parity: `utils.py:114-121`.
    """
    zero = jnp.zeros_like(omega[..., :1])
    omega_q = jnp.concatenate([zero, omega], axis=-1)
    q_dot = 0.5 * quaternion_multiply(q, omega_q)
    norm_error = jnp.sum(q * q, axis=-1, keepdims=True) - 1.0
    return q_dot - 0.5 * norm_error * q


def euler_to_quaternion(roll, pitch, yaw) -> jnp.ndarray:
    """Intrinsic-xyz Euler angles -> ``[w,x,y,z]`` quaternion.

    Parity: `utils.py:14-35,129-136` (the reference builds ``[x,y,z,w]`` then
    shuffles; we emit ``[w,x,y,z]`` directly with the same trig products).
    """
    roll = jnp.asarray(roll)
    cr, sr = jnp.cos(roll / 2), jnp.sin(roll / 2)
    cp, sp = jnp.cos(pitch / 2), jnp.sin(pitch / 2)
    cy, sy = jnp.cos(yaw / 2), jnp.sin(yaw / 2)
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return jnp.stack([w, x, y, z], axis=-1)


def quaternion_to_euler(q: jnp.ndarray) -> jnp.ndarray:
    """``[w,x,y,z]`` quaternion -> intrinsic-xyz Euler ``[roll,pitch,yaw]``.

    Parity: `utils.py:46-70,139-144` including the +/-90 deg pitch clamp.
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2 * (w * x + y * z)
    cosr_cosp = 1 - 2 * (x * x + y * y)
    roll = jnp.arctan2(sinr_cosp, cosr_cosp)

    sinp = 2 * (w * y - z * x)
    pitch = jnp.where(
        jnp.abs(sinp) >= 1,
        jnp.sign(sinp) * (jnp.pi / 2),
        jnp.arcsin(jnp.clip(sinp, -1.0, 1.0)),
    )

    siny_cosp = 2 * (w * z + x * y)
    cosy_cosp = 1 - 2 * (y * y + z * z)
    yaw = jnp.arctan2(siny_cosp, cosy_cosp)
    return jnp.stack([roll, pitch, yaw], axis=-1)
