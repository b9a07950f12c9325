"""Gradient-safe and broadcasting elementwise helpers for the flight core."""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["bcast_where", "safe_norm", "safe_sqrt"]


def safe_norm(v, axis=-1, keepdims=False):
    """L2 norm with a NaN-free gradient at exactly zero.

    ``jnp.linalg.norm``'s vjp at 0 is 0 * inf even when the primal is
    guarded downstream (the sqrt rule computes cotangent * 0.5/sqrt(0)).
    Double-where keeps the primal bit-identical (sqrt of the same sum of
    squares) while the zero-point subgradient becomes 0 — which makes
    reverse-mode through the flight finite at the zero-velocity rail start
    (engine/diff.py differentiates the SAME stacked-path physics)."""
    sq = jnp.sum(v * v, axis=axis, keepdims=keepdims)
    ok = sq > 0.0
    return jnp.where(ok, jnp.sqrt(jnp.where(ok, sq, 1.0)), 0.0)


def safe_sqrt(x):
    """sqrt with a NaN-free gradient at exactly zero; NaN still propagates.

    The component-form twin of ``safe_norm`` for already-summed squares:
    primal matches ``jnp.sqrt`` for every x >= 0 AND for NaN, but the
    zero-point subgradient is 0 instead of inf — reverse-mode through the
    zero-relative-velocity rail start (``engine.diff`` drives the component
    core) stays finite on the additive wind/attitude channels.

    The guard must be ``~(x <= 0)``, not ``x > 0``: both route x == 0 to
    the constant-0 branch (the gradient fix), but the former sends NaN
    through ``jnp.sqrt`` so a diverged lane's NaN speed/range stays NaN.
    ``x > 0`` would launder NaN into 0.0, silently defeating the
    ``isfinite(speed)`` divergence checks and — in strict-parity mode
    (``terminate_nonfinite=False``) — letting NaN lanes through the
    outlier filter with a frozen apogee and range=0 (found by review,
    round 3)."""
    ok = ~(x <= 0.0)
    return jnp.where(ok, jnp.sqrt(jnp.where(ok, x, 1.0)), 0.0)


def bcast_where(mask, a, b):
    """``jnp.where`` with a lane mask broadcast over trailing dims.

    ``mask`` is [B] (or any leading shape of ``a``); it is expanded over
    ``a``'s trailing dims. Boolean operands are selected with logic ops.
    The result equals ``jnp.where(mask[..., None, ...], a, b)``.
    """
    a = jnp.asarray(a)
    extra = a.ndim - jnp.ndim(mask)
    if extra > 0:
        mask = (
            jnp.reshape(
                mask.astype(jnp.int32), jnp.shape(mask) + (1,) * extra
            )
            != 0
        )
    if a.dtype == jnp.bool_:
        return (mask & a) | (~mask & jnp.asarray(b))
    return jnp.where(mask, a, b)
