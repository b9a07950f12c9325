"""Table lookup / interpolation primitives.

The reference uses ``np.interp`` everywhere (`utils.py:147-149`), which
CLAMPS at table endpoints. The wrappers here pin that semantic contract
and give the hot path a single choke point for how a table is queried.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["interpolate_1d", "interpolate_vec"]


def _knot(x_table, i):
    """Static endpoint read: ``lax.slice_in_dim`` with literal bounds is a
    static ``slice`` (plain ``x_table[0]`` traces to a ``dynamic_slice``)."""
    import jax

    n = x_table.shape[-1]
    i = i % n
    return jnp.squeeze(jax.lax.slice_in_dim(x_table, i, i + 1, axis=-1), axis=-1)


def interpolate_1d(x, x_table: jnp.ndarray, y_table: jnp.ndarray) -> jnp.ndarray:
    """Piecewise-linear interpolation, clamped at the table endpoints.

    Parity: `utils.py:147-149` (``np.interp``). ``x_table`` must be strictly
    increasing. ``x`` may be any shape; tables are 1-D.

    Implemented with the same gather-free tent-basis form as
    ``interpolate_vec`` (clamped linear interp == hat-weighted sum of table
    values) rather than ``jnp.interp``: the query is elementwise arithmetic
    and a reduction that fuse into the surrounding loop body, with no
    searchsorted or gather.

    LAYOUT: the knot axis K leads — intermediates are [K, ...x-shape], NOT
    [..., K], so the batch stays the minor (contiguous) axis and the tiny
    K is the reduced one. Per-element math is identical (elementwise ops
    commute with layout).
    """
    x = jnp.asarray(x)
    xc = jnp.clip(x, _knot(x_table, 0), _knot(x_table, -1))
    dx = jnp.maximum(jnp.diff(x_table), 1e-30)
    left = jnp.concatenate([jnp.ones_like(dx[:1]), dx])
    right = jnp.concatenate([dx, jnp.ones_like(dx[:1])])
    kshape = x_table.shape + (1,) * x.ndim  # [K, 1...1] broadcasts vs [K, ...]
    lo = (x_table - left).reshape(kshape)
    hi = (x_table + right).reshape(kshape)
    up = (xc[None, ...] - lo) / left.reshape(kshape)
    down = (hi - xc[None, ...]) / right.reshape(kshape)
    w = jnp.clip(jnp.minimum(up, down), 0.0, 1.0)  # [K, ...]
    return jnp.sum(w * y_table.reshape(kshape), axis=0)


def interpolate_vec(x, x_table: jnp.ndarray, y_table: jnp.ndarray) -> jnp.ndarray:
    """Interpolate a vector-valued table ``y_table[N, C]`` at scalar ``x``.

    GATHER-FREE tent-basis formulation: clamped piecewise-linear
    interpolation is exactly a weighted sum of the table rows with "tent"
    (hat) weights, so the whole query is a broadcast multiply + reduction
    that fuses into the surrounding loop body. The Monte Carlo batch
    carries a PER-LANE wind table ([B, N, 3] under vmap); this form reads
    it with no per-lane gather. (Whether a 2-knot gather is cheaper on the
    GPU is an open measurement.)

    Semantics match ``np.interp`` per component (`environment.py:267-276`):
    clamped at both endpoints, ``x_table`` strictly increasing.
    Returns shape ``[C]`` (vmap adds batch dims).
    """
    x = jnp.asarray(x)
    # Clamp into the table range: tent weights then reproduce endpoint
    # clamping exactly (at x = x_table[0] the first tent is 1, etc.).
    xc = jnp.clip(x, _knot(x_table, 0), _knot(x_table, -1))
    # Tent weight for node n: rises over [x_{n-1}, x_n], falls over
    # [x_n, x_{n+1}]; half-infinite plateaus at the two ends.
    dx = jnp.maximum(jnp.diff(x_table), 1e-30)  # guard duplicate knots
    left = jnp.concatenate([jnp.ones_like(dx[:1]), dx])   # width below node n
    right = jnp.concatenate([dx, jnp.ones_like(dx[:1])])  # width above node n
    up = (xc[..., None] - (x_table - left)) / left         # 1 at node, 0 below
    down = ((x_table + right) - xc[..., None]) / right     # 1 at node, 0 above
    w = jnp.clip(jnp.minimum(up, down), 0.0, 1.0)
    # Per-component sums: a single w[..., :, None] * y_table product would
    # materialize a [..., N, C] temporary for no benefit.
    comps = [
        jnp.sum(w * y_table[..., :, c], axis=-1)
        for c in range(y_table.shape[-1])
    ]
    return jnp.stack(comps, axis=-1)
