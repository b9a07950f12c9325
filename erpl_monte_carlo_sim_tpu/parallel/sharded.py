"""Sharded Monte Carlo execution and collective statistics.

Two layers, both demonstrated here and validated on a virtual 8-device CPU
mesh in tests:

  * ``run_sharded_summaries`` — the high-level path: jit the vmapped flight
    over lanes whose leading axis carries a ``NamedSharding``; the program is
    embarrassingly parallel so XLA partitions it with zero communication
    until the stats reduction.
  * ``collective_stats`` — an explicit ``shard_map`` reduction: per-shard
    masked partial sums combined with ``psum`` over the batch axis (mean,
    std, count, min/max) and a small ``all_gather`` for exact percentiles.
    This is the on-device replacement for the reference's in-driver Python
    statistics loops (`monte_carlo.py:400-473`) at pod scale, where hauling
    every lane's metrics to the host would ride DCN.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.batch import simulate_summary_batch
from ..engine.config import SimConfig
from ..mc.stats import PERCENTILES, order_stat_ranks
from .mesh import BATCH_AXIS, shard_batch

__all__ = ["run_sharded_summaries", "collective_stats",
           "collective_footprint", "collective_footprint_moments",
           "collective_cv_moments", "collective_tail_extremes",
           "collective_tail_reservoir", "collective_tail_carry",
           "tail_reservoir_from_carry"]


def run_sharded_summaries(scene_b, ic_b, axes, cfg: SimConfig, mesh: Mesh,
                          batch_size: int):
    """Run a dispersed batch with its lane axis sharded over the mesh.

    Inputs must already be shaped [batch_size, ...] on batched leaves (use
    ``mc.sample_dispersions``); this places them (``shard_batch``) and runs
    the component-form batch path (``engine.batch``). XLA's SPMD partitioner
    splits the lanes per device — the [B,N,3] -> [3,N,B] wind transpose and
    every [B] carry stay lane-sharded with zero communication; the only
    per-iteration collective is the 1-bit ``any(lane_active)`` loop
    condition. ``axes`` is unused (kept for API compatibility with the
    vmapped path).
    """
    del axes
    scene_b = shard_batch(scene_b, mesh, batch_size)
    ic_b = shard_batch(ic_b, mesh, batch_size)
    return simulate_summary_batch(scene_b, ic_b, cfg)


def _histogram_values_at_ranks(v, m, ranks, vmin, vmax, n_bins):
    """Collective value-at-rank estimate WITHOUT gathering the data: a
    global fixed-bin histogram (one psum of [n_bins]) locates each target
    rank's bucket, then one refinement histogram per target (one psum of
    [n_targets, n_bins]) restricted to that bucket narrows the value to
    (range / n_bins^2) — ~6 mm on an 80 km apogee span at 4096 bins, far
    below the <0.1%-of-sigma bound the tests pin. ``ranks`` are 0-indexed
    positions in the sorted masked data (np.percentile's linear rule is
    r = q/100 * (cnt-1)); within the final refined bucket the mass is
    treated as uniform.
    """
    dtype = v.dtype
    span = jnp.maximum(vmax - vmin, jnp.asarray(1e-30, dtype))
    w = span / n_bins
    mw = m.astype(dtype)

    def local_hist(lo, width, k):
        # [targets..., n_bins] masked histogram of the SHARD's values
        idx = jnp.clip(((v - lo[..., None]) / width[..., None])
                       .astype(jnp.int32), 0, k - 1)
        in_rng = (v >= lo[..., None]) & (v < lo[..., None] + width[..., None] * k)
        wts = jnp.where(in_rng, mw, 0.0)
        if idx.ndim == 1:
            return jnp.zeros((k,), dtype).at[idx].add(wts)
        flat = idx + (jnp.arange(idx.shape[0], dtype=jnp.int32)[:, None] * k)
        return jnp.zeros((idx.shape[0] * k,), dtype).at[
            flat.reshape(-1)
        ].add(wts.reshape(-1)).reshape(idx.shape[0], k)

    # pass 1: global coarse histogram
    hist = jax.lax.psum(
        local_hist(vmin[None], w[None], n_bins)[0], BATCH_AXIS
    )
    cdf = jnp.cumsum(hist)
    # rank r sits in the first bucket whose cumulative mass EXCEEDS r
    bucket = jnp.searchsorted(cdf, ranks, side="right")
    bucket = jnp.clip(bucket, 0, n_bins - 1)
    below = jnp.where(bucket > 0, cdf[jnp.maximum(bucket - 1, 0)], 0.0)

    # pass 2: refined histogram inside each target's bucket
    lo2 = vmin + bucket.astype(dtype) * w  # [T]
    w2 = w / n_bins
    hist2 = jax.lax.psum(
        local_hist(lo2, jnp.broadcast_to(w2, lo2.shape), n_bins), BATCH_AXIS
    )  # [T, n_bins]
    cdf2 = jnp.cumsum(hist2, axis=1)
    within = ranks - below  # mass below the target inside the bucket
    b2 = jnp.clip(
        jax.vmap(lambda c, r: jnp.searchsorted(c, r, side="right"))(
            cdf2, within
        ),
        0, n_bins - 1,
    )
    below2 = jnp.where(
        b2 > 0,
        jnp.take_along_axis(cdf2, jnp.maximum(b2 - 1, 0)[:, None], 1)[:, 0],
        0.0,
    )
    in_bucket = jnp.take_along_axis(hist2, b2[:, None], 1)[:, 0]
    frac = jnp.where(in_bucket > 0, (within - below2) / in_bucket, 0.5)
    est = lo2 + (b2.astype(dtype) + jnp.clip(frac, 0.0, 1.0)) * w2
    return jnp.clip(est, vmin, vmax)


def collective_stats(values: jnp.ndarray, mask: jnp.ndarray | None,
                     mesh: Mesh,
                     exact_percentile_threshold: int = 2_097_152,
                     percentile_bins: int = 4096) -> dict:
    """Masked mean/std/min/max/count/percentiles with explicit collectives.

    ``values``/``mask`` are [n] arrays sharded (or shardable) along the batch
    axis; ``mask=None`` means all lanes (non-finite values are always
    excluded). Moment accumulators ride ``psum``. Percentiles: for
    n up to ``exact_percentile_threshold``, one ``all_gather`` of the scalar
    metric followed by a replicated sort (EXACT np.percentile semantics);
    beyond it, the two-pass collective histogram
    (``_histogram_values_at_ranks`` — O(n_bins) communication instead of
    O(n) gather + replicated O(n log n) sort, error bounded by
    range/n_bins^2). ``percentile_ci`` [k, 2] rides the same machinery:
    order-statistic CIs on each percentile at the EXACT binomial ranks
    (``mc.stats.order_stat_ranks``, clamped to the sample extremes like
    ``mc.stats.percentile_ci``) — the valid count is read back first (one
    scalar collective), the ranks come from scipy host-side (CI ranks ride
    as int32 so they stay exact past 2^24 lanes), and the ranked-value
    extraction runs collectively. The compiled executable stays
    count-independent because the ranks enter as data, and on the
    exact-sort path (n <= exact_percentile_threshold, >= 2 valid lanes)
    the CI matches ``mc.stats.percentile_ci`` bit-for-bit (pinned by
    test); with fewer than 2 valid lanes percentiles and CIs are NaN,
    mirroring ``percentile_ci``'s guard.

    Multi-host safe: when ``values`` is already a global sharded array (a
    ``jax.distributed`` run), the ``device_put`` is a no-op and the psum
    spans every host; pass ``mask=None`` or a global mask in that case
    (a host-local mask array cannot be placed onto non-addressable devices).
    """
    n = values.shape[0]
    use_hist = n > exact_percentile_threshold
    values = jax.device_put(values, NamedSharding(mesh, P(BATCH_AXIS)))
    if mask is None:
        mask = jnp.ones_like(values, dtype=bool)  # inherits values' sharding
    else:
        mask = jax.device_put(mask, NamedSharding(mesh, P(BATCH_AXIS)))

    # Valid-lane count first (XLA inserts the cross-shard reduction): the
    # EXACT binomial order-statistic ranks need scipy's binom.ppf, which is
    # not traceable — one scalar readback buys bit-parity with
    # mc.stats.percentile_ci at every n.
    n_valid = int(jnp.sum(mask & jnp.isfinite(values)))
    n_eff = max(n_valid, 1)
    qs_np = np.asarray(PERCENTILES, np.float64)
    pct_ranks = qs_np / 100.0 * max(n_valid - 1, 0)
    lo_ranks = np.empty_like(qs_np)
    hi_ranks = np.empty_like(qs_np)
    for i, q in enumerate(qs_np):
        l, u = order_stat_ranks(n_eff, q / 100.0)
        lo_ranks[i] = max(l, 1) - 1
        hi_ranks[i] = min(u, n_eff) - 1
    # The histogram path consumes CONTINUOUS rank positions (compared
    # against cumulative bin masses); float dtype is fine there because the
    # bin-resolution error dominates any f32 rank rounding.
    host_ranks = jnp.asarray(
        np.concatenate([pct_ranks, lo_ranks, hi_ranks]), values.dtype
    )
    # The exact-sort path gathers at INTEGER order statistics: indices ride
    # as int32 (integral ranks round in f32 above n ~ 2^24, which a caller
    # reaches by raising exact_percentile_threshold) and only the
    # in-[0,1) interpolation fraction stays float. ceil is computed host-
    # side in f64, so hi == lo exactly when the rank is integral and never
    # touches the +inf padding beyond the valid prefix.
    host_idx = jnp.asarray(
        np.concatenate([
            np.floor(pct_ranks), np.ceil(pct_ranks), lo_ranks, hi_ranks
        ]).astype(np.int64),
        jnp.int32,
    )
    host_frac = jnp.asarray(pct_ranks - np.floor(pct_ranks), values.dtype)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(BATCH_AXIS), P(), P(), P()),
        out_specs=P(),
        # Outputs are replicated by construction (psum/all_gather), but the
        # sort-percentile path isn't statically inferable as such.
        check_vma=False,
    )
    def _stats(v, m, ranks, idx, frac):
        m = m & jnp.isfinite(v)
        big = jnp.asarray(jnp.inf, v.dtype)
        cnt = jax.lax.psum(jnp.sum(m), BATCH_AXIS)
        s1 = jax.lax.psum(jnp.sum(jnp.where(m, v, 0.0)), BATCH_AXIS)
        vmin = jax.lax.pmin(jnp.min(jnp.where(m, v, big)), BATCH_AXIS)
        vmax = jax.lax.pmax(jnp.max(jnp.where(m, v, -big)), BATCH_AXIS)
        denom = jnp.maximum(cnt, 1).astype(v.dtype)
        mean = s1 / denom
        # Two-pass variance (one extra psum): matches mc.stats.masked_stats'
        # numerically stable form — for flight_time-like data (mean ~1e2,
        # std ~1e-1) the one-pass E[x^2]-mean^2 form loses ~1e-3 absolute to
        # rounding of the large accumulators, a ~percent-level std error
        # at f32.
        d = jnp.where(m, v - mean, 0.0)
        var = jnp.maximum(
            jax.lax.psum(jnp.sum(d * d), BATCH_AXIS) / denom, 0.0
        )

        qs = jnp.asarray(PERCENTILES, v.dtype)
        k = qs.shape[0]
        if use_hist:
            vals = _histogram_values_at_ranks(
                v, m, ranks, vmin, vmax, percentile_bins
            )
        else:
            # Exact values: gather every shard's masked metric, sort, then
            # gather at the host-computed INT32 order statistics (exact at
            # any n — f32 ranks round above 2^24).
            all_v = jax.lax.all_gather(
                jnp.where(m, v, big), BATCH_AXIS, tiled=True
            )
            sorted_v = jnp.sort(all_v)
            picked = sorted_v[idx]  # [pct_lo, pct_hi, ci_lo, ci_hi] x k
            p_lo, p_hi = picked[:k], picked[k:2 * k]
            pct_vals = p_lo + (p_hi - p_lo) * frac
            vals = jnp.concatenate([pct_vals, picked[2 * k:]])
        return {
            "mean": mean,
            "std": jnp.sqrt(var),
            "min": vmin,
            "max": vmax,
            "percentiles": vals[:k],
            "percentile_ci": jnp.stack(
                [vals[k:2 * k], vals[2 * k:]], axis=1
            ),
            "n": cnt,
        }

    out = _stats(values, mask, host_ranks, host_idx, host_frac)
    if n_valid < 2:
        # Mirror mc.stats.percentile_ci's guard: below 2 valid lanes order
        # statistics are meaningless (and at n_valid == 0 the +inf mask
        # fill would leak into "percentiles"). NaN, not clamped extremes.
        nan = jnp.full_like(out["percentiles"], jnp.nan)
        out = dict(out)
        out["percentiles"] = nan
        out["percentile_ci"] = jnp.stack([nan, nan], axis=1)
    return out


def collective_footprint_moments(landing: jnp.ndarray,
                                 mask: jnp.ndarray | None,
                                 mesh: Mesh) -> tuple:
    """Centered landing moments with explicit collectives: returns the
    ``(n, mean_x, mean_y, M2x, M2y, Cxy)`` floats that feed
    ``mc.stats.FootprintAccumulator.add`` — the multi-slab entry point
    (merge every slab, build ellipses/CEP ONCE at the end).

    ``landing`` is [n, 2+] (x, y leading) sharded (or shardable) along the
    batch axis. Two-pass centered moments ride ``psum`` (the one-pass
    raw-moment form cancels catastrophically in f32 — same reasoning as
    ``collective_stats``' variance); only six replicated scalars come
    back, no per-lane gather.
    """
    xy = landing[:, :2]
    xy = jax.device_put(xy, NamedSharding(mesh, P(BATCH_AXIS)))
    if mask is None:
        mask = jnp.ones(xy.shape[:1], dtype=bool)
    mask = jax.device_put(mask, NamedSharding(mesh, P(BATCH_AXIS)))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
        out_specs=P(),
    )
    def _moments(p, m):
        x, y = p[:, 0], p[:, 1]
        m = m & jnp.isfinite(x) & jnp.isfinite(y)
        cnt = jax.lax.psum(jnp.sum(m), BATCH_AXIS)
        denom = jnp.maximum(cnt, 1).astype(x.dtype)
        mx = jax.lax.psum(jnp.sum(jnp.where(m, x, 0.0)), BATCH_AXIS) / denom
        my = jax.lax.psum(jnp.sum(jnp.where(m, y, 0.0)), BATCH_AXIS) / denom
        dx = jnp.where(m, x - mx, 0.0)
        dy = jnp.where(m, y - my, 0.0)
        return {
            "n": cnt, "mx": mx, "my": my,
            "m2x": jax.lax.psum(jnp.sum(dx * dx), BATCH_AXIS),
            "m2y": jax.lax.psum(jnp.sum(dy * dy), BATCH_AXIS),
            "cxy": jax.lax.psum(jnp.sum(dx * dy), BATCH_AXIS),
        }

    mo = jax.tree.map(lambda v: float(jnp.asarray(v)), _moments(xy, mask))
    return (mo["n"], mo["mx"], mo["my"], mo["m2x"], mo["m2y"], mo["cxy"])


def collective_footprint(landing: jnp.ndarray, mask: jnp.ndarray | None,
                         mesh: Mesh) -> dict:
    """Landing-dispersion footprint with explicit collectives — the
    pod-scale twin of the analyzer's ``landing_footprint`` block
    (``cep_method="gaussian"``: per-lane miss distances are never
    gathered). Single-batch convenience over
    ``collective_footprint_moments``; slab loops should accumulate the
    moments instead and build the block once."""
    from ..mc.stats import FootprintAccumulator

    acc = FootprintAccumulator()
    acc.add(*collective_footprint_moments(landing, mask, mesh))
    return acc.footprint()


def collective_cv_moments(sample, summary, valid, mask, params, motor,
                          mesh: Mesh, wind_ctrl=None) -> tuple:
    """Control-variate moments with explicit collectives — the pod-scale
    twin of ``mc.cv.cv_slab_moments``. Returns the same
    ``(n, mean_z, mean_t, Szz, Szt, Stt)`` tuple for
    ``mc.cv.CVMoments.add``; merge across slabs/hosts and call
    ``mc.cv.finalize_cv`` once at the end.

    The control matrix is built per shard (elementwise in the lane axis, no
    communication); means ride one ``psum`` each and the centered
    second-moment matrices one ``psum`` of a [d, d]-per-shard matmul —
    O(d^2) bytes between devices per slab regardless of lane count, never a
    per-lane gather. Two-pass centering for the same f32 reasons as
    ``collective_stats``' variance.
    """
    mo = _collective_cv_moments_device(sample, summary, valid, mask, params,
                                       motor, mesh, wind_ctrl)
    return tuple(np.asarray(mo[k]) for k in
                 ("n", "mz", "mt", "szz", "szt", "stt"))


def _collective_cv_moments_device(sample, summary, valid, mask, params,
                                  motor, mesh: Mesh, wind_ctrl=None) -> dict:
    """``collective_cv_moments`` up to the readback: a dict of device
    arrays (traceable, so its contractions can be inspected)."""
    from ..mc.cv import _controls, _targets

    shard = NamedSharding(mesh, P(BATCH_AXIS))
    put = lambda t: jax.tree.map(lambda x: jax.device_put(x, shard), t)
    sample, summary, valid = put(sample), put(summary), put(valid)
    if mask is None:
        mask = jnp.ones(valid.shape, dtype=bool)
    mask = jax.device_put(mask, shard)
    # wind_ctrl: per-lane leaves shard, the projector/grid/model replicate
    wc_spec = P()  # empty pytree when wind_ctrl is None
    if wind_ctrl is not None:
        lane_keys = ("wind", "ws", "wd")
        wind_ctrl = {
            k: (put(v) if k in lane_keys else v)
            for k, v in wind_ctrl.items()
        }
        wc_spec = {k: (P(BATCH_AXIS) if k in lane_keys else P())
                   for k in wind_ctrl}

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(BATCH_AXIS), P(BATCH_AXIS), P(BATCH_AXIS),
                  wc_spec),
        out_specs=P(),
    )
    def _moments(sample_s, summary_s, valid_s, inc_s, wc_s):
        z = _controls(sample_s, params, motor, wc_s)
        t = _targets(summary_s, valid_s, z.dtype)
        inc = inc_s.astype(z.dtype)[:, None]
        z = z * inc
        t = t * inc
        n = jax.lax.psum(jnp.sum(inc_s), BATCH_AXIS)
        nf = jnp.maximum(n, 1).astype(z.dtype)
        mz = jax.lax.psum(jnp.sum(z, axis=0), BATCH_AXIS) / nf
        mt = jax.lax.psum(jnp.sum(t, axis=0), BATCH_AXIS) / nf
        zc = (z - mz) * inc
        tc = (t - mt) * inc
        hi = jax.lax.Precision.HIGHEST
        return {
            "n": n, "mz": mz, "mt": mt,
            "szz": jax.lax.psum(jnp.matmul(zc.T, zc, precision=hi),
                                BATCH_AXIS),
            "szt": jax.lax.psum(jnp.matmul(zc.T, tc, precision=hi),
                                BATCH_AXIS),
            "stt": jax.lax.psum(jnp.matmul(tc.T, tc, precision=hi),
                                BATCH_AXIS),
        }

    return _moments(sample, summary, valid, mask, wind_ctrl)


def collective_tail_extremes(values: jnp.ndarray, mask: jnp.ndarray | None,
                             mesh: Mesh, k: int = 4096) -> tuple:
    """(n_valid, hi_candidates, lo_candidates) with explicit collectives —
    the pod-scale reduction behind ``collective_tail_reservoir``.

    Each shard reduces its lanes to its top-k'/bottom-k'
    (k' = min(k, shard size)) via ``lax.top_k``; one ``all_gather`` per
    side moves [devices * k'] scalars instead of every lane.
    The gathered candidates are SUPERSETS of the global top-k/bottom-k:
    any lane in the global top-k lies in its own shard's top-k' (either
    the shard holds >= k lanes and k' = k, or k' covers the whole shard).
    Masked / non-finite lanes pad with -inf (hi side) / +inf (lo side);
    callers drop non-finite entries.
    """
    n = values.shape[0]
    ndev = mesh.devices.size
    if n == 0 or n % ndev:
        # device_put would also refuse an uneven batch, but with a shape
        # error three layers down; and n < ndev would silently yield
        # k_eff = 0 (empty candidate arrays labeled n valid lanes)
        raise ValueError(
            f"batch of {n} lanes cannot shard over {ndev} devices; "
            "pad to a multiple of the device count"
        )
    values, mask, k_eff = _tail_args(values, mask, mesh, n, ndev, k)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
        out_specs=(P(), P(), P()),
        check_vma=False,  # all_gather outputs are replicated by construction
    )
    def _extremes(v, m):
        return _shard_extremes(v, m, k_eff)

    return _extremes(values, mask)


def _tail_args(values, mask, mesh, n, ndev, k):
    """Shared sharding/validation front end of the tail reductions."""
    values = jax.device_put(values, NamedSharding(mesh, P(BATCH_AXIS)))
    if mask is None:
        mask = jnp.ones_like(values, dtype=bool)
    else:
        mask = jax.device_put(mask, NamedSharding(mesh, P(BATCH_AXIS)))
    return values, mask, min(int(k), n // ndev)


def _shard_extremes(v, m, k_eff):
    """Per-shard body: (global valid count, gathered top/bottom-k_eff
    candidates). Runs INSIDE shard_map on one shard's lanes."""
    m = m & jnp.isfinite(v)
    big = jnp.asarray(jnp.inf, v.dtype)
    cnt = jax.lax.psum(jnp.sum(m), BATCH_AXIS)
    top = jax.lax.top_k(jnp.where(m, v, -big), k_eff)[0]
    bot = -jax.lax.top_k(jnp.where(m, -v, -big), k_eff)[0]
    hi = jax.lax.all_gather(top, BATCH_AXIS, tiled=True)
    lo = jax.lax.all_gather(bot, BATCH_AXIS, tiled=True)
    return cnt, hi, lo


def collective_tail_carry(values: jnp.ndarray, mask: jnp.ndarray | None,
                          mesh: Mesh, carry: tuple | None = None,
                          k: int = 4096) -> tuple:
    """Device-resident streaming top-k/bottom-k across slabs.

    Merges this slab's collective extreme candidates into a replicated
    ``(hi[k], lo[k])`` carry WITHOUT moving candidate arrays to the host
    (per-slab readback of 2*devices*k floats over a slow link is exactly
    the device->host traffic the per-slab loop must avoid — read back
    scalars only). The merge happens INSIDE the shard_map, so it is SPMD
    and multi-process-safe (eager ops on a replicated global array are
    not). ``carry=None`` starts a run (+-inf padding). Returns
    ``(n_valid, (hi, lo))`` where ``n_valid`` is a device scalar and
    hi/lo the updated replicated carries; feed ``(hi, lo)`` back on the
    next slab and finalize once with ``tail_reservoir_from_carry``.
    Exactness argument is ``collective_tail_extremes``'s: the global
    top-k of a union of slabs lies in the union of per-slab candidate
    sets, which the carry retains."""
    n = values.shape[0]
    ndev = mesh.devices.size
    if n == 0 or n % ndev:
        raise ValueError(
            f"batch of {n} lanes cannot shard over {ndev} devices; "
            "pad to a multiple of the device count"
        )
    values, mask, k_eff = _tail_args(values, mask, mesh, n, ndev, k)
    if carry is None:
        dt = values.dtype
        big = jnp.asarray(jnp.inf, dt)
        carry = (jnp.full(k, -big, dt), jnp.full(k, big, dt))

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(BATCH_AXIS), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def _carry(v, m, ch, cl):
        cnt, hi, lo = _shard_extremes(v, m, k_eff)
        new_hi = jax.lax.top_k(jnp.concatenate([ch, hi]), k)[0]
        new_lo = -jax.lax.top_k(jnp.concatenate([-cl, -lo]), k)[0]
        return cnt, new_hi, new_lo

    cnt, ch, cl = _carry(values, mask, *carry)
    return cnt, (ch, cl)


def tail_reservoir_from_carry(carry: tuple, n: int):
    """One end-of-run readback of a ``collective_tail_carry`` state into
    a ``mc.tail.TailReservoir`` (drops the +-inf padding)."""
    import numpy as np

    from ..mc.tail import TailReservoir

    hi = np.asarray(carry[0], np.float64)
    lo = np.asarray(carry[1], np.float64)
    r = TailReservoir(hi.size)
    r.hi = np.sort(hi[np.isfinite(hi)])
    r.lo = np.sort(lo[np.isfinite(lo)])
    r.n = int(n)
    return r


def collective_tail_reservoir(values: jnp.ndarray,
                              mask: jnp.ndarray | None, mesh: Mesh,
                              k: int = 4096):
    """``mc.tail.TailReservoir`` over a sharded metric — the pod-scale
    twin of the analyzer's streaming ``tail_reservoirs`` (feeds
    ``mc.tail.gpd_tail`` / merges into another reservoir via ``add`` +
    restoring ``n``). Exact: the reservoir's ``hi``/``lo`` equal a
    single-host top-k/bottom-k of the same valid lanes."""
    import numpy as np

    from ..mc.tail import TailReservoir

    cnt, hi, lo = collective_tail_extremes(values, mask, mesh, k)
    hi = np.asarray(hi, np.float64)
    lo = np.asarray(lo, np.float64)
    r = TailReservoir(k)
    # hi/lo candidates are supersets per side; build each side directly
    # (an add() on their union would double-count lanes that sit in both
    # a shard's top-k' and bottom-k')
    fh = np.sort(hi[np.isfinite(hi)])
    fl = np.sort(lo[np.isfinite(lo)])
    r.hi = fh[-min(k, fh.size):]
    r.lo = fl[:min(k, fl.size)]
    r.n = int(cnt)
    return r


__all__ += ["collective_envelope"]


def collective_envelope(traj, mesh: Mesh, env=None,
                        n_bins: int | None = None, max_time: float = 300.0):
    """Pod-scale flight envelope: per-time-bin population bands over a
    LANE-SHARDED batched trajectory, with O(n_bins) communication.

    The collective twin of ``mc.EnvelopeAccumulator``: per-shard segment
    reductions combine with ``psum`` (count/sum -> global mean, then
    locally centered M2 about the GLOBAL mean — the same two-pass variance
    discipline as ``collective_stats``), min/max with ``pmin``/``pmax``,
    and the quantile histograms bucket with the EXACT collective per-bin
    min/max (so nothing clips, unlike the chunked path's first-chunk
    calibration). Returns the same JSON-ready block as
    ``EnvelopeAccumulator.result()`` (built by ``mc.envelope.result_block``
    so the schemas cannot drift).

    ``traj`` is a batched ``Trajectory`` ([B, T, ...] leaves); its arrays
    are placed lane-sharded on ``mesh`` if they are not already (a no-op
    for global arrays in a ``jax.distributed`` run).
    """
    from ..mc.envelope import (
        EnvelopeConfig,
        _bin_histogram,
        result_block,
        trajectory_channel,
    )

    if env is None:
        env = EnvelopeConfig()
    if n_bins is None:
        n_bins = env.n_bins
    if n_bins is None:
        import math

        n_bins = int(math.ceil(max_time / env.bin_dt))

    def put(x):
        return jax.device_put(x, NamedSharding(mesh, P(BATCH_AXIS)))

    t = put(traj.time)
    valid = put(traj.valid)
    channels = {ch: put(trajectory_channel(traj, ch))
                for ch in env.channels}
    n_lanes = int(traj.valid.shape[0])

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(BATCH_AXIS),
                  {ch: P(BATCH_AXIS) for ch in env.channels}),
        out_specs=P(),
        check_vma=False,
    )
    def _envelope(t_s, valid_s, ch_s):
        out = {}
        for ch, value in ch_s.items():
            ids = jnp.clip(jnp.floor(t_s / env.bin_dt).astype(jnp.int32),
                           0, n_bins - 1)
            m = valid_s & jnp.isfinite(value)
            ids = jnp.where(m, ids, n_bins).ravel()
            v = value.ravel()
            mr = m.ravel()
            nseg = n_bins + 1
            # count in int32 (exact to 2^31 per bin) and psum as int —
            # an f32 count loses integer exactness past 2^24 samples per
            # bin, the regime this pod-scale path exists for (same
            # discipline as collective_stats' integer lane count)
            n_int = jax.lax.psum(
                jax.ops.segment_sum(mr.astype(jnp.int32), ids,
                                    num_segments=nseg)[:n_bins],
                BATCH_AXIS,
            )
            s_loc = jax.ops.segment_sum(jnp.where(mr, v, 0.0), ids,
                                        num_segments=nseg)[:n_bins]
            n = n_int.astype(v.dtype)
            s = jax.lax.psum(s_loc, BATCH_AXIS)
            mean = s / jnp.maximum(n, 1.0)
            c = v - jnp.concatenate([mean, jnp.zeros((1,), mean.dtype)])[ids]
            m2 = jax.lax.psum(
                jax.ops.segment_sum(jnp.where(mr, c * c, 0.0), ids,
                                    num_segments=nseg)[:n_bins],
                BATCH_AXIS,
            )
            big = jnp.asarray(jnp.inf, v.dtype)
            vmin = jax.lax.pmin(
                jax.ops.segment_min(jnp.where(mr, v, big), ids,
                                    num_segments=nseg)[:n_bins],
                BATCH_AXIS,
            )
            vmax = jax.lax.pmax(
                jax.ops.segment_max(jnp.where(mr, v, -big), ids,
                                    num_segments=nseg)[:n_bins],
                BATCH_AXIS,
            )
            # exact collective edges, in the SAME f32 precision as the
            # chunked accumulator's calibration (schema + value parity)
            fin_lo = jnp.where(jnp.isfinite(vmin), vmin, 0.0)
            fin_hi = jnp.where(jnp.isfinite(vmax), vmax, 1.0)
            span = jnp.maximum(fin_hi - fin_lo, 1e-12)
            lo64 = fin_lo - env.edge_margin * span
            hi64 = fin_hi + env.edge_margin * span
            lo = lo64.astype(jnp.float32)
            width = ((hi64 - lo64) / env.n_buckets).astype(jnp.float32)
            h_loc, clip_loc = _bin_histogram(
                t_s, valid_s, value, env.bin_dt, lo, width,
                n_bins=n_bins, n_buckets=env.n_buckets,
            )
            hist = jax.lax.psum(h_loc, BATCH_AXIS)
            clipped = jax.lax.psum(jnp.sum(clip_loc), BATCH_AXIS)
            out[ch] = {"n": n, "mean": mean, "m2": m2, "min": vmin,
                       "max": vmax, "hist": hist, "lo": lo,
                       "width": width, "clipped": clipped}
        return out

    agg = jax.device_get(_envelope(t, valid, channels))
    return result_block(env, n_bins, agg, n_lanes)
