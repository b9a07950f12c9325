"""Flight-envelope statistics: time-binned population bands over the MC.

The deliverable: for each flight quantity (altitude, speed, Mach, angle of
attack, stability margin, ...), the population's mean/std/min/max and
quantile band as a function of time-since-rail-exit, across every surviving
lane of a Monte Carlo run. The reference can only draw per-lane trajectory
lines from its persisted histories (`/root/reference/plot_results.py` /
`monte_carlo.py:510-517` keep whole trajectories per sim and the plots
overlay a handful); it never computes population envelopes, and its
keep-every-history strategy cannot scale to them. Here the trajectories are
re-created by key in lane chunks (the analyzer's determinism-by-key
re-simulation), and each chunk is reduced ON DEVICE to per-time-bin
aggregates — O(n_bins) host traffic per chunk regardless of lane count, so
an envelope over a 10M-lane run is just more chunks.

Accuracy contract:
- count/mean/std/min/max per bin are EXACT over the lanes fed in (device
  f32 centered sums, host f64 Chan merge across chunks — same discipline
  as ``mc.stats.FootprintAccumulator``).
- quantile bands come from a fixed-edge per-bin histogram (``n_buckets``
  buckets spanning the first chunk's per-bin [min, max], widened by a
  margin); the value error is bounded by one bucket width, and mass
  landing outside the calibrated span clamps into the edge buckets and is
  reported as ``clipped_frac`` (first-chunk calibration sees every bin's
  range to within sampling noise when chunks are a few hundred lanes).
- bands are CONDITIONAL ON LANES STILL FLYING at each bin (the standard
  envelope convention): low-apogee lanes land earlier and leave the
  surviving population biased high, so e.g. the p50 band's peak over
  time sits above the median per-lane apogee (measured 3,935 vs 3,218 m
  on a full-flight MC — NOTES.md). Bands answer "where is the population
  at time t"; use the metric statistics for per-lane-extreme quantiles.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .stats import PERCENTILES

__all__ = ["EnvelopeConfig", "EnvelopeAccumulator", "trajectory_channel",
           "result_block"]

# Channels servable from a recorded Trajectory: state-derived ones always
# exist; the rest require SimConfig.record_derived (the default).
_STATE_CHANNELS = ("altitude", "speed")
DEFAULT_CHANNELS = (
    "altitude", "speed", "mach", "angle_of_attack", "stability_margin",
    "drag",
)


@dataclasses.dataclass(frozen=True)
class EnvelopeConfig:
    """What to bin and how finely.

    ``bin_dt`` buckets time-since-rail-exit; with the default
    ``SimConfig`` (dt=5 ms) and ``record_stride`` below, every 0.25 s bin
    sees multiple recorded samples per surviving lane. ``record_stride``
    overrides the SimConfig's recording stride for the envelope
    re-simulation (None = keep the config's); trajectory memory per chunk
    scales as lanes x steps / stride, so the default keeps a 1024-lane x
    60k-step chunk under ~1 GB of device memory.
    """

    channels: tuple = DEFAULT_CHANNELS
    bin_dt: float = 0.25
    n_bins: Optional[int] = None  # default: ceil(max_time / bin_dt)
    n_buckets: int = 128
    percentiles: tuple = PERCENTILES
    record_stride: Optional[int] = 8
    edge_margin: float = 0.05  # widen calibrated [min,max] by this fraction
    # Feed the quantile HISTOGRAMS every Nth recorded frame only (moments/
    # min/max always see every frame and stay exact). Within a time bin a
    # lane contributes many strongly-autocorrelated frames (~25 at the
    # default strides), so the bands' effective sample count is set by the
    # LANE count, not the frame count — a stride of 4 cuts the dominant
    # binning matmul 4x at no visible band change.
    hist_frame_stride: int = 1


def trajectory_channel(traj, name: str) -> jnp.ndarray:
    """The [B, T] value array for a named envelope channel."""
    if name == "altitude":
        return traj.position[..., 2]
    if name == "speed" and "speed" not in traj.derived:
        # same expression AND association as engine.component.derived_c's
        # "speed" (safe_sqrt(vx*vx + vy*vy + vz*vz)): a jnp.sum over the
        # minor axis reduces in a different order and drifts one ULP,
        # which would break the frame-path vs in-loop bit-equality the
        # envelope tests pin.
        from ..ops.math import safe_sqrt

        vx, vy, vz = (traj.velocity[..., 0], traj.velocity[..., 1],
                      traj.velocity[..., 2])
        return safe_sqrt(vx * vx + vy * vy + vz * vz)
    if name in traj.derived:
        return traj.derived[name]
    raise KeyError(
        f"channel {name!r} is not recorded; state channels are "
        f"{_STATE_CHANNELS}, derived channels need record_derived=True"
    )


@functools.partial(jax.jit, static_argnames=("n_bins",))
def _bin_moments_mc(t, valid, values, bin_dt, n_bins):
    """Multi-channel per-time-bin (count, mean, centered M2, min, max).

    ``values`` is [C, B, T]; returns [C, n_bins] arrays in ONE dispatch.
    All reductions are one-hot contractions (``einsum`` over the shared
    [B, T, K] bin indicator — XLA fuses the iota-compare into the
    contraction operands) instead of ``segment_sum``. Whether a scatter is
    cheaper on the GPU is an open measurement. Every f32 contraction runs
    at HIGHEST precision: a reduced-precision (TF32) pass would round a
    25 km altitude by ~12 m before it is binned. The M2 contraction is CENTERED
    (bin means broadcast back through the same one-hot) — raw
    sum-of-squares cancels catastrophically in f32 when std << mean
    (altitude: 25 km +- 50 m loses every digit).
    """
    ids = jnp.clip(jnp.floor(t / bin_dt).astype(jnp.int32), 0, n_bins - 1)
    m = valid[None] & jnp.isfinite(values)          # [C,B,T]
    ohf = (ids[..., None] == jnp.arange(n_bins)).astype(values.dtype)
    v0 = jnp.where(m, values, 0.0)
    n = jnp.einsum("cbt,btk->ck", m.astype(values.dtype), ohf,
                   precision=jax.lax.Precision.HIGHEST)
    s = jnp.einsum("cbt,btk->ck", v0, ohf, precision=jax.lax.Precision.HIGHEST)
    mean = s / jnp.maximum(n, 1.0)
    mb = jnp.einsum("ck,btk->cbt", mean, ohf,
                    precision=jax.lax.Precision.HIGHEST)
    c = jnp.where(m, values - mb, 0.0)
    m2 = jnp.einsum("cbt,btk->ck", c * c, ohf,
                    precision=jax.lax.Precision.HIGHEST)
    # min/max: bin-BLOCKED one-hot reduces. A whole-K selector feeding both
    # reductions gets MATERIALIZED by XLA ([B,T,K] bool = 8.7 GB at chunk
    # 4096: out of device memory). Blocking K and giving each
    # reduction its OWN selector keeps the compare fused into the reduce
    # with bounded temp memory (~[B,T,block] per map step).
    big = jnp.asarray(jnp.inf, values.dtype)
    v_min = jnp.where(m, values, big)       # [C,B,T]
    v_max = jnp.where(m, values, -big)
    block = 64
    n_blocks = -(-n_bins // block)
    starts = jnp.arange(n_blocks) * block

    def block_min(k0):
        sel = ids[..., None] == (k0 + jnp.arange(block))   # [B,T,block]
        return jnp.min(jnp.where(sel[None], v_min[..., None], big),
                       axis=(1, 2))                        # [C,block]

    def block_max(k0):
        sel = ids[..., None] == (k0 + jnp.arange(block))
        return jnp.max(jnp.where(sel[None], v_max[..., None], -big),
                       axis=(1, 2))

    vmin = jnp.moveaxis(jax.lax.map(block_min, starts), 0, 1)
    vmax = jnp.moveaxis(jax.lax.map(block_max, starts), 0, 1)
    vmin = vmin.reshape(values.shape[0], -1)[:, :n_bins]
    vmax = vmax.reshape(values.shape[0], -1)[:, :n_bins]
    return n, mean, m2, vmin, vmax


@functools.partial(jax.jit,
                   static_argnames=("n_bins", "n_buckets", "frame_stride"))
def _bin_histogram_mc(t, valid, values, bin_dt, lo, width, n_bins,
                      n_buckets, frame_stride=1):
    """Multi-channel fixed-edge per-bin histograms [C, n_bins, n_buckets]
    + per-channel clipped counts, one dispatch. The count is a two-sided
    one-hot contraction (bin indicator x bucket indicator,
    bf16 inputs / f32 accumulation — counts are exact integers far below
    2^24). ``frame_stride`` subsamples frames for the histogram ONLY
    (see ``EnvelopeConfig.hist_frame_stride``)."""
    if frame_stride > 1:
        t = t[:, ::frame_stride]
        valid = valid[:, ::frame_stride]
        values = values[:, :, ::frame_stride]
    ids = jnp.clip(jnp.floor(t / bin_dt).astype(jnp.int32), 0, n_bins - 1)
    m = valid[None] & jnp.isfinite(values)
    ohk = (ids[..., None] == jnp.arange(n_bins)).astype(values.dtype)
    lo_s = jnp.einsum("ck,btk->cbt", lo, ohk,
                      precision=jax.lax.Precision.HIGHEST)
    w_s = jnp.einsum("ck,btk->cbt", width, ohk,
                     precision=jax.lax.Precision.HIGHEST)
    frac = (values - lo_s) / jnp.maximum(w_s, 1e-30)
    bucket = jnp.clip(frac.astype(jnp.int32), 0, n_buckets - 1)
    ohj = ((bucket[..., None] == jnp.arange(n_buckets))
           & m[..., None]).astype(jnp.bfloat16)
    h = jnp.einsum("btk,cbtj->ckj", ohk.astype(jnp.bfloat16), ohj,
                   preferred_element_type=jnp.float32)
    clipped = jnp.where(m & ((frac < 0.0) | (frac >= n_buckets)), 1.0, 0.0)
    clip_ct = jnp.einsum("cbt,btk->ck", clipped, ohk,
                         precision=jax.lax.Precision.HIGHEST).sum(axis=1)
    return h, clip_ct


@functools.partial(jax.jit, static_argnames=("n_bins", "n_buckets"))
def _bin_histogram(t, valid, value, bin_dt, lo, width, n_bins, n_buckets):
    """Single-channel fixed-edge per-bin histogram [n_bins, n_buckets] +
    clipped count — kept (segment-sum form) for the shard_map collective
    path (``parallel.collective_envelope``), where the per-shard batch is
    small and the psum dominates; the chunked host path uses the
    contraction ``_bin_histogram_mc`` above.

    ``lo``/``width`` are the calibrated per-bin bucket grids; samples
    outside clamp into the edge buckets (counted in ``clipped``).
    """
    ids = jnp.clip(jnp.floor(t / bin_dt).astype(jnp.int32), 0, n_bins - 1)
    m = valid & jnp.isfinite(value)
    ids = jnp.where(m, ids, n_bins).ravel()
    v = value.ravel()
    mr = m.ravel()
    pad = jnp.zeros((1,), lo.dtype)
    lo_s = jnp.concatenate([lo, pad])[ids]
    w_s = jnp.concatenate([width, pad])[ids]
    frac = (v - lo_s) / jnp.maximum(w_s, 1e-30)
    bucket = jnp.clip(frac.astype(jnp.int32), 0, n_buckets - 1)
    # integer counting: an f32 count saturates at 2^24 samples per bucket
    # — routinely exceeded at pod scale (the collective path psums these)
    clipped = jnp.where(mr & ((frac < 0.0) | (frac >= n_buckets)), 1, 0)
    flat = jnp.where(mr, ids * n_buckets + bucket, n_bins * n_buckets)
    ones = mr.astype(jnp.int32)
    h = jax.ops.segment_sum(ones, flat,
                            num_segments=n_bins * n_buckets + 1)
    clip_ct = jax.ops.segment_sum(clipped, ids, num_segments=n_bins + 1)
    return h[:-1].reshape(n_bins, n_buckets), clip_ct[:n_bins]


class EnvelopeAccumulator:
    """Chunk-mergeable time-binned statistics over one or more channels.

    Feed batched trajectories with :meth:`add`; chunks merge exactly for
    moments/min/max (host f64 Chan update, vectorized over bins) and
    additively for the histograms (bucket edges freeze after the first
    chunk — the calibration chunk should be a representative sample, which
    lane-chunked MC re-simulation gives for free).
    """

    def __init__(self, cfg, env: EnvelopeConfig = EnvelopeConfig()):
        self.env = env
        n_bins = env.n_bins
        if n_bins is None:
            n_bins = int(np.ceil(cfg.max_time / env.bin_dt))
        self.n_bins = int(n_bins)
        self.n_lanes = 0
        z = lambda: np.zeros(self.n_bins, np.float64)
        self._n = {c: z() for c in env.channels}
        self._mean = {c: z() for c in env.channels}
        self._m2 = {c: z() for c in env.channels}
        self._min = {c: np.full(self.n_bins, np.inf) for c in env.channels}
        self._max = {c: np.full(self.n_bins, -np.inf) for c in env.channels}
        self._edges = None  # ([C, n_bins] lo, [C, n_bins] width), frozen
        self._hist = {
            c: np.zeros((self.n_bins, env.n_buckets), np.float64)
            for c in env.channels
        }
        self._clipped = {c: 0.0 for c in env.channels}

    def add(self, traj) -> None:
        """Fold in one batched Trajectory ([B, T, ...] leaves).

        TWO device dispatches per chunk (multi-channel moment contraction,
        multi-channel histogram); an earlier version dispatched 3
        segment-op calls PER CHANNEL."""
        env = self.env
        t = traj.time
        valid = traj.valid
        values = jnp.stack(
            [trajectory_channel(traj, ch) for ch in env.channels]
        )
        n, mean, m2, vmin, vmax = jax.device_get(_bin_moments_mc(
            t, valid, values, env.bin_dt, self.n_bins
        ))
        for i, ch in enumerate(env.channels):
            self._merge_moments(ch, n[i].astype(np.float64),
                                mean[i].astype(np.float64),
                                m2[i].astype(np.float64))
            self._min[ch] = np.minimum(self._min[ch], vmin[i])
            self._max[ch] = np.maximum(self._max[ch], vmax[i])
        if self._edges is None:
            self._calibrate(vmin, vmax)
        lo, width = self._edges
        h, clip_ct = jax.device_get(_bin_histogram_mc(
            t, valid, values, env.bin_dt, lo, width,
            self.n_bins, env.n_buckets,
            frame_stride=max(1, env.hist_frame_stride),
        ))
        for i, ch in enumerate(env.channels):
            self._hist[ch] += h[i].astype(np.float64)
            self._clipped[ch] += float(clip_ct[i])
        self.n_lanes += int(traj.valid.shape[0])

    def add_aggregates(self, agg, n_lanes: int) -> None:
        """Fold in one chunk's FRAMELESS per-bin aggregates
        (``engine.batch.simulate_envelope_batch`` — the in-loop binning
        path that never materializes [T, B] frames, so chunks scale past
        the frame path's 4096-lane OOM ceiling). Same host f64 Chan merge
        as :meth:`add`; requires the bucket edges to be frozen already —
        feed ONE frame-based chunk (:meth:`add`) first to calibrate."""
        if self._edges is None:
            raise RuntimeError(
                "histogram edges not calibrated: feed one frame-based "
                "chunk via add() before aggregate chunks"
            )
        a = jax.device_get(agg)
        for i, ch in enumerate(self.env.channels):
            self._merge_moments(ch, np.asarray(a["n"][i], np.float64),
                                np.asarray(a["mean"][i], np.float64),
                                np.asarray(a["m2"][i], np.float64))
            self._min[ch] = np.minimum(self._min[ch], a["min"][i])
            self._max[ch] = np.maximum(self._max[ch], a["max"][i])
            self._hist[ch] += np.asarray(a["hist"][i], np.float64)
            self._clipped[ch] += float(a["clipped"][i])
        self.n_lanes += int(n_lanes)

    def _calibrate(self, vmin, vmax) -> None:
        """Freeze per-bin bucket edges from the first chunk's [C, n_bins]
        min/max, widened by ``edge_margin`` (empty bins get a degenerate
        unit span; their histograms stay empty)."""
        env = self.env
        vmin = np.where(np.isfinite(vmin), vmin, 0.0)
        vmax = np.where(np.isfinite(vmax), vmax, 1.0)
        span = np.maximum(vmax - vmin, 1e-12)
        lo = vmin - env.edge_margin * span
        hi = vmax + env.edge_margin * span
        width = (hi - lo) / env.n_buckets
        self._edges = (
            jnp.asarray(lo, jnp.float32), jnp.asarray(width, jnp.float32)
        )

    def _merge_moments(self, ch, n_b, mean_b, m2_b) -> None:
        n_a = self._n[ch]
        tot = n_a + n_b
        safe = np.maximum(tot, 1.0)
        delta = mean_b - self._mean[ch]
        self._m2[ch] += m2_b + delta * delta * n_a * n_b / safe
        self._mean[ch] += delta * n_b / safe
        self._n[ch] = tot

    def result(self) -> dict:
        """The envelope block: JSON-ready per-channel band arrays.

        Per channel: ``n``/``mean``/``std``/``min``/``max`` are exact per
        bin (NaN where the bin saw no samples — every lane already landed,
        or the bin is past max_time); ``percentiles`` maps "5.0" etc. to a
        per-bin band interpolated from the histogram (mass-midpoint rule,
        one-bucket-width value error); ``clipped_frac`` is the mass that
        fell outside the calibrated span.
        """
        env = self.env
        per_channel = {}
        for i, ch in enumerate(env.channels):
            lo = np.asarray(self._edges[0][i], np.float64) if self._edges \
                else np.zeros(self.n_bins)
            width = np.asarray(self._edges[1][i], np.float64) \
                if self._edges else np.ones(self.n_bins)
            per_channel[ch] = {
                "n": self._n[ch], "mean": self._mean[ch],
                "m2": self._m2[ch], "min": self._min[ch],
                "max": self._max[ch], "hist": self._hist[ch],
                "lo": lo, "width": width, "clipped": self._clipped[ch],
            }
        return result_block(env, self.n_bins, per_channel, self.n_lanes)


def _hist_quantiles(hist, lo, width, n, vmin, vmax, qs) -> np.ndarray:
    """[Q, n_bins] histogram quantiles (bucket-center mass midpoints,
    linear interpolation — the convention of ``StreamingStats``), clamped
    inside the exact min/max envelope (bucket-width overshoot at the
    extremes would otherwise poke outside)."""
    qs = np.asarray(qs, np.float64)
    n_bins, n_buckets = hist.shape
    out = np.full((qs.size, n_bins), np.nan)
    for b in range(n_bins):
        h = hist[b]
        tot = h.sum()
        if tot <= 0:
            continue
        centers = lo[b] + (np.arange(n_buckets) + 0.5) * width[b]
        mid = np.cumsum(h) - 0.5 * h
        targets = qs / 100.0 * (tot - 1.0) + 0.5
        out[:, b] = np.interp(targets, mid, centers)
    vmin = np.where(n > 0, vmin, np.nan)
    vmax = np.where(n > 0, vmax, np.nan)
    return np.clip(out, vmin[None, :], vmax[None, :])


def result_block(env: EnvelopeConfig, n_bins: int, per_channel: dict,
                 n_lanes: int) -> dict:
    """Build the JSON-ready envelope block from raw per-bin aggregates —
    shared by :class:`EnvelopeAccumulator` and the pod-scale collective
    path (``parallel.collective_envelope``) so the two schemas cannot
    drift. ``per_channel[ch]`` carries f64 arrays ``n/mean/m2/min/max``
    [n_bins], ``hist`` [n_bins, n_buckets], bucket edges ``lo``/``width``
    [n_bins], and the scalar ``clipped`` count."""
    centers = (np.arange(n_bins) + 0.5) * env.bin_dt
    out = {
        "bin_dt": env.bin_dt,
        "time": [float(x) for x in centers],
        "n_lanes": n_lanes,
        "percentile_qs": [float(q) for q in env.percentiles],
        "channels": {},
    }
    for ch, blk in per_channel.items():
        n = np.asarray(blk["n"], np.float64)
        empty = n == 0
        mean = np.where(empty, np.nan, blk["mean"])
        std = np.where(empty, np.nan,
                       np.sqrt(np.asarray(blk["m2"]) / np.maximum(n, 1.0)))
        vmin = np.where(empty, np.nan, blk["min"])
        vmax = np.where(empty, np.nan, blk["max"])
        pct = _hist_quantiles(
            np.asarray(blk["hist"], np.float64),
            np.asarray(blk["lo"], np.float64),
            np.asarray(blk["width"], np.float64),
            n, np.asarray(blk["min"], np.float64),
            np.asarray(blk["max"], np.float64), env.percentiles,
        )
        # clipped_frac denominator: the HISTOGRAM's own sample count
        # (every masked sample it saw lands in some bucket), not the
        # moments' n.sum() — under hist_frame_stride the histogram sees
        # a strided subset and dividing by all frames understated the
        # miscalibration diagnostic by the stride factor (r4 review).
        hist_total = float(np.asarray(blk["hist"], np.float64).sum())
        out["channels"][ch] = {
            "n": [int(x) for x in n],
            "mean": [float(x) for x in mean],
            "std": [float(x) for x in std],
            "min": [float(x) for x in vmin],
            "max": [float(x) for x in vmax],
            "percentiles": {
                f"{q:g}": [float(x) for x in pct[i]]
                for i, q in enumerate(env.percentiles)
            },
            "clipped_frac": (
                float(blk["clipped"]) / hist_total if hist_total else 0.0
            ),
        }
    return out
