"""Slab-loop accumulators: one protocol, twelve concerns, zero threading.

Round 3's ``_run_slabbed`` interleaved every accumulation concern — stats,
streams, CV moments, QMC block means, ensemble strata, footprint, tail
reservoirs, importance weights, convergence history, parameter ranges,
records, checkpoints — in one ~450-line loop body, and each new estimator
mutated that function plus ``mc/slab_checkpoint.py`` in lock-step (three
round-3 review bugs lived exactly there). This module factors each concern
into a :class:`SlabAccumulator`:

* ``update(ctx)`` — consume one slab via the shared :class:`SlabContext`
  (device handles + LAZY host readbacks, so a concern that needs no
  readback never pays for one);
* ``to_arrays(arrays)`` / ``meta_state()`` — contribute its checkpoint
  leaves (array names unchanged from the v4 format where they existed —
  e.g. ``stream.<metric>.exact`` — so the part-boundary regression tests
  keep their grip);
* ``restore(z, meta)`` — rebuild from a checkpoint, per-accumulator
  ``version`` checked by ``mc.slab_checkpoint``;
* ``finalize(analysis, analyzer)`` — write its analysis-dict blocks
  (registry order: the importance block reads the metrics prefix, so
  prefix finalizes first).

The loop (``MonteCarloAnalyzer._run_slabbed``) now just drives the
registry; ``mc.slab_checkpoint`` iterates the same registry to save and
restore. Replaces-at-scale: the reference's in-driver result-list
accumulation, `monte_carlo.py:400-473`.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["SlabContext", "SlabAccumulator", "build_registry"]

HEADLINE_METRICS = ("apogee_altitude", "range", "flight_time")
PREFIX_METRICS = HEADLINE_METRICS + ("max_speed",)


class SlabContext:
    """One slab's data, shared by every accumulator.

    Device handles are free; host fields (``valid_np``, ``slab_metrics``,
    ``summary_np``, ...) are cached properties so each readback happens at
    most once per slab and ONLY if some enabled accumulator asks
    (device->host readback serializes with the device).
    """

    def __init__(self, *, summary, sample, scene_b, valid, reasons,
                 ranges_mask, n_s: int, slab: int, n_done: int):
        self.summary = summary
        self.sample = sample
        self.scene_b = scene_b
        self.valid = valid
        self.reasons = reasons
        self.ranges_mask = ranges_mask
        self.n_s = n_s
        self.slab = slab
        self.n_done = n_done          # global lane offset of this slab
        self.n_valid_total = 0        # filled by the loop after readback
        self._cache: dict = {}

    def _get(self, name, fn):
        if name not in self._cache:
            self._cache[name] = fn()
        return self._cache[name]

    @property
    def valid_np(self) -> np.ndarray:
        return self._get("valid_np",
                         lambda: np.asarray(self.valid)[: self.n_s])

    @property
    def reasons_np(self) -> np.ndarray:
        return self._get("reasons_np",
                         lambda: np.asarray(self.reasons)[: self.n_s])

    @property
    def slab_metrics(self) -> dict:
        return self._get("slab_metrics", lambda: {
            k: np.asarray(getattr(self.summary, k))[: self.n_s]
            for k in PREFIX_METRICS
        })

    @property
    def mem_np(self) -> np.ndarray:
        return self._get(
            "mem_np",
            lambda: np.asarray(self.sample.wind_member)[: self.n_s],
        )

    @property
    def summary_np(self):
        return self._get("summary_np", lambda: jax.tree.map(
            lambda x: np.asarray(x)[: self.n_s], self.summary))

    @property
    def sample_np(self):
        return self._get("sample_np", lambda: jax.tree.map(
            lambda x: np.asarray(x)[: self.n_s], self.sample))


class SlabAccumulator:
    """Protocol base. ``key`` namespaces checkpoint meta; ``version`` is
    the per-accumulator schema version (bumped independently — adding an
    estimator no longer revs the whole checkpoint format)."""

    key: str = ""
    version: int = 1

    def update(self, ctx: SlabContext) -> None:
        raise NotImplementedError

    def to_arrays(self, arrays: dict) -> None:
        """Contribute numpy leaves to the checkpoint (flat npz dict)."""

    def meta_state(self):
        """JSON-native state (small; floats survive json exactly)."""
        return None

    def restore(self, z, meta) -> None:
        """Rebuild in place from ``np.load`` handle + ``meta_state()``."""

    def finalize(self, analysis: dict, analyzer) -> None:
        """Write this concern's analysis-dict blocks."""


class PrefixAccumulator(SlabAccumulator):
    """Capped per-lane prefix: headline+max_speed metrics, valid mask,
    reason bitmask, landing xy, and (under a forecast ensemble) member
    indices — all aligned to the same first-``cap`` lanes. When not
    streaming, ``cap == n_samples`` and the prefix IS the full run."""

    key = "prefix"

    def __init__(self, cap: int, streaming: bool, want_members: bool):
        self.cap = cap
        self.streaming = streaming
        self.want_members = want_members
        self.kept = 0
        self.metrics = {k: [] for k in PREFIX_METRICS}
        self.valid_parts: list = []
        self.reason_parts: list = []
        self.landing_parts: list = []
        self.member_parts: list = []

    def update(self, ctx: SlabContext) -> None:
        take = min(ctx.n_s, self.cap - self.kept)
        if take <= 0:
            return
        for k in self.metrics:
            self.metrics[k].append(ctx.slab_metrics[k][:take])
        # device-side slice first: read back [take,2], not [slab,3]
        self.landing_parts.append(
            np.asarray(ctx.summary.landing_position[:take, :2])
        )
        self.valid_parts.append(ctx.valid_np[:take])
        self.reason_parts.append(ctx.reasons_np[:take])
        if self.want_members:
            self.member_parts.append(ctx.mem_np[:take])
        self.kept += take

    def to_arrays(self, arrays: dict) -> None:
        for k in PREFIX_METRICS:
            parts = self.metrics[k]
            arrays["metrics." + k] = (
                np.concatenate(parts) if parts else np.empty(0, np.float32)
            )
        for name in ("valid_parts", "reason_parts", "landing_parts",
                     "member_parts"):
            parts = getattr(self, name)
            if parts:
                arrays[name] = np.concatenate(parts)

    def meta_state(self):
        return {"kept": self.kept}

    def restore(self, z, meta) -> None:
        self.kept = meta["kept"]
        self.metrics = {
            k: ([z["metrics." + k]] if z["metrics." + k].size else [])
            for k in PREFIX_METRICS
        }
        for name in ("valid_parts", "reason_parts", "landing_parts",
                     "member_parts"):
            setattr(self, name, [z[name]] if name in z else [])

    def concatenated(self) -> tuple:
        metrics = {k: np.concatenate(v) if v else np.empty(0)
                   for k, v in self.metrics.items()}
        valid = (np.concatenate(self.valid_parts) if self.valid_parts
                 else np.zeros(0, bool))
        reasons = (np.concatenate(self.reason_parts) if self.reason_parts
                   else np.zeros(0, np.int32))
        return metrics, valid, reasons

    def finalize(self, analysis: dict, analyzer) -> None:
        metrics, valid_np, reasons_np = self.concatenated()
        analysis["metrics"] = metrics
        analysis["valid_mask"] = valid_np
        analysis["reasons"] = reasons_np
        # Same capped prefix as metrics: per-lane impact xy for the
        # footprint plot's scatter (the footprint STATS see every lane
        # via the moment merge).
        analysis["landing_samples"] = (
            np.concatenate(self.landing_parts) if self.landing_parts
            else np.zeros((0, 2))
        )
        # Streaming runs cap the per-lane arrays at metrics_sample_cap
        # lanes (i.i.d. for prng; NOT independent for sobol/antithetic —
        # see _run_slabbed's docstring); stats blocks come from exact
        # moments + the quantile sketch over EVERY lane.
        analysis["metrics_is_sample"] = self.streaming
        if self.want_members:
            analysis["wind_members"] = (
                np.concatenate(self.member_parts) if self.member_parts
                else np.zeros(0, np.int32)
            )


class StreamAccumulator(SlabAccumulator):
    """Streaming stats + tail reservoirs per headline metric: exact
    moments, mergeable quantile sketch (``mc.stats.StreamingStats``), and
    top/bottom-k order statistics for GPD fits after the per-lane arrays
    are gone."""

    key = "stream"

    def __init__(self, exact_threshold: int):
        from .stats import StreamingStats
        from .tail import TailReservoir

        self.exact_threshold = exact_threshold
        self.stream = {k: StreamingStats(exact_threshold=exact_threshold)
                       for k in HEADLINE_METRICS}
        self.tails = {k: TailReservoir() for k in HEADLINE_METRICS}

    def update(self, ctx: SlabContext) -> None:
        for k in self.stream:
            vals_valid = ctx.slab_metrics[k][ctx.valid_np]
            self.stream[k].add(vals_valid)
            self.tails[k].add(vals_valid)

    def to_arrays(self, arrays: dict) -> None:
        from .slab_checkpoint import _pack_stream

        for k in HEADLINE_METRICS:
            _pack_stream(self.stream[k], arrays, f"stream.{k}.")
            self.tails[k].to_arrays(arrays, f"tail.{k}.")

    def restore(self, z, meta) -> None:
        from .slab_checkpoint import _unpack_stream
        from .tail import TailReservoir

        self.stream = {
            k: _unpack_stream(z, f"stream.{k}.", self.exact_threshold)
            for k in HEADLINE_METRICS
        }
        self.tails = {
            k: TailReservoir.from_arrays(z, f"tail.{k}.")
            for k in HEADLINE_METRICS
        }

    def stats_blocks(self) -> dict:
        return {k: s.stats() for k, s in self.stream.items()}

    def finalize(self, analysis: dict, analyzer) -> None:
        # Keep the sketches queryable: stats.exceedance_from_analysis
        # answers P(metric > t) after the per-lane data is gone.
        analysis["streams"] = self.stream
        analysis["tail_reservoirs"] = self.tails


class ConvergenceAccumulator(SlabAccumulator):
    """Running mean +- stderr per headline metric after every slab (f64
    sums; population variance like the stats blocks) — the "has this run
    converged" diagnostic the reference's fixed-n driver never shows.
    Stderr treats valid lanes as i.i.d. (conservative under
    sobol/antithetic)."""

    key = "conv"

    def __init__(self):
        self.hist: list = []
        self.acc = {k: [0, 0.0, 0.0] for k in HEADLINE_METRICS}

    def update(self, ctx: SlabContext) -> None:
        row = {"n_done": ctx.n_done + ctx.n_s,
               "n_valid": ctx.n_valid_total}
        for k in self.acc:
            v = ctx.slab_metrics[k][ctx.valid_np].astype(np.float64)
            v = v[np.isfinite(v)]
            a = self.acc[k]
            a[0] += v.size
            a[1] += float(v.sum())
            a[2] += float((v * v).sum())
            n_c, s_c, s2_c = a
            if n_c >= 2:
                m_c = s_c / n_c
                var_c = max(s2_c / n_c - m_c * m_c, 0.0)
                row[k] = {"mean": m_c,
                          "stderr": float(np.sqrt(var_c / n_c))}
            else:
                row[k] = {"mean": (s_c / n_c) if n_c else float("nan"),
                          "stderr": float("nan")}
        self.hist.append(row)

    def meta_state(self):
        return {"conv_hist": self.hist, "conv_acc": self.acc}

    def restore(self, z, meta) -> None:
        self.hist = meta["conv_hist"]
        self.acc = meta["conv_acc"]

    def finalize(self, analysis: dict, analyzer) -> None:
        analysis["convergence"] = self.hist


class QMCAccumulator(SlabAccumulator):
    """Per-slab valid-lane means: each slab draws its own scramble of the
    run key, so slab means are independent RQMC replicates and their
    spread is a statistically valid QMC error bar."""

    key = "qmc"

    def __init__(self):
        self.blocks = {k: [] for k in HEADLINE_METRICS}

    def update(self, ctx: SlabContext) -> None:
        valid_np = ctx.valid_np
        for k in self.blocks:
            arr = ctx.slab_metrics[k]
            self.blocks[k].append(
                float(arr[valid_np].mean()) if valid_np.any()
                else float("nan")
            )

    def to_arrays(self, arrays: dict) -> None:
        for k in HEADLINE_METRICS:
            arrays["qmc." + k] = np.asarray(self.blocks[k], np.float64)

    def restore(self, z, meta) -> None:
        self.blocks = {
            k: [float(x) for x in z["qmc." + k]] for k in HEADLINE_METRICS
        }

    def finalize(self, analysis: dict, analyzer) -> None:
        if len(self.blocks["apogee_altitude"]) > 1:
            analysis["qmc_error"] = analyzer._qmc_error(self.blocks)


class FootprintMomentsAccumulator(SlabAccumulator):
    """Landing-dispersion moment merge: the device kernel reduces each
    slab to six scalars; ellipses/CEP are built once at finalize. Per-lane
    miss distances are never materialized in slabbed runs."""

    key = "footprint"

    def __init__(self):
        from .stats import FootprintAccumulator

        self.acc = FootprintAccumulator()

    def update(self, ctx: SlabContext) -> None:
        from .analyzer import _footprint_moments_kernel

        self.acc.add(*(
            float(np.asarray(v)) for v in _footprint_moments_kernel(
                ctx.summary.landing_position, ctx.ranges_mask
            )
        ))

    def to_arrays(self, arrays: dict) -> None:
        a = self.acc
        arrays["footprint"] = np.asarray(
            [a.n, a.mx, a.my, a.m2x, a.m2y, a.cxy], np.float64
        )

    def restore(self, z, meta) -> None:
        n, mx, my, m2x, m2y, cxy = z["footprint"]
        a = self.acc
        a.n = int(n)
        a.mx, a.my = float(mx), float(my)
        a.m2x, a.m2y, a.cxy = float(m2x), float(m2y), float(cxy)

    def finalize(self, analysis: dict, analyzer) -> None:
        analysis["landing_footprint"] = self.acc.footprint()


class ImportanceAccumulator(SlabAccumulator):
    """Per-lane log likelihood ratios under the importance tilt. Finalizes
    AFTER the prefix (reads its concatenated metrics): importance runs
    never stream, so the prefix holds every lane."""

    key = "lw"

    def __init__(self, analyzer):
        self.analyzer = analyzer
        self.parts: list = []

    def update(self, ctx: SlabContext) -> None:
        from .importance import log_weights

        self.parts.append(log_weights(
            ctx.sample, self.analyzer.uncertainty_params,
            self.analyzer.scene.motor, self.analyzer.importance_shift,
        )[: ctx.n_s])

    def to_arrays(self, arrays: dict) -> None:
        if self.parts:
            arrays["lw"] = np.concatenate(
                [np.asarray(p) for p in self.parts]
            )

    def restore(self, z, meta) -> None:
        self.parts = [z["lw"]] if "lw" in z else []

    def finalize(self, analysis: dict, analyzer) -> None:
        analysis["importance"] = analyzer._importance_block(
            {k: analysis["metrics"][k] for k in HEADLINE_METRICS},
            analysis["valid_mask"], np.concatenate(self.parts),
        )


class CVAccumulator(SlabAccumulator):
    """Control-variate cross-moments (``mc.cv.CVMoments``), reduced on
    device per slab."""

    key = "cv"

    def __init__(self, analyzer, base_wind):
        from .cv import CVMoments

        self.analyzer = analyzer
        self.base_wind = base_wind
        self.acc = CVMoments()
        self._include_full = None

    def update(self, ctx: SlabContext) -> None:
        from .cv import cv_slab_moments

        if self._include_full is None:
            self._include_full = jnp.ones(ctx.slab, bool)
        include = (self._include_full if ctx.n_s == ctx.slab
                   else jnp.arange(ctx.slab) < ctx.n_s)
        self.acc.add(jax.device_get(cv_slab_moments(
            ctx.sample, ctx.summary, ctx.valid, include,
            self.analyzer.uncertainty_params, self.analyzer.scene.motor,
            self.analyzer._cv_wind_ctrl(ctx.scene_b, ctx.sample,
                                        self.base_wind),
        )))

    def to_arrays(self, arrays: dict) -> None:
        cv = self.acc
        if cv.n > 0:
            arrays["cv.n"] = np.asarray(cv.n)
            for name in ("mz", "mt", "szz", "szt", "stt"):
                arrays["cv." + name] = getattr(cv, name)

    def restore(self, z, meta) -> None:
        from .cv import CVMoments

        cv = CVMoments()
        if "cv.n" in z:
            cv.n = int(z["cv.n"])
            for name in ("mz", "mt", "szz", "szt", "stt"):
                setattr(cv, name, np.array(z["cv." + name], np.float64))
        self.acc = cv

    def finalize(self, analysis: dict, analyzer) -> None:
        from .cv import finalize_cv

        analysis["control_variates"] = finalize_cv(
            self.acc, analyzer._cv_names()
        )


class EnsembleStatsAccumulator(SlabAccumulator):
    """Forecast-ensemble post-stratified moments (``mc.ensemble``): O(K)
    per-member Welford merge; the aligned member-index prefix lives in
    :class:`PrefixAccumulator`."""

    key = "ens"

    def __init__(self, ens_acc):
        self.acc = ens_acc

    def update(self, ctx: SlabContext) -> None:
        self.acc.add(ctx.mem_np, ctx.valid_np, ctx.slab_metrics)

    def to_arrays(self, arrays: dict) -> None:
        from .ensemble import METRICS as ENS_METRICS

        ens = self.acc
        arrays["ens.n_drawn"] = ens.n_drawn
        arrays["ens.n_valid"] = ens.n_valid
        for m in ENS_METRICS:
            arrays[f"ens.n.{m}"] = ens._n[m]
            arrays[f"ens.mean.{m}"] = ens._mean[m]
            arrays[f"ens.m2.{m}"] = ens._m2[m]

    def restore(self, z, meta) -> None:
        from .ensemble import METRICS as ENS_METRICS
        from .ensemble import EnsembleAccumulator

        ens = EnsembleAccumulator(int(z["ens.n_drawn"].size))
        ens.n_drawn = np.array(z["ens.n_drawn"], np.int64)
        ens.n_valid = np.array(z["ens.n_valid"], np.int64)
        for m in ENS_METRICS:
            ens._n[m] = np.array(z[f"ens.n.{m}"], np.int64)
            ens._mean[m] = np.array(z[f"ens.mean.{m}"], np.float64)
            ens._m2[m] = np.array(z[f"ens.m2.{m}"], np.float64)
        self.acc = ens

    def finalize(self, analysis: dict, analyzer) -> None:
        analysis["ensemble"] = self.acc.block()


class RangesAccumulator(SlabAccumulator):
    """Observed dispersion-parameter min/max, reduced ON DEVICE (18
    scalars back per slab, not the 19 MB dispersion SoA)."""

    key = "pranges"

    def __init__(self, analyzer):
        self.analyzer = analyzer
        self.pranges = None

    def update(self, ctx: SlabContext) -> None:
        pr = self.analyzer._parameter_ranges_device(ctx.sample,
                                                    ctx.ranges_mask)
        self.pranges = (pr if self.pranges is None
                        else self.analyzer._merge_ranges(self.pranges, pr))

    def meta_state(self):
        return {"pranges": self.pranges}

    def restore(self, z, meta) -> None:
        self.pranges = meta["pranges"]

    def finalize(self, analysis: dict, analyzer) -> None:
        analysis["parameter_ranges_observed"] = self.pranges or {}


class RecordsAccumulator(SlabAccumulator):
    """Per-sim record dicts, first ``limit`` of each kind. The full
    summary/sample readback happens ONLY while records are still being
    materialized AND the slab has lanes of a kind still needed."""

    key = "records"

    def __init__(self, analyzer, limit: int):
        self.analyzer = analyzer
        self.limit = limit
        self.records: list = []
        self.outlier_records: list = []

    def update(self, ctx: SlabContext) -> None:
        valid_np = ctx.valid_np
        need_valid = len(self.records) < self.limit and valid_np.any()
        need_outlier = (len(self.outlier_records) < self.limit
                        and (~valid_np).any())
        if not (need_valid or need_outlier):
            return
        summary_np, sample_np = ctx.summary_np, ctx.sample_np
        if need_valid:
            self.records.extend(self.analyzer._materialize_records(
                summary_np, sample_np, valid_np, ctx.reasons_np,
                want_valid=True, limit=self.limit - len(self.records),
                offset=ctx.n_done,
            ))
        if need_outlier:
            self.outlier_records.extend(self.analyzer._materialize_records(
                summary_np, sample_np, valid_np, ctx.reasons_np,
                want_valid=False,
                limit=self.limit - len(self.outlier_records),
                offset=ctx.n_done,
            ))

    def meta_state(self):
        return {"records": self.records,
                "outlier_records": self.outlier_records}

    def restore(self, z, meta) -> None:
        self.records = meta["records"]
        self.outlier_records = meta["outlier_records"]

    def finalize(self, analysis: dict, analyzer) -> None:
        analysis["results"] = self.records
        analysis["outliers"] = self.outlier_records


def build_registry(analyzer, *, n_samples: int, slab: int, base_wind,
                   limit: int, streaming: bool, ens_acc) -> list:
    """The ordered accumulator registry for one slabbed run. Order is the
    finalize order: the prefix runs first (importance reads its arrays);
    everything else is independent."""
    cap = analyzer.metrics_sample_cap if streaming else n_samples
    accs: list = [
        PrefixAccumulator(cap, streaming, want_members=ens_acc is not None),
    ]
    if streaming:
        accs.append(
            StreamAccumulator(analyzer.stats_stream_threshold)
        )
    accs.append(ConvergenceAccumulator())
    if analyzer.sampler == "sobol":
        accs.append(QMCAccumulator())
    accs.append(FootprintMomentsAccumulator())
    if analyzer.importance_shift:
        accs.append(ImportanceAccumulator(analyzer))
    if analyzer.control_variates:
        accs.append(CVAccumulator(analyzer, base_wind))
    if ens_acc is not None:
        accs.append(EnsembleStatsAccumulator(ens_acc))
    accs.append(RangesAccumulator(analyzer))
    accs.append(RecordsAccumulator(analyzer, limit))
    return accs
