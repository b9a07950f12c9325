"""Monte Carlo orchestrator: vmap over dispersions, shard over a mesh.

The batched replacement for the reference's ``MonteCarloAnalyzer``
(`/root/reference/rocket_simulation/monte_carlo.py:17-473`):

  reference                               this framework
  ---------------------------------------------------------------------
  ProcessPoolExecutor + pickle            jit(vmap(simulate_summary))
  np.random.seed(i) per sample            jax.random.split per lane
  per-future exception swallowing         diverged/NaN lane masks
  Python loops over result dicts          masked on-device reductions
  deepcopy per perturbed object           one batched Scene pytree
  chunking for "optimized" mode           sharding the batch axis over a
                                          jax.sharding.Mesh (XLA collectives)

The analysis dict keeps the reference's schema (keys at
`monte_carlo.py:461-471`) so reports, plots, and post-hoc CLIs port over.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..engine.config import SimConfig
from ..engine.state import InitialConditions
from ..models.scene import Scene, nominal_scene
from ..utils.logging import get_logger
from .dispersions import UncertaintyParams, sample_dispersions
from .filter import OutlierBounds, decode_reasons, outlier_mask
from .stats import (
    PERCENTILES,
    landing_footprint,
    masked_stats,
    percentile_ci,
)

__all__ = ["MonteCarloAnalyzer"]

log = get_logger("mc")


def _host_stats(values: np.ndarray, mask: np.ndarray) -> dict:
    """NumPy twin of ``masked_stats`` for host-accumulated (slabbed) runs:
    population std, linear-interpolated percentiles (`monte_carlo.py:444-459`),
    plus the beyond-reference order-statistic percentile CIs
    (``mc.stats.percentile_ci``)."""
    vals = values[mask & np.isfinite(values)]
    if vals.size == 0:
        nan = float("nan")
        return {"mean": nan, "std": nan, "min": nan, "max": nan,
                "percentiles": [nan] * len(PERCENTILES),
                "percentile_ci": [[nan, nan]] * len(PERCENTILES)}
    ones = np.ones(vals.shape, bool)
    return {
        "mean": float(vals.mean()),
        "std": float(vals.std()),
        "min": float(vals.min()),
        "max": float(vals.max()),
        "percentiles": [float(v) for v in np.percentile(vals, PERCENTILES)],
        "percentile_ci": percentile_ci(vals, ones),
    }


def _as_ic(initial_conditions) -> InitialConditions:
    if isinstance(initial_conditions, InitialConditions):
        return initial_conditions
    # The reference (simulator.py:134-150) .get()s exactly these four keys
    # and silently ignores anything else — a typo'd key there simulates an
    # all-defaults flight with no warning. Error paths aren't parity
    # surface: reject unknown keys loudly instead.
    unknown = set(initial_conditions) - {
        "position", "velocity", "attitude", "angular_velocity"}
    if unknown:
        raise ValueError(
            f"unknown initial_conditions keys {sorted(unknown)}; valid "
            "keys are position, velocity, attitude, angular_velocity "
            "(or pass an InitialConditions)"
        )
    return InitialConditions.create(
        position=initial_conditions.get("position", (0.0, 0.0, 0.0)),
        velocity=initial_conditions.get("velocity", (0.0, 0.0, 0.0)),
        attitude=initial_conditions.get("attitude", (0.0, 0.0, 0.0)),
        angular_velocity=initial_conditions.get("angular_velocity", (0.0, 0.0, 0.0)),
    )


def _stats_to_py(s: dict) -> dict:
    return {
        "mean": float(s["mean"]),
        "std": float(s["std"]),
        "min": float(s["min"]),
        "max": float(s["max"]),
        "percentiles": [float(v) for v in np.asarray(s["percentiles"])],
    }


@jax.jit
def _footprint_moments_kernel(landing, mask):
    """Per-slab centered landing moments on device (6 scalars back per
    slab, not a [slab,3] readback): n, mean_x, mean_y, M2x, M2y, Cxy about
    the slab's own mean — see ``mc.stats.FootprintAccumulator`` for why
    centered (f32 raw-moment differencing cancels catastrophically)."""
    x, y = landing[:, 0], landing[:, 1]
    m = mask & jnp.isfinite(x) & jnp.isfinite(y)
    n = jnp.sum(m)
    nf = jnp.maximum(n, 1).astype(x.dtype)
    mx = jnp.sum(jnp.where(m, x, 0.0)) / nf
    my = jnp.sum(jnp.where(m, y, 0.0)) / nf
    dx = jnp.where(m, x - mx, 0.0)
    dy = jnp.where(m, y - my, 0.0)
    return n, mx, my, jnp.sum(dx * dx), jnp.sum(dy * dy), jnp.sum(dx * dy)


@jax.jit
def _ranges_kernel(sample, valid) -> dict:
    """Masked per-parameter (min, max) over valid lanes, plus the valid
    count — the device side of ``_parameter_ranges_device``."""
    out = {"__n_valid__": jnp.sum(valid)}
    for name in MonteCarloAnalyzer._RANGE_FIELDS:
        arr = getattr(sample, name)
        m = valid if arr.ndim == 1 else valid[:, None]
        if jnp.issubdtype(arr.dtype, jnp.integer):
            lo_fill = jnp.iinfo(arr.dtype).max
            hi_fill = jnp.iinfo(arr.dtype).min
        else:
            lo_fill, hi_fill = jnp.inf, -jnp.inf
        out[name] = (
            jnp.min(jnp.where(m, arr, lo_fill), axis=0),
            jnp.max(jnp.where(m, arr, hi_fill), axis=0),
        )
    return out


from .resimulate import ResimulationMixin
from .subset_driver import SubsetDriverMixin


class MonteCarloAnalyzer(SubsetDriverMixin, ResimulationMixin):
    """Dispersion analysis over a scene. Mirrors the reference's constructor
    shape (`monte_carlo.py:20-50`) — pass a full ``scene`` or the parts.

    ``mesh``: optional ``jax.sharding.Mesh`` with a ``batch`` axis; the lane
    dimension is sharded across it and statistics reduce with XLA
    collectives. Without a mesh, runs on the default device.
    """

    def __init__(
        self,
        rocket=None,
        motor=None,
        atmosphere=None,
        wind_model=None,
        *,
        scene: Optional[Scene] = None,
        uncertainty_params: UncertaintyParams = UncertaintyParams(),
        sim_config: SimConfig = SimConfig(),
        bounds: OutlierBounds = OutlierBounds(),
        mesh=None,
        max_lanes_per_call: int = 262_144,
        sampler: str = "prng",
        sobol_scrambles: int = 1,
        sobol_wind_modes: int = 0,
        antithetic: bool = False,
        control_variates: bool = False,
        cv_wind_modes: int = 0,
        cv_wind_speed: int = 0,
        importance_shift: Optional[dict] = None,
        two_level_lanes: int = 0,
        persistent_cache: bool = True,
        stats_stream_threshold: int = 4_194_304,
        metrics_sample_cap: int = 1_048_576,
        wind_grid_points: int = 100,
        wind_grid_top: float = 25000.0,
        wind_table_modes: Optional[int] = None,
    ):
        if scene is None:
            if motor is None:
                raise ValueError("provide either scene= or at least a motor")
            scene = nominal_scene(motor)
            if rocket is not None:
                scene = scene.replace(rocket=rocket)
            if atmosphere is not None:
                scene = scene.replace(atmosphere=atmosphere)
            if wind_model is not None:
                scene = scene.replace(wind_model=wind_model)
        if persistent_cache:
            # Cold XLA compiles of the hot loop take minutes; every entry
            # point shares one persistent cache (utils.cache). A
            # config knob (default on) because a library constructor mutating
            # global compiler state is surprising; pass False to opt out.
            from ..utils.cache import enable_persistent_cache

            enable_persistent_cache()
        self.scene = scene
        self.uncertainty_params = uncertainty_params
        self.sim_config = sim_config
        self.bounds = bounds
        self.mesh = mesh
        # Dispersion sampler: "prng" (reference-equivalent) or "sobol"
        # (scrambled quasi-Monte Carlo over the scalar channels — see
        # mc.sample_dispersions). Stored so slabbed runs and by-key lane
        # re-simulation regenerate identical lanes.
        self.sampler = sampler
        # Randomized-QMC replication: >1 partitions each sobol draw into K
        # independently scrambled blocks; block means yield a valid
        # ``qmc_error`` stderr in the analysis (a single scramble's
        # std/sqrt(n) is not a valid QMC error estimate).
        self.sobol_scrambles = sobol_scrambles
        # Turbulence QMC depth: with sampler="sobol", also stratify the top
        # K principal components of each lane's AR(1) wind turbulence (see
        # mc.sample_dispersions sobol_wind_modes). 0 = scalar channels only.
        self.sobol_wind_modes = sobol_wind_modes
        # Antithetic pairing (mc.sample_dispersions): the second half of
        # each draw mirrors the first; variance of batch means drops when
        # metric response is near-linear in the scalar channels.
        self.antithetic = antithetic
        # Regression control variates (mc.cv): adjust the headline means by
        # the fitted linear+quadratic response to the dispersion draws
        # (whose expectations are known exactly), reporting variance-reduced
        # means with delta-method stderr in analysis["control_variates"].
        # Opt-in: it adds one O(d^2) readback per slab and its stderr
        # assumes i.i.d. lanes (prng; for sobol use qmc_error instead).
        self.control_variates = control_variates
        # With control_variates: ALSO use the top-K AR(1) turbulence-mode
        # scores of each lane's realized wind table (+ their squares) as
        # controls (mc.cv.wind_mode_projector) — the turbulence share of
        # full-flight dispersion becomes reducible, the CV counterpart of
        # sobol_wind_modes. Valid under any sampler (known-zero means).
        if cv_wind_modes < 0:
            raise ValueError("cv_wind_modes must be >= 0")
        if cv_wind_modes and not control_variates:
            raise ValueError("cv_wind_modes requires control_variates=True")
        self.cv_wind_modes = cv_wind_modes
        # With control_variates: ALSO use the realized horizontal wind
        # SPEED and ENERGY at this many altitude knots as controls
        # (mc.cv.wind_speed_control_means — exact Rice/quadrature means).
        # These are EVEN in the turbulence, carrying the cross-mode and
        # mean x turbulence structure the per-mode diagonal squares miss;
        # the weather-cocking response is ~|w| (NOTES.md full-flight CV
        # study), so this is the nonlinear-regime counterpart of
        # cv_wind_modes.
        if cv_wind_speed < 0:
            raise ValueError("cv_wind_speed must be >= 0")
        if cv_wind_speed and not control_variates:
            raise ValueError("cv_wind_speed requires control_variates=True")
        self.cv_wind_speed = cv_wind_speed
        self._cv_proj = None  # (grid_key, projector) memo
        self._cv_spd = None   # (grid_key, base_key, idx, means) memo
        # Importance sampling (mc.importance): draw the named Gaussian
        # multiplier channels mean-shifted by the given sigmas and report
        # self-normalized weighted estimates under the NOMINAL distribution
        # in analysis["importance"] — rare-event tails become estimable.
        # The headline stats blocks then describe the SHIFTED population.
        if importance_shift:
            if sampler != "prng" or antithetic:
                raise ValueError(
                    "importance_shift requires sampler='prng', no antithetic"
                )
            if control_variates:
                # the CV controls' exactly-known means are means under the
                # NOMINAL distribution; tilting breaks that premise
                raise ValueError(
                    "importance_shift and control_variates are exclusive"
                )
            self.importance_shift = tuple(sorted(importance_shift.items()))
        else:
            self.importance_shift = ()
        # Two-level bias correction (mc.two_level): with any fast flag set
        # on sim_config, ALSO run this many COUPLED lanes (same dispersion
        # draws) under the run config and its exact-parity twin, and report
        # the measured integration bias plus bias-corrected headline means
        # (the MLMC identity E[f_parity] = E[f_fast] + E[f_parity-f_fast])
        # in analysis["two_level"]. Use when n is large enough that the
        # mean's sampling stderr drops below the tiered-dt bias (crossover
        # n ~ (sigma/bias)^2 — measured in scripts/two_level_check.py).
        if two_level_lanes < 0:
            raise ValueError("two_level_lanes must be >= 0")
        if two_level_lanes:
            from .two_level import FAST_FIELDS, parity_twin

            if parity_twin(sim_config) == sim_config and not wind_table_modes:
                raise ValueError(
                    "two_level_lanes needs at least one fast flag in "
                    f"sim_config (one of {FAST_FIELDS}) or "
                    "wind_table_modes; the config is already exact parity "
                    "— there is no bias to correct"
                )
            if importance_shift:
                # the correction estimates the NOMINAL-population bias;
                # under exponential tilting the headline stats describe the
                # SHIFTED population and the two would not compose
                raise ValueError(
                    "two_level_lanes and importance_shift are exclusive"
                )
        self.two_level_lanes = two_level_lanes
        # Streaming-statistics mode engages above this many lanes (see
        # _run_slabbed); below it the slab loop keeps exact host arrays.
        if stats_stream_threshold < 1 or metrics_sample_cap < 1:
            # cap=0 would leave the per-lane metric lists empty and crash
            # the end-of-run concatenate AFTER the whole simulation; fail
            # at construction instead (found by review, round 3).
            raise ValueError(
                "stats_stream_threshold and metrics_sample_cap must be >= 1"
            )
        self.stats_stream_threshold = stats_stream_threshold
        self.metrics_sample_cap = metrics_sample_cap
        # Synthesized per-lane wind profile grid (reference: 100 points,
        # 0-25 km, `monte_carlo.py:282-288`). Coarser grids cut the dominant
        # memory traffic (the [3,N,B] table read) and sampling cost for runs
        # that don't need 250 m wind resolution.
        self.wind_grid_points = wind_grid_points
        self.wind_grid_top = wind_grid_top
        # Mode-compressed per-lane wind tables (models.wind.WindModes):
        # carry each lane's wind as K AR(1)-mode scores against a shared
        # orthonormal basis instead of the full [N,3] table (table bytes
        # drop ~N/(K+aux) ~ 4x at K=24).
        # Opt-in documented approximation: exact when K >= wind_grid_points
        # (pinned by test), stats drift at the default-recommended K=24
        # pinned like wind_table_bf16's. Applied to the simulation call
        # only — accumulators (CV projections, re-simulation) keep the
        # realized tables.
        if wind_table_modes is not None and wind_table_modes < 1:
            raise ValueError("wind_table_modes must be >= 1 (or None)")
        self.wind_table_modes = wind_table_modes
        self._wind_basis_memo = None  # (cache_key, basis ndarray)
        # Auto-slab threshold: beyond this many lanes the lane axis is
        # processed in per-call slabs with host-side moment accumulation,
        # bounding device memory for the per-lane wind tables + RK4 stage
        # intermediates. The default was chosen for a 16 GB device and has
        # not been re-measured on the GPU.
        self.max_lanes_per_call = max_lanes_per_call

        # Forecast-driven runs (`monte_carlo.py:31-32`, set by
        # `example.py:58-59`). base_wind_profile may be one forecast [N,3]
        # or a member ENSEMBLE [K,N,3] (models.load_wind_ensemble_from_csvs)
        # — each lane then perturbs a uniformly drawn member.
        self.base_altitude_profile = None
        self.base_wind_profile = None

        # Kept for re-simulation (trajectory clouds, per-sim exports).
        self._last_batch = None
        # Single-slot memo for resimulate_trajectories: the reporting
        # pipeline (per-sim exports + 2D cloud + 3D cloud) asks for the
        # SAME first-N lanes three times in a row; each re-simulation is a
        # full trajectory-recording run.
        self._resim_memo = None

    def _compress_for_sim(self, scene_b, base_wind):
        """With ``wind_table_modes=K`` set: a copy of ``scene_b`` whose
        per-lane wind tables are mode-compressed (models.wind.WindModes)
        for the simulation call. The realized-table ``scene_b`` itself is
        untouched — accumulators and re-simulation keep full tables. Shared
        (non-per-lane) wind tables pass through: they are already one
        broadcast table, there are no per-lane bytes to save."""
        k = self.wind_table_modes
        if not k:
            return scene_b
        wind = scene_b.wind
        if jnp.ndim(wind.wind) != 3:
            return scene_b
        from ..models.wind import compress_wind, wind_mode_basis

        grid = np.asarray(wind.altitudes)
        extra = None if base_wind is None else np.asarray(base_wind[1])
        cache_key = (
            int(k), grid.tobytes(),
            None if extra is None else extra.tobytes(),
        )
        if (self._wind_basis_memo is None
                or self._wind_basis_memo[0] != cache_key):
            basis = wind_mode_basis(self.scene.wind_model, grid, k,
                                    extra_profiles=extra)
            self._wind_basis_memo = (cache_key, basis)
        return scene_b.replace(
            wind=compress_wind(wind, self._wind_basis_memo[1])
        )

    # ------------------------------------------------------------------ run
    def run_monte_carlo(
        self,
        initial_conditions,
        n_samples: int = 1000,
        n_processes=None,  # accepted for API parity; parallelism is the mesh
        optimized: bool = False,  # parity flag; there is only the fast path
        seed: int = 0,
        materialize_results: Optional[int] = None,
        chunk_steps: Optional[int] = None,
        lane_slab: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 16,
    ) -> dict:
        """Run ``n_samples`` dispersed flights and analyze.

        Returns the reference-schema analysis dict (`monte_carlo.py:461-471`)
        plus SoA extras (``summary``, ``valid_mask``, ``reasons``,
        ``sample``), a ``performance`` block, and the beyond-reference
        blocks the constructor knobs enable: ``landing_footprint``
        (always), ``control_variates`` (control_variates=True),
        ``importance`` (importance_shift=), ``qmc_error``
        (sobol_scrambles>1 or slabbed sobol runs), ``two_level``
        (two_level_lanes>0 — measured fast-flag bias + corrected
        means), and ``streams``
        (streaming slabbed runs — retained quantile sketches for
        ``mc.exceedance_from_analysis``).

        ``chunk_steps``: execute at most this many RK4 steps per device call
        (host-chunked; see ``engine.simulate_batch_chunked``). Use for large
        full-flight batches on runtimes that bound single-call execution
        time; results match the vmapped path to f32 compilation noise.

        ``lane_slab``: max lanes per device call (default:
        ``self.max_lanes_per_call``). When ``n_samples`` exceeds it, the
        lane axis is auto-slabbed: each slab draws its dispersions from its
        own fold of the run key (so results are independent of slab size),
        statistics accumulate on the host with identical percentile
        semantics, and ``analysis["summary"]`` holds only the per-lane
        headline metrics (not the full FlightSummary SoA) to bound
        device->host traffic. ``run_monte_carlo(n_samples=10_000_000)``
        just works on one chip.

        ``checkpoint_path``: slabbed runs persist their accumulator state
        to this file every ``checkpoint_every`` slabs; if the process dies,
        re-running the SAME call resumes from the last checkpoint with
        bit-identical final results (``mc.slab_checkpoint``). The file is
        removed on successful completion; a checkpoint from a different
        run configuration refuses to load.
        """
        del n_processes, optimized
        if chunk_steps is not None and self.wind_table_modes:
            # the stacked chunked engine consumes WindField tables only;
            # silently dropping the compression the caller asked for would
            # misreport what ran
            raise ValueError(
                "wind_table_modes applies to the component batch path; "
                "it does not compose with chunk_steps"
            )
        ic = _as_ic(initial_conditions)
        base_wind = None
        if self.base_wind_profile is not None and self.base_altitude_profile is not None:
            base_wind = (self.base_altitude_profile, self.base_wind_profile)

        slab = lane_slab if lane_slab is not None else self.max_lanes_per_call
        if checkpoint_path is not None and checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        if n_samples > slab:
            return self._run_slabbed(
                ic, n_samples, slab, seed, materialize_results, chunk_steps,
                base_wind, checkpoint_path, checkpoint_every,
            )
        if checkpoint_path is not None:
            # a single-call run has no slab boundaries to checkpoint at;
            # silently ignoring would deny the crash protection the caller
            # asked for
            raise ValueError(
                "checkpoint_path applies to slabbed runs (n_samples > "
                "lane_slab); this run fits one device call"
            )

        t_start = time.time()
        key = jax.random.PRNGKey(seed)
        scene_b, ic_b, sample = sample_dispersions(
            key, self.scene, ic, self.uncertainty_params, n_samples,
            base_wind=base_wind, sampler=self.sampler,
            sobol_scrambles=self.sobol_scrambles,
            sobol_wind_modes=self.sobol_wind_modes,
            antithetic=self.antithetic,
            importance_shift=self.importance_shift,
            wind_grid_points=self.wind_grid_points,
            wind_grid_top=self.wind_grid_top,
        )

        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            shard = NamedSharding(self.mesh, P("batch"))

            # Classify batched leaves by GAINED DIMENSION vs the base tree
            # (same rule as scene_in_axes / make_global_batch): the bare
            # shape[0]==n heuristic would shard a SHARED table whose length
            # happens to equal n (e.g. the 100-knot wind grid at n=100),
            # putting collectives into the hot loop.
            def put(x, base):
                if jnp.ndim(x) > jnp.ndim(base):
                    return jax.device_put(x, shard)
                return x
            scene_b = jax.tree.map(put, scene_b, self.scene)
            ic_b = jax.tree.map(put, ic_b, ic)

        if chunk_steps is not None:
            from ..engine.simulate import simulate_batch_chunked

            summary = simulate_batch_chunked(
                scene_b, ic_b, self.sim_config, chunk_steps=chunk_steps
            )
        else:
            # Component-form batch path (engine/batch.py): identical results
            # to jit(vmap(simulate_summary)) on flat [B] carries.
            from ..engine.batch import simulate_summary_batch

            summary = simulate_summary_batch(
                self._compress_for_sim(scene_b, base_wind), ic_b,
                self.sim_config,
            )
        valid, reasons = outlier_mask(summary, self.bounds)

        stats = {
            "apogee_altitude": masked_stats(summary.apogee_altitude, valid),
            "range": masked_stats(summary.range, valid),
            "flight_time": masked_stats(summary.flight_time, valid),
        }
        # Force everything to host once (also serves as the sync point).
        summary_np = jax.tree.map(np.asarray, summary)
        valid_np = np.asarray(valid)
        reasons_np = np.asarray(reasons)
        stats_py = {k: _stats_to_py(v) for k, v in stats.items()}
        for k in stats_py:
            # beyond-reference: distribution-free CIs on the reported
            # percentiles (host-side — the per-lane arrays are already
            # read back; see mc.stats.percentile_ci for the i.i.d. caveat)
            stats_py[k]["percentile_ci"] = percentile_ci(
                getattr(summary_np, k), valid_np
            )
        elapsed = time.time() - t_start

        self._last_batch = (scene_b, ic_b)
        self._resim_memo = None

        n_valid = int(valid_np.sum())
        n_outliers = n_samples - n_valid
        sample_np = jax.tree.map(np.asarray, sample)

        # Landing-dispersion footprint (mean impact point, covariance,
        # 95/99% ellipses, CEP) over the same lanes as the range stats
        # (final position of every valid lane) — a deliverable the
        # reference never computes from its scalar range list.
        lp = np.asarray(summary_np.landing_position)
        fin = valid_np & np.isfinite(lp[:, 0]) & np.isfinite(lp[:, 1])
        footprint = landing_footprint(lp[fin, 0], lp[fin, 1])

        analysis = {
            "n_samples": n_valid,
            "n_failed": 0,  # lanes cannot "fail"; divergence is an outlier
            "n_outliers": n_outliers,
            "apogee_altitude": stats_py["apogee_altitude"],
            "range": stats_py["range"],
            "flight_time": stats_py["flight_time"],
            "landing_footprint": footprint,
            "parameter_ranges_observed": self._parameter_ranges(sample_np, valid_np),
            "summary": summary_np,
            "sample": sample_np,
            "valid_mask": valid_np,
            "reasons": reasons_np,
            "initial_conditions": ic,
            "performance": {
                "total_time": elapsed,
                "simulations_per_second": n_samples / max(elapsed, 1e-9),
                "cores_used": (
                    self.mesh.devices.size if self.mesh is not None
                    else jax.device_count()
                ),
            },
        }
        from .ensemble import EnsembleAccumulator

        ens_acc = EnsembleAccumulator.from_base_wind(base_wind)
        if ens_acc is not None:
            # post-stratified forecast-ensemble stats (mc.ensemble)
            ens_acc.add(
                np.asarray(sample_np.wind_member), valid_np,
                {k: np.asarray(getattr(summary_np, k)) for k in
                 ("apogee_altitude", "range", "flight_time")},
            )
            analysis["ensemble"] = ens_acc.block()
            analysis["wind_members"] = np.asarray(sample_np.wind_member)
        if self.importance_shift:
            from .importance import log_weights

            analysis["importance"] = self._importance_block(
                {k: getattr(summary_np, k) for k in
                 ("apogee_altitude", "range", "flight_time")},
                valid_np,
                log_weights(sample_np, self.uncertainty_params,
                            self.scene.motor, self.importance_shift),
            )

        if self.control_variates:
            from .cv import CVMoments, cv_slab_moments, finalize_cv

            acc = CVMoments()
            acc.add(jax.device_get(cv_slab_moments(
                sample, summary, valid, jnp.ones(n_samples, bool),
                self.uncertainty_params, self.scene.motor,
                self._cv_wind_ctrl(scene_b, sample, base_wind),
            )))
            analysis["control_variates"] = finalize_cv(acc, self._cv_names())

        if self.sampler == "sobol" and self.sobol_scrambles > 1:
            K = self.sobol_scrambles
            block = n_samples // K
            bm = {}
            for name in ("apogee_altitude", "range", "flight_time"):
                arr = np.asarray(getattr(summary_np, name))
                bm[name] = [
                    float(np.mean(arr[i * block:(i + 1) * block][
                        valid_np[i * block:(i + 1) * block]
                    ])) if valid_np[i * block:(i + 1) * block].any()
                    else float("nan")
                    for i in range(K)
                ]
            analysis["qmc_error"] = self._qmc_error(bm)

        if self.two_level_lanes:
            analysis["two_level"] = self._two_level(
                ic, seed, base_wind, analysis
            )

        # Same default cap as the slab path: materializing a Python dict
        # per lane at 100k+ lanes costs tens of seconds of host time and GBs
        # of RAM when the caller only wants statistics. Pass
        # materialize_results=n_samples for the old exhaustive behavior.
        limit = 1000 if materialize_results is None else materialize_results
        analysis["results"] = self._materialize_records(
            summary_np, sample_np, valid_np, reasons_np, want_valid=True, limit=limit
        )
        analysis["outliers"] = self._materialize_records(
            summary_np, sample_np, valid_np, reasons_np, want_valid=False, limit=limit
        )
        return analysis

    def run_to_precision(
        self,
        initial_conditions,
        *,
        criteria,
        max_samples: int,
        min_samples: int = 0,
        seed: int = 0,
        lane_slab: Optional[int] = None,
        materialize_results: Optional[int] = None,
        chunk_steps: Optional[int] = None,
    ) -> dict:
        """Sequential Monte Carlo: run slabs until every criterion is met.

        The reference can only run a FIXED ``n_samples``
        (`monte_carlo.py:52`) — choosing it is the user's problem. This
        states the precision the decision needs instead: ``criteria`` is
        a list of ``mc.sequential`` criteria (or their spec dicts —
        ``{"metric": m, "mean_stderr": x}``,
        ``{"metric": m, "exceed": t, "p_limit": p}``,
        ``{"metric": m, "exceed": t, "ci_halfwidth": h}``), checked after
        every ``lane_slab``-sized slab; the run stops at the first slab
        boundary where ALL hold (but never before ``min_samples`` lanes),
        or at ``max_samples``.

        Stopping early is EXACT, not approximate: slab k's dispersions
        depend only on ``(key, k, slab)``, so the analysis returned is
        bit-identical to ``run_monte_carlo(n_samples=n_used,
        lane_slab=<same slab>)`` (pinned by test; slab size is part of the
        determinism key). The analysis carries a ``"sequential"`` block:
        per-criterion
        report (realized stderr/CI/decision), ``n_used``, ``max_samples``,
        ``stopped_early``, ``satisfied``. Criterion counts treat valid
        lanes as i.i.d. — under ``sampler="sobol"``/``antithetic`` the
        stop is conservative (see ``mc.sequential`` for this and the
        optional-stopping caveat).
        """
        from .sequential import parse_criterion

        if not criteria:
            raise ValueError("criteria must be a non-empty list")
        crits = [parse_criterion(c) for c in criteria]
        if self.sampler != "sobol":
            bad = [c for c in crits
                   if getattr(c, "requires_sobol", False)]
            if bad:
                raise ValueError(
                    "qmc_mean_stderr criteria need sampler='sobol' (slab "
                    "means are independent RQMC replicates only under the "
                    "per-slab Owen scrambles); on prng draws use "
                    "mean_stderr, which is valid AND tighter there"
                )
        if self.importance_shift:
            raise ValueError(
                "run_to_precision counts unweighted lanes; "
                "importance-sampled runs need weighted estimators (and IS "
                "exists to make n small) — use run_monte_carlo"
            )
        if max_samples < 1:
            raise ValueError("max_samples must be >= 1")
        if min_samples > max_samples:
            raise ValueError("min_samples must be <= max_samples")
        ic = _as_ic(initial_conditions)
        base_wind = None
        if (self.base_wind_profile is not None
                and self.base_altitude_profile is not None):
            base_wind = (self.base_altitude_profile,
                         self.base_wind_profile)
        slab = lane_slab if lane_slab is not None \
            else self.max_lanes_per_call

        def stop_rule(slab_metrics, valid_np, n_done):
            for c in crits:
                c.update(slab_metrics[c.metric][valid_np])
            return all(c.satisfied() for c in crits)

        analysis = self._run_slabbed(
            ic, max_samples, slab, seed, materialize_results, chunk_steps,
            base_wind, stop_rule=stop_rule, min_samples=min_samples,
        )
        n_used = int(analysis["n_total"])
        analysis["sequential"] = {
            "max_samples": int(max_samples),
            "min_samples": int(min_samples),
            "lane_slab": int(slab),
            "n_used": n_used,
            "stopped_early": n_used < max_samples,
            "satisfied": all(c.satisfied() for c in crits),
            "criteria": [c.block() for c in crits],
        }
        return analysis

    def _cv_wind_ctrl(self, scene_b, sample, base_wind):
        """The wind_ctrl pytree for mc.cv wind-table controls (None when
        both cv_wind_modes and cv_wind_speed are off). The [N,K] projector
        comes from a host-side SVD of the AR(1) transfer matrix; the
        wind-speed knot means from Rice/quadrature — both memoized per
        grid (+ base profile for the means)."""
        if not (self.cv_wind_modes or self.cv_wind_speed):
            return None
        from .cv import wind_mode_projector, wind_speed_ctrl_leaves

        alt = scene_b.wind.altitudes
        alt_np = np.asarray(alt, np.float64)
        base_np = None if base_wind is None else np.asarray(
            base_wind[1], np.float64
        )
        # memo on the FULL grid (a forecast grid can share length and
        # endpoints with a different interior spacing — a stale projector
        # would silently break the scores' exact standard-normality)
        grid_stale = (self._cv_proj is None
                      or self._cv_proj[0].shape != alt_np.shape
                      or not np.array_equal(self._cv_proj[0], alt_np))
        if self.cv_wind_modes and grid_stale:
            self._cv_proj = (alt_np, jnp.asarray(wind_mode_projector(
                self.scene.wind_model, alt_np, self.cv_wind_modes
            ), alt.dtype))
        ctrl = {
            "wind": scene_b.wind.wind,
            "ws": sample.wind_speed,
            "wd": sample.wind_direction,
            "proj": self._cv_proj[1] if self.cv_wind_modes else None,
            "alt": alt,
            "model": self.scene.wind_model,
            "base": None if base_wind is None else base_wind[1],
        }
        if self.cv_wind_speed:
            spd_stale = (
                self._cv_spd is None
                or self._cv_spd[0].shape != alt_np.shape
                or not np.array_equal(self._cv_spd[0], alt_np)
                or (self._cv_spd[1] is None) != (base_np is None)
                or (base_np is not None
                    and not np.array_equal(self._cv_spd[1], base_np))
            )
            if spd_stale:
                leaves, idx = wind_speed_ctrl_leaves(
                    self.uncertainty_params, self.scene.wind_model, alt_np,
                    self.cv_wind_speed, base=base_np, dtype=alt.dtype,
                )
                self._cv_spd = (alt_np, base_np, idx, leaves)
            ctrl.update(self._cv_spd[3])
        return ctrl

    def _importance_block(self, values_by_name: dict, valid_np, lw) -> dict:
        """The ``analysis["importance"]`` block, shared by the single-call
        and slabbed layouts: shift, per-lane log-weights, and weighted
        nominal-distribution means per headline metric. (The headline
        stats blocks describe the SHIFTED population by design.)"""
        from .importance import weighted_mean

        imp = {
            "shift": dict(self.importance_shift),
            "log_weights": lw,
            "note": "self-normalized IS estimates under the nominal "
                    "distribution; use mc.importance.weighted_tail or "
                    "exceedance_from_analysis for tail probabilities",
        }
        for kname, vals in values_by_name.items():
            imp[kname] = weighted_mean(vals, valid_np, lw)
        return imp

    def _two_level(self, ic, seed, base_wind, analysis) -> dict:
        """``analysis["two_level"]``: measured fast-flag integration bias
        (small coupled parity batch — mc.two_level) plus bias-corrected
        headline means. The corrected stderr combines the main run's
        sampling stderr with the correction's own (the correction batch is
        key-decorrelated from every main slab, so variances add).

        The main-run term uses the i.i.d. formula std/sqrt(n), which is
        only the mean's sampling error for ``sampler="prng"`` without
        antithetic pairing: antithetic lanes are pairwise dependent
        (std/sqrt(n) OVERSTATES the error by the pairing's VR factor) and
        sobol lanes are stratified (use ``qmc_error`` there — same caveat
        mc.cv documents for its stderr). For those samplers the corrected
        MEAN is still exact, so it is kept and ``corrected_stderr`` is
        omitted (None) with a ``stderr_note`` saying why.
        """
        from .two_level import METRICS, two_level_block

        block = two_level_block(
            self.scene, ic, self.sim_config, self.two_level_lanes,
            jax.random.PRNGKey(seed), params=self.uncertainty_params,
            bounds=self.bounds, base_wind=base_wind,
            wind_grid_points=self.wind_grid_points,
            wind_grid_top=self.wind_grid_top,
            # wind_table_modes runs compress the correction's FAST leg the
            # same way the main run simulated, so the measured bias covers
            # the compression truncation too (r5); None when modes are off
            fast_transform=(
                (lambda sb: self._compress_for_sim(sb, base_wind))
                if self.wind_table_modes else None
            ),
        )
        iid_main = self.sampler == "prng" and not self.antithetic
        if not iid_main:
            block["stderr_note"] = (
                "corrected_stderr omitted: the main run's lanes are not "
                f"i.i.d. (sampler={self.sampler!r}, "
                f"antithetic={self.antithetic}), so std/sqrt(n) is not its "
                "mean's sampling error — use qmc_error for sobol; the "
                "corrected_mean and bias/bias_stderr remain valid"
            )
        n_main = max(int(analysis["n_samples"]), 1)
        for k in METRICS:
            st = analysis[k]
            block[k]["corrected_mean"] = float(st["mean"]) + block[k]["bias"]
            if iid_main:
                main_stderr = float(st["std"]) / np.sqrt(n_main)
                block[k]["corrected_stderr"] = float(
                    np.hypot(main_stderr, block[k]["bias_stderr"])
                )
            else:
                block[k]["corrected_stderr"] = None
        return block

    def _cv_names(self) -> list:
        """Control names matching the control matrix actually built: the
        projector may clamp cv_wind_modes to the grid size, and the name
        list must clamp identically or every beta after the boundary would
        be silently mislabeled (found by review, round 3)."""
        from .cv import control_names

        k_eff = 0
        if self.cv_wind_modes and self._cv_proj is not None:
            k_eff = int(self._cv_proj[1].shape[1])
        spd_alts = ()
        if self.cv_wind_speed and self._cv_spd is not None:
            spd_alts = tuple(self._cv_spd[0][self._cv_spd[2]])
        return control_names(self.uncertainty_params, self.scene.motor,
                             k_eff, spd_alts)

    def run_optimized_monte_carlo(self, initial_conditions, n_samples=1000,
                                  chunk_size=None, **kw) -> dict:
        """API parity with `monte_carlo.py:92-154` — the vmapped path IS the
        optimized path; ``chunk_size`` is meaningless on a device mesh."""
        del chunk_size
        return self.run_monte_carlo(initial_conditions, n_samples, **kw)

    @staticmethod
    def _qmc_error(block_means: dict) -> dict:
        """Randomized-QMC error bars: ``block_means[metric]`` are means over
        independently scrambled Sobol blocks (i.i.d. estimates of the
        target); stderr = std(blocks, ddof=1)/sqrt(K)."""
        out = {}
        for name, means in block_means.items():
            m = np.asarray([x for x in means if np.isfinite(x)], float)
            stderr = (
                float(m.std(ddof=1) / np.sqrt(m.size)) if m.size > 1
                else float("nan")
            )
            out[name] = {"block_means": m.tolist(), "mean_stderr": stderr}
        return out

    # ---------------------------------------------------------- slab loop
    def _run_slabbed(self, ic, n_samples, slab, seed, materialize_results,
                     chunk_steps, base_wind, checkpoint_path=None,
                     checkpoint_every=16, stop_rule=None,
                     min_samples=0) -> dict:
        """Lane-slabbed Monte Carlo: bounded per-call device memory/time.

        Each slab's dispersions come from ``fold_in(key, slab_idx)``; host
        accumulation reproduces the single-call statistics exactly (same
        percentile rule, population std). Replaces the reference's chunked
        "optimized" mode (`monte_carlo.py:92-154`) at scales its process
        pool could never reach.

        Beyond ``stats_stream_threshold`` lanes, per-lane accumulation
        switches to STREAMING mode with O(slab) host memory: moments and
        min/max accumulate exactly, percentiles come from a mergeable
        quantile sketch (``mc.stats.StreamingStats``; rank error
        ~1/(2*max_centroids) of mass — <0.1% of sigma on unimodal metrics,
        pinned by test; see the sketch's multi-modal caveat), and
        ``metrics``/``valid_mask``/``reasons`` hold only the first
        ``metrics_sample_cap`` lanes, flagged by
        ``analysis["metrics_is_sample"]``. For prng runs that prefix is an
        unbiased i.i.d. sample (lanes are keyed independently). For
        sobol/antithetic runs each lane is still marginally unbiased but
        the prefix is NOT independent (a scrambled-Sobol prefix is
        negatively correlated, and an antithetic prefix drops mirror
        partners), so variance estimates computed from it are biased —
        use the streamed stats blocks, which see every lane. A 100M-lane
        run no longer concatenates 4x100M host arrays and sorts them.
        """
        t_start = time.time()
        key = jax.random.PRNGKey(seed)
        # Record materialization at 10M+ lanes would build millions of
        # Python dicts; slabbed runs default to the first 1000 of each kind.
        limit = 1000 if materialize_results is None else materialize_results

        streaming = n_samples > self.stats_stream_threshold
        if streaming and self.importance_shift:
            # weighted tail estimators need every lane's (weight, metric)
            # pair; IS exists to make n SMALL, so this is a config error,
            # not a capability gap
            raise ValueError(
                "importance_shift runs need per-lane weights: keep "
                "n_samples <= stats_stream_threshold (IS makes small n "
                "sufficient; that is its purpose)"
            )
        # Forecast-ensemble post-stratified stats (mc.ensemble): O(K)
        # per-member moments + a capped member-index prefix aligned with
        # the retained metrics. K=1 "ensembles" are single forecasts.
        from .ensemble import EnsembleAccumulator
        from .slab_accumulators import SlabContext, build_registry

        ens_acc = EnsembleAccumulator.from_base_wind(base_wind)
        # Each accumulation concern (prefix, streams, CV, QMC, ensemble,
        # footprint, importance, convergence, ranges, records) is one
        # registry object with its own update/checkpoint/finalize —
        # mc.slab_accumulators. This loop only drives them.
        accs = build_registry(self, n_samples=n_samples, slab=slab,
                              base_wind=base_wind, limit=limit,
                              streaming=streaming, ens_acc=ens_acc)
        by_key = {a.key: a for a in accs}
        n_done = 0
        n_valid_total = 0
        slab_idx = 0
        n_slabs = -(-n_samples // slab)
        ckpt_fp = None
        if checkpoint_path:
            from .slab_checkpoint import (load_slab_state, run_fingerprint,
                                          save_slab_state)

            ckpt_fp = run_fingerprint(self, ic, n_samples, slab, seed,
                                      base_wind, chunk_steps, limit)
            st = load_slab_state(checkpoint_path, ckpt_fp, accs)
            if st is not None:
                # Resume is EXACT: slab k's dispersions depend only on
                # (key, k, slab), and every accumulator is a deterministic
                # host-side merge — pinned bit-identical to an
                # uninterrupted run by tests/test_slab_checkpoint.py.
                n_done, slab_idx = st["n_done"], st["slab_idx"]
                n_valid_total = st["n_valid_total"]
                log.info("resumed from %s: slab %d/%d (%d lanes done)",
                         checkpoint_path, slab_idx, n_slabs, n_done)
        while n_done < n_samples:
            n_s = min(slab, n_samples - n_done)
            # Always draw a FULL slab and drop the excess host-side: a
            # ragged final slab is a different XLA program (a whole
            # recompile for the tail of a 10M run). Lane values
            # for a given global id depend on (key, slab_idx, slab) only.
            scene_b, ic_b, sample = sample_dispersions(
                jax.random.fold_in(key, slab_idx), self.scene, ic,
                self.uncertainty_params, slab, base_wind=base_wind,
                sampler=self.sampler,
                sobol_scrambles=self.sobol_scrambles,
                sobol_wind_modes=self.sobol_wind_modes,
                antithetic=self.antithetic,
                importance_shift=self.importance_shift,
                wind_grid_points=self.wind_grid_points,
                wind_grid_top=self.wind_grid_top,
            )
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                shard = NamedSharding(self.mesh, P("batch"))
                put = lambda x, base: (
                    jax.device_put(x, shard)
                    if jnp.ndim(x) > jnp.ndim(base) else x
                )
                scene_b = jax.tree.map(put, scene_b, self.scene)
                ic_b = jax.tree.map(put, ic_b, ic)

            if chunk_steps is not None:
                from ..engine.simulate import simulate_batch_chunked

                summary = simulate_batch_chunked(
                    scene_b, ic_b, self.sim_config, chunk_steps=chunk_steps
                )
            else:
                from ..engine.batch import simulate_summary_batch

                summary = simulate_summary_batch(
                    self._compress_for_sim(scene_b, base_wind), ic_b,
                    self.sim_config,
                )
            # Globalize the per-slab lane ids: dispersions stamps
            # random_seed = arange(slab) (slab-LOCAL); records and parameter
            # ranges must report the GLOBAL id so seed == simulation_id
            # holds across slabs exactly as in a single-call run.
            sample = sample.replace(random_seed=sample.random_seed + n_done)
            valid, reasons = outlier_mask(summary, self.bounds)
            # Padding-lane mask: only the final ragged slab needs it — the
            # extra eager device ops (~3 dispatches) would otherwise
            # run on every slab for a mask that is all-True.
            ranges_mask = (
                valid if n_s == slab else valid & (jnp.arange(slab) < n_s)
            )

            ctx = SlabContext(summary=summary, sample=sample,
                              scene_b=scene_b, valid=valid, reasons=reasons,
                              ranges_mask=ranges_mask, n_s=n_s, slab=slab,
                              n_done=n_done)
            # Host readback (the slow path) happens lazily inside ctx —
            # once per array, only if some accumulator asks.
            n_valid_total += int(ctx.valid_np.sum())
            ctx.n_valid_total = n_valid_total
            for acc in accs:
                acc.update(ctx)

            n_done += n_s
            slab_idx += 1
            log.info("slab %d/%d: %d/%d lanes", slab_idx, n_slabs, n_done,
                     n_samples)
            if stop_rule is not None:
                # Criteria fold in EVERY slab (their report blocks must see
                # all the data); truncation fires only mid-run. Stopping
                # after slab k is exactly the run that asked for k*slab
                # lanes — slab draws depend on (key, slab_idx, slab) only.
                met = stop_rule(ctx.slab_metrics, ctx.valid_np, n_done)
                if met and min_samples <= n_done < n_samples:
                    log.info(
                        "sequential stop: criteria met after slab %d "
                        "(%d of %d budgeted lanes)",
                        slab_idx, n_done, n_samples,
                    )
                    n_samples = n_done
                    n_slabs = slab_idx
            if (ckpt_fp is not None and n_done < n_samples
                    and slab_idx % checkpoint_every == 0):
                save_slab_state(checkpoint_path, {
                    "n_done": n_done, "slab_idx": slab_idx,
                    "n_valid_total": n_valid_total,
                }, accs, ckpt_fp)
                log.info("checkpoint written: %s (slab %d/%d)",
                         checkpoint_path, slab_idx, n_slabs)

        if ckpt_fp is not None and os.path.exists(checkpoint_path):
            os.remove(checkpoint_path)  # completed: nothing left to resume

        elapsed = time.time() - t_start

        self._resim_memo = None
        self._last_batch = {
            "slabbed": True, "key": key, "slab": slab,
            "n_samples": n_samples, "base_wind": base_wind, "ic": ic,
        }

        n_valid = n_valid_total
        prefix = by_key["prefix"]
        if streaming:
            stats_blocks = by_key["stream"].stats_blocks()
        else:
            metrics_all, valid_all, _ = prefix.concatenated()
            stats_blocks = {
                k: _host_stats(metrics_all[k], valid_all)
                for k in ("apogee_altitude", "range", "flight_time")
            }
        analysis = {
            "n_samples": n_valid,
            "n_failed": 0,
            "n_outliers": n_samples - n_valid,
            "apogee_altitude": stats_blocks["apogee_altitude"],
            "range": stats_blocks["range"],
            "flight_time": stats_blocks["flight_time"],
            # Slabbed runs keep per-lane headline metrics, not the full
            # FlightSummary SoA (bounded host memory + readback traffic).
            "summary": None,
            # Streaming-only blocks default to None; StreamAccumulator
            # overwrites them when engaged.
            "streams": None,
            "tail_reservoirs": None,
            "n_total": n_samples,
            "sample": None,
            "initial_conditions": ic,
            "performance": {
                "total_time": elapsed,
                "simulations_per_second": n_samples / max(elapsed, 1e-9),
                "cores_used": (
                    self.mesh.devices.size if self.mesh is not None
                    else jax.device_count()
                ),
            },
        }
        # Registry order = finalize order (the importance block reads the
        # prefix's concatenated metrics; everything else is independent).
        for acc in accs:
            acc.finalize(analysis, self)
        if self.two_level_lanes:
            analysis["two_level"] = self._two_level(
                ic, seed, base_wind, analysis
            )
        return analysis

    _RANGE_FIELDS = (
        "initial_position_offset", "initial_velocity_offset",
        "initial_attitude_offset", "initial_angular_velocity_offset",
        "mass_multiplier", "thrust_multiplier", "wind_speed",
        "wind_direction", "density_multiplier", "random_seed",
    )

    @classmethod
    def _parameter_ranges_device(cls, sample, valid) -> dict:
        """On-device masked min/max per dispersion parameter: one jitted
        call + one small readback per slab, vs hauling the full 19 MB
        dispersion SoA to the host (`_parameter_ranges` semantics)."""
        reduced = jax.device_get(_ranges_kernel(sample, valid))
        n_valid = reduced.pop("__n_valid__")
        if int(n_valid) == 0:
            return {}
        return {
            name: {"min": mn.tolist(), "max": mx.tolist()}
            for name, (mn, mx) in reduced.items()
        }

    @staticmethod
    def _merge_ranges(a: dict, b: dict) -> dict:
        if not a:
            return b
        if not b:
            return a
        out = {}
        for name in a.keys() | b.keys():
            if name not in a:
                out[name] = b[name]
            elif name not in b:
                out[name] = a[name]
            else:
                out[name] = {
                    "min": np.minimum(a[name]["min"], b[name]["min"]).tolist(),
                    "max": np.maximum(a[name]["max"], b[name]["max"]).tolist(),
                }
        return out

    # ------------------------------------------------------------ helpers
    @staticmethod
    def _parameter_ranges(sample_np, valid_np) -> dict:
        """Observed min/max of each dispersion parameter over valid lanes
        (`monte_carlo.py:424-441`)."""
        out = {}
        if valid_np.sum() == 0:
            return out
        for name in MonteCarloAnalyzer._RANGE_FIELDS:
            arr = getattr(sample_np, name)[valid_np]
            out[name] = {
                "min": arr.min(axis=0).tolist(),
                "max": arr.max(axis=0).tolist(),
            }
        return out

    @staticmethod
    def _materialize_records(summary_np, sample_np, valid_np, reasons_np,
                             want_valid: bool, limit: int,
                             offset: int = 0) -> list:
        """Light per-sim records (reference's per-result dicts minus the full
        histories, which `resimulate_trajectories` regenerates on demand).
        ``offset``: global id of this batch's lane 0 (slabbed runs)."""
        idx = np.nonzero(valid_np if want_valid else ~valid_np)[0][:limit]
        records = []
        for i in idx:
            rec = {
                "simulation_id": int(i) + offset,
                "apogee_altitude": float(summary_np.apogee_altitude[i]),
                "apogee_time": float(summary_np.apogee_time[i]),
                "range": float(summary_np.range[i]),
                "flight_time": float(summary_np.flight_time[i]),
                "max_speed": float(summary_np.max_speed[i]),
                "landing_position": summary_np.landing_position[i].tolist(),
                "rail_exit_speed": float(summary_np.rail.rail_exit_speed[i]),
                "rail_exit_time": float(summary_np.rail.rail_exit_time[i]),
                "parachute_deployed": bool(summary_np.parachute_deployed[i]),
                "parameters": {
                    "initial_position_offset": sample_np.initial_position_offset[i].tolist(),
                    "initial_velocity_offset": sample_np.initial_velocity_offset[i].tolist(),
                    "initial_attitude_offset": sample_np.initial_attitude_offset[i].tolist(),
                    "initial_angular_velocity_offset": sample_np.initial_angular_velocity_offset[i].tolist(),
                    "mass_multiplier": float(sample_np.mass_multiplier[i]),
                    "thrust_multiplier": float(sample_np.thrust_multiplier[i]),
                    "wind_speed": float(sample_np.wind_speed[i]),
                    "wind_direction": float(sample_np.wind_direction[i]),
                    "density_multiplier": float(sample_np.density_multiplier[i]),
                    "random_seed": int(sample_np.random_seed[i]),
                },
            }
            if not want_valid:
                rec["outlier_reasons"] = decode_reasons(int(reasons_np[i]))
            records.append(rec)
        return records
