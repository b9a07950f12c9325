"""Determinism-by-key lane re-simulation + the flight-envelope driver.

Extracted from mc/analyzer.py (round 4, god-module slimming): the
MonteCarloAnalyzer methods that re-create selected Monte Carlo lanes from
the run key (slabbed or single-call), re-simulate them with trajectory
recording, and reduce recorded chunks to time-binned population envelopes
(``mc.envelope``). Mixed into the analyzer class so the public API is
unchanged: ``analyzer.lane_scenes`` / ``resimulate_trajectories`` /
``flight_envelope``.

Replaces the reference's keep-every-history strategy
(`monte_carlo.py:296-302,510-517`) with regenerate-on-demand.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..engine.config import SimConfig
from .dispersions import sample_dispersions, select_lane

__all__ = ["ResimulationMixin"]


class ResimulationMixin:
    """Trajectory re-creation methods shared into ``MonteCarloAnalyzer``."""

    def lane_scenes(self, lane_ids) -> list:
        """The single-lane perturbed Scene for each global lane id, for both
        batch layouts (single-call and auto-slabbed). Slabbed runs re-create
        each touched slab's dispersions by key (same padded draw as
        ``_resimulate_slabbed``) and select the slab-local lane."""
        if self._last_batch is None:
            raise RuntimeError("run_monte_carlo first")
        if isinstance(self._last_batch, dict) and self._last_batch.get("slabbed"):
            info = self._last_batch
            slab = info["slab"]
            ids = np.asarray(lane_ids, dtype=np.int64)
            out = {}
            for slab_idx in np.unique(ids // slab):
                scene_b, _, _ = sample_dispersions(
                    jax.random.fold_in(info["key"], int(slab_idx)),
                    self.scene, info["ic"], self.uncertainty_params, slab,
                    base_wind=info["base_wind"], sampler=self.sampler,
                    sobol_scrambles=self.sobol_scrambles,
                    sobol_wind_modes=self.sobol_wind_modes,
                    antithetic=self.antithetic,
                    importance_shift=self.importance_shift,
                    wind_grid_points=self.wind_grid_points,
                    wind_grid_top=self.wind_grid_top,
                )
                for g in ids[ids // slab == slab_idx]:
                    out[int(g)] = select_lane(
                        scene_b, self.scene, int(g % slab)
                    )
            return [out[int(g)] for g in ids]
        scene_b, _ = self._last_batch
        return [select_lane(scene_b, self.scene, int(i)) for i in lane_ids]


    def resimulate_trajectories(self, lane_ids, sim_config: Optional[SimConfig] = None):
        """Re-run selected lanes with full trajectory recording, under the
        SAME SimConfig the Monte Carlo ran (tiered-dt flags included).

        Determinism-by-key makes any lane exactly re-creatable
        (the batched version of the reference's persist-every-trajectory
        strategy, `monte_carlo.py:510-517`): the Monte Carlo pass stores only
        summaries, and plotting/export re-simulates the handful of lanes it
        needs. Recording runs on the component core
        (``engine.batch.simulate_flight_batch``) — the exact engine the MC
        measured — so re-simulated summaries reproduce the MC metrics to
        float noise, mirroring the reference's one engine that records while
        it integrates (`simulator.py:208-293`). Returns
        ``(summary, trajectory)`` batched over ``lane_ids``.
        """
        from ..engine.batch import simulate_flight_batch

        if self._last_batch is None:
            raise RuntimeError("run_monte_carlo first")
        memo_key = (tuple(int(i) for i in lane_ids),
                    sim_config or self.sim_config)
        if self._resim_memo is not None and self._resim_memo[0] == memo_key:
            return self._resim_memo[1]
        if isinstance(self._last_batch, dict) and self._last_batch.get("slabbed"):
            out = self._resimulate_slabbed(lane_ids, sim_config)
            self._resim_memo = (memo_key, out)
            return out
        scene_sel, ic_sel = self._select_lanes(lane_ids)
        out = simulate_flight_batch(
            scene_sel, ic_sel, sim_config or self.sim_config
        )
        self._resim_memo = (memo_key, out)
        return out

    def _select_lanes(self, lane_ids):
        """Slice the single-call batch down to ``lane_ids``: batched leaves
        (those that gained an axis vs the base scene) gather along the
        lane axis; shared tables pass through untouched."""
        scene_b, ic_b = self._last_batch
        ids = jnp.asarray(lane_ids)
        base_leaves = jax.tree.leaves(self.scene)
        batch_leaves = jax.tree.leaves(scene_b)
        sel_leaves = [
            jnp.take(b, ids, axis=0) if jnp.ndim(b) > jnp.ndim(base) else b
            for base, b in zip(base_leaves, batch_leaves)
        ]
        scene_sel = jax.tree.unflatten(jax.tree.structure(scene_b), sel_leaves)
        ic_sel = jax.tree.map(lambda x: jnp.take(x, ids, axis=0), ic_b)
        return scene_sel, ic_sel

    def flight_envelope(
        self,
        lane_ids=None,
        n_lanes: int = 4096,
        chunk: int = 1024,
        env_config=None,
        sim_config: Optional[SimConfig] = None,
        analysis: Optional[dict] = None,
        inline: bool = False,
    ) -> dict:
        """Time-binned population bands (mean/std/min/max/quantiles vs
        time-since-rail-exit) over re-simulated MC lanes — see
        ``mc.envelope``. The reference persists whole per-lane histories and
        overlays a handful in its plots (`monte_carlo.py:510-517`); it has
        no population-envelope product at all.

        Lanes re-create by key in ``chunk``-sized batches and reduce ON
        DEVICE to per-bin aggregates, so host traffic is O(n_bins) per
        chunk. ``lane_ids=None`` takes the first ``n_lanes`` lanes of the
        run — or, when ``analysis`` (the ``run_monte_carlo`` return) is
        passed, the first ``n_lanes`` lanes its outlier filter accepted.
        The re-simulation runs the analyzer's own SimConfig (tiered-dt
        flags included) with ``record_derived`` forced on and the
        envelope's ``record_stride`` applied.
        """
        from .envelope import EnvelopeAccumulator, EnvelopeConfig

        if self._last_batch is None:
            raise RuntimeError("run_monte_carlo first")
        env = env_config if env_config is not None else EnvelopeConfig()
        if lane_ids is None:
            if analysis is not None and analysis.get("valid_mask") is not None:
                lane_ids = np.nonzero(np.asarray(analysis["valid_mask"]))[0]
                lane_ids = lane_ids[:n_lanes]
            else:
                if isinstance(self._last_batch, dict):
                    n_run = int(self._last_batch["n_samples"])
                else:
                    n_run = int(self._last_batch[1].position.shape[0])
                lane_ids = np.arange(min(n_lanes, n_run))
        lane_ids = np.asarray(lane_ids, np.int64)
        if lane_ids.size == 0:
            raise ValueError("flight_envelope needs at least one lane")

        import dataclasses

        cfg = sim_config or self.sim_config
        # record only the channels the envelope bins: the rest of the
        # derived set dead-code-eliminates inside the jitted recorder
        cfg = dataclasses.replace(cfg, record_derived=True,
                                  record_channels=tuple(
                                      c for c in env.channels
                                      # state-served channels never read
                                      # the derived buffers
                                      # (envelope.trajectory_channel):
                                      # recording them wastes a [T,B]
                                      # buffer each
                                      if c not in ("altitude", "speed")
                                  ))
        if env.record_stride is not None:
            cfg = dataclasses.replace(cfg, record_stride=env.record_stride)
        use_inline = inline
        if use_inline and (isinstance(self._last_batch, dict)
                           and self._last_batch.get("slabbed")):
            # the inline path slices the single-call batch directly;
            # slabbed runs re-create lanes per slab — frame path only
            # (raise rather than silently downgrade the asked-for mode)
            raise ValueError(
                "inline=True needs a single-call run; slabbed runs use the "
                "frame-based envelope path"
            )
        acc = EnvelopeAccumulator(cfg, env)
        for start in range(0, lane_ids.size, chunk):
            ids = lane_ids[start:start + chunk]
            if use_inline and acc._edges is not None:
                # frameless in-loop binning: no [T, B] buffers, so chunks
                # scale past the frame path's memory ceiling
                from ..engine.batch import simulate_envelope_batch

                scene_sel, ic_sel = self._select_lanes(ids)
                lo, width = acc._edges
                _, agg = simulate_envelope_batch(
                    scene_sel, ic_sel, cfg,
                    channels=env.channels, n_bins=acc.n_bins,
                    n_buckets=env.n_buckets, bin_dt=env.bin_dt,
                    lo=lo, width=width,
                    hist_every=max(1, env.hist_frame_stride),
                )
                acc.add_aggregates(agg, len(ids))
            else:
                # first chunk always runs frame-based: it calibrates the
                # histogram bucket edges the in-loop kernel needs
                _, traj = self.resimulate_trajectories(ids, cfg)
                acc.add(traj)
        self._resim_memo = None  # drop the last chunk's trajectories
        return acc.result()

    def _resimulate_slabbed(self, lane_ids, sim_config: Optional[SimConfig] = None):
        """Re-create selected lanes of a slabbed run by key (determinism: a
        slab's dispersions depend only on ``fold_in(key, slab_idx)``), then
        re-simulate just those lanes with trajectory recording. Returns
        ``(summary, trajectory)`` batched in ``lane_ids`` order."""
        from ..engine.batch import simulate_flight_batch

        info = self._last_batch
        ids = np.asarray(lane_ids, dtype=np.int64)
        cfg = sim_config or self.sim_config
        slab = info["slab"]
        ic = info["ic"]

        parts = {}
        for slab_idx in np.unique(ids // slab):
            # Mirror _run_slabbed's padded draw: lane values for a global id
            # depend on (key, slab_idx, slab), so re-simulation must sample
            # the same full-slab batch.
            scene_b, ic_b, _ = sample_dispersions(
                jax.random.fold_in(info["key"], int(slab_idx)), self.scene,
                ic, self.uncertainty_params, slab,
                base_wind=info["base_wind"], sampler=self.sampler,
                sobol_scrambles=self.sobol_scrambles,
                sobol_wind_modes=self.sobol_wind_modes,
                antithetic=self.antithetic,
                importance_shift=self.importance_shift,
                wind_grid_points=self.wind_grid_points,
                wind_grid_top=self.wind_grid_top,
            )
            locals_ = np.asarray(
                sorted(set((ids[ids // slab == slab_idx] % slab).tolist()))
            )
            sel = jnp.asarray(locals_)
            base_leaves = jax.tree.leaves(self.scene)
            batch_leaves = jax.tree.leaves(scene_b)
            sel_leaves = [
                jnp.take(b, sel, axis=0) if jnp.ndim(b) > jnp.ndim(base) else b
                for base, b in zip(base_leaves, batch_leaves)
            ]
            scene_sel = jax.tree.unflatten(jax.tree.structure(scene_b), sel_leaves)
            ic_sel = jax.tree.map(lambda x: jnp.take(x, sel, axis=0), ic_b)
            out = simulate_flight_batch(scene_sel, ic_sel, cfg)
            for j, loc in enumerate(locals_):
                parts[int(slab_idx) * slab + int(loc)] = jax.tree.map(
                    lambda x: x[j], out
                )
        ordered = [parts[int(g)] for g in ids]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *ordered)

