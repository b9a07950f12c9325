"""Flight-envelope statistics (mc/envelope.py + analyzer.flight_envelope).

The binning kernels are pinned against direct NumPy reductions; the
accumulator's chunk merge against a single-chunk run; and the analyzer
integration against physical sanity (bands ordered, ascent monotone,
every lane present at rail exit). Beyond-reference feature: the reference
persists whole histories and overlays a few lines (`monte_carlo.py:510-517`)
— it has no population-envelope product.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu.mc import (
    EnvelopeAccumulator,
    EnvelopeConfig,
    MonteCarloAnalyzer,
)
from erpl_monte_carlo_sim_tpu.mc.envelope import (
    _bin_histogram,
    _bin_histogram_mc,
    _bin_moments_mc,
)
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene

CFG = SimConfig(max_time=3.0)


def _ref_bins(t, valid, value, bin_dt, n_bins):
    ids = np.clip(np.floor(t / bin_dt).astype(int), 0, n_bins - 1)
    m = valid & np.isfinite(value)
    out = []
    for b in range(n_bins):
        sel = value[m & (ids == b)]
        out.append(sel)
    return out


def test_bin_moments_match_numpy():
    rng = np.random.default_rng(7)
    B, T, n_bins, bin_dt = 13, 50, 6, 0.4
    t = np.cumsum(rng.uniform(0.01, 0.08, (B, T)), axis=1)
    valid = rng.uniform(size=(B, T)) < 0.9
    value = rng.normal(100.0, 5.0, (B, T))
    value[0, 3] = np.nan  # non-finite samples must drop
    # two channels through the multi-channel contraction kernel: the
    # second is a shifted copy so per-channel separation is visible
    values = np.stack([value, value + 7.0])
    n, mean, m2, vmin, vmax = map(
        np.asarray,
        _bin_moments_mc(jnp.asarray(t), jnp.asarray(valid),
                        jnp.asarray(values), bin_dt, n_bins),
    )
    for c, off in enumerate((0.0, 7.0)):
        for b, sel in enumerate(
            _ref_bins(t, valid, value + off, bin_dt, n_bins)
        ):
            assert n[c, b] == sel.size
            if sel.size:
                np.testing.assert_allclose(mean[c, b], sel.mean(),
                                           rtol=1e-12)
                np.testing.assert_allclose(
                    m2[c, b], ((sel - sel.mean()) ** 2).sum(),
                    rtol=1e-9, atol=1e-9,
                )
                assert vmin[c, b] == sel.min() and vmax[c, b] == sel.max()


def test_bin_histogram_quantiles_within_bucket():
    rng = np.random.default_rng(3)
    B, T, n_bins, n_buckets, bin_dt = 64, 40, 4, 64, 0.5
    t = np.tile(np.linspace(0.0, 1.99, T), (B, 1))
    valid = np.ones((B, T), bool)
    value = rng.normal(50.0, 3.0, (B, T))
    lo = np.full(n_bins, value.min() - 0.5)
    width = np.full(n_bins, (value.max() - value.min() + 1.0) / n_buckets)
    h, clip_ct = map(np.asarray, _bin_histogram(
        jnp.asarray(t), jnp.asarray(valid), jnp.asarray(value), bin_dt,
        jnp.asarray(lo, jnp.float32), jnp.asarray(width, jnp.float32),
        n_bins, n_buckets,
    ))
    assert clip_ct.sum() == 0
    assert h.sum() == B * T
    bins = _ref_bins(t, valid, value, bin_dt, n_bins)
    for b in range(n_bins):
        centers = lo[b] + (np.arange(n_buckets) + 0.5) * width[b]
        mid = np.cumsum(h[b]) - 0.5 * h[b]
        tot = h[b].sum()
        targets = np.array([25.0, 50.0, 75.0]) / 100.0 * (tot - 1) + 0.5
        est = np.interp(targets, mid, centers)
        ref = np.percentile(bins[b], [25, 50, 75])
        assert np.all(np.abs(est - ref) <= width[b] + 1e-9)


@pytest.fixture(scope="module")
def envelope_run():
    mc = MonteCarloAnalyzer(scene=nominal_scene(liquid_motor()),
                            sim_config=CFG)
    analysis = mc.run_monte_carlo(
        InitialConditions.vertical_launch(), n_samples=48, seed=11
    )
    env_cfg = EnvelopeConfig(bin_dt=0.25, record_stride=2)
    env = mc.flight_envelope(n_lanes=48, chunk=48, env_config=env_cfg,
                             analysis=analysis)
    return mc, analysis, env_cfg, env


def test_envelope_schema_and_sanity(envelope_run):
    _, analysis, env_cfg, env = envelope_run
    n_valid = int(np.asarray(analysis["valid_mask"]).sum())
    assert env["n_lanes"] == min(48, n_valid)
    assert set(env["channels"]) == set(env_cfg.channels)
    json.dumps(env)  # report-ready

    alt = env["channels"]["altitude"]
    n = np.asarray(alt["n"])
    mean = np.asarray(alt["mean"])
    # every lane is flying during the first bins after rail exit
    assert n[0] > 0 and n[1] > 0
    # boost-phase population altitude rises monotonically
    live = np.nonzero(n > 0)[0]
    assert np.all(np.diff(mean[live[:6]]) > 0)
    # band ordering wherever the bin saw samples
    p = {q: np.asarray(alt["percentiles"][q]) for q in ("5", "25", "50",
                                                        "75", "95")}
    vmin, vmax = np.asarray(alt["min"]), np.asarray(alt["max"])
    for b in live:
        assert vmin[b] - 1e-9 <= p["5"][b] <= p["25"][b] <= p["50"][b]
        assert p["50"][b] <= p["75"][b] <= p["95"][b] <= vmax[b] + 1e-9
    # empty bins are NaN, not zeros
    dead = np.nonzero(n == 0)[0]
    if dead.size:
        assert np.isnan(mean[dead]).all()
    # calibrated on the full population in one chunk: nothing clipped
    assert alt["clipped_frac"] == 0.0


def test_envelope_chunk_merge_matches_single_chunk(envelope_run):
    mc, analysis, env_cfg, env = envelope_run
    env2 = mc.flight_envelope(n_lanes=48, chunk=17, env_config=env_cfg,
                              analysis=analysis)
    for ch in env["channels"]:
        a, b = env["channels"][ch], env2["channels"][ch]
        assert a["n"] == b["n"]
        np.testing.assert_allclose(a["mean"], b["mean"], rtol=1e-6,
                                   equal_nan=True)
        np.testing.assert_allclose(a["std"], b["std"], rtol=1e-5,
                                   atol=1e-8, equal_nan=True)
        np.testing.assert_allclose(a["min"], b["min"], rtol=1e-12,
                                   equal_nan=True)
        np.testing.assert_allclose(a["max"], b["max"], rtol=1e-12,
                                   equal_nan=True)
        # quantile bands: chunked calibration sees only the first 17 lanes,
        # so later-lane mass may clip; bands still agree to a bucket width
        sig = np.nanmean(np.asarray(a["std"]))
        np.testing.assert_allclose(
            a["percentiles"]["50"], b["percentiles"]["50"],
            atol=max(5 * sig / env_cfg.n_buckets, 1e-6), equal_nan=True,
        )


def test_envelope_honors_tiered_dt(envelope_run):
    mc, analysis, env_cfg, _ = envelope_run
    fast = dataclasses.replace(CFG, descent_dt_scale=8,
                               ascent_q_threshold=8000.0)
    env = mc.flight_envelope(n_lanes=16, chunk=16, env_config=env_cfg,
                             analysis=analysis, sim_config=fast)
    n = np.asarray(env["channels"]["speed"]["n"])
    assert n[0] > 0
    m = np.asarray(env["channels"]["speed"]["mean"])
    assert np.isfinite(m[n > 0]).all()


def test_envelope_plot_and_report(envelope_run, tmp_path):
    from erpl_monte_carlo_sim_tpu.reporting.plots import plot_flight_envelope
    from erpl_monte_carlo_sim_tpu.reporting.report import save_report

    mc, analysis, _, env = envelope_run
    path = plot_flight_envelope(env, str(tmp_path))
    assert path and os.path.getsize(path) > 10_000
    analysis2 = dict(analysis)
    analysis2["flight_envelope"] = env
    report = save_report(analysis2, str(tmp_path), analyzer=mc)
    assert report["flight_envelope"]["n_lanes"] == env["n_lanes"]
    with open(tmp_path / "monte_carlo_report.txt") as f:
        txt = f.read()
    assert "Flight Envelope" in txt and "altitude: population max" in txt
    with open(tmp_path / "monte_carlo_report.json") as f:
        assert "flight_envelope" in json.load(f)


def test_collective_envelope_matches_accumulator():
    """Pod-scale twin: the shard_map envelope over the 8-device mesh must
    reproduce the single-device accumulator on the same trajectories —
    moments to f64-merge noise, histograms bucket-for-bucket (both
    calibrate edges on the full population in the same f32 precision)."""
    import jax

    from erpl_monte_carlo_sim_tpu.engine.batch import simulate_flight_batch
    from erpl_monte_carlo_sim_tpu.mc import (
        UncertaintyParams,
        sample_dispersions,
    )
    from erpl_monte_carlo_sim_tpu.parallel import (
        collective_envelope,
        make_mesh,
    )

    scene_b, ic_b, _ = sample_dispersions(
        jax.random.PRNGKey(5), nominal_scene(liquid_motor()),
        InitialConditions.vertical_launch(), UncertaintyParams(), 64
    )
    cfg = dataclasses.replace(CFG, record_stride=2)
    _, traj = simulate_flight_batch(scene_b, ic_b, cfg)
    env_cfg = EnvelopeConfig(bin_dt=0.25, channels=("altitude", "speed",
                                                    "mach"))
    acc = EnvelopeAccumulator(cfg, env_cfg)
    acc.add(traj)
    ref = acc.result()
    col = collective_envelope(traj, make_mesh(), env=env_cfg,
                              max_time=cfg.max_time)
    assert col["n_lanes"] == ref["n_lanes"]
    for ch in env_cfg.channels:
        a, b = ref["channels"][ch], col["channels"][ch]
        assert a["n"] == b["n"]
        np.testing.assert_allclose(b["mean"], a["mean"], rtol=1e-12,
                                   equal_nan=True)
        np.testing.assert_allclose(b["std"], a["std"], rtol=1e-9,
                                   atol=1e-12, equal_nan=True)
        np.testing.assert_allclose(b["min"], a["min"], rtol=0,
                                   equal_nan=True)
        np.testing.assert_allclose(b["max"], a["max"], rtol=0,
                                   equal_nan=True)
        for q in a["percentiles"]:
            np.testing.assert_allclose(
                b["percentiles"][q], a["percentiles"][q], rtol=1e-9,
                atol=1e-12, equal_nan=True,
            )
        assert b["clipped_frac"] == 0.0


def test_envelope_accumulator_rejects_unrecorded_channel():
    from erpl_monte_carlo_sim_tpu.engine.batch import simulate_flight_batch
    from erpl_monte_carlo_sim_tpu.mc import sample_dispersions, \
        UncertaintyParams
    import jax

    scene_b, ic_b, _ = sample_dispersions(
        jax.random.PRNGKey(0), nominal_scene(liquid_motor()),
        InitialConditions.vertical_launch(), UncertaintyParams(), 4
    )
    cfg = dataclasses.replace(CFG, record_derived=False)
    _, traj = simulate_flight_batch(scene_b, ic_b, cfg)
    acc = EnvelopeAccumulator(cfg, EnvelopeConfig(channels=("mach",)))
    with pytest.raises(KeyError):
        acc.add(traj)
    # state channels survive without derived recording
    acc2 = EnvelopeAccumulator(
        cfg, EnvelopeConfig(channels=("altitude", "speed"))
    )
    acc2.add(traj)
    assert acc2.result()["channels"]["speed"]["n"][0] > 0


def test_bin_histogram_counts_are_integer():
    """Histogram/count segment sums accumulate in int32 — an f32 count
    saturates at 2^24 samples per bucket, routinely exceeded at pod scale
    (the collective path psums these)."""
    t = jnp.linspace(0.0, 1.0, 32)[None, :].repeat(3, 0)
    valid = jnp.ones((3, 32), bool)
    v = jnp.linspace(0.0, 2.0, 32)[None, :].repeat(3, 0)
    lo = jnp.zeros(4, jnp.float32)
    width = jnp.full(4, 0.5, jnp.float32)
    h, clip_ct = _bin_histogram(t, valid, v, 0.3, lo, width,
                                n_bins=4, n_buckets=4)
    assert jnp.issubdtype(h.dtype, jnp.integer)
    assert jnp.issubdtype(clip_ct.dtype, jnp.integer)
    assert int(h.sum()) + int(clip_ct.sum()) >= int(h.sum())
    assert int(h.sum()) == 3 * 32


def test_bin_histogram_mc_matches_single_channel():
    """The multi-channel one-hot-contraction histogram must count EXACTLY what
    the single-channel segment kernel counts (bf16 one-hot inputs with f32
    accumulation keep integer counts exact below 2^24), and its
    frame-stride subsampling must equal slicing by hand."""
    rng = np.random.default_rng(11)
    B, T, K, J = 17, 60, 5, 16
    t = np.cumsum(rng.uniform(0.01, 0.08, (B, T)), axis=1)
    valid = rng.uniform(size=(B, T)) < 0.9
    vals = np.stack([rng.normal(40.0, 3.0, (B, T)),
                     rng.normal(-5.0, 1.0, (B, T))])
    vals[0, 2, 5] = np.inf  # non-finite drops per channel
    lo = np.stack([np.full(K, 30.0), np.full(K, -9.0)])
    width = np.stack([np.full(K, 1.2), np.full(K, 0.7)])
    h, clip_ct = map(np.asarray, _bin_histogram_mc(
        jnp.asarray(t), jnp.asarray(valid), jnp.asarray(vals), 0.5,
        jnp.asarray(lo, jnp.float32), jnp.asarray(width, jnp.float32),
        K, J,
    ))
    for c in range(2):
        h1, c1 = map(np.asarray, _bin_histogram(
            jnp.asarray(t), jnp.asarray(valid), jnp.asarray(vals[c]), 0.5,
            jnp.asarray(lo[c], jnp.float32),
            jnp.asarray(width[c], jnp.float32), K, J,
        ))
        np.testing.assert_array_equal(h[c], h1)
        assert clip_ct[c] == c1.sum()
    h4, _ = map(np.asarray, _bin_histogram_mc(
        jnp.asarray(t), jnp.asarray(valid), jnp.asarray(vals), 0.5,
        jnp.asarray(lo, jnp.float32), jnp.asarray(width, jnp.float32),
        K, J, frame_stride=4,
    ))
    href, _ = map(np.asarray, _bin_histogram_mc(
        jnp.asarray(t[:, ::4]), jnp.asarray(valid[:, ::4]),
        jnp.asarray(vals[:, :, ::4]), 0.5,
        jnp.asarray(lo, jnp.float32), jnp.asarray(width, jnp.float32),
        K, J,
    ))
    np.testing.assert_array_equal(h4, href)


def test_clipped_frac_denominator_respects_hist_stride():
    """clipped_frac divides by the HISTOGRAM's sample count: under
    hist_frame_stride the histogram sees a strided frame subset, and the
    old all-frames denominator understated the miscalibration diagnostic
    by the stride factor (r4 review). All-clipping data must report
    clipped_frac == 1.0 at any stride."""
    from erpl_monte_carlo_sim_tpu.engine import SimConfig

    cfg = SimConfig(max_time=4.0)
    env = EnvelopeConfig(channels=("altitude",), bin_dt=1.0,
                         record_stride=1, hist_frame_stride=2)
    acc = EnvelopeAccumulator(cfg, env)
    B, T = 8, 40
    t = np.tile(np.linspace(0.0, 3.9, T), (B, 1))
    pos = np.zeros((B, T, 3))
    pos[..., 2] = np.linspace(1000.0, 2000.0, T)[None, :]

    class FakeTraj:
        time = jnp.asarray(t)
        valid = jnp.ones((B, T), bool)
        position = jnp.asarray(pos)
        velocity = jnp.zeros((B, T, 3))
        derived = {}

    acc.add(FakeTraj())
    # sabotage the calibrated edges so EVERY sample clips, then re-add
    lo, width = acc._edges
    acc._edges = (lo + 1e6, width)
    acc._hist = {c: np.zeros_like(h) for c, h in acc._hist.items()}
    acc._clipped = {c: 0.0 for c in acc._clipped}
    acc.add(FakeTraj())
    blk = acc.result()["channels"]["altitude"]
    assert blk["clipped_frac"] == pytest.approx(1.0)


def test_inline_envelope_matches_frame_path(envelope_run):
    """The frameless in-loop binning engine (r5:
    engine.batch.simulate_envelope_batch) must reproduce the frame-based
    path on the same lanes: counts/min/max/histograms exactly (same masks,
    same bin ids, same integer counting), moments to merge-order noise
    (per-record-step Welford vs per-chunk two-pass + Chan)."""
    mc, analysis, env_cfg, env_ref = envelope_run
    # chunk=16 over 48 lanes: chunk 1 calibrates frame-based, chunks 2-3
    # run in-loop — the exact production composition of inline=True
    env_inl = mc.flight_envelope(n_lanes=48, chunk=16, env_config=env_cfg,
                                 analysis=analysis, inline=True)
    env_frm = mc.flight_envelope(n_lanes=48, chunk=16, env_config=env_cfg,
                                 analysis=analysis, inline=False)
    for ch in env_cfg.channels:
        a = env_frm["channels"][ch]
        b = env_inl["channels"][ch]
        assert a["n"] == b["n"], ch
        # min/max: near-ULP, not bit-equal — computed channels (speed etc.)
        # go through different XLA executables whose FMA fusion choices
        # differ by one ULP (measured: 2.8e-14 abs on a 153.8 value).
        # State-served channels (altitude) do match exactly, but one
        # tolerance serves all.
        np.testing.assert_allclose(b["min"], a["min"], rtol=1e-12,
                                   equal_nan=True, err_msg=ch)
        np.testing.assert_allclose(b["max"], a["max"], rtol=1e-12,
                                   equal_nan=True, err_msg=ch)
        np.testing.assert_allclose(b["mean"], a["mean"], rtol=1e-9,
                                   atol=1e-12, equal_nan=True, err_msg=ch)
        np.testing.assert_allclose(b["std"], a["std"], rtol=1e-6,
                                   atol=1e-9, equal_nan=True, err_msg=ch)
        assert b["clipped_frac"] == pytest.approx(a["clipped_frac"],
                                                  abs=1e-12)
        for q, band in a["percentiles"].items():
            np.testing.assert_allclose(
                b["percentiles"][q], band, rtol=1e-9, atol=1e-9,
                equal_nan=True, err_msg=f"{ch} p{q}",
            )


def test_inline_envelope_hist_stride(envelope_run):
    """hist_frame_stride in the in-loop kernel subsamples the SAME record
    indices as the frame path's [::stride] histogram slicing."""
    mc, analysis, env_cfg, _ = envelope_run
    env_s = dataclasses.replace(env_cfg, hist_frame_stride=3)
    env_inl = mc.flight_envelope(n_lanes=32, chunk=16, env_config=env_s,
                                 analysis=analysis, inline=True)
    env_frm = mc.flight_envelope(n_lanes=32, chunk=16, env_config=env_s,
                                 analysis=analysis, inline=False)
    for ch in env_s.channels:
        a, b = env_frm["channels"][ch], env_inl["channels"][ch]
        assert a["n"] == b["n"], ch
        for q, band in a["percentiles"].items():
            np.testing.assert_allclose(
                b["percentiles"][q], band, rtol=1e-9, atol=1e-9,
                equal_nan=True, err_msg=f"{ch} p{q}",
            )


def test_inline_envelope_rejects_slabbed():
    mc = MonteCarloAnalyzer(scene=nominal_scene(liquid_motor()),
                            sim_config=CFG, persistent_cache=False)
    mc.run_monte_carlo(InitialConditions.vertical_launch(), n_samples=64,
                       lane_slab=32, seed=1)
    with pytest.raises(ValueError, match="inline"):
        mc.flight_envelope(n_lanes=8, chunk=8, inline=True)
