"""Sharding layer on the virtual 8-device CPU mesh.

The replacement for "test multi-node without a real cluster"
(SURVEY.md §4): conftest forces 8 host-platform devices; these tests verify
that sharded execution matches single-device execution exactly and that the
shard_map collective statistics match the vmapped masked stats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig, simulate_summary
from erpl_monte_carlo_sim_tpu.mc import masked_stats, sample_dispersions, scene_in_axes
from erpl_monte_carlo_sim_tpu.parallel import (
    collective_stats,
    make_mesh,
    pad_to_devices,
    run_sharded_summaries,
)
from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(n_devices=8)


def test_mesh_shape(mesh):
    assert mesh.shape["batch"] == 8
    assert pad_to_devices(17, mesh) == 24


def test_collective_stats_matches_masked_stats(mesh):
    rng = np.random.default_rng(0)
    vals = jnp.array(rng.normal(5000.0, 800.0, size=640))
    mask = jnp.array(rng.uniform(size=640) > 0.25)
    ref = masked_stats(vals, mask)
    got = collective_stats(vals, mask, mesh)
    for k in ["mean", "std", "min", "max", "n"]:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-12), k
    np.testing.assert_allclose(
        np.asarray(got["percentiles"]), np.asarray(ref["percentiles"]), rtol=1e-12
    )
    # percentile_ci (exact path): the collective CI must equal the
    # scipy-exact host interval (mc.stats.percentile_ci) BIT FOR BIT —
    # the ranks are computed host-side from binom.ppf after the count
    # readback, so there is no normal-approximation drift at any n.
    from erpl_monte_carlo_sim_tpu.mc.stats import percentile_ci

    v = np.asarray(vals)
    m = np.asarray(mask)
    ci = np.asarray(got["percentile_ci"])
    assert ci.shape == (5, 2)
    host = np.asarray(percentile_ci(v, m))
    np.testing.assert_array_equal(ci, host)
    for i in range(5):
        assert ci[i, 0] <= np.asarray(ref["percentiles"])[i] <= ci[i, 1]


@pytest.mark.parametrize("n", [24, 200, 5000])
def test_collective_percentile_ci_exact_ranks(mesh, n):
    """Exact binomial ranks at small AND large n (VERDICT r3 item 5):
    normal-approximation ranks differ from binom.ppf by >=1 rank at small
    n — the collective path must not."""
    from erpl_monte_carlo_sim_tpu.mc.stats import percentile_ci

    rng = np.random.default_rng(n)
    v = rng.normal(100.0, 7.0, size=n)
    m = rng.uniform(size=n) > 0.1
    got = collective_stats(jnp.array(v), jnp.array(m), mesh)
    np.testing.assert_array_equal(
        np.asarray(got["percentile_ci"]), np.asarray(percentile_ci(v, m))
    )


@pytest.mark.slow
def test_sharded_run_matches_single_device(mesh):
    """The same 16-lane dispersed batch must produce identical summaries
    sharded over 8 devices and on one device."""
    cfg = SimConfig(max_time=20.0)  # short: ascent only, still exercises rail+RK4
    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    # Benign dispersion (calm wind, tiny attitude errors): strongly wind-
    # dispersed 6DOF lanes are CHAOTIC, and XLA legitimately compiles
    # different vector widths (16-lane vs 2-lane shards) with different fp
    # contraction, so divergent lanes can't match bitwise across shardings.
    from erpl_monte_carlo_sim_tpu.mc import UncertaintyParams

    calm = UncertaintyParams(wind_speed_range=(0.0, 0.3),
                             initial_attitude=(0.001, 0.001, 0.001))
    scene_b, ic_b, _ = sample_dispersions(
        jax.random.PRNGKey(0), scene, ic, params=calm, n=16, base_wind=None
    )
    axes = scene_in_axes(scene, scene_b)

    single = jax.jit(
        jax.vmap(simulate_summary, in_axes=(axes, 0, None)), static_argnums=2
    )(scene_b, ic_b, cfg)
    sharded = run_sharded_summaries(scene_b, ic_b, axes, cfg, mesh, batch_size=16)

    np.testing.assert_allclose(
        np.asarray(sharded.apogee_altitude), np.asarray(single.apogee_altitude),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(sharded.flight_time), np.asarray(single.flight_time), rtol=1e-6
    )
    # Each lane really lives on its own shard
    assert len(sharded.apogee_altitude.sharding.device_set) == 8


@pytest.mark.slow
def test_chunked_batch_matches_vmap():
    """Host-chunked batch execution is lane-for-lane equivalent to the
    vmapped while_loop path (used to bound per-call device time on
    runtimes that kill long executions)."""
    import jax.numpy as jnp

    from erpl_monte_carlo_sim_tpu.engine import simulate_batch_chunked
    from erpl_monte_carlo_sim_tpu.mc import UncertaintyParams

    cfg = SimConfig(max_time=25.0, energy_consistent_aero=True)
    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    calm = UncertaintyParams(wind_speed_range=(0.0, 0.5))
    scene_b, ic_b, _ = sample_dispersions(
        jax.random.PRNGKey(0), scene, ic, params=calm, n=8
    )
    axes = scene_in_axes(scene, scene_b)
    ref = jax.jit(
        jax.vmap(simulate_summary, in_axes=(axes, 0, None)), static_argnums=2
    )(scene_b, ic_b, cfg)
    chunks_seen = []
    got = simulate_batch_chunked(
        scene_b, ic_b, cfg, chunk_steps=700,
        progress=lambda k, n: chunks_seen.append(k),
    )
    np.testing.assert_allclose(
        np.asarray(got.apogee_altitude), np.asarray(ref.apogee_altitude), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(got.flight_time), np.asarray(ref.flight_time), rtol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(got.n_steps), np.asarray(ref.n_steps))
    assert len(chunks_seen) >= 2  # really chunked


@pytest.mark.slow
def test_analyzer_with_mesh(mesh):
    """MonteCarloAnalyzer(mesh=...) shards the lane axis across devices and
    produces a normal analysis dict."""
    from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer, UncertaintyParams

    calm = UncertaintyParams(wind_speed_range=(0.0, 0.3),
                             initial_attitude=(0.001, 0.001, 0.001))
    mc = MonteCarloAnalyzer(
        scene=nominal_scene(liquid_motor()),
        uncertainty_params=calm,
        sim_config=SimConfig(max_time=20.0, energy_consistent_aero=True),
        mesh=mesh,
    )
    a = mc.run_monte_carlo(InitialConditions.vertical_launch(), n_samples=16)
    assert a["n_samples"] == 16
    assert a["performance"]["cores_used"] == 8
    assert np.isfinite(a["apogee_altitude"]["mean"])
    # resimulation still works from the sharded batch
    _, traj = mc.resimulate_trajectories([0, 1], SimConfig(max_time=5.0))
    assert traj.position.shape[0] == 2


def test_make_global_batch_base_tree_classification(mesh):
    """A SHARED leaf whose leading dim coincidentally equals local_batch must
    stay replicated when the unbatched base tree is provided — assembly from
    process-local data would otherwise CONCATENATE it into a corrupt global
    value on a real multi-process run (e.g. a 100-knot wind grid with 100
    local lanes)."""
    from jax.sharding import PartitionSpec as P

    from erpl_monte_carlo_sim_tpu.parallel import make_global_batch

    local = 8  # == leading dim of the shared leaf below
    tree = {
        "batched": np.zeros((local, 3), np.float32),
        "shared_grid": np.arange(local, dtype=np.float32),  # NOT per-lane
    }
    base = {
        "batched": np.zeros((3,), np.float32),
        "shared_grid": np.arange(local, dtype=np.float32),
    }
    out = make_global_batch(tree, mesh, local, base_tree=base)
    assert out["batched"].sharding.spec == P("batch")
    assert out["shared_grid"].sharding.spec == P()
    # without the base tree, the shape heuristic misclassifies the grid —
    # the documented reason base_tree exists
    out2 = make_global_batch(tree, mesh, local)
    assert out2["shared_grid"].sharding.spec == P("batch")


def test_collective_histogram_percentiles(mesh):
    """Beyond exact_percentile_threshold, collective_stats switches to the
    two-pass histogram estimate: O(n_bins) communication instead of an O(n)
    all_gather + replicated sort. Error must stay far below the 0.1%-of-
    sigma bound at a representative lane count (below it, order-statistic
    gaps dominate — that regime keeps the exact path)."""
    rng = np.random.default_rng(0)
    n = 262_144
    vals = jnp.array(rng.normal(5000.0, 800.0, size=n))
    mask = jnp.array(rng.uniform(size=n) > 0.25)
    exact = masked_stats(vals, mask)
    hist = collective_stats(vals, mask, mesh, exact_percentile_threshold=1024)
    for k in ("mean", "std", "min", "max", "n"):
        np.testing.assert_allclose(float(hist[k]), float(exact[k]), rtol=1e-12)
    err = np.abs(
        np.asarray(hist["percentiles"]) - np.asarray(exact["percentiles"])
    ) / float(exact["std"])
    assert err.max() < 1e-4, err
    # default threshold keeps the exact path for this n
    ex2 = collective_stats(vals, mask, mesh)
    np.testing.assert_allclose(
        np.asarray(ex2["percentiles"]), np.asarray(exact["percentiles"]),
        rtol=1e-12,
    )
    # percentile_ci rides the same two-pass histogram: within the same
    # 0.1%-of-sigma bound of the exact-path interval
    ci_err = np.abs(
        np.asarray(hist["percentile_ci"]) - np.asarray(ex2["percentile_ci"])
    ) / float(exact["std"])
    assert ci_err.max() < 1e-4, ci_err
    ci = np.asarray(ex2["percentile_ci"])
    assert (ci[:, 0] <= np.asarray(ex2["percentiles"])).all()
    assert (ci[:, 1] >= np.asarray(ex2["percentiles"])).all()


def test_collective_histogram_degenerate_span(mesh):
    """All-valid-values-equal: the coarse span collapses; the clamp on
    span (1e-30) plus the final clip to [vmin, vmax] must still return the
    exact common value for every percentile, with skewed masks."""
    n = 4096
    vals = jnp.full((n,), 1234.5)
    mask = jnp.arange(n) % 3 != 0
    got = collective_stats(vals, mask, mesh, exact_percentile_threshold=64)
    np.testing.assert_allclose(
        np.asarray(got["percentiles"]), np.full(5, 1234.5), rtol=0, atol=0
    )
    np.testing.assert_allclose(
        np.asarray(got["percentile_ci"]), np.full((5, 2), 1234.5),
        rtol=0, atol=0,
    )
    assert float(got["std"]) == 0.0
    assert int(got["n"]) == int(np.asarray(mask).sum())


def test_sharded_hot_loop_is_collective_free(mesh):
    """PROVE the design claim in parallel/sharded.py (lanes embarrassingly
    parallel; zero communication in the hot loop) at the compiled-HLO level:
    lower + compile the sharded summary program on the 8-device mesh and
    assert the ONLY collectives in the whole module are 1-bit (pred[])
    all-reduces — the rail/main while-loop conditions. A regression that
    smuggles a tensor all-reduce, all-gather, reduce-scatter, or
    collective-permute into the loop body would pass value-level tests and
    only show up as a slowdown on real devices, which a CPU run cannot
    measure."""
    import re

    from erpl_monte_carlo_sim_tpu.engine.batch import simulate_summary_batch
    from erpl_monte_carlo_sim_tpu.parallel.mesh import shard_batch

    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()
    scene_b, ic_b, _ = sample_dispersions(
        jax.random.PRNGKey(0), scene, ic, n=16
    )
    scene_b = shard_batch(scene_b, mesh, 16)
    ic_b = shard_batch(ic_b, mesh, 16)
    cfg = SimConfig(max_time=1.0)
    txt = (
        jax.jit(simulate_summary_batch, static_argnums=2)
        .lower(scene_b, ic_b, cfg)
        .compile()
        .as_text()
    )
    pat = re.compile(
        r"all-reduce|all-gather|reduce-scatter|collective-permute|all-to-all"
    )
    coll = [ln for ln in txt.splitlines() if pat.search(ln)]
    # positive control: the program really was partitioned (loop conditions
    # must reduce across shards) — an unpartitioned compile would trivially
    # "pass" the emptiness checks below
    assert coll, "expected the while-loop condition all-reduces; got none"
    for ln in coll:
        assert "all-reduce" in ln and "pred[]" in ln, (
            f"non-1-bit collective in the sharded hot program: {ln.strip()}"
        )


def test_collective_stats_variance_catastrophic_cancellation(mesh):
    """Two-pass variance: large-mean/small-std f32 data must not lose the
    std to E[x^2]-mean^2 cancellation (flight_time-like: mean ~1e2, std
    ~1e-1 — the one-pass form was ~percent-level wrong)."""
    rng = np.random.default_rng(3)
    vals = jnp.asarray(rng.normal(100.0, 0.1, size=1024), jnp.float32)
    st = collective_stats(vals, None, mesh)
    ref = float(np.asarray(vals, np.float64).std())
    np.testing.assert_allclose(float(st["std"]), ref, rtol=2e-3)


def test_collective_footprint_matches_host_footprint(mesh):
    """collective_footprint's psum'd two-pass moments must reproduce the
    host empirical footprint's mean/cov/ellipses exactly (CEP differs by
    method: gaussian fit vs empirical median — per-lane distances are
    never gathered at pod scale)."""
    from erpl_monte_carlo_sim_tpu.mc.stats import landing_footprint
    from erpl_monte_carlo_sim_tpu.parallel import collective_footprint

    rng = np.random.default_rng(7)
    landing = jnp.array(rng.multivariate_normal(
        [4200.0, -730.0], [[250.0 ** 2, 9000.0], [9000.0, 90.0 ** 2]],
        size=640,
    ))
    landing = jnp.concatenate(  # [n,3]: z column must be ignored
        [landing, jnp.full((640, 1), 123.0)], axis=1)
    mask = jnp.array(rng.uniform(size=640) > 0.25)
    # a non-finite lane inside the mask must be excluded, like the analyzer
    landing = landing.at[5, 0].set(jnp.nan)
    got = collective_footprint(landing, mask, mesh)
    m = np.asarray(mask) & np.isfinite(np.asarray(landing[:, 0]))
    ref = landing_footprint(np.asarray(landing)[m, 0],
                            np.asarray(landing)[m, 1])
    assert got["n"] == ref["n"]
    np.testing.assert_allclose(got["mean_m"], ref["mean_m"], rtol=1e-9)
    np.testing.assert_allclose(got["cov_m2"], ref["cov_m2"], rtol=1e-6)
    np.testing.assert_allclose(
        got["ellipse95"]["semi_major_m"], ref["ellipse95"]["semi_major_m"],
        rtol=1e-6,
    )
    assert got["cep_method"] == "gaussian" and ref["cep_method"] == "empirical"
    assert abs(got["cep_m"] - ref["cep_m"]) / ref["cep_m"] < 0.05
    # mask=None: all finite lanes
    all_fp = collective_footprint(landing, None, mesh)
    assert all_fp["n"] == 639


def test_collective_tail_carry_matches_host(mesh):
    """The device-resident carry (no per-slab candidate readback) must
    finalize to exactly the host reservoir of all slabs' valid lanes,
    including NaN lanes and a slab count that underfills k."""
    from erpl_monte_carlo_sim_tpu.mc.tail import TailReservoir
    from erpl_monte_carlo_sim_tpu.parallel import (collective_tail_carry,
                                                   tail_reservoir_from_carry)

    rng = np.random.default_rng(5)
    for k in (64, 4096):  # 4096 > 3*640 lanes: +-inf padding must drop
        ref = TailReservoir(k)
        carry, n_tot = None, 0
        for s in range(3):
            vals = rng.normal(25_000.0, 800.0, size=640)
            vals[::97] = np.nan
            cnt, carry = collective_tail_carry(jnp.asarray(vals), None,
                                               mesh, carry, k=k)
            n_tot += int(cnt)
            ref.add(vals)
        got = tail_reservoir_from_carry(carry, n_tot)
        assert got.n == ref.n
        np.testing.assert_array_equal(got.hi, ref.hi)
        np.testing.assert_array_equal(got.lo, ref.lo)


def test_collective_tail_rejects_unshardable_batch(mesh):
    """n not divisible by the device count must be a clear error, not an
    empty candidate set or a shape failure three layers down."""
    from erpl_monte_carlo_sim_tpu.parallel import collective_tail_extremes

    with pytest.raises(ValueError, match="cannot shard"):
        collective_tail_extremes(jnp.ones(9), None, mesh, k=4)
    with pytest.raises(ValueError, match="cannot shard"):
        collective_tail_extremes(jnp.ones(0), None, mesh, k=4)


def test_collective_tail_reservoir_matches_host(mesh):
    """The psum/top_k/all_gather tail reduction must equal a single-host
    TailReservoir of the same valid lanes EXACTLY (it is order statistics,
    not a sketch), for k both below and above the per-shard lane count."""
    from erpl_monte_carlo_sim_tpu.mc.tail import TailReservoir
    from erpl_monte_carlo_sim_tpu.parallel import collective_tail_reservoir

    rng = np.random.default_rng(3)
    vals = rng.normal(25_000.0, 800.0, size=640)
    vals[::71] = np.nan  # non-finite lanes must drop out
    mask = rng.uniform(size=640) > 0.2
    for k in (16, 64, 200):  # 200 > 640/8 = 80 lanes/shard
        got = collective_tail_reservoir(jnp.asarray(vals),
                                        jnp.asarray(mask), mesh, k=k)
        ref = TailReservoir(k)
        ref.add(vals[mask])
        assert got.n == ref.n
        np.testing.assert_array_equal(got.hi, ref.hi)
        np.testing.assert_array_equal(got.lo, ref.lo)
