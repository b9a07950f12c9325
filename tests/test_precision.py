"""Every float contraction whose exactness the code relies on carries
``Precision.HIGHEST``.

XLA:GPU may run a float32 ``dot_general`` with default precision in TF32,
which keeps ~3 significant digits: an envelope bin would then round a 25 km
altitude by ~12 m before binning, mode-compressed wind would stop being
exact at full rank, and the control-variate Gram matrices would lose the
variance reduction they report. The CPU never shows this, so the contract
is checked on the traced program: each site's jaxpr is walked (into jit,
while, cond and shard_map bodies) and every dot_general on f32 (or wider)
operands must ask for HIGHEST. bf16 one-hot count contractions are exact
with f32 accumulation and are exempt.
"""

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest

from erpl_monte_carlo_sim_tpu.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu.engine.batch import (_make_wind_fn,
                                                   simulate_envelope_batch,
                                                   simulate_summary_batch)
from erpl_monte_carlo_sim_tpu.mc import (UncertaintyParams, outlier_mask,
                                         sample_dispersions)
from erpl_monte_carlo_sim_tpu.mc.cv import (_wind_scores, cv_slab_moments,
                                            wind_mode_projector)
from erpl_monte_carlo_sim_tpu.mc.envelope import (_bin_histogram_mc,
                                                  _bin_moments_mc)
from erpl_monte_carlo_sim_tpu.models import (WindField, compress_wind,
                                             liquid_motor, nominal_scene,
                                             wind_mode_basis)
from erpl_monte_carlo_sim_tpu.parallel import make_mesh
from erpl_monte_carlo_sim_tpu.parallel.sharded import \
    _collective_cv_moments_device

SCENE = nominal_scene(liquid_motor())
IC = InitialConditions.vertical_launch()
PARAMS = UncertaintyParams()
N = 8
F32 = jnp.float32


def _sub_jaxprs(value):
    if isinstance(value, jax.extend.core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jax.extend.core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _dot_generals(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from _dot_generals(sub)


def _is_highest(precision):
    pair = precision if isinstance(precision, tuple) else (precision,) * 2
    return all(p == jax.lax.Precision.HIGHEST for p in pair)


@pytest.fixture(scope="module")
def batch():
    scene_b, ic_b, sample = sample_dispersions(
        jax.random.PRNGKey(0), SCENE, IC, PARAMS, N)
    summary = simulate_summary_batch(scene_b, ic_b, SimConfig(max_time=0.5))
    valid, _ = outlier_mask(summary)
    wind_ctrl = {
        "wind": scene_b.wind.wind, "ws": sample.wind_speed,
        "wd": sample.wind_direction,
        "proj": jnp.asarray(wind_mode_projector(
            SCENE.wind_model, np.asarray(scene_b.wind.altitudes), 3)),
        "alt": scene_b.wind.altitudes, "model": SCENE.wind_model,
        "base": None,
    }
    return scene_b, ic_b, sample, summary, valid, wind_ctrl


def _envelope_moments(b):
    t = jnp.linspace(0.0, 4.0, 12, dtype=F32)[None].repeat(N, 0)
    valid = jnp.ones((N, 12), bool)
    values = jnp.ones((2, N, 12), F32)
    return jax.make_jaxpr(
        lambda t, v, x: _bin_moments_mc(t, v, x, 0.25, n_bins=16)
    )(t, valid, values)


def _envelope_histogram(b):
    t = jnp.linspace(0.0, 4.0, 12, dtype=F32)[None].repeat(N, 0)
    valid = jnp.ones((N, 12), bool)
    values = jnp.ones((2, N, 12), F32)
    lo = jnp.zeros((2, 16), F32)
    width = jnp.ones((2, 16), F32)
    return jax.make_jaxpr(
        lambda t, v, x: _bin_histogram_mc(t, v, x, 0.25, lo, width,
                                          n_bins=16, n_buckets=8)
    )(t, valid, values)


def _inline_envelope(b):
    scene_b, ic_b = b[0], b[1]
    channels = ("altitude", "speed")
    lo = jnp.zeros((2, 8))
    width = jnp.ones((2, 8))
    return jax.make_jaxpr(lambda sb, ib: simulate_envelope_batch(
        sb, ib, SimConfig(max_time=1.0), channels=channels, n_bins=8,
        n_buckets=4, bin_dt=0.25, lo=lo, width=width)[1])(scene_b, ic_b)


def _wind_modes_query(b):
    grid = jnp.linspace(0.0, 25000.0, 100, dtype=F32)
    wT = {"basis": jnp.ones((100, 6), F32),
          "scores": jnp.ones((3, 6, N), F32)}
    return jax.make_jaxpr(_make_wind_fn(grid, wT))(jnp.ones((N,), F32))


def _compress_wind(b):
    grid = np.linspace(0.0, 25000.0, 100)
    basis = wind_mode_basis(SCENE.wind_model, grid, 6)
    return jax.make_jaxpr(lambda w: compress_wind(
        WindField(altitudes=jnp.asarray(grid, F32), wind=w), basis).scores
    )(jnp.ones((N, 100, 3), F32))


def _sobol_rotation(b):
    return jax.make_jaxpr(lambda key: sample_dispersions(
        key, SCENE, IC, PARAMS, N, sampler="sobol", sobol_wind_modes=2
    )[0].wind.wind)(jax.random.PRNGKey(1))


def _cv_slab_moments(b):
    _, _, sample, summary, valid, wind_ctrl = b
    return jax.make_jaxpr(lambda: cv_slab_moments(
        sample, summary, valid, jnp.ones(N, bool), PARAMS, SCENE.motor,
        wind_ctrl))()


def _cv_wind_scores(b):
    wind_ctrl = b[5]
    return jax.make_jaxpr(
        lambda w: _wind_scores({**wind_ctrl, "wind": w}, F32)
    )(jnp.asarray(wind_ctrl["wind"], F32))


def _collective_cv_moments(b):
    _, _, sample, summary, valid, wind_ctrl = b
    mesh = make_mesh(n_devices=8)
    return jax.make_jaxpr(lambda: _collective_cv_moments_device(
        sample, summary, valid, None, PARAMS, SCENE.motor, mesh,
        wind_ctrl))()


SITES = {
    "envelope_moments": _envelope_moments,
    "envelope_histogram": _envelope_histogram,
    "inline_envelope": _inline_envelope,
    "wind_modes_query": _wind_modes_query,
    "compress_wind": _compress_wind,
    "sobol_rotation": _sobol_rotation,
    "cv_slab_moments": _cv_slab_moments,
    "cv_wind_scores": _cv_wind_scores,
    "collective_cv_moments": _collective_cv_moments,
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_float_contractions_are_highest(batch, site):
    closed = SITES[site](batch)
    dots = list(_dot_generals(closed.jaxpr))
    wide = [e for e in dots
            if all(jnp.issubdtype(v.aval.dtype, jnp.floating)
                   and jnp.finfo(v.aval.dtype).bits >= 32 for v in e.invars)]
    assert wide, f"{site}: no f32 contraction traced"
    low = [e.params["precision"] for e in wide
           if not _is_highest(e.params["precision"])]
    assert not low, f"{site}: {len(low)} contraction(s) at {low}"
