"""On-device scrambled-Sobol sequences (uint32 bit ops, fully jittable).

On-device replacement for the host-side scipy stage of the QMC sampling
path (`mc/dispersions.py`): the reference has no QMC at all, and an
earlier rebuild generated Sobol matrices with ``scipy.stats.qmc`` +
``scipy.special.ndtri`` on the host, serialized with the simulation.
Everything here
traces under ``jit``, so the whole draw fuses into the one sampling
dispatch.

Construction:

* **Direction numbers** — Joe-Kuo ``new-joe-kuo-6.21201`` (first 640
  dims), baked into ``data/sobol_directions.npz`` by
  ``scripts/gen_sobol_directions.py`` (verified there against scipy's own
  point stream).
* **Generation** — Gray-code direct form: ``x_i = XOR_{j in
  bits(gray(i))} v_j``, vectorized over points as an unrolled XOR
  reduction over the ``ceil(log2 n)`` live bits (pure elementwise uint32 work; no
  gathers, no sequential dependence — unlike the classic recursive
  construction, every point is independent).
* **Scrambling** — full nested-uniform (Owen) scrambling with the digit
  permutations drawn from a hash: output bit ``b`` flips by a hash of the
  input's more-significant bits and a per-(dimension, bit) key (the
  hash-as-permutation-tree idea of Burley, "Practical Hash-based Owen
  Scrambling", JCGT 2020, but per-bit rather than the cheaper
  Laine-Karras approximation — the per-bit form is exactly
  nested-uniform given a good hash, preserves (0,m,s)-net strata
  (pinned by test), and matches-or-beats scipy's Owen scramble on
  direct d=91 integrand RMS comparisons; see NOTES.md). Every
  scrambled coordinate is marginally U(0,1) for a uniform seed, so
  estimators stay unbiased — the property the RQMC error bars
  (``sobol_scrambles``) rely on.

Conversion to (0,1) uses bin centers (``(x + 0.5) * 2^-bits``), so 0 and 1
are unreachable and ``ndtri`` stays finite without clipping.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["direction_numbers", "sobol_uniform", "sobol_normal", "max_dims"]

_U32 = jnp.uint32


@functools.lru_cache(maxsize=1)
def _table() -> np.ndarray:
    from importlib.resources import files

    with (files("erpl_monte_carlo_sim_tpu.data") / "sobol_directions.npz"
          ).open("rb") as f:
        return np.load(f)["v"]


def max_dims() -> int:
    """Largest supported dimension count (baked-table width)."""
    return int(_table().shape[0])


def direction_numbers(d: int) -> np.ndarray:
    """First ``d`` Joe-Kuo direction-number rows, shape [d, 32] uint32."""
    t = _table()
    if not 1 <= d <= t.shape[0]:
        raise ValueError(
            f"sobol dimension {d} outside the baked table (1..{t.shape[0]}); "
            "regenerate with scripts/gen_sobol_directions.py if more are needed"
        )
    return t[:d]


def _sobol_bits(n: int, v, xp=jnp):
    """Unscrambled Sobol integers for points 0..n-1, shape [n, d] uint32.

    ``xp`` selects the array module: ``jnp`` (default) traces under jit for
    the device sampling path; ``numpy`` runs the same construction on the
    host (used by ``mc.stats._gaussian_cep`` — one algorithm, two
    backends, no drift)."""
    u32 = xp.uint32
    i = xp.arange(n, dtype=u32)
    gray = i ^ (i >> u32(1))
    x = xp.zeros((n, v.shape[0]), u32)
    for j in range(max(1, (n - 1).bit_length())):
        bit = (gray >> u32(j)) & u32(1)
        x = x ^ (bit[:, None] * v[None, :, j])
    return x


def _hash32(z):
    """Wellons' lowbias32 avalanche mix (public domain constants)."""
    z = z ^ (z >> 16)
    z = z * _U32(0x7FEB352D)
    z = z ^ (z >> 15)
    z = z * _U32(0x846CA68B)
    z = z ^ (z >> 16)
    return z


def _owen_scramble(x, seeds):
    """Nested-uniform (Owen) scramble of [n, d] Sobol integers with
    per-dimension uint32 ``seeds`` [d].

    Full per-bit construction: bit ``b`` of the output flips according to a
    hash of the INPUT's more-significant bits (``prefix = x >> (b+1)``) and
    a per-(dimension, bit) key — exactly Owen's digit-permutation tree with
    the permutations drawn from a hash instead of stored. For a uniform
    seed every flip is a fair coin and flips differ across prefixes, so
    each scrambled coordinate is marginally U(0,1) (unbiased estimators)
    AND the (t,m,s)-net structure is preserved per branch (pinned by
    test: a scrambled 1024-point 2-D block still has exactly one point
    per 32x32 stratum). Costs 32 hash rounds — pure elementwise uint32 work,
    negligible next to ndtri. Direct d=91 integrand comparisons (NOTES.md)
    show RMS parity-or-better vs scipy's Owen scramble; the cheaper
    Laine-Karras approximation was indistinguishable on the flight study
    but is not provably nested-uniform, so the per-bit form ships.
    """
    # per-(dimension, bit) keys from the per-dimension seeds
    bits = jnp.arange(32, dtype=_U32)
    keys = _hash32(seeds[:, None] ^ _hash32(bits[None, :] * _U32(0x9E3779B9)))
    y = x
    for b in range(32):
        prefix = x >> _U32(b + 1) if b < 31 else jnp.zeros_like(x)
        flip = _hash32(prefix ^ keys[None, :, b]) & _U32(1)
        y = y ^ (flip << _U32(b))
    return y


def _to_unit(x, dtype):
    dtype = jnp.dtype(dtype)
    if dtype == jnp.float64:
        return (x.astype(jnp.float64) + 0.5) * jnp.float64(2.0 ** -32)
    # Drop to 23 bits so float32 k+0.5 is EXACT for every k: with 24 bits,
    # k >= 2^23 rounds k+0.5 to an even integer (tie-to-even) and the top
    # bin (k = 2^24-1) lands on exactly 1.0 -> ndtri = +inf. At 2^-24
    # probability per coordinate that poisons ~a quarter of production-size
    # f32 slabs (262144 x 19+ coords). 23-bit bins keep the result in
    # [2^-24, 1 - 2^-24] exactly.
    return ((x >> 9).astype(dtype) + jnp.asarray(0.5, dtype)) * jnp.asarray(
        2.0 ** -23, dtype
    )


@functools.partial(jax.jit, static_argnames=("n", "d", "scrambles", "dtype"))
def sobol_uniform(key, n: int, d: int, scrambles: int = 1,
                  dtype=jnp.float32) -> jnp.ndarray:
    """[n, d] scrambled-Sobol points in (0,1), deterministic in ``key``.

    With ``scrambles=K`` (n divisible by K), the batch is K contiguous
    blocks of the SAME base points under independently seeded scrambles —
    K i.i.d. randomized-QMC replicates, for valid error bars.

    Jittable (and already jitted standalone); when called inside an outer
    jit the inner jit inlines.
    """
    if n % scrambles:
        raise ValueError("n must be a multiple of scrambles")
    v = jnp.asarray(direction_numbers(d))
    base = _sobol_bits(n // scrambles, v)
    seeds = jax.random.bits(key, (scrambles, d), "uint32")
    blocks = jax.vmap(lambda s: _owen_scramble(base, s))(seeds)
    return _to_unit(blocks.reshape(n, d), dtype)


def sobol_normal(key, n: int, d: int, scrambles: int = 1,
                 dtype=jnp.float32) -> jnp.ndarray:
    """[n, d] standard-normal scrambled-Sobol draws (inverse-CDF transform)."""
    from jax.scipy.special import ndtri

    return ndtri(sobol_uniform(key, n, d, scrambles, dtype))
