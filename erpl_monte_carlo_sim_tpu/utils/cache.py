"""Persistent XLA compile cache: the one place a cache directory is chosen.

Every entry point (the analyzer, ``bench.py``, ``chip_smoke.py``,
``__graft_entry__.py``, ``scripts/*``, the test conftest) calls
``enable_persistent_cache()``. With ``JAX_COMPILATION_CACHE_DIR`` set, jax
already uses that directory and nothing is changed. Otherwise the cache is
the fixed ``.jax_compile_cache`` at the root of this checkout (the path is
part of the cache key, so it must not move between runs), suffixed with a
host fingerprint on the CPU backend.
"""

from __future__ import annotations

import hashlib
import os

__all__ = ["default_cache_dir", "enable_persistent_cache", "host_fingerprint"]

_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_compile_cache")


def host_fingerprint() -> str:
    """8-hex-char digest of this host's CPU feature flags.

    XLA:CPU persists AOT-compiled executables keyed only by program +
    compiler version; an entry compiled on a host with wider SIMD features
    (amx/avx512) replayed on a narrower host is a latent SIGILL. CPU-platform
    cache dirs are therefore keyed by this fingerprint so each host
    population is disjoint. GPU executables do not depend on the host CPU;
    that cache stays unkeyed.

    Known cosmetic residue: this jax/XLA build also logs
    ``cpu_aot_loader`` "machine features don't match" errors for entries
    written BY THE SAME HOST, because XLA embeds the pseudo-features
    ``+prefer-no-scatter/+prefer-no-gather`` in the AOT result and the
    loader can't find them in host CPUID. Those messages are noise — the
    entries load; only a mismatch in REAL features (the amx/avx512 class
    this fingerprint keys on) is dangerous.
    """
    try:
        flags = ""
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
        return hashlib.sha256(flags.encode()).hexdigest()[:8]
    except OSError:  # pragma: no cover - non-Linux
        return "unknown"


def default_cache_dir(cpu: bool) -> str:
    """The checkout-local cache directory; host-keyed on the CPU backend."""
    return f"{_DEFAULT_DIR}-{host_fingerprint()}" if cpu else _DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Point jax at the persistent compile cache and return its directory.

    A directory already configured (``JAX_COMPILATION_CACHE_DIR`` or an
    explicit ``jax.config`` update) is left exactly as it is. Otherwise the
    checkout-local default is set. Idempotent; safe before or after backend
    initialization (the keys are process-level)."""
    import jax

    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    plats = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    path = default_cache_dir("cpu" in str(plats).split(","))
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)
    return path
