"""Pytest bootstrap: force CPU JAX with a virtual 8-device mesh.

Multi-device sharding is validated on a host-platform device mesh (the
equivalent of "test multi-node without a cluster" — SURVEY.md §4).
x64 is enabled so golden-value comparisons against the float64 reference can
use tight tolerances; float32 behavior is tested with explicit dtypes.

Env vars alone are not enough here: a pytest plugin may import jax before
this file's module body runs, so the config is also set programmatically
(safe as long as no backend/trace has been created yet).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "1")

# Block zstandard BEFORE jax can import it: jax's persistent compile cache
# picks zstd when importable, zlib otherwise, and the zstd serialize path
# segfaulted twice mid-suite in round 3 (crash inside
# compilation_cache.put/get_executable_and_time on
# jit_simulate_flight-sized executables). zlib-compressed entries have run
# the full suite without incident. Setting the sys.modules entry to None
# makes `import zstandard` raise ImportError, which jax handles as
# "not installed".
sys.modules["zstandard"] = None  # type: ignore[assignment]

import jax  # noqa: E402

# The env vars alone are not enough: a plugin may have imported jax first,
# and jax 0.9 ignores --xla_force_host_platform_device_count.
# Programmatic config wins.
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
# Persistent compile cache for the CPU test config: compile time dominates
# the suite (gradient/equivalence tests compile multi-minute reverse
# programs), so warm re-runs are several times faster. utils.cache picks
# the directory: JAX_COMPILATION_CACHE_DIR if set, else the checkout's
# host-keyed CPU dir (XLA:CPU AOT entries embed the compiling host's SIMD
# features, and replaying them on a narrower host is a latent SIGILL).
# Entries here are zlib-compressed (zstandard blocked above).
from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_executables():
    """Bound live XLA:CPU executables to one module's worth.

    With the cache disabled the suite still segfaulted, deterministically,
    ~140 compiled programs into a full `-m "not slow"` run — inside
    jax's backend_compile_and_load while COMPILING a program that compiles
    fine standalone (tests/test_trajectory_batch.py::
    test_record_stride_subsamples; RSS only ~10 GB, so not host OOM). Both
    observed crash sites (cache deserialize, backend compile) are XLA
    executable load paths, pointing at accumulated in-process compiler/JIT
    state, not any one program. Dropping every cached executable between
    test modules keeps that state bounded; the cross-module recompile cost
    is minutes over the whole suite.
    """
    yield
    jax.clear_caches()
    gc.collect()
