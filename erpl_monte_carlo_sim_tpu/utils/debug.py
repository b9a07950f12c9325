"""Debug & observability helpers.

The reference had none of this (SURVEY.md §5.1-5.2: bare prints, NumPy
overflow warnings as its only 'race detection'). JAX equivalents:

  * ``debug_mode()``     — context manager enabling ``jax_debug_nans`` (the
                           vmap-world replacement for per-process exception
                           swallowing: a NaN faults at the op that made it),
  * ``trace_profile()``  — wrap a region in a ``jax.profiler`` trace for
                           xprof/tensorboard inspection,
  * ``check_finite()``   — assert a pytree is finite, reporting which leaf.
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np

from .logging import get_logger

__all__ = ["debug_mode", "trace_profile", "check_finite"]

log = get_logger("debug")


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False):
    """Run a block with NaN-faulting (and optionally eager) execution."""
    prev_nans = jax.config.jax_debug_nans
    try:
        jax.config.update("jax_debug_nans", nans)
        if disable_jit:
            with jax.disable_jit():
                yield
        else:
            yield
    finally:
        jax.config.update("jax_debug_nans", prev_nans)


@contextlib.contextmanager
def trace_profile(log_dir: str = "/tmp/jax-trace"):
    """Capture a profiler trace of the enclosed block (view with xprof)."""
    with jax.profiler.trace(log_dir):
        yield
    log.info("profiler trace written to %s", log_dir)


def check_finite(tree, name: str = "tree") -> None:
    """Raise with the leaf path if any array in the pytree is non-finite."""
    leaves_with_paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in leaves_with_paths:
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"{name}{jax.tree_util.keystr(path)}: {bad} non-finite values"
            )
