"""Mid-run checkpoint / resume for slabbed Monte Carlo runs.

``mc.checkpoint.save_summaries`` persists a COMPLETED analysis; this
module persists the slab loop's accumulator state MID-RUN so a killed
multi-hour run (100M+ lanes) resumes from the last
checkpointed slab instead of restarting. Because every slab's
dispersions derive from ``fold_in(run_key, slab_idx)`` and all
accumulation is deterministic host-side merging, a resumed run produces
BIT-IDENTICAL results to an uninterrupted one (pinned by
``tests/test_slab_checkpoint.py``).

Usage::

    analyzer.run_monte_carlo(ic, n_samples=100_000_000,
                             checkpoint_path="run.ckpt.npz",
                             checkpoint_every=16)

If the process dies, re-running the SAME call resumes; the file is
removed on successful completion. A fingerprint of everything that
shapes per-slab results (scene/ic/params/config pytrees + sampler knobs)
guards against resuming into a different run — mismatches raise instead
of silently mixing two populations.

Reference counterpart: none — its closest notion of resume is "every
trajectory is a JSON file and seeds are deterministic" (SURVEY.md §5.4);
at reference scale (minutes) restarting is fine. This exists because the
batched rebuild runs 5-6 orders of magnitude more lanes per call.

Format notes: one uncompressed ``.npz`` (state is written every
``checkpoint_every`` slabs — zlib on the ~100 MB worst case would cost a
visible fraction of a slab's sim time), written atomically
(tmp + ``os.replace``) so a crash mid-write never corrupts the previous
checkpoint.
"""

from __future__ import annotations

import hashlib
import json
import os

import jax
import numpy as np

from .stats import StreamingStats

__all__ = ["run_fingerprint", "save_slab_state", "load_slab_state"]

# v5: accumulator-registry format — the container version only changes
# when the ENVELOPE changes; each accumulator carries its own schema
# version in meta["acc"][key]["version"] (mc.slab_accumulators), so
# adding an estimator no longer revs the whole file format.
_VERSION = 5


def run_fingerprint(analyzer, ic, n_samples, slab, seed, base_wind,
                    chunk_steps, limit) -> str:
    """Digest of everything that determines per-slab results and
    accumulator shapes. Two runs with equal fingerprints execute
    identical slab sequences; anything else must refuse to resume."""
    h = hashlib.sha256()

    def tree(t):
        leaves, treedef = jax.tree_util.tree_flatten(t)
        h.update(str(treedef).encode())
        for leaf in leaves:
            arr = np.asarray(leaf)
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(np.ascontiguousarray(arr).tobytes())

    tree(analyzer.scene)
    tree(ic)
    tree(base_wind)
    # frozen dataclasses of primitives: repr is a stable total description
    h.update(repr(analyzer.uncertainty_params).encode())
    h.update(repr(analyzer.sim_config).encode())
    h.update(repr(analyzer.bounds).encode())
    h.update(json.dumps([
        _VERSION, int(n_samples), int(slab), int(seed),
        # backend: XLA transcendentals differ ~1e-8 between platforms
        # (CLAUDE.md), so a GPU run resumed on CPU would silently mix two
        # numerically different slab populations — refuse instead
        jax.default_backend(),
        analyzer.sampler, int(analyzer.sobol_scrambles),
        int(analyzer.sobol_wind_modes), bool(analyzer.antithetic),
        list(analyzer.importance_shift),
        bool(analyzer.control_variates), int(analyzer.cv_wind_modes),
        int(analyzer.cv_wind_speed),
        int(analyzer.stats_stream_threshold),
        int(analyzer.metrics_sample_cap),
        int(analyzer.wind_grid_points), float(analyzer.wind_grid_top),
        None if chunk_steps is None else int(chunk_steps),
        int(limit),
    ]).encode())
    return h.hexdigest()


def _pack_stream(s: StreamingStats, out: dict, prefix: str) -> None:
    # _warned rides along so the "logged once" contract of the
    # multimodality sketch warning survives a checkpoint resume.
    out[prefix + "moments"] = np.asarray(
        [s.n, s._mean, s._m2, s._min, s._max,
         float(getattr(s, "_warned", False))], np.float64
    )
    if s._exact_parts is not None:
        parts = s._exact_parts
        out[prefix + "exact"] = (
            np.concatenate(parts) if parts else np.empty(0)
        )
        # part boundaries matter for bit-identical resume: at the
        # exact->sketch crossing each part is compressed SEPARATELY, so
        # restoring one concatenated part would build different centroids
        # than the uninterrupted run
        out[prefix + "exact_lens"] = np.asarray(
            [p.size for p in parts], np.int64
        )
    else:
        out[prefix + "cent_v"] = s._cent_v
        out[prefix + "cent_w"] = s._cent_w


def _unpack_stream(z, prefix: str, exact_threshold: int) -> StreamingStats:
    s = StreamingStats(exact_threshold=exact_threshold)
    mo = z[prefix + "moments"]
    n, mean, m2, mn, mx = mo[:5]
    s.n = int(n)
    s._mean, s._m2 = float(mean), float(m2)
    s._min, s._max = float(mn), float(mx)
    # 6th slot (absent in pre-r5 checkpoints): the warn-once latch.
    s._warned = bool(mo[5]) if mo.size > 5 else False
    if prefix + "exact" in z:
        lens = z[prefix + "exact_lens"]
        s._exact_parts = (
            list(np.split(z[prefix + "exact"], np.cumsum(lens)[:-1]))
            if lens.size else []
        )
    else:
        s._exact_parts = None
        s._cent_v = z[prefix + "cent_v"]
        s._cent_w = z[prefix + "cent_w"]
    return s


def save_slab_state(path: str, loop: dict, accs: list,
                    fingerprint: str) -> None:
    """Atomically persist the slab loop's state: the three loop counters
    plus every registry accumulator's leaves (``mc.slab_accumulators`` —
    each contributes npz arrays via ``to_arrays`` and JSON-native state
    via ``meta_state``, under its own ``key``/``version``)."""
    arrays: dict = {}
    meta = {
        "version": _VERSION,
        "fingerprint": fingerprint,
        "n_done": int(loop["n_done"]),
        "slab_idx": int(loop["slab_idx"]),
        "n_valid_total": int(loop["n_valid_total"]),
        # per-accumulator schema version + JSON-native state (floats
        # survive json round-trip exactly: repr-roundtrip)
        "acc": {},
    }
    for acc in accs:
        acc.to_arrays(arrays)
        meta["acc"][acc.key] = {"version": acc.version,
                                "state": acc.meta_state()}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_slab_state(path: str, fingerprint: str,
                    accs: list) -> dict | None:
    """Restore the registry accumulators IN PLACE and return the loop
    counters, or None when no checkpoint exists. A fingerprint mismatch
    raises — silently restarting (or worse, resuming a DIFFERENT run's
    accumulators) would corrupt results. Per-accumulator versions are
    checked too: equal fingerprints imply the same registry keys, but an
    accumulator whose internal schema evolved must refuse its old leaves."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta["version"] != _VERSION:
            raise ValueError(
                f"checkpoint {path!r} uses format v{meta['version']}; "
                f"this build writes v{_VERSION} — delete it (or finish "
                "the run with the build that wrote it)"
            )
        if meta["fingerprint"] != fingerprint:
            raise ValueError(
                f"checkpoint {path!r} belongs to a different run "
                "(scene/config/sampling mismatch); delete it or point "
                "checkpoint_path elsewhere to start fresh"
            )
        saved = meta["acc"]
        keys = [a.key for a in accs]
        if sorted(saved) != sorted(keys):
            raise ValueError(
                f"checkpoint {path!r} holds accumulators {sorted(saved)} "
                f"but this run builds {sorted(keys)} — fingerprint "
                "collision or registry drift; delete the checkpoint"
            )
        for acc in accs:
            ent = saved[acc.key]
            if ent["version"] != acc.version:
                raise ValueError(
                    f"checkpoint accumulator {acc.key!r} is schema "
                    f"v{ent['version']}; this build expects "
                    f"v{acc.version} — delete the checkpoint"
                )
            acc.restore(z, ent["state"])
        return {"n_done": meta["n_done"], "slab_idx": meta["slab_idx"],
                "n_valid_total": meta["n_valid_total"]}
