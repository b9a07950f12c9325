"""Device-mesh construction and batch sharding helpers.

The reference's entire distributed layer is a single-host
``ProcessPoolExecutor`` moving pickled scenes (`monte_carlo.py:63-141`). The
replacement: put the Monte Carlo batch axis on a ``jax.sharding.Mesh``
and let XLA insert the collectives (NCCL between GPUs). There is exactly
one parallelism in this problem — data parallelism over Monte Carlo lanes
(SURVEY.md §2) — so the mesh is 1-D and every batched leaf is sharded along
it; scene tables stay replicated.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh", "shard_batch", "replicate", "pad_to_devices", "BATCH_AXIS",
    "init_distributed", "make_global_batch",
]

BATCH_AXIS = "batch"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Multi-host entry point: join a ``jax.distributed`` job.

    The pod-scale replacement for the reference's single-host process pool
    (`monte_carlo.py:92-154`): after this, ``jax.devices()`` is the GLOBAL
    device list, a ``make_mesh()`` spans hosts, lane shards ride the
    device interconnect within a host and the network across hosts, and
    ``collective_stats`` reductions are global. No-op (returns 0) when called single-process with no
    coordinator. Returns this process's id.

    Pass the three arguments explicitly (the coordinator is
    ``host:port`` of process 0), e.g. for CPU multi-process validation
    (``scripts/pod_scale.py --num-processes N --process-id I``).
    """
    if coordinator_address is None and num_processes is None:
        return 0
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_index()


def make_global_batch(tree, mesh: Mesh, local_batch: int,
                      axis_name: str = BATCH_AXIS, base_tree=None):
    """Assemble per-process local leaves into global sharded arrays.

    Each process passes ITS lanes (leading axis ``local_batch``); leaves
    gain a global leading axis of ``local_batch * num_processes``. Shared
    leaves (no batch axis) must be identical on every process and are
    replicated. This is the multi-host analogue of ``shard_batch`` (which
    only works when one process addresses every device).

    ``base_tree``: the UNBATCHED twin of ``tree`` (same structure, leaves
    without the lane axis — e.g. the nominal scene for a dispersed scene
    batch). When given, a leaf is classified as batched iff it gained a
    dimension over its base leaf — the same rule as ``mc.scene_in_axes``.
    Pass it whenever available: the shape heuristic alone misclassifies a
    SHARED leaf whose leading dim happens to equal ``local_batch`` (e.g. a
    100-point wind grid with 100 local lanes), and unlike ``shard_batch``
    (where jax arrays stay logically global) assembly from process-local
    data CONCATENATES misclassified leaves into a corrupt global value.
    """
    import numpy as np

    sharded = NamedSharding(mesh, P(axis_name))
    repl = NamedSharding(mesh, P())

    def put(x, base=None):
        x = np.asarray(x)
        if base is not None:
            batched = x.ndim > np.ndim(base)
        else:
            batched = x.ndim >= 1 and x.shape[0] == local_batch
        if batched:
            return jax.make_array_from_process_local_data(sharded, x)
        return jax.make_array_from_process_local_data(repl, x)

    if base_tree is not None:
        return jax.tree.map(put, tree, base_tree)
    return jax.tree.map(put, tree)


def make_mesh(devices: Optional[Sequence] = None, n_devices: Optional[int] = None,
              axis_name: str = BATCH_AXIS) -> Mesh:
    """1-D mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.array(devices), (axis_name,))


def pad_to_devices(n: int, mesh: Mesh, axis_name: str = BATCH_AXIS) -> int:
    """Smallest multiple of the mesh axis size >= n (lane padding)."""
    size = mesh.shape[axis_name]
    return ((n + size - 1) // size) * size


def shard_batch(tree, mesh: Mesh, batch_size: int, axis_name: str = BATCH_AXIS):
    """Place leaves with a leading ``batch_size`` axis on the mesh (sharded
    along it); everything else is replicated."""
    sharded = NamedSharding(mesh, P(axis_name))
    repl = NamedSharding(mesh, P())

    def put(x):
        x = jnp.asarray(x)
        if x.ndim >= 1 and x.shape[0] == batch_size:
            return jax.device_put(x, sharded)
        return jax.device_put(x, repl)

    return jax.tree.map(put, tree)


def replicate(tree, mesh: Mesh):
    repl = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), repl), tree)
