"""Frozen pytree dataclasses.

``@dataclass`` makes a frozen ``dataclasses.dataclass``, gives it a
``.replace(**updates)`` method and registers it with
``jax.tree_util.register_dataclass``. Fields declared with
``field(pytree_node=False)`` are static metadata (part of the treedef);
every other field is a child, in declaration order. That order is what
treedefs, ``mc.scene_in_axes`` and the slab checkpoints rely on.
"""

from __future__ import annotations

import dataclasses

import jax

__all__ = ["dataclass", "field"]


def field(pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` that records whether the field is a pytree
    child (``pytree_node=True``) or static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **updates):
    """A copy with the given fields replaced."""
    return dataclasses.replace(self, **updates)


def dataclass(cls):
    """Frozen dataclass registered as a JAX pytree (see module docstring)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields, meta_fields = [], []
    for f in dataclasses.fields(cls):
        if f.metadata.get("pytree_node", True):
            data_fields.append(f.name)
        else:
            meta_fields.append(f.name)
    cls.replace = _replace
    jax.tree_util.register_dataclass(cls, data_fields, meta_fields)
    return cls
