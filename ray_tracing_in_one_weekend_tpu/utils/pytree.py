"""Frozen dataclasses registered as JAX pytrees.

Fields are pytree leaves unless declared with `static_field()`, which
makes them metadata: hashable, part of the jit cache key, never traced.
Instances get a `replace(**changes)` method (`dataclasses.replace`).
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field that is pytree metadata, not a leaf."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def pytree_dataclass(cls):
    """Decorator: frozen dataclass + `replace` + pytree registration."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls)
