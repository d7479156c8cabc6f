"""Leaf-wise maps over the port's dataclass containers.

The JAX package registers its containers (SE3, State, Trajectory, ...) as
pytrees and maps over them with `jax.tree.map`. The port's containers are
plain dataclasses of tensors; `tree_map` walks their fields the same way.
"""

from __future__ import annotations

import dataclasses


def tree_map(fn, obj, *rest):
    """Apply `fn` to every tensor leaf of `obj` (and the matching leaves of
    `rest`, which share its structure). `None` fields stay `None`."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(
            obj,
            **{
                f.name: tree_map(
                    fn, getattr(obj, f.name), *(getattr(r, f.name) for r in rest)
                )
                for f in dataclasses.fields(obj)
            },
        )
    return fn(obj, *rest)
