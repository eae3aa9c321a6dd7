"""MSC mesh roles — counterpart of `repro/sharding/specs.py:msc_axes`.

The reference's logical-axis rules for the LM parameters, caches and
batches (`ShardingRules`, `param_specs`, ...) are not ported: ROADMAP.md
queue 1 item 9 (rest).
"""
from __future__ import annotations

from typing import Optional, Tuple

Axes = Tuple[str, ...]

MESH_REST_TODO = ("composite slice axes, the serving engines on a mesh and "
                  "the LM serving meshes are not ported yet: ROADMAP.md, "
                  "queue 1 item 9 (rest)")


def msc_axes(mesh, inner_axis: Optional[str] = "inner",
             mode_axis: str = "mode") -> Tuple[Axes, Axes]:
    """(slice_axes, inner_axes) for an MSC DeviceMesh.

    The inner dim is taken when the mesh names it; every other dim
    except the grouped schedule's mode dim plays the slice role.  A slice
    role over more than one dim (the reference's composite slice axis of
    a production (data, model) mesh) raises NotImplementedError.
    """
    names = tuple(mesh.mesh_dim_names or ())
    inner: Axes = (inner_axis,) if inner_axis and inner_axis in names else ()
    slices = tuple(a for a in names if a not in inner and a != mode_axis)
    if len(slices) > 1:
        raise NotImplementedError(f"slice role over the mesh dims {slices}: "
                                  f"{MESH_REST_TODO}")
    return slices, inner
