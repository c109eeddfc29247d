"""Device mesh and the logical-axis rules.

Port of ``accessory_tpu/parallel/mesh.py`` (``DEFAULT_RULES``,
``INFERENCE_RULES``, ``make_mesh``, ``local_mesh``, ``logical_to_pspec``,
``_fit_spec``). A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks of the default process group (one rank a device), with named axes:
``dp`` (data parallel), ``fsdp``, ``ep``, ``cp`` (context parallel: the
sequence split, parallel/context.py) and ``tp`` (tensor parallel: the heads).
Each axis has its own process group (``mesh.get_group(name)``).

The rules map the logical axis names a model gives its parameters to mesh
axes, as in the JAX package; ``logical_to_pspec`` gives the port's
``PartitionSpec`` (a tuple, one entry per dimension). Placing parameters by
these specs (tensor and FSDP sharding of the model) waits for ROADMAP A10;
the context-parallel training step keeps every parameter whole on each rank.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch.distributed as dist

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicate)
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("dp", "fsdp"),
    "length": None,
    "layers": None,
    "vocab": "tp",
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "ffn": "tp",
    "experts": "ep",
    "expert_ffn": "tp",
}

# inference: no fsdp axis, weights tp-sharded, batch over dp
INFERENCE_RULES: Dict[str, Any] = {
    **DEFAULT_RULES,
    "batch": "dp",
    "embed": None,
}


class PartitionSpec(tuple):
    """Per-dimension mesh axes (None, an axis name or a tuple of names), the
    port's counterpart of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


def make_mesh(axes: Mapping[str, int], device: str = "cuda"):
    """A DeviceMesh with the given axis sizes, e.g. ``{"dp": 2, "cp": 2}``,
    over every rank of the default process group (``init_distributed_mode``
    first). Axis order follows dict order; the sizes must multiply to the
    world size. Axes of size 1 are kept. ``device``: "cuda" (NCCL, a rank a
    card) or "cpu" (gloo)."""
    names = tuple(axes.keys())
    sizes = tuple(axes.values())
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {dict(axes)} needs {math.prod(sizes)} devices, have {world}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.distributed.init_distributed_mode first")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, sizes, mesh_dim_names=names)


def local_mesh(tp: int = 1, dp: int = 1, fsdp: int = 1, ep: int = 1, cp: int = 1,
               device: str = "cuda"):
    """Mesh over every rank: (dp, fsdp, ep, cp, tp). ``cp`` is the
    context-parallel (sequence-sharding) axis, see parallel.context."""
    return make_mesh({"dp": dp, "fsdp": fsdp, "ep": ep, "cp": cp, "tp": tp}, device)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh (anything with ``mesh_dim_names`` and
    ``shape``, a DeviceMesh)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, name: Optional[str]) -> int:
    """The size of axis ``name``; 1 for None or an axis the mesh lacks."""
    return axis_sizes(mesh).get(name, 1) if name else 1


def axis_rank(mesh, name: Optional[str]) -> int:
    """This rank's coordinate along axis ``name``; 0 for an absent axis."""
    return mesh.get_local_rank(name) if axis_size(mesh, name) > 1 else 0


def _resolve(axis: Optional[str], rules: Mapping[str, Any], mesh_axes) -> Any:
    if axis is None:
        return None
    ma = rules.get(axis, None)
    if ma is None:
        return None
    if isinstance(ma, (tuple, list)):
        present = tuple(a for a in ma if a in mesh_axes)
        return present if present else None
    return ma if ma in mesh_axes else None


def logical_to_pspec(axes: Optional[Tuple[Optional[str], ...]],
                     rules: Mapping[str, Any] = DEFAULT_RULES, mesh=None) -> PartitionSpec:
    """A tuple of logical axis names -> a PartitionSpec. Mesh axes absent from
    ``mesh`` resolve to replication, so the same axes work on any mesh; with
    no mesh, every mesh axis the rules name counts as present."""
    if axes is None:
        return PartitionSpec()
    if mesh is not None:
        mesh_axes = set(mesh.mesh_dim_names)
    else:
        mesh_axes = set(a for v in rules.values()
                        for a in ((v,) if isinstance(v, str) else (v or ())))
    return PartitionSpec(*[_resolve(a, rules, mesh_axes) for a in axes])


def _fit_spec(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """Replicate any dimension whose size its mesh axes do not divide (the
    scales and zeros of a quantized weight at tiny test sizes)."""
    if mesh is None:
        return spec
    sizes = axis_sizes(mesh)
    out = []
    for d, ax in enumerate(tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))):
        size = math.prod(sizes[a] for a in ((ax,) if isinstance(ax, str) else ax)) if ax else 1
        out.append(ax if size and shape[d] % size == 0 else None)
    return PartitionSpec(*out)
