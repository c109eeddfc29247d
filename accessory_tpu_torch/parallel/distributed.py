"""Process-group initialization and the global mesh.

Port of ``accessory_tpu/parallel/distributed.py`` (``init_distributed_mode``,
``make_global_mesh``) over ``torch.distributed``: one process a card, NCCL
between cards and gloo on the CPU. Discovery follows the reference's order:
explicit arguments, then the variables torchrun sets (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), then SLURM's
(``SLURM_STEP_NODELIST``, ``SLURM_NPROCS``, ``SLURM_PROCID``,
``SLURM_LOCALID``), then a single process. Unlike the JAX version, which does
nothing on one host, a single process still gets a one-rank group (an
in-memory store), so meshes and collectives run the same at world size 1.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

from accessory_tpu_torch.parallel.mesh import make_mesh

DEFAULT_PORT = 29500


def _discover(init_method: Optional[str], world_size: Optional[int], rank: Optional[int],
              env: Mapping[str, str]) -> Dict[str, object]:
    """(init_method, world_size, rank, local_rank) from the arguments, then
    torchrun's variables, then SLURM's, then one process (init_method None:
    an in-memory store)."""
    if init_method is not None:
        rank = 0 if rank is None else rank
        return {"init_method": init_method, "world_size": 1 if world_size is None else world_size,
                "rank": rank, "local_rank": int(env.get("LOCAL_RANK", rank))}
    if "MASTER_ADDR" in env and "WORLD_SIZE" in env and "RANK" in env:
        rank = int(env["RANK"]) if rank is None else rank
        return {"init_method": "env://",
                "world_size": int(env["WORLD_SIZE"]) if world_size is None else world_size,
                "rank": rank, "local_rank": int(env.get("LOCAL_RANK", rank))}
    if "SLURM_STEP_NODELIST" in env:
        # the allocation's first node hosts the store, as the reference does
        node = env["SLURM_STEP_NODELIST"].split(",")[0].split("[")[0]
        port = int(env.get("MASTER_PORT", DEFAULT_PORT))
        rank = int(env.get("SLURM_PROCID", 0)) if rank is None else rank
        return {"init_method": f"tcp://{node}:{port}",
                "world_size": int(env.get("SLURM_NPROCS", 1)) if world_size is None
                else world_size,
                "rank": rank, "local_rank": int(env.get("SLURM_LOCALID", rank))}
    return {"init_method": None, "world_size": 1, "rank": 0, "local_rank": 0}


def init_distributed_mode(init_method: Optional[str] = None, world_size: Optional[int] = None,
                          rank: Optional[int] = None, device: str = "cuda"
                          ) -> Dict[str, object]:
    """Join (or create) the default process group; a no-op past the first
    call. ``init_method``: e.g. ``tcp://host:port`` or ``file:///path`` (with
    ``world_size`` and ``rank``). ``device``: "cuda" takes NCCL and sets this
    process's card (the local rank modulo the cards it sees), "cpu" gloo.
    Returns {rank, world_size, local_rank, local_devices, backend}."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"init_distributed_mode: device {device!r} (cuda or cpu)")
    found = _discover(init_method, world_size, rank, os.environ)
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed_mode: no CUDA device (device='cpu' for gloo)")
        torch.cuda.set_device(found["local_rank"] % torch.cuda.device_count())
    if not dist.is_initialized():
        if found["init_method"] is None:
            dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
        else:
            dist.init_process_group(backend, init_method=found["init_method"],
                                    world_size=found["world_size"], rank=found["rank"])
    return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "local_rank": found["local_rank"],
            "local_devices": torch.cuda.device_count() if device == "cuda" else 1,
            "backend": dist.get_backend()}


def make_global_mesh(tp: int = 1, fsdp: int = 1, ep: int = 1, device: str = "cuda"):
    """Mesh (dp, fsdp, ep, tp) over every rank: dp takes what tp * fsdp * ep
    leave. Ranks are numbered host-major, so the inner axes stay on one host's
    NVLink and dp spans the hosts. (The JAX version's ``dcn_dp``, a hybrid
    device order across slices, waits for a multi-host mesh: ROADMAP A10.)"""
    world = dist.get_world_size() if dist.is_initialized() else 1
    inner = tp * fsdp * ep
    dp = world // inner
    if dp < 1 or dp * inner != world:
        raise ValueError(f"world {world} does not split into tp {tp} x fsdp {fsdp} x ep {ep}")
    return make_mesh({"dp": dp, "fsdp": fsdp, "ep": ep, "tp": tp}, device)
