"""Host-side utilities of the port: the KV-dtype and remat policies."""

from __future__ import annotations

import functools
from typing import Callable, Optional

from torch.utils.checkpoint import checkpoint


def resolve_kv_dtype(kv_dtype: Optional[str]) -> Optional[str]:
    """The KV-cache dtype policy: an explicit ``kv_dtype`` wins ("int8" / "i8"
    for the int8 cache; "fp", "bf16" or "bfloat16" for the activation dtype),
    and ``None`` means the activation dtype. Returns "int8" or None.

    Port of ``accessory_tpu/util/__init__.py::resolve_kv_dtype`` without its
    environment variable and without its backend rule: the JAX package turns
    int8 on by default on its own accelerator from measurements taken there;
    on this port int8 is opt-in."""
    if kv_dtype in ("int8", "i8"):
        return "int8"
    if kv_dtype in (None, "fp", "bf16", "bfloat16"):
        return None
    raise ValueError(f"kv_dtype={kv_dtype!r}: expected None, 'fp', 'bf16' or 'int8'")


def remat_policy(remat) -> Optional[Callable]:
    """How the training forward checkpoints a layer: None (``remat`` False:
    keep every activation) or ``torch.utils.checkpoint.checkpoint``
    (non-reentrant), which keeps the layer's input and runs its forward again
    in the backward.

    Port of ``accessory_tpu/util/__init__.py::remat_policy``. ``"full"`` is
    the reference's policy (save nothing inside the block). ``True`` /
    ``"dots"`` (the reference saves the matmul and attention outputs and
    recomputes the rest) take the same full route here: the same numbers,
    more recompute; a selective policy is later work (ROADMAP A7)."""
    if remat is None or remat is False:
        return None
    if remat is True or remat in ("dots", "full"):
        return functools.partial(checkpoint, use_reentrant=False)
    raise ValueError(f"remat={remat!r}: expected False, True, 'dots' or 'full'")
