"""Host-side utilities of the port."""

from __future__ import annotations

from typing import Optional


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
