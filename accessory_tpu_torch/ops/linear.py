"""Linear application over plain or W4-quantized weights. Port of
``accessory_tpu/ops/linear.py`` (linear, module_linear, module_linear_nr).

On the port a folded-layout W4 module with fewer than BIGM_ROWS rows takes
the fused kernel call: the norm prologue folds whatever the K tiling (the JAX
package's in_dim == tile_k rule is a TPU block constraint), as do the RoPE
and residual epilogues. With BIGM_ROWS rows or more (a batched prefill) it
takes the unfused composition, as in the JAX package, so that
``quant_matmul`` routes the product to the many-row kernel. Other weights
take the unfused composition too.
"""

from __future__ import annotations

from typing import Optional

import torch

from accessory_tpu_torch.ops.norms import rms_norm
from accessory_tpu_torch.ops.rope import apply_rope_flat
from accessory_tpu_torch.quant.qtensor import BIGM_ROWS, QuantizedWeight, quant_matmul


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in_dim) @ w (in_dim, out_dim) [+ b]."""
    y = quant_matmul(x, w) if isinstance(w, QuantizedWeight) else torch.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def module_linear(x: torch.Tensor, mod: dict) -> torch.Tensor:
    """{"weight", ["bias"], ["lora_a", "lora_b"]}: y = x@W [+ b] + (x@A)@B."""
    y = linear(x, mod["weight"], mod.get("bias"))
    if "lora_a" in mod:
        y = y + linear(linear(x, mod["lora_a"]), mod["lora_b"]).to(y.dtype)
    return y


def module_linear_nr(x: torch.Tensor, mod: dict, *, norm: Optional[dict] = None,
                     eps: float = 1e-5, residual: Optional[torch.Tensor] = None,
                     rope: Optional[tuple] = None) -> torch.Tensor:
    """``residual + rope(module_linear(rms_norm(x), mod))``, folded into one
    W4 kernel call when the weight allows it.

    ``rope``: (cos_row, sin_row, style, head_dim) decode-RoPE rows
    (ops.rope.rope_rows) for the fused wqkv projection."""
    w = mod.get("weight")
    m_rows = x.numel() // x.shape[-1]
    if (m_rows < BIGM_ROWS and isinstance(w, QuantizedWeight) and w.layout == "folded"
            and "lora_a" not in mod and mod.get("bias") is None and x.shape[-1] <= w.in_dim):
        return quant_matmul(x, w, norm_weight=None if norm is None else norm["weight"],
                            norm_eps=eps, residual=residual, rope=rope)
    xn = x if norm is None else rms_norm(x, norm["weight"], eps)
    y = module_linear(xn, mod)
    if rope is not None:
        cos_row, sin_row, style, hd = rope
        y = apply_rope_flat(y, cos_row, sin_row, style, hd)
    return y if residual is None else residual + y
