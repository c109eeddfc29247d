"""Linear application over plain or W4-quantized weights. Port of
``accessory_tpu/ops/linear.py`` (linear, module_linear, module_linear_nr).

On the port a folded-layout W4 or a w8-layout W8 module with fewer than
BIGM_ROWS rows takes the fused kernel call: the norm prologue folds whatever
the K tiling (the JAX package's in_dim == tile_k rule is a TPU block
constraint), as do the RoPE and residual epilogues. With BIGM_ROWS rows or
more (a batched prefill) it takes the unfused composition, as in the JAX
package, so that ``quant_matmul`` routes the product to the many-row W4
kernel, or to the W8 kernel without fusions. Other weights (std, magic,
dense) take the unfused composition too.
"""

from __future__ import annotations

from typing import Optional

import torch

from accessory_tpu_torch.ops.norms import rms_norm
from accessory_tpu_torch.ops.rope import apply_rope_flat
from accessory_tpu_torch.quant.qtensor import (BIGM_ROWS, FUSED_LAYOUTS, QuantizedWeight,
                                               quant_matmul)
from accessory_tpu_torch.util import keeps, replayed


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in_dim) @ w (in_dim, out_dim) [+ b]. A dense product inside a
    layer checkpointed under ``remat=True`` is kept by the forward and taken
    back by the recompute (``util.replayed``, kind "dots")."""
    if isinstance(w, QuantizedWeight):
        y = quant_matmul(x, w)
    elif keeps("dots"):
        y = replayed("dots", lambda: _KeptProduct.apply(x, w, None),
                     lambda kept: _KeptProduct.apply(x, w, kept))
    else:
        y = torch.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


class _KeptProduct(torch.autograd.Function):
    """x @ w inside a layer that keeps its dense products: the forward
    computes it, the recompute is handed the value the forward kept
    (``kept``); both save the same tensors, so the checkpoint's check of the
    recompute against the forward holds, and differentiate as
    ``torch.matmul`` does (the product over x folded to 2-D)."""

    @staticmethod
    def forward(ctx, x, w, kept):
        x2d = x.reshape(-1, x.shape[-1])
        ctx.save_for_backward(x2d, w)
        ctx.x_shape = x.shape
        return torch.matmul(x, w) if kept is None else kept.view_as(kept)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gx = g2.mm(w.t()).reshape(ctx.x_shape) if ctx.needs_input_grad[0] else None
        gw = x2d.t().mm(g2) if ctx.needs_input_grad[1] else None
        return gx, gw, None


def module_linear(x: torch.Tensor, mod: dict) -> torch.Tensor:
    """{"weight", ["bias"], ["lora_a", "lora_b"]}: y = x@W [+ b] + (x@A)@B."""
    y = linear(x, mod["weight"], mod.get("bias"))
    if "lora_a" in mod:
        y = y + linear(linear(x, mod["lora_a"]), mod["lora_b"]).to(y.dtype)
    return y


def module_linear_nr(x: torch.Tensor, mod: dict, *, norm: Optional[dict] = None,
                     eps: float = 1e-5, residual: Optional[torch.Tensor] = None,
                     rope: Optional[tuple] = None, allow_fused: bool = True) -> torch.Tensor:
    """``residual + rope(module_linear(rms_norm(x), mod))``, folded into one
    W4 or W8 kernel call when the weight allows it.

    ``rope``: (cos_row, sin_row, style, head_dim) decode-RoPE rows
    (ops.rope.rope_rows) for the fused wqkv projection. ``allow_fused=False``
    forces the unfused composition: training passes it, because the fused
    kernel call has no backward (only the plain W4 product does), and e.g.
    norm-only QPEFT differentiates through wo / w2 modules that would
    otherwise fuse (reference ops/linear.py:37-71)."""
    w = mod.get("weight")
    m_rows = x.numel() // x.shape[-1]
    if (allow_fused and m_rows < BIGM_ROWS and isinstance(w, QuantizedWeight)
            and w.layout in FUSED_LAYOUTS
            and "lora_a" not in mod and mod.get("bias") is None and x.shape[-1] <= w.in_dim):
        return quant_matmul(x, w, norm_weight=None if norm is None else norm["weight"],
                            norm_eps=eps, residual=residual, rope=rope)
    xn = x if norm is None else rms_norm(x, norm["weight"], eps)
    y = module_linear(xn, mod)
    if rope is not None:
        cos_row, sin_row, style, hd = rope
        y = apply_rope_flat(y, cos_row, sin_row, style, hd)
    return y if residual is None else residual + y
