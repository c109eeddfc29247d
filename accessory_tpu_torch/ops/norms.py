"""RMSNorm and LayerNorm. Port of ``accessory_tpu/ops/norms.py`` with the
same f32 op order (rms_norm: mean of squares, sqrt, reciprocal, scale, cast
back; layer_norm: mean, mean of squared deviations, reciprocal sqrt, scale,
bias, cast back)."""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.to(torch.float32)
    normed = xf * torch.reciprocal(torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps))
    return (normed * weight.to(torch.float32)).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (Falcon, and InternLM with ``norm_type="layernorm"``)."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    out = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps)) * weight.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(dtype)
