"""RMSNorm. Port of ``accessory_tpu/ops/norms.py::rms_norm`` with the same
f32 op order (mean of squares, sqrt, reciprocal, scale, cast back)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.to(torch.float32)
    normed = xf * torch.reciprocal(torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps))
    return (normed * weight.to(torch.float32)).to(dtype)
