"""Rotary position embeddings, f32 math. Port of ``accessory_tpu/ops/rope.py``.

"interleaved" pairs consecutive elements (x0, x1), (x2, x3), ... (Meta
LLaMA); "half" pairs (x_i, x_{i + d/2}) (NeoX / HF). ``rope_rows`` bakes one
position's rotation into per-column rows for the fused wqkv epilogue.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def precompute_rope(head_dim: int, max_len: int, theta: float = 10000.0,
                    scaling: Optional[float] = None,
                    device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (max_len, head_dim // 2) f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    freqs = 1.0 / (theta ** exps)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    if scaling is not None:
        t = t * scaling
    angles = torch.outer(t, freqs)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               style: str = "interleaved") -> torch.Tensor:
    """Rotate q or k: x (batch, seq, heads, head_dim); cos/sin (seq, hd/2) or
    (batch, seq, hd/2). f32 math, result cast back to x.dtype."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    if cos.ndim == 3:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    if style == "interleaved":
        xr = xf.reshape(*xf.shape[:-1], -1, 2)
        x0, x1 = xr[..., 0], xr[..., 1]
        out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(xf.shape)
    elif style == "half":
        half = xf.shape[-1] // 2
        x0, x1 = xf[..., :half], xf[..., half:]
        out = torch.cat([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    else:
        raise ValueError(f"unknown rope style: {style}")
    return out.to(dtype)


def rope_rows(cos: torch.Tensor, sin: torch.Tensor, n_rot_heads: int,
              n_pass_heads: int, head_dim: int, style: str):
    """Per-column (cos_row, sin_row) for rotating a flat fused projection
    output (..., (n_rot + n_pass) * head_dim) in place of per-head RoPE.

    cos/sin: (..., head_dim // 2) for one position per leading index (a
    decode step: every batch row shares it). sin carries the pair sign (the
    first element of each pair subtracts its partner); pass-through columns
    (the fused v projection) get cos 1, sin 0."""
    hd = head_dim
    lead = cos.shape[:-1]
    dev = cos.device
    if style == "interleaved":
        c = torch.repeat_interleave(cos, 2, dim=-1)
        s = torch.repeat_interleave(sin, 2, dim=-1)
        sign = torch.tensor([-1.0, 1.0], dtype=torch.float32, device=dev).repeat(hd // 2)
    elif style == "half":
        c = torch.cat([cos, cos], dim=-1)
        s = torch.cat([sin, sin], dim=-1)
        sign = torch.cat([torch.full((hd // 2,), -1.0, device=dev),
                          torch.ones(hd // 2, device=dev)])
    else:
        raise ValueError(f"unknown rope style: {style}")
    reps = (1,) * len(lead) + (n_rot_heads,)
    cos_row = torch.cat([c.repeat(reps), torch.ones(*lead, n_pass_heads * hd, device=dev)], dim=-1)
    sin_row = torch.cat([(s * sign).repeat(reps),
                         torch.zeros(*lead, n_pass_heads * hd, device=dev)], dim=-1)
    return cos_row.to(torch.float32).contiguous(), sin_row.to(torch.float32).contiguous()


def rotate_flat(yf: torch.Tensor, cos_row: torch.Tensor, sin_row: torch.Tensor,
                style: str, head_dim: int) -> torch.Tensor:
    """f32 column rotation y * cos_row + partner(y) * sin_row (no cast)."""
    if style == "interleaved":
        yr = yf.reshape(*yf.shape[:-1], -1, 2)
        partner = torch.stack([yr[..., 1], yr[..., 0]], dim=-1).reshape(yf.shape)
    elif style == "half":
        half = head_dim // 2
        yr = yf.reshape(*yf.shape[:-1], -1, head_dim)
        partner = torch.cat([yr[..., half:], yr[..., :half]], dim=-1).reshape(yf.shape)
    else:
        raise ValueError(f"unknown rope style: {style}")
    return yf * cos_row + partner * sin_row


def apply_rope_flat(y: torch.Tensor, cos_row: torch.Tensor, sin_row: torch.Tensor,
                    style: str, head_dim: int) -> torch.Tensor:
    """Rotate y (..., N) columnwise with rope_rows outputs; f32 math, cast back."""
    return rotate_flat(y.to(torch.float32), cos_row, sin_row, style, head_dim).to(y.dtype)
