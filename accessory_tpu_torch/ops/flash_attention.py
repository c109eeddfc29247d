"""Causal self-attention forward with native GQA (prefill at position 0).

Port of ``accessory_tpu/ops/flash_attention.py::flash_attention_tpu`` (which
calls JAX's bundled TPU splash kernel). The CUDA kernel is
``csrc/flash_attention.cu``; on a CPU tensor the plain grouped attention
(ops.attention.grouped_attention) runs. The kernel masks a ragged end
itself, so every length is served (the TPU path padded to 128 and required
q_len >= 128).
"""

from __future__ import annotations

from typing import Optional

import torch

from accessory_tpu_torch import kernels

_ARGS = [kernels.P, kernels.L, kernels.L, kernels.P, kernels.L, kernels.L, kernels.P,
         kernels.L, kernels.L, kernels.P, kernels.I, kernels.I, kernels.I, kernels.I,
         kernels.I, kernels.F, kernels.P]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention: q (b, s, nq, hd), k/v (b, s, nkv, hd) -> (b, s, nq, hd)."""
    if q.device.type == "cpu":
        from accessory_tpu_torch.ops.attention import grouped_attention

        return grouped_attention(q, k, v, causal=True, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    for name, t, heads in (("q", q, nq), ("k", k, nkv), ("v", v, nkv)):
        if not (t.device == q.device and t.dtype == torch.bfloat16
                and tuple(t.shape) == (b, s, heads, hd)
                and t.stride(3) == 1 and t.stride(2) == hd and t.stride(0) % 8 == 0
                and t.stride(1) % 8 == 0 and t.data_ptr() % 16 == 0):
            raise ValueError(f"flash_attention: {name} must be bf16 (b, s, heads, hd) on "
                             "q's device, with contiguous heads and 16-byte aligned token rows")
    if hd not in (64, 128) or nq % nkv:
        raise ValueError(f"flash_attention: head_dim {hd} (64 or 128), heads {nq}/{nkv}")
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty((b, s, nq, hd), dtype=torch.bfloat16, device=q.device)
    fn = kernels.function("flash_attention", "flash_attention_fwd", _ARGS)
    rc = fn(q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(), k.stride(0), k.stride(1),
            v.data_ptr(), v.stride(0), v.stride(1), out.data_ptr(), b, s, nq, nkv, hd,
            scale, kernels.stream_ptr(q))
    kernels.check("flash_attention", rc)
    return out
