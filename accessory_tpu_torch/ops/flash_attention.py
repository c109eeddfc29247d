"""Causal self-attention with native GQA (prefill at position 0, and the
cache-free training forward), with its backward.

Port of ``accessory_tpu/ops/flash_attention.py::flash_attention_tpu`` (which
calls JAX's bundled TPU splash kernel, custom VJP and all). The CUDA kernels
are ``csrc/flash_attention.cu`` (forward; for training it also stores each
row's f32 log-sum-exp) and ``csrc/flash_attention_bwd.cu`` (dq, then dk / dv
summed over each KV head's group). On a CPU tensor the plain versions run:
``ops.attention.grouped_attention`` forward and ``flash_attention_bwd_plain``,
the explicit backward formula over P recomputed from the lse. The kernels
mask a ragged end themselves, so every length is served (the TPU path padded
to 128 and required q_len >= 128).

``flash_attention`` is differentiable in q, k and v (``_FlashAttention``);
called where no gradient is wanted (serving) it runs the forward alone,
without the lse.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops.attention import NEG_INF, grouped_attention

_P, _L, _I, _F = kernels.P, kernels.L, kernels.I, kernels.F
_ARGS = [_P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _I, _I, _I, _I, _I, _F, _P, _P]
_BWD_DQ_ARGS = [_P, _L, _L] * 5 + [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
_BWD_DKDV_ARGS = [_P, _L, _L] * 4 + [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention: q (b, s, nq, hd), k/v (b, s, nkv, hd) -> (b, s, nq, hd)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale, with_lse=False)[0]


class _FlashAttention(torch.autograd.Function):
    """The forward saves q, k, v, the output and the per-row lse; the
    backward is ``flash_attention_bwd`` (the splash custom VJP's role)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, ctx.scale)
        return dq, dk, dv, None


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               more=()) -> None:
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    for tag, t, heads in (("q", q, nq), ("k", k, nkv), ("v", v, nkv)) + tuple(more):
        if not (t.device == q.device and t.dtype == torch.bfloat16
                and tuple(t.shape) == (b, s, heads, hd)
                and t.stride(3) == 1 and t.stride(2) == hd and t.stride(0) % 8 == 0
                and t.stride(1) % 8 == 0 and t.data_ptr() % 16 == 0):
            raise ValueError(f"{name}: {tag} must be bf16 (b, s, heads, hd) on q's device, "
                             "with contiguous heads and 16-byte aligned token rows")
    if hd not in (64, 128) or nq % nkv:
        raise ValueError(f"{name}: head_dim {hd} (64 or 128), heads {nq}/{nkv}")


def _forward(q, k, v, scale, with_lse: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if q.device.type == "cpu":
        out = grouped_attention(q, k, v, causal=True, scale=scale)
        return out, (attention_lse(q, k, scale) if with_lse else None)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    _check_qkv("flash_attention", q, k, v)
    b, s, nq, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty((b, s, nq, hd), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, nq, s), dtype=torch.float32, device=q.device) if with_lse else None
    fn = kernels.function("flash_attention", "flash_attention_fwd", _ARGS)
    rc = fn(q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(), k.stride(0), k.stride(1),
            v.data_ptr(), v.stride(0), v.stride(1), out.data_ptr(), b, s, nq, k.shape[2], hd,
            scale, None if lse is None else lse.data_ptr(), kernels.stream_ptr(q))
    kernels.check("flash_attention", rc)
    return out, lse


def attention_lse(q: torch.Tensor, k: torch.Tensor, scale: Optional[float] = None
                  ) -> torch.Tensor:
    """Per-row log-sum-exp (b, nq, s) f32 of the causal scaled scores, the
    plain counterpart of the forward kernel's lse output."""
    b, s, nq, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    scores = _scores(q, k, scale)
    return torch.logsumexp(scores, dim=-1).reshape(b, nq, s)


def _scores(q, k, scale):
    """Causal scaled scores (b, nkv, R, s, s) f32, masked with NEG_INF."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, s, nkv, nq // nkv, hd).to(torch.float32)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qg, k.to(torch.float32)) * scale
    idx = torch.arange(s, device=q.device)
    causal = idx[None, :] <= idx[:, None]
    return torch.where(causal, scores, torch.full_like(scores, NEG_INF))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq (b, s, nq, hd), dk / dv (b, s, nkv, hd) of causal attention, from the
    forward's output and f32 lse (b, nq, s): two kernel launches on a CUDA
    tensor (dq with D = rowsum(dout * out), then dk / dv), the plain formula
    on a CPU one."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_bwd: no kernel for device {q.device}")
    dout = dout.contiguous()
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    _check_qkv("flash_attention_bwd", q, k, v, (("out", out, nq), ("dout", dout, nq)))
    if not (lse.device == q.device and lse.dtype == torch.float32 and lse.is_contiguous()
            and tuple(lse.shape) == (b, nq, s)):
        raise ValueError("flash_attention_bwd: lse must be contiguous f32 (b, nq, s)")
    scale = hd ** -0.5 if scale is None else scale
    d = torch.empty((b, nq, s), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, s, nq, hd), dtype=torch.bfloat16, device=q.device)
    dk = torch.empty((b, s, nkv, hd), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty_like(dk)
    st = kernels.stream_ptr(q)
    strided = lambda t: (t.data_ptr(), t.stride(0), t.stride(1))  # noqa: E731
    fn = kernels.function("flash_attention_bwd", "flash_attention_bwd_dq", _BWD_DQ_ARGS)
    rc = fn(*strided(q), *strided(k), *strided(v), *strided(out), *strided(dout),
            lse.data_ptr(), d.data_ptr(), dq.data_ptr(), b, s, nq, nkv, hd, scale, st)
    kernels.check("flash_attention_bwd_dq", rc)
    fn = kernels.function("flash_attention_bwd", "flash_attention_bwd_dkdv", _BWD_DKDV_ARGS)
    rc = fn(*strided(q), *strided(k), *strided(v), *strided(dout), lse.data_ptr(),
            d.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, nq, nkv, hd, scale, st)
    kernels.check("flash_attention_bwd_dkdv", rc)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, out, dout, lse, scale: Optional[float] = None):
    """The explicit backward in f32: P = exp(S - lse) (causal), dV = P^T dO
    (P in v's dtype, as the forward's value product takes it), dP = dO V^T,
    dS = P (dP - D) with D = rowsum(dO * O), dQ = scale dS K,
    dK = scale dS^T Q, dK / dV summed over each KV head's group. It gives the
    gradients ``grouped_attention`` has under autograd, up to where bf16
    rounds."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    r = nq // nkv
    scale = hd ** -0.5 if scale is None else scale
    f32 = torch.float32
    p = torch.exp(_scores(q, k, scale) - lse.reshape(b, nkv, r, s)[..., None])
    do = dout.reshape(b, s, nkv, r, hd).to(f32)
    dv = torch.einsum("bkrqs,bqkrh->bskh", p.to(v.dtype).to(f32), do)
    dp = torch.einsum("bqkrh,bskh->bkrqs", do, v.to(f32))
    d = (do * out.reshape(b, s, nkv, r, hd).to(f32)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (dp - d[..., None])
    dq = torch.einsum("bkrqs,bskh->bqkrh", ds, k.to(f32)) * scale
    dk = torch.einsum("bkrqs,bqkrh->bskh", ds, q.reshape(b, s, nkv, r, hd).to(f32)) * scale
    return (dq.reshape(b, s, nq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
