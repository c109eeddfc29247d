"""Decode attention fused with the KV-cache write, and the prefill slab write.

Port of the per-layer bf16 path of ``accessory_tpu/ops/decode_attention.py``:
``decode_attention_update`` (TPU kernel _kernel_bloop_w), ``write_kv_layer``
(TPU kernel _write_kernel4) and ``cached_attention_t``'s position-0 prefill
dispatch. The port's cache layout is (B, NKV, S, HD): each cached token of a
head is one contiguous HD * 2-byte row. (The JAX package's lane-major
(B, NKV, HD, S) layout is a TPU choice.) Caches are updated in place.

CUDA kernels: ``csrc/decode_attention.cu`` and ``csrc/kv_write.cu``. Their
plain versions (``*_plain``) follow the TPU kernels' op order and run for
tensors on the CPU. The fused decode kernel serves any cache length and the
slab write any chunk length and position.
"""

from __future__ import annotations

import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops.attention import attention

NEG_INF = -1e30

_ATTN_ARGS = [kernels.P, kernels.L, kernels.P, kernels.L, kernels.P, kernels.L, kernels.P,
              kernels.P, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I,
              kernels.F, kernels.P, kernels.P]
_WRITE_ARGS = [kernels.P, kernels.L, kernels.L, kernels.P, kernels.L, kernels.L, kernels.P,
               kernels.P, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I,
               kernels.P]


def decode_attention_update(q, k_new, v_new, cache_k, cache_v, pos: int):
    """One decode step of attention plus the cache write, in one kernel.

    q (b, 1, nq, hd); k_new/v_new (b, 1, nkv, hd); cache_* (b, nkv, S, hd);
    pos: tokens already cached (every row shares it). Attention covers the
    cached tokens < pos and the new token; then k/v land at index pos.
    Returns (out (b, 1, nq, hd), cache_k, cache_v), caches written in place."""
    if q.device.type == "cpu":
        return decode_attention_update_plain(q, k_new, v_new, cache_k, cache_v, pos)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attention_update: no kernel for device {q.device}")
    b, sq, nq, hd = q.shape
    _, nkv, s_len, _ = cache_k.shape
    r = nq // nkv
    ok = (sq == 1 and nq % nkv == 0 and hd in (64, 128) and r <= (32 if hd == 64 else 16)
          and 0 <= pos < s_len
          and all(t.device == q.device for t in (k_new, v_new, cache_k, cache_v)))
    for t, heads in ((q, nq), (k_new, nkv), (v_new, nkv)):
        ok = ok and (t.dtype == torch.bfloat16 and tuple(t.shape) == (b, 1, heads, hd)
                     and t.stride(3) == 1 and t.stride(2) == hd)
    for t in (cache_k, cache_v):
        ok = ok and (t.dtype == torch.bfloat16 and t.is_contiguous()
                     and tuple(t.shape) == (b, nkv, s_len, hd) and t.data_ptr() % 16 == 0)
    if not ok:
        raise ValueError("decode_attention_update: needs bf16 q (b,1,nq,hd), k/v (b,1,nkv,hd) "
                         "with contiguous heads, contiguous caches (b,nkv,S,hd), all on q's "
                         "device, hd 64/128, "
                         f"0 <= pos < S; got q {tuple(q.shape)} cache {tuple(cache_k.shape)} "
                         f"pos {pos}")
    out = torch.empty((b, 1, nq, hd), dtype=torch.bfloat16, device=q.device)
    fn = kernels.function("decode_attention", "decode_attention_update", _ATTN_ARGS)
    rc = fn(q.data_ptr(), q.stride(0), k_new.data_ptr(), k_new.stride(0), v_new.data_ptr(),
            v_new.stride(0), cache_k.data_ptr(), cache_v.data_ptr(), b, nkv, s_len, r, hd,
            pos, hd ** -0.5, out.data_ptr(), kernels.stream_ptr(q))
    kernels.check("decode_attention", rc)
    return out, cache_k, cache_v


def decode_attention_update_plain(q, k_new, v_new, cache_k, cache_v, pos: int):
    """Plain version, the TPU kernel's op order: two-part softmax in f32 over
    the cached tokens < pos and the new token, p cast to the cache dtype for
    the value product, new token's term in f32."""
    b, _, nq, hd = q.shape
    nkv = cache_k.shape[1]
    scale = hd ** -0.5
    qf = q.reshape(b, nkv, nq // nkv, hd).to(torch.float32)
    kn = k_new.reshape(b, nkv, 1, hd).to(torch.float32)
    vn = v_new.reshape(b, nkv, 1, hd).to(torch.float32)
    s_new = (qf * kn).sum(dim=-1, keepdim=True) * scale            # (b, nkv, r, 1)
    if pos > 0:
        kc = cache_k[:, :, :pos].to(torch.float32)
        vc = cache_v[:, :, :pos]
        s_old = torch.einsum("bkrh,bksh->bkrs", qf, kc) * scale
        m = torch.maximum(s_old.amax(dim=-1, keepdim=True), s_new)
        p_old = torch.exp(s_old - m)
        p_new = torch.exp(s_new - m)
        denom = p_old.sum(dim=-1, keepdim=True) + p_new
        out = torch.einsum("bkrs,bksh->bkrh", p_old.to(vc.dtype).to(torch.float32),
                           vc.to(torch.float32))
        out = out + p_new * vn
    else:
        denom = torch.ones_like(s_new)
        out = vn.expand(b, nkv, nq // nkv, hd)
    out = (out / denom).to(q.dtype).reshape(b, 1, nq, hd)
    cache_k[:, :, pos] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, :, pos] = v_new[:, 0].to(cache_v.dtype)
    return out, cache_k, cache_v


def write_kv_layer(cache_k, cache_v, new_k, new_v, pos: int):
    """Write a chunk new_* (B, sq, NKV, HD) into cache_* (B, NKV, S, HD) at
    token rows [pos, pos + sq), in place. Returns (cache_k, cache_v)."""
    if new_k.device.type == "cpu":
        return write_kv_layer_plain(cache_k, cache_v, new_k, new_v, pos)
    if new_k.device.type != "cuda":
        raise RuntimeError(f"write_kv_layer: no kernel for device {new_k.device}")
    b, sq, nkv, hd = new_k.shape
    s_len = cache_k.shape[2]
    ok = (hd % 8 == 0 and 0 <= pos and pos + sq <= s_len
          and all(t.device == new_k.device for t in (new_v, cache_k, cache_v)))
    for t in (new_k, new_v):
        ok = ok and (t.dtype == torch.bfloat16 and tuple(t.shape) == (b, sq, nkv, hd)
                     and t.stride(3) == 1 and t.stride(2) == hd and t.stride(0) % 8 == 0
                     and t.stride(1) % 8 == 0 and t.data_ptr() % 16 == 0)
    for t in (cache_k, cache_v):
        ok = ok and (t.dtype == torch.bfloat16 and t.is_contiguous()
                     and tuple(t.shape) == (b, nkv, s_len, hd) and t.data_ptr() % 16 == 0)
    if not ok:
        raise ValueError("write_kv_layer: needs bf16 chunks (B,sq,NKV,HD) with contiguous, "
                         "16-byte aligned heads, contiguous caches (B,NKV,S,HD), all on one "
                         f"device, pos + sq <= S; got {tuple(new_k.shape)} into "
                         f"{tuple(cache_k.shape)} at {pos}")
    fn = kernels.function("kv_write", "kv_write_slab", _WRITE_ARGS)
    rc = fn(new_k.data_ptr(), new_k.stride(0), new_k.stride(1), new_v.data_ptr(),
            new_v.stride(0), new_v.stride(1), cache_k.data_ptr(), cache_v.data_ptr(), b, sq,
            nkv, hd, s_len, pos, kernels.stream_ptr(new_k))
    kernels.check("kv_write", rc)
    return cache_k, cache_v


def write_kv_layer_plain(cache_k, cache_v, new_k, new_v, pos: int):
    """Plain version: a strided copy_ per pool."""
    sq = new_k.shape[1]
    cache_k[:, :, pos:pos + sq].copy_(new_k.transpose(1, 2))
    cache_v[:, :, pos:pos + sq].copy_(new_v.transpose(1, 2))
    return cache_k, cache_v


def cached_attention_t(q, k_new, v_new, cache_k, cache_v, pos):
    """Attention of a new chunk over the cache, cache read-only.

    Ported case: a position-0 prefill, where nothing valid is cached, is
    plain causal self-attention and goes to the flash kernel at any length.
    A chunk after cached tokens (chunked prefill) and read-only decode are
    not ported yet."""
    if isinstance(pos, int) and pos == 0:
        return attention(q, k_new, v_new, causal=True, q_offset=0)
    raise NotImplementedError(
        "attention of a chunk after cached tokens: read-only decode attention "
        "(_kernel_bloop, ROADMAP B12) and chunked prefill (ROADMAP A7) are not ported")
