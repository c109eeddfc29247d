"""Decode attention fused with the KV-cache write, and the prefill slab write,
over a bf16 cache or an int8 cache with per-token scales.

Port of the per-layer path of ``accessory_tpu/ops/decode_attention.py``:
``decode_attention_update`` (TPU kernels _kernel_bloop_w for GQA and
_kernel_hgrp_w for one query head per KV head), ``decode_attention_update8``
(_kernel_hgrp_w8), ``quantize_kv_chunk``, ``write_kv_layer`` (_write_kernel4),
``write_kv_layer8`` (_write_kernel4_q8) and ``cached_attention_t``'s
position-0 prefill dispatch. The port's cache layout is (B, NKV, S, HD): each
cached token of a head is one contiguous row, and the int8 cache's scale
pools are (B, NKV, S) f32. (The JAX package's lane-major (B, NKV, HD, S)
layout is a TPU choice.) Caches are updated in place.

CUDA kernels: ``csrc/decode_attention.cu`` (GQA), ``csrc/decode_attention_mha.cu``
(R = 1, bf16 and int8) and ``csrc/kv_write.cu`` (both slab writes). Their
plain versions (``*_plain``) follow the TPU kernels' op order and run for
tensors on the CPU. The fused decode kernels serve any cache length and the
slab writes any chunk length and position.
"""

from __future__ import annotations

import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops.attention import attention

NEG_INF = -1e30
KV_SCALE_EPS = 1e-6

_ATTN_ARGS = [kernels.P, kernels.L, kernels.P, kernels.L, kernels.P, kernels.L, kernels.P,
              kernels.P, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I,
              kernels.F, kernels.P, kernels.P]
_MHA_ARGS = [kernels.P, kernels.L, kernels.P, kernels.L, kernels.P, kernels.L, kernels.P,
             kernels.P, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.F,
             kernels.P, kernels.P]
_MHA8_ARGS = _MHA_ARGS[:8] + [kernels.P, kernels.P] + _MHA_ARGS[8:]
_WRITE_ARGS = [kernels.P, kernels.L, kernels.L, kernels.P, kernels.L, kernels.L, kernels.P,
               kernels.P, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I,
               kernels.P]
_WRITE8_ARGS = _WRITE_ARGS[:8] + [kernels.P, kernels.P] + _WRITE_ARGS[8:]


def decode_attention_update(q, k_new, v_new, cache_k, cache_v, pos: int):
    """One decode step of attention plus the cache write, in one kernel.

    q (b, 1, nq, hd); k_new/v_new (b, 1, nkv, hd); cache_* (b, nkv, S, hd);
    pos: tokens already cached (every row shares it). Attention covers the
    cached tokens < pos and the new token; then k/v land at index pos.
    Returns (out (b, 1, nq, hd), cache_k, cache_v), caches written in place.
    Two kernels share the plain version: nq == nkv goes to the MHA kernel,
    nq > nkv to the GQA kernel."""
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
    if r == 1:  # the MHA kernel reads q / k_new / v_new with 16-byte loads
        ok = ok and _aligned16(q, k_new, v_new)
    if not ok:
        raise ValueError("decode_attention_update: needs bf16 q (b,1,nq,hd), k/v (b,1,nkv,hd) "
                         "with contiguous heads (16-byte aligned rows when nq == nkv), "
                         "contiguous caches (b,nkv,S,hd), all on q's device, hd 64/128, "
                         f"0 <= pos < S; got q {tuple(q.shape)} cache {tuple(cache_k.shape)} "
                         f"pos {pos}")
    out = torch.empty((b, 1, nq, hd), dtype=torch.bfloat16, device=q.device)
    if r == 1:
        # one query head per KV head: the kernel that spreads the cached tokens
        # over a block's warps (the JAX package's _pick_g_blk rule, r != 1 -> 0)
        fn = kernels.function("decode_attention_mha", "decode_attention_mha", _MHA_ARGS)
        rc = fn(q.data_ptr(), q.stride(0), k_new.data_ptr(), k_new.stride(0),
                v_new.data_ptr(), v_new.stride(0), cache_k.data_ptr(), cache_v.data_ptr(), b,
                nkv, s_len, hd, pos, hd ** -0.5, out.data_ptr(), kernels.stream_ptr(q))
        kernels.check("decode_attention_mha", rc)
        return out, cache_k, cache_v
    fn = kernels.function("decode_attention", "decode_attention_update", _ATTN_ARGS)
    rc = fn(q.data_ptr(), q.stride(0), k_new.data_ptr(), k_new.stride(0), v_new.data_ptr(),
            v_new.stride(0), cache_k.data_ptr(), cache_v.data_ptr(), b, nkv, s_len, r, hd,
            pos, hd ** -0.5, out.data_ptr(), kernels.stream_ptr(q))
    kernels.check("decode_attention", rc)
    return out, cache_k, cache_v


def _int8_pools_ok(pools, b: int, nkv: int, s_len: int, hd: int) -> bool:
    """Contiguous int8 k/v pools (b, nkv, S, hd), 16-byte aligned, and f32
    scale pools (b, nkv, S)."""
    cache_k, cache_v, cache_ks, cache_vs = pools
    return (all(t.dtype == torch.int8 and t.is_contiguous() and t.data_ptr() % 16 == 0
                and tuple(t.shape) == (b, nkv, s_len, hd) for t in (cache_k, cache_v))
            and all(t.dtype == torch.float32 and t.is_contiguous()
                    and tuple(t.shape) == (b, nkv, s_len) for t in (cache_ks, cache_vs)))


def _aligned16(*tensors) -> bool:
    """Batch rows start on 16-byte boundaries (bf16: strides in multiples of 8)."""
    return all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 for t in tensors)


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


def quantize_kv_chunk(x: torch.Tensor):
    """(..., HD) float -> (int8 (..., HD), f32 scales (...,)): symmetric
    per-vector quantization, scale = max(amax, 1e-6) / 127 (an all-zero
    vector stays exactly zero), q = clip(round(x / scale), -127, 127) with
    round half to even and a true division, bit-equal to the JAX package."""
    xf = x.to(torch.float32)
    # a tensor divisor: PyTorch turns a division by a Python scalar on a CUDA
    # tensor into a multiplication by its reciprocal, which rounds differently
    sc = torch.clamp_min(xf.abs().amax(dim=-1), KV_SCALE_EPS) / xf.new_tensor(127.0)
    q = torch.clamp(torch.round(xf / sc[..., None]), -127, 127).to(torch.int8)
    return q, sc


def decode_attention_update8(q, k_new, v_new, cache_k, cache_v, cache_ks, cache_vs, pos: int):
    """int8 sibling of decode_attention_update: attention over the int8 cache
    and the quantized in-place write of the new token, in one kernel.

    cache_k/v (b, nkv, S, hd) int8; cache_ks/vs (b, nkv, S) f32 scales. The
    new token's k/v enter the softmax unquantized and are quantized only as
    they land at index pos. Returns (out, cache_k, cache_v, cache_ks,
    cache_vs), the four pools written in place. On a CUDA tensor only
    nq == nkv is served."""
    if q.device.type == "cpu":
        return decode_attention_update8_plain(q, k_new, v_new, cache_k, cache_v, cache_ks,
                                              cache_vs, pos)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attention_update8: no kernel for device {q.device}")
    b, sq, nq, hd = q.shape
    _, nkv, s_len, _ = cache_k.shape
    if nq != nkv:
        raise NotImplementedError(
            f"int8 decode attention with {nq // max(nkv, 1)} query heads per KV head: the "
            "GQA int8 kernel (_kernel_bloop_w8, PERF.md kernel table row 13, ROADMAP B7) is "
            "not ported; only one query head per KV head is served")
    pools = (cache_k, cache_v, cache_ks, cache_vs)
    ok = (sq == 1 and hd in (64, 128) and 0 <= pos < s_len
          and all(t.device == q.device for t in (k_new, v_new) + pools)
          and _aligned16(q, k_new, v_new))
    for t in (q, k_new, v_new):
        ok = ok and (t.dtype == torch.bfloat16 and tuple(t.shape) == (b, 1, nkv, hd)
                     and t.stride(3) == 1 and t.stride(2) == hd)
    if not (ok and _int8_pools_ok(pools, b, nkv, s_len, hd)):
        raise ValueError("decode_attention_update8: needs bf16 q/k/v (b,1,nkv,hd) with "
                         "contiguous heads and 16-byte aligned rows, contiguous int8 caches "
                         "(b,nkv,S,hd) and f32 scale pools (b,nkv,S), all on q's device, hd "
                         f"64/128, 0 <= pos < S; got q {tuple(q.shape)} cache "
                         f"{tuple(cache_k.shape)} {cache_k.dtype} pos {pos}")
    out = torch.empty((b, 1, nq, hd), dtype=torch.bfloat16, device=q.device)
    fn = kernels.function("decode_attention_mha", "decode_attention_mha8", _MHA8_ARGS)
    rc = fn(q.data_ptr(), q.stride(0), k_new.data_ptr(), k_new.stride(0), v_new.data_ptr(),
            v_new.stride(0), cache_k.data_ptr(), cache_v.data_ptr(), cache_ks.data_ptr(),
            cache_vs.data_ptr(), b, nkv, s_len, hd, pos, hd ** -0.5, out.data_ptr(),
            kernels.stream_ptr(q))
    kernels.check("decode_attention_mha8", rc)
    return out, cache_k, cache_v, cache_ks, cache_vs


def decode_attention_update8_plain(q, k_new, v_new, cache_k, cache_v, cache_ks, cache_vs,
                                   pos: int):
    """Plain version, the TPU kernel's op order (any nq / nkv): scores are the
    bf16 q . int8 k sums in f32 times (k scale * softmax scale); the new token
    is the exact second part of the softmax; p * v scale is rounded to bf16
    for the value product; then the new token is quantized and written."""
    b, _, nq, hd = q.shape
    nkv = cache_k.shape[1]
    r = nq // nkv
    scale = hd ** -0.5
    qf = q.reshape(b, nkv, r, hd).to(torch.float32)
    kn = k_new.reshape(b, nkv, 1, hd).to(torch.float32)
    vn = v_new.reshape(b, nkv, 1, hd).to(torch.float32)
    s_new = (qf * kn).sum(dim=-1, keepdim=True) * scale
    if pos > 0:
        qb = q.reshape(b, nkv, r, hd).to(torch.bfloat16).to(torch.float32)
        kc = cache_k[:, :, :pos].to(torch.float32)
        vc = cache_v[:, :, :pos].to(torch.float32)
        ks = cache_ks[:, :, None, :pos]
        vs = cache_vs[:, :, None, :pos]
        s_old = torch.einsum("bkrh,bksh->bkrs", qb, kc) * (ks * scale)
        m = torch.maximum(s_old.amax(dim=-1, keepdim=True), s_new)
        p_old = torch.exp(s_old - m)
        p_new = torch.exp(s_new - m)
        denom = p_old.sum(dim=-1, keepdim=True) + p_new
        pv = (p_old * vs).to(torch.bfloat16).to(torch.float32)
        out = torch.einsum("bkrs,bksh->bkrh", pv, vc) + p_new * vn
    else:
        denom = torch.ones_like(s_new)
        out = vn.expand(b, nkv, r, hd)
    out = (out / denom).to(q.dtype).reshape(b, 1, nq, hd)
    kq, ksc = quantize_kv_chunk(k_new[:, 0])
    vq, vsc = quantize_kv_chunk(v_new[:, 0])
    cache_k[:, :, pos] = kq
    cache_v[:, :, pos] = vq
    cache_ks[:, :, pos] = ksc
    cache_vs[:, :, pos] = vsc
    return out, cache_k, cache_v, cache_ks, cache_vs


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


def write_kv_layer8(cache_k, cache_v, cache_ks, cache_vs, new_k, new_v, pos: int):
    """Quantize a chunk new_* (B, sq, NKV, HD) and write it into the int8
    pools cache_k/v (B, NKV, S, HD) and the f32 scale pools cache_ks/vs
    (B, NKV, S) at token rows [pos, pos + sq), in place, in one kernel.
    Returns the four pools."""
    if new_k.device.type == "cpu":
        return write_kv_layer8_plain(cache_k, cache_v, cache_ks, cache_vs, new_k, new_v, pos)
    if new_k.device.type != "cuda":
        raise RuntimeError(f"write_kv_layer8: no kernel for device {new_k.device}")
    b, sq, nkv, hd = new_k.shape
    s_len = cache_k.shape[2]
    pools = (cache_k, cache_v, cache_ks, cache_vs)
    ok = (hd in (64, 128, 256) and 0 <= pos and pos + sq <= s_len
          and all(t.device == new_k.device for t in (new_v,) + pools))
    for t in (new_k, new_v):
        ok = ok and (t.dtype == torch.bfloat16 and tuple(t.shape) == (b, sq, nkv, hd)
                     and t.stride(3) == 1 and t.stride(2) == hd and t.stride(0) % 8 == 0
                     and t.stride(1) % 8 == 0 and t.data_ptr() % 16 == 0)
    if not (ok and _int8_pools_ok(pools, b, nkv, s_len, hd)):
        raise ValueError("write_kv_layer8: needs bf16 chunks (B,sq,NKV,HD) with contiguous, "
                         "16-byte aligned heads, contiguous int8 caches (B,NKV,S,HD) and f32 "
                         "scale pools (B,NKV,S), all on one device, HD 64/128/256, pos + sq "
                         f"<= S; got {tuple(new_k.shape)} into {tuple(cache_k.shape)} "
                         f"{cache_k.dtype} at {pos}")
    fn = kernels.function("kv_write", "kv_write_slab_q8", _WRITE8_ARGS)
    rc = fn(new_k.data_ptr(), new_k.stride(0), new_k.stride(1), new_v.data_ptr(),
            new_v.stride(0), new_v.stride(1), cache_k.data_ptr(), cache_v.data_ptr(),
            cache_ks.data_ptr(), cache_vs.data_ptr(), b, sq, nkv, hd, s_len, pos,
            kernels.stream_ptr(new_k))
    kernels.check("kv_write_q8", rc)
    return cache_k, cache_v, cache_ks, cache_vs


def write_kv_layer8_plain(cache_k, cache_v, cache_ks, cache_vs, new_k, new_v, pos: int):
    """Plain version: quantize_kv_chunk, then a strided copy_ per pool."""
    sq = new_k.shape[1]
    kq, ksc = quantize_kv_chunk(new_k)
    vq, vsc = quantize_kv_chunk(new_v)
    cache_k[:, :, pos:pos + sq].copy_(kq.transpose(1, 2))
    cache_v[:, :, pos:pos + sq].copy_(vq.transpose(1, 2))
    cache_ks[:, :, pos:pos + sq].copy_(ksc.transpose(1, 2))
    cache_vs[:, :, pos:pos + sq].copy_(vsc.transpose(1, 2))
    return cache_k, cache_v, cache_ks, cache_vs


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
