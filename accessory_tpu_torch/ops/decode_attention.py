"""Attention over the static KV cache and every write into it: a bf16 cache or
an int8 cache with per-token scales, per layer or stacked over the layers.

Port of ``accessory_tpu/ops/decode_attention.py``:

* ``decode_attention_update`` / ``decode_attention_update8``: one decode step
  of attention fused with the write of the new token (TPU kernels
  _kernel_bloop_w / _kernel_bloop_w8 for GQA, _kernel_hgrp_w / _kernel_hgrp_w8
  for one query head per KV head), or, with ``fused_attn_write=False``, the
  read-only attention followed by the one-token write;
* ``cached_attention_t`` / ``cached_attention_t8``: attention of a new chunk
  over a read-only cache: a position-0 prefill goes to the flash kernel, one
  token to the read-only decode kernels (_kernel_bloop and its (B, NKV)-grid
  form _kernel, _kernel_bloop8), a longer chunk after cached tokens to plain
  PyTorch (an XLA einsum in the JAX package too);
* ``write_kv_layer`` / ``write_kv_layer8``: a chunk into one layer's cache
  (_write_kernel4 / _write_kernel4_q8; at one token _col_write_kernel4 /
  _col_write_kernel4_q8);
* ``write_kv_t`` / ``write_kv_t8``: all layers' new k/v into a stacked cache
  in one call (_col_write_kernel at one token, _write_kernel for a slab; the
  int8 form is a dynamic_update_slice in the JAX package);
* ``quantize_kv_chunk`` / ``dequantize_kv``.

The port's cache layout is (B, NKV, S, HD), stacked (L, B, NKV, S, HD): each
cached token of a head is one contiguous row, and the int8 cache's scale
pools are (B, NKV, S) f32. (The JAX package's lane-major (B, NKV, HD, S)
layout is a TPU choice.) Caches are updated in place. Every position is one
int shared by the batch (the reference's cached_attention_t also takes a
(b,) tensor, which no caller there passes; per-row positions are the paged
cache's, engine/kvcache.py).

CUDA kernels: ``csrc/decode_attention.cu`` (GQA), ``csrc/decode_attention_mha.cu``
(one query head per KV head) and ``csrc/kv_write.cu`` (all writes). Their
plain versions (``*_plain``) follow the TPU kernels' op order and run for
tensors on the CPU. The kernels serve any cache length, chunk length and
position.
"""

from __future__ import annotations

import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops.attention import attention

NEG_INF = -1e30
KV_SCALE_EPS = 1e-6

P, I, L, F = kernels.P, kernels.I, kernels.L, kernels.F
_QKV_ARGS = [P, L, P, L, P, L]
_TAIL_ARGS = [F, P, P]                       # softmax scale, out, stream
# (q, k_new, v_new with batch strides) + pools + dims + tail
_GQA_ARGS = _QKV_ARGS + [P, P] + [I] * 6 + _TAIL_ARGS        # B NKV S R HD pos
_GQA8_ARGS = _QKV_ARGS + [P, P, P, P] + [I] * 6 + _TAIL_ARGS
_MHA_ARGS = _QKV_ARGS + [P, P] + [I] * 5 + _TAIL_ARGS        # B NKV S HD pos
_MHA8_ARGS = _QKV_ARGS + [P, P, P, P] + [I] * 5 + _TAIL_ARGS
_SLAB_SRC = [P, L, L, P, L, L]               # k, v with batch and token strides
_COL_SRC = [P, L, P, L]                      # k, v with batch strides
_WRITE_ARGS = _SLAB_SRC + [P, P] + [I] * 6 + [P]             # B sq NKV HD S pos
_WRITE8_ARGS = _SLAB_SRC + [P, P, P, P] + [I] * 6 + [P]
_COL_ARGS = _COL_SRC + [P, P] + [I] * 5 + [P]                # B NKV HD S pos
_COL8_ARGS = _COL_SRC + [P, P, P, P] + [I] * 5 + [P]
_STACKED_ARGS = _SLAB_SRC + [P, P] + [I] * 7 + [P]           # L B sq NKV HD S pos
_STACKED_COL_ARGS = _COL_SRC + [P, P] + [I] * 6 + [P]        # L B NKV HD S pos
_STACKED8_ARGS = _SLAB_SRC + [P, P, P, P] + [I] * 7 + [P]

# decode kernels by (one query head per KV head, int8 cache, fused write):
# (source, C entry point, argument types); the launch-count name is the entry point's
_DECODE_KERNELS = {
    (False, False, True): ("decode_attention", "decode_attention", _GQA_ARGS),
    (False, True, True): ("decode_attention", "decode_attention8", _GQA8_ARGS),
    (False, False, False): ("decode_attention", "decode_attention_ro", _GQA_ARGS),
    (False, True, False): ("decode_attention", "decode_attention8_ro", _GQA8_ARGS),
    (True, False, True): ("decode_attention_mha", "decode_attention_mha", _MHA_ARGS),
    (True, True, True): ("decode_attention_mha", "decode_attention_mha8", _MHA8_ARGS),
    (True, False, False): ("decode_attention_mha", "decode_attention_mha_ro", _MHA_ARGS),
    (True, True, False): ("decode_attention_mha", "decode_attention_mha8_ro", _MHA8_ARGS),
}


def _int_pos(fn: str, pos) -> int:
    if isinstance(pos, bool) or not isinstance(pos, int):
        raise NotImplementedError(
            f"{fn}: pos must be one int shared by the batch, got {type(pos).__name__}; "
            "per-row positions are served by the paged cache (engine.kvcache."
            "paged_cached_attention, models.llama.forward_paged)")
    return pos


def _pools_ok(pools, shape) -> bool:
    """Contiguous, 16-byte aligned k/v pools of ``shape`` (..., S, HD), bf16, or
    int8 with f32 scale pools of ``shape[:-1]``."""
    kv_dtype = torch.int8 if len(pools) == 4 else torch.bfloat16
    return (all(t.dtype == kv_dtype and t.is_contiguous() and t.data_ptr() % 16 == 0
                and tuple(t.shape) == tuple(shape) for t in pools[:2])
            and all(t.dtype == torch.float32 and t.is_contiguous()
                    and tuple(t.shape) == tuple(shape[:-1]) for t in pools[2:]))


def _aligned16(*tensors) -> bool:
    """Batch rows start on 16-byte boundaries (bf16: strides in multiples of 8)."""
    return all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 for t in tensors)


def _decode_kernel(fn: str, q, k_new, v_new, pools, pos: int, write: bool):
    """Launch the decode-attention kernel that serves these operands on the
    card: GQA or one-query-head, bf16 or int8 pools, fused write or read-only."""
    b, sq, nq, hd = q.shape
    _, nkv, s_len, _ = pools[0].shape
    r = nq // max(nkv, 1)
    int8 = len(pools) == 4
    ok = (sq == 1 and nkv > 0 and nq % nkv == 0 and hd in (64, 128)
          and r <= (32 if hd == 64 else 16) and 0 <= pos <= (s_len - 1 if write else s_len)
          and all(t.device == q.device for t in (k_new, v_new) + tuple(pools))
          and _pools_ok(pools, (b, nkv, s_len, hd)))
    for t, heads in ((q, nq), (k_new, nkv), (v_new, nkv)):
        ok = ok and (t.dtype == torch.bfloat16 and tuple(t.shape) == (b, 1, heads, hd)
                     and t.stride(3) == 1 and t.stride(2) == hd)
    if r == 1:  # the one-query-head kernel reads q / k_new / v_new with 16-byte loads
        ok = ok and _aligned16(q, k_new, v_new)
    if not ok:
        raise ValueError(
            f"{fn}: needs bf16 q (b,1,nq,hd), k/v (b,1,nkv,hd) with contiguous heads (16-byte "
            "aligned rows when nq == nkv), contiguous 16-byte aligned caches (b,nkv,S,hd) "
            "(bf16, or int8 with f32 scale pools (b,nkv,S)), all on q's device, hd 64/128, "
            f"0 <= pos {'<' if write else '<='} S; got q {tuple(q.shape)} cache "
            f"{tuple(pools[0].shape)} {pools[0].dtype} pos {pos}")
    source, symbol, argtypes = _DECODE_KERNELS[(r == 1, int8, write)]
    out = torch.empty((b, 1, nq, hd), dtype=torch.bfloat16, device=q.device)
    dims = (b, nkv, s_len, hd, pos) if r == 1 else (b, nkv, s_len, r, hd, pos)
    rc = kernels.function(source, symbol, argtypes)(
        q.data_ptr(), q.stride(0), k_new.data_ptr(), k_new.stride(0), v_new.data_ptr(),
        v_new.stride(0), *(t.data_ptr() for t in pools), *dims, hd ** -0.5, out.data_ptr(),
        kernels.stream_ptr(q))
    kernels.check(symbol, rc)
    return out


def _device_route(fn: str, t: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain version (a CPU tensor)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{fn}: no kernel for device {t.device}")
    return True


# ---------------------------------------------------------------- decode attention, bf16


def decode_attention_update(q, k_new, v_new, cache_k, cache_v, pos: int,
                            fused_attn_write: bool = True):
    """One decode step of attention plus the cache write.

    q (b, 1, nq, hd); k_new/v_new (b, 1, nkv, hd); cache_* (b, nkv, S, hd);
    pos: tokens already cached (every row shares it). Attention covers the
    cached tokens < pos and the new token; then k/v land at index pos.
    Returns (out (b, 1, nq, hd), cache_k, cache_v), caches written in place.
    With ``fused_attn_write`` both happen in one kernel (nq == nkv: the
    one-query-head kernel, nq > nkv: the GQA kernel); without it the
    read-only attention is followed by the one-token write."""
    pos = _int_pos("decode_attention_update", pos)
    if not fused_attn_write:
        out = cached_attention_t(q, k_new, v_new, cache_k, cache_v, pos)
        return (out,) + write_kv_layer(cache_k, cache_v, k_new, v_new, pos)
    if not _device_route("decode_attention_update", q):
        return decode_attention_update_plain(q, k_new, v_new, cache_k, cache_v, pos)
    out = _decode_kernel("decode_attention_update", q, k_new, v_new, (cache_k, cache_v), pos,
                         write=True)
    return out, cache_k, cache_v


def cached_attention_decode_plain(q, k_new, v_new, cache_k, cache_v, pos: int):
    """Plain read-only decode attention, the TPU kernel's op order: two-part
    softmax in f32 over the cached tokens < pos and the new token, p cast to
    the cache dtype for the value product, new token's term in f32."""
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
    return (out / denom).to(q.dtype).reshape(b, 1, nq, hd)


def decode_attention_update_plain(q, k_new, v_new, cache_k, cache_v, pos: int):
    """Plain version of the fused step: the read-only attention, then the
    new token's k/v stored at index pos."""
    out = cached_attention_decode_plain(q, k_new, v_new, cache_k, cache_v, pos)
    cache_k[:, :, pos] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, :, pos] = v_new[:, 0].to(cache_v.dtype)
    return out, cache_k, cache_v


def cached_attention_chunk_plain(q, k_new, v_new, cache_k, cache_v, pos: int):
    """A chunk of sq tokens after ``pos`` cached ones (chunked prefill): one
    softmax over the cached tokens < pos and, causally, the chunk itself, all
    in f32. Plain PyTorch on every device (an XLA einsum in the JAX package)."""
    b, sq, nq, hd = q.shape
    nkv = cache_k.shape[1]
    scale = hd ** -0.5
    qg = q.reshape(b, sq, nkv, nq // nkv, hd).to(torch.float32)
    s_old = torch.einsum("bqkrh,bksh->bkrqs", qg, cache_k[:, :, :pos].to(torch.float32)) * scale
    s_new = torch.einsum("bqkrh,bskh->bkrqs", qg, k_new.to(torch.float32)) * scale
    idx = torch.arange(sq, device=q.device)
    causal = idx[None, :] <= idx[:, None]
    s_new = torch.where(causal, s_new, torch.full_like(s_new, NEG_INF))
    probs = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1)
    out = torch.einsum("bkrqs,bksh->bqkrh", probs[..., :pos],
                       cache_v[:, :, :pos].to(torch.float32))
    out = out + torch.einsum("bkrqs,bskh->bqkrh", probs[..., pos:], v_new.to(torch.float32))
    return out.reshape(b, sq, nq, hd).to(q.dtype)


def cached_attention_t(q, k_new, v_new, cache_k, cache_v, pos: int):
    """Attention of a new chunk (b, sq, ...) over the cache, cache read-only.

    A position-0 prefill, where nothing valid is cached, is plain causal
    self-attention and goes to the flash kernel at any length. One token goes
    to the read-only decode kernel (the GQA kernel, or the one-query-head
    kernel when nq == nkv). A longer chunk after cached tokens takes the plain
    two-part softmax."""
    pos = _int_pos("cached_attention_t", pos)
    sq = q.shape[1]
    if pos == 0 and sq > 1:
        return attention(q, k_new, v_new, causal=True, q_offset=0)
    if sq > 1:
        return cached_attention_chunk_plain(q, k_new, v_new, cache_k, cache_v, pos)
    if not _device_route("cached_attention_t", q):
        return cached_attention_decode_plain(q, k_new, v_new, cache_k, cache_v, pos)
    return _decode_kernel("cached_attention_t", q, k_new, v_new, (cache_k, cache_v), pos,
                          write=False)


# ---------------------------------------------------------------- int8 cache


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


def dequantize_kv(q: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """Inverse of quantize_kv_chunk: q (..., HD) int8 with sc (...,) -> f32.
    (The port's pools are token-major, so one form serves a pool and a chunk.)"""
    return q.to(torch.float32) * sc[..., None]


def decode_attention_update8(q, k_new, v_new, cache_k, cache_v, cache_ks, cache_vs, pos: int,
                             fused_attn_write: bool = True):
    """int8 sibling of decode_attention_update: attention over the int8 cache
    and the quantized in-place write of the new token.

    cache_k/v (b, nkv, S, hd) int8; cache_ks/vs (b, nkv, S) f32 scales. The
    new token's k/v enter the softmax unquantized and are quantized only as
    they land at index pos. Returns (out, cache_k, cache_v, cache_ks,
    cache_vs), the four pools written in place."""
    pos = _int_pos("decode_attention_update8", pos)
    pools = (cache_k, cache_v, cache_ks, cache_vs)
    if not fused_attn_write:
        out = cached_attention_t8(q, k_new, v_new, *pools, pos)
        return (out,) + write_kv_layer8(*pools, k_new, v_new, pos)
    if not _device_route("decode_attention_update8", q):
        return decode_attention_update8_plain(q, k_new, v_new, *pools, pos)
    out = _decode_kernel("decode_attention_update8", q, k_new, v_new, pools, pos, write=True)
    return (out,) + pools


def _decode8_plain(q, q_cached, k_new, v_new, cache_k, cache_v, cache_ks, cache_vs, pos: int):
    """The int8 two-part softmax with the q of the cached scores given apart
    (``q_cached``, f32 (b, nkv, r, hd)) from the q of the new token's score."""
    b, _, nq, hd = q.shape
    nkv = cache_k.shape[1]
    r = nq // nkv
    scale = hd ** -0.5
    qf = q.reshape(b, nkv, r, hd).to(torch.float32)
    kn = k_new.reshape(b, nkv, 1, hd).to(torch.float32)
    vn = v_new.reshape(b, nkv, 1, hd).to(torch.float32)
    s_new = (qf * kn).sum(dim=-1, keepdim=True) * scale
    if pos > 0:
        kc = cache_k[:, :, :pos].to(torch.float32)
        vc = cache_v[:, :, :pos].to(torch.float32)
        ks = cache_ks[:, :, None, :pos]
        vs = cache_vs[:, :, None, :pos]
        s_old = torch.einsum("bkrh,bksh->bkrs", q_cached, kc) * (ks * scale)
        m = torch.maximum(s_old.amax(dim=-1, keepdim=True), s_new)
        p_old = torch.exp(s_old - m)
        p_new = torch.exp(s_new - m)
        denom = p_old.sum(dim=-1, keepdim=True) + p_new
        pv = (p_old * vs).to(torch.bfloat16).to(torch.float32)
        out = torch.einsum("bkrs,bksh->bkrh", pv, vc) + p_new * vn
    else:
        denom = torch.ones_like(s_new)
        out = vn.expand(b, nkv, r, hd)
    return (out / denom).to(q.dtype).reshape(b, 1, nq, hd)


def cached_attention_decode8_plain(q, k_new, v_new, cache_k, cache_v, cache_ks, cache_vs,
                                   pos: int):
    """Plain read-only int8 decode attention, the TPU kernel's op order (any
    nq / nkv): scores are the q . int8 k sums in f32 times (k scale * softmax
    scale); the new token is the exact second part of the softmax; p * v
    scale is rounded to bf16 for the value product."""
    b, _, nq, hd = q.shape
    nkv = cache_k.shape[1]
    qf = q.reshape(b, nkv, nq // nkv, hd).to(torch.float32)
    return _decode8_plain(q, qf, k_new, v_new, cache_k, cache_v, cache_ks, cache_vs, pos)


def decode_attention_update8_plain(q, k_new, v_new, cache_k, cache_v, cache_ks, cache_vs,
                                   pos: int):
    """Plain version of the fused int8 step: the read-only attention, then the
    new token quantized and written with its two scales. At one query head per
    KV head the TPU's head-grouped kernel serves the shape, which rounds q to
    bf16 for the cached scores (a no-op for a bf16 model)."""
    b, _, nq, hd = q.shape
    nkv = cache_k.shape[1]
    qc = q.reshape(b, nkv, nq // nkv, hd).to(torch.float32)
    if nq == nkv:
        qc = qc.to(torch.bfloat16).to(torch.float32)
    out = _decode8_plain(q, qc, k_new, v_new, cache_k, cache_v, cache_ks, cache_vs, pos)
    kq, ksc = quantize_kv_chunk(k_new[:, 0])
    vq, vsc = quantize_kv_chunk(v_new[:, 0])
    cache_k[:, :, pos] = kq
    cache_v[:, :, pos] = vq
    cache_ks[:, :, pos] = ksc
    cache_vs[:, :, pos] = vsc
    return out, cache_k, cache_v, cache_ks, cache_vs


def cached_attention_t8(q, k_new, v_new, cache_k, cache_v, cache_ks, cache_vs, pos: int):
    """cached_attention_t over the int8 cache. One token goes to the int8
    read-only decode kernel; a longer chunk dequantizes the cached tokens to
    bf16 and takes cached_attention_t's path (a position-0 prefill reads
    nothing cached and goes straight to the flash kernel)."""
    pos = _int_pos("cached_attention_t8", pos)
    pools = (cache_k, cache_v, cache_ks, cache_vs)
    if q.shape[1] > 1:
        if pos == 0:
            return attention(q, k_new, v_new, causal=True, q_offset=0)
        kf = dequantize_kv(cache_k[:, :, :pos], cache_ks[:, :, :pos]).to(torch.bfloat16)
        vf = dequantize_kv(cache_v[:, :, :pos], cache_vs[:, :, :pos]).to(torch.bfloat16)
        return cached_attention_chunk_plain(q, k_new, v_new, kf, vf, pos)
    if not _device_route("cached_attention_t8", q):
        return cached_attention_decode8_plain(q, k_new, v_new, *pools, pos)
    return _decode_kernel("cached_attention_t8", q, k_new, v_new, pools, pos, write=False)


# ---------------------------------------------------------------- cache writes


def _chunk_ok(new_k, new_v, shape, align_elems: int) -> bool:
    """bf16 chunks of ``shape`` (..., sq, NKV, HD) with contiguous heads, every
    other stride a multiple of ``align_elems`` elements and aligned starts."""
    hd = shape[-1]
    return all(t.dtype == torch.bfloat16 and tuple(t.shape) == tuple(shape)
               and t.stride(-1) == 1 and t.stride(-2) == hd
               and all(s % align_elems == 0 for s in t.stride()[:-2])
               and t.data_ptr() % (2 * align_elems) == 0 for t in (new_k, new_v))


def _write(fn: str, pools, new_k, new_v, pos: int):
    """Launch the write kernel for these operands: per-layer pools
    (B, NKV, S, HD) with chunks (B, sq, NKV, HD), or stacked pools
    (L, B, NKV, S, HD) with chunks (L, B, sq, NKV, HD); bf16 or int8."""
    int8 = len(pools) == 4
    stacked = pools[0].ndim == 5
    *lead, sq, nkv, hd = new_k.shape
    s_len = pools[0].shape[-2]
    # the bf16 kernel moves 16-byte pieces, the int8 one HD / 32 elements a lane
    align = hd // 32 if int8 else 8
    ok = (len(lead) == (2 if stacked else 1)
          and (hd in (64, 128, 256) if int8 else hd % 8 == 0)
          and 0 <= pos and pos + sq <= s_len
          and all(t.device == new_k.device for t in (new_v,) + tuple(pools))
          and _chunk_ok(new_k, new_v, (*lead, sq, nkv, hd), align)
          and _pools_ok(pools, (*lead, nkv, s_len, hd)))
    if ok and stacked:  # layer l of the chunks starts lead[1] batch strides after layer l - 1
        ok = all(t.stride(0) == lead[1] * t.stride(1) for t in (new_k, new_v))
    if not ok:
        raise ValueError(
            f"{fn}: needs bf16 chunks ({'L,' if stacked else ''}B,sq,NKV,HD) with contiguous, "
            f"aligned heads{' stacked evenly over L' if stacked else ''}, contiguous caches "
            f"({'L,' if stacked else ''}B,NKV,S,HD) (bf16, or int8 with f32 scale pools, HD "
            f"64/128/256), all on one device, pos + sq <= S; got {tuple(new_k.shape)} into "
            f"{tuple(pools[0].shape)} {pools[0].dtype} at {pos}")
    bs, ts = new_k.stride(-4), new_k.stride(-3)
    vbs, vts = new_v.stride(-4), new_v.stride(-3)
    ptrs = tuple(t.data_ptr() for t in pools)
    stream = kernels.stream_ptr(new_k)
    if stacked and int8:
        name, symbol, argtypes = "kv_write_stacked_q8", "kv_write_stacked_q8", _STACKED8_ARGS
        args = (new_k.data_ptr(), bs, ts, new_v.data_ptr(), vbs, vts, *ptrs, *lead, sq, nkv, hd,
                s_len, pos, stream)
    elif stacked and sq == 1:
        name, symbol, argtypes = "kv_write_stacked_col", "kv_write_stacked_col", _STACKED_COL_ARGS
        args = (new_k.data_ptr(), bs, new_v.data_ptr(), vbs, *ptrs, *lead, nkv, hd, s_len, pos,
                stream)
    elif stacked:
        name, symbol, argtypes = "kv_write_stacked", "kv_write_stacked", _STACKED_ARGS
        args = (new_k.data_ptr(), bs, ts, new_v.data_ptr(), vbs, vts, *ptrs, *lead, sq, nkv, hd,
                s_len, pos, stream)
    elif sq == 1:
        name = symbol = "kv_write_col_q8" if int8 else "kv_write_col"
        argtypes = _COL8_ARGS if int8 else _COL_ARGS
        args = (new_k.data_ptr(), bs, new_v.data_ptr(), vbs, *ptrs, *lead, nkv, hd, s_len, pos,
                stream)
    else:
        name, symbol = ("kv_write_q8", "kv_write_slab_q8") if int8 else ("kv_write",
                                                                         "kv_write_slab")
        argtypes = _WRITE8_ARGS if int8 else _WRITE_ARGS
        args = (new_k.data_ptr(), bs, ts, new_v.data_ptr(), vbs, vts, *ptrs, *lead, sq, nkv, hd,
                s_len, pos, stream)
    kernels.check(name, kernels.function("kv_write", symbol, argtypes)(*args))
    return tuple(pools)


def write_kv_layer(cache_k, cache_v, new_k, new_v, pos: int):
    """Write a chunk new_* (B, sq, NKV, HD) into cache_* (B, NKV, S, HD) at
    token rows [pos, pos + sq), in place. Returns (cache_k, cache_v). One
    token (sq == 1) takes the column-write entry, a longer chunk the slab's."""
    if not _device_route("write_kv_layer", new_k):
        return write_kv_layer_plain(cache_k, cache_v, new_k, new_v, pos)
    return _write("write_kv_layer", (cache_k, cache_v), new_k, new_v, pos)


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
    pools = (cache_k, cache_v, cache_ks, cache_vs)
    if not _device_route("write_kv_layer8", new_k):
        return write_kv_layer8_plain(*pools, new_k, new_v, pos)
    return _write("write_kv_layer8", pools, new_k, new_v, pos)


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


def write_kv_t(cache_k, cache_v, new_k, new_v, pos: int):
    """All layers' chunks new_* (L, B, sq, NKV, HD) into the stacked caches
    cache_* (L, B, NKV, S, HD) at token rows [pos, pos + sq), in place, in one
    kernel launch. Returns (cache_k, cache_v)."""
    if not _device_route("write_kv_t", new_k):
        return write_kv_t_plain(cache_k, cache_v, new_k, new_v, pos)
    return _write("write_kv_t", (cache_k, cache_v), new_k, new_v, pos)


def write_kv_t_plain(cache_k, cache_v, new_k, new_v, pos: int):
    """Plain version: a strided copy_ per stacked pool."""
    sq = new_k.shape[2]
    cache_k[:, :, :, pos:pos + sq].copy_(new_k.transpose(2, 3))
    cache_v[:, :, :, pos:pos + sq].copy_(new_v.transpose(2, 3))
    return cache_k, cache_v


def write_kv_t8(cache_k, cache_v, cache_ks, cache_vs, new_k, new_v, pos: int):
    """Stacked form of write_kv_layer8: cache_k/v (L, B, NKV, S, HD) int8,
    cache_ks/vs (L, B, NKV, S) f32, new_* (L, B, sq, NKV, HD); quantized and
    written in one kernel launch. Returns the four pools."""
    pools = (cache_k, cache_v, cache_ks, cache_vs)
    if not _device_route("write_kv_t8", new_k):
        return write_kv_t8_plain(*pools, new_k, new_v, pos)
    return _write("write_kv_t8", pools, new_k, new_v, pos)


def write_kv_t8_plain(cache_k, cache_v, cache_ks, cache_vs, new_k, new_v, pos: int):
    """Plain version: quantize_kv_chunk, then a strided copy_ per stacked pool."""
    sq = new_k.shape[2]
    kq, ksc = quantize_kv_chunk(new_k)
    vq, vsc = quantize_kv_chunk(new_v)
    cache_k[:, :, :, pos:pos + sq].copy_(kq.transpose(2, 3))
    cache_v[:, :, :, pos:pos + sq].copy_(vq.transpose(2, 3))
    cache_ks[:, :, :, pos:pos + sq].copy_(ksc.transpose(2, 3))
    cache_vs[:, :, :, pos:pos + sq].copy_(vsc.transpose(2, 3))
    return cache_k, cache_v, cache_ks, cache_vs
