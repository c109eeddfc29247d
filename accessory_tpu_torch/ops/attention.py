"""Attention: the plain grouped-GQA version (the oracle) and its dispatch,
and the two-part softmax over a read-only cache.

Port of ``accessory_tpu/ops/attention.py::attention`` and ``cached_attention``. GQA is computed
grouped (q reshaped to (kv head, group)), masking is positional with
NEG_INF = -1e30, scores and softmax are f32 and the probabilities are cast to
v's dtype before the value product, the JAX op order. A causal
self-attention call at offset 0 goes to ops.flash_attention, which launches
the CUDA kernel on a CUDA tensor at any length.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              q_offset=0, kv_len: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """q (b, q_len, n_heads, hd); k, v (b, kv_len_max, n_kv_heads, hd) ->
    (b, q_len, n_heads, hd) in q.dtype."""
    if kv_len is None and causal and isinstance(q_offset, int) and q_offset == 0 \
            and q.shape[1] == k.shape[1]:
        from accessory_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, scale=scale)
    return grouped_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
                             scale=scale)


def grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_offset=0,
                      kv_len: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Plain grouped-GQA attention with positional masking (no dispatch);
    non-causal without ``kv_len`` (LLaMA-Adapter's prefix attention) it
    masks nothing."""
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    if nq % nkv:
        raise ValueError(f"n_heads {nq} is not a multiple of n_kv_heads {nkv}")
    n_rep = nq // nkv
    if scale is None:
        scale = hd ** -0.5
    dev = q.device
    qg = q.reshape(b, sq, nkv, n_rep, hd).to(torch.float32)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qg, k.to(torch.float32)) * scale
    if causal or kv_len is not None:
        # an int offset is added on the device: a host int copied to a CUDA
        # tensor would wait for the stream
        if isinstance(q_offset, int):
            q_ids = (torch.arange(sq, device=dev) + q_offset)[None, :]
        else:
            q_pos = torch.as_tensor(q_offset, device=dev).reshape(-1)
            q_ids = q_pos[:, None] + torch.arange(sq, device=dev)[None, :]
        kv_ids = torch.arange(skv, device=dev)[None, :]
        mask = torch.ones((q_ids.shape[0], sq, skv), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kv_ids[:, None, :] <= q_ids[:, :, None])
        if kv_len is not None:
            kl = torch.as_tensor(kv_len, device=dev).reshape(-1)
            mask = mask & (kv_ids[:, None, :] < kl[:, None, None])
        scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrqs,bskh->bqkrh", probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, sq, nq, hd).to(q.dtype)


def cached_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Attention of a new chunk over a dense cache that is only read: the
    result of writing k_new / v_new at [pos, pos + sq) and attending over
    cache[:pos + sq], computed as one softmax over [q . K_old (masked below
    pos) ; q . k_new (causal within the chunk)]. Port of
    ``accessory_tpu/ops/attention.py::cached_attention``.

    q (b, sq, nq, hd); k_new / v_new (b, sq, nkv, hd); cache_k / cache_v
    (b, S, nkv, hd); ``pos`` an int or a (b,) tensor of per-row positions.
    Scores and softmax in f32; each part's probabilities are cast to its
    values' dtype before the value product. Plain PyTorch on every device
    (an XLA einsum in the reference)."""
    b, sq, nq, hd = q.shape
    skv, nkv = cache_k.shape[1], cache_k.shape[2]
    if nq % nkv:
        raise ValueError(f"n_heads {nq} is not a multiple of n_kv_heads {nkv}")
    if scale is None:
        scale = hd ** -0.5
    dev = q.device
    qg = q.reshape(b, sq, nkv, nq // nkv, hd).to(torch.float32)
    s_old = torch.einsum("bqkrh,bskh->bkrqs", qg, cache_k.to(torch.float32)) * scale
    pos_t = torch.as_tensor(pos, device=dev).reshape(-1)      # (1,) or (b,)
    old_mask = torch.arange(skv, device=dev)[None, :] < pos_t[:, None]
    s_old = torch.where(old_mask[:, None, None, None, :], s_old, torch.full_like(s_old, NEG_INF))
    s_new = torch.einsum("bqkrh,bskh->bkrqs", qg, k_new.to(torch.float32)) * scale
    idx = torch.arange(sq, device=dev)
    causal = idx[None, :] <= idx[:, None]                      # new key j seen by query i
    s_new = torch.where(causal, s_new, torch.full_like(s_new, NEG_INF))
    probs = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1)
    p_old, p_new = probs[..., :skv], probs[..., skv:]
    out = torch.einsum("bkrqs,bskh->bqkrh", p_old.to(cache_v.dtype).to(torch.float32),
                       cache_v.to(torch.float32))
    out = out + torch.einsum("bkrqs,bskh->bqkrh", p_new.to(v_new.dtype).to(torch.float32),
                             v_new.to(torch.float32))
    return out.reshape(b, sq, nq, hd).to(q.dtype)
