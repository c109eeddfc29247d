"""The layer loop that InternLM and Falcon share: attention over the static
KV cache (or none) and the cache writes, around a family's own block.

The JAX package's ``models/internlm.py`` and ``models/falcon.py`` repeat
one ``forward`` body (the unrolled per-layer decode, the stacked scans with
``write_kv_t`` / ``write_kv_t8``, the cache-free scan); here it is written
once. ``attend`` is a block's attention: causal attention at offset 0 or an
injected ``attn_fn`` without a cache; over per-layer pools at one token the
fused decode attention + write (``fused_attn_write=False``: read-only
attention, then a one-token write); otherwise read-only attention over the
cache (the flash kernel for a position-0 prefill). ``run_layers`` drives the
blocks: a per-layer cache takes each layer's slab write after its block
(none at one token: the block wrote it), a stacked cache one write of every
layer's new k/v after the last block, as ``models.llama.forward`` does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from accessory_tpu_torch.models.llama import _rope_tables
from accessory_tpu_torch.ops.attention import attention
from accessory_tpu_torch.ops.decode_attention import (cached_attention_t, cached_attention_t8,
                                                      decode_attention_update,
                                                      decode_attention_update8, write_kv_layer,
                                                      write_kv_layer8, write_kv_t, write_kv_t8)
from accessory_tpu_torch.util import remat_policy


def attend(q, k, v, pos: int, cache_k, cache_v, cache_ks, cache_vs, update_cache: bool,
           fused_attn_write: bool = True, attn_fn: Optional[Callable] = None):
    """A block's attention: (out (b, sq, nq, hd), k, v). With ``update_cache``
    the k / v returned are the cache's pools, already written."""
    if cache_k is None and attn_fn is not None:
        return attn_fn(q, k, v), k, v
    if cache_k is None:
        return attention(q, k, v, causal=True, q_offset=0), k, v
    if update_cache and cache_ks is not None:
        out, k, v, _, _ = decode_attention_update8(q, k, v, cache_k, cache_v, cache_ks, cache_vs,
                                                   pos, fused_attn_write)
        return out, k, v
    if update_cache:
        return decode_attention_update(q, k, v, cache_k, cache_v, pos, fused_attn_write)
    if cache_ks is not None:
        return cached_attention_t8(q, k, v, cache_k, cache_v, cache_ks, cache_vs, pos), k, v
    return cached_attention_t(q, k, v, cache_k, cache_v, pos), k, v


def run_layers(block: Callable, args, layers: List[Dict[str, Any]], h: torch.Tensor,
               cache: Optional[Dict[str, Any]], cur_pos: int, rope: tuple, *,
               fused_attn_write: bool = True, remat=False,
               attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Every layer of a forward; returns the last hidden state. ``block(h,
    layer, args, cos, sin, pos, cache_k, cache_v, update_cache, cache_ks,
    cache_vs, fused_attn_write, attn_fn)`` -> (h, k, v), its attention
    through ``attend``. ``rope``: (head_dim, theta, scaling) of the RoPE
    tables (``models.llama``'s cached ones, without the rows of its fused
    epilogue). Without a cache the tokens sit at ``cur_pos`` onwards (a context-
    parallel rank's shard) and ``remat`` checkpoints each layer; the cache
    (per-layer lists or stacked tensors) is written in place."""
    sq = h.shape[1]
    hd, theta, scaling = rope
    if cache is None:
        cos, sin, _, _ = _rope_tables(hd, cur_pos + sq, theta, scaling, "half", 0, 0,
                                      str(h.device))
        cos, sin = cos[cur_pos:], sin[cur_pos:]
        checkpoint = remat_policy(remat)

        def one(h, layer):
            return block(h, layer, args, cos, sin, 0, None, None, False, None, None, True,
                         attn_fn)[0]

        for layer in layers:
            h = one(h, layer) if checkpoint is None else checkpoint(one, h, layer)
        return h
    stacked = isinstance(cache["k"], torch.Tensor)
    s_len = cache["k"].shape[3] if stacked else cache["k"][0].shape[2]
    cos, sin, _, _ = _rope_tables(hd, s_len, theta, scaling, "half", 0, 0, str(h.device))
    cos, sin = cos[cur_pos:cur_pos + sq], sin[cur_pos:cur_pos + sq]
    decode = sq == 1
    int8_kv = "ks" in cache
    new_k, new_v = [], []
    for i, layer in enumerate(layers):
        ck, cv = cache["k"][i], cache["v"][i]
        cks = cache["ks"][i] if int8_kv else None
        cvs = cache["vs"][i] if int8_kv else None
        h, k_new, v_new = block(h, layer, args, cos, sin, cur_pos, ck, cv, decode and not stacked,
                                cks, cvs, fused_attn_write, None)
        if stacked:
            new_k.append(k_new)
            new_v.append(v_new)
        elif decode:
            continue
        elif int8_kv:
            write_kv_layer8(ck, cv, cks, cvs, k_new, v_new, cur_pos)
        else:
            write_kv_layer(ck, cv, k_new, v_new, cur_pos)
    if stacked:
        # one bulk write of all layers' new k/v (the stack is a copy of them)
        new_k, new_v = torch.stack(new_k), torch.stack(new_v)
        if int8_kv:
            write_kv_t8(cache["k"], cache["v"], cache["ks"], cache["vs"], new_k, new_v, cur_pos)
        else:
            write_kv_t(cache["k"], cache["v"], new_k, new_v, cur_pos)
    return h
