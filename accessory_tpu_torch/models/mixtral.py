"""Mixtral-8x7B sparse MoE: LLaMA-style GQA attention (rope_theta 1e6) and a
top-k routed SwiGLU expert FFN in every layer.

Port of ``accessory_tpu/models/mixtral.py`` (init_params, the trainable
filter and quant blocklist, init_kv_cache, _block, forward with
``with_aux_loss``, init_paged_cache, forward_paged) on the port's per-layer
trees, as ``models/llama.py`` holds them: ``layers`` is a list of per-layer
dicts whose ``feed_forward`` holds the f32 router ``gate`` (dim, E) and the
experts ``w1`` / ``w3`` (E, dim, hidden) and ``w2`` (E, hidden, dim), or,
after ``quant.quantize_params``, a tuple of E per-expert QuantizedWeights
each (the JAX package's serving form, ``unstack_layers``' split_experts),
so every expert reads its own buffers. The router is never quantized.

Each block runs separate wq, wk, wv projections (the model has no fused
wqkv: ``SUPPORTS_FUSED_QKV`` is unset, so the engines keep the separate
projections), RoPE, and attention as LLaMA's block does: over per-layer
pools a decode step's attention writes its token into the cache in the same
kernel (or, with ``fused_attn_write=False``, read-only attention and a
one-token write), a prefill at position 0 takes the flash kernel and one
slab write a layer; a stacked cache is read in each layer and written once a
forward. Then wo and the residual, RMSNorm and ``ops.moe.moe_ffn`` (W4
experts: three quantized products for each touched expert, on all rows).
``forward`` without a cache is the training forward; ``with_aux_loss`` adds
the summed load-balancing loss as a third output (None over a cache, as in
the reference). ``param_axes`` / ``cache_axes`` wait for the port's sharding
rules (ROADMAP A10), as LLaMA's do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from accessory_tpu_torch.config import MixtralArgs
from accessory_tpu_torch.engine import kvcache
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.models.llama import torch_dtype
from accessory_tpu_torch.ops.attention import attention
from accessory_tpu_torch.ops.decode_attention import (cached_attention_t, cached_attention_t8,
                                                      decode_attention_update,
                                                      decode_attention_update8, write_kv_layer,
                                                      write_kv_layer8, write_kv_t, write_kv_t8)
from accessory_tpu_torch.ops.linear import linear, module_linear
from accessory_tpu_torch.ops.moe import moe_ffn
from accessory_tpu_torch.ops.norms import rms_norm
from accessory_tpu_torch.ops.rope import apply_rope
from accessory_tpu_torch.util import remat_policy

Params = Dict[str, Any]

# the capability flags the engines read with getattr (reference :43-49); no
# SUPPORTS_FUSED_QKV: the blocks take separate projections only
SUPPORTS_UNROLLED_DECODE = True
SUPPORTS_UNROLLED_PAGED = True
SUPPORTS_KV_INT8 = True
SUPPORTS_CHUNKED_PREFILL = True

TOP_LEVEL_KEYS = llama.TOP_LEVEL_KEYS

_ATT = ("wq", "wk", "wv", "wo")


def init_params(args: MixtralArgs, seed: int = 0, device="cuda") -> Params:
    """Random per-layer params from ``seed`` (normal, fan-in scaled). Norm
    weights start at one; the router gate is f32. PEFT leaves on the
    attention projections (reference :86-101): with ``lora_rank > 0``
    ``lora_a`` random and ``lora_b`` zero, with ``bias_tuning`` zero biases,
    drawn after the base weights."""
    dtype = torch_dtype(args.dtype)
    hd, nq, nkv = args.head_dim, args.n_heads, args.kv_heads
    e, hidden = args.num_experts, args.hidden_dim
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(shape, scale=None, out_dtype=dtype):
        scale = scale or shape[-2] ** -0.5
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w * scale).to(out_dtype)

    def ones():
        return torch.ones(args.dim, dtype=dtype, device=device)

    tok = dense((args.vocab_size, args.dim), 0.02)
    dims = {"wq": (args.dim, nq * hd), "wk": (args.dim, nkv * hd),
            "wv": (args.dim, nkv * hd), "wo": (nq * hd, args.dim)}
    layers: List[Params] = []
    for _ in range(args.n_layers):
        layers.append({
            "attention_norm": {"weight": ones()},
            "ffn_norm": {"weight": ones()},
            "attention": {name: {"weight": dense(shape)} for name, shape in dims.items()},
            "feed_forward": {
                "gate": {"weight": dense((args.dim, e), out_dtype=torch.float32)},
                "w1": {"weight": dense((e, args.dim, hidden))},
                "w2": {"weight": dense((e, hidden, args.dim))},
                "w3": {"weight": dense((e, args.dim, hidden))},
            },
        })
    params = {"tok_embeddings": {"weight": tok}, "layers": layers,
              "norm": {"weight": ones()}, "output": {"weight": dense((args.dim, args.vocab_size))}}
    for layer in layers:
        for name, (din, dout) in dims.items():
            mod = layer["attention"][name]
            if args.lora_rank > 0:
                mod["lora_a"] = dense((din, args.lora_rank))
                mod["lora_b"] = torch.zeros((args.lora_rank, dout), dtype=dtype, device=device)
            if args.bias_tuning:
                mod["bias"] = torch.zeros(dout, dtype=dtype, device=device)
    return params


def get_trainable_params_filter(args: MixtralArgs):
    """Name predicate of the trainable subset (reference :103): PEFT trains
    only lora / bias / norm leaves, full finetuning everything."""
    return llama.get_trainable_params_filter(args)


def get_quant_blocklist(args: MixtralArgs) -> List[str]:
    """The router stays f32 (its softmax numerics)."""
    return ["gate"]


def init_kv_cache(args: MixtralArgs, batch: int, max_len: Optional[int] = None,
                  dtype=None, stacked: bool = False, kv_dtype: Optional[str] = None,
                  device="cuda") -> Dict[str, Any]:
    """The static KV cache of ``models.llama.init_kv_cache`` (the same
    contract and argument order; per-layer pools by default, the port's
    serving layout)."""
    return llama.init_kv_cache(args, batch, max_len, dtype, stacked, kv_dtype, device=device)


def _check_layers(params: Params) -> None:
    for i, layer in enumerate(params["layers"]):
        att, ff = layer["attention"], layer["feed_forward"]
        if not (all(k in att for k in _ATT) and all(k in ff for k in ("gate", "w1", "w2", "w3"))):
            raise ValueError(f"layer {i}: Mixtral takes separate wq / wk / wv / wo projections "
                             "and gate / w1 / w2 / w3 experts")


def _qkv(h, layer, args: MixtralArgs, cos, sin):
    """RMSNorm, the separate projections and RoPE: q, k, v (b, sq, heads, hd)."""
    b, sq, _ = h.shape
    hd, nq, nkv = args.head_dim, args.n_heads, args.kv_heads
    att = layer["attention"]
    x = rms_norm(h, layer["attention_norm"]["weight"], args.norm_eps)
    q = module_linear(x, att["wq"]).reshape(b, sq, nq, hd)
    k = module_linear(x, att["wk"]).reshape(b, sq, nkv, hd)
    v = module_linear(x, att["wv"]).reshape(b, sq, nkv, hd)
    return (apply_rope(q, cos, sin, args.rope_style), apply_rope(k, cos, sin, args.rope_style), v)


def _ffn(h, out, layer, args: MixtralArgs, moe_impl: str, balance: bool):
    """wo and the residual, then the routed expert FFN and its residual:
    (h, the layer's aux loss or None)."""
    b, sq, _ = h.shape
    h = h + module_linear(out.reshape(b, sq, -1), layer["attention"]["wo"])
    x = rms_norm(h, layer["ffn_norm"]["weight"], args.norm_eps)
    ff = layer["feed_forward"]
    y, aux = moe_ffn(x.reshape(b * sq, args.dim), ff["gate"]["weight"], ff["w1"]["weight"],
                     ff["w3"]["weight"], ff["w2"]["weight"], k=args.num_experts_per_tok,
                     balance_weight=args.load_balancing_weight if balance else None,
                     impl=moe_impl)
    return h + y.reshape(b, sq, args.dim), aux


def _block(h, layer, args: MixtralArgs, cos, sin, pos: int, cache_k, cache_v,
           update_cache: bool, cache_ks=None, cache_vs=None, fused_attn_write: bool = True,
           attn_fn=None, moe_impl: str = "ragged", balance: bool = False):
    """One block. ``update_cache`` (a decode step over per-layer pools): the
    attention call also writes the new token's k/v (quantized when the int8
    scale pools are given), and (h, cache_k, cache_v, aux) comes back;
    otherwise the cache is only read and (h, k, v, aux) comes back for the
    caller's write. Without a cache: causal attention at offset 0, or
    ``attn_fn(q, k, v)`` (the context-parallel seam). ``balance``: the MoE
    layer returns its load-balancing loss as aux (else None)."""
    q, k, v = _qkv(h, layer, args, cos, sin)
    if cache_k is None and attn_fn is not None:
        out = attn_fn(q, k, v)
    elif cache_k is None:
        out = attention(q, k, v, causal=True, q_offset=0)
    elif update_cache and cache_ks is not None:
        out, k, v, _, _ = decode_attention_update8(q, k, v, cache_k, cache_v, cache_ks,
                                                   cache_vs, pos, fused_attn_write)
    elif update_cache:
        out, k, v = decode_attention_update(q, k, v, cache_k, cache_v, pos, fused_attn_write)
    elif cache_ks is not None:
        out = cached_attention_t8(q, k, v, cache_k, cache_v, cache_ks, cache_vs, pos)
    else:
        out = cached_attention_t(q, k, v, cache_k, cache_v, pos)
    h, aux = _ffn(h, out, layer, args, moe_impl, balance)
    return h, k, v, aux


def _head(h, params: Params, args: MixtralArgs) -> torch.Tensor:
    h = rms_norm(h, params["norm"]["weight"], args.norm_eps)
    return linear(h, params["output"]["weight"]).to(torch.float32)


def _rope(args: MixtralArgs, length: int, device):
    cos, sin, _, _ = llama._rope_tables(args.head_dim, length, args.rope_theta,
                                        args.rope_scaling, args.rope_style,
                                        args.n_heads + args.kv_heads, args.kv_heads, str(device))
    return cos, sin


def forward(params: Params, args: MixtralArgs, tokens: torch.Tensor, *,
            cache: Optional[Dict[str, Any]] = None, cur_pos: int = 0,
            fused_attn_write: bool = True, ffn_fuse: bool = False, remat=False, attn_fn=None,
            moe_impl: str = "ragged", with_aux_loss: bool = False):
    """A chunk of tokens at position ``cur_pos`` over per-layer params, the
    contract of ``models.llama.forward``: (logits f32 (b, sq, vocab), cache),
    the cache updated in place. ``cache=None`` is the training forward
    (``remat`` checkpoints each layer, ``attn_fn`` replaces its attention);
    per-layer pools take the fused decode write at one token and a slab
    write a layer for a longer chunk; a stacked cache is read in each layer
    and written once after the last. ``moe_impl``: the dispatch of dense
    experts ("ragged" or "dense"). ``with_aux_loss``: a third output, the
    load-balancing loss summed over the layers (training), None over a
    cache. ``ffn_fuse`` is the engines' switch for LLaMA's fused FFN
    kernel; the MoE FFN has none, so it must stay off."""
    if ffn_fuse:
        raise ValueError("ffn_fuse: Mixtral's routed experts have no fused FFN kernel")
    _check_layers(params)
    h = params["tok_embeddings"]["weight"][tokens]
    sq = h.shape[1]
    if cache is None:
        cos, sin = _rope(args, cur_pos + sq, h.device)
        cos, sin = cos[cur_pos:], sin[cur_pos:]
        checkpoint = remat_policy(remat)
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)

        def block(h, layer):
            h, _, _, aux = _block(h, layer, args, cos, sin, 0, None, None, False,
                                  attn_fn=attn_fn, moe_impl=moe_impl, balance=with_aux_loss)
            return h if aux is None else (h, aux)

        for layer in params["layers"]:
            out = block(h, layer) if checkpoint is None else checkpoint(block, h, layer)
            if with_aux_loss:
                h, aux = out
                aux_total = aux_total + aux
            else:
                h = out
        logits = _head(h, params, args)
        return (logits, None, aux_total) if with_aux_loss else (logits, None)
    stacked = isinstance(cache["k"], torch.Tensor)
    s_len = cache["k"].shape[3] if stacked else cache["k"][0].shape[2]
    cos_full, sin_full = _rope(args, s_len, h.device)
    cos, sin = cos_full[cur_pos:cur_pos + sq], sin_full[cur_pos:cur_pos + sq]
    decode = sq == 1
    int8_kv = "ks" in cache
    new_k, new_v = [], []
    for i, layer in enumerate(params["layers"]):
        ck, cv = cache["k"][i], cache["v"][i]
        cks = cache["ks"][i] if int8_kv else None
        cvs = cache["vs"][i] if int8_kv else None
        h, k_new, v_new, _ = _block(h, layer, args, cos, sin, cur_pos, ck, cv,
                                    decode and not stacked, cks, cvs, fused_attn_write,
                                    moe_impl=moe_impl)
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
        new_k, new_v = torch.stack(new_k), torch.stack(new_v)
        if int8_kv:
            write_kv_t8(cache["k"], cache["v"], cache["ks"], cache["vs"], new_k, new_v, cur_pos)
        else:
            write_kv_t(cache["k"], cache["v"], new_k, new_v, cur_pos)
    logits = _head(h, params, args)
    return (logits, cache, None) if with_aux_loss else (logits, cache)


# ---------------------------------------------------------------- paged KV cache


def init_paged_cache(args: MixtralArgs, slots: int, total_pages: int, page_size: int = 64,
                     pages_per_seq: Optional[int] = None, dtype=None,
                     kv_dtype: Optional[str] = None, device="cuda") -> kvcache.PagedKVCache:
    """A paged KV cache for this model, as ``models.llama.init_paged_cache``."""
    return llama.init_paged_cache(args, slots, total_pages, page_size, pages_per_seq, dtype,
                                  kv_dtype, device=device)


def forward_paged(params: Params, args: MixtralArgs, tokens: torch.Tensor,
                  pcache: kvcache.PagedKVCache, moe_impl: str = "ragged",
                  active_pages: Optional[int] = None,
                  continuation: bool = False) -> Tuple[torch.Tensor, kvcache.PagedKVCache]:
    """A forward over a paged KV cache with per-slot positions, the contract
    of ``models.llama.forward_paged``: a fresh prefill from position 0 (flash
    attention over the chunk), a ``continuation`` chunk at each slot's
    length, or one decode token a slot; the pools are read in the layer loop
    and every layer's new k/v written by one paged write after the last.
    Returns (logits f32 (b, sq, vocab), the cache with lengths + sq)."""
    _check_layers(params)
    b, sq = tokens.shape
    h = params["tok_embeddings"]["weight"][tokens]
    dev = h.device
    max_pos = pcache.pages_per_seq * pcache.page_size
    cos_full, sin_full = _rope(args, max_pos, dev)
    lengths = pcache.lengths
    cached = sq == 1 or continuation
    if cached:
        pos = lengths.to(torch.int64)[:, None] + torch.arange(sq, device=dev)[None, :]
        pos = pos.clamp(max=max_pos - 1)
        cos, sin = cos_full[pos], sin_full[pos]                  # (b, sq, hd / 2)
        start = lengths
    else:
        cos, sin = cos_full[:sq], sin_full[:sq]
        start = torch.zeros((b,), dtype=torch.int32, device=dev)
    new_k, new_v = [], []
    for i, layer in enumerate(params["layers"]):
        q, k, v = _qkv(h, layer, args, cos, sin)
        if cached:
            out = kvcache.paged_cached_attention(
                q, k, v, pcache.k_pages, pcache.v_pages, lengths, pcache.page_indices,
                active_pages, pcache.ks_pages, pcache.vs_pages, layer=i)
        else:
            out = attention(q, k, v, causal=True, q_offset=0)
        h, _ = _ffn(h, out, layer, args, moe_impl, False)
        new_k.append(k)
        new_v.append(v)
    kvcache.write_tokens_all_layers(
        pcache.k_pages, pcache.v_pages, torch.stack(new_k), torch.stack(new_v),
        pcache.page_indices, start, pcache.ks_pages, pcache.vs_pages)
    return _head(h, params, args), dataclasses.replace(pcache, lengths=lengths + sq)
