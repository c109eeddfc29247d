"""LLaMA forward: training (no cache), and for serving a prefill, a chunk
after cached tokens and one-token decode, over a per-layer or a stacked KV
cache.

Port of ``accessory_tpu/models/llama.py`` (init_params, init_kv_cache,
_block, forward): its unrolled per-layer decode path and its stacked-cache
path (read-only attention in each layer, one bulk write per forward; a layer
of a stacked tensor is a view in PyTorch, so the params stay per-layer lists
on both paths and only the cache is stacked). Params are a tree of dicts
whose ``layers`` is a list of per-layer dicts; weights are stored
(in_dim, out_dim). Layers hold fused wqkv / w13 weights
(``quant.fuse.fuse_for_decode``) or separate wq, wk, wv / w1, w3. Each fused
decode layer runs: the wqkv W4 kernel with the
RMSNorm prologue and RoPE epilogue; the fused decode attention + KV write;
wo W4 + residual; w13 W4 with the norm; SwiGLU; w2 W4 + residual (or, with
``ffn_fuse``, the last three in one fused FFN kernel, ops/ffn_fused.py). A
position-0 prefill runs the same matmuls, causal flash attention and one
slab write of the prompt's K/V per layer; with 1024 prompt rows or more the
W4 matmuls go unfused through the many-row kernel (ops/linear.py). With an
int8 KV cache (``kv_dtype="int8"``: int8 ``k``/``v`` pools plus f32 ``ks``/
``vs`` scale pools) the decode attention and the slab write are the int8
kernels; the prefill still attends over the exact new k/v and only the write
quantizes. The output head is the final RMSNorm plus a dense matmul, outside
any kernel, as in the JAX package.

``forward`` without a cache is the training forward (reference :552-567):
every block attends causally through ``ops.flash_attention`` (differentiable:
the flash backward kernel on the card), or through an injected ``attn_fn``
(``parallel.make_cp_attn_fn``: the tokens are one rank's sequence shard,
starting at ``cur_pos``), and composes its W4 matmuls unfused
(``allow_fused=False``: the fused kernel call has no backward), each layer
optionally checkpointed (``util.remat_policy``). ``init_params`` adds the
PEFT leaves (``lora_rank``: lora_a random, lora_b zero; ``bias_tuning``:
zero biases) and ``get_trainable_params_filter`` names the trainable ones.

``init_paged_cache`` / ``forward_paged`` (reference :574-731) serve the
continuous batcher over a paged KV cache (engine/kvcache.py): per-slot
positions, pools read-only inside the layer loop (paged decode attention, or
flash for a fresh prefill) and one paged write of every layer's new k/v per
forward.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from accessory_tpu_torch.config import LLaMAArgs, n_layers_of
from accessory_tpu_torch.engine import kvcache
from accessory_tpu_torch.ops.attention import attention
from accessory_tpu_torch.ops.decode_attention import (cached_attention_t, cached_attention_t8,
                                                      decode_attention_update,
                                                      decode_attention_update8, write_kv_layer,
                                                      write_kv_layer8, write_kv_t, write_kv_t8)
from accessory_tpu_torch.ops.ffn_fused import ffn_fusible, ffn_qmm
from accessory_tpu_torch.ops.linear import module_linear, module_linear_nr
from accessory_tpu_torch.ops.norms import rms_norm
from accessory_tpu_torch.ops.rope import apply_rope, precompute_rope, rope_rows
from accessory_tpu_torch.util import remat_policy, resolve_kv_dtype

Params = Dict[str, Any]

# the capability flags the engines read with getattr, as the reference sets
# them (accessory_tpu/models/llama.py:51-62)
SUPPORTS_UNROLLED_DECODE = True
SUPPORTS_UNROLLED_PAGED = True     # forward_paged takes per-layer params
SUPPORTS_CHUNKED_PREFILL = True    # forward_paged(continuation=True)
SUPPORTS_KV_INT8 = True
SUPPORTS_FUSED_QKV = True

# the top-level keys of a whole model's params (MetaModel.from_pretrained's
# check for a partial checkpoint)
TOP_LEVEL_KEYS = ("tok_embeddings", "layers", "norm", "output")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


def init_params(args: LLaMAArgs, seed: int = 0, device="cuda") -> Params:
    """Random per-layer params from ``seed`` (normal, fan-in scaled; the exact
    init does not matter for serving). Norm weights start at one. PEFT leaves
    (reference :106-126): with ``lora_rank > 0`` every projection gets
    ``lora_a`` (in_dim, r) random and ``lora_b`` (r, out_dim) zero, so the
    adapter starts as the identity; with ``bias_tuning`` zero biases. They
    are drawn after the base weights, which a seed gives the same with or
    without them."""
    dtype = torch_dtype(args.dtype)
    hd, nq, nkv = args.head_dim, args.n_heads, args.kv_heads
    ffn = args.ffn_hidden_dim
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(shape, scale=None):
        scale = scale or shape[0] ** -0.5
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w * scale).to(dtype)

    tok = dense((args.vocab_size, args.dim), 0.02)
    layers: List[Params] = []
    for _ in range(args.n_layers):
        layers.append({
            "attention_norm": {"weight": torch.ones(args.dim, dtype=dtype, device=device)},
            "ffn_norm": {"weight": torch.ones(args.dim, dtype=dtype, device=device)},
            "attention": {
                "wq": {"weight": dense((args.dim, nq * hd))},
                "wk": {"weight": dense((args.dim, nkv * hd))},
                "wv": {"weight": dense((args.dim, nkv * hd))},
                "wo": {"weight": dense((nq * hd, args.dim))},
            },
            "feed_forward": {
                "w1": {"weight": dense((args.dim, ffn))},
                "w2": {"weight": dense((ffn, args.dim))},
                "w3": {"weight": dense((args.dim, ffn))},
            },
        })
    params = {
        "tok_embeddings": {"weight": tok},
        "layers": layers,
        "norm": {"weight": torch.ones(args.dim, dtype=dtype, device=device)},
        "output": {"weight": dense((args.dim, args.vocab_size))},
    }
    dims = {("attention", "wq"): (args.dim, nq * hd), ("attention", "wk"): (args.dim, nkv * hd),
            ("attention", "wv"): (args.dim, nkv * hd), ("attention", "wo"): (nq * hd, args.dim),
            ("feed_forward", "w1"): (args.dim, ffn), ("feed_forward", "w2"): (ffn, args.dim),
            ("feed_forward", "w3"): (args.dim, ffn)}
    for layer in layers:
        for (part, name), (din, dout) in dims.items():
            mod = layer[part][name]
            if args.lora_rank > 0:
                mod["lora_a"] = dense((din, args.lora_rank))
                mod["lora_b"] = torch.zeros((args.lora_rank, dout), dtype=dtype, device=device)
            if args.bias_tuning:
                mod["bias"] = torch.zeros(dout, dtype=dtype, device=device)
    return params


def get_trainable_params_filter(args: LLaMAArgs):
    """Name predicate of the trainable subset (reference :129): PEFT trains
    only lora / bias / norm leaves, full finetuning everything."""
    if not (args.lora_rank > 0 or args.bias_tuning or args.norm_tuning):
        return lambda name: True

    def f(name: str) -> bool:
        return ((args.lora_rank > 0 and "lora" in name)
                or (args.bias_tuning and name.endswith("bias"))
                or (args.norm_tuning and "norm" in name))

    return f


def init_kv_cache(args: LLaMAArgs, batch: int, max_len: Optional[int] = None,
                  dtype=None, stacked: bool = False, kv_dtype: Optional[str] = None,
                  device="cuda") -> Dict[str, Any]:
    """Static KV cache. Per layer (the default, for the unrolled decode path):
    lists of pools (batch, n_kv_heads, max_len, head_dim), every cached token
    of a head one contiguous row (the port's layout). ``stacked=True``: one
    tensor per pool with a leading layer axis (n_layers, batch, ...), for the
    path that reads the cache in each layer and writes all layers' new k/v
    once per forward. ``kv_dtype="int8"`` stores per-token-per-head symmetric
    int8 ``k``/``v`` plus f32 scale pools ``ks``/``vs`` (batch, n_kv_heads,
    max_len); ``None`` means the activation dtype (``util.resolve_kv_dtype``)."""
    max_len = max_len or args.max_seq_len
    int8_kv = resolve_kv_dtype(kv_dtype) == "int8"
    dtype = torch.int8 if int8_kv else torch_dtype(dtype or args.dtype)
    shape = (batch, args.kv_heads, max_len, args.head_dim)
    n_layers = n_layers_of(args)

    def pools(shape, dtype):
        if stacked:
            return torch.zeros((n_layers,) + shape, dtype=dtype, device=device)
        return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layers)]

    cache = {"k": pools(shape, dtype), "v": pools(shape, dtype)}
    if int8_kv:
        cache["ks"] = pools(shape[:3], torch.float32)
        cache["vs"] = pools(shape[:3], torch.float32)
    return cache


@functools.lru_cache(maxsize=16)
def _rope_tables(head_dim: int, max_len: int, theta: float, scaling, style: str,
                 n_rot: int, n_pass: int, device: str):
    """cos/sin tables (max_len, hd/2) and their per-position decode rows
    (max_len, (n_rot + n_pass) * hd), built once per cache length."""
    cos, sin = precompute_rope(head_dim, max_len, theta, scaling, device=device)
    rows = rope_rows(cos, sin, n_rot, n_pass, head_dim, style)
    return cos, sin, rows[0], rows[1]


def rope_at(table: torch.Tensor, pos, sq: int) -> torch.Tensor:
    """Rows [pos, pos + sq) of a RoPE table built to the cache's length: a
    slice at an int position, a gather at a 0-d tensor one (a position on
    the device, which a decode step captured in a CUDA graph advances and no
    host reads). The rows are the same either way."""
    if isinstance(pos, torch.Tensor):
        idx = pos.reshape(1)
        if sq > 1:
            idx = idx + torch.arange(sq, device=table.device)
        return table.index_select(0, idx)
    return table[pos:pos + sq]


def _block(h, layer, args: LLaMAArgs, cos, sin, pos, cache_k, cache_v,
           update_cache: bool, rope_t=None, cache_ks=None, cache_vs=None,
           fused_attn_write: bool = True, ffn_fuse: bool = False, attn_fn=None):
    """One transformer block, over fused (wqkv / w13) or separate (wq, wk, wv /
    w1, w3) layer params. With ``update_cache`` (a decode step over per-layer
    pools) the attention call also writes the new token's k/v into the cache
    (quantized when the int8 scale pools ``cache_ks`` / ``cache_vs`` are
    given), in one kernel or, without ``fused_attn_write``, in a read-only
    attention and a one-token write, and (h, cache_k, cache_v) is returned;
    otherwise the cache is only read and (h, k, v) goes back for the caller's
    write. ``ffn_fuse``: a one-token step over a cache runs the FFN (norm,
    w13, SwiGLU, w2 and the residual) as one fused kernel call where
    ``ops.ffn_fused.ffn_fusible`` holds and w2 has no LoRA or bias, the
    reference's conditions (its ``ACCESSORY_FFN_FUSE=1``). ``attn_fn``: the
    cache-free forward's attention, in place of causal attention at offset 0
    (the context-parallel seam, reference :364-368)."""
    b, sq, _ = h.shape
    hd, nq, nkv = args.head_dim, args.n_heads, args.kv_heads
    att = layer["attention"]
    # training (no cache) differentiates through every matmul: the fused
    # kernel call has no backward, so the unfused composition is forced
    fuse_ok = cache_k is not None
    if "wqkv" in att:
        qkv = module_linear_nr(h, att["wqkv"], norm=layer["attention_norm"],
                               eps=args.norm_eps, rope=rope_t, allow_fused=fuse_ok)
        q = qkv[..., :nq * hd].reshape(b, sq, nq, hd)
        k = qkv[..., nq * hd:(nq + nkv) * hd].reshape(b, sq, nkv, hd)
        v = qkv[..., (nq + nkv) * hd:].reshape(b, sq, nkv, hd)
        if rope_t is None:
            q = apply_rope(q, cos, sin, args.rope_style)
            k = apply_rope(k, cos, sin, args.rope_style)
    else:
        x = rms_norm(h, layer["attention_norm"]["weight"], args.norm_eps)
        q = module_linear(x, att["wq"]).reshape(b, sq, nq, hd)
        k = module_linear(x, att["wk"]).reshape(b, sq, nkv, hd)
        v = module_linear(x, att["wv"]).reshape(b, sq, nkv, hd)
        q = apply_rope(q, cos, sin, args.rope_style)
        k = apply_rope(k, cos, sin, args.rope_style)

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

    h = module_linear_nr(out.reshape(b, sq, nq * hd), att["wo"], residual=h,
                         allow_fused=fuse_ok)
    ff = layer["feed_forward"]
    if "w13" in ff:
        w13, w2 = ff["w13"]["weight"], ff["w2"]
        m_rows = b * sq
        if (ffn_fuse and fuse_ok and sq == 1 and "lora_a" not in w2 and w2.get("bias") is None
                and ffn_fusible(w13, w2["weight"], m_rows)):
            x2d = h.reshape(m_rows, h.shape[-1])
            h = ffn_qmm(x2d, w13, w2["weight"], residual=x2d,
                        norm_weight=layer["ffn_norm"]["weight"],
                        norm_eps=args.norm_eps).reshape(h.shape)
        else:
            gu = module_linear_nr(h, ff["w13"], norm=layer["ffn_norm"], eps=args.norm_eps,
                                  allow_fused=fuse_ok)
            hidden = gu.shape[-1] // 2
            gate = torch.nn.functional.silu(gu[..., :hidden])
            h = module_linear_nr(gate * gu[..., hidden:], w2, residual=h, allow_fused=fuse_ok)
    else:
        x = rms_norm(h, layer["ffn_norm"]["weight"], args.norm_eps)
        gate = torch.nn.functional.silu(module_linear(x, ff["w1"]))
        h = module_linear_nr(gate * module_linear(x, ff["w3"]), ff["w2"], residual=h,
                             allow_fused=fuse_ok)
    return h, k, v


def _check_layers(params: Params) -> None:
    for i, layer in enumerate(params["layers"]):
        att, ff = layer["attention"], layer["feed_forward"]
        if not (("wqkv" in att or all(k in att for k in ("wq", "wk", "wv")))
                and ("w13" in ff or all(k in ff for k in ("w1", "w3")))):
            raise ValueError(f"layer {i} has neither fused (wqkv / w13, from "
                             "quant.fuse.fuse_for_decode) nor separate (wq, wk, wv / w1, w3) "
                             "projection weights")


def forward(params: Params, args: LLaMAArgs, tokens: torch.Tensor, *,
            cache: Optional[Dict[str, Any]] = None, cur_pos=0,
            fused_attn_write: bool = True, ffn_fuse: bool = False, remat=False,
            attn_fn=None, embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """A chunk of tokens at position ``cur_pos`` (a prefill at 0, a chunk
    after cached tokens, or one decode token) over per-layer params, fused
    by ``quant.fuse.fuse_for_decode`` or not. Returns (logits f32
    (b, sq, vocab), cache); the cache is updated in place.

    ``cache=None``: the training forward (reference :552-567), differentiable,
    returning (logits f32, None); ``remat`` (``util.remat_policy``)
    checkpoints each layer, whose forward then runs again in the backward.
    ``attn_fn(q, k, v)`` replaces its causal attention (bound inside the
    checkpointed block, so remat keeps it); the tokens then sit at positions
    ``cur_pos`` onwards (a context-parallel rank's shard), where RoPE reads
    its tables.

    Per-layer pools (lists): a decode step's attention writes its own layer's
    slot (one fused kernel, or read-only attention plus a one-token write with
    ``fused_attn_write=False``); a longer chunk is written layer by layer.
    A stacked cache (one tensor per pool): every layer reads its slice of the
    cache and all layers' new k/v are written by one call after the last.
    Over a cache ``cur_pos`` may be a 0-d int tensor on the device (a decode
    step captured in a CUDA graph): the RoPE rows are gathered at it and the
    kernels read it in place, with the same results as at the int.
    ``ffn_fuse``: a decode step's FFN takes the fused kernel where it can
    (``_block``); a prefill and the training forward never fuse.

    ``embeds`` (b, s, dim) replaces the table lookup (the multimodal splice:
    s may exceed the token count); every row count, and so every route
    choice below, is read from it."""
    _check_layers(params)
    h = embeds if embeds is not None else params["tok_embeddings"]["weight"][tokens]
    sq = h.shape[1]
    if cache is None:
        cos, sin, _, _ = _rope_tables(args.head_dim, cur_pos + sq, args.rope_theta,
                                      args.rope_scaling, args.rope_style,
                                      args.n_heads + args.kv_heads, args.kv_heads, str(h.device))
        cos, sin = cos[cur_pos:], sin[cur_pos:]
        checkpoint = remat_policy(remat)

        def block(h, layer):
            return _block(h, layer, args, cos, sin, 0, None, None, False, attn_fn=attn_fn)[0]

        for layer in params["layers"]:
            h = block(h, layer) if checkpoint is None else checkpoint(block, h, layer)
        logits = module_linear_nr(h, params["output"], norm=params["norm"], eps=args.norm_eps)
        return logits.to(torch.float32), None
    stacked = isinstance(cache["k"], torch.Tensor)
    s_len = cache["k"].shape[3] if stacked else cache["k"][0].shape[2]
    cos_full, sin_full, cos_rows, sin_rows = _rope_tables(
        args.head_dim, s_len, args.rope_theta, args.rope_scaling, args.rope_style,
        args.n_heads + args.kv_heads, args.kv_heads, str(h.device))
    cos, sin = rope_at(cos_full, cur_pos, sq), rope_at(sin_full, cur_pos, sq)
    decode = sq == 1
    # decode-RoPE folded into the fused wqkv epilogue: one shared position
    rope_t = ((rope_at(cos_rows, cur_pos, 1)[0], rope_at(sin_rows, cur_pos, 1)[0],
               args.rope_style, args.head_dim) if decode else None)
    int8_kv = "ks" in cache
    new_k, new_v = [], []
    for i, layer in enumerate(params["layers"]):
        cks = cache["ks"][i] if int8_kv else None
        cvs = cache["vs"][i] if int8_kv else None
        ck, cv = cache["k"][i], cache["v"][i]
        h, k_new, v_new = _block(h, layer, args, cos, sin, cur_pos, ck, cv,
                                 decode and not stacked, rope_t, cks, cvs, fused_attn_write,
                                 ffn_fuse)
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
    logits = module_linear_nr(h, params["output"], norm=params["norm"], eps=args.norm_eps)
    return logits.to(torch.float32), cache


# ---------------------------------------------------------------- paged KV cache


def init_paged_cache(args: LLaMAArgs, slots: int, total_pages: int, page_size: int = 64,
                     pages_per_seq: Optional[int] = None, dtype=None,
                     kv_dtype: Optional[str] = None, device="cuda") -> kvcache.PagedKVCache:
    """A paged KV cache for this model (engine.kvcache.init_paged_cache): pools
    (n_layers, n_kv_heads, total_pages, page_size, head_dim) in ``dtype`` (the
    activation dtype by default) or int8 with scale pools."""
    pages_per_seq = pages_per_seq or (args.max_seq_len // page_size)
    return kvcache.init_paged_cache(args.n_layers, args.kv_heads, args.head_dim, total_pages,
                                    page_size, slots, pages_per_seq,
                                    dtype=torch_dtype(dtype or args.dtype), kv_dtype=kv_dtype,
                                    device=device)


def forward_paged(params: Params, args: LLaMAArgs, tokens: torch.Tensor,
                  pcache: kvcache.PagedKVCache, active_pages: Optional[int] = None,
                  continuation: bool = False) -> Tuple[torch.Tensor, kvcache.PagedKVCache]:
    """A forward over a paged KV cache, per-slot positions, in three modes:

    * sq > 1: a fresh prefill of every slot from position 0 (causal flash
      attention over the chunk);
    * sq > 1, ``continuation``: each slot's chunk continues at its own
      ``pcache.lengths`` (per-slot RoPE positions, attention over the cached
      pages plus causally the chunk: the paged decode kernel up to 16 tokens,
      the gather route above); with lengths 0 this is the fresh prefill;
    * sq == 1: one decode token per slot at position ``pcache.lengths``.

    Params are per-layer, fused (wqkv / w13) or separate. RoPE is applied
    after the projection at each slot's positions (the decode-RoPE epilogue
    of the static path needs one shared position). The pools are only read in
    the layer loop; after the last layer one ``write_tokens_all_layers`` call
    stores every layer's new k/v at each slot's positions. ``active_pages``
    bounds the pages read. Positions past the cache's capacity (a chunk's
    padded tail) take the last RoPE row: their k/v land in the TRASH page and
    their logits are discarded. Returns (logits f32 (b, sq, vocab), the cache
    with lengths + sq); the pools are updated in place."""
    _check_layers(params)
    b, sq = tokens.shape
    hd, nq, nkv = args.head_dim, args.n_heads, args.kv_heads
    h = params["tok_embeddings"]["weight"][tokens]
    dev = h.device
    max_pos = pcache.pages_per_seq * pcache.page_size
    cos_full, sin_full, _, _ = _rope_tables(hd, max_pos, args.rope_theta, args.rope_scaling,
                                            args.rope_style, nq + nkv, nkv, str(dev))
    lengths = pcache.lengths
    if sq == 1 or continuation:
        pos = lengths.to(torch.int64)[:, None] + torch.arange(sq, device=dev)[None, :]
        pos = pos.clamp(max=max_pos - 1)
        cos, sin = cos_full[pos], sin_full[pos]                  # (b, sq, hd / 2)
        start = lengths
    else:
        cos, sin = cos_full[:sq], sin_full[:sq]
        start = torch.zeros((b,), dtype=torch.int32, device=dev)
    new_k, new_v = [], []
    for i, layer in enumerate(params["layers"]):
        att = layer["attention"]
        if "wqkv" in att:
            qkv = module_linear_nr(h, att["wqkv"], norm=layer["attention_norm"],
                                   eps=args.norm_eps)
            q = qkv[..., :nq * hd].reshape(b, sq, nq, hd)
            k = qkv[..., nq * hd:(nq + nkv) * hd].reshape(b, sq, nkv, hd)
            v = qkv[..., (nq + nkv) * hd:].reshape(b, sq, nkv, hd)
        else:
            x = rms_norm(h, layer["attention_norm"]["weight"], args.norm_eps)
            q = module_linear(x, att["wq"]).reshape(b, sq, nq, hd)
            k = module_linear(x, att["wk"]).reshape(b, sq, nkv, hd)
            v = module_linear(x, att["wv"]).reshape(b, sq, nkv, hd)
        q = apply_rope(q, cos, sin, args.rope_style)
        k = apply_rope(k, cos, sin, args.rope_style)
        if sq == 1 or continuation:
            out = kvcache.paged_cached_attention(
                q, k, v, pcache.k_pages, pcache.v_pages, lengths, pcache.page_indices,
                active_pages, pcache.ks_pages, pcache.vs_pages, layer=i)
        else:
            out = attention(q, k, v, causal=True, q_offset=0)
        h = module_linear_nr(out.reshape(b, sq, nq * hd), att["wo"], residual=h)
        ff = layer["feed_forward"]
        if "w13" in ff:
            gu = module_linear_nr(h, ff["w13"], norm=layer["ffn_norm"], eps=args.norm_eps)
            hidden = gu.shape[-1] // 2
            gate = torch.nn.functional.silu(gu[..., :hidden])
            h = module_linear_nr(gate * gu[..., hidden:], ff["w2"], residual=h)
        else:
            x = rms_norm(h, layer["ffn_norm"]["weight"], args.norm_eps)
            gate = torch.nn.functional.silu(module_linear(x, ff["w1"]))
            h = module_linear_nr(gate * module_linear(x, ff["w3"]), ff["w2"], residual=h)
        new_k.append(k)
        new_v.append(v)
    # one paged write of every layer's new k/v (the stack is a copy of them)
    kvcache.write_tokens_all_layers(
        pcache.k_pages, pcache.v_pages, torch.stack(new_k), torch.stack(new_v),
        pcache.page_indices, start, pcache.ks_pages, pcache.vs_pages)
    logits = module_linear_nr(h, params["output"], norm=params["norm"], eps=args.norm_eps)
    return logits.to(torch.float32), dataclasses.replace(pcache, lengths=lengths + sq)
