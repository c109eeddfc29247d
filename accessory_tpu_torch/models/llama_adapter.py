"""LLaMA-Adapter: zero-init gated prefix tuning over a LLaMA decoder, and its
visual prefix.

Port of ``accessory_tpu/models/llama_adapter.py`` (init_params, _init_visual,
_clip_cfg, encode_visual_prefix, get_trainable_params_filter, init_kv_cache,
_prefix_mask, forward). The last ``prefix_layers`` layers carry
``prefix_len`` learned prefix embeddings, stacked (L, prefix_len, dim) with
per-head gates (L, n_heads) that start at zero. Each such layer's attention
output gains tanh(gate) x attention(q, wk(prefix), wv(prefix)): non-causal,
no RoPE on the prefix, the prefix's k / v projected again every forward as
the reference does. With zero gates the model is its LLaMA base. The JAX
package runs the prefix attention on every layer and zeroes the layers
without a prefix by their mask (one scan); here those layers skip it, which
adds exactly zero there (a finite delta times tanh(gate) x 0).

The visual branch (``init_params(with_visual=True)``): a ViT (``_clip_cfg``)
whose features, projected to ``v_embed_dim``, are attended by a zero-init
query through ``v_depth`` projector blocks; the query rows, projected to dim
and layer-normed, are ADDED to every layer's prefix. ``forward(images=)``
takes it (the training and scoring forward); the model has no
``encode_image``, so the Generator serves text only, as the JAX package's.

The decoder runs LLaMA's separate wq, wk, wv / w1, w3 projections (no fused
wqkv, no RoPE epilogue) and serves from a stacked cache only: read-only
attention in each layer (``cached_attention_t``: flash at position 0, the
read-only decode kernels at one token) and one ``write_kv_t`` of every
layer's new k / v after the last. ``init_kv_cache`` gives that cache in the
activation dtype whatever ``kv_dtype`` says (the prefix path has no int8
cache). The prefix attention is the plain grouped attention (an XLA op in
the JAX package, no Pallas kernel).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from accessory_tpu_torch.config import AdapterArgs
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.models.llama import torch_dtype
from accessory_tpu_torch.models.visual import ViTConfig, init_vit, vit_forward
from accessory_tpu_torch.ops.attention import attention
from accessory_tpu_torch.ops.decode_attention import cached_attention_t, write_kv_t
from accessory_tpu_torch.ops.linear import linear, module_linear
from accessory_tpu_torch.ops.norms import layer_norm, rms_norm
from accessory_tpu_torch.ops.rope import apply_rope
from accessory_tpu_torch.util import remat_policy

Params = Dict[str, Any]

TOP_LEVEL_KEYS = llama.TOP_LEVEL_KEYS + ("adapter",)


def init_params(args: AdapterArgs, seed: int = 0, device="cuda",
                with_visual: bool = False) -> Params:
    """llama's params plus ``adapter``: the prefix (normal x 0.02 in the
    model dtype) and zero gates; with ``with_visual`` the f32 ``visual``
    branch."""
    params = llama.init_params(args, seed=seed, device=device)
    dtype = torch_dtype(args.dtype)
    gen = torch.Generator(device=device).manual_seed(seed * 1009 + 23)
    prefix = torch.randn((args.n_layers, args.prefix_len, args.dim), generator=gen,
                         device=device) * 0.02
    params["adapter"] = {"prefix": prefix.to(dtype),
                         "gate": torch.zeros((args.n_layers, args.n_heads), dtype=dtype,
                                             device=device)}
    if with_visual:
        params["visual"] = _init_visual(args, seed, device)
    return params


def _init_visual(args: AdapterArgs, seed: int = 0, device="cuda") -> Params:
    """The visual prefix branch, f32: the ViT, its projection to
    v_embed_dim, the zero query, ``v_depth`` projector blocks stacked on a
    leading axis, and the projection to dim with its LayerNorm."""
    gen = torch.Generator(device=device).manual_seed(seed * 1009 + 29)
    ve, vd = args.v_embed_dim, args.v_depth
    mlp = int(ve * args.v_mlp_ratio)

    def dense(*shape):
        return torch.randn(shape, generator=gen, device=device) * shape[-2] ** -0.5

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ln(*shape):
        return {"weight": torch.ones(shape, device=device), "bias": zeros(*shape)}

    clip_cfg = _clip_cfg(args)
    return {
        "clip": init_vit(clip_cfg, seed * 1009 + 31, device),
        "clip_proj": {"weight": dense(clip_cfg.width, ve), "bias": zeros(ve)},
        "query": zeros(args.prefix_len, ve),
        "blocks": {
            "ln1": ln(vd, ve), "ln2": ln(vd, ve),
            "qkv": {"weight": dense(vd, ve, 3 * ve), "bias": zeros(vd, 3 * ve)},
            "proj": {"weight": dense(vd, ve, ve), "bias": zeros(vd, ve)},
            "fc1": {"weight": dense(vd, ve, mlp), "bias": zeros(vd, mlp)},
            "fc2": {"weight": dense(vd, mlp, ve), "bias": zeros(vd, ve)},
        },
        "out_proj": {"weight": dense(ve, args.dim), "bias": zeros(args.dim)},
        "out_norm": ln(args.dim),
    }


def _clip_cfg(args: AdapterArgs) -> ViTConfig:
    """The visual branch's ViT, as the JAX package builds it. Its comment
    there names CLIP ViT-L/14, but at the default ``v_embed_dim`` 768 this
    gives a 2-layer, 768-wide ViT at patch 14 (ROADMAP C12): the port
    computes what the reference computes."""
    width = max(args.v_embed_dim, 32)
    return ViTConfig(image_size=224, patch_size=14 if width >= 256 else 56,
                     width=width if width >= 256 else args.v_embed_dim,
                     layers=24 if width >= 1024 else 2,
                     heads=16 if width >= 1024 else args.v_num_heads)


def encode_visual_prefix(params: Params, args: AdapterArgs, images: torch.Tensor) -> torch.Tensor:
    """images (b, 3, 224, 224) -> (b, prefix_len, dim) visual prefix delta in
    the model dtype. f32 throughout; the projector's GELU is the tanh form
    (``jax.nn.gelu``'s default)."""
    vis = params["visual"]
    feats = vit_forward(vis["clip"], _clip_cfg(args), images.to(torch.float32))
    feats = linear(feats, vis["clip_proj"]["weight"], vis["clip_proj"]["bias"])
    b, pl, ve = feats.shape[0], args.prefix_len, args.v_embed_dim
    heads = args.v_num_heads
    hd = ve // heads
    x = torch.cat([vis["query"][None].expand(b, pl, ve), feats], dim=1)
    blk = vis["blocks"]
    for i in range(blk["qkv"]["weight"].shape[0]):
        h = layer_norm(x, blk["ln1"]["weight"][i], blk["ln1"]["bias"][i])
        qkv = linear(h, blk["qkv"]["weight"][i], blk["qkv"]["bias"][i]).reshape(
            b, -1, 3, heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        p = torch.softmax(s, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, -1, ve)
        x = x + linear(o, blk["proj"]["weight"][i], blk["proj"]["bias"][i])
        h = layer_norm(x, blk["ln2"]["weight"][i], blk["ln2"]["bias"][i])
        h = F.gelu(linear(h, blk["fc1"]["weight"][i], blk["fc1"]["bias"][i]),
                   approximate="tanh")
        x = x + linear(h, blk["fc2"]["weight"][i], blk["fc2"]["bias"][i])
    delta = linear(x[:, :pl], vis["out_proj"]["weight"], vis["out_proj"]["bias"])
    delta = layer_norm(delta, vis["out_norm"]["weight"], vis["out_norm"]["bias"])
    return delta.to(torch_dtype(args.dtype))


def get_trainable_params_filter(args: AdapterArgs):
    """Only the adapter (prefix and gates) trains."""
    return lambda name: name.startswith("adapter")


def init_kv_cache(args: AdapterArgs, batch: int, max_len: Optional[int] = None, dtype=None,
                  stacked: bool = True, kv_dtype: Optional[str] = None,
                  device="cuda") -> Dict[str, Any]:
    """llama's stacked static cache, always in the activation dtype (``dtype``
    or the model's): ``kv_dtype`` is taken and ignored, as in the JAX
    package, whose prefix path has no int8 scales."""
    return llama.init_kv_cache(args, batch, max_len, dtype, stacked, "fp", device=device)


def _prefix_mask(args: AdapterArgs) -> torch.Tensor:
    """(L,) f32: 1.0 on the layers that carry a prefix (the last
    ``prefix_layers``; None: all), 0.0 elsewhere."""
    pl = args.prefix_layers if args.prefix_layers is not None else args.n_layers
    return (torch.arange(args.n_layers) >= args.n_layers - pl).to(torch.float32)


def _block(h, layer, args: AdapterArgs, cos, sin, prefix, gate, visual_delta, cache_k,
           cache_v, pos: int):
    """One layer: (h, k, v). ``prefix`` None: a layer without a prefix."""
    b, sq, _ = h.shape
    hd, nq, nkv = args.head_dim, args.n_heads, args.kv_heads
    att = layer["attention"]
    x = rms_norm(h, layer["attention_norm"]["weight"], args.norm_eps)
    q = module_linear(x, att["wq"]).reshape(b, sq, nq, hd)
    k = module_linear(x, att["wk"]).reshape(b, sq, nkv, hd)
    v = module_linear(x, att["wv"]).reshape(b, sq, nkv, hd)
    q = apply_rope(q, cos, sin, args.rope_style)
    k = apply_rope(k, cos, sin, args.rope_style)
    if cache_k is not None:
        out = cached_attention_t(q, k, v, cache_k, cache_v, pos)
    else:
        out = attention(q, k, v, causal=True, q_offset=0)
    if prefix is not None:
        pb = prefix[None].expand(b, args.prefix_len, args.dim)
        if visual_delta is not None:
            pb = pb + visual_delta
        pk = module_linear(pb, att["wk"]).reshape(b, args.prefix_len, nkv, hd)
        pv = module_linear(pb, att["wv"]).reshape(b, args.prefix_len, nkv, hd)
        delta = attention(q, pk, pv, causal=False, q_offset=0)
        g = torch.tanh(gate.to(torch.float32))[None, None, :, None]
        out = out + (g * delta.to(torch.float32)).to(out.dtype)
    h = h + module_linear(out.reshape(b, sq, nq * hd), att["wo"])
    x = rms_norm(h, layer["ffn_norm"]["weight"], args.norm_eps)
    ff = layer["feed_forward"]
    gatev = F.silu(module_linear(x, ff["w1"]))
    h = h + module_linear(gatev * module_linear(x, ff["w3"]), ff["w2"])
    return h, k, v


def forward(params: Params, args: AdapterArgs, tokens: torch.Tensor, *,
            cache: Optional[Dict[str, Any]] = None, cur_pos=0, remat=False,
            embeds: Optional[torch.Tensor] = None, images: Optional[torch.Tensor] = None,
            ffn_fuse: bool = False):
    """(logits f32 (b, sq, vocab), cache). ``cache=None``: the training /
    scoring forward (``remat`` checkpoints each layer); a stacked cache
    (``init_kv_cache``) is read in each layer and written once after the
    last, in place. ``images`` (b, 3, 224, 224): the visual prefix, added
    to every prefix layer's prefix (the model needs ``visual`` params).
    ``ffn_fuse`` is the engines' switch for LLaMA's fused FFN kernel; the
    adapter's blocks take none, so it must stay off."""
    if ffn_fuse:
        raise ValueError("ffn_fuse: the adapter's blocks take separate projections only")
    visual_delta = None if images is None else encode_visual_prefix(params, args, images)
    h = embeds if embeds is not None else params["tok_embeddings"]["weight"][tokens]
    sq = h.shape[1]
    ad = params["adapter"]
    has_prefix = _prefix_mask(args).tolist()    # from args alone, on the host
    if cache is not None and not isinstance(cache["k"], torch.Tensor):
        raise ValueError("the adapter serves from a stacked cache (init_kv_cache(stacked=True))")
    if cache is not None and "ks" in cache:
        raise ValueError("the adapter's cache is in the activation dtype (no int8 scales)")
    max_rope = cache["k"].shape[3] if cache is not None else sq
    cos, sin, _, _ = llama._rope_tables(args.head_dim, max_rope, args.rope_theta,
                                        args.rope_scaling, args.rope_style,
                                        args.n_heads + args.kv_heads, args.kv_heads,
                                        str(h.device))
    cos, sin = ((llama.rope_at(cos, cur_pos, sq), llama.rope_at(sin, cur_pos, sq))
                if cache is not None else (cos[:sq], sin[:sq]))

    def prefix_of(i):
        return (ad["prefix"][i], ad["gate"][i]) if has_prefix[i] else (None, None)

    if cache is None:
        checkpoint = remat_policy(remat)

        def block(h, layer, prefix, gate):
            return _block(h, layer, args, cos, sin, prefix, gate, visual_delta, None, None,
                          0)[0]

        for i, layer in enumerate(params["layers"]):
            args_i = (h, layer) + prefix_of(i)
            h = block(*args_i) if checkpoint is None else checkpoint(block, *args_i)
    else:
        new_k, new_v = [], []
        for i, layer in enumerate(params["layers"]):
            h, k, v = _block(h, layer, args, cos, sin, *prefix_of(i), visual_delta,
                             cache["k"][i], cache["v"][i], cur_pos)
            new_k.append(k)
            new_v.append(v)
        write_kv_t(cache["k"], cache["v"], torch.stack(new_k), torch.stack(new_v), cur_pos)
    h = rms_norm(h, params["norm"]["weight"], args.norm_eps)
    return linear(h, params["output"]["weight"]).to(torch.float32), cache
