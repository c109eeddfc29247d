"""Falcon (7B / 40B / 180B): separate wq, wk, wv projections (GQA, or one KV
head with ``multi_query``), "half"-pair RoPE, LayerNorm and a 4x tanh-GELU
MLP, in one of three block topologies:

* ``new_decoder_architecture``: two parallel layernorms (ln_attn, ln_mlp)
  read the same residual; out = h + attn + mlp (Falcon-40B / 180B);
* else ``parallel_attn``: one input_layernorm feeds both branches (7B);
* else sequential, with a post_attention_layernorm before the MLP.

Port of ``accessory_tpu/models/falcon.py`` (init_params, init_kv_cache,
_block, forward) on the port's per-layer trees. Every projection is its own
W4 product (``ops.linear.linear``, the bias added after it where
``args.bias``), six a layer; no fused weights (``SUPPORTS_FUSED_QKV``
unset, as in the reference). The attention over the static cache and the
cache writes are ``models.static``'s, bf16 or int8, per-layer or stacked;
``forward`` without a cache is the training forward. No paged forward, so
the continuous batcher does not serve it (as in the reference).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from accessory_tpu_torch.config import FalconArgs
from accessory_tpu_torch.models import llama, static
from accessory_tpu_torch.models.llama import torch_dtype
from accessory_tpu_torch.ops.linear import linear
from accessory_tpu_torch.ops.norms import layer_norm
from accessory_tpu_torch.ops.rope import apply_rope

Params = Dict[str, Any]

# the capability flags the engines read with getattr (reference :38-41)
SUPPORTS_UNROLLED_DECODE = True
SUPPORTS_KV_INT8 = True

TOP_LEVEL_KEYS = ("word_embeddings", "layers", "ln_f", "output")


def _ln(x, mod: Params, args: FalconArgs):
    return layer_norm(x, mod["weight"], mod["bias"], args.layer_norm_epsilon)


def _mod(x, mod: Params):
    return linear(x, mod["weight"], mod.get("bias"))


def init_params(args: FalconArgs, seed: int = 0, device="cuda") -> Params:
    """Random per-layer params from ``seed`` (normal, fan-in scaled, the
    embeddings at 0.02); layernorms weight one and bias zero, projection
    biases zero where ``args.bias``."""
    dtype = torch_dtype(args.dtype)
    d, kvd = args.hidden_size, args.kv_heads * args.head_dim
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(shape, scale=None):
        scale = scale or shape[0] ** -0.5
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w * scale).to(dtype)

    def mod(din, dout):
        m = {"weight": dense((din, dout))}
        if args.bias:
            m["bias"] = torch.zeros(dout, dtype=dtype, device=device)
        return m

    def ln():
        return {"weight": torch.ones(d, dtype=dtype, device=device),
                "bias": torch.zeros(d, dtype=dtype, device=device)}

    tok = dense((args.vocab_size, d), 0.02)
    layers: List[Params] = []
    for _ in range(args.num_layers):
        layer = {"self_attention": {"wq": mod(d, d), "wk": mod(d, kvd), "wv": mod(d, kvd),
                                    "dense": mod(d, d)},
                 "mlp": {"dense_h_to_4h": mod(d, 4 * d), "dense_4h_to_h": mod(4 * d, d)}}
        if args.new_decoder_architecture:
            layer["ln_attn"], layer["ln_mlp"] = ln(), ln()
        else:
            layer["input_layernorm"] = ln()
            if not args.parallel_attn:
                layer["post_attention_layernorm"] = ln()
        layers.append(layer)
    return {"word_embeddings": {"weight": tok}, "layers": layers, "ln_f": ln(),
            "output": {"weight": dense((d, args.vocab_size))}}


def init_kv_cache(args: FalconArgs, batch: int, max_len: Optional[int] = None,
                  dtype=None, stacked: bool = False, kv_dtype: Optional[str] = None,
                  device="cuda") -> Dict[str, Any]:
    """The static KV cache of ``models.llama.init_kv_cache`` over
    ``args.kv_heads`` KV heads (per-layer pools by default)."""
    return llama.init_kv_cache(args, batch, max_len, dtype, stacked, kv_dtype, device=device)


def _mlp(x, layer: Params):
    mlp = layer["mlp"]
    return _mod(F.gelu(_mod(x, mlp["dense_h_to_4h"]), approximate="tanh"), mlp["dense_4h_to_h"])


def _block(h, layer, args: FalconArgs, cos, sin, pos: int, cache_k, cache_v,
           update_cache: bool, cache_ks=None, cache_vs=None, fused_attn_write: bool = True,
           attn_fn=None):
    """One block of the args' topology: (h, k, v), or with ``update_cache``
    (h, cache_k, cache_v) (``models.static.attend``)."""
    b, sq, d = h.shape
    nh, nkv, hd = args.num_attention_heads, args.kv_heads, args.head_dim
    att = layer["self_attention"]
    if args.new_decoder_architecture:
        attn_in, mlp_in = _ln(h, layer["ln_attn"], args), _ln(h, layer["ln_mlp"], args)
    else:
        attn_in = mlp_in = _ln(h, layer["input_layernorm"], args)
    q = apply_rope(_mod(attn_in, att["wq"]).reshape(b, sq, nh, hd), cos, sin, "half")
    k = apply_rope(_mod(attn_in, att["wk"]).reshape(b, sq, nkv, hd), cos, sin, "half")
    v = _mod(attn_in, att["wv"]).reshape(b, sq, nkv, hd)
    out, k, v = static.attend(q, k, v, pos, cache_k, cache_v, cache_ks, cache_vs, update_cache,
                              fused_attn_write, attn_fn)
    attn_out = _mod(out.reshape(b, sq, d), att["dense"])
    if not args.new_decoder_architecture and not args.parallel_attn:
        h = h + attn_out
        return h + _mlp(_ln(h, layer["post_attention_layernorm"], args), layer), k, v
    return h + attn_out + _mlp(mlp_in, layer), k, v


def forward(params: Params, args: FalconArgs, tokens: torch.Tensor, *,
            cache: Optional[Dict[str, Any]] = None, cur_pos=0,
            fused_attn_write: bool = True, ffn_fuse: bool = False, remat=False, attn_fn=None):
    """A chunk of tokens at position ``cur_pos`` over per-layer params, the
    contract of ``models.llama.forward``: (logits f32 (b, sq, vocab), cache),
    the cache updated in place; ``cache=None`` is the training forward.
    ``ffn_fuse`` is the engines' switch for LLaMA's fused FFN kernel, which
    Falcon's GELU MLP does not take, so it must stay off."""
    if ffn_fuse:
        raise ValueError("ffn_fuse: Falcon's GELU MLP has no fused FFN kernel")
    h = params["word_embeddings"]["weight"][tokens]
    h = static.run_layers(_block, args, params["layers"], h, cache, cur_pos,
                          (args.head_dim, args.rope_theta, args.rope_scaling),
                          fused_attn_write=fused_attn_write, remat=remat, attn_fn=attn_fn)
    h = _ln(h, params["ln_f"], args)
    return linear(h, params["output"]["weight"]).to(torch.float32), cache
