"""InternLM: fused Wqkv attention with bias (multi-head), "half"-pair RoPE,
RMSNorm (or LayerNorm) and a SwiGLU (or tanh-GELU) FFN whose weights keep
the reference's names: ``inner = silu(x w1) * (x w2)``, then ``h + inner
w3``.

Port of ``accessory_tpu/models/internlm.py`` (_hidden_dim, _norm,
init_params, init_kv_cache, _block, forward) on the port's per-layer trees:
``layers`` is a list of per-layer dicts, weights (in_dim, out_dim). Every
projection is its own W4 product (``ops.linear.linear``: the kernel, then
the bias), five a layer: Wqkv, whose output splits as (b, sq, 3, heads,
head_dim), out_proj, w1, w2 and w3. LLaMA's fused wqkv / w13 weights and
fused FFN kernel do not apply (``SUPPORTS_FUSED_QKV`` is unset, as in the
reference: Wqkv is fused by the model itself). The attention over the
static cache and the cache writes are ``models.static``'s: per-layer pools
(the fused decode attention + write at one token, the flash kernel and a
slab write for a prefill) or a stacked cache (read in each layer, written
once a forward), bf16 or int8. ``forward`` without a cache is the training
forward (``remat``, ``attn_fn``). The model has no paged forward, so the
continuous batcher does not serve it (as in the reference).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from accessory_tpu_torch.config import InternLMArgs
from accessory_tpu_torch.models import llama, static
from accessory_tpu_torch.models.llama import torch_dtype
from accessory_tpu_torch.ops.linear import linear
from accessory_tpu_torch.ops.norms import layer_norm, rms_norm
from accessory_tpu_torch.ops.rope import apply_rope

Params = Dict[str, Any]

# the capability flags the engines read with getattr (reference :38-41)
SUPPORTS_UNROLLED_DECODE = True
SUPPORTS_KV_INT8 = True

TOP_LEVEL_KEYS = ("word_embeddings", "layers", "norm", "output")


def _hidden_dim(args: InternLMArgs) -> int:
    h = int(args.hidden_size * args.mlp_ratio)
    return args.multiple_of * ((h + args.multiple_of - 1) // args.multiple_of)


def _norm(x, mod: Params, args: InternLMArgs):
    if args.norm_type == "rmsnorm":
        return rms_norm(x, mod["weight"], args.layer_norm_epsilon)
    return layer_norm(x, mod["weight"], mod.get("bias"), args.layer_norm_epsilon)


def init_params(args: InternLMArgs, seed: int = 0, device="cuda") -> Params:
    """Random per-layer params from ``seed`` (normal, fan-in scaled, the
    embeddings at 0.02); norm weights one, biases zero (with layernorm the
    norms carry a zero bias too)."""
    dtype = torch_dtype(args.dtype)
    d, hidden = args.hidden_size, _hidden_dim(args)
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(shape, scale=None):
        scale = scale or shape[0] ** -0.5
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w * scale).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    def norm():
        mod = {"weight": torch.ones(d, dtype=dtype, device=device)}
        if args.norm_type == "layernorm":
            mod["bias"] = zeros(d)
        return mod

    tok = dense((args.vocab_size, d), 0.02)
    layers: List[Params] = []
    for _ in range(args.num_layers):
        layers.append({
            "norm1": norm(), "norm2": norm(),
            "mixer": {"Wqkv": {"weight": dense((d, 3 * d)), "bias": zeros(3 * d)},
                      "out_proj": {"weight": dense((d, d)), "bias": zeros(d)}},
            "mlp": {"w1": {"weight": dense((d, hidden))}, "w2": {"weight": dense((d, hidden))},
                    "w3": {"weight": dense((hidden, d))}},
        })
    return {"word_embeddings": {"weight": tok}, "layers": layers, "norm": norm(),
            "output": {"weight": dense((d, args.vocab_size))}}


def init_kv_cache(args: InternLMArgs, batch: int, max_len: Optional[int] = None,
                  dtype=None, stacked: bool = False, kv_dtype: Optional[str] = None,
                  device="cuda") -> Dict[str, Any]:
    """The static KV cache of ``models.llama.init_kv_cache`` (one KV head a
    query head; per-layer pools by default)."""
    return llama.init_kv_cache(args, batch, max_len, dtype, stacked, kv_dtype, device=device)


def _block(h, layer, args: InternLMArgs, cos, sin, pos: int, cache_k, cache_v,
           update_cache: bool, cache_ks=None, cache_vs=None, fused_attn_write: bool = True,
           attn_fn=None):
    """One block: (h, k, v), or with ``update_cache`` (h, cache_k, cache_v)
    (``models.static.attend``)."""
    b, sq, d = h.shape
    nh, hd = args.num_attention_heads, args.head_dim
    mx = layer["mixer"]
    x = _norm(h, layer["norm1"], args)
    qkv = linear(x, mx["Wqkv"]["weight"], mx["Wqkv"].get("bias")).reshape(b, sq, 3, nh, hd)
    q = apply_rope(qkv[:, :, 0], cos, sin, "half")
    k = apply_rope(qkv[:, :, 1], cos, sin, "half")
    out, k, v = static.attend(q, k, qkv[:, :, 2], pos, cache_k, cache_v, cache_ks, cache_vs,
                              update_cache, fused_attn_write, attn_fn)
    h = h + linear(out.reshape(b, sq, d), mx["out_proj"]["weight"], mx["out_proj"].get("bias"))
    x = _norm(h, layer["norm2"], args)
    mlp = layer["mlp"]
    if args.use_swiglu:
        inner = F.silu(linear(x, mlp["w1"]["weight"])) * linear(x, mlp["w2"]["weight"])
    else:
        inner = F.gelu(linear(x, mlp["w1"]["weight"]), approximate="tanh")
    return h + linear(inner, mlp["w3"]["weight"]), k, v


def forward(params: Params, args: InternLMArgs, tokens: torch.Tensor, *,
            cache: Optional[Dict[str, Any]] = None, cur_pos=0,
            fused_attn_write: bool = True, ffn_fuse: bool = False, remat=False, attn_fn=None):
    """A chunk of tokens at position ``cur_pos`` over per-layer params, the
    contract of ``models.llama.forward``: (logits f32 (b, sq, vocab), cache),
    the cache updated in place; ``cache=None`` is the training forward.
    ``ffn_fuse`` is the engines' switch for LLaMA's fused FFN kernel, which
    InternLM's FFN does not take, so it must stay off."""
    if ffn_fuse:
        raise ValueError("ffn_fuse: InternLM's FFN (w1, w2, w3) has no fused FFN kernel")
    h = params["word_embeddings"]["weight"][tokens]
    h = static.run_layers(_block, args, params["layers"], h, cache, cur_pos,
                          (args.head_dim, args.rope_theta, args.rope_scaling),
                          fused_attn_write=fused_attn_write, remat=remat, attn_fn=attn_fn)
    h = _norm(h, params["norm"], args)
    return linear(h, params["output"]["weight"]).to(torch.float32), cache
