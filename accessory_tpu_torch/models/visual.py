"""SPHINX's visual towers: ViT (CLIP ViT-L/14 and DINOv2 ViT-g/14 styles),
ConvNeXt and the BLIP-2 Q-Former, in plain PyTorch.

Port of ``accessory_tpu/models/visual.py`` (ViTConfig, init_vit, _attn,
vit_forward, ConvNeXtConfig, init_convnext, _depthwise7, convnext_forward,
QFormerConfig, init_qformer, qformer_forward). The params have the JAX
package's tree: a tower's blocks are stacked on a leading layer axis
(``blocks["qkv"]["weight"]`` is (L, width, 3 * width)), ConvNeXt's stages a
list, weights stored (in_dim, out_dim), so ``convert.params_from_jax`` carries
them across leaf for leaf. The JAX package runs the towers in XLA outside any
Pallas kernel; here they are torch matmuls and attention, in f32.

Precision: the towers compute in f32. Their matmuls follow the caller's
``torch.backends.cuda.matmul`` settings (PyTorch's default: IEEE f32, no
TF32). The ConvNeXt depthwise 7 x 7 convolution is 49 shifted multiply-adds
(``_depthwise7``), so it never reaches cuDNN, whose convolutions may take
TF32 by default (``torch.backends.cudnn.allow_tf32``); nothing here sets a
process-wide flag.

``resize_linear`` is ``jax.image.resize(..., "linear")`` on the trailing two
axes: antialiased where it shrinks (a triangle filter widened by the scale)
and plain bilinear where it grows, as JAX computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from accessory_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


def resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., size[0], size[1]) by linear interpolation with
    half-pixel centres: ``antialias`` where the image shrinks, none where it
    grows (the same weights as jax.image.resize's "linear")."""
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    if (h, w) == tuple(size):
        return x
    x4 = x.reshape((-1, 1) + (h, w))
    out = F.interpolate(x4, size=tuple(size), mode="bilinear", align_corners=False,
                        antialias=size[0] < h or size[1] < w)
    return out.reshape(lead + tuple(size))


def _dense(gen, shape, scale, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale


def _ln(shape, device):
    return {"weight": torch.ones(shape, device=device), "bias": torch.zeros(shape, device=device)}


# ---------------------------------------------------------------- ViT


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_ratio: float = 4.0
    act: str = "quick_gelu"   # CLIP: QuickGELU; DINOv2: exact GELU
    ln_pre: bool = True       # CLIP has a pre-transformer LayerNorm, DINOv2 none
    norm_eps: float = 1e-5    # CLIP 1e-5, DINOv2 1e-6
    layerscale: bool = False  # DINOv2: per-block residual scales ls1 / ls2
    ffn: str = "mlp"          # "mlp" | "swiglu" (DINOv2-giant)
    patch_bias: bool = False  # DINOv2's patch convolution has a bias

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def n_tokens(self) -> int:
        return self.n_patches + 1

    @property
    def ffn_hidden(self) -> int:
        if self.ffn == "swiglu":
            # 2/3 of the MLP width, rounded up to 8 (HF Dinov2SwiGLUFFN)
            h = int(self.width * self.mlp_ratio)
            return (int(h * 2 / 3) + 7) // 8 * 8
        return int(self.width * self.mlp_ratio)


def init_vit(cfg: ViTConfig, seed: int = 0, device="cuda") -> Params:
    """Random f32 ViT params from ``seed`` (fan-in scaled; norms one)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w, n_l, mlp = cfg.width, cfg.layers, cfg.ffn_hidden
    fc1_out = 2 * mlp if cfg.ffn == "swiglu" else mlp

    def dense(shape):
        return _dense(gen, shape, shape[-2] ** -0.5, device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    blocks = {
        "ln1": _ln((n_l, w), device), "ln2": _ln((n_l, w), device),
        "qkv": {"weight": dense((n_l, w, 3 * w)), "bias": zeros(n_l, 3 * w)},
        "proj": {"weight": dense((n_l, w, w)), "bias": zeros(n_l, w)},
        "fc1": {"weight": dense((n_l, w, fc1_out)), "bias": zeros(n_l, fc1_out)},
        "fc2": {"weight": dense((n_l, mlp, w)), "bias": zeros(n_l, w)},
    }
    if cfg.layerscale:
        blocks["ls1"] = torch.ones((n_l, w), device=device)
        blocks["ls2"] = torch.ones((n_l, w), device=device)
    patch = {"weight": _dense(gen, (cfg.patch_size * cfg.patch_size * 3, w), 0.02, device)}
    if cfg.patch_bias:
        patch["bias"] = zeros(w)
    out = {"patch_embed": patch,
           "cls_token": _dense(gen, (1, 1, w), w ** -0.5, device),
           "pos_embed": _dense(gen, (cfg.n_tokens, w), w ** -0.5, device),
           "blocks": blocks,
           "ln_post": _ln((w,), device)}
    if cfg.ln_pre:
        out["ln_pre"] = _ln((w,), device)
    return out


def _mha(q, k, v, heads: int):
    """Softmax attention of (b, tq, w) queries over (b, tk, w) keys / values,
    ``heads`` heads, no mask, scale head_dim^-0.5."""
    b, tq, w = q.shape
    hd = w // heads
    qh = q.reshape(b, tq, heads, hd).transpose(1, 2)
    kh = k.reshape(b, k.shape[1], heads, hd).transpose(1, 2)
    vh = v.reshape(b, v.shape[1], heads, hd).transpose(1, 2)
    out = F.scaled_dot_product_attention(qh, kh, vh)
    return out.transpose(1, 2).reshape(b, tq, w)


def _attn(x, qkv_w, qkv_b, proj_w, proj_b, heads: int):
    b, t, w = x.shape
    qkv = (x @ qkv_w + qkv_b).reshape(b, t, 3, w)
    return _mha(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], heads) @ proj_w + proj_b


def _quick_gelu(v):
    return v * torch.sigmoid(1.702 * v)


def vit_forward(params: Params, cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """images (b, 3, H, W) normalized -> (b, n_tokens, width)."""
    b = images.shape[0]
    p = cfg.patch_size
    g = cfg.image_size // p
    pe = params["patch_embed"]
    # patchify: (b, 3, g, p, g, p) -> (b, g*g, p*p*3), (row, col, channel) order
    x = images.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 3, 5, 1)
    x = x.reshape(b, g * g, p * p * 3).to(pe["weight"].dtype) @ pe["weight"]
    if cfg.patch_bias:
        x = x + pe["bias"]
    cls = params["cls_token"].expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][None]
    if cfg.ln_pre:
        x = layer_norm(x, params["ln_pre"]["weight"], params["ln_pre"]["bias"], cfg.norm_eps)
    act = _quick_gelu if cfg.act == "quick_gelu" else F.gelu
    blk = params["blocks"]
    for i in range(blk["qkv"]["weight"].shape[0]):
        h = layer_norm(x, blk["ln1"]["weight"][i], blk["ln1"]["bias"][i], cfg.norm_eps)
        h = _attn(h, blk["qkv"]["weight"][i], blk["qkv"]["bias"][i],
                  blk["proj"]["weight"][i], blk["proj"]["bias"][i], cfg.heads)
        if cfg.layerscale:
            h = h * blk["ls1"][i]
        x = x + h
        h = layer_norm(x, blk["ln2"]["weight"][i], blk["ln2"]["bias"][i], cfg.norm_eps)
        h = h @ blk["fc1"]["weight"][i] + blk["fc1"]["bias"][i]
        if cfg.ffn == "swiglu":
            gate, up = h.chunk(2, dim=-1)
            h = F.silu(gate) * up
        else:
            h = act(h)
        h = h @ blk["fc2"]["weight"][i] + blk["fc2"]["bias"][i]
        if cfg.layerscale:
            h = h * blk["ls2"][i]
        x = x + h
    return layer_norm(x, params["ln_post"]["weight"], params["ln_post"]["bias"], cfg.norm_eps)


# ---------------------------------------------------------------- ConvNeXt


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Tuple[int, ...] = (3, 4, 30, 3)
    dims: Tuple[int, ...] = (384, 768, 1536, 3072)  # XXL
    norm_eps: float = 1e-6


def init_convnext(cfg: ConvNeXtConfig, seed: int = 0, device="cuda") -> Params:
    """Random f32 ConvNeXt params from ``seed``; the layer scales start at
    1e-6, as ConvNeXt's do."""
    gen = torch.Generator(device=device).manual_seed(seed)
    stages = []
    for si, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        cin = 3 if si == 0 else cfg.dims[si - 1]
        patch = 4 if si == 0 else 2
        down = {"conv": _dense(gen, (patch * patch * cin, dim), 0.02, device),
                "conv_bias": torch.zeros(dim, device=device),
                "norm": _ln((dim if si == 0 else cin,), device)}
        blocks = {
            "dw": _dense(gen, (depth, 49, dim), 0.02, device),
            "dw_bias": torch.zeros((depth, dim), device=device),
            "norm": _ln((depth, dim), device),
            "pw1": {"weight": _dense(gen, (depth, dim, 4 * dim), dim ** -0.5, device),
                    "bias": torch.zeros((depth, 4 * dim), device=device)},
            "pw2": {"weight": _dense(gen, (depth, 4 * dim, dim), (4 * dim) ** -0.5, device),
                    "bias": torch.zeros((depth, dim), device=device)},
            "gamma": torch.full((depth, dim), 1e-6, device=device),
        }
        stages.append({"down": down, "blocks": blocks})
    return {"stages": stages}


def _depthwise7(x: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """x (b, h, w, c), dw (49, c): the depthwise 7 x 7 cross-correlation with
    3 pixels of zero padding on each side, as 49 shifted multiply-adds in f32
    (see the module docstring)."""
    b, h, w, c = x.shape
    # channels first, so each shifted read is a run along a row
    xp = F.pad(x.permute(0, 3, 1, 2), (3, 3, 3, 3))
    k = dw.reshape(7, 7, c, 1, 1)
    acc = torch.zeros((b, c, h, w), dtype=x.dtype, device=x.device)
    for i in range(7):
        for j in range(7):
            acc.addcmul_(xp[:, :, i:i + h, j:j + w], k[i, j])
    return acc.permute(0, 2, 3, 1)


def _patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(b, h, w, c) -> (b, h/p, w/p, p*p*c) in (row, col, channel) order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // p, w // p, p * p * c)


def convnext_forward(params: Params, cfg: ConvNeXtConfig, images: torch.Tensor) -> torch.Tensor:
    """images (b, 3, H, W) -> (b, (H/32) * (W/32), dims[-1]) feature tokens."""
    x = images.permute(0, 2, 3, 1)  # NHWC
    for si, stage in enumerate(params["stages"]):
        down = stage["down"]
        if si == 0:
            x = _patchify(x, 4) @ down["conv"] + down["conv_bias"]
            x = layer_norm(x, down["norm"]["weight"], down["norm"]["bias"], cfg.norm_eps)
        else:
            x = layer_norm(x, down["norm"]["weight"], down["norm"]["bias"], cfg.norm_eps)
            x = _patchify(x, 2) @ down["conv"] + down["conv_bias"]
        blk = stage["blocks"]
        for i in range(blk["dw"].shape[0]):
            h = _depthwise7(x, blk["dw"][i]) + blk["dw_bias"][i]
            h = layer_norm(h, blk["norm"]["weight"][i], blk["norm"]["bias"][i], cfg.norm_eps)
            h = F.gelu(h @ blk["pw1"]["weight"][i] + blk["pw1"]["bias"][i])
            h = h @ blk["pw2"]["weight"][i] + blk["pw2"]["bias"][i]
            x = x + blk["gamma"][i] * h
    b, hh, ww, c = x.shape
    return x.reshape(b, hh * ww, c)


# ---------------------------------------------------------------- Q-Former


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    n_queries: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    kv_dim: int = 1024       # the width of the visual features attended to
    norm_eps: float = 1e-12  # BERT LayerNorm


def init_qformer(cfg: QFormerConfig, seed: int = 0, device="cuda") -> Params:
    """Random f32 Q-Former params from ``seed`` (HF Blip2QFormerModel's
    layout, cross-attention on every layer)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w, n_l, mlp = cfg.width, cfg.layers, 4 * cfg.width

    def lin(k, n):
        return {"weight": _dense(gen, (n_l, k, n), k ** -0.5, device),
                "bias": torch.zeros((n_l, n), device=device)}

    return {
        "queries": _dense(gen, (cfg.n_queries, w), 0.02, device),
        "ln_q_in": _ln((w,), device),
        "blocks": {"self_qkv": lin(w, 3 * w), "proj": lin(w, w), "ln_self": _ln((n_l, w), device),
                   "q": lin(w, w), "kv": lin(cfg.kv_dim, 2 * w), "cproj": lin(w, w),
                   "ln_cross": _ln((n_l, w), device), "fc1": lin(w, mlp), "fc2": lin(mlp, w),
                   "ln_mlp": _ln((n_l, w), device)},
    }


def qformer_forward(params: Params, cfg: QFormerConfig, visual_feats: torch.Tensor) -> torch.Tensor:
    """visual_feats (b, t, kv_dim) -> (b, n_queries, width). Each layer:
    self-attention over the queries, post-LN; cross-attention to the raw
    visual features, post-LN; the MLP (exact GELU), post-LN. The query
    embeddings are layer-normed once on entry."""
    b = visual_feats.shape[0]
    kv = visual_feats.to(params["queries"].dtype)
    x = params["queries"][None].expand(b, cfg.n_queries, cfg.width)
    x = layer_norm(x, params["ln_q_in"]["weight"], params["ln_q_in"]["bias"], cfg.norm_eps)
    blk, eps = params["blocks"], cfg.norm_eps

    def lin(name, i, v):
        return v @ blk[name]["weight"][i] + blk[name]["bias"][i]

    def ln(name, i, v):
        return layer_norm(v, blk[name]["weight"][i], blk[name]["bias"][i], eps)

    for i in range(blk["proj"]["weight"].shape[0]):
        q, k, v = lin("self_qkv", i, x).chunk(3, dim=-1)
        x = ln("ln_self", i, x + lin("proj", i, _mha(q, k, v, cfg.heads)))
        k, v = lin("kv", i, kv).chunk(2, dim=-1)
        x = ln("ln_cross", i, x + lin("cproj", i, _mha(lin("q", i, x), k, v, cfg.heads)))
        h = lin("fc2", i, F.gelu(lin("fc1", i, x)))
        x = ln("ln_mlp", i, x + h)
    return x
