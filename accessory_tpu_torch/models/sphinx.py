"""SPHINX multimodal LLaMA (the llama_ens families): a visual ensemble whose
image tokens are spliced into the LLaMA decoder's prefill.

Port of ``accessory_tpu/models/sphinx.py`` (_tower_cfgs, words_per_crop,
n_crops, image_words, init_params, get_quant_blocklist,
get_trainable_params_filter, _split_crops, encode_image, forward and the
decoder passthroughs). Per crop of 224 px:

  * Q-Former: 32 tokens (768-d) -> qformer_proj (Linear + LayerNorm) -> dim;
  * CLIP ViT-L/14: 257 tokens (1024-d);
  * ConvNeXt-XXL on the crop resized to 256 px: 8 x 8 -> 2x nearest
    upsample -> 256 tokens, plus their mean as a cls token (3072-d);
  * DINOv2 ViT-g/14 on the crop renormalized from CLIP's to DINOv2's
    statistics: 257 tokens (1536-d);
  * the last three concatenated per token (5632-d) -> visual_proj -> dim;
  * [start_img] + 32 + 257 + [end_img]: 291 words a crop.

``ens_light`` drops CLIP and the Q-Former (259 words a crop). ``ens5``
(448 px) adds a 2 x 2 grid of 224-px tiles to the global view resized to
224 px (5 crops), ``ens10`` (672 px) a 3 x 3 grid (10 crops). ``ens5p2``
keeps the global view's 291 words and pools each tile's 16 x 16 patch grid
2x (32 + 1 + 64 + 2 words a tile). The towers run in f32
(``models/visual.py``); the image tokens are cast to the decoder dtype last.
The decoder is ``models/llama.py`` over the same params tree; the image words
go after the leading BOS.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from accessory_tpu_torch.config import SphinxArgs
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.models.llama import torch_dtype
from accessory_tpu_torch.models.visual import (ConvNeXtConfig, QFormerConfig, ViTConfig,
                                               convnext_forward, init_convnext, init_qformer,
                                               init_vit, qformer_forward, resize_linear,
                                               vit_forward)
from accessory_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
DINO_MEAN = (0.485, 0.456, 0.406)
DINO_STD = (0.229, 0.224, 0.225)

# the decoder is llama's: its capability flags, cache and paged-free serving
init_kv_cache = llama.init_kv_cache
SUPPORTS_UNROLLED_DECODE = True
SUPPORTS_KV_INT8 = True
SUPPORTS_FUSED_QKV = True
TOP_LEVEL_KEYS = llama.TOP_LEVEL_KEYS + ("visual",)


def _tower_cfgs(args: SphinxArgs):
    vit = ViTConfig(image_size=224, patch_size=args.vit_patch, width=args.clip_width,
                    layers=args.clip_layers, heads=args.clip_heads, act="quick_gelu")
    # DINOv2-giant's block: LayerScale, SwiGLU FFN, no pre-LN, eps 1e-6
    dino = ViTConfig(image_size=224, patch_size=args.vit_patch, width=args.dino_width,
                     layers=args.dino_layers, heads=args.dino_heads, act="gelu", ln_pre=False,
                     layerscale=True, ffn="swiglu", norm_eps=1e-6, patch_bias=True)
    conv = ConvNeXtConfig(depths=tuple(args.convnext_depths), dims=tuple(args.convnext_dims))
    qf = QFormerConfig(n_queries=32, width=args.qformer_width, layers=args.qformer_layers,
                       heads=args.qformer_heads, kv_dim=args.clip_width)
    return vit, dino, conv, qf


def _light(args: SphinxArgs) -> bool:
    return args.visual.startswith("ens_light") or args.visual.startswith("ens5_light")


def words_per_crop(args: SphinxArgs) -> int:
    n_vis = _tower_cfgs(args)[0].n_tokens
    if _light(args):
        return n_vis + 2   # no Q-Former
    return 32 + n_vis + 2


def n_crops(args: SphinxArgs) -> int:
    """1 for the single-view variants; g * g + 1 for a g x g grid of 224-px
    tiles plus the resized global view (g = image_size // 224)."""
    if not ("5" in args.visual or args.image_size > 224):
        return 1
    g = max(args.image_size // 224, 1)
    return 1 if g == 1 else g * g + 1


def image_words(args: SphinxArgs) -> int:
    if args.visual == "ens5p2":
        vit = _tower_cfgs(args)[0]
        main = 32 + vit.n_tokens + 2
        part = 32 + 1 + vit.n_patches // 4 + 2
        return main + part * (n_crops(args) - 1)
    return words_per_crop(args) * n_crops(args)


def init_params(args: SphinxArgs, seed: int = 0, device="cuda") -> Params:
    """llama's params plus the f32 ``visual`` subtree (``init_visual``)."""
    params = llama.init_params(args, seed=seed, device=device)
    params["visual"] = init_visual(args, seed, device)
    return params


def init_visual(args, seed: int = 0, device="cuda") -> Params:
    """The f32 ``visual`` subtree of a SPHINX host of width ``args.dim``
    (LLaMA's or Mixtral's), each tower drawn from its own generator seeded
    from ``seed``."""
    vit, dino, conv, qf = _tower_cfgs(args)
    d = args.dim
    gen = torch.Generator(device=device).manual_seed(seed * 1009 + 17)
    light = _light(args)
    ens_dim = conv.dims[-1] + dino.width + (0 if light else vit.width)

    def proj(k):
        return {"linear": {"weight": torch.randn((k, d), generator=gen, device=device) * k ** -0.5,
                           "bias": torch.zeros(d, device=device)},
                "norm": {"weight": torch.ones(d, device=device),
                         "bias": torch.zeros(d, device=device)}}

    visual: Params = {
        "convnext": init_convnext(conv, seed * 1009 + 2, device),
        "dinov2": init_vit(dino, seed * 1009 + 3, device),
        "visual_proj": proj(ens_dim),
        "start_img": torch.rand((1, 1, d), generator=gen, device=device),
        "end_img": torch.rand((1, 1, d), generator=gen, device=device),
    }
    if not light:
        visual["clip"] = init_vit(vit, seed * 1009 + 0, device)
        visual["qformer"] = init_qformer(qf, seed * 1009 + 1, device)
        visual["qformer_proj"] = proj(qf.width)
    return visual


def get_quant_blocklist(args: SphinxArgs):
    """The visual modules are never quantized."""
    return ["visual", "qformer", "clip", "convnext", "dinov2"]


def get_trainable_params_filter(args: SphinxArgs):
    base = llama.get_trainable_params_filter(args)
    return lambda name: base(name) and not name.startswith("visual/")


def _split_crops(args: SphinxArgs, images: torch.Tensor) -> torch.Tensor:
    """(b, 3, S, S) -> (b * n_crops, 3, 224, 224): the view resized to 224 px,
    then the g x g tiles row by row."""
    n = n_crops(args)
    if n == 1:
        return images
    b = images.shape[0]
    g = max(args.image_size // 224, 1)
    views = [resize_linear(images, (224, 224))]
    for i in range(g):
        for j in range(g):
            views.append(images[:, :, i * 224:(i + 1) * 224, j * 224:(j + 1) * 224])
    return torch.stack(views, dim=1).reshape(b * n, 3, 224, 224)


def _stats(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device).reshape(1, 3, 1, 1)


def tower_features(params: Params, args: SphinxArgs, crops: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The towers' outputs for (bc, 3, 224, 224) f32 crops: ``clip`` (bc, 257,
    clip_width; absent in the light variants), ``convnext`` (bc, 257,
    dims[-1]: upsampled, with the mean token first) and ``dinov2`` (bc, 257,
    dino_width)."""
    vis = params["visual"]
    vit, dino, conv, _ = _tower_cfgs(args)
    bc = crops.shape[0]
    out = {}
    if "clip" in vis:
        out["clip"] = vit_forward(vis["clip"], vit, crops)
    cf = convnext_forward(vis["convnext"], conv, resize_linear(crops, (256, 256)))
    g = int(round(cf.shape[1] ** 0.5))
    cf2 = cf.reshape(bc, g, 1, g, 1, -1).expand(bc, g, 2, g, 2, cf.shape[-1])
    cf2 = cf2.reshape(bc, 4 * g * g, -1)
    cf2 = torch.cat([cf2.mean(dim=1, keepdim=True), cf2], dim=1)
    n_tok = vit.n_tokens
    if cf2.shape[1] > n_tok:
        cf2 = cf2[:, :n_tok]
    elif cf2.shape[1] < n_tok:
        cf2 = torch.nn.functional.pad(cf2, (0, 0, 0, n_tok - cf2.shape[1]))
    out["convnext"] = cf2
    dino_in = (crops * _stats(CLIP_STD, crops) + _stats(CLIP_MEAN, crops)
               - _stats(DINO_MEAN, crops)) / _stats(DINO_STD, crops)
    out["dinov2"] = vit_forward(vis["dinov2"], dino, dino_in)
    return out


def _project(p: Params, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x @ p["linear"]["weight"] + p["linear"]["bias"], p["norm"]["weight"],
                      p["norm"]["bias"])


def encode_image(params: Params, args: SphinxArgs, images: torch.Tensor) -> torch.Tensor:
    """images (b, 3, S, S) CLIP-normalized -> (b, image_words, dim) in the
    decoder dtype."""
    vis = params["visual"]
    qf = _tower_cfgs(args)[3]
    crops = _split_crops(args, images.to(torch.float32))
    bc = crops.shape[0]
    feats = tower_features(params, args, crops)
    ens = torch.cat([feats[k] for k in ("clip", "convnext", "dinov2") if k in feats], dim=2)
    ens = _project(vis["visual_proj"], ens)
    light = "clip" not in feats
    qfeat = None
    if not light:
        qfeat = _project(vis["qformer_proj"], qformer_forward(vis["qformer"], qf, feats["clip"]))
    k = n_crops(args)
    b, d = bc // k, args.dim
    out_dtype = torch_dtype(args.dtype)

    if args.visual == "ens5p2" and k > 1:
        # the global view keeps every patch token; each tile's patch grid is
        # pooled 2x after visual_proj (a linear resize commutes with it)
        n_tok = ens.shape[1]
        qf_ = qfeat.reshape(b, k, qfeat.shape[1], d)
        ens_ = ens.reshape(b, k, n_tok, d)
        views = [torch.cat([qf_[:, 0], ens_[:, 0]], dim=1)]
        gg = int(round((n_tok - 1) ** 0.5))
        for v in range(1, k):
            pv = ens_[:, v]
            patch = pv[:, 1:1 + gg * gg].reshape(b, gg, gg, d).permute(0, 3, 1, 2)
            patch = resize_linear(patch, (gg // 2, gg // 2)).permute(0, 2, 3, 1)
            views.append(torch.cat([qf_[:, v], pv[:, :1], patch.reshape(b, -1, d)], dim=1))
        start = vis["start_img"].expand(b, 1, d)
        end = vis["end_img"].expand(b, 1, d)
        return torch.cat([t for v in views for t in (start, v, end)], dim=1).to(out_dtype)

    tokens = ens if light else torch.cat([qfeat, ens], dim=1)
    start = vis["start_img"].expand(bc, 1, d)
    end = vis["end_img"].expand(bc, 1, d)
    tokens = torch.cat([start, tokens, end], dim=1)
    return tokens.reshape(b, k * tokens.shape[1], d).to(out_dtype)


def splice(params: Params, tokens: torch.Tensor, img_tokens: torch.Tensor) -> torch.Tensor:
    """The prefill's embeddings: [BOS, image words, the rest of the text]."""
    emb = params["tok_embeddings"]["weight"][tokens]
    return torch.cat([emb[:, :1], img_tokens.to(emb.dtype), emb[:, 1:]], dim=1)


def forward_with(encode, decoder=llama.forward):
    """``decoder``'s forward (llama's, or Mixtral's for SPHINX-MoE) with an
    optional image prefix encoded by ``encode(params, args, images)``: with
    ``images`` the prefill embeds are [BOS, image words, rest of the text];
    without a cache (training, scoring) the image positions' logits are
    dropped, as many as the splice added. The decoder's outputs after the
    logits (the cache, Mixtral's aux loss) pass through."""

    def forward(params, args, tokens, *, cache=None, cur_pos=0, embeds=None, images=None, **kw):
        if images is not None:
            embeds = splice(params, tokens, encode(params, args, images))
        out = decoder(params, args, tokens, cache=cache, cur_pos=cur_pos, embeds=embeds, **kw)
        if images is not None and cache is None:
            out = (out[0][:, embeds.shape[1] - tokens.shape[1]:],) + tuple(out[1:])
        return out

    return forward


forward = forward_with(encode_image)
