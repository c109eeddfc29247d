"""LLaMA with a BLIP-2 visual branch (the llama_qformerv2 family): a CLIP-style
vision tower and a Q-Former give 32 image tokens (768-d) -> qformer_proj
(Linear + LayerNorm -> dim), between learned start_img / end_img tags.

Port of ``accessory_tpu/models/llama_qformerv2.py``. The decoder, the cache
and the capability flags are llama's, the forward ``models/sphinx.py``'s
splice; the tower and the Q-Former are frozen and never quantized, the
projection and the tags train.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from accessory_tpu_torch.config import SphinxArgs
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.models.llama import torch_dtype
# splice: the module attribute the Generator's prefill calls
from accessory_tpu_torch.models.sphinx import _project, forward_with, splice  # noqa: F401
from accessory_tpu_torch.models.visual import (QFormerConfig, ViTConfig, init_qformer, init_vit,
                                               qformer_forward, vit_forward)

Params = Dict[str, Any]

init_kv_cache = llama.init_kv_cache
SUPPORTS_UNROLLED_DECODE = True
SUPPORTS_KV_INT8 = True
SUPPORTS_FUSED_QKV = True
TOP_LEVEL_KEYS = llama.TOP_LEVEL_KEYS + ("visual",)


def _cfgs(args: SphinxArgs):
    vit = ViTConfig(image_size=224, patch_size=args.vit_patch, width=args.clip_width,
                    layers=args.clip_layers, heads=args.clip_heads)
    qf = QFormerConfig(n_queries=32, width=args.qformer_width, layers=args.qformer_layers,
                       heads=args.qformer_heads, kv_dim=args.clip_width)
    return vit, qf


def image_words(args: SphinxArgs) -> int:
    return 32 + 2   # the queries and the two tags


def init_params(args: SphinxArgs, seed: int = 0, device="cuda") -> Params:
    params = llama.init_params(args, seed=seed, device=device)
    vit, qf = _cfgs(args)
    d = args.dim
    gen = torch.Generator(device=device).manual_seed(seed * 1009 + 29)
    params["visual"] = {
        "vision_tower": init_vit(vit, seed * 1009 + 30, device),
        "qformer": init_qformer(qf, seed * 1009 + 31, device),
        "qformer_proj": {
            "linear": {"weight": torch.randn((qf.width, d), generator=gen, device=device)
                       * qf.width ** -0.5,
                       "bias": torch.zeros(d, device=device)},
            "norm": {"weight": torch.ones(d, device=device), "bias": torch.zeros(d, device=device)},
        },
        "start_img": torch.rand((1, 1, d), generator=gen, device=device),
        "end_img": torch.rand((1, 1, d), generator=gen, device=device),
    }
    return params


def get_quant_blocklist(args: SphinxArgs):
    return ["visual", "qformer", "vision_tower"]


def get_trainable_params_filter(args: SphinxArgs):
    base = llama.get_trainable_params_filter(args)

    def f(name: str) -> bool:
        if name.startswith("visual/qformer/") or name.startswith("visual/vision_tower/"):
            return False
        return base(name) or name.startswith("visual/")

    return f


def encode_image(params: Params, args: SphinxArgs, images: torch.Tensor) -> torch.Tensor:
    """(b, 3, 224, 224) -> (b, 34, dim): [start_img] + 32 queries + [end_img]."""
    vit, qf = _cfgs(args)
    vis = params["visual"]
    feats = vit_forward(vis["vision_tower"], vit, images.to(torch.float32))
    qtok = _project(vis["qformer_proj"], qformer_forward(vis["qformer"], qf, feats))
    b = qtok.shape[0]
    start = vis["start_img"].expand(b, 1, args.dim)
    end = vis["end_img"].expand(b, 1, args.dim)
    return torch.cat([start, qtok, end], dim=1).to(torch_dtype(args.dtype))


forward = forward_with(encode_image)
