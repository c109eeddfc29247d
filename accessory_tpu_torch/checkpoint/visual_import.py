"""Pretrained visual-tower weights -> the port's tower params
(``models/visual.py``). Port of ``accessory_tpu/checkpoint/visual_import.py``:
numpy state dicts in transformers' names (CLIPVisionModel, Dinov2Model,
ConvNextModel, Blip2QFormerModel; open_clip / timm ConvNeXt names through
``_timm_to_hf_convnext``) become f32 tensors on ``device``:

  * a patch convolution (w, 3, p, p) -> the patchify matmul (p*p*3, w) in
    (row, col, channel) order; a ConvNeXt downsampling conv likewise over
    its input channels; a depthwise (c, 1, 7, 7) kernel -> (49, c);
  * separate q / k / v (and the Q-Former's cross k / v) -> one fused
    weight, output order q; k; v;
  * linear weights (out, in) -> (in, out), stacked on a leading layer axis.

``load_hf_clip_vision`` / ``load_hf_dinov2`` read a transformers model
(transformers is imported inside them: the card's machine has none).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from accessory_tpu_torch.models.visual import ConvNeXtConfig, QFormerConfig, ViTConfig


def _f32(sd, name) -> np.ndarray:
    return np.asarray(sd[name], np.float32)


def _t(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)).to(device)


def _tr(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _patch(conv: np.ndarray, width: int) -> np.ndarray:
    """(w, c, p, p) convolution -> (p*p*c, w) in (row, col, channel) order."""
    return conv.transpose(2, 3, 1, 0).reshape(-1, width)


class _Layers:
    """Reads per-layer tensors named ``fmt.format(i)`` and stacks them."""

    def __init__(self, sd, n: int, device):
        self.sd, self.n, self.device = sd, n, device

    def stack(self, fmt: str, transform=None) -> torch.Tensor:
        out = []
        for i in range(self.n):
            v = _f32(self.sd, fmt.format(i))
            out.append(transform(v) if transform else v)
        return _t(np.stack(out), self.device)

    def fused(self, fmt: str, names, transpose: bool) -> torch.Tensor:
        def one(i):
            parts = [_f32(self.sd, fmt.format(i) + n) for n in names]
            if transpose:
                return np.concatenate([_tr(p) for p in parts], axis=1)
            return np.concatenate(parts)

        return _t(np.stack([one(i) for i in range(self.n)]), self.device)


def convert_hf_clip_vision(sd: Dict[str, np.ndarray], cfg: ViTConfig, device="cuda"):
    """transformers CLIPVisionModel state dict (``vision_model.``-prefixed,
    numpy) -> the port's ViT params."""
    p = "vision_model."
    b = p + "encoder.layers.{}."
    ly = _Layers(sd, cfg.layers, device)
    qkv = ("self_attn.q_proj.", "self_attn.k_proj.", "self_attn.v_proj.")
    return {
        "patch_embed": {"weight": _t(_patch(_f32(sd, p + "embeddings.patch_embedding.weight"),
                                            cfg.width), device)},
        "cls_token": _t(_f32(sd, p + "embeddings.class_embedding").reshape(1, 1, cfg.width),
                        device),
        "pos_embed": _t(_f32(sd, p + "embeddings.position_embedding.weight"), device),
        "ln_pre": {"weight": _t(_f32(sd, p + "pre_layrnorm.weight"), device),
                   "bias": _t(_f32(sd, p + "pre_layrnorm.bias"), device)},
        "blocks": {
            "ln1": {"weight": ly.stack(b + "layer_norm1.weight"),
                    "bias": ly.stack(b + "layer_norm1.bias")},
            "ln2": {"weight": ly.stack(b + "layer_norm2.weight"),
                    "bias": ly.stack(b + "layer_norm2.bias")},
            "qkv": {"weight": ly.fused(b, [n + "weight" for n in qkv], True),
                    "bias": ly.fused(b, [n + "bias" for n in qkv], False)},
            "proj": {"weight": ly.stack(b + "self_attn.out_proj.weight", _tr),
                     "bias": ly.stack(b + "self_attn.out_proj.bias")},
            "fc1": {"weight": ly.stack(b + "mlp.fc1.weight", _tr),
                    "bias": ly.stack(b + "mlp.fc1.bias")},
            "fc2": {"weight": ly.stack(b + "mlp.fc2.weight", _tr),
                    "bias": ly.stack(b + "mlp.fc2.bias")},
        },
        "ln_post": {"weight": _t(_f32(sd, p + "post_layernorm.weight"), device),
                    "bias": _t(_f32(sd, p + "post_layernorm.bias"), device)},
    }


def convert_hf_dinov2(sd: Dict[str, np.ndarray], cfg: ViTConfig, device="cuda"):
    """transformers Dinov2Model state dict (facebook/dinov2-giant's layout:
    LayerScale, SwiGLU weights_in / weights_out, a patch bias, no pre-LN) ->
    the port's ViT params; ``cfg`` must be DINOv2-style."""
    if not (cfg.layerscale and cfg.ffn == "swiglu" and not cfg.ln_pre):
        raise ValueError("convert_hf_dinov2 needs a DINOv2-style ViTConfig (layerscale, "
                         "swiglu, no ln_pre)")
    b = "encoder.layer.{}."
    ly = _Layers(sd, cfg.layers, device)
    qkv = ("attention.attention.query.", "attention.attention.key.",
           "attention.attention.value.")
    return {
        "patch_embed": {
            "weight": _t(_patch(_f32(sd, "embeddings.patch_embeddings.projection.weight"),
                                cfg.width), device),
            "bias": _t(_f32(sd, "embeddings.patch_embeddings.projection.bias"), device)},
        "cls_token": _t(_f32(sd, "embeddings.cls_token"), device),
        "pos_embed": _t(_f32(sd, "embeddings.position_embeddings")[0], device),
        "blocks": {
            "ln1": {"weight": ly.stack(b + "norm1.weight"), "bias": ly.stack(b + "norm1.bias")},
            "ln2": {"weight": ly.stack(b + "norm2.weight"), "bias": ly.stack(b + "norm2.bias")},
            "qkv": {"weight": ly.fused(b, [n + "weight" for n in qkv], True),
                    "bias": ly.fused(b, [n + "bias" for n in qkv], False)},
            "proj": {"weight": ly.stack(b + "attention.output.dense.weight", _tr),
                     "bias": ly.stack(b + "attention.output.dense.bias")},
            "ls1": ly.stack(b + "layer_scale1.lambda1"),
            "ls2": ly.stack(b + "layer_scale2.lambda1"),
            # weights_in packs [gate; up] rows
            "fc1": {"weight": ly.stack(b + "mlp.weights_in.weight", _tr),
                    "bias": ly.stack(b + "mlp.weights_in.bias")},
            "fc2": {"weight": ly.stack(b + "mlp.weights_out.weight", _tr),
                    "bias": ly.stack(b + "mlp.weights_out.bias")},
        },
        "ln_post": {"weight": _t(_f32(sd, "layernorm.weight"), device),
                    "bias": _t(_f32(sd, "layernorm.bias"), device)},
    }


def load_hf_dinov2(model_name_or_dir: str, cfg: ViTConfig, device="cuda"):
    """A transformers Dinov2Model (a local directory) converted."""
    from transformers import Dinov2Model

    model = Dinov2Model.from_pretrained(model_name_or_dir)
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()}
    return convert_hf_dinov2(sd, cfg, device)


_TIMM_BLOCK = {"conv_dw.weight": "dwconv.weight", "conv_dw.bias": "dwconv.bias",
               "norm.weight": "layernorm.weight", "norm.bias": "layernorm.bias",
               "mlp.fc1.weight": "pwconv1.weight", "mlp.fc1.bias": "pwconv1.bias",
               "mlp.fc2.weight": "pwconv2.weight", "mlp.fc2.bias": "pwconv2.bias",
               "gamma": "layer_scale_parameter"}


def _timm_to_hf_convnext(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """open_clip / timm ConvNeXt names (``visual.trunk.`` or ``trunk.``
    prefixes accepted) -> transformers ConvNextModel names; keys of neither
    trunk are dropped."""
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("visual.trunk.").removeprefix("trunk.")
        nk = None
        if k.startswith("stem.0."):
            nk = "embeddings.patch_embeddings." + k[len("stem.0."):]
        elif k.startswith("stem.1."):
            nk = "embeddings.layernorm." + k[len("stem.1."):]
        elif k.startswith("stages."):
            parts = k.split(".")
            si, rest = parts[1], ".".join(parts[2:])
            for idx in ("0", "1"):
                if rest.startswith(f"downsample.{idx}."):
                    nk = (f"encoder.stages.{si}.downsampling_layer.{idx}."
                          + rest[len(f"downsample.{idx}."):])
            if rest.startswith("blocks."):
                bp = rest.split(".")
                tail = ".".join(bp[2:])
                if tail in _TIMM_BLOCK:
                    nk = f"encoder.stages.{si}.layers.{bp[1]}." + _TIMM_BLOCK[tail]
        if nk is not None:
            out[nk] = v
    return out


def convert_convnext(sd: Dict[str, np.ndarray], cfg: ConvNeXtConfig, device="cuda"):
    """transformers ConvNextModel state dict (or open_clip / timm names) ->
    the port's ConvNeXt params."""
    if not any(k.startswith("embeddings.") for k in sd):
        sd = _timm_to_hf_convnext(sd)
    stages = []
    for si, depth in enumerate(cfg.depths):
        if si == 0:
            down = {"conv": _t(_patch(_f32(sd, "embeddings.patch_embeddings.weight"),
                                      cfg.dims[0]), device),
                    "conv_bias": _t(_f32(sd, "embeddings.patch_embeddings.bias"), device),
                    "norm": {"weight": _t(_f32(sd, "embeddings.layernorm.weight"), device),
                             "bias": _t(_f32(sd, "embeddings.layernorm.bias"), device)}}
        else:
            d = f"encoder.stages.{si}.downsampling_layer."
            down = {"conv": _t(_patch(_f32(sd, d + "1.weight"), cfg.dims[si]), device),
                    "conv_bias": _t(_f32(sd, d + "1.bias"), device),
                    "norm": {"weight": _t(_f32(sd, d + "0.weight"), device),
                             "bias": _t(_f32(sd, d + "0.bias"), device)}}
        ly = _Layers(sd, depth, device)
        b = f"encoder.stages.{si}.layers.{{}}."
        blocks = {
            "dw": ly.stack(b + "dwconv.weight", lambda w: w.transpose(2, 3, 1, 0).reshape(49, -1)),
            "dw_bias": ly.stack(b + "dwconv.bias"),
            "norm": {"weight": ly.stack(b + "layernorm.weight"),
                     "bias": ly.stack(b + "layernorm.bias")},
            "pw1": {"weight": ly.stack(b + "pwconv1.weight", _tr),
                    "bias": ly.stack(b + "pwconv1.bias")},
            "pw2": {"weight": ly.stack(b + "pwconv2.weight", _tr),
                    "bias": ly.stack(b + "pwconv2.bias")},
            "gamma": ly.stack(b + "layer_scale_parameter"),
        }
        stages.append({"down": down, "blocks": blocks})
    return {"stages": stages}


def convert_hf_blip2_qformer(sd: Dict[str, np.ndarray], cfg: QFormerConfig, device="cuda"):
    """transformers Blip2QFormerModel state dict (cross-attention on every
    layer; the queries under ``query_tokens`` (1, n, w) or ``queries``) ->
    the port's Q-Former params."""
    b = "encoder.layer.{}."
    ly = _Layers(sd, cfg.layers, device)
    self_qkv = ("attention.attention.query.", "attention.attention.key.",
                "attention.attention.value.")
    cross_kv = ("crossattention.attention.key.", "crossattention.attention.value.")
    queries = _f32(sd, "query_tokens")[0] if "query_tokens" in sd else _f32(sd, "queries")

    def lin(name):
        return {"weight": ly.stack(b + name + ".weight", _tr), "bias": ly.stack(b + name + ".bias")}

    def ln(name):
        return {"weight": ly.stack(b + name + ".weight"), "bias": ly.stack(b + name + ".bias")}

    return {
        "queries": _t(queries, device),
        "ln_q_in": {"weight": _t(_f32(sd, "layernorm.weight"), device),
                    "bias": _t(_f32(sd, "layernorm.bias"), device)},
        "blocks": {
            "self_qkv": {"weight": ly.fused(b, [n + "weight" for n in self_qkv], True),
                         "bias": ly.fused(b, [n + "bias" for n in self_qkv], False)},
            "proj": lin("attention.output.dense"),
            "ln_self": ln("attention.output.LayerNorm"),
            "q": lin("crossattention.attention.query"),
            "kv": {"weight": ly.fused(b, [n + "weight" for n in cross_kv], True),
                   "bias": ly.fused(b, [n + "bias" for n in cross_kv], False)},
            "cproj": lin("crossattention.output.dense"),
            "ln_cross": ln("crossattention.output.LayerNorm"),
            "fc1": lin("intermediate_query.dense"),
            "fc2": lin("output_query.dense"),
            "ln_mlp": ln("output_query.LayerNorm"),
        },
    }


def load_hf_clip_vision(model_name_or_dir: str, cfg: ViTConfig, device="cuda"):
    """A transformers CLIPVisionModel (a local directory) converted."""
    from transformers import CLIPVisionModel

    model = CLIPVisionModel.from_pretrained(model_name_or_dir)
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()}
    sd = {(k if k.startswith("vision_model.") else "vision_model." + k): v for k, v in sd.items()}
    return convert_hf_clip_vision(sd, cfg, device)
