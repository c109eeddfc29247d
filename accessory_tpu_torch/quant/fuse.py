"""Decode-time weight fusion: wq|wk|wv -> wqkv and w1|w3 -> w13.

Port of ``accessory_tpu/quant/fuse.py::fuse_for_decode``: every layout packs
along K (std and folded words, w8's int8 rows, magic's per-tile words), so
fusion is a concatenation along the output axis (packed, scales and zeros
alike) of weights that agree on bits, group, in_dim, layout and tile. Two launches per layer replace five, and the fused wqkv
carries the decode-RoPE epilogue. The TPU re-tiling (retile_for_decode) and
kernel_prep's scale-row padding do not carry over; kernel_prep's other half,
norm weights stored as f32 for the fused-norm kernel operand, does (math
unchanged: rms_norm computes in f32 anyway).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from accessory_tpu_torch.quant.qtensor import QuantizedWeight

_NORM_KEYS = ("attention_norm", "ffn_norm", "norm")


def _concat_weights(mods):
    """Concatenate module weights on the output axis, or None where the
    representations differ."""
    ws = [m["weight"] for m in mods]
    if all(isinstance(w, QuantizedWeight) for w in ws):
        w0 = ws[0]
        key = lambda w: (w.bits, w.group_size, w.in_dim, w.layout, w.tile_k,  # noqa: E731
                         w.scales.shape[0])
        if any(key(w) != key(w0) for w in ws[1:]):
            return None
        return QuantizedWeight(
            packed=torch.cat([w.packed for w in ws], dim=-1),
            scales=torch.cat([w.scales for w in ws], dim=-1),
            zeros=torch.cat([w.zeros for w in ws], dim=-1),
            bits=w0.bits, group_size=w0.group_size, in_dim=w0.in_dim,
            out_dim=sum(w.out_dim for w in ws), act_dtype=w0.act_dtype,
            layout=w0.layout, tile_k=w0.tile_k)
    if any(isinstance(w, QuantizedWeight) for w in ws):
        return None
    if len({tuple(w.shape[:-1]) for w in ws}) != 1:
        return None
    return torch.cat(ws, dim=-1)


def _fusible(mods) -> bool:
    # LoRA / bias modules keep their own per-projection adapters
    return all(set(m.keys()) == {"weight"} for m in mods)


def _fuse_layer(layer: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(layer)
    att = dict(layer["attention"])
    if all(k in att for k in ("wq", "wk", "wv")) and _fusible([att["wq"], att["wk"], att["wv"]]):
        fused = _concat_weights([att["wq"], att["wk"], att["wv"]])
        if fused is not None:
            att["wqkv"] = {"weight": fused}
            del att["wq"], att["wk"], att["wv"]
    out["attention"] = att
    ff = layer.get("feed_forward")
    if isinstance(ff, dict) and all(k in ff for k in ("w1", "w3")) and _fusible([ff["w1"], ff["w3"]]):
        fused = _concat_weights([ff["w1"], ff["w3"]])
        if fused is not None:
            ff = dict(ff)
            ff["w13"] = {"weight": fused}
            del ff["w1"], ff["w3"]
            out["feed_forward"] = ff
    return _f32_norms(out)


def _f32_norms(node: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(node)
    for k in _NORM_KEYS:
        if isinstance(out.get(k), dict) and "weight" in out[k]:
            out[k] = dict(out[k], weight=out[k]["weight"].to(torch.float32))
    return out


def fuse_for_decode(params: Dict[str, Any]) -> Dict[str, Any]:
    """Return a params tree with per-layer wqkv / w13 fused weights and f32
    norm weights. Layers that cannot fuse (adapters, mixed representations)
    keep their separate weights, and ``models.llama.forward`` refuses them."""
    layers = params.get("layers")
    if not isinstance(layers, (list, tuple)):
        raise ValueError("fuse_for_decode expects per-layer params (a list of layer dicts)")
    out = _f32_norms(params)
    out["layers"] = [_fuse_layer(layer) for layer in layers]
    return out
