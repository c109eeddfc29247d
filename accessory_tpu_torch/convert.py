"""Carry weights written by the JAX package across to the port.

``params_from_jax`` takes the JAX params tree as plain numpy: a quantized
leaf is a dict with the fields the native checkpoint stores for it
(``packed``, ``scales``, ``zeros``, ``bits``, ``group_size``, ``in_dim``,
``out_dim``, ``layout``, ``tile_k``; accessory_tpu/checkpoint/native.py), a
dense leaf is an array (bf16 arrays may come as numpy's bfloat16 extension
dtype or any dtype torch reads). It accepts stacked (L, ...) or per-layer
``layers``, fused (wqkv / w13) or separate projections, the ``std`` and
``planes`` W4 layouts, and scale rows padded past in_dim // group_size.
Every quantized leaf comes out in the port's folded layout.

``cache_from_jax`` does the same for a KV cache: the JAX package's lane-major
pools become the port's token-major ones.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.models.llama import torch_dtype
from accessory_tpu_torch.quant.qtensor import QuantizedWeight, pack_int

_QFIELDS = ("packed", "scales", "zeros")


def unpack_tile_words(words, in_dim: int, tk: int) -> np.ndarray:
    """Planes word order (the JAX package's TPU kernel layout, k-tiles of
    size tk) -> nibble rows (in_dim, N) uint8. Own copy of
    accessory_tpu/ops/quant_matmul_planes.py::unpack_tile_words."""
    k, n = in_dim, words.shape[-1]
    w = np.asarray(words).reshape(k // tk, tk // 8, n)
    q = np.empty((k // tk, tk, n), np.uint8)
    half = tk // 2
    for b in range(4):
        byte = (w >> np.uint32(8 * b)).astype(np.uint32)
        q[:, b:half:4] = (byte & 0xF).astype(np.uint8)
        q[:, half + b::4] = ((byte >> 4) & 0xF).astype(np.uint8)
    return q.reshape(k, n)


def _tensor(arr, device) -> torch.Tensor:
    a = np.array(arr)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # numpy extension dtype: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    elif a.dtype == np.uint32:
        t = torch.from_numpy(a.view(np.int32))
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _quantized(leaf: Dict[str, Any], act_dtype: torch.dtype, device) -> QuantizedWeight:
    bits, gs = int(leaf["bits"]), int(leaf["group_size"])
    in_dim, out_dim = int(leaf["in_dim"]), int(leaf["out_dim"])
    layout = leaf.get("layout", "std")
    if bits != 4:
        raise NotImplementedError(f"W{bits} weights: only W4 is ported (ROADMAP A1/B10)")
    rows = in_dim // gs
    scales = np.asarray(leaf["scales"]).astype(np.float32)[:rows]
    zeros = np.asarray(leaf["zeros"]).astype(np.float32)[:rows]
    if layout == "std":
        packed = _tensor(np.asarray(leaf["packed"]).astype(np.uint32), device)
        zs = zeros * scales
    elif layout == "planes":
        # planes words re-emitted in std order; zeros already hold zs
        q = unpack_tile_words(leaf["packed"], in_dim, int(leaf["tile_k"]))
        packed = pack_int(torch.from_numpy(q.astype(np.int32)), 4).to(device)
        zs = zeros
    else:
        raise NotImplementedError(f"W4 layout {layout!r}: the port reads std and planes")
    return QuantizedWeight(packed=packed,
                           scales=_tensor(scales, device), zeros=_tensor(zs, device),
                           bits=4, group_size=gs, in_dim=in_dim, out_dim=out_dim,
                           act_dtype=act_dtype, layout="folded")


def _is_quantized(node) -> bool:
    return isinstance(node, dict) and all(f in node for f in _QFIELDS) and "bits" in node


def _convert(node, act_dtype, device):
    if _is_quantized(node):
        return _quantized(node, act_dtype, device)
    if isinstance(node, dict):
        return {k: _convert(v, act_dtype, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, act_dtype, device) for v in node]
    return _tensor(node, device)


def _layer_slice(node, i: int):
    """Layer i of a stacked subtree (quantized leaves: index their arrays)."""
    if _is_quantized(node):
        return {k: (np.asarray(v)[i] if k in _QFIELDS else v) for k, v in node.items()}
    if isinstance(node, dict):
        return {k: _layer_slice(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def params_from_jax(tree: Dict[str, Any], args: LLaMAArgs, device="cuda") -> Dict[str, Any]:
    """JAX LLaMA params (numpy leaves, see module docstring) -> the port's
    per-layer params on ``device``."""
    act_dtype = torch_dtype(args.dtype)
    layers = tree["layers"]
    if isinstance(layers, dict):
        layers = [_layer_slice(layers, i) for i in range(args.n_layers)]
    if len(layers) != args.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, args say {args.n_layers}")
    out = {k: _convert(v, act_dtype, device) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_convert(layer, act_dtype, device) for layer in layers]
    return out


def cache_from_jax(cache_np: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """A JAX per-layer KV cache as numpy -> the port's layout on ``device``.

    ``k`` / ``v``: one (B, NKV, HD, S) array per layer (bf16, f32 or int8; a
    list, or one array stacked on a leading layer axis) become (B, NKV, S, HD)
    contiguous; the int8 cache's ``ks`` / ``vs`` (B, NKV, S) f32 scale pools
    keep their layout."""
    out = {key: [_tensor(np.asarray(a), device).transpose(2, 3).contiguous()
                 for a in cache_np[key]] for key in ("k", "v")}
    for key in ("ks", "vs"):
        if key in cache_np:
            out[key] = [_tensor(np.asarray(a), device).contiguous() for a in cache_np[key]]
    return out
