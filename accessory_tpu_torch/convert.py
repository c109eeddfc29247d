"""Carry weights written by the JAX package across to the port.

``params_from_jax`` takes the JAX params tree as plain numpy: a quantized
leaf is a dict with the fields the native checkpoint stores for it
(``packed``, ``scales``, ``zeros``, ``bits``, ``group_size``, ``in_dim``,
``out_dim``, ``layout``, ``tile_k``; accessory_tpu/checkpoint/native.py), a
dense leaf is an array (bf16 arrays may come as numpy's bfloat16 extension
dtype or any dtype torch reads). It accepts stacked (L, ...) or per-layer
``layers``, fused (wqkv / w13) or separate projections, W3, W4 and W8
leaves in the ``std``, ``planes``, ``w8`` and ``magic`` layouts, and scale
rows padded past in_dim // group_size. A MoE layer's experts come as one
dense (L, E, in, out) leaf, which stays a dense (E, in, out) tensor a layer,
or as one quantized leaf stacked over the experts (packed (L, E, K/8, N)),
which becomes a tuple of E QuantizedWeights a layer (a list of per-expert
leaves stays a list). A leaf comes out in the port's layout for it: W4 std
and planes folded, W8 std and w8 as w8, W3 std as std, magic
as magic; a record the port wrote names its own (``serve_layout``, which
the JAX package does not read), so a std W4 weight (a GPTQ import) comes
back std. The native checkpoint reader (``checkpoint/native.py``) hands its
tensors over through the same function: its bf16 leaves come as
``BF16Bits`` (raw bits, the checkpoint's ``@bf16`` form), each leaf is read
from the file only as it is converted, and ``cast`` gives dense floating
leaves another dtype on the way. ``params_to_jax`` is the way back: the
port's per-layer tree as the stacked numpy tree the JAX package stores,
folded leaves in its ``planes`` layout, the others in their own, and a
layer's per-expert weights as one leaf stacked over the experts. A list
outside ``layers`` (SPHINX's ConvNeXt stages) stays a list; a dict whose
keys are all indices (the native checkpoint's form of such a list) becomes
one again.

``cache_from_jax`` does the same for a KV cache: the JAX package's lane-major
pools become the port's token-major ones; ``paged_cache_from_jax`` for a paged
cache: its fold-stored pages and 128-lane scale rows become the port's
token-major pages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from accessory_tpu_torch.config import n_layers_of
from accessory_tpu_torch.models.llama import torch_dtype
from accessory_tpu_torch.quant.qtensor import (QuantizedWeight, pack_int, to_folded_layout,
                                               to_w8_layout, unpack_int)

_QFIELDS = ("packed", "scales", "zeros")
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.float16: "float16"}


@dataclasses.dataclass
class BF16Bits:
    """bf16 values held as their raw bits (uint16): numpy has no bf16 dtype of
    its own, and the native checkpoint stores bf16 leaves this way."""

    bits: np.ndarray

    @property
    def shape(self):
        return self.bits.shape

    def __getitem__(self, idx) -> "BF16Bits":
        return BF16Bits(self.bits[idx])


def choose_tile_k(in_dim: int, group_size: int, max_tk: int = 2048) -> int:
    """The planes layout's k-tile for a weight: the largest tk <= max_tk that
    divides in_dim with (tk / 2) % group_size == 0. Own copy of
    accessory_tpu/ops/quant_matmul_planes.py::choose_tile_k (per-leaf form)."""
    tk = 2 * group_size
    while in_dim % (2 * tk) == 0 and 2 * tk <= max_tk:
        tk *= 2
    if in_dim % tk:
        raise ValueError(f"in_dim {in_dim} has no planes k-tile at group_size {group_size}")
    return tk


def pack_tile_words(q: np.ndarray, tk: int) -> np.ndarray:
    """Nibble rows (K, N) -> planes word order (K/8, N) uint32 for k-tiles of
    size tk, the inverse of unpack_tile_words. Own copy of
    accessory_tpu/ops/quant_matmul_planes.py::pack_tile_words."""
    k, n = q.shape
    q = q.astype(np.uint32).reshape(k // tk, 2, tk // 2, n)
    lo = q[:, 0].reshape(-1, tk // 8, 4, n)
    hi = q[:, 1].reshape(-1, tk // 8, 4, n)
    shifts = (np.arange(4, dtype=np.uint32) * 8)[None, None, :, None]
    words = np.bitwise_or.reduce(lo << shifts, axis=2) \
        | np.bitwise_or.reduce(hi << (shifts + 4), axis=2)
    return words.reshape(k // 8, n)


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


def _tensor(arr, device, cast: Optional[torch.dtype] = None) -> torch.Tensor:
    bf16 = isinstance(arr, BF16Bits)
    a = np.array(arr.bits if bf16 else arr)  # a writable, contiguous copy
    if bf16 or a.dtype.name == "bfloat16":  # raw bits / numpy's extension dtype
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype == np.uint32:
        t = torch.from_numpy(a.view(np.int32))
    else:
        t = torch.from_numpy(a)
    if cast is not None and t.is_floating_point():
        t = t.to(cast)
    return t.to(device)


def _f32(arr) -> np.ndarray:
    """Scales / zeros as f32 (the JAX package may store them as bf16)."""
    if isinstance(arr, BF16Bits):
        return (np.asarray(arr.bits).astype(np.uint32) << np.uint32(16)).view(np.float32)
    return np.asarray(arr).astype(np.float32)


# the layout a leaf the JAX package wrote takes in the port, by (bits, layout)
_PORT_LAYOUT = {(4, "std"): "folded", (4, "planes"): "folded", (4, "magic"): "magic",
                (8, "std"): "w8", (8, "w8"): "w8", (3, "std"): "std"}


def _quantized(leaf: Dict[str, Any], act_dtype: torch.dtype, device) -> QuantizedWeight:
    bits, gs = int(leaf["bits"]), int(leaf["group_size"])
    in_dim, out_dim = int(leaf["in_dim"]), int(leaf["out_dim"])
    layout = leaf.get("layout", "std")
    if (bits, layout) not in _PORT_LAYOUT:
        raise ValueError(f"W{bits} weights in the {layout!r} layout: the formats are "
                         f"{sorted(_PORT_LAYOUT)}")
    target = leaf.get("serve_layout") or _PORT_LAYOUT[bits, layout]
    rows = in_dim // gs
    scales, zeros = _f32(leaf["scales"])[:rows], _f32(leaf["zeros"])[:rows]
    if leaf.get("act_dtype") is not None:  # the checkpoint's own record wins
        act_dtype = torch_dtype(leaf["act_dtype"])
    if layout == "planes":
        # planes words re-emitted in std order; zeros already hold zs
        q = unpack_tile_words(leaf["packed"], in_dim, int(leaf["tile_k"]))
        packed = pack_int(torch.from_numpy(q.astype(np.int32)), 4).to(device)
        layout = "folded"
    elif layout == "w8":
        packed = _tensor(np.asarray(leaf["packed"]).astype(np.int8), device)
    else:
        packed = _tensor(np.asarray(leaf["packed"]).astype(np.uint32), device)
    qw = QuantizedWeight(packed=packed, scales=_tensor(scales, device),
                         zeros=_tensor(zeros, device), bits=bits, group_size=gs, in_dim=in_dim,
                         out_dim=out_dim, act_dtype=act_dtype, layout=layout,
                         tile_k=int(leaf.get("tile_k", 0)) if layout in ("w8", "magic") else 0)
    if qw.layout == target:
        return qw
    if (qw.layout, target) == ("std", "folded"):
        return to_folded_layout(qw)
    if (qw.layout, target) == ("std", "w8"):
        return to_w8_layout(qw)
    raise ValueError(f"a {qw.layout!r} W{bits} leaf cannot be served as {target!r}")


def _is_quantized(node) -> bool:
    return isinstance(node, dict) and all(f in node for f in _QFIELDS) and "bits" in node


def _convert(node, act_dtype, device, cast=None):
    if _is_quantized(node) and np.ndim(node["packed"]) == 3:
        # a MoE layer's experts stacked (E, K/8, N): a tuple of per-expert weights
        n_experts = np.shape(node["packed"])[0]
        return tuple(_quantized(_layer_slice(node, e), act_dtype, device)
                     for e in range(n_experts))
    if _is_quantized(node):
        return _quantized(node, act_dtype, device)
    if isinstance(node, dict) and node and all(k.isdigit() for k in node):
        # a list the checkpoint stored under index keys (ConvNeXt's stages)
        node = [node[k] for k in sorted(node, key=int)]
    if isinstance(node, dict):
        return {k: _convert(v, act_dtype, device, cast) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, act_dtype, device, cast) for v in node]
    return _tensor(node, device, cast)


def _layer_slice(node, i: int):
    """Layer i of a stacked subtree (quantized leaves: index their arrays)."""
    if _is_quantized(node):
        return {k: (_layer_slice(v, i) if k in _QFIELDS else v) for k, v in node.items()}
    if isinstance(node, dict):
        return {k: _layer_slice(v, i) for k, v in node.items()}
    if isinstance(node, BF16Bits):  # bf16 leaves, and scales / zeros stored as bf16
        return node[i]
    return np.asarray(node)[i]


def params_from_jax(tree: Dict[str, Any], args, device="cuda",
                    cast: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """JAX params of any ported family (numpy leaves, see module docstring)
    -> the port's per-layer params on ``device``, one leaf at a time.
    ``cast``: the dtype dense floating leaves are given (quantized leaves
    keep theirs, and so does the ``visual`` subtree of the multimodal
    families: its towers run in f32 and cross over bit for bit, stacked
    blocks and ConvNeXt's list of stages as they are)."""
    act_dtype = torch_dtype(args.dtype)
    layers = tree["layers"]
    n_layers = n_layers_of(args)
    if isinstance(layers, dict):
        layers = [_layer_slice(layers, i) for i in range(n_layers)]
    if len(layers) != n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, args say {n_layers}")
    out = {k: _convert(v, act_dtype, device, None if k == "visual" else cast)
           for k, v in tree.items() if k != "layers"}
    out["layers"] = [_convert(layer, act_dtype, device, cast) for layer in layers]
    return out


def _np(t: torch.Tensor):
    """A tensor as numpy on the host; bf16 as BF16Bits, packed words as uint32."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return BF16Bits(t.view(torch.int16).numpy().view(np.uint16))
    if t.dtype == torch.int32:
        return t.numpy().view(np.uint32)
    return t.numpy()


def _quantized_to_jax(qw: QuantizedWeight) -> Dict[str, Any]:
    """A quantized weight as the JAX package stores it, with the port's
    ``serve_layout``. The std, w8 and magic layouts are the JAX package's own
    (a w8 leaf with the K tile ``choose_tile_k_w8`` gives, which its kernel
    takes). The port's folded layout (std nibble order, zeros = zeros *
    scales) is none of its layouts, so it goes out as ``planes`` (the same
    folded zeros, words re-ordered by pack_tile_words: exact) or, where in_dim
    admits no planes k-tile, as ``std`` with the zeros recovered by rounding
    zs / scales."""
    leaf = {"bits": qw.bits, "group_size": qw.group_size, "in_dim": qw.in_dim,
            "out_dim": qw.out_dim, "act_dtype": _DTYPE_NAMES[qw.act_dtype],
            "layout": qw.layout, "tile_k": qw.tile_k, "serve_layout": qw.layout,
            "packed": _np(qw.packed), "scales": _np(qw.scales.to(torch.float32)),
            "zeros": _np(qw.zeros.to(torch.float32))}
    if qw.layout == "w8":
        from accessory_tpu_torch.ops.quant_matmul_w8 import choose_tile_k_w8

        return dict(leaf, tile_k=choose_tile_k_w8(qw.in_dim, qw.group_size))
    if qw.layout != "folded":
        return leaf
    if qw.in_dim % (2 * qw.group_size) == 0:
        tk = choose_tile_k(qw.in_dim, qw.group_size)
        q = unpack_int(qw.packed.cpu(), 4, qw.in_dim).numpy()
        return dict(leaf, layout="planes", tile_k=tk, packed=pack_tile_words(q, tk))
    zeros = torch.round(qw.zeros.to(torch.float32) / qw.scales.to(torch.float32))
    return dict(leaf, layout="std", zeros=_np(zeros))


def _experts(node) -> bool:
    return (isinstance(node, (list, tuple)) and len(node) > 0
            and all(isinstance(w, QuantizedWeight) for w in node))


def _to_jax(node):
    if isinstance(node, QuantizedWeight):
        return _quantized_to_jax(node)
    if _experts(node):      # per-expert weights go out stacked on a leading expert axis
        return _stack([_quantized_to_jax(w) for w in node])
    if isinstance(node, dict):
        return {k: _to_jax(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_jax(v) for v in node]
    return _np(node)


def _stack(nodes):
    """Per-layer subtrees -> one subtree whose arrays carry a leading L axis."""
    first = nodes[0]
    if _is_quantized(first):
        meta = {k: v for k, v in first.items() if k not in _QFIELDS}
        if any({k: v for k, v in n.items() if k not in _QFIELDS} != meta for n in nodes[1:]):
            raise ValueError("layers disagree on a quantized weight's format; cannot stack them")
        return dict(meta, **{f: _stack([n[f] for n in nodes]) for f in _QFIELDS})
    if isinstance(first, dict):
        return {k: _stack([n[k] for n in nodes]) for k in first}
    if isinstance(first, BF16Bits):
        return BF16Bits(np.stack([n.bits for n in nodes]))
    return np.stack(nodes)


def params_to_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's per-layer params -> the JAX package's stacked tree on the
    host: numpy leaves (bf16 as BF16Bits), ``layers`` stacked on a leading
    axis, quantized leaves as the dicts ``params_from_jax`` reads."""
    out = {k: _to_jax(v) for k, v in params.items() if k != "layers"}
    out["layers"] = _stack([_to_jax(layer) for layer in params["layers"]])
    return out


def cache_from_jax(cache_np: Dict[str, Any], device="cuda", stacked: bool = False
                   ) -> Dict[str, Any]:
    """A JAX KV cache as numpy -> the port's layout on ``device``.

    ``k`` / ``v``: one (B, NKV, HD, S) array per layer (bf16, f32 or int8; a
    list, or one array stacked on a leading layer axis) become (B, NKV, S, HD)
    contiguous; the int8 cache's ``ks`` / ``vs`` (B, NKV, S) f32 scale pools
    keep their layout. The result is a list of per-layer pools, or with
    ``stacked`` one (L, ...) tensor per pool (the port's stacked cache)."""
    out = {key: [_tensor(np.asarray(a), device).transpose(2, 3).contiguous()
                 for a in cache_np[key]] for key in ("k", "v")}
    for key in ("ks", "vs"):
        if key in cache_np:
            out[key] = [_tensor(np.asarray(a), device).contiguous() for a in cache_np[key]]
    if stacked:
        out = {key: torch.stack(pools) for key, pools in out.items()}
    return out


def paged_cache_from_jax(pcache_np: Dict[str, Any], device="cuda"):
    """A JAX ``PagedKVCache`` as numpy -> the port's ``engine.kvcache.
    PagedKVCache`` on ``device``.

    ``pcache_np`` holds the dataclass's fields: ``k_pages`` / ``v_pages``
    (L, NKV, P, psk, fold * hd) fold-stored (token t of a page at row t % psk,
    lanes (t // psk) * hd ...), ``page_indices``, ``lengths``, ``head_dim``,
    and for int8 pools ``ks_pages`` / ``vs_pages`` (L, NKV, P, srows, 128), the
    scale of token t at (t // 128, t % 128). The pools come out token-major
    (L, NKV, P, page_size, hd), the scale pools (L, NKV, P, page_size)."""
    from accessory_tpu_torch.engine.kvcache import PagedKVCache

    n_layers, nkv, n_pages, psk, minor = np.asarray(pcache_np["k_pages"]).shape
    hd = int(pcache_np.get("head_dim") or minor)
    fold = minor // hd
    ps = psk * fold

    def unfold(a):
        t = _tensor(np.asarray(a), device).reshape(n_layers, nkv, n_pages, psk, fold, hd)
        return t.transpose(3, 4).reshape(n_layers, nkv, n_pages, ps, hd).contiguous()

    def scales(a):
        if a is None:
            return None
        t = _tensor(np.asarray(a), device)
        return t.reshape(n_layers, nkv, n_pages, -1)[..., :ps].contiguous()

    return PagedKVCache(
        k_pages=unfold(pcache_np["k_pages"]), v_pages=unfold(pcache_np["v_pages"]),
        page_indices=_tensor(np.asarray(pcache_np["page_indices"]).astype(np.int32), device),
        lengths=_tensor(np.asarray(pcache_np["lengths"]).astype(np.int32), device),
        ks_pages=scales(pcache_np.get("ks_pages")), vs_pages=scales(pcache_np.get("vs_pages")))
