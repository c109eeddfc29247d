"""Carry weights written by the JAX package across to the port.

``params_from_jax`` takes the JAX params tree as plain numpy: a quantized
leaf is a dict with the fields the native checkpoint stores for it
(``packed``, ``scales``, ``zeros``, ``bits``, ``group_size``, ``in_dim``,
``out_dim``, ``layout``, ``tile_k``; accessory_tpu/checkpoint/native.py), a
dense leaf is an array (bf16 arrays may come as numpy's bfloat16 extension
dtype or any dtype torch reads). It accepts stacked (L, ...) or per-layer
``layers``, fused (wqkv / w13) or separate projections, the ``std`` and
``planes`` W4 layouts, and scale rows padded past in_dim // group_size.
Every quantized leaf comes out in the port's folded layout. The native
checkpoint reader (``checkpoint/native.py``) hands its tensors over through
the same function: its bf16 leaves come as ``BF16Bits`` (raw bits, the
checkpoint's ``@bf16`` form), each leaf is read from the file only as it is
converted, and ``cast`` gives dense floating leaves another dtype on the way.
``params_to_jax`` is the way back: the port's per-layer tree as the stacked
numpy tree the JAX package stores, quantized leaves in its ``planes`` layout.

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

from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.models.llama import torch_dtype
from accessory_tpu_torch.quant.qtensor import QuantizedWeight, pack_int

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


def _quantized(leaf: Dict[str, Any], act_dtype: torch.dtype, device) -> QuantizedWeight:
    bits, gs = int(leaf["bits"]), int(leaf["group_size"])
    in_dim, out_dim = int(leaf["in_dim"]), int(leaf["out_dim"])
    layout = leaf.get("layout", "std")
    if bits != 4:
        raise NotImplementedError(f"W{bits} weights: only W4 is ported (ROADMAP A1/B10)")
    rows = in_dim // gs
    scales, zeros = _f32(leaf["scales"])[:rows], _f32(leaf["zeros"])[:rows]
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
    if leaf.get("act_dtype") is not None:  # the checkpoint's own record wins
        act_dtype = torch_dtype(leaf["act_dtype"])
    return QuantizedWeight(packed=packed,
                           scales=_tensor(scales, device), zeros=_tensor(zs, device),
                           bits=4, group_size=gs, in_dim=in_dim, out_dim=out_dim,
                           act_dtype=act_dtype, layout="folded")


def _is_quantized(node) -> bool:
    return isinstance(node, dict) and all(f in node for f in _QFIELDS) and "bits" in node


def _convert(node, act_dtype, device, cast=None):
    if _is_quantized(node):
        return _quantized(node, act_dtype, device)
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


def params_from_jax(tree: Dict[str, Any], args: LLaMAArgs, device="cuda",
                    cast: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """JAX LLaMA params (numpy leaves, see module docstring) -> the port's
    per-layer params on ``device``, one leaf at a time. ``cast``: the dtype
    dense floating leaves are given (quantized leaves keep theirs)."""
    act_dtype = torch_dtype(args.dtype)
    layers = tree["layers"]
    if isinstance(layers, dict):
        layers = [_layer_slice(layers, i) for i in range(args.n_layers)]
    if len(layers) != args.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, args say {args.n_layers}")
    out = {k: _convert(v, act_dtype, device, cast) for k, v in tree.items() if k != "layers"}
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
    """A W4 weight as the JAX package stores it. The port's folded layout
    (std nibble order, zeros = zeros * scales) is none of its layouts, so it
    goes out as ``planes`` (the same folded zeros, words re-ordered by
    pack_tile_words: exact) or, where in_dim admits no planes k-tile, as
    ``std`` with the zeros recovered by rounding zs / scales."""
    if qw.bits != 4:
        raise NotImplementedError(f"W{qw.bits} weights: only W4 is ported (ROADMAP A1/B10)")
    leaf = {"bits": 4, "group_size": qw.group_size, "in_dim": qw.in_dim, "out_dim": qw.out_dim,
            "act_dtype": _DTYPE_NAMES[qw.act_dtype], "layout": "std", "tile_k": 0,
            "packed": _np(qw.packed), "scales": _np(qw.scales.to(torch.float32)),
            "zeros": _np(qw.zeros.to(torch.float32))}
    if qw.layout == "std":
        return leaf
    if qw.in_dim % (2 * qw.group_size) == 0:
        from accessory_tpu_torch.quant.qtensor import unpack_int

        tk = choose_tile_k(qw.in_dim, qw.group_size)
        q = unpack_int(qw.packed.cpu(), 4, qw.in_dim).numpy()
        return dict(leaf, layout="planes", tile_k=tk, packed=pack_tile_words(q, tk))
    zeros = torch.round(qw.zeros.to(torch.float32) / qw.scales.to(torch.float32))
    return dict(leaf, zeros=_np(zeros))


def _to_jax(node):
    if isinstance(node, QuantizedWeight):
        return _quantized_to_jax(node)
    if isinstance(node, dict):
        return {k: _to_jax(v) for k, v in node.items()}
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
