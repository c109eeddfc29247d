"""Native checkpoint format: flat safetensors + quant sidecar.

Port of ``accessory_tpu/checkpoint/native.py``; a directory written by either
package is read by the other. Layout of a checkpoint dir:

  weights.safetensors  every leaf under its "/"-joined path, ``layers`` leaves
                       stacked on a leading layer axis; a quantized leaf
                       expands to <path>#packed / #scales / #zeros; a bf16
                       leaf is stored as its raw bits (uint16) under
                       <path>@bf16
  quant.json           {path: {bits, group_size, in_dim, out_dim, act_dtype,
                       layout, tile_k[, serve_layout]}} (serve_layout: the
                       port's own record of the layout it serves the leaf in;
                       the JAX package does not read it)
  (plus config.json / meta.json / tokenizer files written by MetaModel)

The safetensors container is read and written here with numpy alone (an
8-byte little-endian header length, a JSON header giving each tensor's
``dtype``, ``shape`` and ``data_offsets``, then the byte buffer), so loading
needs no library beyond numpy; the file is memory-mapped and a tensor's bytes
are read only as it is converted and sent to the device.

On the way in, a flat dict becomes the JAX package's nested tree (quantized
leaves as dicts of their fields) and goes through ``convert.params_from_jax``:
W3, W4 and W8 leaves in the ``std``, ``planes``, ``w8`` and ``magic``
layouts, stacked layers and padded scale rows come out as the port's
per-layer params in its layouts; a MoE layer's quantized experts, stored
stacked (L, E, ...) under one path, come out as a tuple of per-expert
weights a layer. On the way out ``convert.params_to_jax`` stacks the layers
(and each layer's experts) and emits folded W4 leaves in the ``planes``
layout and the others in their own, which the JAX package loads as they
stand.

Sequential multi-path loading (``load_checkpoint_list``) has the JAX
package's override/add semantics. A directory of PyTorch ``consolidated.*``
files (the format of the project this system was modelled on) is imported
by ``checkpoint.torch_import`` into the same flat dict; a ``*-diff``
directory adds its deltas to the leaves loaded before it (in f32, the sum
stored in the earlier leaf's dtype).
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from accessory_tpu_torch.convert import (_QFIELDS, BF16Bits, _f32, _is_quantized,
                                         params_from_jax, params_to_jax)
from accessory_tpu_torch.models.llama import torch_dtype

WEIGHTS_FILE = "weights.safetensors"
QUANT_FILE = "quant.json"
_BF16 = "@bf16"
_QMETA = ("bits", "group_size", "in_dim", "out_dim", "act_dtype", "layout", "tile_k",
          "serve_layout")

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
              "I32": np.int32, "I16": np.int16, "I8": np.int8, "U64": np.uint64,
              "U32": np.uint32, "U16": np.uint16, "U8": np.uint8, "BOOL": np.bool_}
_NP_DTYPES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


# ---------------------------------------------------------------- the container


def write_safetensors(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write {name: array} as one safetensors file (little-endian, C order)."""
    header: Dict[str, Any] = {}
    offset = 0
    arrays = []
    for name in sorted(tensors):
        arr = np.asarray(tensors[name], order="C")   # (ascontiguousarray would make 0-d 1-d)
        if arr.dtype not in _NP_DTYPES:
            raise TypeError(f"{name}: dtype {arr.dtype} has no safetensors name")
        header[name] = {"dtype": _NP_DTYPES[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
        arrays.append(arr)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for arr in arrays:
            f.write(arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes())


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of a safetensors file. The arrays are read-only views of
    one memory map, so nothing is read until an array is used. A ``BF16``
    tensor comes back as its raw bits (uint16)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        if hlen > size - 8:
            raise ValueError(f"{path}: header length {hlen} exceeds the file")
        header = json.loads(f.read(hlen))
    header.pop("__metadata__", None)
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + hlen) if size > 8 + hlen \
        else np.zeros(0, np.uint8)
    out = {}
    for name, info in header.items():
        dtype = np.uint16 if info["dtype"] == "BF16" else _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise TypeError(f"{path}: {name} has unsupported dtype {info['dtype']}")
        lo, hi = info["data_offsets"]
        dt = np.dtype(dtype).newbyteorder("<")
        out[name] = data[lo:hi].view(dt).reshape(info["shape"])
    return out


# ---------------------------------------------------------------- flat <-> tree


def flatten_params(params) -> Dict[str, Any]:
    """The port's params -> {path: array} as the checkpoint stores them:
    layers stacked, a quantized leaf as #packed / #scales / #zeros children
    plus a #meta entry (its quant.json record); bf16 leaves as BF16Bits; a
    list outside ``layers`` (ConvNeXt's stages) under index keys
    (``visual/convnext/stages/0/...``)."""
    flat: Dict[str, Any] = {}

    def visit(node, prefix):
        if _is_quantized(node):
            base = prefix[:-1]
            for field in _QFIELDS:
                flat[f"{base}#{field}"] = node[field]
            flat[base + "#meta"] = {k: node[k] for k in _QMETA if k in node}
        elif isinstance(node, dict):
            for k, v in node.items():
                visit(v, prefix + k + "/")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                visit(v, f"{prefix}{i}/")
        else:
            flat[prefix[:-1]] = node

    visit(params_to_jax(params), "")
    return flat


def save_checkpoint(save_dir: str, params,
                    filter: Optional[Callable[[str], bool]] = None) -> None:
    """Write weights.safetensors (+ quant.json). ``filter(path)`` selects the
    subset to save (trainable-only saves)."""
    os.makedirs(save_dir, exist_ok=True)
    quant_meta: Dict[str, Any] = {}
    tensors: Dict[str, np.ndarray] = {}
    for key, val in flatten_params(params).items():
        base = key.split("#")[0]
        if filter is not None and not filter(base):
            continue
        if key.endswith("#meta"):
            quant_meta[base] = val
        elif isinstance(val, BF16Bits):
            tensors[key + _BF16] = val.bits
        else:
            tensors[key] = val
    write_safetensors(str(Path(save_dir) / WEIGHTS_FILE), tensors)
    with open(Path(save_dir) / QUANT_FILE, "w") as f:
        json.dump(quant_meta, f, indent=2)


def _strip_bf16(key: str, arr) -> Tuple[str, Any]:
    if key.endswith(_BF16):
        return key[:-len(_BF16)], BF16Bits(arr)
    return key, arr


def _read_flat(load_dir: str) -> Dict[str, Any]:
    return dict(_strip_bf16(k, v)
                for k, v in read_safetensors(str(Path(load_dir) / WEIGHTS_FILE)).items())


def _read_quant_meta(load_dir: str) -> Dict[str, Any]:
    qf = Path(load_dir) / QUANT_FILE
    return json.loads(qf.read_text()) if qf.exists() else {}


def _insert(tree: Dict[str, Any], path, val) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = val


def unflatten_params(flat: Dict[str, Any], quant_meta: Dict[str, Any]) -> Dict[str, Any]:
    """Rebuild the nested (JAX-shaped) tree; a quantized leaf becomes the dict
    of its arrays and its quant.json record that params_from_jax reads."""
    tree: Dict[str, Any] = {}
    qparts: Dict[str, Dict[str, Any]] = {}
    for key, val in flat.items():
        if "#" in key:
            base, part = key.split("#", 1)
            qparts.setdefault(base, {})[part] = val
        else:
            _insert(tree, key.split("/"), val)
    for base, parts in qparts.items():
        if base not in quant_meta:
            raise KeyError(f"{base} has quantized parts but no record in {QUANT_FILE}")
        meta = quant_meta[base]
        _insert(tree, base.split("/"), dict(
            parts, bits=int(meta["bits"]), group_size=int(meta["group_size"]),
            in_dim=int(meta["in_dim"]), out_dim=int(meta["out_dim"]),
            act_dtype=meta.get("act_dtype"), layout=meta.get("layout", "std"),
            tile_k=int(meta.get("tile_k", 0)), serve_layout=meta.get("serve_layout")))
    return tree


def load_checkpoint(load_dir: str, args, device="cuda") -> Dict[str, Any]:
    """A native checkpoint dir -> the port's params on ``device``."""
    return load_checkpoint_list([load_dir], args=args, device=device)


def stream_checkpoint(load_dir: str, device_put_fn=None) -> Iterator[Tuple[str, Any]]:
    """Yield (path, array) one tensor at a time (bf16 tensors as BF16Bits);
    with ``device_put_fn(path, array)`` each is placed before the next is
    read, so peak host memory stays at one tensor."""
    for key, arr in read_safetensors(str(Path(load_dir) / WEIGHTS_FILE)).items():
        key, arr = _strip_bf16(key, arr)
        if device_put_fn is not None:
            arr = device_put_fn(key, arr)
        yield key, arr


def _fill_missing(tree, template):
    """Leaves of ``template`` that ``tree`` lacks, added to it (same structure)."""
    if isinstance(template, dict) and isinstance(tree, dict):
        for k, v in template.items():
            tree[k] = _fill_missing(tree[k], v) if k in tree else v
    elif isinstance(template, list) and isinstance(tree, list):
        if len(tree) != len(template):
            raise ValueError(f"{len(tree)} layers loaded, the template has {len(template)}")
        for i, v in enumerate(template):
            tree[i] = _fill_missing(tree[i], v)
    return tree


def _add_delta(dst, delta):
    """dst + delta in f32, in dst's dtype (bf16 rounded to nearest even)."""
    total = _f32(dst) + np.asarray(delta, dtype=np.float32)
    if isinstance(dst, BF16Bits):
        bits = torch.from_numpy(total).to(torch.bfloat16).view(torch.int16).numpy()
        return BF16Bits(bits.view(np.uint16))
    return total.astype(np.asarray(dst).dtype)


def _merge_into(flat: Dict[str, Any], quant_meta: Dict[str, Any], src: Dict[str, Any],
                meta: Dict[str, Any], diff: bool = False) -> None:
    """Override / add ``src``'s leaves (a quantized leaf replaces a dense one,
    and back); with ``diff`` a dense leaf already loaded takes src's value
    as a delta."""
    for base in meta:
        flat.pop(base, None)
    for key in src:
        if "#" not in key and key in quant_meta:
            del quant_meta[key]
            for field in _QFIELDS:
                flat.pop(f"{key}#{field}", None)
    quant_meta.update(meta)
    for key, val in src.items():
        flat[key] = _add_delta(flat[key], val) if diff and key in flat else val


def load_checkpoint_list(paths: Sequence[str], template_params=None,
                         dtype: Optional[str] = None, *, args,
                         device="cuda") -> Dict[str, Any]:
    """Load checkpoint dirs in order, later paths overriding / adding (base
    weights, then finetuned or extra leaves), and convert the result to the
    port's per-layer params on ``device``, tensor by tensor. A dir is a
    native checkpoint (weights.safetensors) or a PyTorch one
    (``consolidated.*``: imported, and a ``*-diff`` dir's tensors added as
    deltas).

    ``template_params`` (the port's params, e.g. from init_params) supplies
    the leaves that no checkpoint holds. ``dtype`` casts dense floating
    leaves; quantized leaves are kept as stored."""
    from accessory_tpu_torch.checkpoint.torch_import import (
        import_reference_checkpoint, infer_checkpoint_format_and_mp_size)

    flat: Dict[str, Any] = {}
    quant_meta: Dict[str, Any] = {}
    for p in paths:
        if (Path(p) / WEIGHTS_FILE).exists():
            _merge_into(flat, quant_meta, _read_flat(p), _read_quant_meta(p))
        else:
            fmt, _ = infer_checkpoint_format_and_mp_size(p)
            _merge_into(flat, quant_meta, import_reference_checkpoint(p), {},
                        diff=fmt.endswith("_diff"))
    cast = None if dtype is None else torch_dtype(dtype)
    params = params_from_jax(unflatten_params(flat, quant_meta), args, device=device, cast=cast)
    if template_params is not None:
        params = _fill_missing(params, template_params)
    return params
