"""Import OmniQuant / GPTQ-format quantized checkpoints.

Port of ``accessory_tpu/quant/omniquant.py``. Released OmniQuant weights ship
in the AutoGPTQ tensor layout; this module converts that layout to the port's
std-layout QuantizedWeight (zeros unfolded), which W4 serves through the std
kernel (ops/quant_matmul_pallas.py):

  GPTQ:  qweight (K/pw, N) int32 -- pw = 32 // bits values per word along K
         qzeros  (K/gs, N/pw) int32 -- zero points packed along N
         scales  (K/gs, N) f16
         dequant w[k, n] = (q[k, n] - (z[g, n] + 1)) * s[g, n]   (the classic
         GPTQ +1 zero offset; ``zero_plus_one=False`` for exllama exports)

  Ours:  packed (K/pw, N) 32-bit words along K (the same order), zeros f32
         unpacked.

W3 is read as the reference reads it, 10 values a word along K and along N.
That holds only where K and N are multiples of 10 (K also of the group
size); elsewhere the reference's reading breaks (an assertion or a wrong
in_dim), and AutoGPTQ's own 3-bit format is a bit stream of 32 values per 3
words that neither reads. The port raises ``ValueError`` there (ROADMAP C3).

The files are read with the port's numpy safetensors reader
(``checkpoint.native.read_safetensors``): no ``safetensors`` package.
"""

from __future__ import annotations

import dataclasses
import glob
import re
from typing import Dict, Optional

import numpy as np
import torch

from accessory_tpu_torch.checkpoint.native import read_safetensors
from accessory_tpu_torch.quant.qtensor import QuantizedWeight

W3_FAULT = ("the reference's W3 GPTQ reading (10 values a word along K and N) does not "
            "hold at this shape; AutoGPTQ's 3-bit bit stream is not read (ROADMAP C3)")


def _unpack_cols(packed: np.ndarray, bits: int) -> np.ndarray:
    """Unpack int32 (G, N/pw) -> (G, N) along the last axis. Own copy of the
    reference's omniquant._unpack_cols."""
    pw = 32 // bits
    mask = (1 << bits) - 1
    shifts = (np.arange(pw, dtype=np.uint32) * bits)[None, None, :]
    vals = (np.asarray(packed).astype(np.uint32)[:, :, None] >> shifts) & mask
    return vals.reshape(packed.shape[0], packed.shape[1] * pw)


def from_gptq(qweight: np.ndarray, qzeros: np.ndarray, scales: np.ndarray, bits: int = 4,
              group_size: int = 128, act_dtype: torch.dtype = torch.bfloat16,
              zero_plus_one: bool = True, device="cuda") -> QuantizedWeight:
    """Convert one GPTQ-layout linear to a std-layout QuantizedWeight on
    ``device``."""
    pw = 32 // bits
    in_dim = qweight.shape[0] * pw
    out_dim = qweight.shape[1]
    zeros = _unpack_cols(qzeros, bits).astype(np.float32)
    if in_dim % group_size or zeros.shape != (in_dim // group_size, out_dim):
        detail = (f"qweight {tuple(qweight.shape)} gives in_dim {in_dim} and out_dim "
                  f"{out_dim}; qzeros {tuple(qzeros.shape)} unpacks to {zeros.shape} at group "
                  f"size {group_size}")
        raise ValueError(f"{detail}: {W3_FAULT}" if bits == 3 else detail)
    if zero_plus_one:
        zeros = zeros + 1.0
    return QuantizedWeight(
        packed=torch.from_numpy(np.array(qweight).view(np.int32)).to(device),
        scales=torch.from_numpy(np.array(scales, np.float32)).to(device),
        zeros=torch.from_numpy(zeros).to(device), bits=bits, group_size=group_size,
        in_dim=in_dim, out_dim=out_dim, act_dtype=act_dtype)


def _rope_unpermute_cols(n_heads: int, out_dim: int) -> np.ndarray:
    """Column permutation taking the HF half-split rotary layout to the
    interleaved one: interleaved position (h, 2i + p) reads HF position
    (h, p * hd/2 + i). Own copy of the reference's."""
    hd = out_dim // n_heads
    i = np.arange(hd // 2)
    per_head = np.empty(hd, np.int64)
    per_head[2 * i] = i
    per_head[2 * i + 1] = hd // 2 + i
    return (np.arange(n_heads)[:, None] * hd + per_head[None, :]).reshape(-1)


def unpermute_rope_qw(qw: QuantizedWeight, n_heads: int) -> QuantizedWeight:
    """Undo the HF half-split rotary row permutation on a GPTQ-imported q / k
    projection: a pure reorder of the out (N) axis of packed, scales and
    zeros, exact."""
    perm = torch.from_numpy(_rope_unpermute_cols(n_heads, qw.out_dim)).to(qw.packed.device)
    return dataclasses.replace(qw, packed=qw.packed[:, perm].contiguous(),
                               scales=qw.scales[:, perm].contiguous(),
                               zeros=qw.zeros[:, perm].contiguous())


# HF-GPTQ module name -> the port's per-layer param path (llama family)
_HF_TO_OURS = {
    "self_attn.q_proj": "attention/wq/weight",
    "self_attn.k_proj": "attention/wk/weight",
    "self_attn.v_proj": "attention/wv/weight",
    "self_attn.o_proj": "attention/wo/weight",
    "mlp.gate_proj": "feed_forward/w1/weight",
    "mlp.down_proj": "feed_forward/w2/weight",
    "mlp.up_proj": "feed_forward/w3/weight",
}


def load_gptq_dir(path: str, bits: int = 4, group_size: int = 128,
                  act_dtype: torch.dtype = torch.bfloat16, n_heads: Optional[int] = None,
                  n_kv_heads: Optional[int] = None, rope_style: str = "interleaved",
                  device="cuda") -> Dict[str, Dict[int, QuantizedWeight]]:
    """Read a HF AutoGPTQ safetensors dir -> {layer path: {layer index: QW}}
    with every weight on ``device``.

    With ``rope_style='interleaved'`` (the models' default) the HF half-split
    rotary permutation on q_proj / k_proj is undone column-wise
    (``unpermute_rope_qw``); ``n_heads`` (and ``n_kv_heads`` for GQA) are then
    required. Pass ``rope_style='half'`` only if the model uses half-split
    RoPE. ``install_gptq_weights`` puts the result into a params tree."""
    if rope_style == "interleaved" and n_heads is None:
        raise ValueError(
            "load_gptq_dir: n_heads is required to undo the HF rotary permutation for "
            "rope_style='interleaved' (pass rope_style='half' only if the model uses "
            "half-split RoPE)")
    tensors: Dict[str, np.ndarray] = {}
    for f in sorted(glob.glob(f"{path}/*.safetensors")):
        tensors.update(read_safetensors(f))

    out: Dict[str, Dict[int, QuantizedWeight]] = {}
    pat = re.compile(r"model\.layers\.(\d+)\.(.+)\.qweight")
    for name, qweight in tensors.items():
        m = pat.fullmatch(name)
        if not m or m.group(2) not in _HF_TO_OURS:
            continue
        idx, mod = int(m.group(1)), m.group(2)
        base = f"model.layers.{idx}.{mod}"
        imported = from_gptq(qweight, tensors[base + ".qzeros"], tensors[base + ".scales"],
                             bits=bits, group_size=group_size, act_dtype=act_dtype,
                             device=device)
        if rope_style == "interleaved":
            if mod == "self_attn.q_proj":
                imported = unpermute_rope_qw(imported, n_heads)
            elif mod == "self_attn.k_proj":
                imported = unpermute_rope_qw(imported, n_kv_heads or n_heads)
        out.setdefault(_HF_TO_OURS[mod], {})[idx] = imported
    return out


def install_gptq_weights(params, gptq: Dict[str, Dict[int, QuantizedWeight]]):
    """Replace the dense weights of the port's per-layer llama params with the
    QuantizedWeights of ``load_gptq_dir`` (in place; returns ``params``). The
    weights stay on the device ``load_gptq_dir`` put them on."""
    layers = params["layers"]
    for path, per_layer in gptq.items():
        parts = path.split("/")
        for idx, qw in per_layer.items():
            if not 0 <= idx < len(layers):
                raise ValueError(f"GPTQ layer {idx} is past the model's {len(layers)} layers")
            node = layers[idx]
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = qw
    return params
