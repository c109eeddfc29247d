"""Whole-model quantization: swap eligible dense weights in a params tree for
QuantizedWeights. Port of ``accessory_tpu/quant/quantize.py`` (its
blocklist, output-head exclusion, in_dim padding rule and per-expert
quantization of MoE expert leaves). The blocklist adds
``word_embeddings``, InternLM's and Falcon's embedding table: the JAX
package's blocks only LLaMA's ``tok_embeddings``, so it quantizes that
table whenever the vocabulary is a multiple of the group size, and its
forward's table lookup then fails (ROADMAP C8)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from accessory_tpu_torch.quant.qtensor import (quantize_weight, to_folded_layout,
                                               to_w8_layout)

# path substrings never quantized
DEFAULT_BLOCKLIST = (
    "tok_embeddings",
    "word_embeddings",
    "norm",
    "lora",
    "bias",
    "gate",
    "visual",
    "rope",
)
# the layout "auto" picks for each bit width: each one's kernel layout
# (W3 has no kernel: its std weights take the dequant + plain matmul)
AUTO_LAYOUT = {3: "std", 4: "folded", 8: "w8"}
_CONVERT = {"std": lambda qw: qw, "folded": to_folded_layout, "w8": to_w8_layout}


def pad_to(in_dim: int, group_size: int) -> int:
    """Reduction-dim padding multiple (1024 for in_dim >= 1024, else one
    group), as in the JAX package, so both packages hold the same K."""
    return 1024 if in_dim >= 1024 else group_size


def quantize_params(params, bits: int = 4, group_size: int = 128,
                    blocklist: Sequence[str] = DEFAULT_BLOCKLIST,
                    quantize_output: bool = False,
                    predicate: Optional[Callable[[str, torch.Tensor], bool]] = None,
                    layout: str = "auto"):
    """Return a params tree (dicts / lists of tensors) with every eligible
    floating weight quantized: path not on the blocklist (nor "output" unless
    ``quantize_output``), in_dim a multiple of ``group_size``. The port's
    trees hold per-layer weights: a 2-D leaf becomes one QuantizedWeight, a
    3-D leaf (a MoE layer's experts, (E, in, out)) a tuple of E of them,
    quantized expert by expert as the JAX package quantizes its 4-D leaves.

    ``layout``: "auto" (the same on the CPU and the GPU: folded for W4, w8
    for W8, std for W3), or "std", "folded" (W4) or "w8" (W8) explicitly."""
    if bits not in AUTO_LAYOUT:
        raise ValueError(f"bits {bits}: quantize_params takes {sorted(AUTO_LAYOUT)}")
    layout = AUTO_LAYOUT[bits] if layout == "auto" else layout
    if layout not in _CONVERT:
        raise ValueError(f"layout {layout!r}: one of 'auto', {sorted(_CONVERT)}")
    convert = _CONVERT[layout]
    block = tuple(blocklist) + (() if quantize_output else ("output",))

    def quantize(w):
        return convert(quantize_weight(w, bits=bits, group_size=group_size, act_dtype=w.dtype,
                                       pad_in_to=pad_to(w.shape[0], group_size)))

    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v, f"{path}/{i}") for i, v in enumerate(node))
        if not isinstance(node, torch.Tensor) or not node.is_floating_point():
            return node
        if any(b in path for b in block):
            return node
        if predicate is not None and not predicate(path, node):
            return node
        if node.ndim == 2 and node.shape[0] % group_size == 0:
            return quantize(node)
        if node.ndim == 3 and node.shape[1] % group_size == 0:
            # MoE experts (E, in, out): one weight an expert, each its own buffers
            return tuple(quantize(node[e]) for e in range(node.shape[0]))
        return node

    return visit(params, "")
