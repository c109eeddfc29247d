"""Whole-model quantization: swap eligible dense weights in a params tree for
folded-layout W4 QuantizedWeights. Port of ``accessory_tpu/quant/quantize.py``
(same blocklist, output-head exclusion and in_dim padding rule)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from accessory_tpu_torch.quant.qtensor import (W3_W8_QUEUE, quantize_weight,
                                               to_folded_layout)

# path substrings never quantized
DEFAULT_BLOCKLIST = (
    "tok_embeddings",
    "norm",
    "lora",
    "bias",
    "gate",
    "visual",
    "rope",
)


def pad_to(in_dim: int, group_size: int) -> int:
    """Reduction-dim padding multiple (1024 for in_dim >= 1024, else one
    group), as in the JAX package, so both packages hold the same K."""
    return 1024 if in_dim >= 1024 else group_size


def quantize_params(params, bits: int = 4, group_size: int = 128,
                    blocklist: Sequence[str] = DEFAULT_BLOCKLIST,
                    quantize_output: bool = False,
                    predicate: Optional[Callable[[str, torch.Tensor], bool]] = None):
    """Return a params tree (dicts / lists of tensors) with every eligible 2-D
    floating weight quantized: path not on the blocklist (nor "output" unless
    ``quantize_output``), in_dim a multiple of ``group_size``. The port's
    trees hold per-layer weights, so only 2-D leaves are visited."""
    if bits != 4:
        raise NotImplementedError(f"W{bits} quantize_params: {W3_W8_QUEUE}")
    block = tuple(blocklist) + (() if quantize_output else ("output",))

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
            return to_folded_layout(quantize_weight(
                node, bits=bits, group_size=group_size, act_dtype=node.dtype,
                pad_in_to=pad_to(node.shape[0], group_size)))
        return node

    return visit(params, "")
