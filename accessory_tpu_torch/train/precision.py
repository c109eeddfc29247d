"""Precision utilities. Port of ``accessory_tpu/train/precision.py``:
trainable parameters train as f32 masters while frozen ones keep their
dtype; the train step casts the masters to the compute dtype inside the
differentiated function (``train_step._autocast``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from accessory_tpu_torch.train.tree import map_leaves


def promote_trainable_params_to_fp32(params, trainable: Optional[Callable[[str], bool]] = None):
    """Cast trainable floating leaves to f32 (quantized and frozen leaves kept)."""

    def visit(path, leaf):
        if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
            return leaf
        if trainable is not None and not trainable(path):
            return leaf
        return leaf.to(torch.float32)

    return map_leaves(visit, params)
