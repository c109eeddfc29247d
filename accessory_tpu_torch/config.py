"""Model configuration: LLaMA args built from a union merge of JSON configs.

Own copy of ``accessory_tpu/config.py`` (union_merge_configs, make_args,
LLaMAArgs); field names and defaults are identical so one config JSON drives
both packages.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Union


def union_merge_configs(paths_or_dicts: Sequence[Union[str, Dict[str, Any]]]) -> Dict[str, Any]:
    """Union-merge JSON config files / dicts, last key wins."""
    merged: Dict[str, Any] = {}
    for item in paths_or_dicts:
        if isinstance(item, str):
            with open(item) as f:
                item = json.load(f)
        if not isinstance(item, dict):
            raise TypeError(f"config item must be a dict or JSON path, got {type(item)}")
        merged.update(item)
    return merged


def make_args(args_cls, config: Sequence[Union[str, Dict[str, Any]]] = (), **overrides):
    """Build an args dataclass from a union-merged config plus kw overrides.
    Keys the dataclass does not know are skipped."""
    merged = union_merge_configs(config)
    merged.update(overrides)
    fields = {f.name for f in dataclasses.fields(args_cls)}
    return args_cls(**{k: v for k, v in merged.items() if k in fields})


@dataclass
class LLaMAArgs:
    """LLaMA / LLaMA2 / CodeLLaMA family args (same fields as accessory_tpu)."""

    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: Optional[int] = None
    vocab_size: int = -1  # set by tokenizer
    multiple_of: int = 256
    ffn_dim_multiplier: Optional[float] = None
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0

    max_batch_size: int = 32
    max_seq_len: int = 2048

    rope_scaling: Optional[float] = None

    dtype: str = "bfloat16"  # parameter / activation dtype
    rope_style: str = "interleaved"  # "interleaved" (meta llama) | "half" (neox/hf)
    tie_embeddings: bool = False
    lora_rank: int = -1
    bias_tuning: bool = False
    norm_tuning: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def ffn_hidden_dim(self) -> int:
        """SwiGLU hidden size with 2/3 shrink + multiple_of round-up."""
        hidden = int(2 * (4 * self.dim) / 3)
        if self.ffn_dim_multiplier is not None:
            hidden = int(self.ffn_dim_multiplier * hidden)
        return self.multiple_of * ((hidden + self.multiple_of - 1) // self.multiple_of)


ARGS_REGISTRY = {"llama": LLaMAArgs}
