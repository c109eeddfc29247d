"""Model configuration: model args built from a union merge of JSON configs.

Own copy of ``accessory_tpu/config.py`` (union_merge_configs, make_args,
LLaMAArgs, AdapterArgs, InternLMArgs, FalconArgs, MixtralArgs, SphinxArgs,
SphinxMoEArgs, the registry of every llama_type and the SPHINX families'
per-type visual defaults); field names and defaults are identical so one
config JSON drives both packages. ``n_layers_of`` reads the depth of any
family (LLaMA's ``n_layers``, InternLM's and Falcon's ``num_layers``).
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


@dataclass
class AdapterArgs(LLaMAArgs):
    """LLaMA-Adapter: zero-init gated prefix tuning of the last
    ``prefix_layers`` layers (None: all), ``prefix_len`` prefix tokens a
    layer, and the visual prefix branch's projector (``v_*``).
    ``trainable_mode`` is read by nothing, as in the JAX package."""

    prefix_layers: Optional[int] = None
    prefix_len: int = 10
    v_embed_dim: int = 768
    v_depth: int = 8
    v_num_heads: int = 16
    v_mlp_ratio: float = 4.0
    trainable_mode: str = "sg"  # sg | mm_stage1 | mm_stage2


@dataclass
class InternLMArgs:
    """InternLM family (HF-style names, same fields as accessory_tpu): fused
    Wqkv with bias, "half"-pair RoPE, rmsnorm or layernorm, SwiGLU (w1 gate,
    w2 up, w3 down) or GELU FFN of width round_up(hidden_size * mlp_ratio,
    multiple_of). ``layer_norm_epsilon`` is the eps every norm uses
    (``norm_eps`` is read by nothing, as in the reference)."""

    num_layers: int = 32
    hidden_size: int = 4096
    num_attention_heads: int = 32
    mlp_ratio: float = 8 / 3
    layer_norm_epsilon: float = 1e-5
    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    use_swiglu: bool = True
    vocab_size: int = -1
    multiple_of: int = 256
    rope_theta: float = 10000.0
    max_batch_size: int = 32
    max_seq_len: int = 2048
    rope_scaling: Optional[float] = None
    dtype: str = "bfloat16"
    bias: bool = True  # the attention projections carry a bias

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_attention_heads


@dataclass
class FalconArgs:
    """Falcon / Falcon-40B / Falcon-180B family (same fields as accessory_tpu).
    ``new_decoder_architecture``: two parallel layernorms and
    ``num_kv_heads`` KV heads; else ``parallel_attn`` (one layernorm feeding
    both branches) or sequential, with one KV head when ``multi_query``."""

    num_layers: int = 80
    hidden_size: int = 14848
    num_attention_heads: int = 232
    bias: bool = False
    multi_query: bool = True
    new_decoder_architecture: bool = True
    parallel_attn: bool = True
    num_kv_heads: Optional[int] = None
    layer_norm_epsilon: float = 1e-5
    vocab_size: int = -1
    rope_theta: float = 10000.0
    max_batch_size: int = 32
    max_seq_len: int = 2048
    rope_scaling: Optional[float] = None
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        if self.new_decoder_architecture:
            return self.num_kv_heads if self.num_kv_heads is not None else self.num_attention_heads
        return 1 if self.multi_query else self.num_attention_heads


@dataclass
class MixtralArgs:
    """Mixtral-8x7B MoE family (same fields as accessory_tpu): top-k routing
    over ``num_experts`` SwiGLU experts of width ``hidden_dim``."""

    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: Optional[int] = 8
    vocab_size: int = -1
    hidden_dim: int = 14336
    norm_eps: float = 1e-5
    rope_theta: float = 1000000.0
    max_batch_size: int = 32
    max_seq_len: int = 2048
    rope_scaling: Optional[float] = None

    num_experts: int = 8
    num_experts_per_tok: int = 2
    load_balancing_weight: float = 0.01

    dtype: str = "bfloat16"
    rope_style: str = "interleaved"
    # "ep" | "sparse": the reference's sharding layouts of the experts; read
    # by nothing on one card (the sharding rules are ROADMAP A10)
    expert_layout: str = "ep"
    # PEFT: LoRA / bias on the attention projections
    lora_rank: int = -1
    bias_tuning: bool = False
    norm_tuning: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads


@dataclass
class _VisualTowerFields:
    """SPHINX's visual ensemble. The tower sizes default to the production
    towers: CLIP ViT-L/14, DINOv2 ViT-g/14, OpenCLIP ConvNeXt-XXL and the
    BLIP-2 Q-Former."""

    visual: str = "ens"
    image_size: int = 224  # 448 for the ens5 variants, 672 for ens10
    load_pretrained_visual_encoder: bool = False

    vit_patch: int = 14
    clip_width: int = 1024
    clip_layers: int = 24
    clip_heads: int = 16
    dino_width: int = 1536
    dino_layers: int = 40
    dino_heads: int = 24
    convnext_depths: tuple = (3, 4, 30, 3)
    convnext_dims: tuple = (384, 768, 1536, 3072)
    qformer_width: int = 768
    qformer_layers: int = 12
    qformer_heads: int = 12


@dataclass
class SphinxArgs(_VisualTowerFields, LLaMAArgs):
    """SPHINX multimodal LLaMA (the llama_ens and llama_qformerv2 families).
    ``visual``: "ens" | "ens5" | "ens5p2" | "ens_light" | "ens5_light"."""


@dataclass
class SphinxMoEArgs(_VisualTowerFields, MixtralArgs):
    """SPHINX-MoE (the mixtral_sparse_ens families): SPHINX's visual
    ensemble on a Mixtral decoder."""


ARGS_REGISTRY = {"llama": LLaMAArgs, "llama_peft": LLaMAArgs, "llama_adapter": AdapterArgs,
                 "internlm": InternLMArgs, "falcon": FalconArgs,
                 "mixtral": MixtralArgs, "mixtral_peft": MixtralArgs,
                 "mixtral_sparse": MixtralArgs,
                 "llama_qformerv2": SphinxArgs, "llama_qformerv2_peft": SphinxArgs,
                 "llama_ens": SphinxArgs, "llama_ens5": SphinxArgs, "llama_ens5p2": SphinxArgs,
                 "llama_ens10": SphinxArgs, "llama_ens_peft": SphinxArgs,
                 "llama_ens_light": SphinxArgs, "llama_ens5_light": SphinxArgs,
                 "mixtral_sparse_ens": SphinxMoEArgs, "mixtral_sparse_ens5": SphinxMoEArgs}


def _sphinx_visual_for(llama_type: str) -> str:
    """The ``visual`` a SPHINX family defaults to (llama_qformerv2's module
    ignores the ensemble fields it does not use)."""
    return {
        "llama_ens": "ens", "llama_ens5": "ens5", "llama_ens5p2": "ens5p2",
        "llama_ens10": "ens5", "llama_ens_peft": "ens",
        "llama_ens_light": "ens_light", "llama_ens5_light": "ens5_light",
        "mixtral_sparse_ens": "ens", "mixtral_sparse_ens5": "ens5",
        "llama_qformerv2": "ens", "llama_qformerv2_peft": "ens",
    }[llama_type]


def _sphinx_image_size_for(llama_type: str) -> int:
    """The input size of each SPHINX family; the crop count follows from
    size // 224 (2 x 2 + 1 at 448, 3 x 3 + 1 at 672)."""
    return {
        "llama_ens": 224, "llama_ens_peft": 224, "llama_ens_light": 224,
        "llama_ens5": 448, "llama_ens5p2": 448, "llama_ens5_light": 448,
        "llama_ens10": 672,
        "mixtral_sparse_ens": 224, "mixtral_sparse_ens5": 448,
    }.get(llama_type, 224)


def n_layers_of(args) -> int:
    """The depth of any family's args (``n_layers`` or ``num_layers``)."""
    return args.n_layers if hasattr(args, "n_layers") else args.num_layers
