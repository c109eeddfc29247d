"""DiT model: LLaMA-style blocks with adaLN-zero conditioning.

Port of ``accessory_tpu/dit/model.py`` (reference Large-DiT-T2I/models/
model.py:36-513): patch embedding of VAE latents, a sinusoidal timestep
embedding through an MLP, a label embedding (one extra slot: the CFG null
label), optional caption features pooled into the conditioning vector,
blocks whose LayerNorms are modulated by (shift, scale, gate) from the
conditioning vector (the gate projections zero-init, so every block starts
as the identity), and a final adaLN + linear head predicting 2 x channels
(eps and the learned sigma).

The port keeps the layers as a list of per-layer dicts (the reference
stacks them for its ``lax.scan``); ``convert.params_from_jax`` /
``params_to_jax`` carry a tree across in either direction. Attention is the
port's plain ``ops.attention.attention(..., causal=False)``, as in the
reference (an einsum there, no Pallas kernel), and the dense products are
``ops.linear.linear`` (``torch.matmul``), so a block checkpointed under
``remat=True`` keeps them for its recompute (``util.remat_policy``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from accessory_tpu_torch.models.llama import torch_dtype
from accessory_tpu_torch.ops.attention import attention
from accessory_tpu_torch.ops.linear import linear
from accessory_tpu_torch.ops.norms import layer_norm
from accessory_tpu_torch.util import remat_policy

Params = Dict[str, Any]


@dataclasses.dataclass
class DiTArgs:
    input_size: int = 32       # latent spatial size
    patch_size: int = 2
    in_channels: int = 4       # VAE latent channels
    dim: int = 1152
    n_layers: int = 28
    n_heads: int = 16
    num_classes: int = 1000
    class_dropout_prob: float = 0.1
    learn_sigma: bool = True
    multiple_of: int = 256
    dtype: str = "float32"
    # T2I conditioning (Large-DiT-T2I): caption features (e.g. T5/CLIP text
    # encoder outputs) projected into the adaLN conditioning vector
    cap_feat_dim: int = 0  # 0 = class-conditional only

    @property
    def n_patches(self) -> int:
        return (self.input_size // self.patch_size) ** 2

    @property
    def out_channels(self) -> int:
        return self.in_channels * (2 if self.learn_sigma else 1)

    @property
    def ffn_hidden(self) -> int:
        hidden = int(2 * (4 * self.dim) / 3)
        return self.multiple_of * ((hidden + self.multiple_of - 1) // self.multiple_of)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding (reference TimestepEmbedder), in f32 as the
    reference computes it (log of max_period taken in f32)."""
    half = dim // 2
    log_period = torch.log(torch.tensor(float(max_period), dtype=torch.float32))
    freqs = torch.exp(-log_period * torch.arange(half, dtype=torch.float32) / half)
    args = t.to(torch.float32)[:, None] * freqs.to(t.device)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def init_dit(seed: Union[int, torch.Generator], args: DiTArgs, device="cuda") -> Params:
    """Random params from ``seed`` (an int, or a ``torch.Generator`` on
    ``device``): normal, fan-in scaled as the reference's; norms at one; the
    adaLN projections and the head zero (adaLN-zero)."""
    dtype = torch_dtype(args.dtype)
    d, L = args.dim, args.n_layers
    ffn = args.ffn_hidden
    pd = args.patch_size * args.patch_size * args.in_channels
    out_pd = pd * (2 if args.learn_sigma else 1)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=device).manual_seed(seed)

    def dense(shape, s=None):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w * (s or shape[-2] ** -0.5)).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    params = {
        "patch_embed": {"weight": dense((pd, d), 0.02), "bias": zeros(d)},
        "pos_embed": dense((args.n_patches, d), 0.02),
        "t_embed": {"fc1": {"weight": dense((256, d)), "bias": zeros(d)},
                    "fc2": {"weight": dense((d, d)), "bias": zeros(d)}},
        # +1 class slot = CFG null label (reference LabelEmbedder)
        "y_embed": {"weight": dense((args.num_classes + 1, d), 0.02)},
    }
    if args.cap_feat_dim:
        params["cap_embed"] = {"fc1": {"weight": dense((args.cap_feat_dim, d)),
                                       "bias": zeros(d)},
                               "fc2": {"weight": dense((d, d)), "bias": zeros(d)}}
    params["layers"] = [{
        "attn_norm": {"weight": ones(d)},
        "ffn_norm": {"weight": ones(d)},
        "wqkv": {"weight": dense((d, 3 * d))},
        "wo": {"weight": dense((d, d))},
        "w1": {"weight": dense((d, ffn))},
        "w2": {"weight": dense((ffn, d))},
        "w3": {"weight": dense((d, ffn))},
        # adaLN-zero: 6 modulation vectors per block, zero-init
        "ada": {"weight": zeros(d, 6 * d), "bias": zeros(6 * d)},
    } for _ in range(L)]
    params["final"] = {"norm": {"weight": ones(d)},
                       "ada": {"weight": zeros(d, 2 * d), "bias": zeros(2 * d)},
                       "linear": {"weight": zeros(d, out_pd), "bias": zeros(out_pd)}}
    return params


def dit_param_axes(args: DiTArgs) -> Params:
    """Logical sharding axes of each leaf (the reference's spec; the port's
    layers carry no leading axis). Nothing on the one-card path reads it:
    it waits for the weight sharding of ROADMAP A10."""
    A = lambda *n: tuple(n)  # noqa: E731
    return {
        "patch_embed": {"weight": A("embed", None), "bias": A(None)},
        "pos_embed": A(None, "embed"),
        "t_embed": {"fc1": {"weight": A(None, "embed"), "bias": A(None)},
                    "fc2": {"weight": A("embed", None), "bias": A(None)}},
        "y_embed": {"weight": A("vocab", "embed")},
        "layers": {
            "attn_norm": {"weight": A(None)},
            "ffn_norm": {"weight": A(None)},
            "wqkv": {"weight": A("embed", "heads")},
            "wo": {"weight": A("heads", "embed")},
            "w1": {"weight": A("embed", "ffn")},
            "w2": {"weight": A("ffn", "embed")},
            "w3": {"weight": A("embed", "ffn")},
            "ada": {"weight": A("embed", None), "bias": A(None)},
        },
        "final": {"norm": {"weight": A(None)},
                  "ada": {"weight": A("embed", None), "bias": A(None)},
                  "linear": {"weight": A("embed", None), "bias": A(None)}},
    }


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _block(h, c, layer, args: DiTArgs):
    b, d, nh = h.shape[0], args.dim, args.n_heads
    mod = linear(c, layer["ada"]["weight"], layer["ada"]["bias"])
    s1, sc1, g1, s2, sc2, g2 = torch.chunk(mod, 6, dim=-1)
    xn = _modulate(layer_norm(h, layer["attn_norm"]["weight"]), s1, sc1)
    qkv = linear(xn, layer["wqkv"]["weight"]).reshape(b, -1, 3, nh, d // nh)
    out = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=False)
    h = h + g1[:, None, :] * linear(out.reshape(b, -1, d), layer["wo"]["weight"])
    xn = _modulate(layer_norm(h, layer["ffn_norm"]["weight"]), s2, sc2)
    ff = F.silu(linear(xn, layer["w1"]["weight"])) * linear(xn, layer["w3"]["weight"])
    return h + g2[:, None, :] * linear(ff, layer["w2"]["weight"])


def dit_forward(params: Params, args: DiTArgs, x: torch.Tensor, t: torch.Tensor,
                y: torch.Tensor, cap_feats: Optional[torch.Tensor] = None,
                remat=False) -> torch.Tensor:
    """x (b, C, H, W) noisy latents, t (b,) timesteps, y (b,) labels
    (num_classes = the CFG null label), cap_feats (b, T, cap_feat_dim) or
    None -> (b, out_channels, H, W). ``remat`` (``util.remat_policy``:
    True / "dots" keeps each block's dense products, "full" nothing)
    checkpoints each block, whose forward then runs again in the backward."""
    b = x.shape[0]
    p, g = args.patch_size, args.input_size // args.patch_size

    # patchify
    xp = x.reshape(b, args.in_channels, g, p, g, p).permute(0, 2, 4, 3, 5, 1)
    xp = xp.reshape(b, g * g, p * p * args.in_channels)
    pe = params["patch_embed"]
    h = linear(xp.to(params["pos_embed"].dtype), pe["weight"], pe["bias"])
    h = h + params["pos_embed"][None]

    # conditioning vector c = t_emb + y_emb
    te = timestep_embedding(t, 256).to(h.dtype)
    tm = params["t_embed"]
    te = F.silu(linear(te, tm["fc1"]["weight"], tm["fc1"]["bias"]))
    te = linear(te, tm["fc2"]["weight"], tm["fc2"]["bias"])
    cond = te + params["y_embed"]["weight"][y]
    if cap_feats is not None and "cap_embed" in params:
        # T2I: project caption features and mean-pool into the global
        # conditioning vector (Large-DiT-T2I CaptionEmbedder role)
        ce = params["cap_embed"]
        cf = F.silu(linear(cap_feats.to(cond.dtype), ce["fc1"]["weight"], ce["fc1"]["bias"]))
        cf = linear(cf, ce["fc2"]["weight"], ce["fc2"]["bias"])
        cond = cond + torch.mean(cf, dim=1)
    c = F.silu(cond)

    checkpoint = remat_policy(remat)
    for layer in params["layers"]:
        h = (_block(h, c, layer, args) if checkpoint is None
             else checkpoint(_block, h, c, layer, args))

    fin = params["final"]
    shift, scale = torch.chunk(linear(c, fin["ada"]["weight"], fin["ada"]["bias"]), 2, dim=-1)
    h = _modulate(layer_norm(h, fin["norm"]["weight"]), shift, scale)
    h = linear(h, fin["linear"]["weight"], fin["linear"]["bias"])

    # unpatchify
    oc = args.out_channels
    h = h.reshape(b, g, g, p, p, oc).permute(0, 5, 1, 3, 2, 4)
    return h.reshape(b, oc, g * p, g * p)
