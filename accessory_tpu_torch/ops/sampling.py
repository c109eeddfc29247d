"""Token sampling: greedy and nucleus (top-p). Port of
``accessory_tpu/ops/sampling.py`` with an explicit ``torch.Generator``
(the JAX package draws with a PRNG key; the streams differ)."""

from __future__ import annotations

import torch


def sample_top_p(probs: torch.Tensor, p: float, generator: torch.Generator) -> torch.Tensor:
    """Nucleus sampling over (batch, vocab) f32 probabilities: drop tokens
    whose preceding cumulative mass already exceeds p, renormalize, draw.
    Returns (batch,) int64 token ids."""
    sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep = (cum - sorted_probs) <= p
    filtered = torch.where(keep, sorted_probs, torch.zeros_like(sorted_probs))
    filtered = filtered / filtered.sum(dim=-1, keepdim=True)
    draw = torch.multinomial(filtered, 1, generator=generator)
    return torch.gather(sorted_idx, -1, draw)[:, 0]


def sample_token(logits: torch.Tensor, generator: torch.Generator,
                 temperature: float = 0.0, top_p: float = 0.75) -> torch.Tensor:
    """Greedy when temperature <= 0, else top-p at the given temperature."""
    if temperature > 0:
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return sample_top_p(probs, top_p, generator)
    return torch.argmax(logits, dim=-1)
