"""Token sampling: greedy and nucleus (top-p), one setting for the batch or
per row. Port of ``accessory_tpu/ops/sampling.py`` with an explicit
``torch.Generator`` (the JAX package draws with a PRNG key; the streams
differ, greedy tokens do not)."""

from __future__ import annotations

import torch


def sample_top_p(probs: torch.Tensor, p, generator: torch.Generator) -> torch.Tensor:
    """Nucleus sampling over (batch, vocab) f32 probabilities: drop tokens
    whose preceding cumulative mass already exceeds p (a float, or a (batch, 1)
    tensor of per-row values), renormalize, draw. Returns (batch,) int64 ids."""
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


def sample_token_batched(logits: torch.Tensor, generator: torch.Generator,
                         temperature: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-row temperature / top-p sampling over (b, vocab) logits, on the
    logits' device: rows with temperature <= 0 are greedy, the others draw
    from their nucleus with ``generator`` (a generator on that device).
    temperature / top_p (b,) f32 tensors. Returns (b,) int64 ids. The
    continuous batcher samples every slot this way inside a dispatch, so only
    the token ids come back to the host. Port of
    ``accessory_tpu/ops/sampling.py::sample_token_batched``."""
    greedy = torch.argmax(logits, dim=-1)
    t = torch.clamp_min(temperature, 1e-6)[:, None]
    probs = torch.softmax(logits.to(torch.float32) / t, dim=-1)
    sampled = sample_top_p(probs, top_p[:, None], generator)
    return torch.where(temperature > 0, sampled, greedy)
