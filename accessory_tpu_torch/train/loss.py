"""Language-model loss. Port of ``accessory_tpu/train/loss.py``."""

from __future__ import annotations

from typing import Tuple

import torch


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 0,
                       shift: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean next-token cross entropy.

    logits (b, s, vocab) f32; labels (b, s) int aligned with the inputs
    (label[t] is the token at input position t; ``ignore_index`` masks).
    With ``shift`` logits[:, :-1] are scored against labels[:, 1:]. Returns
    (scalar loss, valid-token count); the mean is over valid tokens, at
    least one."""
    if shift:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    mask = labels != ignore_index
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    tok_lp = torch.gather(logp, -1, safe[..., None])[..., 0]
    n_valid = mask.sum()
    loss = -torch.where(mask, tok_lp, torch.zeros_like(tok_lp)).sum() / n_valid.clamp_min(1)
    return loss, n_valid
