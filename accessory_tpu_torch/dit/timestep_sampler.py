"""Diffusion timestep samplers: uniform and loss-second-moment.

Port of ``accessory_tpu/dit/timestep_sampler.py`` (reference
Large-DiT-ImageNet/diffusion/timestep_sampler.py: importance-sample t with
unbiasing weights 1/(T p[t]); LossSecondMomentResampler keeps the last H
losses per timestep and weighs by sqrt(E[loss^2]) with ``uniform_prob``
mixed in, uniform until every timestep has a full history).

The state is a pair of tensors on the device (``SamplerState``), so the
sample -> train -> update cycle never leaves it. The history is a circular
buffer (write slot = count mod H): the weights read only the mean of
squares, so the statistics equal the reference's shift-out-oldest buffer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class SamplerState(NamedTuple):
    """Loss history for loss-aware sampling."""
    history: torch.Tensor  # (T, H) f32: the last H losses seen per timestep
    counts: torch.Tensor   # (T,) i32: lifetime writes per timestep


def init_sampler_state(num_timesteps: int, history_per_term: int = 10,
                       device="cuda") -> SamplerState:
    return SamplerState(
        history=torch.zeros((num_timesteps, history_per_term), dtype=torch.float32,
                            device=device),
        counts=torch.zeros((num_timesteps,), dtype=torch.int32, device=device))


def sampler_weights(state: SamplerState, uniform_prob: float = 0.001) -> torch.Tensor:
    """The normalized sampling distribution p(t) (reference weights():131-138):
    uniform until warm (every timestep has a full history), then
    sqrt(mean(loss^2)) renormalized with ``uniform_prob`` mixed in so no
    timestep starves."""
    T, H = state.history.shape
    warmed = torch.all(state.counts >= H)
    w = torch.sqrt(torch.mean(torch.square(state.history), dim=-1))
    w = w / torch.clamp_min(torch.sum(w), 1e-20)
    w = w * (1 - uniform_prob) + uniform_prob / T
    return torch.where(warmed, w, torch.full((T,), 1.0 / T, device=w.device))


def sample_timesteps(state: SamplerState, generator: Optional[torch.Generator], batch: int,
                     uniform_prob: float = 0.001, t: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Importance-sample a (b,) timestep batch and its unbiasing weights
    1/(T p[t_i]) (reference sample():53-58): multiplying the per-example
    losses by them keeps the objective's expectation equal to the uniform
    objective. ``t``: the draw to use (else drawn from ``generator``)."""
    p = sampler_weights(state, uniform_prob)
    if t is None:
        t = torch.multinomial(p, batch, replacement=True, generator=generator)
    t = t.to(device=p.device, dtype=torch.long)
    return t, 1.0 / (p.shape[0] * p[t])


@torch.no_grad()
def update_sampler_state(state: SamplerState, t: torch.Tensor,
                         losses: torch.Tensor) -> SamplerState:
    """The state with the batch's (t, loss) pairs recorded
    (update_with_all_losses:139-147), one pair at a time in batch order, so
    duplicate timesteps in one batch each land in their own history slot,
    as in the reference's loop. The losses are statistics: detached."""
    H = state.history.shape[1]
    history, counts = state.history.clone(), state.counts.clone()
    losses = losses.detach().to(torch.float32)
    for i in range(t.shape[0]):
        ti = t[i]
        history[ti, counts[ti] % H] = losses[i]
        counts[ti] += 1
    return SamplerState(history, counts)


def create_named_schedule_sampler(name: str, num_timesteps: int, history_per_term: int = 10,
                                  device="cuda"):
    """The reference entry point (timestep_sampler.py:13-24): returns
    (init_state, sample_fn, update_fn); for "uniform" the state is None and
    update returns it unchanged, so train loops thread one interface.
    ``sample_fn(state, generator, batch, t=None)`` -> (t, weights)."""
    if name == "uniform":
        def sample_u(state, generator, batch, t=None):
            if t is None:
                t = torch.randint(0, num_timesteps, (batch,), generator=generator,
                                  device=device)
            t = t.to(device=device, dtype=torch.long)
            return t, torch.ones((batch,), dtype=torch.float32, device=device)

        return None, sample_u, lambda state, t, losses: state
    if name == "loss-second-moment":
        return (init_sampler_state(num_timesteps, history_per_term, device=device),
                lambda state, generator, batch, t=None: sample_timesteps(state, generator,
                                                                         batch, t=t),
                update_sampler_state)
    raise ValueError(f"unknown schedule sampler: {name}")
