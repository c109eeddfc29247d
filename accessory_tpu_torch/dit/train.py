"""DiT training CLI (ImageNet class-conditional style).

Port of ``accessory_tpu/dit/train.py`` (reference Large-DiT-ImageNet/
train.py, Large-DiT-T2I/train.py:160-235): AdamW after a global-norm clip
(the reference's ``optax.chain(clip_by_global_norm, adamw(weight_decay=0))``,
here ``train.optim``'s written-out form), an f32 EMA of the params, CFG label
(and caption) dropout, the uniform or loss-aware timestep sampler, and
``{"model", "ema"}`` checkpoints in the native format (numpy writer).

Expects pre-extracted VAE latents as .npz shards ({"latents": (N, C, H, W),
"labels": (N,)}); VAE encoding is outside scope, as in the reference.

Run: python -m accessory_tpu_torch.dit.train --data_dir shards/ --output_dir out/
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, Optional

import numpy as np
import torch


def get_args_parser():
    p = argparse.ArgumentParser("DiT training", add_help=False)
    p.add_argument("--data_dir", required=True, type=str)
    p.add_argument("--output_dir", default="./dit_out", type=str)
    p.add_argument("--dim", default=1152, type=int)
    p.add_argument("--n_layers", default=28, type=int)
    p.add_argument("--n_heads", default=16, type=int)
    p.add_argument("--input_size", default=32, type=int)
    p.add_argument("--num_classes", default=1000, type=int)
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--max_iters", default=400000, type=int)
    p.add_argument("--ema_decay", default=0.9999, type=float)
    p.add_argument("--clip_grad", default=1.0, type=float)
    p.add_argument("--model_parallel_size", default=1, type=int)
    p.add_argument("--save_freq", default=10000, type=int)
    p.add_argument("--log_every", default=100, type=int)
    p.add_argument("--seed", default=0, type=int)
    # reference train.py --schedule_sampler (uniform | loss-second-moment)
    p.add_argument("--schedule_sampler", default="uniform", type=str,
                   choices=("uniform", "loss-second-moment"))
    return p


def draw_step(args_d, diffusion, sample_fn, sampler_state, generator, latents
              ) -> Dict[str, torch.Tensor]:
    """The step's random draws, in one place: the timesteps ``t`` (from the
    schedule sampler), the ``noise`` the loss adds to the latents and the CFG
    ``drop`` mask. A caller may hand the step its own dict instead (the
    reference draws them from three keys split off its step key)."""
    b = latents.shape[0]
    t, _ = sample_fn(sampler_state, generator, b)
    noise = torch.randn(latents.shape, generator=generator, dtype=latents.dtype,
                        device=latents.device)
    u = torch.rand((b,), generator=generator, device=latents.device)
    return {"t": t, "noise": noise, "drop": u < args_d.class_dropout_prob}


def make_dit_train_step(args_d, diffusion, tx, remat=True, schedule_sampler: str = "uniform",
                        device="cuda", ema_decay: float = 0.9999):
    """``step(state, ema, latents, labels, generator, cap_feats=None,
    sampler_state=None, draws=None)`` -> (state, ema, metrics[,
    sampler_state]): one AdamW step on the loss (each example's hybrid loss
    times its timestep's unbiasing weight, averaged), then the EMA update at
    ``ema_decay`` (the reference's step ignores its ``--ema_decay``: ROADMAP
    C15), both in place on the tensors of ``state`` and ``ema``. ``draws``: the
    step's draws (``draw_step``), else drawn from ``generator``. Metrics:
    loss, mse, vb, grad_norm, as 0-d tensors on the device.

    ``schedule_sampler="loss-second-moment"`` importance-samples timesteps
    from the per-t loss history (reference LossAwareSampler /
    LossSecondMomentResampler); the step then takes ``sampler_state`` and
    returns it updated, and this returns (step, the initial sampler state)."""
    from accessory_tpu_torch.dit.diffusion import ema_update
    from accessory_tpu_torch.dit.model import dit_forward
    from accessory_tpu_torch.dit.timestep_sampler import create_named_schedule_sampler
    from accessory_tpu_torch.train.optim import global_norm
    from accessory_tpu_torch.train.train_step import TrainState, partition_params

    sstate0, sample_fn, update_fn = create_named_schedule_sampler(
        schedule_sampler, diffusion.num_timesteps, device=device)
    loss_aware = sstate0 is not None

    def step(state, ema, latents, labels, generator=None, cap_feats=None, sampler_state=None,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        latents = torch.as_tensor(latents, dtype=torch.float32, device=device)
        labels = torch.as_tensor(labels, dtype=torch.long, device=device)
        if draws is None:
            draws = draw_step(args_d, diffusion, sample_fn, sampler_state, generator, latents)
        b = latents.shape[0]
        t, t_weights = sample_fn(sampler_state, None, b, t=draws["t"])
        drop = torch.as_tensor(draws["drop"], device=device)
        # CFG label dropout -> the null label (LabelEmbedder semantics); for
        # T2I the same dropout zeroes the caption conditioning
        labels = torch.where(drop, torch.full_like(labels, args_d.num_classes), labels)
        if cap_feats is not None:
            cap_feats = torch.as_tensor(cap_feats, dtype=torch.float32, device=device)
            cap_feats = torch.where(drop[:, None, None], torch.zeros_like(cap_feats),
                                    cap_feats)
        diff = partition_params(state.params)
        for p in diff.values():
            p.grad = None
        per, parts = diffusion.training_loss(
            lambda xt, tt: dit_forward(state.params, args_d, xt, tt, labels,
                                       cap_feats=cap_feats, remat=remat),
            latents, t, noise=torch.as_tensor(draws["noise"], device=device), reduce=False)
        # importance-sampling unbiasing weights (1 for uniform): the weighted
        # mean keeps E[loss] equal to the uniform objective
        loss = torch.mean(per * t_weights)
        loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in diff.items()}
        gnorm = global_norm(list(grads.values()))
        opt_state = tx.update(grads, state.opt_state, diff, grad_norm=gnorm)
        ema_update(ema, state.params, ema_decay)
        metrics = {"loss": loss.detach(), "mse": parts["mse"].detach(),
                   "vb": parts["vb"].detach(), "grad_norm": gnorm}
        new_state = TrainState(step=state.step + 1, params=state.params, opt_state=opt_state)
        if loss_aware:
            return new_state, ema, metrics, update_fn(sampler_state, t, per)
        return new_state, ema, metrics

    return (step, sstate0) if loss_aware else step


def latent_batches(data_dir: str, batch_size: int):
    """(latents f32, labels) numpy batches of ``batch_size``, shard after
    shard, forever (the reference's input loop; a shard's tail short of a
    batch is skipped). Raises where no shard holds a whole batch (the
    reference's loop would spin)."""
    files = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
    if not files:
        raise FileNotFoundError(f"no .npz latent shards under {data_dir}")
    while True:
        n = 0
        for f in files:
            with np.load(f) as d:
                lat, lab = d["latents"], d["labels"]
            for i in range(0, len(lat) - batch_size + 1, batch_size):
                n += 1
                yield (lat[i:i + batch_size].astype(np.float32),
                       lab[i:i + batch_size].astype(np.int64))
        if not n:
            raise ValueError(f"no shard under {data_dir} holds a batch of {batch_size}")


def main(args, device="cuda"):
    """Train from ``args`` (``get_args_parser``) on ``device``; returns the
    final (TrainState, ema)."""
    from accessory_tpu_torch.checkpoint.native import save_checkpoint_trees
    from accessory_tpu_torch.dit.diffusion import GaussianDiffusion
    from accessory_tpu_torch.dit.model import DiTArgs, init_dit
    from accessory_tpu_torch.train.optim import make_optimizer
    from accessory_tpu_torch.train.train_step import TrainState
    from accessory_tpu_torch.train.tree import map_leaves
    from accessory_tpu_torch.util.logging import MetricLogger

    if args.model_parallel_size != 1:
        raise NotImplementedError("--model_parallel_size > 1: tensor parallelism waits for "
                                  "the parallel package (ROADMAP A10)")
    args_d = DiTArgs(input_size=args.input_size, dim=args.dim, n_layers=args.n_layers,
                     n_heads=args.n_heads, num_classes=args.num_classes)
    diffusion = GaussianDiffusion()
    params = init_dit(args.seed, args_d, device=device)
    with torch.no_grad():
        ema = map_leaves(lambda _, x: x.detach().to(torch.float32, copy=True), params)
    # optax.adamw's defaults (b1 0.9, b2 0.999, eps 1e-8) after the clip
    tx = make_optimizer(params, args.lr, weight_decay=0.0, betas=(0.9, 0.999),
                        clip_norm=args.clip_grad)
    state = TrainState.create(params, tx)
    loss_aware = args.schedule_sampler == "loss-second-moment"
    made = make_dit_train_step(args_d, diffusion, tx, schedule_sampler=args.schedule_sampler,
                               device=device, ema_decay=args.ema_decay)
    step, sampler_state = made if loss_aware else (made, None)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    logger = MetricLogger()
    os.makedirs(args.output_dir, exist_ok=True)
    for it, (lat, lab) in logger.log_every(latent_batches(args.data_dir, args.batch_size),
                                           args.log_every, "DiT", total=args.max_iters):
        if it >= args.max_iters:
            break
        lat = torch.from_numpy(lat).to(device)
        lab = torch.from_numpy(lab).to(device)
        if loss_aware:
            state, ema, metrics, sampler_state = step(state, ema, lat, lab, generator,
                                                      sampler_state=sampler_state)
        else:
            state, ema, metrics = step(state, ema, lat, lab, generator)
        logger.update(loss=float(metrics["loss"]), mse=float(metrics["mse"]))
        if (it + 1) % args.save_freq == 0:
            save_checkpoint_trees(os.path.join(args.output_dir, f"iter{it + 1}"),
                                  {"model": state.params, "ema": ema})
    return state, ema


if __name__ == "__main__":
    main(get_args_parser().parse_args())
