"""DiT sampling CLI: class-conditional generation with classifier-free
guidance.

Port of ``accessory_tpu/dit/sample.py`` (reference Large-DiT-ImageNet/
sample.py). Produces latents (decode them with a VAE offline), DDPM or
DDIM. ``main`` loads a checkpoint written by either package's DiT trainer
(its ``ema`` tree where there is one, else ``model``, else the whole
checkpoint) and writes ``latents`` to an .npz file.

Run: python -m accessory_tpu_torch.dit.sample --ckpt out/iter10000 --labels 1 2 3
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def get_args_parser():
    p = argparse.ArgumentParser("DiT sampling", add_help=False)
    p.add_argument("--ckpt", required=True, type=str)
    p.add_argument("--labels", nargs="*", type=int, default=[0])
    p.add_argument("--cfg_scale", default=4.0, type=float)
    p.add_argument("--sampler", choices=["ddpm", "ddim"], default="ddim")
    p.add_argument("--steps", default=50, type=int)
    p.add_argument("--out", default="samples.npz", type=str)
    p.add_argument("--seed", default=0, type=int)
    # model shape (must match ckpt)
    p.add_argument("--dim", default=1152, type=int)
    p.add_argument("--n_layers", default=28, type=int)
    p.add_argument("--n_heads", default=16, type=int)
    p.add_argument("--input_size", default=32, type=int)
    p.add_argument("--num_classes", default=1000, type=int)
    return p


def sample(params, args_d, labels, cfg_scale=4.0, sampler="ddim", steps=50, seed=0,
           device="cuda", x_T=None):
    """(len(labels), C, H, W) latents from noise drawn from ``seed`` on
    ``device`` (``x_T``: the starting noise instead), guided by
    ``cfg_scale``."""
    from accessory_tpu_torch.dit.diffusion import GaussianDiffusion, cfg_model_fn
    from accessory_tpu_torch.dit.model import dit_forward

    diffusion = GaussianDiffusion()
    y = torch.as_tensor(labels, dtype=torch.long, device=device)
    shape = (y.shape[0], args_d.in_channels, args_d.input_size, args_d.input_size)
    guided = cfg_model_fn(lambda x, t, yy: dit_forward(params, args_d, x, t, yy), cfg_scale,
                          args_d.num_classes)
    model_fn = lambda x, t: guided(x, t, y)  # noqa: E731
    generator = torch.Generator(device=device).manual_seed(seed)
    if sampler == "ddpm":
        return diffusion.p_sample_loop(model_fn, shape, generator, x_T=x_T, device=device)
    return diffusion.ddim_sample_loop(model_fn, shape, generator, steps=steps, x_T=x_T,
                                      device=device)


def load_dit_params(ckpt: str, args_d, device="cuda"):
    """A DiT checkpoint dir -> the port's params on ``device``: the ``ema``
    tree where there is one, else ``model``, else the whole checkpoint."""
    from accessory_tpu_torch.checkpoint.native import read_checkpoint_tree
    from accessory_tpu_torch.convert import params_from_jax

    tree = read_checkpoint_tree(ckpt)
    return params_from_jax(tree.get("ema", tree.get("model", tree)), args_d, device=device)


def main(args, device="cuda"):
    from accessory_tpu_torch.dit.model import DiTArgs

    args_d = DiTArgs(input_size=args.input_size, dim=args.dim, n_layers=args.n_layers,
                     n_heads=args.n_heads, num_classes=args.num_classes)
    params = load_dit_params(args.ckpt, args_d, device=device)
    lat = sample(params, args_d, args.labels, args.cfg_scale, args.sampler, args.steps,
                 args.seed, device=device)
    np.savez(args.out, latents=lat.float().cpu().numpy())
    print(f"wrote {len(args.labels)} samples to {args.out}")
    return lat


if __name__ == "__main__":
    main(get_args_parser().parse_args())
