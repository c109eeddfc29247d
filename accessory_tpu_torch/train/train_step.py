"""The training step on one device.

Port of ``accessory_tpu/train/train_step.py`` (TrainState, partition_params,
make_train_step). The reference jits one function over a mesh and scans
microbatches; here the step runs eagerly: each microbatch's forward and
``backward()`` accumulate into the leaves' ``.grad``, then the optimizer
updates the trainable leaves in place (the reference returns new arrays;
in place keeps one copy of the masters in device memory).

Differentiated leaves are, as in the reference's ``partition_params``, every
floating tensor that is not a quantized weight: frozen dense leaves (the
embedding, the output head, norms without norm tuning) get gradients too,
which count in ``grad_norm`` and in the clip, and are not updated (their
optimizer label is "frozen"). QPEFT's W4 base gets none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from accessory_tpu_torch.models.llama import torch_dtype
from accessory_tpu_torch.train.loss import cross_entropy_loss
from accessory_tpu_torch.train.optim import global_norm
from accessory_tpu_torch.train.tree import map_leaves, named_leaves


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any

    @classmethod
    def create(cls, params, tx) -> "TrainState":
        partition_params(params)
        return cls(step=0, params=params, opt_state=tx.init(params))


def partition_params(params) -> Dict[str, torch.Tensor]:
    """{path: leaf} of the differentiated leaves (floating tensors, not
    quantized weights), each marked ``requires_grad``; the rest of the tree
    (W4 weights, integer arrays) is static."""
    diff = {}
    for path, leaf in named_leaves(params):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            leaf.requires_grad_(True)
            diff[path] = leaf
    return diff


def make_train_step(module, args, tx, remat=True, accum_steps: int = 1, ignore_index: int = 0,
                    moe_aux: bool = False, attn_fn=None, device="cuda"):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    batch: {"examples": (b, s) int, "labels": (b, s) int} (numpy or torch;
    moved to ``device``). With ``accum_steps > 1`` the batch splits into that
    many microbatches along its first axis; their gradients are summed and
    divided by ``accum_steps`` and their metrics averaged. Metrics: loss,
    c_loss, aux_loss, n_tokens and grad_norm, as 0-d tensors on the device."""
    if moe_aux:
        raise NotImplementedError("the MoE auxiliary loss: mixtral is not ported (ROADMAP A6)")
    if attn_fn is not None:
        raise NotImplementedError("attn_fn (context-parallel attention) waits for the "
                                  "parallel package (ROADMAP A10)")
    compute_dtype = torch_dtype(args.dtype)

    def _autocast(params):
        """f32 masters cast to the compute dtype inside the differentiated
        function, so the forward computes in the model's dtype and their
        gradients land in f32 (the reference's _autocast)."""
        if compute_dtype == torch.float32:
            return params
        return map_leaves(lambda _, x: x.to(compute_dtype) if isinstance(x, torch.Tensor)
                          and x.dtype == torch.float32 else x, params)

    def loss_fn(params, examples, labels):
        logits, _ = module.forward(_autocast(params), args, examples, remat=remat)
        return cross_entropy_loss(logits, labels, ignore_index)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        if batch.get("images") is not None:
            raise NotImplementedError("multimodal batches: the image families are not "
                                      "ported (ROADMAP A8)")
        examples, labels = (_ids(batch[k], device) for k in ("examples", "labels"))
        diff = partition_params(state.params)
        for p in diff.values():
            p.grad = None
        if examples.shape[0] % accum_steps:
            raise ValueError(f"batch {examples.shape[0]} does not split into {accum_steps} "
                             "microbatches")
        losses, counts = [], []
        for ex, lab in zip(examples.chunk(accum_steps), labels.chunk(accum_steps)):
            c_loss, n_tok = loss_fn(state.params, ex, lab)
            c_loss.backward()
            losses.append(c_loss.detach())
            counts.append(n_tok)
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in diff.items()}
        if accum_steps > 1:
            grads = {k: g / accum_steps for k, g in grads.items()}
            c_loss = torch.stack(losses).mean()
            n_tokens = torch.stack(counts).to(torch.float32).mean()
        else:
            c_loss, n_tokens = losses[0], counts[0]
        gnorm = global_norm(list(grads.values()))
        opt_state = tx.update(grads, state.opt_state, diff, grad_norm=gnorm)
        metrics = {"loss": c_loss, "c_loss": c_loss, "aux_loss": torch.zeros_like(c_loss),
                   "n_tokens": n_tokens, "grad_norm": gnorm}
        return TrainState(step=state.step + 1, params=state.params, opt_state=opt_state), metrics

    return train_step


def _ids(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=torch.long)


def grads_of(state: TrainState) -> Dict[str, torch.Tensor]:
    """{path: .grad} of the last step's differentiated leaves (summed over its
    microbatches, before the division by accum_steps and the clip)."""
    return {k: p.grad for k, p in named_leaves(state.params)
            if isinstance(p, torch.Tensor) and p.grad is not None}
