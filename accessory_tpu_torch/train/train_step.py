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
optimizer label is "frozen"). QPEFT's W4 base gets none, and neither does a
frozen leaf of the ``visual`` subtree (the towers of the multimodal
families): no autograd graph is built through them. The ``visual`` subtree
keeps its f32 in the forward, where the trainable projections of
llama_qformerv2 train too (the JAX package differentiates the frozen
towers, counts them in ``grad_norm`` and casts every f32 leaf to the
compute dtype; ROADMAP, "Deliberate differences").

A batch with ``images`` (b, 3, S, S) hands each microbatch its rows of
them, and the loss passes them to the model's forward (the SPHINX families,
SPHINX-MoE, llama_qformerv2, LLaMA-Adapter with its visual branch), whose
cache-free logits are the text positions'.

``moe_aux`` (Mixtral and SPHINX-MoE): the forward also returns the
load-balancing loss summed over the layers, and the differentiated loss is
c_loss + aux, as the reference's (its metrics report both).

With ``attn_fn`` from ``parallel.make_cp_attn_fn(mesh)`` (the only attn_fn it
takes: the mesh it carries decides each rank's slice) the step is
context-parallel (the reference jits it over the mesh with the batch and the
sequence sharded): each rank takes its dp slice of the batch's rows and its cp
slice of the sequence, and attention gathers the rest (parallel/context.py).
The labels are shifted once on the whole sequence (the last position
ignored) and scored unshifted, so no label is lost at a shard boundary; each
microbatch's loss is normalized by its token count summed over dp x cp, the
global mean; the gradients are summed over dp x cp (not tp, whose ranks hold
equal ones) before the norm and the update, flattened into buckets of at most
2**27 elements a dtype (one all-reduce a bucket and group, not one a leaf), so
every rank keeps the same parameters. Metrics are the global ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from accessory_tpu_torch.models.llama import torch_dtype
from accessory_tpu_torch.parallel.context import CPAttention, seq_shard
from accessory_tpu_torch.parallel.mesh import axis_rank, axis_size
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
        partition_params(params, frozen_paths(tx))
        return cls(step=0, params=params, opt_state=tx.init(params))


def _visual(path: str) -> bool:
    return path.startswith("visual/")


def frozen_paths(tx):
    """The paths ``tx`` (``make_optimizer``'s AdamW) labels "frozen"."""
    return {p for p, lab in getattr(tx, "labels", {}).items() if lab == "frozen"}


def partition_params(params, frozen=()) -> Dict[str, torch.Tensor]:
    """{path: leaf} of the differentiated leaves (floating tensors, not
    quantized weights, not a ``visual`` leaf in ``frozen``), each marked
    ``requires_grad``; the rest of the tree (W4 weights, integer arrays,
    the frozen towers, unmarked) is static."""
    diff = {}
    for path, leaf in named_leaves(params):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            differentiated = not (_visual(path) and path in frozen)
            leaf.requires_grad_(differentiated)
            if differentiated:
                diff[path] = leaf
    return diff


def make_train_step(module, args, tx, remat=True, accum_steps: int = 1, ignore_index: int = 0,
                    moe_aux: bool = False, attn_fn=None, device="cuda"):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    batch: {"examples": (b, s) int, "labels": (b, s) int} (numpy or torch;
    moved to ``device``), and for a multimodal family optionally "images"
    (b, 3, S, S) CLIP-normalized (not with a cp ``attn_fn``, ROADMAP A10).
    With ``accum_steps > 1`` the batch splits into that many microbatches
    along its first axis; their gradients are summed and divided by
    ``accum_steps`` and their metrics averaged. Metrics: loss (c_loss +
    aux_loss), c_loss, aux_loss (0 without ``moe_aux``), n_tokens and
    grad_norm, as 0-d tensors on the device. ``attn_fn``: None, or
    ``parallel.make_cp_attn_fn(mesh)``, which makes the step context-parallel
    over its mesh (see above); any other raises. ``moe_aux`` under a mesh of
    more than one dp x cp rank raises: the reference's balance loss is taken
    over the global tokens, and a rank's shard gives another number."""
    compute_dtype = torch_dtype(args.dtype)
    layout = None if attn_fn is None else _CPLayout.of(attn_fn)
    if moe_aux and layout is not None and layout.dp * layout.cp > 1:
        raise NotImplementedError("moe_aux under a context-parallel mesh of more than one "
                                  "rank: the load-balancing loss over the global tokens waits "
                                  "for the parallel package (ROADMAP A10)")
    frozen = frozen_paths(tx)

    def _autocast(params):
        """f32 masters cast to the compute dtype inside the differentiated
        function, so the forward computes in the model's dtype and their
        gradients land in f32 (the reference's _autocast); the ``visual``
        subtree stays f32."""
        if compute_dtype == torch.float32:
            return params
        return map_leaves(lambda path, x: x.to(compute_dtype) if isinstance(x, torch.Tensor)
                          and x.dtype == torch.float32 and not _visual(path) else x, params)

    def forward(params, examples, **kw):
        """(logits, the aux loss or None)."""
        if moe_aux:
            logits, _, aux = module.forward(_autocast(params), args, examples, remat=remat,
                                            with_aux_loss=True, **kw)
            return logits, aux
        return module.forward(_autocast(params), args, examples, remat=remat, **kw)[0], None

    def loss_fn(params, examples, labels, images=None):
        """(c_loss, aux or None, n_tokens)."""
        if layout is None:
            logits, aux = forward(params, examples,
                                  **({} if images is None else {"images": images}))
            c_loss, n_tok = cross_entropy_loss(logits, labels, ignore_index)
            return c_loss, aux, n_tok
        ex, lab, start = layout.shard(examples, labels, ignore_index)
        logits, aux = forward(params, ex, attn_fn=attn_fn, cur_pos=start)
        loss, n_tok = cross_entropy_loss(logits, lab, ignore_index, shift=False)
        n_all = layout.sum(n_tok.clone())
        # this rank's share of the global mean (the factor is 1 on one rank)
        return loss * (n_tok.clamp_min(1) / n_all.clamp_min(1)), aux, n_all

    def train_step(state: TrainState, batch: Dict[str, Any]):
        images = batch.get("images")
        if images is not None and layout is not None:
            raise NotImplementedError("images under a context-parallel mesh: the image "
                                      "words' split over the sequence shards waits for the "
                                      "parallel package (ROADMAP A10)")
        examples, labels = (_ids(batch[k], device) for k in ("examples", "labels"))
        diff = partition_params(state.params, frozen)
        for p in diff.values():
            p.grad = None
        if examples.shape[0] % accum_steps:
            raise ValueError(f"batch {examples.shape[0]} does not split into {accum_steps} "
                             "microbatches")
        image_chunks = ((None,) * accum_steps if images is None
                        else _images(images, device).chunk(accum_steps))
        losses, auxes, counts = [], [], []
        for ex, lab, img in zip(examples.chunk(accum_steps), labels.chunk(accum_steps),
                                image_chunks):
            c_loss, aux, n_tok = loss_fn(state.params, ex, lab, img)
            (c_loss if aux is None else c_loss + aux).backward()
            losses.append(c_loss.detach())
            auxes.append(torch.zeros_like(losses[-1]) if aux is None else aux.detach())
            counts.append(n_tok)
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in diff.items()}
        if layout is not None:
            layout.sum_all(list(grads.values()))
            losses = list(layout.sum(torch.stack(losses)))
        if accum_steps > 1:
            # the reference's scan: each metric the f32 mean of the microbatches'
            grads = {k: g / accum_steps for k, g in grads.items()}
            totals = [c + a for c, a in zip(losses, auxes)]
            loss, c_loss, aux_loss, n_tokens = (torch.stack(m).to(torch.float32).mean()
                                                for m in (totals, losses, auxes, counts))
        else:
            c_loss, aux_loss, n_tokens = losses[0], auxes[0], counts[0]
            loss = c_loss + aux_loss
        gnorm = global_norm(list(grads.values()))
        opt_state = tx.update(grads, state.opt_state, diff, grad_norm=gnorm)
        metrics = {"loss": loss, "c_loss": c_loss, "aux_loss": aux_loss,
                   "n_tokens": n_tokens, "grad_norm": gnorm}
        return TrainState(step=state.step + 1, params=state.params, opt_state=opt_state), metrics

    return train_step


class _CPLayout:
    """Where a context-parallel rank sits on its mesh: its dp slice of the
    batch rows, its cp slice of the sequence, and the groups that sum over
    dp x cp."""

    BUCKET = 1 << 27          # elements of one gradient all-reduce (512 MiB of f32)

    def __init__(self, mesh, cp_axis: str):
        if axis_size(mesh, "fsdp") > 1 or axis_size(mesh, "ep") > 1:
            raise NotImplementedError("fsdp / ep mesh axes: FSDP and expert sharding of the "
                                      "model wait (ROADMAP A10)")
        self.dp, self.cp = axis_size(mesh, "dp"), axis_size(mesh, cp_axis)
        self.dp_rank, self.cp_rank = axis_rank(mesh, "dp"), axis_rank(mesh, cp_axis)
        self.groups = [mesh.get_group(a) for a in ("dp", cp_axis) if axis_size(mesh, a) > 1]

    @classmethod
    def of(cls, attn_fn) -> "_CPLayout":
        if not isinstance(attn_fn, CPAttention):
            raise TypeError(f"make_train_step: attn_fn {attn_fn!r} is not one of "
                            "parallel.make_cp_attn_fn(mesh): the step slices each rank's batch "
                            "and sequence by the mesh that carries")
        return cls(attn_fn.mesh, attn_fn.cp_axis)

    def shard(self, examples: torch.Tensor, labels: torch.Tensor, ignore_index: int):
        """This rank's rows and positions and its first position; labels
        shifted on the whole sequence first (label t = the token at t + 1;
        the last ignored)."""
        b, s = examples.shape
        shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], ignore_index)], 1)
        rows, cols = seq_shard(b, self.dp, self.dp_rank), seq_shard(s, self.cp, self.cp_rank)
        return examples[rows, cols], shifted[rows, cols], cols.start

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) over dp x cp, in place; returns t."""
        for group in self.groups:
            dist.all_reduce(t, group=group)
        return t

    def sum_all(self, tensors) -> None:
        """``sum`` of every tensor, in place: same-dtype tensors flattened into
        buckets of at most ``BUCKET`` elements (a larger one alone), one
        all-reduce a bucket and group."""
        if not self.groups:
            return
        buckets, size = {}, {}
        for t in tensors:
            key = t.dtype
            if not buckets.get(key) or size[key] + t.numel() > self.BUCKET:
                buckets.setdefault(key, []).append([])
                size[key] = 0
            buckets[key][-1].append(t)
            size[key] += t.numel()
        for ts in (b for per_dtype in buckets.values() for b in per_dtype):
            flat = self.sum(torch.cat([t.reshape(-1) for t in ts]))
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))


def _images(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=torch.float32)


def _ids(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=torch.long)


def grads_of(state: TrainState) -> Dict[str, torch.Tensor]:
    """{path: .grad} of the last step's differentiated leaves (summed over its
    microbatches, before the division by accum_steps and the clip)."""
    return {k: p.grad for k, p in named_leaves(state.params)
            if isinstance(p, torch.Tensor) and p.grad is not None}
