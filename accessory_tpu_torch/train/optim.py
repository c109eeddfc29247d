"""AdamW with weight-decay groups, frozen leaves and a global-norm clip.

Port of ``accessory_tpu/train/optim.py``. The reference builds the optimizer
from optax (``clip_by_global_norm`` masked to float leaves, then
``multi_transform`` of ``adamw(b1, b2, eps=1e-8)`` per label with "frozen"
set to zero); optax does not run on the card's machine, so the same
arithmetic is written out here, op for op:

  clip   g <- (g / norm) * clip_norm unless norm < clip_norm, with norm the
         global L2 norm of every differentiated leaf's gradient (frozen float
         leaves included, as the reference differentiates them);
  adam   mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu;
         u = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps),  n = count + 1;
  decay  u <- u + wd * p ("decay" leaves only);
  step   p <- p + (-lr(count)) * u, the schedule read at the count before
         this update;
  chain  each transform of ``chain(tx, ...)`` (``scale_lr_by_prefix``) maps
         the update (-lr(count)) * u before it is added, as optax.chain
         applies the transforms after adamw.

This is optax's order, decay added to the Adam direction after the moments;
``torch.optim.AdamW`` shrinks p before the moments instead (equal in exact
arithmetic, not in f32 rounding), so it is not used: the optax form holds the
reference to 1e-6 relative (tests/test_torch_train_ops.py). The update runs
as ``torch._foreach_*`` ops, each rounding as its per-tensor twin does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch

from accessory_tpu_torch.quant.qtensor import QuantizedWeight
from accessory_tpu_torch.train.tree import named_leaves

def param_label_fn(params, trainable: Optional[Callable[[str], bool]] = None
                   ) -> Dict[str, str]:
    """{path: "decay" | "no_decay" | "frozen"} for every leaf.

    frozen: ``trainable(path)`` False, or a quantized weight (QPEFT never
    trains the W4 base); no_decay: biases and norms (by name) and leaves of
    ndim <= 1; decay: the rest."""
    labels = {}
    for name, leaf in named_leaves(params):
        if (trainable is not None and not trainable(name)) or isinstance(leaf, QuantizedWeight):
            labels[name] = "frozen"
        elif "bias" in name or "norm" in name or getattr(leaf, "ndim", 0) <= 1:
            labels[name] = "no_decay"
        else:
            labels[name] = "decay"
    return labels


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every gradient's sum of squares (each leaf's sum
    in its own dtype, as optax.global_norm)."""
    return torch.sqrt(sum((g * g).sum() for g in grads))


class AdamW:
    """``make_optimizer``'s result: ``init(params)`` gives the state,
    ``update(grads, state, params)`` updates the trainable leaves in place."""

    def __init__(self, labels: Dict[str, str], lr_fn: Union[Callable[[int], float], float],
                 weight_decay: float, betas, eps: float, clip_norm: Optional[float]):
        self.labels = labels
        self.lr_fn = lr_fn
        self.weight_decay = weight_decay
        self.b1, self.b2 = betas
        self.eps = eps
        self.clip_norm = clip_norm
        self.transforms = []        # update maps added by ``chain``

    def lr(self, count: int) -> float:
        return float(self.lr_fn(count)) if callable(self.lr_fn) else float(self.lr_fn)

    def init(self, params) -> dict:
        """{"count": updates so far, "mu" / "nu": {path: zeros like the leaf}}
        for the decay and no_decay leaves; frozen leaves hold no state."""
        leaves = dict(named_leaves(params))
        train = [p for p, lab in self.labels.items() if lab != "frozen"]
        return {"count": 0,
                "mu": {p: torch.zeros_like(leaves[p]) for p in train},
                "nu": {p: torch.zeros_like(leaves[p]) for p in train}}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor], grad_norm: Optional[torch.Tensor] = None
               ) -> dict:
        """One step. ``grads`` / ``params``: {path: tensor} of every
        differentiated leaf (frozen float leaves too: their gradients count
        in the clip's norm, as in the reference, and are then dropped);
        ``grad_norm``: their global norm when the caller has it. Updates the
        trainable params in place and returns the new state."""
        count = state["count"]
        scale = None
        if self.clip_norm is not None:
            norm = global_norm(list(grads.values())) if grad_norm is None else grad_norm
            if not float(norm) < self.clip_norm:
                scale = float(norm)
        lr = self.lr(count)
        b1, b2, n = self.b1, self.b2, count + 1
        f32 = torch.float32
        bc1 = float(1 - torch.tensor(b1, dtype=f32) ** float(n))
        bc2 = float(1 - torch.tensor(b2, dtype=f32) ** float(n))
        mu_all, nu_all = dict(state["mu"]), dict(state["nu"])
        for label, wd in (("decay", self.weight_decay), ("no_decay", 0.0)):
            paths = [p for p in mu_all if self.labels[p] == label]
            if not paths:
                continue
            ps = [params[p] for p in paths]
            gs = [grads[p] for p in paths]
            if scale is not None:
                gs = torch._foreach_mul(torch._foreach_div(gs, scale), self.clip_norm)
            mu = torch._foreach_add(torch._foreach_mul(gs, 1 - b1),
                                    torch._foreach_mul([mu_all[p] for p in paths], b1))
            nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2),
                                    torch._foreach_mul([nu_all[p] for p in paths], b2))
            u = torch._foreach_div(torch._foreach_div(mu, bc1),
                                   torch._foreach_add(torch._foreach_sqrt(
                                       torch._foreach_div(nu, bc2)), self.eps))
            if wd:
                u = torch._foreach_add(u, torch._foreach_mul(ps, wd))
            step = torch._foreach_mul(u, -lr)
            for transform in self.transforms:
                step = transform(paths, step)
            torch._foreach_add_(ps, step)
            mu_all.update(zip(paths, mu))
            nu_all.update(zip(paths, nu))
        return {"count": n, "mu": mu_all, "nu": nu_all}


def make_optimizer(params, lr_fn: Union[Callable[[int], float], float],
                   weight_decay: float = 0.02, betas=(0.9, 0.95),
                   clip_norm: Optional[float] = None,
                   trainable: Optional[Callable[[str], bool]] = None) -> AdamW:
    """AdamW (b1, b2 = ``betas``, eps 1e-8) with the decay / no_decay /
    frozen split of ``param_label_fn`` and an optional global-norm clip."""
    return AdamW(param_label_fn(params, trainable), lr_fn, weight_decay, betas, 1e-8,
                 clip_norm)


def chain(tx: AdamW, *transforms) -> AdamW:
    """``tx`` with ``transforms`` applied in order to each update after AdamW
    (optax.chain(tx, *transforms)); each maps (paths, updates) -> updates."""
    tx.transforms = list(tx.transforms) + list(transforms)
    return tx


class _PrefixScale:
    """``scale_lr_by_prefix``'s transform: each update times its path's scale."""

    def __init__(self, lr_scales: Dict[str, float]):
        self.lr_scales = dict(lr_scales)
        self.prefixes = sorted(lr_scales, key=len, reverse=True)

    def scale_of(self, path: str) -> float:
        for pre in self.prefixes:
            if path.startswith(pre):
                return float(self.lr_scales[pre])
        return 1.0

    def __call__(self, paths: Sequence[str], updates):
        out = []
        for path, u in zip(paths, updates):
            scale = self.scale_of(path)
            out.append(u if scale == 1.0 else u * scale)
        return out


def scale_lr_by_prefix(params, lr_scales: Dict[str, float]) -> _PrefixScale:
    """Per-group LR scaling keyed on param-path prefixes (the reference's
    layer-wise LR groups, accessory/util/param_group.py): ``lr_scales``
    {path prefix: scale}, the longest matching prefix wins, default 1. Chain
    it after the optimizer: ``chain(make_optimizer(...), scale_lr_by_prefix(
    params, scales))``. Paths are the port's (``train.tree``: a layer's index
    in its path, ``layers/3/...``). ``params`` is unused, as in the
    reference."""
    return _PrefixScale(lr_scales)
