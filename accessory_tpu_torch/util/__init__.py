"""Host-side utilities of the port: the KV-dtype and remat policies, and the
per-layer memo a checkpointed layer's recompute replays."""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Iterator, Optional

from torch.utils.checkpoint import checkpoint


def resolve_kv_dtype(kv_dtype: Optional[str]) -> Optional[str]:
    """The KV-cache dtype policy: an explicit ``kv_dtype`` wins ("int8" / "i8"
    for the int8 cache; "fp", "bf16" or "bfloat16" for the activation dtype),
    and ``None`` means the activation dtype. Returns "int8" or None.

    Port of ``accessory_tpu/util/__init__.py::resolve_kv_dtype`` without its
    environment variable and without its backend rule: the JAX package turns
    int8 on by default on its own accelerator from measurements taken there;
    on this port int8 is opt-in."""
    if kv_dtype in ("int8", "i8"):
        return "int8"
    if kv_dtype in (None, "fp", "bf16", "bfloat16"):
        return None
    raise ValueError(f"kv_dtype={kv_dtype!r}: expected None, 'fp', 'bf16' or 'int8'")


class LayerMemo:
    """What a checkpointed layer's forward keeps for its recompute: for each
    kind in ``keep`` the values ``replayed`` computed, in call order."""

    def __init__(self, keep):
        self.keep = frozenset(keep)
        self.store = {}
        self.pos = {}


_memo: Optional[LayerMemo] = None


@contextlib.contextmanager
def replaying(memo: LayerMemo) -> Iterator[LayerMemo]:
    """Within the block ``replayed`` records into ``memo`` (a first run) or
    takes back from it in the same order (a later run: the recompute)."""
    global _memo
    prev, _memo = _memo, memo
    memo.pos = {}
    try:
        yield memo
    finally:
        _memo = prev


def keeps(kind: str) -> bool:
    """Whether an open ``replaying`` memo keeps ``kind``."""
    return _memo is not None and kind in _memo.keep


def replayed(kind: str, compute: Callable[[], Any], replay: Optional[Callable] = None):
    """``compute()``, kept under ``kind`` when an open ``replaying`` memo keeps
    that kind; in a later run the kept value (passed through ``replay``
    where given) instead of computing it."""
    memo = _memo
    if not keeps(kind):
        return compute()
    kept = memo.store.setdefault(kind, [])
    i = memo.pos.get(kind, 0)
    memo.pos[kind] = i + 1
    if i < len(kept):
        return kept[i] if replay is None else replay(kept[i])
    out = compute()
    kept.append(_detach(out))
    return out


def _detach(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_detach(v) for v in x)
    return x.detach() if hasattr(x, "detach") else x


def checkpoint_layer(fn: Callable, *args, keep=("route",)):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args)`` with a
    ``LayerMemo`` of its own: the forward keeps what ``keep`` names, and the
    recompute in the backward takes it back (``replayed``)."""
    memo = LayerMemo(keep)

    def run(*a):
        with replaying(memo):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)


def remat_policy(remat) -> Optional[Callable]:
    """How the training forward checkpoints a layer: None (``remat`` False:
    keep every activation) or ``checkpoint_layer``, which keeps the layer's
    input and runs its forward again in the backward.

    Port of ``accessory_tpu/util/__init__.py::remat_policy``. ``"full"``
    saves nothing inside the layer: its whole forward runs again. ``True`` /
    ``"dots"`` is the reference's selective policy (``dots_with_no_batch_dims``
    plus the named splash output): the layer's forward keeps the outputs of
    its dense 2-D products (``ops.linear.linear`` over a dense weight: the
    bf16 linears and the LoRA products) and of the flash forward (its
    output and lse), which the recompute takes back instead of computing;
    norms, RoPE, SwiGLU, casts, the MoE layer's expert products and the W4
    products (whose kernels are no dot to the reference's policy either)
    are recomputed. Under both a MoE layer's recompute takes the forward's
    routing (``ops.moe``, kind "route"), so it launches the same experts.
    The memo is a list a layer, not a dispatcher mode: a selective
    checkpoint through ``create_selective_checkpoint_contexts`` sends every
    op through Python and ran the 7B QPEFT step 2.5x slower than full
    recompute on the H100 (PERF.md, Findings)."""
    if remat is None or remat is False:
        return None
    if remat == "full":
        return functools.partial(checkpoint_layer, keep=("route",))
    if remat is True or remat == "dots":
        return functools.partial(checkpoint_layer, keep=("route", "flash", "dots"))
    raise ValueError(f"remat={remat!r}: expected False, True, 'dots' or 'full'")
