"""Named leaves of a params tree (dicts and per-layer lists). Paths join keys
and layer indices with "/", e.g. ``layers/3/attention/wq/lora_a``: the
reference's names with the layer index where its stacked tree has none, so
its name predicates (trainable filters, decay labels) read the same."""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def map_leaves(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """The tree with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
