"""Decode steps captured as CUDA graphs and replayed.

The JAX package never runs a decode loop op by op: ``Generator`` jits
prefill and the whole decode loop into one program a key
(``_compiled_loop``), streaming jits its step (``_stream_step``) and
``ContinuousBatcher`` jits ``n_steps`` paged forwards a key (``_decode_fn``).
Here the engines capture their decode step once a key as a CUDA graph
(``torch.cuda.CUDAGraph``) and replay it: every kernel launch of a step,
the sampling and the stop matching go to the card as one graph launch, and
the host is left with the loop's bookkeeping. A step reads its inputs from
buffers that stay where they are (the engines copy new values in before a
replay) and takes its position from a device counter it advances, so the
host reads nothing inside a step.

``StepGraph`` captures under ``torch.cuda.set_sync_debug_mode("error")``:
a step that synchronizes with the host fails its capture, and a capture that
fails raises; nothing falls back to the eager route. The eager route is the
same step function called directly: on the CPU always, and on the card with
``compiled=False`` (the counterpart of ``jax.disable_jit()``).
"""

from __future__ import annotations

import gc
from typing import Callable, Iterable

import torch

from accessory_tpu_torch import kernels


def use_graphs(device, compiled: bool) -> bool:
    """Whether an engine on ``device`` replays captured steps: on the card,
    unless ``compiled=False``."""
    return bool(compiled) and torch.device(device).type == "cuda"


class GraphPool:
    """The memory pool an engine's captured steps share (all its keys), made
    at the first capture."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class StepGraph:
    """``step()`` captured once into a graph in ``pool`` (the engine's
    ``GraphPool``, which its keys share) and replayed by ``replay()``,
    which returns the tensors the capture returned (the same tensors each
    time, rewritten by each replay). ``generators``: the
    ``torch.Generator``s the step draws from, registered with the graph, so
    that a replay draws what the same step run eagerly draws. The launch
    counts the capture recorded are added at each replay
    (``kernels.count_replay``). The caller runs the step eagerly once before
    the first capture of a shape (every library built and loaded, every
    kernel's attributes set)."""

    def __init__(self, step: Callable[[], object], pool: GraphPool,
                 generators: Iterable[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        # thread_local: another thread's work (a server's handlers) neither
        # breaks this capture nor is refused while it runs
        capture = torch.cuda.graph(self.graph, pool=pool.handle(),
                                   capture_error_mode="thread_local")
        # no cyclic garbage collection inside the capture: an unreachable
        # engine's graph destroyed there (its exec, its pool's blocks) would
        # invalidate the capture (torch collects once before it begins)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with kernels.counting_capture() as recorded, capture:
                previous = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    self.outputs = step()
                finally:
                    torch.cuda.set_sync_debug_mode(previous)
        finally:
            if collecting:
                gc.enable()
        self.launches = recorded

    def replay(self):
        self.graph.replay()
        kernels.count_replay(self.launches)
        return self.outputs
