"""Evaluation harness of the port. Port of ``accessory_tpu/eval``: the three
primitives the benchmark drivers compose (``perplexity``, ``multiple_choice``,
``generation_eval``; ``harness``), the light-eval task drivers (``tasks``:
BBH, MATH, HumanEval, C-Eval, CMMLU), their CLI (``run_eval``), the
multimodal drivers over SPHINX (``eval_mm``), and the framework-free
``math_util`` and ``code_exec``, of which the port keeps its own copies."""

from accessory_tpu_torch.eval.harness import (  # noqa: F401
    generation_eval,
    multiple_choice,
    perplexity,
)
