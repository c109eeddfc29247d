"""Sandboxed execution and pass@k for HumanEval-style code benchmarks.

A copy of ``accessory_tpu/eval/code_exec.py`` (it holds no JAX; the port
keeps its own copy and imports nothing of the JAX package). Role of the
reference's light-eval/src/eval_utils/humaneval_evaluation.py (the OpenAI
human-eval harness): run each candidate program against the task's test
suite in an isolated ``python3`` subprocess with a wall-clock timeout, then
compute the unbiased pass@k estimator over n samples with c correct.

Isolation: each check runs ``python -I -c <program>`` in a fresh subprocess
with a scratch cwd and a short timeout, so a crash, an infinite loop, or
stdin/stdout abuse in generated code cannot take down the evaluator. (This
is an evaluation sandbox, not a security boundary; run untrusted-model
evals in a container, as the reference harness also advises.)
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List

import numpy as np


def check_program(program: str, timeout: float = 3.0) -> bool:
    """Run ``program`` in a subprocess; True iff it exits 0 in time."""
    with tempfile.TemporaryDirectory() as tmp:
        try:
            # -I (isolated): ignore PYTHONPATH/user site — keeps repo and
            # environment sitecustomize out of the candidate's namespace
            # (and off its startup time)
            proc = subprocess.run(
                [sys.executable, "-I", "-c", program],
                cwd=tmp, timeout=timeout,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                stdin=subprocess.DEVNULL)
            return proc.returncode == 0
        except subprocess.TimeoutExpired:
            return False
        except OSError:
            return False


def build_test_program(prompt: str, completion: str, test: str,
                       entry_point: str) -> str:
    """HumanEval task -> self-checking program (prompt + body + tests +
    check(entry_point) call)."""
    return (prompt + completion + "\n\n" + test + "\n"
            + f"check({entry_point})\n")


def estimate_pass_at_k(n: int, c: int, k: int) -> float:
    """Unbiased pass@k: 1 - C(n-c, k)/C(n, k) (Codex paper, eq. 1)."""
    if n - c < k:
        return 1.0
    return float(1.0 - np.prod(1.0 - k / np.arange(n - c + 1, n + 1)))


def evaluate_functional_correctness(
    samples: Iterable[Dict],     # {task_id, completion}
    problems: Dict[str, Dict],   # task_id -> {prompt, test, entry_point}
    ks: List[int] = (1,),
    n_workers: int = 4,
    timeout: float = 3.0,
) -> Dict[str, float]:
    """Execute every sample; return {"pass@k": ...} over tasks."""
    samples = list(samples)

    def run(sample):
        prob = problems[sample["task_id"]]
        prog = build_test_program(prob["prompt"], sample["completion"],
                                  prob["test"], prob["entry_point"])
        return sample["task_id"], check_program(prog, timeout)

    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        results = list(ex.map(run, samples))

    by_task: Dict[str, List[bool]] = {}
    for task_id, ok in results:
        by_task.setdefault(task_id, []).append(ok)

    out = {}
    for k in ks:
        vals = [estimate_pass_at_k(len(v), sum(v), k)
                for v in by_task.values() if len(v) >= k]
        out[f"pass@{k}"] = float(np.mean(vals)) if vals else 0.0
    out["total"] = len(by_task)
    return out
