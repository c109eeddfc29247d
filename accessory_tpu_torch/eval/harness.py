"""Evaluation primitives: perplexity, multiple choice, generation accuracy.

Port of ``accessory_tpu/eval/harness.py``. The forwards run as they are (the
reference wraps them in ``jax.jit``): ``perplexity`` is the model's
cache-free forward of ``seq_len`` tokens (on the card: row 3's flash
attention and row 5's many-row W4 product at 1024 rows or more, row 1's
tile below), ``multiple_choice`` scores through ``evaluate_examples`` and
``generation_eval`` generates through the Generator.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch


@torch.no_grad()
def perplexity(model, text: str, seq_len: int = 2048, stride: Optional[int] = None,
               max_windows: Optional[int] = None) -> float:
    """Sliding-window perplexity of ``text`` (WikiText-2/C4 protocol: encode
    the whole corpus, score windows of seq_len with the given stride, count
    each token once via the non-overlapping tail)."""
    stride = stride or seq_len
    ids = np.asarray(model.tokenizer.encode(text, bos=True, eos=False), np.int64)
    total_lp, total_n = 0.0, 0
    n_windows = 0
    for start in range(0, max(len(ids) - 1, 1), stride):
        window = ids[start: start + seq_len]
        if len(window) < 2:
            break
        pad = seq_len - len(window)
        chunk = np.pad(window, (0, pad)) if pad else window
        toks = torch.from_numpy(chunk[None]).to(model.device)
        logits = model.module.forward(model.params, model.args, toks)[0]
        logp = torch.log_softmax(logits[0, : len(window) - 1].to(torch.float32), -1)
        tgt = torch.from_numpy(window[1:]).to(model.device)
        tok_lp = torch.gather(logp, 1, tgt[:, None])[:, 0]
        # only count tokens not scored by the previous window
        new_from = 0 if start == 0 else seq_len - stride
        total_lp += float(torch.sum(tok_lp[new_from:]))
        total_n += int(tok_lp.shape[0] - new_from)
        n_windows += 1
        if max_windows and n_windows >= max_windows:
            break
        if start + seq_len >= len(ids):
            break
    return float(np.exp(-total_lp / max(total_n, 1)))


def multiple_choice(model, items: Iterable[Dict], choices_key: str = "choices",
                    question_key: str = "question", answer_key: str = "answer"
                    ) -> Dict[str, float]:
    """Loglikelihood-ranked multiple choice (MMLU-style): pick the choice
    with the highest loglikelihood given the question context. Every item x
    choice scoring goes through one ``evaluate_examples`` call, which
    batches them by length bucket."""
    items = list(items)
    ctxs, conts, offsets = [], [], [0]
    for item in items:
        for choice in item[choices_key]:
            ctxs.append(item[question_key])
            conts.append(" " + str(choice))
        offsets.append(len(ctxs))
    res = model.evaluate_examples(ctxs, conts)
    correct = total = 0
    for j, item in enumerate(items):
        lls = [r["loglikelihood"] for r in res[offsets[j]:offsets[j + 1]]]
        pred = int(np.argmax(lls))
        ans = item[answer_key]
        if isinstance(ans, str) and len(ans) == 1 and ans.isalpha():
            ans = ord(ans.upper()) - ord("A")
        correct += int(pred == int(ans))
        total += 1
    return {"accuracy": correct / max(total, 1), "total": total}


_NUM_RE = re.compile(r"-?\d[\d,]*(?:\.\d+)?")


def extract_last_number(text: str) -> Optional[str]:
    """GSM8K-style answer extraction (the last number in the generation)."""
    nums = _NUM_RE.findall(text)
    return nums[-1].replace(",", "") if nums else None


def generation_eval(model, items: Iterable[Dict], prompt_fn: Callable[[Dict], str],
                    target_fn: Callable[[Dict], str],
                    extract_fn: Callable[[str], Optional[str]] = extract_last_number,
                    max_gen_len: int = 256, batch_size: int = 8,
                    stop_symbols: Sequence[str] = ()) -> Dict[str, float]:
    """Generate answers and compare extracted values (GSM8K/MATH style)."""
    items = list(items)
    correct = 0
    for i in range(0, len(items), batch_size):
        batch = items[i: i + batch_size]
        outs = model.generate([prompt_fn(b) for b in batch], max_gen_len=max_gen_len,
                              additional_stop_symbols=tuple(stop_symbols))
        for item, out in zip(batch, outs):
            pred = extract_fn(out)
            tgt = extract_fn(target_fn(item)) or target_fn(item)
            correct += int(pred is not None and str(pred) == str(tgt))
    return {"accuracy": correct / max(len(items), 1), "total": len(items)}
