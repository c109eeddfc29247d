"""light-eval task drivers: BBH, MATH, HumanEval, C-Eval, CMMLU.

Port of ``accessory_tpu/eval/tasks.py`` (role of the reference's light-eval/
src/eval_{bbh,math,humaneval,ceval,cmmlu}.py): the same data formats,
prompt construction, answer extraction and scoring, batched through the
port's Generator (whose decode steps replay as CUDA graphs on the card).
C-Eval and CMMLU score first-token logits from the cache-free forward, over
the reference's bucketed, fixed-batch padding (``_first_token_choices``).

Data directory layouts (reference-compatible):
  BBH:      <data>/bbh/<task>.json + <data>/cot-prompts/<task>.txt
  MATH:     <data>/math/test.jsonl  (fields: problem, solution)  [or *.jsonl]
  HumanEval:<data>/HumanEval.jsonl  (task_id, prompt, test, entry_point)
  C-Eval:   <data>/ceval/val/<subj>_val.csv + dev/<subj>_dev.csv
  CMMLU:    <data>/cmmlu/test/<subj>.csv + dev/<subj>.csv
"""

from __future__ import annotations

import csv
import glob
import json
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# BBH (reference eval_bbh.py)

BBH_MULTIPLE_CHOICE_TASKS = [
    "temporal_sequences", "disambiguation_qa", "date_understanding",
    "tracking_shuffled_objects_three_objects", "penguins_in_a_table",
    "geometric_shapes", "snarks", "ruin_names",
    "tracking_shuffled_objects_seven_objects",
    "tracking_shuffled_objects_five_objects",
    "logical_deduction_three_objects", "hyperbaton",
    "logical_deduction_five_objects", "logical_deduction_seven_objects",
    "movie_recommendation", "salient_translation_error_detection",
    "reasoning_about_colored_objects",
]
BBH_FREE_FORM_TASKS = [
    "multistep_arithmetic_two", "navigate", "dyck_languages", "word_sorting",
    "sports_understanding", "boolean_expressions", "object_counting",
    "formal_fallacies", "causal_judgement", "web_of_lies",
]


def bbh_extract_ans(ans: str, mode: str) -> str:
    """Reference eval_bbh.extract_ans: cut at the next 'Q:', take the text
    after 'answer is'; MC answers reduce to the letter."""
    ans_line = re.split("Q:", ans, flags=re.IGNORECASE)[0]
    parts = re.split("answer is ", ans_line, flags=re.IGNORECASE)
    if len(parts) == 1:
        return ans
    ans = parts[-1].strip()
    if mode == "multiple_choice":
        m = re.search(r"\(([A-Z])\)*", ans) or re.search(r"([A-Z])", ans)
        return m.group(1) if m else ans
    return re.split(r"[.#]", ans)[0]


def _resize_prompt(tokenizer, max_ctx: int, prompt: str,
                   reserve: int = 1024) -> str:
    """Drop few-shot examples until the prompt fits (reference
    resize_prompt): examples are the \\n\\n-separated blocks after the
    instruction line."""
    while len(tokenizer.encode(prompt, bos=True, eos=False)) + 1 > \
            max_ctx - reserve:
        parts = prompt.split("\n\n")
        if len(parts) <= 2:
            break
        parts.pop(1)
        prompt = "\n\n".join(parts)
    return prompt


def eval_bbh(model, data_dir: str, tasks: Optional[Sequence[str]] = None,
             batch_size: int = 8, max_gen_len: int = 1024,
             limit: Optional[int] = None) -> Dict:
    """Few-shot CoT BBH; returns per-task and average accuracy."""
    all_tasks = tasks or (BBH_MULTIPLE_CHOICE_TASKS + BBH_FREE_FORM_TASKS)
    scores = {}
    for task in all_tasks:
        fp = os.path.join(data_dir, "bbh", f"{task}.json")
        pp = os.path.join(data_dir, "cot-prompts", f"{task}.txt")
        if not (os.path.exists(fp) and os.path.exists(pp)):
            continue
        mode = ("multiple_choice" if task in BBH_MULTIPLE_CHOICE_TASKS
                else "free_form")
        with open(pp) as f:
            task_prompt = "".join(f.readlines()[2:])  # drop the header lines
        examples = json.load(open(fp))["examples"]
        if limit:
            examples = examples[:limit]
        prompts, answers = [], []
        for item in examples:
            full = (task_prompt + "\n\nQ: " + item["input"]
                    + "\nA: Let's think step by step.")
            prompts.append(_resize_prompt(model.tokenizer,
                                          model.args.max_seq_len, full))
            tgt = item["target"]
            answers.append(tgt[1] if mode == "multiple_choice" else tgt)
        correct = 0
        for i in range(0, len(prompts), batch_size):
            outs = model.generate(prompts[i: i + batch_size],
                                  max_gen_len=max_gen_len)
            for out, ans in zip(outs, answers[i: i + batch_size]):
                correct += int(bbh_extract_ans(out, mode) == ans)
        scores[task] = correct / max(len(prompts), 1)
    avg = float(np.mean(list(scores.values()))) if scores else 0.0
    return {"tasks": scores, "accuracy": avg}


# ---------------------------------------------------------------------------
# MATH (reference eval_math.py)

# reference few-shot style (light-eval/prompt/math_prompt.txt): CoT ending
# "The answer is X" — the extraction protocol keys on "answer is "
MATH_FEWSHOT = (
    "Given a mathematics problem, determine the answer. Simplify your "
    "answer as much as possible.\n\n"
    "Problem: The sum of two numbers is 6. The difference of their squares "
    "is 12. What is the positive difference of the two numbers?\n"
    "Answer: Let's think step by step.\n"
    "Call the two numbers $x$ and $y$. We are given that $x+y = 6$ and "
    "$x^2 - y^2 = 12$. Because $x^2 - y^2$ factors into $(x+y)(x-y)$, we "
    "can substitute in for $x+y$, giving $6(x-y) = 12$, or "
    "$x-y = \\boxed{2}$.\nThe answer is 2\n\n"
    "Problem: If $g(x) = 3x + 7$ and $f(x) = 5x - 9$, what is the value of "
    "$f(g(8))$?\nAnswer: Let's think step by step.\n"
    "$g(8)=3(8)+7=24+7=31$. Thus, "
    "$f(g(8))=f(31)=5(31)-9=155-9=\\boxed{146}$.\nThe answer is 146\n\n")


def eval_math(model, data_path: str, batch_size: int = 8,
              max_gen_len: int = 512, limit: Optional[int] = None) -> Dict:
    """MATH: few-shot, boxed-answer equivalence (math_util.is_equiv)."""
    from accessory_tpu_torch.eval.math_util import (
        extract_math_answer, is_equiv, last_boxed_only_string, remove_boxed)

    files = ([data_path] if os.path.isfile(data_path)
             else sorted(glob.glob(os.path.join(data_path, "*.jsonl"))))
    items = []
    for f in files:
        with open(f) as fh:
            for line in fh:
                if line.strip():
                    items.append(json.loads(line))
    if limit:
        items = items[:limit]

    prompts, targets = [], []
    for it in items:
        problem = it.get("problem") or it.get("instruction")
        solution = it.get("solution") or it.get("output")
        prompt = (MATH_FEWSHOT + "\n\nProblem: " + problem
                  + "\nAnswer: Let's think step by step.\n")
        prompts.append(_resize_prompt(model.tokenizer,
                                      model.args.max_seq_len, prompt))
        targets.append(remove_boxed(last_boxed_only_string(solution)))

    correct = 0
    for i in range(0, len(prompts), batch_size):
        outs = model.generate(prompts[i: i + batch_size],
                              max_gen_len=max_gen_len)
        for out, tgt in zip(outs, targets[i: i + batch_size]):
            pred = extract_math_answer(out)
            correct += int(is_equiv(pred, tgt))
    return {"accuracy": correct / max(len(items), 1), "total": len(items)}


# ---------------------------------------------------------------------------
# HumanEval (reference eval_humaneval.py)

def _filter_code(completion: str) -> str:
    completion = completion.lstrip("\n")
    return completion.split("\n\n")[0]


def eval_humaneval(model, data_path: str, n_samples: int = 1,
                   temperature: float = 0.2, top_p: float = 0.95,
                   max_gen_len: int = 512, timeout: float = 3.0,
                   limit: Optional[int] = None,
                   ks: Sequence[int] = (1,)) -> Dict:
    """HumanEval pass@k with sandboxed execution (eval/code_exec.py)."""
    from accessory_tpu_torch.eval.code_exec import evaluate_functional_correctness

    problems = {}
    with open(data_path) as f:
        for line in f:
            if line.strip():
                p = json.loads(line)
                problems[p["task_id"]] = p
    task_ids = list(problems)
    if limit:
        task_ids = task_ids[:limit]

    samples = []
    for tid in task_ids:
        prompt = problems[tid]["prompt"].replace("    ", "\t")
        outs = model.generate([prompt] * n_samples, max_gen_len=max_gen_len,
                              temperature=temperature, top_p=top_p)
        for out in outs:
            samples.append({"task_id": tid,
                            "completion": _filter_code(
                                out.replace("\t", "    "))})
    return evaluate_functional_correctness(
        samples, problems, ks=list(ks), timeout=timeout)


# ---------------------------------------------------------------------------
# C-Eval / CMMLU (reference eval_ceval.py / eval_cmmlu.py):
# Chinese 4-way MC scored by FIRST-TOKEN LOGITS over the A/B/C/D token ids.

_CHOICES = ["A", "B", "C", "D"]


def _mc_format_example(row: Dict, include_answer: bool) -> str:
    ex = row["question"]
    for c in _CHOICES:
        ex += f"\n{c}. {row[c]}"
    ex += "\n答案：" + (row["answer"] + "\n\n" if include_answer else "")
    return ex


def _first_token_choice(model, prompt: str) -> str:
    """argmax over the A/B/C/D first-token logits at the last position
    (reference extract_ans_by_logits)."""
    return _first_token_choices(model, [prompt])[0]


def _first_token_choices(model, prompts, batch_size: int = 8):
    """Batched first-token MC scoring: prompts are bucket-padded (powers of
    two from 64, up to max_seq_len) and scored ``batch_size`` rows at a time
    (a short chunk padded with empty rows, as in the reference); each row's
    logits are taken at its last real position only, on the device, so
    (B, V) and not (B, L, V) comes back to the host."""
    opt_ids = [model.tokenizer.encode(c, bos=False, eos=False)[0] for c in _CHOICES]
    enc = [model.tokenizer.encode(p, bos=True, eos=False) for p in prompts]

    def bucket(n):
        b = 64
        while b < n:
            b *= 2
        return min(b, model.args.max_seq_len)

    by_bucket = {}
    for i, ids in enumerate(enc):
        by_bucket.setdefault(bucket(len(ids)), []).append(i)
    out = [None] * len(prompts)
    for blen, idxs in sorted(by_bucket.items()):
        for off in range(0, len(idxs), batch_size):
            chunk = idxs[off:off + batch_size]
            toks = np.zeros((batch_size, blen), np.int64)
            lens = np.ones((batch_size,), np.int64)
            for r, i in enumerate(chunk):
                ids = enc[i][-blen:]  # left-truncate overlong prompts
                toks[r, :len(ids)] = ids
                lens[r] = len(ids)
            last = _last_logits(model, toks, lens)
            for r, i in enumerate(chunk):
                out[i] = _CHOICES[int(np.argmax([last[r, t] for t in opt_ids]))]
    return out


@torch.no_grad()
def _last_logits(model, toks: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """(B, V) f32 logits of each row at its position lens - 1."""
    dev = model.device
    logits = model.module.forward(model.params, model.args, torch.from_numpy(toks).to(dev))[0]
    rows = torch.arange(toks.shape[0], device=dev)
    return logits[rows, torch.from_numpy(lens).to(dev) - 1].to(torch.float32).cpu().numpy()


def _eval_chinese_mc(model, test_files: Dict[str, str],
                     dev_files: Dict[str, str], header_prompt,
                     ntrain: int = 5, limit: Optional[int] = None) -> Dict:
    scores = {}
    for subj, tf in sorted(test_files.items()):
        dev_rows = _read_csv_rows(dev_files.get(subj))
        few_shot = header_prompt(subj)
        for r in dev_rows[:ntrain if ntrain >= 0 else len(dev_rows)]:
            few_shot += _mc_format_example(r, include_answer=True)
        rows = _read_csv_rows(tf)
        if limit:
            rows = rows[:limit]
        prompts = [_resize_prompt(model.tokenizer, model.args.max_seq_len,
                                  few_shot + _mc_format_example(
                                      row, include_answer=False), reserve=1)
                   for row in rows]
        if prompts:
            preds = _first_token_choices(model, prompts)
            scores[subj] = float(np.mean(
                [p == row["answer"] for p, row in zip(preds, rows)]))
    avg = float(np.mean(list(scores.values()))) if scores else 0.0
    return {"tasks": scores, "accuracy": avg}


def _read_csv_rows(path: Optional[str]) -> List[Dict]:
    if not path or not os.path.exists(path):
        return []
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        rows = []
        for r in reader:
            # ceval csvs: id,question,A,B,C,D,answer; cmmlu: Question,A..D,Answer
            norm = {k.strip().lower() if k.strip().lower() in
                    ("question", "answer") else k.strip(): v
                    for k, v in r.items() if k}
            rows.append(norm)
        return rows


def eval_ceval(model, data_dir: str, ntrain: int = 5,
               limit: Optional[int] = None) -> Dict:
    """C-Eval val split, few-shot, first-token-logit scoring."""
    test = {os.path.basename(f)[: -len("_val.csv")]: f
            for f in glob.glob(os.path.join(data_dir, "val", "*_val.csv"))}
    dev = {os.path.basename(f)[: -len("_dev.csv")]: f
           for f in glob.glob(os.path.join(data_dir, "dev", "*_dev.csv"))}
    header = (lambda s:
              f"以下是中国关于{s.replace('_', ' ')}考试的单项选择题，"
              "请选出其中的正确答案。\n\n")
    return _eval_chinese_mc(model, test, dev, header, ntrain, limit)


def eval_cmmlu(model, data_dir: str, ntrain: int = 5,
               limit: Optional[int] = None) -> Dict:
    """CMMLU test split, few-shot, first-token-logit scoring."""
    test = {os.path.basename(f)[:-4]: f
            for f in glob.glob(os.path.join(data_dir, "test", "*.csv"))}
    dev = {os.path.basename(f)[:-4]: f
           for f in glob.glob(os.path.join(data_dir, "dev", "*.csv"))}
    header = (lambda s:
              f"以下是关于{s.replace('_', ' ')}的单项选择题，"
              "请直接给出正确答案的选项。\n\n")
    return _eval_chinese_mc(model, test, dev, header, ntrain, limit)
