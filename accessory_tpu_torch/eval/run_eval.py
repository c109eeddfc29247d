"""Evaluation CLI driver (light-eval equivalent).

Port of ``accessory_tpu/eval/run_eval.py`` over the port's ``MetaModel``
(reference light-eval/src/eval_mmlu.py:82-107 etc.): builds the model,
reads the benchmark's data files, runs the matching primitive, prints
accuracy / perplexity as one JSON line.

Tasks:
  ppl   --data file.txt                 sliding-window perplexity
  mmlu  --data dir/ (HF-style csv: question,A,B,C,D,answer)
  gsm8k --data file.jsonl (fields: question, answer)
  bbh / math / humaneval / ceval / cmmlu   the light-eval drivers (eval/tasks.py)

Run: python -m accessory_tpu_torch.eval.run_eval --task ppl --data wiki.txt \
       --pretrained_path ckpt/ [--quant]
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os


def get_args_parser():
    p = argparse.ArgumentParser("evaluation", add_help=False)
    p.add_argument("--task", required=True,
                   choices=["ppl", "mmlu", "gsm8k", "bbh", "math",
                            "humaneval", "ceval", "cmmlu"])
    p.add_argument("--n_samples", default=1, type=int,
                   help="humaneval samples per task (pass@k needs n >= k)")
    p.add_argument("--ntrain", default=5, type=int,
                   help="few-shot examples (ceval/cmmlu)")
    p.add_argument("--data", required=True, type=str)
    p.add_argument("--pretrained_path", required=True, type=str)
    p.add_argument("--llama_type", default=None, type=str)
    p.add_argument("--max_seq_len", default=2048, type=int)
    p.add_argument("--seq_len", default=2048, type=int, help="ppl window")
    p.add_argument("--quant", action="store_true")
    p.add_argument("--limit", default=None, type=int)
    return p


def load_mmlu_csvs(path: str, limit=None):
    items = []
    files = sorted(glob.glob(os.path.join(path, "*.csv"))) if os.path.isdir(path) else [path]
    for f in files:
        with open(f) as fh:
            for row in csv.reader(fh):
                if len(row) < 6:
                    continue
                q, a, b, c, d, ans = row[:6]
                items.append({"question": q, "choices": [a, b, c, d],
                              "answer": ans})
                if limit and len(items) >= limit:
                    return items
    return items


def load_jsonl(path: str, limit=None):
    items = []
    with open(path) as f:
        for line in f:
            items.append(json.loads(line))
            if limit and len(items) >= limit:
                break
    return items


def main(args, device="cuda"):
    """Run ``args.task`` on the model under ``args.pretrained_path`` on
    ``device``; prints the result line and returns the result dict."""
    from accessory_tpu_torch.eval import generation_eval, multiple_choice, perplexity
    from accessory_tpu_torch.meta import MetaModel

    model = MetaModel.from_pretrained(
        args.pretrained_path, llama_type=args.llama_type,
        max_seq_len=args.max_seq_len, quant=args.quant, device=device)

    if args.task == "ppl":
        with open(args.data) as f:
            text = f.read()
        res = {"ppl": perplexity(model, text, seq_len=args.seq_len, max_windows=args.limit)}
    elif args.task == "mmlu":
        res = multiple_choice(model, load_mmlu_csvs(args.data, args.limit))
    elif args.task == "gsm8k":
        res = generation_eval(
            model, load_jsonl(args.data, args.limit),
            prompt_fn=lambda x: f"Question: {x['question']}\nAnswer:",
            target_fn=lambda x: str(x["answer"]).split("####")[-1].strip(),
            stop_symbols=("Question:",))
    else:
        from accessory_tpu_torch.eval import tasks

        if args.task == "bbh":
            res = tasks.eval_bbh(model, args.data, limit=args.limit)
        elif args.task == "math":
            res = tasks.eval_math(model, args.data, limit=args.limit)
        elif args.task == "humaneval":
            res = tasks.eval_humaneval(model, args.data, n_samples=args.n_samples,
                                       limit=args.limit)
        elif args.task == "ceval":
            res = tasks.eval_ceval(model, args.data, ntrain=args.ntrain, limit=args.limit)
        else:
            res = tasks.eval_cmmlu(model, args.data, ntrain=args.ntrain, limit=args.limit)
    out = {"task": args.task, **res}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(get_args_parser().parse_args())
