"""Multimodal benchmark harness (SPHINX).

Port of ``accessory_tpu/eval/eval_mm.py`` over the port's ``SPHINXModel``
(reference accessory/eval_mm/evaluate.py:84-110 and
inference_image_sphinx.py: inference over image QA annotations with
per-benchmark metrics: VQA accuracy, refcoco IoU, the MME yes/no score; the
MM-Vet and LLaVA-bench answer files).

Annotations are jsonl rows {"image": path, "question": ..., "answer": ...}
(VQA-style) or {"image", "text", "label" (yes/no)} (MME). The image drivers
read their files with PIL, imported inside them as in the reference; the
metrics and the model call (``generate(images=...)`` on CLIP-normalized
arrays) need no PIL.
"""

from __future__ import annotations

import argparse
import json
import re
from typing import Dict, Iterable, List


def vqa_accuracy(pred: str, answers: List[str]) -> float:
    """Soft VQA accuracy: min(matches/3, 1) over annotator answers."""
    p = normalize_answer(pred)
    m = sum(normalize_answer(a) == p for a in answers)
    return min(m / 3.0, 1.0)


def normalize_answer(s: str) -> str:
    s = s.lower().strip().rstrip(".")
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return re.sub(r"\s+", " ", s).strip()


def evaluate_vqa(model, items: Iterable[Dict], image_root: str = "",
                 batch_size: int = 8, max_gen_len: int = 32) -> Dict:
    """items: {"image", "question", "answer"| "answers"}."""
    from PIL import Image

    from accessory_tpu_torch.data.conversation import default_conversation
    from accessory_tpu_torch.data.transform import padded_resize

    items = list(items)
    size = getattr(model.args, "image_size", 224)
    total = 0.0
    for i in range(0, len(items), batch_size):
        batch = items[i: i + batch_size]
        prompts, imgs = [], []
        for it in batch:
            conv = default_conversation()
            conv.load_qas([[it["question"], None]])
            prompts.append(conv.get_prompt())
            imgs.append(padded_resize(
                Image.open(f"{image_root}{it['image']}").convert("RGB"), size))
        import numpy as np

        conv = default_conversation()
        outs = model.generate(
            prompts, images=np.stack(imgs), max_gen_len=max_gen_len,
            additional_stop_symbols=(conv.response_end_signal,))
        for it, out in zip(batch, outs):
            out = out.split(conv.response_end_signal)[0]
            answers = it.get("answers") or [it["answer"]]
            total += vqa_accuracy(out, answers)
    return {"accuracy": total / max(len(items), 1), "total": len(items)}


_BOX_RE = re.compile(r"\[?\(?(\d+\.?\d*)[,;\s]+(\d+\.?\d*)[,;\s]+"
                     r"(\d+\.?\d*)[,;\s]+(\d+\.?\d*)\)?\]?")


def extract_box(text: str):
    """Parse the first (x1, y1, x2, y2) box from a generation."""
    m = _BOX_RE.search(text)
    return tuple(float(g) for g in m.groups()) if m else None


def box_iou(a, b) -> float:
    """IoU of two (x1, y1, x2, y2) boxes (refcoco grounding metric)."""
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix2 - ix1, 0.0) * max(iy2 - iy1, 0.0)
    area = lambda r: max(r[2] - r[0], 0.0) * max(r[3] - r[1], 0.0)  # noqa: E731
    union = area(a) + area(b) - inter
    return inter / union if union > 0 else 0.0


def evaluate_refcoco(model, items: Iterable[Dict], image_root: str = "",
                     batch_size: int = 8, iou_thresh: float = 0.5) -> Dict:
    """refcoco-style grounding: generate a box for each referring expression
    and score acc@IoU>=0.5 (reference accessory/eval_mm refcoco driver).
    items: {"image", "expression"|"question", "bbox": [x1, y1, x2, y2]}."""
    from PIL import Image

    from accessory_tpu_torch.data.conversation import default_conversation
    from accessory_tpu_torch.data.transform import padded_resize

    items = list(items)
    size = getattr(model.args, "image_size", 224)
    correct = 0
    for i in range(0, len(items), batch_size):
        batch = items[i: i + batch_size]
        prompts, imgs = [], []
        for it in batch:
            q = it.get("expression") or it["question"]
            conv = default_conversation()
            conv.load_qas([[f"Please provide the bounding box for: {q}", None]])
            prompts.append(conv.get_prompt())
            imgs.append(padded_resize(
                Image.open(f"{image_root}{it['image']}").convert("RGB"), size))
        import numpy as np

        conv = default_conversation()
        outs = model.generate(
            prompts, images=np.stack(imgs), max_gen_len=32,
            additional_stop_symbols=(conv.response_end_signal,))
        for it, out in zip(batch, outs):
            pred = extract_box(out)
            if pred is not None and box_iou(pred, tuple(it["bbox"])) >= iou_thresh:
                correct += 1
    return {"accuracy": correct / max(len(items), 1), "total": len(items)}


def evaluate_mme(model, items: Iterable[Dict], image_root: str = "",
                 batch_size: int = 8) -> Dict:
    """MME yes/no protocol: accuracy + accuracy+ (both questions per image)."""
    items = list(items)
    res = evaluate_vqa(model, [
        {"image": it["image"], "question": it["text"],
         "answer": it["label"]} for it in items],
        image_root=image_root, batch_size=batch_size, max_gen_len=4)
    return res


_INSTRUCT_FMT = ("Below is an instruction that describes a task.\n"
                 "Write a response that appropriately completes the request."
                 "\n\n### Instruction:\n{q}\n\n### Response:")


def _generate_mm(model, question: str, image_path: str,
                 max_gen_len: int = 512) -> str:
    """One instruction-formatted multimodal generation (reference
    eval_mmvet/eval_llavabenchmark generate_output: temperature 0.1,
    top_p 0.7, alpaca instruction template)."""
    import numpy as np
    from PIL import Image

    from accessory_tpu_torch.data.transform import padded_resize

    size = getattr(model.args, "image_size", 224)
    img = padded_resize(Image.open(image_path).convert("RGB"), size)
    out = model.generate([_INSTRUCT_FMT.format(q=question)],
                         images=np.stack([img]), max_gen_len=max_gen_len,
                         temperature=0.1, top_p=0.7)
    return out[0]


def evaluate_mmvet(model, question_file: str, image_root: str,
                   answers_file: str, limit=None) -> Dict:
    """MM-Vet answer-file generator (reference eval_mmvet.py:133-165):
    writes {question_id: answer} JSON in the format the official MM-Vet
    GPT-4 grader consumes."""
    import os

    with open(question_file) as f:
        data = json.load(f)
    results = {}
    for i, (key, value) in enumerate(data.items()):
        if limit and i >= limit:
            break
        results[key] = _generate_mm(
            model, value["question"],
            os.path.join(image_root, value["imagename"]))
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    with open(answers_file, "w") as f:
        f.write(json.dumps(results, indent=4))
    return {"answered": len(results), "answers_file": answers_file}


def evaluate_llava_bench(model, question_file: str, image_root: str,
                         answers_file: str, model_name: str = "accessory_tpu",
                         limit=None) -> Dict:
    """LLaVA-bench(-in-the-wild) answer generator (reference
    eval_llavabenchmark.py:148-175): jsonl rows the official reviewer
    scripts consume."""
    import os
    import uuid

    questions = [json.loads(q) for q in open(question_file)]
    if limit:
        questions = questions[:limit]
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    n = 0
    with open(answers_file, "w") as f:
        for line in questions:
            out = _generate_mm(model, line["text"],
                               os.path.join(image_root, line["image"]))
            f.write(json.dumps({
                "question_id": line["question_id"], "prompt": line["text"],
                "text": out, "answer_id": uuid.uuid4().hex[:22],
                "model_id": model_name, "metadata": {}}) + "\n")
            n += 1
    return {"answered": n, "answers_file": answers_file}


def get_args_parser():
    p = argparse.ArgumentParser("multimodal eval", add_help=False)
    p.add_argument("--task", choices=["vqa", "mme", "mmvet", "llava_bench"],
                   required=True)
    p.add_argument("--data", required=True, help="jsonl/json annotations")
    p.add_argument("--image_root", default="")
    p.add_argument("--answers_file", default="answers.json")
    p.add_argument("--pretrained_path", required=True)
    p.add_argument("--llama_type", default=None)
    p.add_argument("--limit", type=int, default=None)
    return p


def main(args, device="cuda"):
    """Run ``args.task`` (``get_args_parser``) with the SPHINX model under
    ``args.pretrained_path`` on ``device``; prints and returns the result."""
    from accessory_tpu_torch.sphinx_api import SPHINXModel

    model = SPHINXModel.from_pretrained(
        args.pretrained_path, llama_type=args.llama_type, with_visual=True, device=device)
    if args.task == "mmvet":
        res = evaluate_mmvet(model, args.data, args.image_root,
                             args.answers_file, limit=args.limit)
    elif args.task == "llava_bench":
        res = evaluate_llava_bench(model, args.data, args.image_root,
                                   args.answers_file, limit=args.limit)
    else:
        items = []
        with open(args.data) as f:
            for line in f:
                items.append(json.loads(line))
                if args.limit and len(items) >= args.limit:
                    break
        fn = evaluate_vqa if args.task == "vqa" else evaluate_mme
        res = fn(model, items, image_root=args.image_root)
    out = {"task": args.task, **res}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(get_args_parser().parse_args())
