"""Port parity, the evaluation harness: ``math_util`` and ``code_exec``
(the JAX tests' cases and more), ``perplexity``, ``multiple_choice``,
``generation_eval`` and ``_first_token_choices`` against the JAX package's
values on the same params, every light-eval driver (BBH, MATH, HumanEval,
C-Eval, CMMLU) on inline files with the same result dicts (greedy),
``run_eval.main`` on a checkpoint the JAX package wrote, and ``eval_mm``'s
metrics and its VQA, RefCOCO and MME drivers on PNGs written here with PIL
(a tiny SPHINX).

A 2-layer f32 LLaMA of width 64 (max_seq_len 256) and the tiny
llama_ens_light of test_torch_sphinx, params drawn by the port, perturbed
from a numpy seed and handed to the JAX package. Perplexity and
log-likelihoods to 1e-5 relative (f32 on both sides, the same op order but
for the softmax's sums); predictions, texts and result dicts exactly.
"""

import json

import numpy as np
import pytest

from accessory_tpu.eval import code_exec as jcode
from accessory_tpu.eval import eval_mm as jmm
from accessory_tpu.eval import harness as jharness
from accessory_tpu.eval import math_util as jmath
from accessory_tpu.eval import run_eval as jrun
from accessory_tpu.eval import tasks as jtasks
from accessory_tpu.meta import MetaModel as JMetaModel

from accessory_tpu_torch.convert import params_from_jax, params_to_jax
from accessory_tpu_torch.eval import code_exec, eval_mm, harness, math_util, run_eval, tasks
from accessory_tpu_torch.meta import MetaModel

from test_torch_generate import one_torch_thread, tok_path  # noqa: F401  (fixtures)
from test_torch_sphinx import pair
from test_torch_visual import perturbed, to_jax

CFG = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, multiple_of=32, dtype="float32")
TEXT = ("the quick brown fox jumps over the lazy dog while the farmer counts his sheep "
        "hello world this is a test of the evaluation harness ") * 6


@pytest.fixture(scope="module")
def text_pair(tok_path):  # noqa: F811
    tm = MetaModel("llama", CFG, tokenizer_path=tok_path, max_seq_len=256, seed=3,
                   device="cpu")
    tm.params = params_from_jax(perturbed(params_to_jax(tm.params), seed=4, scale=0.02),
                                tm.args, device="cpu")
    jm = JMetaModel("llama", CFG, tokenizer_path=tok_path, max_seq_len=256, init_params=False)
    jm.params = to_jax(params_to_jax(tm.params))
    return tm, jm


# ---------------------------------------------------------------- host-side logic

MATH_PAIRS = [("\\frac{1}{2}", "1/2"), ("\\tfrac12", "\\frac{1}{2}"), ("0.5", "\\frac{1}{2}"),
              ("\\sqrt3", "\\sqrt{3}"), ("10\\text{ inches}", "10"),
              ("\\frac{1}{2}", "\\frac{1}{3}"), ("x = 5", "5"), ("\\left(1,2\\right)", "(1,2)"),
              ("90^\\circ", "90"), ("\\$5", "5"), ("50\\%", "50"), (None, None), (None, "1"),
              (".5", "\\frac12"), ("\\dfrac{3}{4}", "3/4"), ("2", "3")]
SOLUTIONS = ["so we get $x=2$ and \\boxed{\\frac{1}{2}} done", "\\fbox{7} and more",
             "no box", "\\boxed{a{b}c}", "\\boxed{unclosed", "x \\boxed{1} y \\boxed{2}"]
COMPLETIONS = ["... so $x = \\boxed{7}$.\nThe answer is 7\n\nProblem: next",
               "thus \\boxed{42} qed", "The answer is 3.", "nothing here",
               "the answer is \\frac{1}{2}.\nmore"]


def test_math_util_matches_reference():
    for a, b in MATH_PAIRS:
        assert math_util.is_equiv(a, b) == jmath.is_equiv(a, b), (a, b)
        for s in (a, b):
            if s is not None:
                assert math_util.strip_string(s) == jmath.strip_string(s), s
    for s in SOLUTIONS:
        box = math_util.last_boxed_only_string(s)
        assert box == jmath.last_boxed_only_string(s), s
        assert math_util.remove_boxed(box) == jmath.remove_boxed(box), s
    for c in COMPLETIONS:
        assert math_util.extract_math_answer(c) == jmath.extract_math_answer(c), c
    assert math_util.is_equiv("\\frac{1}{2}", "1/2") and not math_util.is_equiv("2", "3")


def test_extraction_matches_reference():
    for text in ("reasoning... So the answer is (B).", "the answer is 42.\nQ: next",
                 "the answer is valid#junk", "no answer phrase", "The answer is C, clearly"):
        for mode in ("multiple_choice", "free_form"):
            assert tasks.bbh_extract_ans(text, mode) == jtasks.bbh_extract_ans(text, mode)
    for text in ("the answer is 42.", "1,234 then 5.5", "none", "-3 and -7.25"):
        assert harness.extract_last_number(text) == jharness.extract_last_number(text)
    for text in ("def f():\n\n    return 1\n\nextra", "\n\n  x = 1\n\ny"):
        assert tasks._filter_code(text) == jtasks._filter_code(text)
    row = {"question": "q?", "A": "1", "B": "2", "C": "3", "D": "4", "answer": "B"}
    for include in (True, False):
        assert tasks._mc_format_example(row, include) == jtasks._mc_format_example(row, include)


def test_code_exec_matches_reference():
    for n, c, k in [(1, 1, 1), (1, 0, 1), (2, 1, 1), (10, 10, 5), (10, 3, 5), (20, 7, 10),
                    (5, 0, 3)]:
        assert code_exec.estimate_pass_at_k(n, c, k) == jcode.estimate_pass_at_k(n, c, k)
    prob = {"prompt": "def add(a, b):\n", "test": "def check(f):\n    assert f(1, 2) == 3\n",
            "entry_point": "add"}
    good, bad = "    return a + b\n", "    return a - b\n"
    prog = code_exec.build_test_program(prob["prompt"], good, prob["test"], prob["entry_point"])
    assert prog == jcode.build_test_program(prob["prompt"], good, prob["test"],
                                            prob["entry_point"])
    assert code_exec.check_program(prog)
    assert not code_exec.check_program(code_exec.build_test_program(
        prob["prompt"], bad, prob["test"], prob["entry_point"]))
    assert not code_exec.check_program("while True:\n    pass\n", timeout=1.0)
    assert not code_exec.check_program("import sys\nsys.exit(3)\n")
    samples = [{"task_id": "t0", "completion": good}, {"task_id": "t0", "completion": bad},
               {"task_id": "t1", "completion": bad}]
    problems = {"t0": prob, "t1": prob}
    got = code_exec.evaluate_functional_correctness(samples, problems, ks=[1, 2])
    assert got == jcode.evaluate_functional_correctness(samples, problems, ks=[1, 2])
    assert got == {"pass@1": 0.25, "pass@2": 1.0, "total": 2}


# ---------------------------------------------------------------- primitives


@pytest.mark.parametrize("seq_len,stride,max_windows", [(64, None, None), (64, 32, None),
                                                        (128, None, 1), (256, 96, None)])
def test_perplexity_matches_jax(text_pair, seq_len, stride, max_windows):
    tm, jm = text_pair
    got = harness.perplexity(tm, TEXT, seq_len=seq_len, stride=stride, max_windows=max_windows)
    want = jharness.perplexity(jm, TEXT, seq_len=seq_len, stride=stride,
                               max_windows=max_windows)
    assert np.isfinite(got) and got > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5)


MC_ITEMS = [{"question": "the quick brown", "choices": [" fox", " zebra", "dog"], "answer": 0},
            {"question": "hello", "choices": [" world", " banana"], "answer": "A"},
            {"question": "write a response that", "choices": ["appropriately", " x", "y z"],
             "answer": "C"}]


def test_multiple_choice_and_generation_eval_match_jax(text_pair):
    tm, jm = text_pair
    assert harness.multiple_choice(tm, MC_ITEMS) == jharness.multiple_choice(jm, MC_ITEMS)
    items = [{"q": "the quick brown fox", "a": "12"}, {"q": "hello world", "a": "7"},
             {"q": "one two three", "a": "3"}]
    kw = dict(prompt_fn=lambda x: x["q"], target_fn=lambda x: x["a"], max_gen_len=6,
              batch_size=2, stop_symbols=("dog",))
    assert harness.generation_eval(tm, items, **kw) == jharness.generation_eval(jm, items, **kw)


def test_first_token_choices_match_jax(text_pair):
    """Prompts in the 64 and 128 buckets and one past max_seq_len (left-
    truncated), chunks of 3 padded to the fixed batch: the same choices,
    and the same last-position logits to 1e-5."""
    tm, jm = text_pair
    prompts = ["the quick brown fox\nA. a\nB. b\nC. c\nD. d\n答案：",
               "hello " * 40 + "答案：", "x", "the lazy dog " * 60,
               "write a response that appropriately completes the request " * 2]
    assert len(tm.tokenizer.encode(prompts[3], bos=True, eos=False)) > 256
    got = tasks._first_token_choices(tm, prompts, batch_size=3)
    assert got == jtasks._first_token_choices(jm, prompts, batch_size=3)
    toks = np.zeros((3, 64), np.int64)
    toks[:, :5] = [[1, 5, 9, 42, 7]] * 3
    lens = np.array([5, 3, 1])
    want = np.asarray(jm._ft_last_jit(jm.params, toks.astype(np.int32), lens.astype(np.int32)))
    np.testing.assert_allclose(tasks._last_logits(tm, toks, lens), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- task drivers


def _bbh_dir(d):
    (d / "bbh").mkdir(parents=True)
    (d / "cot-prompts").mkdir()
    for task, target in (("snarks", "(A)"), ("navigate", "Yes")):
        exs = [{"input": f"is {i} even?", "target": target} for i in range(3)]
        (d / "bbh" / f"{task}.json").write_text(json.dumps({"examples": exs}))
        (d / "cot-prompts" / f"{task}.txt").write_text(
            "header\nheader\nQ: example?\nA: the answer is (A).\n")
    return d


def _mc_csv(path, n, header):
    with open(path, "w") as f:
        f.write(header + "\n")
        for i in range(n):
            f.write(f"{i},question {i}?,yes,no,maybe,never,{'ABCD'[i % 4]}\n")


def _chinese_dirs(d):
    for sub in ("ceval", "cmmlu"):
        for part in ("val", "dev", "test"):
            (d / sub / part).mkdir(parents=True)
    _mc_csv(d / "ceval" / "val" / "logic_val.csv", 3, "id,question,A,B,C,D,answer")
    _mc_csv(d / "ceval" / "dev" / "logic_dev.csv", 2, "id,question,A,B,C,D,answer")
    _mc_csv(d / "cmmlu" / "test" / "physics.csv", 3, "id,Question,A,B,C,D,Answer")
    _mc_csv(d / "cmmlu" / "dev" / "physics.csv", 2, "id,Question,A,B,C,D,Answer")
    return d


def test_task_drivers_match_jax(text_pair, tmp_path):
    """Each driver on inline files, greedy: the same result dicts (BBH's
    per-task scores, MATH's accuracy, HumanEval's pass@1 at temperature 0,
    C-Eval's and CMMLU's per-subject scores)."""
    tm, jm = text_pair
    d = _bbh_dir(tmp_path / "bbh_data")
    kw = dict(tasks=["snarks", "navigate"], max_gen_len=6, batch_size=2, limit=3)
    assert tasks.eval_bbh(tm, str(d), **kw) == jtasks.eval_bbh(jm, str(d), **kw)
    f = tmp_path / "math.jsonl"
    f.write_text("".join(json.dumps({"problem": f"What is {i}+1?",
                                     "solution": f"We compute. $\\boxed{{{i + 1}}}$"}) + "\n"
                         for i in range(3)))
    kw = dict(max_gen_len=6, batch_size=2)
    assert tasks.eval_math(tm, str(f), **kw) == jtasks.eval_math(jm, str(f), **kw)
    f = tmp_path / "HumanEval.jsonl"
    f.write_text("".join(json.dumps({"task_id": f"HumanEval/{i}", "prompt": "def f():\n",
                                     "test": "def check(f):\n    assert f() is None\n",
                                     "entry_point": "f"}) + "\n" for i in range(2)))
    kw = dict(max_gen_len=6, temperature=0.0, limit=2)
    got = tasks.eval_humaneval(tm, str(f), **kw)
    assert got == jtasks.eval_humaneval(jm, str(f), **kw) and got["total"] == 2
    d = _chinese_dirs(tmp_path / "zh")
    got = tasks.eval_ceval(tm, str(d / "ceval"), ntrain=1)
    assert got == jtasks.eval_ceval(jm, str(d / "ceval"), ntrain=1) and "logic" in got["tasks"]
    got = tasks.eval_cmmlu(tm, str(d / "cmmlu"), ntrain=2, limit=2)
    assert got == jtasks.eval_cmmlu(jm, str(d / "cmmlu"), ntrain=2, limit=2)
    assert "physics" in got["tasks"]


def test_run_eval_main_on_a_jax_checkpoint(text_pair, tmp_path, capsys):
    """run_eval.main loads a checkpoint the JAX package's save_pretrained
    wrote (cast to bf16 by both loaders) and prints the JAX driver's line:
    ppl to 5e-3 (bf16 activations, rounded at other points of the two
    forwards), mmlu's result exactly."""
    _, jm = text_pair
    jm.save_pretrained(str(tmp_path / "ck"))
    (tmp_path / "wiki.txt").write_text(TEXT)
    with open(tmp_path / "mmlu.csv", "w") as f:
        f.write("the quick brown,fox,zebra,cat,dog,A\nhello,world,banana,x,y,B\n")
    for task, data in (("ppl", "wiki.txt"), ("mmlu", "mmlu.csv")):
        argv = ["--task", task, "--data", str(tmp_path / data), "--pretrained_path",
                str(tmp_path / "ck"), "--max_seq_len", "256", "--seq_len", "64"]
        got = run_eval.main(run_eval.get_args_parser().parse_args(argv), device="cpu")
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
        jrun.main(jrun.get_args_parser().parse_args(argv))
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert got["task"] == want["task"] == task
        if task == "ppl":
            np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=5e-3)
        else:
            assert got == want


# ---------------------------------------------------------------- multimodal


def test_eval_mm_metrics_match_reference():
    for s in ("The Cat.", "  an apple ", "A  dog the", "yes"):
        assert eval_mm.normalize_answer(s) == jmm.normalize_answer(s)
    for pred, answers in (("a cat", ["cat", "cat", "cat", "dog"]), ("dog", ["cat", "cat", "dog"]),
                          ("fish", ["cat"]), ("Yes.", ["yes", "yes"])):
        assert eval_mm.vqa_accuracy(pred, answers) == jmm.vqa_accuracy(pred, answers)
    for text in ("the box is [10, 20, 30, 40].", "(1.5, 2.5, 3.5, 4.5)", "no box here",
                 "1;2;3;4", "[3 4 5]"):
        assert eval_mm.extract_box(text) == jmm.extract_box(text)
    for a, b in (((0, 0, 10, 10), (0, 0, 10, 10)), ((0, 0, 10, 10), (5, 5, 15, 15)),
                 ((0, 0, 1, 1), (5, 5, 6, 6)), ((0, 0, 0, 0), (0, 0, 0, 0))):
        assert eval_mm.box_iou(a, b) == jmm.box_iou(a, b)
    assert eval_mm.box_iou((0, 0, 10, 10), (5, 5, 15, 15)) == pytest.approx(25 / 175)


def test_eval_mm_drivers_match_jax(tok_path, tmp_path):  # noqa: F811
    """VQA, RefCOCO and MME on PNGs written here, on the tiny SPHINX pair:
    the same result dicts as the JAX drivers (greedy)."""
    from PIL import Image

    tm, jm = pair(tok_path, "llama_ens_light")
    for name, size, color in (("red.png", (64, 48), (255, 0, 0)),
                              ("blue.png", (40, 80), (0, 0, 255))):
        Image.new("RGB", size, color).save(tmp_path / name)
    root = f"{tmp_path}/"
    vqa = [{"image": "red.png", "question": "what is in the image", "answer": "a cat"},
           {"image": "blue.png", "question": "what colour", "answers": ["blue", "blue", "sky"]}]
    kw = dict(image_root=root, batch_size=2, max_gen_len=4)
    assert eval_mm.evaluate_vqa(tm, vqa, **kw) == jmm.evaluate_vqa(jm, vqa, **kw)
    ref = [{"image": "red.png", "expression": "the red square", "bbox": [0, 0, 10, 10]}]
    assert eval_mm.evaluate_refcoco(tm, ref, image_root=root) == \
        jmm.evaluate_refcoco(jm, ref, image_root=root)
    mme = [{"image": "blue.png", "text": "is it blue?", "label": "yes"},
           {"image": "red.png", "text": "is it blue?", "label": "no"}]
    got = eval_mm.evaluate_mme(tm, mme, image_root=root, batch_size=2)
    assert got == jmm.evaluate_mme(jm, mme, image_root=root, batch_size=2)
    assert got["total"] == 2
