"""Port parity, scoring and the CLI: ``compute_logits`` (text, and with
images the text positions only), ``evaluate_examples`` (text examples in
power-of-two buckets at a fixed batch shape, one over max_seq_len cut after
its BOS; examples with images one at a time) against the JAX package's, the
batched text path against per-example scoring built from
``compute_logits``, and the terminal demo's text path, whose printed
output must equal the JAX demo's.

A 2-layer f32 LLaMA of width 64 (max_seq_len 128: buckets 64 and 128) and
the tiny llama_ens_light of test_torch_sphinx, the params drawn by the port
and handed to the JAX package. f32 on both sides: logits and
log-likelihoods are held to 1e-4 (relative and absolute), ``max_equal``
and the CLI's text exactly.
"""

import numpy as np
import pytest
import torch

import accessory_tpu.meta as jmeta
from accessory_tpu.demos import cli as jcli
from accessory_tpu.meta import MetaModel as JMetaModel

import accessory_tpu_torch.meta as tmeta
from accessory_tpu_torch.convert import params_from_jax, params_to_jax
from accessory_tpu_torch.demos import cli as tcli
from accessory_tpu_torch.meta import MetaModel

from test_torch_generate import one_torch_thread, tok_path  # noqa: F401  (fixtures)
from test_torch_sphinx import images, pair
from test_torch_visual import perturbed, to_jax

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, multiple_of=32, dtype="float32")
# contexts of 3 to ~100 tokens (the 64 and the 128 bucket) and one of ~140,
# past max_seq_len, which loses context tokens after its BOS
CONTEXTS = ["the quick brown", "hello world this is a test of the engine " * 2, "hi",
            "the quick brown fox jumps over the lazy dog " * 5,
            "Hi my darling how are you today " * 8]
CONTINUATIONS = [" fox", " again", " there my darling", " and the dog", " fine"]


@pytest.fixture(scope="module")
def text_pair(tok_path):  # noqa: F811
    tm = MetaModel("llama", CFG, tokenizer_path=tok_path, max_seq_len=128, seed=3,
                   device="cpu")
    tm.params = params_from_jax(perturbed(params_to_jax(tm.params), seed=4, scale=0.02),
                                tm.args, device="cpu")
    jm = JMetaModel("llama", CFG, tokenizer_path=tok_path, max_seq_len=128, init_params=False)
    jm.params = to_jax(params_to_jax(tm.params))
    return tm, jm


def _check_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loglikelihood"], w["loglikelihood"], **TOL)
        np.testing.assert_allclose(g["ppl"], w["ppl"], rtol=1e-3)
        assert g["max_equal"] == w["max_equal"]


def test_compute_logits_matches_jax(text_pair, tok_path):  # noqa: F811
    """Text: (b, s, vocab) f32 logits of the cache-free forward; with images
    (llama_ens_light) the text positions' only."""
    tm, jm = text_pair
    toks = np.random.RandomState(5).randint(0, tm.args.vocab_size, (2, 20))
    got = tm.compute_logits(toks)
    assert got.dtype == torch.float32 and got.shape == (2, 20, tm.args.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.compute_logits(toks)), **TOL)
    sm, sj = pair(tok_path, "llama_ens_light")
    x = images(2, 224, seed=8)
    got = sm.compute_logits(toks[:, :12], images=x)
    assert got.shape == (2, 12, sm.args.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(sj.compute_logits(toks[:, :12],
                                                                         images=x)), **TOL)


def test_evaluate_examples_matches_jax(text_pair, tok_path):  # noqa: F811
    """{loglikelihood, ppl, max_equal} per example against the JAX package:
    text in two buckets with chunks of 2 (the last one padded with a
    scored-and-dropped row), a sequence cut to max_seq_len, and a
    continuation that is the model's own greedy token (max_equal True);
    then two examples with images."""
    tm, jm = text_pair
    greedy = None
    for words in range(1, 12):   # a context whose argmax token re-encodes as itself
        ctx = " ".join("the quick brown fox jumps over the lazy dog hello world".split()[:words])
        ctx_t = tm.tokenizer.encode(ctx, bos=True, eos=False)
        nxt = int(tm.compute_logits([ctx_t])[0, -1].argmax())
        cont = tm.tokenizer.decode([nxt])
        if tm.tokenizer.encode(ctx + cont, bos=True, eos=False) == ctx_t + [nxt]:
            greedy = (ctx, cont)
            break
    assert greedy is not None
    contexts, conts = CONTEXTS + [greedy[0]], CONTINUATIONS + [greedy[1]]
    assert len(tm.tokenizer.encode(contexts[4] + conts[4], bos=True, eos=False)) > 128
    got = tm.evaluate_examples(contexts, conts, batch_size=2)
    _check_results(got, jm.evaluate_examples(contexts, conts, batch_size=2))
    assert got[-1]["max_equal"]
    sm, sj = pair(tok_path, "llama_ens_light")
    x = images(2, 224, seed=9)
    got = sm.evaluate_examples(CONTEXTS[:2], CONTINUATIONS[:2], images=x)
    _check_results(got, sj.evaluate_examples(CONTEXTS[:2], CONTINUATIONS[:2], images=x))


def test_batched_equals_per_example(text_pair):
    """The batched, bucketed text path against each example scored alone
    from compute_logits (the reference's per-example path): log-likelihoods
    to 1e-4, max_equal equal."""
    tm, _ = text_pair
    got = tm.evaluate_examples(CONTEXTS[:4], CONTINUATIONS[:4], batch_size=3)
    for (ctx, cont), g in zip(zip(CONTEXTS[:4], CONTINUATIONS[:4]), got):
        ctx_t = tm.tokenizer.encode(ctx, bos=True, eos=False)
        full = tm.tokenizer.encode(ctx + cont, bos=True, eos=False)
        logp = torch.log_softmax(tm.compute_logits([full])[0, :-1], dim=-1)
        tgt = torch.tensor(full[1:])
        lp = logp.gather(1, tgt[:, None])[:, 0][len(ctx_t) - 1:]
        np.testing.assert_allclose(g["loglikelihood"], float(lp.sum()), **TOL)
        assert g["max_equal"] == bool((logp[len(ctx_t) - 1:].argmax(-1)
                                       == tgt[len(ctx_t) - 1:]).all())


def test_cli_text_path_matches_jax(text_pair, monkeypatch, capsys):
    """demos/cli.py's loop with two models compared side by side, a /reset
    and greedy decoding: the printed transcript equals the JAX demo's on the
    same weights and input lines."""
    tm, jm = text_pair
    lines = ["hello world", "/reset", "the quick brown", ""]
    argv = ["--pretrained_path", "ckptA", "ckptB", "--max_gen_len", "6", "--temperature", "0"]
    out = {}
    for name, mod, meta, model in (("jax", jcli, jmeta, jm), ("port", tcli, tmeta, tm)):
        monkeypatch.setattr(meta.MetaModel, "from_pretrained",
                            classmethod(lambda _cls, path, **kw: model))
        turns = iter(lines)
        monkeypatch.setattr("builtins.input", lambda *_: next(turns))
        mod.main(mod.get_args_parser().parse_args(argv))
        out[name] = capsys.readouterr().out
    assert "[ckptA] assistant:" in out["port"] and "[ckptB] assistant:" in out["port"]
    assert out["port"] == out["jax"]
