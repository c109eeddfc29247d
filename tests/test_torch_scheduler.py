"""Port parity, the continuous batcher: ``engine.scheduler.ContinuousBatcher``
of the port against the JAX package's on the same weights, tokenizer and
prompts, in the scenarios of tests/test_scheduler.py: greedy text must be
identical, and after every run the port's page allocator is balanced (every
page free but the TRASH page and those the prefix cache holds, no slot
holding pages). The model is that file's (a 2-layer dense f32 GQA LLaMA, dim
64, its tokenizer trained the same way); the port runs on the CPU through
its plain versions, the JAX package through its XLA gather route. The prefix
cache, speculative decoding and the soak are in
test_torch_scheduler_cache.py.
"""

import numpy as np
import pytest

from accessory_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from accessory_tpu.meta import MetaModel as JMetaModel

from accessory_tpu_torch.convert import params_from_jax
from accessory_tpu_torch.engine.scheduler import ContinuousBatcher
from accessory_tpu_torch.meta import MetaModel

from test_torch_generate import to_numpy_tree

CORPUS = ["the quick brown fox jumps over the lazy dog",
          "hello world this is a scheduler test"] * 30
CFG = {"dim": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "multiple_of": 32,
       "dtype": "float32"}


def make_models(tmp_path_factory):
    """(JAX MetaModel, the port's MetaModel on the CPU with the same weights
    and tokenizer file)."""
    from tokenizers import Tokenizer as HFTok
    from tokenizers import decoders, models, pre_tokenizers, trainers

    tk = HFTok(models.BPE(unk_token=None))
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    tk.decoder = decoders.ByteLevel()
    tr = trainers.BpeTrainer(vocab_size=300, special_tokens=["<s>", "</s>"],
                             initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tk.train_from_iterator(CORPUS, tr)
    path = str(tmp_path_factory.mktemp("tok") / "tokenizer.json")
    tk.save(path)
    jm = JMetaModel("llama", CFG, tokenizer_path=path, max_seq_len=256)
    tm = MetaModel("llama", CFG, tokenizer_path=path, max_seq_len=256, init_params=False,
                   device="cpu")
    tm.params = params_from_jax(to_numpy_tree(jm.params), tm.args, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return make_models(tmp_path_factory)


def batchers(models, **kw):
    """The JAX batcher and the port's, built alike."""
    jm, tm = models
    return (JBatcher(jm.module, jm.args, jm.params, jm.tokenizer, **kw),
            ContinuousBatcher(tm.module, tm.args, tm.params, tm.tokenizer, device="cpu", **kw))


def assert_balanced(cb):
    """Every page free but TRASH and the prefix cache's own references; no
    slot holds a page."""
    assert cb.pool.free_pages + len(cb._prefix_map) == cb.total_pages - 1
    assert all(not v for v in cb.slot_pages.values())
    assert all(r is None for r in cb.active.values()) and not cb.pending


def run_both(models, prompts, max_gen_len, **kw):
    """Both batchers' run() on the same prompts: identical text, the port's
    allocator balanced. Returns (texts, JAX batcher, port batcher)."""
    jb, tb = batchers(models, **kw)
    want = jb.run(prompts, max_gen_len=max_gen_len)
    got = tb.run(prompts, max_gen_len=max_gen_len)
    assert got == want
    assert_balanced(tb)
    return got, jb, tb


def drain(cb):
    guard = 0
    while cb.pending or any(r is not None for r in cb.active.values()):
        cb.step()
        guard += 1
        assert guard < 2000, "scheduler failed to drain"
    return guard


def test_scheduler_matches_jax(models):
    outs, _, _ = run_both(models, ["the quick brown", "hello world this"], 6, slots=2,
                          page_size=32)
    assert all(outs)


def test_more_requests_than_slots(models):
    prompts = ["the quick", "hello world", "brown fox", "lazy dog", "this is"]
    outs, _, _ = run_both(models, prompts, 5, slots=2, page_size=32)
    assert len(outs) == 5


def test_incremental_admission(models):
    """A request added after two steps joins the running batch; both
    requests' text equals the JAX package's."""
    texts = []
    for cb in batchers(models, slots=2, page_size=32):
        a = cb.add_request("the quick", max_gen_len=4)
        cb.step()
        cb.step()
        b = cb.add_request("hello world", max_gen_len=4)
        drain(cb)
        by_uid = {r.uid: r for r in cb.finished}
        assert set(by_uid) == {a, b}
        texts.append([cb.tokenizer.decode(by_uid[u].generated) for u in (a, b)])
    assert texts[1] == texts[0]
    assert_balanced(cb)


def test_small_pool_paging(models):
    """8 usable pages for 4 slots of 8 pages each: on-demand allocation."""
    prompts = ["the quick brown fox", "hello world this is", "jumps over the lazy",
               "scheduler test the"]
    outs, _, tb = run_both(models, prompts, 6, slots=4, page_size=32, total_pages=9)
    assert len(outs) == 4 and tb.pool.free_pages == tb.total_pages - 1


def test_preemption_recomputes_youngest(models):
    """A pool that runs dry mid-decode: the youngest request is preempted,
    re-queued with what it generated and recomputed on resume; the text is
    the JAX package's, which preempts alike."""
    prompts = ["the quick brown fox jumps", "hello world this is a", "lazy dog the quick"]
    _, _, tb = run_both(models, prompts, 14, slots=2, page_size=4, total_pages=8)
    assert tb.preemptions > 0


def test_page_growth_across_boundary(models):
    prompt = "the quick brown fox jumps over the lazy dog " * 2
    _, _, tb = run_both(models, [prompt], 40, slots=1, page_size=32)
    req = tb.finished[0]
    assert len(req.prompt_tokens) + len(req.generated) > 32


def test_multi_token_stop_sequence(models):
    """A stop sequence of two greedy tokens truncates both packages' output
    at the same place."""
    outs = []
    for cb0, cb in zip(batchers(models, slots=1, page_size=32),
                       batchers(models, slots=1, page_size=32)):
        cb0.add_request("the quick brown", max_gen_len=8)
        drain(cb0)
        toks = cb0.finished[0].output_tokens
        assert len(toks) >= 4
        cb.stop_seqs = cb.stop_seqs + (tuple(toks[2:4]),)
        cb.add_request("the quick brown", max_gen_len=8)
        drain(cb)
        assert cb.finished[0].output_tokens == toks[:2]
        outs.append(toks)
    assert outs[1] == outs[0]


def test_multi_step_decode_matches_single_step(models):
    """decode_steps=4 (four one-token forwards per dispatch, one host fetch)
    gives the text of decode_steps=1 and of the JAX package's decode_steps=4."""
    prompts = ["the quick brown fox", "hello world this", "lazy dog"]
    outs, _, _ = run_both(models, prompts, 9, slots=4, page_size=16, decode_steps=4)
    _, single = batchers(models, slots=4, page_size=16, decode_steps=1)
    assert single.run(prompts, max_gen_len=9) == outs


def test_chunked_prefill_matches_unchunked(models):
    prompts = ["the quick brown fox jumps over the lazy dog again and", "hello"]
    outs, _, _ = run_both(models, prompts, 6, slots=2, page_size=32, prefill_chunk=4)
    _, plain = batchers(models, slots=2, page_size=32)
    assert plain.run(prompts, max_gen_len=6) == outs


def test_single_slot_full_pool_prompt_admits(models):
    long_prompt = "the quick brown fox jumps over the lazy dog " * 10
    outs, _, tb = run_both(models, [long_prompt], 3, slots=1, page_size=32, pages_per_seq=4)
    assert len(tb.finished[0].prompt_tokens) > 3 * 32 and len(tb.finished[0].output_tokens) > 0


def test_overlong_prompt_clamped_to_page_capacity(models):
    texts = []
    for cb in batchers(models, slots=2, page_size=32, pages_per_seq=3):
        cb.add_request("hello world this is a scheduler test " * 30, max_gen_len=4)
        assert len(cb.pending[0].prompt_tokens) <= 3 * 32 - 1
        drain(cb)
        assert len(cb.finished) == 1
        texts.append(cb.tokenizer.decode(cb.finished[0].output_tokens))
    assert texts[1] == texts[0]
    assert_balanced(cb)


def test_never_admittable_request_fails_not_spins(models):
    for cb in batchers(models, slots=1, page_size=32, pages_per_seq=4, total_pages=3):
        cb.add_request("the quick brown fox " * 20, max_gen_len=4)
        assert len(cb.pending[0].prompt_tokens) > 2 * 32
        assert drain(cb) < 50
        assert len(cb.finished) == 1 and cb.finished[0].done
        assert cb.finished[0].output_tokens == []
    assert_balanced(cb)


def test_decode_fetches_one_token_tensor_per_dispatch(models, monkeypatch):
    """A dispatch of decode_steps one-token forwards samples on the device
    and the host fetches only the (slots, decode_steps) token ids: one fetch
    per dispatch, however many steps it holds."""
    _, tb = batchers(models, slots=2, page_size=16, decode_steps=3)
    shapes = []
    real = tb._decode

    def counted(*a, **kw):
        out = real(*a, **kw)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(tb, "_decode", counted)
    tb.run(["the quick brown", "hello world"], max_gen_len=7)
    assert shapes and all(s == (2, 3) for s in shapes)
    assert np.all(tb.h_len == 0)
