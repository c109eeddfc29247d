"""Port parity, the continuous batcher's options: prefix caching (reuse,
eviction under pressure, with chunked prefill, a forced hash collision) and
prompt-lookup speculative decoding (lookup proposals, an oracle proposer, the
fallback for sampled rows), against the JAX package's batcher in the
scenarios of tests/test_scheduler.py, and a randomized soak of the port's
batcher. Same model, tokenizer and rules as test_torch_scheduler.py: greedy
text identical, the allocator balanced after every run.
"""

import numpy as np
import pytest

from test_torch_scheduler import assert_balanced, batchers, drain, make_models, run_both


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return make_models(tmp_path_factory)


def test_prefix_cache_reuses_pages_and_matches(models):
    """A repeated prompt prefix is served from shared read-only pages: the
    text equals the uncached batcher's and the JAX package's, the hits are
    the JAX package's."""
    shared = "the quick brown fox jumps over the lazy dog and then"
    prompts1, prompts2 = [shared + " runs"], [shared + " sleeps", shared + " eats"]
    outs = []
    for prefix_cache in (False, True):
        jb, tb = batchers(models, slots=2, page_size=4, prefix_cache=prefix_cache)
        got = tb.run(prompts1, max_gen_len=4) + tb.run(prompts2, max_gen_len=4)
        want = jb.run(prompts1, max_gen_len=4) + jb.run(prompts2, max_gen_len=4)
        assert got == want and tb.prefix_hits == jb.prefix_hits
        assert_balanced(tb)
        outs.append(got)
    assert outs[1] == outs[0]
    assert tb.prefix_hits > 0 and len(tb._prefix_map) > 0


def test_prefix_cache_eviction_under_pressure(models):
    prompts = [f"prompt number {i} says the quick brown fox" for i in range(4)]
    outs, _, tb = run_both(models, prompts, 4, slots=2, page_size=4, total_pages=24,
                           prefix_cache=True)
    _, plain = batchers(models, slots=2, page_size=4, total_pages=24)
    assert plain.run(prompts, max_gen_len=4) == outs
    assert len(tb._prefix_map) < sum(len(tb.tokenizer.encode(p, bos=True, eos=False)) // 4
                                     for p in prompts)


def test_prefix_cache_with_chunked_prefill(models):
    shared = "the quick brown fox jumps over the lazy dog and then some"
    prompts = [shared + " runs", shared + " sleeps"]
    outs, _, _ = run_both(models, prompts, 4, slots=2, page_size=4, prefix_cache=True,
                          prefill_chunk=4)
    _, plain = batchers(models, slots=2, page_size=4)
    assert plain.run(prompts, max_gen_len=4) == outs


def test_prefix_cache_hash_collision_not_served(models):
    """Two prompts forced onto the same rolling-hash keys share no page:
    every hit is checked against the page's tokens."""
    p1 = "the quick brown fox jumps over the lazy dog " * 3
    p2 = "hello world this is a scheduler test hello " * 3
    jb, tb = batchers(models, slots=2, page_size=32, prefix_cache=True)
    for cb in (jb, tb):
        cb._prefix_keys = lambda tokens: [1234] * (len(tokens) // 32)
    got = tb.run([p1, p2], max_gen_len=6)
    assert got == jb.run([p1, p2], max_gen_len=6)
    _, plain = batchers(models, slots=2, page_size=32)
    assert plain.run([p1, p2], max_gen_len=6) == got
    assert_balanced(tb)


def test_speculative_lookup_decode_matches_greedy(models):
    """spec_lookup=4: the verify dispatch of 5 tokens per slot (the paged
    decode kernel's multi-query form) accepts what the JAX package accepts
    and gives the plain batcher's text."""
    prompts = ["the quick brown fox jumps over the lazy dog the quick brown fox jumps over",
               "hello world hello world hello"]
    outs, jb, tb = run_both(models, prompts, 12, slots=2, page_size=32, spec_lookup=4)
    assert tb.spec_steps == jb.spec_steps > 0 and tb.spec_accepted == jb.spec_accepted
    _, plain = batchers(models, slots=2, page_size=32)
    assert plain.run(prompts, max_gen_len=12) == outs


def test_speculative_accepts_correct_proposals(models):
    """An oracle proposer (the true greedy continuation) is accepted K + 1
    tokens a dispatch and the text is still the greedy one."""
    prompt = "the quick brown fox"
    jb, full = batchers(models, slots=1, page_size=32)
    want = jb.run([prompt], max_gen_len=12)
    full.run([prompt], max_gen_len=16)
    continuation = full.finished[0].output_tokens
    _, tb = batchers(models, slots=1, page_size=32, spec_lookup=3)
    plen = len(tb.tokenizer.encode(prompt, bos=True, eos=False))

    def oracle(ctx, K, n=2):
        done = len(ctx) - plen
        prop = continuation[done:done + K]
        return prop + [0] * (K - len(prop))

    tb._propose_lookup = oracle
    assert tb.run([prompt], max_gen_len=12) == want
    assert tb.spec_accepted > 0 and tb.spec_steps < 12
    assert_balanced(tb)


def test_speculative_falls_back_for_sampled_requests(models):
    """A batch with a sampled row decodes normally (no verify dispatch); the
    greedy row's text is the JAX package's."""
    texts = []
    for cb in batchers(models, slots=2, page_size=32, spec_lookup=4, seed=7):
        cb.add_request("hello world", max_gen_len=6, temperature=0.8)
        greedy = cb.add_request("the quick", max_gen_len=6)
        drain(cb)
        assert cb.spec_steps == 0 and len(cb.finished) == 2
        texts.append(next(cb.tokenizer.decode(r.output_tokens) for r in cb.finished
                          if r.uid == greedy))
    assert texts[1] == texts[0]
    assert_balanced(cb)


def test_randomized_soak_invariants(models):
    """Random prompt and generation lengths, shared prefixes, greedy and
    sampled rows, interleaved submission, a pool small enough for
    preemption and prefix eviction, two-step dispatches: every request
    finishes within its budget and the allocator balances."""
    rng = np.random.RandomState(7)
    words = "the quick brown fox jumps over lazy dog hello world this".split()
    _, cb = batchers(models, slots=4, page_size=32, total_pages=4 * 3 + 1, decode_steps=2,
                     prefix_cache=True)
    shared = "the quick brown fox jumps over "
    budget = {}
    for i in range(24):
        prompt = (shared if rng.rand() < 0.5 else "") + " ".join(
            rng.choice(words, rng.randint(2, 30)))
        gl = int(rng.randint(2, 12))
        budget[cb.add_request(prompt, max_gen_len=gl,
                              temperature=float(rng.choice([0.0, 0.8])))] = gl
        if i % 3 == 0:
            cb.step()
    drain(cb)
    assert len(cb.finished) == 24
    for r in cb.finished:
        assert len(r.output_tokens) <= budget[r.uid]
    assert_balanced(cb)
