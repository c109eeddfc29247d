"""Batched generation: one prefill forward, then a decode loop; and
single-prompt streaming.

Port of ``accessory_tpu/engine/generate.py::Generator`` (``generate``,
``stream_generate``, the ``unroll_decode`` switch). ``generate``: 64-token
buckets for the prompt prefix and the buffer, left-aligned prompt packing
with the prompt-mask overwrite, greedy or top-p sampling, stop sequences
matched wholly inside the generated tokens, per-row ``max_gen_len``
slicing, and an early exit once every row has stopped. The JAX package
compiles prefill and the decode loop into one device program a key
(``_compiled_loop``). Here prefill runs eagerly and each decode step
(sample, the prompt-mask overwrite, stop matching, then the one-token
forward) is one function of device buffers (``_DecodeState``): the position
is a device counter the step advances, ``tokens`` / ``mask`` and the stop
windows are indexed on the device, and a window that would start before 0
is masked on the device. On the card the step is captured once a key as a
CUDA graph and replayed (engine/graphs.py; the key is the reference's,
``(bsz, buffer length, temperature, top_p, stop sequences, image words)``,
without the prefill length, since prefill is not in the graph; the graph
holds the key's buffers and KV cache, ``GRAPH_KEYS`` keys a Generator).
The host only counts steps and reads the stop state every
``STOP_CHECK_EVERY`` steps; steps run after every row stopped cannot change
the output, which is sliced at each row's stop position. One graph holds
one step, so the stop check lands where it lands eagerly and
``last_decode_steps`` counts the same steps on both routes.
``stream_generate`` is a host loop that needs each token on the host, as in
the JAX package; its step (the one-token forward, then the next draw) is
captured the same way (the reference's ``_stream_step``).
``compiled=False`` runs every step eagerly on the card (the counterpart of
``jax.disable_jit()``); on the CPU the steps always run eagerly.

``ffn_fuse=True`` runs each decode step's FFN as one fused kernel call where
the weights allow it (models/llama.py ``_block``), the reference's
``ACCESSORY_FFN_FUSE=1``; off by default, as there.

``images`` (families with a visual branch: the SPHINX and SPHINX-MoE
families, through the ``encode_image`` hook ``MetaModel`` hands over): the
image words are spliced after each prompt's leading BOS in the prefill's
embeddings (the module's ``splice``), the cache holds ``n_image_words`` more
positions, every text position is shifted by ``n_image_words`` and the
text's length budget shrinks by as much. A model without the hook refuses
``images`` at the call; ``compute_logits`` hands them to the module's
forward wherever the params carry a ``visual`` branch (LLaMA-Adapter's
visual prefix, which has no ``encode_image``, as in the JAX package).

Scoring (the reference's OpenCompass interface): ``compute_logits`` is the
cache-free forward's f32 logits (text positions only with ``images``);
``evaluate_examples`` scores each continuation given its context
({loglikelihood, ppl, max_equal}): text examples batched by power-of-two
length buckets (64, 128, ...) at a fixed batch shape, zero rows padding a
short chunk; examples with an image one at a time (``_evaluate_one_mm``).

``unroll_decode=True`` (the default: the card is this package's accelerator)
takes effect for a module that sets ``SUPPORTS_UNROLLED_DECODE`` (every
family but LLaMA-Adapter, as in the JAX package): it fuses wqkv / w13 where
the module sets ``SUPPORTS_FUSED_QKV`` (LLaMA; not Mixtral, whose blocks
take separate projections) and decodes over per-layer caches with the fused
attention + write kernels. Otherwise the separate projections stay and the
model serves from a stacked cache: read-only attention in each layer and
one bulk write of all layers' new k/v per forward, the JAX package's path
wherever its unrolled loop is off.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from accessory_tpu_torch.engine.graphs import GraphPool, StepGraph, use_graphs
from accessory_tpu_torch.ops.sampling import sample_token
from accessory_tpu_torch.quant.fuse import fuse_for_decode

_BUCKET = 64
STOP_CHECK_EVERY = 8
GRAPH_KEYS = 4   # captured decode steps a Generator keeps, with their buffers (LRU)


def _round_up(x: int, m: int = _BUCKET) -> int:
    return max(m, (x + m - 1) // m * m)


def stop_token_seqs(tokenizer, stop_symbols: Iterable[str]) -> Tuple[Tuple[int, ...], ...]:
    """eos + each stop symbol tokenized as a segment and without a prefix
    space, deduplicated in order."""
    seqs = [(tokenizer.eos_id,)]
    for s in stop_symbols:
        seqs.append(tuple(tokenizer.encode_segment(s)))
        seqs.append(tuple(tokenizer.encode_wo_prefix_space(s)))
    seen, out = set(), []
    for s in seqs:
        if s not in seen:
            seen.add(s)
            out.append(s)
    return tuple(out)


def image_tensor(images, device) -> torch.Tensor:
    """Images (b, 3, S, S), numpy or torch, as f32 on ``device``."""
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.asarray(images, dtype=np.float32))
    return images.to(device, torch.float32)


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.to(torch.float32), dim=-1)


@dataclasses.dataclass
class _DecodeState:
    """The buffers a decode step reads and writes, which a captured step
    keeps: ``tokens`` / ``mask`` (bsz, buffer) and the KV ``cache`` (or, for
    streaming, ``tokens`` (1, 1), the token the next forward takes), ``last``
    the logits that pick the next token, ``cur`` the position the next step
    fills (0-d int64 on the device), the stop state, the generator. A kept
    state is reused with its cache zeroed (``reset``)."""
    tokens: torch.Tensor
    mask: Optional[torch.Tensor]
    cache: dict
    last: Optional[torch.Tensor]
    cur: torch.Tensor
    stopped: Optional[torch.Tensor]
    stop_pos: Optional[torch.Tensor]
    gen: torch.Generator
    seqs: Sequence[torch.Tensor] = ()   # the stop sequences on the device
    warm: bool = False
    graph: Optional[StepGraph] = None
    graphed: bool = False   # kept by the graph route, whose steps it captures

    def reset(self, seed: int) -> None:
        """A kept state's cache zeroed (a fresh one is zero) and its
        generator seeded."""
        if self.warm:
            for pools in self.cache.values():
                for t in (pools if isinstance(pools, list) else [pools]):
                    t.zero_()
        self.gen.manual_seed(seed)


def graph_rule(module, params, rows: int) -> bool:
    """A module's rule for capturing a decode step of ``rows`` token rows:
    its ``SUPPORTS_DECODE_GRAPH``, a bool or a predicate of (params, rows);
    on where the module sets none. A module that says no decodes eagerly on
    the card."""
    rule = getattr(module, "SUPPORTS_DECODE_GRAPH", True)
    return bool(rule(params, rows) if callable(rule) else rule)


class Generator:
    """Wraps a model module (``forward`` / ``init_kv_cache``), its args,
    per-layer params on ``device`` and a tokenizer. ``encode_image(params,
    images) -> image embeds (b, n_image_words, dim)``: the multimodal hook
    (None: the model has no visual branch). ``compiled``: on the card, replay
    each decode step as a captured CUDA graph (see the module docstring;
    False: run it eagerly)."""

    def __init__(self, module, args, params, tokenizer, kv_dtype=None, device="cuda",
                 unroll_decode: bool = True, ffn_fuse: bool = False, encode_image=None,
                 compiled: bool = True):
        self.module = module
        self.args = args
        self.tokenizer = tokenizer
        self.encode_image = encode_image
        self.kv_dtype = kv_dtype
        self.device = torch.device(device)
        self.unroll_decode = bool(unroll_decode) and getattr(module, "SUPPORTS_UNROLLED_DECODE",
                                                             False)
        self.ffn_fuse = bool(ffn_fuse)
        # fused wqkv / w13 only for a module whose blocks take them (the
        # reference's SUPPORTS_FUSED_QKV check); Mixtral's keep wq, wk, wv
        fuse = self.unroll_decode and getattr(module, "SUPPORTS_FUSED_QKV", False)
        self.params = fuse_for_decode(params) if fuse else params
        self.last_decode_steps = 0
        self.last_tokens = None  # the last run's token buffer (batch, buf_len), numpy
        self.compiled = bool(compiled)
        self.graphs = use_graphs(self.device, compiled)
        self._states: "OrderedDict[tuple, _DecodeState]" = OrderedDict()
        self._pool = GraphPool()

    def _state(self, key: tuple, make) -> _DecodeState:
        """The decode state of ``key`` (its first item the batch): kept (with
        its captured step) on the graph route, the newest GRAPH_KEYS keys;
        made anew on the eager route."""
        if not self.graphs or not graph_rule(self.module, self.params, key[0]):
            return make()
        st = self._states.pop(key, None)
        if st is None:
            st = make()
            st.graphed = True
            while len(self._states) >= GRAPH_KEYS:
                self._states.popitem(last=False)
        self._states[key] = st
        return st

    def _advance(self, st: _DecodeState, step) -> None:
        """One decode step: eagerly (the CPU, ``compiled=False``, a module's
        rule, a key's first step), else the key's captured step, captured at
        its second."""
        if not st.graphed:
            step()
            return
        if st.graph is None:
            if not st.warm:
                st.warm = True
                step()
                return
            st.graph = StepGraph(step, self._pool, (st.gen,))
        st.graph.replay()

    def _images(self, images):
        """(image embeds, n_image_words), or (None, 0) without images."""
        if images is None:
            return None, 0
        if self.encode_image is None:
            raise NotImplementedError(
                f"images: {self.module.__name__} has no visual branch to generate from (the "
                "multimodal families are llama_ens*, llama_qformerv2 and mixtral_sparse_ens*; "
                "llama_adapter takes images in compute_logits and scoring only)")
        embeds = self.encode_image(self.params, images)
        return embeds, embeds.shape[1]

    def _prefill(self, tokens, cache, embeds):
        """The position-0 forward of ``tokens``, with the image words spliced
        after the BOS (the module's ``splice``) when ``embeds`` is given."""
        kw = {} if embeds is None else {"embeds": self.module.splice(self.params, tokens, embeds)}
        return self.module.forward(self.params, self.args, tokens, cache=cache, cur_pos=0,
                                   ffn_fuse=self.ffn_fuse, **kw)

    @torch.no_grad()
    def generate(self, prompts: List[str], images=None, max_gen_len: int = 512,
                 temperature: float = 0.0, top_p: float = 0.95,
                 additional_stop_symbols: Iterable[str] = (), seed: int = 0) -> List[str]:
        if isinstance(prompts, str):
            raise ValueError("generate expects a batched LIST of prompts")
        embeds, n_image_words = self._images(images)
        bsz = len(prompts)
        prompt_tokens = [self.tokenizer.encode(x, bos=True, eos=False) for x in prompts]
        max_seq_len = self.args.max_seq_len - n_image_words
        keep = max(1, max_seq_len - max_gen_len)
        prompt_tokens = [t[-keep:] for t in prompt_tokens]
        min_prompt = min(len(t) for t in prompt_tokens)
        max_prompt = max(len(t) for t in prompt_tokens)
        total_len = min(max_seq_len, max_gen_len + max_prompt)
        buf_len = max(min(_round_up(total_len), max_seq_len), total_len)

        tokens = np.zeros((bsz, buf_len), np.int64)
        mask = np.zeros((bsz, buf_len), bool)
        for i, t in enumerate(prompt_tokens):
            tokens[i, :len(t)] = t
            mask[i, :len(t)] = True
        prefill_len = min(_round_up(min_prompt), buf_len)
        stop_seqs = stop_token_seqs(self.tokenizer, additional_stop_symbols)
        out_tokens, stop_pos = self._run(tokens, mask, prefill_len, min_prompt, total_len,
                                         temperature, top_p, stop_seqs, seed, embeds,
                                         n_image_words)
        decoded = []
        for i in range(bsz):
            plen = len(prompt_tokens[i])
            end = min(int(stop_pos[i]), plen + max_gen_len)
            decoded.append(self.tokenizer.decode(out_tokens[i, plen:end].tolist()))
        return decoded

    def _run(self, tokens_np, mask_np, prefill_len: int, start_pos: int, end: int,
             temperature: float, top_p: float, stop_seqs: Sequence[Tuple[int, ...]], seed: int,
             embeds=None, n_image_words: int = 0):
        dev, args = self.device, self.args
        bsz, buf_len = tokens_np.shape
        temperature, top_p = float(temperature), float(top_p)

        def make():
            cache = self.module.init_kv_cache(args, bsz, max_len=buf_len + n_image_words,
                                              kv_dtype=self.kv_dtype, device=dev,
                                              stacked=not self.unroll_decode)
            return _DecodeState(
                tokens=torch.zeros((bsz, buf_len), dtype=torch.int64, device=dev),
                mask=torch.zeros((bsz, buf_len), dtype=torch.bool, device=dev), cache=cache,
                last=torch.zeros((bsz, args.vocab_size), dtype=torch.float32, device=dev),
                cur=torch.zeros((), dtype=torch.int64, device=dev),
                stopped=torch.zeros(bsz, dtype=torch.bool, device=dev),
                stop_pos=torch.zeros(bsz, dtype=torch.int64, device=dev),
                gen=torch.Generator(device=dev),
                seqs=[torch.tensor(s, dtype=torch.int64, device=dev) for s in stop_seqs])

        key = (bsz, buf_len, temperature, top_p, tuple(stop_seqs), n_image_words)
        st = self._state(key, make)
        st.tokens.copy_(torch.from_numpy(tokens_np))
        st.mask.copy_(torch.from_numpy(mask_np))
        st.reset(seed)
        logits, _ = self._prefill(st.tokens[:, :prefill_len], st.cache, embeds)
        # the logits that pick position start_pos sit after the image words
        st.last.copy_(logits[:, start_pos - 1 + n_image_words])
        st.stopped.zero_()
        st.stop_pos.fill_(start_pos + 1)
        st.cur.fill_(start_pos)

        def step():
            self._decode_step(st, temperature, top_p, n_image_words)

        cur, steps = start_pos, 0
        while cur < end:
            if steps and steps % STOP_CHECK_EVERY == 0 and bool(st.stopped.all()):
                break
            self._advance(st, step)
            cur += 1
            steps += 1
        self.last_decode_steps = steps
        self.last_tokens = st.tokens.cpu().numpy()
        return self.last_tokens, st.stop_pos.cpu().numpy()

    def _decode_step(self, st: _DecodeState, temperature: float, top_p: float,
                     n_image_words: int) -> None:
        """One step of the decode loop on the device (the body of the
        reference's ``_compiled_loop``): sample from ``last``, keep the
        prompt's token where ``mask`` says so, match the stop sequences in the
        windows ending at ``cur`` (a window must lie wholly in generated tokens:
        one that starts before 0 or in the prompt is no match), then the
        one-token forward at ``cur`` and ``cur += 1``. Reads no value on the
        host."""
        bsz = st.tokens.shape[0]
        col = st.cur.reshape(1, 1).expand(bsz, 1)
        nxt = sample_token(st.last, st.gen, temperature, top_p)
        cur_mask = st.mask.gather(1, col)[:, 0]
        nxt = torch.where(cur_mask, st.tokens.gather(1, col)[:, 0], nxt)
        st.tokens.scatter_(1, col, nxt[:, None])
        st.stop_pos.copy_(torch.where(st.stopped, st.stop_pos, st.cur + 1))
        for seq_t in st.seqs:
            first = st.cur + 1 - seq_t.shape[0]
            idx = (first + torch.arange(seq_t.shape[0], device=first.device)).clamp_min(0)
            hit = (st.tokens.index_select(1, idx) == seq_t).all(dim=-1)
            in_prompt = st.mask.index_select(1, first.clamp_min(0).reshape(1))[:, 0]
            hit = hit & ~cur_mask & ~st.stopped & ~in_prompt & (first >= 0)
            st.stop_pos.copy_(torch.where(hit, first, st.stop_pos))
            st.stopped.logical_or_(hit)
        pos = st.cur + n_image_words if n_image_words else st.cur
        logits, _ = self.module.forward(self.params, self.args, st.tokens.gather(1, col),
                                        cache=st.cache, cur_pos=pos, ffn_fuse=self.ffn_fuse)
        st.last.copy_(logits[:, 0])
        st.cur.add_(1)

    def stream_generate(self, prompt: str, images=None, max_gen_len: int = 512,
                        temperature: float = 0.0, top_p: float = 0.95,
                        additional_stop_symbols: Iterable[str] = (),
                        seed: int = 0) -> Iterator[Dict[str, object]]:
        """One prompt, yielding {"text", "end_of_content"} after every token:
        the text decoded so far, cut at the first stop string once one shows
        up in it; eos ends the stream. ``images`` raises at the call, before
        the first token on a model without a visual branch."""
        if images is not None and self.encode_image is None:
            self._images(images)   # raises now, not at the first next()
        return self._stream(prompt, images, max_gen_len, temperature, top_p,
                            additional_stop_symbols, seed)

    @torch.no_grad()
    def _stream(self, prompt, images, max_gen_len, temperature, top_p, additional_stop_symbols,
                seed):
        dev, args = self.device, self.args
        tokens_l = self.tokenizer.encode(prompt, bos=True, eos=False)
        embeds, n_image_words = self._images(images)
        max_seq_len = args.max_seq_len - n_image_words
        tokens_l = tokens_l[-max(1, max_seq_len - max_gen_len):]
        start = len(tokens_l)
        total = min(max_seq_len, start + max_gen_len)
        stop_strs = list(additional_stop_symbols)
        prefill_len = _round_up(start)
        buf_len = max(min(_round_up(total), max_seq_len), total)
        temperature, top_p = float(temperature), float(top_p)

        def make():
            cache = self.module.init_kv_cache(args, 1, max_len=buf_len + n_image_words,
                                              kv_dtype=self.kv_dtype, device=dev,
                                              stacked=not self.unroll_decode)
            return _DecodeState(tokens=torch.zeros((1, 1), dtype=torch.int64, device=dev),
                                mask=None, cache=cache, last=None,
                                cur=torch.zeros((), dtype=torch.int64, device=dev),
                                stopped=None, stop_pos=None, gen=torch.Generator(device=dev))

        st = self._state((1, "stream", buf_len, temperature, top_p, n_image_words), make)
        st.reset(seed)
        prompt_t = torch.zeros((1, prefill_len), dtype=torch.int64, device=dev)
        prompt_t[0, :start] = torch.tensor(tokens_l, dtype=torch.int64)
        logits, _ = self._prefill(prompt_t, st.cache, embeds)
        st.tokens.copy_(sample_token(logits[0, start - 1 + n_image_words][None], st.gen,
                                     temperature, top_p)[:, None])
        st.cur.fill_(start + n_image_words)

        def step():
            # the forward of the token just drawn, at cur, then the next draw
            logits, _ = self.module.forward(self.params, args, st.tokens, cache=st.cache,
                                            cur_pos=st.cur, ffn_fuse=self.ffn_fuse)
            st.tokens.copy_(sample_token(logits[:, 0], st.gen, temperature, top_p)[:, None])
            st.cur.add_(1)

        generated: List[int] = []
        steps = 0
        for _ in range(start, total):
            nxt = int(st.tokens[0, 0])   # streaming: each token to the host
            if nxt == self.tokenizer.eos_id:
                break
            generated.append(nxt)
            text = self.tokenizer.decode(generated)
            hit = [s for s in stop_strs if s in text]
            if hit:
                self.last_decode_steps = steps
                yield {"text": text[:min(text.index(s) for s in hit)], "end_of_content": True}
                return
            yield {"text": text, "end_of_content": False}
            self._advance(st, step)
            steps += 1
        self.last_decode_steps = steps
        yield {"text": self.tokenizer.decode(generated), "end_of_content": True}

    # ------------------------------------------------------------ scoring

    def _tokens(self, examples) -> torch.Tensor:
        if isinstance(examples, torch.Tensor):
            return examples.to(device=self.device, dtype=torch.int64)
        return torch.as_tensor(np.asarray(examples), dtype=torch.int64, device=self.device)

    @torch.no_grad()
    def compute_logits(self, examples, images=None) -> torch.Tensor:
        """The cache-free forward's f32 logits (b, s, vocab) of token ids
        ``examples`` (b, s); with ``images`` (a model with a visual branch)
        the text positions' only."""
        tokens = self._tokens(examples)
        if images is None:
            return self.module.forward(self.params, self.args, tokens)[0]
        if self.encode_image is None and "visual" not in self.params:
            self._images(images)   # raises: no visual branch
        return self.module.forward(self.params, self.args, tokens,
                                   images=image_tensor(images, self.device))[0]

    def evaluate_examples(self, contexts: List[str], continuations: List[str], images=None,
                          batch_size: int = 8) -> List[Dict[str, object]]:
        """Per example {loglikelihood, ppl, max_equal} of the continuation
        given the context: the continuation's tokens of
        encode(context + continuation) are scored, ``max_equal`` is whether
        each is the argmax. Text examples: padded to a power-of-two bucket
        (at least 64, at most max_seq_len), ``batch_size`` rows a forward
        (a short chunk padded with scored-and-dropped rows); a sequence over
        max_seq_len loses context tokens after its BOS. With ``images`` (one
        a row) each example is scored alone."""
        if images is not None:
            return [self._evaluate_one_mm(c, x, images[i:i + 1])
                    for i, (c, x) in enumerate(zip(contexts, continuations))]
        max_len = self.args.max_seq_len
        items = []
        for i, (ctx, cont) in enumerate(zip(contexts, continuations)):
            ctx_t = self.tokenizer.encode(ctx, bos=True, eos=False)
            full_t = self.tokenizer.encode(ctx + cont, bos=True, eos=False)
            if len(full_t) > max_len:
                drop = len(full_t) - max_len
                full_t = full_t[:1] + full_t[1 + drop:]
                ctx_len = max(len(ctx_t) - drop, 1)
            else:
                ctx_len = len(ctx_t)
            items.append((i, full_t, ctx_len))

        def bucket(n):
            b = 64
            while b < n:
                b *= 2
            return min(b, max_len)

        results: List[Dict[str, object]] = [None] * len(items)
        by_bucket: Dict[int, list] = {}
        for it in items:
            by_bucket.setdefault(bucket(len(it[1])), []).append(it)
        for blen, group in sorted(by_bucket.items()):
            for off in range(0, len(group), batch_size):
                chunk = group[off:off + batch_size]
                toks = np.zeros((batch_size, blen), np.int64)
                ctx_l = np.ones((batch_size,), np.int64)
                full_l = np.full((batch_size,), 2, np.int64)
                for r, (_, full_t, cl) in enumerate(chunk):
                    toks[r, :len(full_t)] = full_t
                    ctx_l[r], full_l[r] = cl, len(full_t)
                ll, n, greedy_ok = (t.cpu().numpy() for t in self._score_examples(
                    toks, ctx_l, full_l))
                for r, (i, _, _) in enumerate(chunk):
                    results[i] = {"loglikelihood": float(ll[r]),
                                  "ppl": float(np.exp(-ll[r] / max(int(n[r]), 1))),
                                  "max_equal": bool(greedy_ok[r])}
        return results

    @torch.no_grad()
    def _score_examples(self, tokens, ctx_lens, full_lens):
        """(B, L) token ids -> (loglikelihood, continuation tokens,
        every-token-argmax) per row, over positions ctx_len - 1 ..
        full_len - 2 of the shifted targets."""
        tokens = self._tokens(tokens)
        ctx_lens = torch.as_tensor(ctx_lens, device=self.device)
        full_lens = torch.as_tensor(full_lens, device=self.device)
        logits = self.module.forward(self.params, self.args, tokens)[0]
        logp = _log_softmax(logits[:, :-1])
        tgt = tokens[:, 1:]
        tok_lp = torch.gather(logp, -1, tgt[..., None])[..., 0]
        pos = torch.arange(tokens.shape[1] - 1, device=self.device)[None, :]
        mask = (pos >= ctx_lens[:, None] - 1) & (pos < full_lens[:, None] - 1)
        ll = (tok_lp * mask).sum(dim=1)
        greedy_ok = ((logp.argmax(dim=-1) == tgt) | ~mask).all(dim=1)
        return ll, mask.sum(dim=1), greedy_ok

    def _evaluate_one_mm(self, ctx: str, cont: str, img) -> Dict[str, object]:
        """One example with its image (1, 3, S, S): the continuation scored
        from ``compute_logits``' text-position logits."""
        ctx_t = self.tokenizer.encode(ctx, bos=True, eos=False)
        full_t = self.tokenizer.encode(ctx + cont, bos=True, eos=False)
        logits = self.compute_logits([full_t], images=img)
        logp = _log_softmax(logits[0, :-1])
        tgt = torch.as_tensor(full_t[1:], device=logp.device)
        tok_lp = torch.gather(logp, 1, tgt[:, None])[:, 0]
        cont_lp = tok_lp[len(ctx_t) - 1:]
        max_equal = bool((logp[len(ctx_t) - 1:].argmax(dim=-1) == tgt[len(ctx_t) - 1:]).all())
        ll = float(cont_lp.sum())
        n = int(cont_lp.shape[0])
        return {"loglikelihood": ll, "ppl": float(np.exp(-ll / max(n, 1))),
                "max_equal": max_equal}
