"""Continuous batching over the paged KV cache.

Port of ``accessory_tpu/engine/scheduler.py`` (Request, ContinuousBatcher).
Fixed decode slots share one page pool on the device; requests are admitted
into free slots between decode dispatches, finished sequences release their
pages at once, and every dispatch advances all active slots together.

* Pages (engine/kvcache.py PagePool) are allocated at admission
  (ceil(prompt / page_size)) and grown one page at a time as decode crosses
  a page boundary. When the pool runs dry the youngest active request is
  preempted: its pages are released and it re-queues with its prompt plus
  what it generated so far as the new prompt (recompute on resume).
* Admission runs one prefill for the whole group at a common 64-token
  bucket, the group padded to a power of two with rows whose pages are all
  the TRASH page.
* Sampling happens on the device (ops.sampling.sample_token_batched): a
  dispatch of ``decode_steps`` one-token forwards advances the lengths on the
  device and the host fetches only the (slots, decode_steps) token ids, once.
* Decode reads only the first ``active_pages`` logical pages, the next power
  of two covering the longest active context.
* Multi-token stop sequences are matched on the host.
* Options: ``prefill_chunk`` (long prompts admitted as fixed-size
  continuation chunks), ``prefix_cache`` (full prompt pages shared read-only
  across requests, refcounted, LRU-evicted under pressure, every hit checked
  against the page's tokens) and ``spec_lookup=K`` (prompt-lookup
  speculative decoding for greedy batches: K proposals and the last token
  verified in one dispatch of K + 1 tokens per slot).

The reference compiles each step shape once (``_prefill_fn``, ``_decode_fn``,
``_verify_fn``, ``_chunk_prefill_fn``); here the same steps are plain
methods around ``forward_paged``. On the card the weights are fused once
(wqkv / w13, ``quant.fuse.fuse_for_decode``), as the reference does on its
accelerator. Random draws come from a ``torch.Generator`` on the device seeded
from ``seed``: sampled tokens differ from the reference's, greedy ones do not.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from accessory_tpu_torch.engine.generate import stop_token_seqs
from accessory_tpu_torch.engine.kvcache import PagePool
from accessory_tpu_torch.ops.sampling import sample_token_batched
from accessory_tpu_torch.quant.fuse import fuse_for_decode

_BUCKET = 64


def _round_up(x: int, m: int = _BUCKET) -> int:
    return max(m, (x + m - 1) // m * m)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@dataclasses.dataclass
class Request:
    uid: int
    prompt_tokens: List[int]
    max_gen_len: int
    temperature: float = 0.0
    top_p: float = 0.95
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # preemption folds generated tokens into prompt_tokens; orig_prompt_len
    # recovers the true completion
    orig_prompt_len: int = -1
    prefix_gen: int = 0
    admit_seq: int = 0  # admission order, for youngest-first preemption

    def __post_init__(self):
        if self.orig_prompt_len < 0:
            self.orig_prompt_len = len(self.prompt_tokens)

    @property
    def output_tokens(self) -> List[int]:
        return self.prompt_tokens[self.orig_prompt_len:] + self.generated

    @property
    def n_generated(self) -> int:
        return self.prefix_gen + len(self.generated)


class ContinuousBatcher:
    def __init__(self, module, args, params, tokenizer, slots: int = 8, page_size: int = 64,
                 pages_per_seq: Optional[int] = None, total_pages: Optional[int] = None,
                 seed: int = 0, stop_symbols: Iterable[str] = (), decode_steps: int = 1,
                 kv_dtype: Optional[str] = None, prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False, spec_lookup: int = 0, device="cuda"):
        self.device = torch.device(device)
        # decode_steps > 1: each dispatch decodes that many tokens per slot,
        # sampled on the device, before the one host fetch; up to
        # decode_steps - 1 tokens per request are wasted past a stop
        self.decode_steps = max(1, int(decode_steps))
        chunked = getattr(module, "SUPPORTS_CHUNKED_PREFILL", False)
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk and chunked else None
        self.prefix_cache = bool(prefix_cache and chunked)
        self._prefix_map: "OrderedDict[int, Tuple[int, Tuple[int, ...]]]" = OrderedDict()
        self._page_key: Dict[int, int] = {}
        self.prefix_hits = 0       # prompt pages served from the prefix cache
        self.spec_lookup = int(spec_lookup) if spec_lookup and chunked else 0
        self.spec_accepted = 0     # proposals accepted
        self.spec_steps = 0        # verify dispatches
        self.preemptions = 0
        if (self.device.type == "cuda" and getattr(module, "SUPPORTS_UNROLLED_PAGED", False)
                and getattr(module, "SUPPORTS_FUSED_QKV", False)):
            params = fuse_for_decode(params)   # wqkv / w13: 2 W4 launches a layer, not 5
        self.module = module
        self.args = args
        self.params = params
        self.tokenizer = tokenizer
        self.slots = slots
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq or (args.max_seq_len // page_size)
        # +1 for the TRASH page; by default the pool covers the worst case
        # (servers pass a smaller total_pages to oversubscribe)
        self.total_pages = total_pages or (slots * self.pages_per_seq + 1)
        self.pool = PagePool(self.total_pages)
        self.pcache = module.init_paged_cache(
            args, slots=slots, total_pages=self.total_pages, page_size=page_size,
            pages_per_seq=self.pages_per_seq, kv_dtype=kv_dtype, device=self.device)
        # host mirrors of the device page table and lengths
        self.page_table = np.full((slots, self.pages_per_seq), PagePool.TRASH, np.int32)
        self.h_len = np.zeros((slots,), np.int32)
        self.slot_pages: Dict[int, List[int]] = {s: [] for s in range(slots)}
        self.pcache = dataclasses.replace(self.pcache, page_indices=self._dev(self.page_table))
        self.active: Dict[int, Optional[Request]] = {i: None for i in range(slots)}
        self.pending: List[Request] = []
        self.finished: List[Request] = []
        self._uid = 0
        self._admit_seq = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.stop_seqs: Tuple[Tuple[int, ...], ...] = stop_token_seqs(tokenizer, stop_symbols)

    def _dev(self, arr: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=dtype, device=self.device)

    def add_request(self, prompt: str, max_gen_len: int = 128, temperature: float = 0.0,
                    top_p: float = 0.95) -> int:
        toks = self.tokenizer.encode(prompt, bos=True, eos=False)
        # clamp to both budgets: the model context minus the generation budget,
        # and the slot's page capacity minus one dispatch's writes
        margin = max(self.decode_steps, self.spec_lookup + 1)
        keep = max(1, min(self.args.max_seq_len - max_gen_len,
                          self.pages_per_seq * self.page_size - margin))
        toks = toks[-keep:]
        self._uid += 1
        self.pending.append(Request(self._uid, toks, max_gen_len, temperature, top_p))
        return self._uid

    # ------------------------------------------------------------------ steps

    def _forward(self, toks, pcache, **kw):
        return self.module.forward_paged(self.params, self.args, toks, pcache, **kw)

    @torch.no_grad()
    def _prefill(self, toks, sub, last_off, temps, topps, active_pages=None,
                 continuation=False):
        """One prefill (or continuation chunk) of the admitted group; samples
        each row's token at ``last_off`` on the device."""
        logits, sub = self._forward(toks, sub, active_pages=active_pages,
                                    continuation=continuation)
        last = logits[torch.arange(logits.shape[0], device=self.device), last_off.to(torch.int64)]
        return sample_token_batched(last, self._gen, temps, topps), sub

    @torch.no_grad()
    def _decode(self, toks, active_pages: int, n_steps: int, temps, topps):
        """n_steps one-token forwards of every slot in one dispatch; the
        lengths advance on the device. Returns (slots, n_steps) token ids on
        the device."""
        out = []
        pcache = self.pcache
        for _ in range(n_steps):
            logits, pcache = self._forward(toks, pcache, active_pages=active_pages)
            nxt = sample_token_batched(logits[:, -1], self._gen, temps, topps)
            out.append(nxt)
            toks = nxt[:, None]
        self.pcache = pcache
        return torch.stack(out, dim=1)

    @torch.no_grad()
    def _verify(self, toks, active_pages: int):
        """Speculative verify: K + 1 tokens per slot at its own offset; the
        greedy target at every position."""
        logits, self.pcache = self._forward(toks, self.pcache, active_pages=active_pages,
                                            continuation=True)
        return torch.argmax(logits, dim=-1)

    @staticmethod
    def _propose_lookup(ctx: List[int], K: int, n: int = 2) -> List[int]:
        """Prompt-lookup proposal: the K tokens that followed the latest
        earlier occurrence of the context's final n-gram (zero-padded)."""
        if len(ctx) <= n:
            return [0] * K
        pat = ctx[-n:]
        for p in range(len(ctx) - n - 1, -1, -1):
            if ctx[p:p + n] == pat:
                prop = ctx[p + n:p + n + K]
                return prop + [0] * (K - len(prop))
        return [0] * K

    # ------------------------------------------------------------------ prefix cache

    def _prefix_keys(self, tokens: List[int]) -> List[int]:
        """Rolling content hash per full prompt page (key j covers
        tokens[:(j + 1) * page_size])."""
        ps = self.page_size
        keys, h = [], 0
        for j in range(len(tokens) // ps):
            h = hash((h, tuple(tokens[j * ps:(j + 1) * ps])))
            keys.append(h)
        return keys

    def _match_prefix(self, tokens: List[int], keys: List[int]) -> List[int]:
        """Longest run of cached pages covering the prompt's head, capped so at
        least one prompt token is left to prefill; each hit's stored tokens
        are compared, so a hash collision is never served."""
        ps = self.page_size
        reused = []
        for j in range(min(len(keys), (len(tokens) - 1) // ps)):
            entry = self._prefix_map.get(keys[j])
            if entry is None or entry[1] != tuple(tokens[j * ps:(j + 1) * ps]):
                break
            reused.append(entry[0])
            self._prefix_map.move_to_end(keys[j])
        return reused

    def _register_prefix(self, slot: int, tokens: List[int], k0: int, keys: List[int]) -> None:
        """Publish the slot's freshly written full prompt pages (past the k0
        reused ones); the map holds a page reference of its own."""
        ps = self.page_size
        for j in range(k0, len(tokens) // ps):
            if keys[j] in self._prefix_map:
                continue
            page = int(self.page_table[slot, j])
            self.pool.share([page])
            self._prefix_map[keys[j]] = (page, tuple(tokens[j * ps:(j + 1) * ps]))
            self._page_key[page] = keys[j]

    def _evict_prefix(self, n: int) -> int:
        """Drop least recently used entries until about n pages came free."""
        freed = 0
        for key in list(self._prefix_map):
            if freed >= n:
                break
            page, _ = self._prefix_map.pop(key)
            del self._page_key[page]
            before = self.pool.free_pages
            self.pool.release([page])
            freed += self.pool.free_pages - before
        return freed

    # ------------------------------------------------------------------ paging

    def _release_slot(self, slot: int) -> None:
        self.pool.release(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.page_table[slot, :] = PagePool.TRASH
        self.h_len[slot] = 0
        self.active[slot] = None

    def _preempt_youngest(self) -> bool:
        """Requeue the most recently admitted active request, releasing its
        pages. False if nothing is active."""
        act = [(r.admit_seq, s) for s, r in self.active.items() if r is not None]
        if not act:
            return False
        _, slot = max(act)
        req = self.active[slot]
        req.prompt_tokens = req.prompt_tokens + req.generated
        req.prefix_gen += len(req.generated)
        req.generated = []
        self._release_slot(slot)
        self.pending.insert(0, req)
        self.preemptions += 1
        return True

    def _grow_pages(self, slot: int, ahead: int = 1) -> bool:
        """Pages for the slot's next ``ahead`` write positions."""
        need = (int(self.h_len[slot]) + ahead - 1) // self.page_size
        while need >= len(self.slot_pages[slot]):
            pg = self.pool.alloc(1)
            if pg is None and self._prefix_map:
                self._evict_prefix(1)
                pg = self.pool.alloc(1)
            if pg is None:
                return False
            self.page_table[slot, len(self.slot_pages[slot])] = pg[0]
            self.slot_pages[slot].append(pg[0])
        return True

    def _push_mirrors(self) -> None:
        """The host page table and lengths to the device (idle slots at 0)."""
        self.pcache = dataclasses.replace(self.pcache, page_indices=self._dev(self.page_table),
                                          lengths=self._dev(self.h_len))

    # ------------------------------------------------------------------ admission

    def _admit(self) -> List[Tuple[int, int]]:
        """Admit from the queue into free slots: allocate pages, run one
        bucketed prefill for the group, sample first tokens on the device.
        Returns [(slot, first token)]."""
        group: List[Tuple[int, Request]] = []
        reuse_k: Dict[int, int] = {}
        keys_by_slot: Dict[int, List[int]] = {}
        max_alloc = self.total_pages - 1  # page 0 is the TRASH page
        pool_full = False
        for slot in range(self.slots):
            if pool_full or self.active[slot] is not None or not self.pending:
                continue
            req = self.pending[0]
            plen = len(req.prompt_tokens)
            n_pages = -(-plen // self.page_size)
            if n_pages > max_alloc:
                # can never be admitted (the pool is smaller than the prompt):
                # fail it rather than spin the serving loop
                self.pending.pop(0)
                req.done = True
                self.finished.append(req)
                continue
            reused: List[int] = []
            keys: List[int] = []
            if self.prefix_cache:
                keys = self._prefix_keys(req.prompt_tokens)
                reused = self._match_prefix(req.prompt_tokens, keys)
                self.pool.share(reused)   # hold them before any eviction can free them
                self.prefix_hits += len(reused)
            need = n_pages - len(reused)
            # one page of headroom so the first decode steps cannot preempt
            # what was just admitted, unless the pool could never give it
            headroom = 1 if need < max_alloc else 0
            if self.pool.free_pages < need + headroom and self._prefix_map:
                self._evict_prefix(need + headroom - self.pool.free_pages)
            pages = self.pool.alloc(need) if self.pool.free_pages >= need + headroom else None
            if pages is None:
                self.pool.release(reused)
                pool_full = True  # FIFO: no younger request past this one
                continue
            self.pending.pop(0)
            row = reused + pages
            self.slot_pages[slot] = row
            self.page_table[slot, :] = PagePool.TRASH
            self.page_table[slot, :n_pages] = row
            self._admit_seq += 1
            req.admit_seq = self._admit_seq
            reuse_k[slot] = len(reused)
            keys_by_slot[slot] = keys
            group.append((slot, req))
        if not group:
            return []

        g = len(group)
        plens = np.array([len(r.prompt_tokens) for _, r in group], np.int32)
        # with prefix-cache reuse each slot prefills only its suffix, from its
        # own offset
        starts = np.array([reuse_k.get(s, 0) * self.page_size for s, _ in group], np.int32)
        slens = plens - starts
        bucket = min(_round_up(int(slens.max())), self.pages_per_seq * self.page_size)
        # the group padded to a power of two; pad rows write to the TRASH page
        gp = 1 << (g - 1).bit_length()
        toks = np.zeros((gp, bucket), np.int64)
        for i, (_, r) in enumerate(group):
            toks[i, :slens[i]] = r.prompt_tokens[starts[i]:]
        gslots = np.array([s for s, _ in group])
        slens_p = np.concatenate([slens, np.ones((gp - g,), np.int32)])
        starts_p = np.concatenate([starts, np.zeros((gp - g,), np.int32)])
        rows = np.concatenate([self.page_table[gslots],
                               np.full((gp - g, self.pages_per_seq), PagePool.TRASH, np.int32)])
        sub = dataclasses.replace(self.pcache, page_indices=self._dev(rows),
                                  lengths=self._dev(starts_p))
        temps = self._dev([r.temperature for _, r in group] + [1.0] * (gp - g), torch.float32)
        topps = self._dev([r.top_p for _, r in group] + [1.0] * (gp - g), torch.float32)
        cs = self.prefill_chunk
        if starts.any() or (cs and bucket > cs):
            # chunked prefill: fixed-size continuation chunks; every row
            # advances by the chunk size (a short prompt's overshoot lands in
            # the TRASH page, as the single-shot bucket's does); the host keeps
            # the sample of the chunk holding each prompt's last token and the
            # lengths are set to the prompt lengths below
            ce = min(cs, bucket) if cs else bucket
            n_ch = -(-bucket // ce)
            toks_pad = np.zeros((gp, n_ch * ce), np.int64)
            toks_pad[:, :bucket] = toks
            nxt = np.zeros((gp,), np.int64)
            max_start = int(starts_p.max())
            for c in range(n_ch):
                # power-of-two page buckets, as the decode dispatch's
                active = min(_next_pow2(max(1, -(-(max_start + c * ce) // self.page_size))),
                             self.pages_per_seq)
                last_off = np.clip(slens_p - 1 - c * ce, 0, ce - 1)
                nc, sub = self._prefill(self._dev(toks_pad[:, c * ce:(c + 1) * ce]), sub,
                                        self._dev(last_off), temps, topps, active_pages=active,
                                        continuation=True)
                hit = (slens_p - 1) // ce == c
                if hit.any():
                    nxt[hit] = nc.cpu().numpy()[hit]
        else:
            nxt, sub = self._prefill(self._dev(toks), sub, self._dev(slens_p - 1), temps, topps)
            nxt = nxt.cpu().numpy()

        # the pools were written in place; set the admitted lengths
        self.h_len[gslots] = plens
        self._push_mirrors()
        if self.prefix_cache:
            for slot, req in group:
                self._register_prefix(slot, req.prompt_tokens, reuse_k[slot], keys_by_slot[slot])
        first = []
        for i, (slot, req) in enumerate(group):
            tok = int(nxt[i])
            self.active[slot] = req
            self._append_token(req, tok)
            first.append((slot, tok))
        return first

    def _append_token(self, req: Request, tok: int) -> None:
        """Append, match stop sequences over everything the request generated
        (tokens folded into the prompt by a preemption included, so a stop
        sequence spanning the preemption is caught), check the budgets."""
        req.generated.append(tok)
        hist = req.prompt_tokens[req.orig_prompt_len:] + req.generated
        for seq in self.stop_seqs:
            n = len(seq)
            if len(hist) >= n and tuple(hist[-n:]) == seq:
                # strip the stop tokens, from generated first, then from the
                # folded part (both feed output_tokens)
                k_gen = min(n, len(req.generated))
                req.generated = req.generated[:len(req.generated) - k_gen]
                rem = n - k_gen
                if rem:
                    req.prompt_tokens = req.prompt_tokens[:-rem]
                    req.prefix_gen -= rem
                req.done = True
                return
        if req.n_generated >= req.max_gen_len:
            req.done = True
        # context capacity: one dispatch's writes short of the slot's pages, so
        # the next multi-step or speculative dispatch always fits
        margin = max(self.decode_steps, self.spec_lookup + 1)
        if (len(req.prompt_tokens) + len(req.generated)
                >= self.pages_per_seq * self.page_size - margin):
            req.done = True

    def _retire(self, slot: int, done_now: List[Request]) -> None:
        req = self.active[slot]
        done_now.append(req)
        self.finished.append(req)
        self._release_slot(slot)

    def step(self) -> List[Request]:
        """Admission, then one decode dispatch of every active slot. Returns
        the requests that finished."""
        self._admit()
        done_now: List[Request] = []
        for s in range(self.slots):   # done at admission (a stop on the first token)
            req = self.active[s]
            if req is not None and req.done:
                self._retire(s, done_now)
        act = [s for s, r in self.active.items() if r is not None]
        if not act:
            return done_now

        K = self.spec_lookup
        if K and all(self.active[s].temperature == 0.0 for s in act):
            return done_now + self._spec_step(act, K)

        n = self.decode_steps
        # pages for the next n writes; preempt the youngest when the pool is
        # dry (never below one active sequence)
        for s in list(act):
            while self.active[s] is not None and not self._grow_pages(s, n):
                if not self._preempt_youngest():
                    raise RuntimeError("page pool too small for one sequence")
        act = [s for s, r in self.active.items() if r is not None]
        if not act:
            return done_now

        toks = np.zeros((self.slots, 1), np.int64)
        temps = np.zeros((self.slots,), np.float32)
        topps = np.full((self.slots,), 0.95, np.float32)
        for s in act:
            toks[s, 0] = self.active[s].generated[-1]
            temps[s] = self.active[s].temperature
            topps[s] = self.active[s].top_p
        # context bucket: power-of-two pages covering the longest active
        # context with the n tokens this dispatch adds
        max_pages = max(1, -(-(int(self.h_len[act].max()) + n - 1) // self.page_size))
        active_pages = min(_next_pow2(max_pages), self.pages_per_seq)
        self._push_mirrors()
        nxt = self._decode(self._dev(toks), active_pages, n, self._dev(temps),
                           self._dev(topps)).cpu().numpy()   # the dispatch's one fetch

        # the device advanced every slot by n whatever the stops; the host
        # drops what lies past a stop
        self.h_len[act] += n
        for s in act:
            req = self.active[s]
            for j in range(n):
                self._append_token(req, int(nxt[s, j]))
                if req.done:
                    break
            if req.done:
                self._retire(s, done_now)
        return done_now

    def _spec_step(self, act: List[int], K: int) -> List[Request]:
        """One speculative dispatch for every active (greedy) slot: the last
        token and K lookup proposals; the longest verified run plus the next
        target are accepted, 1..K + 1 tokens."""
        done_now: List[Request] = []
        for s in list(act):
            while self.active[s] is not None and not self._grow_pages(s, K + 1):
                if not self._preempt_youngest():
                    raise RuntimeError("page pool too small for one sequence")
        act = [s for s, r in self.active.items() if r is not None]
        if not act:
            return done_now
        toks = np.zeros((self.slots, K + 1), np.int64)
        for s in act:
            req = self.active[s]
            toks[s, 0] = req.generated[-1]
            toks[s, 1:] = self._propose_lookup(req.prompt_tokens + req.generated, K)
        max_pages = max(1, -(-(int(self.h_len[act].max()) + K) // self.page_size))
        active_pages = min(_next_pow2(max_pages), self.pages_per_seq)
        self._push_mirrors()
        tgt = self._verify(self._dev(toks), active_pages).cpu().numpy()  # (slots, K + 1)
        self.spec_steps += 1
        for s in act:
            req = self.active[s]
            j = 0
            while j < K and tgt[s, j] == toks[s, j + 1]:
                j += 1
            self.spec_accepted += j
            # K + 1 positions were written; only the verified run is context,
            # the rest is overwritten before it is ever attended
            self.h_len[s] += j + 1
            for t in tgt[s, :j + 1]:
                self._append_token(req, int(t))
                if req.done:
                    break
            if req.done:
                self._retire(s, done_now)
        return done_now

    def run(self, prompts: List[str], max_gen_len: int = 64,
            temperature: float = 0.0) -> List[str]:
        """Queue every prompt, step until drained, return the texts in
        submission order."""
        ids = [self.add_request(p, max_gen_len, temperature) for p in prompts]
        while self.pending or any(r is not None for r in self.active.values()):
            self.step()
        by_uid = {r.uid: r for r in self.finished}
        return [self.tokenizer.decode(by_uid[i].output_tokens) for i in ids]
