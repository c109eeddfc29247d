"""Batched generation: one prefill forward, then a decode loop; and
single-prompt streaming.

Port of ``accessory_tpu/engine/generate.py::Generator`` (``generate``,
``stream_generate``, the ``unroll_decode`` switch). ``generate``: 64-token
buckets for the prompt prefix and the buffer, left-aligned prompt packing
with the prompt-mask overwrite, greedy or top-p sampling, stop sequences
matched wholly inside the generated tokens, per-row ``max_gen_len``
slicing, and an early exit once every row has stopped. The JAX package
compiles the loop into one device program; here it is a Python loop over
device tensors (the stop state stays on the device and is read back every
``STOP_CHECK_EVERY`` steps; steps run after every row stopped cannot change
the output, which is sliced at each row's stop position).
``stream_generate`` is a host loop over single-token forwards, as in the JAX
package: streaming needs each token on the host.

``unroll_decode=True`` (the default: the card is this package's accelerator)
fuses wqkv / w13 and decodes over per-layer caches with the fused attention +
write kernels. ``False`` keeps the separate projections and serves from a
stacked cache: read-only attention in each layer and one bulk write of all
layers' new k/v per forward, the JAX package's path wherever its unrolled
loop is off.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from accessory_tpu_torch.ops.sampling import sample_token
from accessory_tpu_torch.quant.fuse import fuse_for_decode

_BUCKET = 64
STOP_CHECK_EVERY = 8


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


class Generator:
    """Wraps a model module (``forward`` / ``init_kv_cache``), its args,
    per-layer params on ``device`` and a tokenizer."""

    def __init__(self, module, args, params, tokenizer, kv_dtype=None, device="cuda",
                 unroll_decode: bool = True):
        self.module = module
        self.args = args
        self.tokenizer = tokenizer
        self.kv_dtype = kv_dtype
        self.device = torch.device(device)
        self.unroll_decode = bool(unroll_decode)
        self.params = fuse_for_decode(params) if self.unroll_decode else params
        self.last_decode_steps = 0
        self.last_tokens = None  # the last run's token buffer (batch, buf_len), numpy

    @torch.no_grad()
    def generate(self, prompts: List[str], max_gen_len: int = 512, temperature: float = 0.0,
                 top_p: float = 0.95, additional_stop_symbols: Iterable[str] = (),
                 seed: int = 0) -> List[str]:
        if isinstance(prompts, str):
            raise ValueError("generate expects a batched LIST of prompts")
        bsz = len(prompts)
        prompt_tokens = [self.tokenizer.encode(x, bos=True, eos=False) for x in prompts]
        max_seq_len = self.args.max_seq_len
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
                                         temperature, top_p, stop_seqs, seed)
        decoded = []
        for i in range(bsz):
            plen = len(prompt_tokens[i])
            end = min(int(stop_pos[i]), plen + max_gen_len)
            decoded.append(self.tokenizer.decode(out_tokens[i, plen:end].tolist()))
        return decoded

    def _run(self, tokens_np, mask_np, prefill_len: int, start_pos: int, end: int,
             temperature: float, top_p: float, stop_seqs: Sequence[Tuple[int, ...]], seed: int):
        dev, args = self.device, self.args
        bsz, buf_len = tokens_np.shape
        tokens = torch.from_numpy(tokens_np).to(dev)
        mask = torch.from_numpy(mask_np).to(dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        cache = self.module.init_kv_cache(args, bsz, max_len=buf_len, kv_dtype=self.kv_dtype,
                                          device=dev, stacked=not self.unroll_decode)
        logits, cache = self.module.forward(self.params, args, tokens[:, :prefill_len],
                                            cache=cache, cur_pos=0)
        last = logits[:, start_pos - 1]
        stopped = torch.zeros(bsz, dtype=torch.bool, device=dev)
        stop_pos = torch.full((bsz,), start_pos + 1, dtype=torch.int64, device=dev)
        seq_ts = [torch.tensor(s, dtype=torch.int64, device=dev) for s in stop_seqs]
        cur, steps = start_pos, 0
        while cur < end:
            if steps and steps % STOP_CHECK_EVERY == 0 and bool(stopped.all()):
                break
            nxt = sample_token(last, gen, temperature, top_p)
            cur_mask = mask[:, cur]
            nxt = torch.where(cur_mask, tokens[:, cur], nxt)
            tokens[:, cur] = nxt
            stop_pos = torch.where(stopped, stop_pos, torch.full_like(stop_pos, cur + 1))
            for seq, seq_t in zip(stop_seqs, seq_ts):
                first = cur + 1 - len(seq)
                if first < 0:
                    continue
                hit = (tokens[:, first:cur + 1] == seq_t).all(dim=-1)
                hit = hit & ~cur_mask & ~stopped & ~mask[:, first]
                stop_pos = torch.where(hit, torch.full_like(stop_pos, first), stop_pos)
                stopped = stopped | hit
            logits, cache = self.module.forward(self.params, args, tokens[:, cur:cur + 1],
                                                cache=cache, cur_pos=cur)
            last = logits[:, 0]
            cur += 1
            steps += 1
        self.last_decode_steps = steps
        self.last_tokens = tokens.cpu().numpy()
        return self.last_tokens, stop_pos.cpu().numpy()

    @torch.no_grad()
    def stream_generate(self, prompt: str, max_gen_len: int = 512, temperature: float = 0.0,
                        top_p: float = 0.95, additional_stop_symbols: Iterable[str] = (),
                        seed: int = 0) -> Iterator[Dict[str, object]]:
        """One prompt, yielding {"text", "end_of_content"} after every token:
        the text decoded so far, cut at the first stop string once one shows
        up in it; eos ends the stream."""
        dev, args = self.device, self.args
        tokens_l = self.tokenizer.encode(prompt, bos=True, eos=False)
        max_seq_len = args.max_seq_len
        tokens_l = tokens_l[-max(1, max_seq_len - max_gen_len):]
        start = len(tokens_l)
        total = min(max_seq_len, start + max_gen_len)
        stop_strs = list(additional_stop_symbols)
        prefill_len = _round_up(start)
        buf_len = max(min(_round_up(total), max_seq_len), total)

        tokens = torch.zeros((1, buf_len), dtype=torch.int64, device=dev)
        tokens[0, :start] = torch.tensor(tokens_l, dtype=torch.int64)
        gen = torch.Generator(device=dev).manual_seed(seed)
        cache = self.module.init_kv_cache(args, 1, max_len=buf_len, kv_dtype=self.kv_dtype,
                                          device=dev, stacked=not self.unroll_decode)
        logits, cache = self.module.forward(self.params, args, tokens[:, :prefill_len],
                                            cache=cache, cur_pos=0)
        last = logits[0, start - 1]
        generated: List[int] = []
        steps = 0
        for cur in range(start, total):
            nxt = int(sample_token(last[None], gen, float(temperature), float(top_p))[0])
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
            tokens[0, cur] = nxt
            logits, cache = self.module.forward(self.params, args, tokens[:, cur:cur + 1],
                                                cache=cache, cur_pos=cur)
            last = logits[0, 0]
            steps += 1
        self.last_decode_steps = steps
        yield {"text": self.tokenizer.decode(generated), "end_of_content": True}
