#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (accessory_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--phases device,build,kernels,parity,serve,decode,
                                               checkpoint,parity8,paged_parity,serve8,stream,
                                               stacked,batcher,batcher8,preempt,server,
                                               decode8,decode_unfused,
                                               parity7b,serve7b,decode7b,parity_w8,
                                               parity_gptq,serve7b_w8,decode7b_w8,serve_gptq,
                                               decode_gptq,serve_magic,decode_magic,serve_w3,
                                               train_parity,train_qpeft7b,train_full,
                                               finetune,parity_ffn,serve_ffn,decode_ffn,
                                               decode7b_ffn,paged_ro,cp_shards,train_cp,
                                               parity_moe,serve_moe,decode_moe,batcher_moe,
                                               parity_zoo,serve_falcon40b,decode_falcon40b,
                                               serve_internlm7b,decode_internlm7b,
                                               torch_import]
                          [--out FILE] [--kernel_names w8_matmul,w4_matmul_std,...]
    python3 chip_smoke.py --phases device,build,compare   (parent / change timing)

Phases, each printing JSON lines (any failure raises and exits non-zero):
  device    the card (nvidia-smi name and power limit), torch and CUDA versions;
  build     compiles every kernel in accessory_tpu_torch/csrc with nvcc;
  kernels   each kernel against its plain PyTorch version on CUDA tensors at
            the main paths' shapes (TinyLlama-1.1B, LLaMA2-7B, Mixtral-8x7B,
            Falcon-40B and InternLM-7B, the last three tagged "mixtral",
            "falcon40b" and "internlm7b"): max error,
            kernel / plain / library-call device time (profiler CUDA trace,
            median of 3; inputs rotated through enough copies to spill the
            50 MB L2 where the model reads them cold), the kernel's wall time
            between CUDA events, and the bound from bytes and operations at the
            H100's 3.35 TB/s and 989 TFLOP/s (the fused FFN beside the unfused
            chain's device time, the read-only paged decode also against the
            paged decode after the token's paged write; where a plan splits K
            (the many-row W4 and W8 tiles, the GEMVs' clusters), a
            second launch bit-equal to the first and the unsplit plan within
            tolerance; the decode attention and KV-write rows carry out_sha, a
            digest of what they computed, so the same script run in a parent
            checkout shows whether the bits moved); --kernel_names keeps the
            rows of some kernels only;
  parity    TinyLlama width, 2 layers: CPU through the plain versions against
            the card through the kernels, prefill logits and 16 greedy decode
            steps (teacher-forced on the CPU tokens);
  serve     TinyLlama-1.1B shape (GQA), 22 layers, W4, random weights from
            --seed: 4 prompts through MetaModel.generate, with each kernel's
            launch count checked;
  decode    that model at the bench shape (batch 8, 1024-token cache, 100
            forward steps from position 512): ms per step against the bytes
            bound, with each kernel's launch count checked over the timed steps;
  checkpoint  that quantized 22-layer model saved with MetaModel.save_pretrained
            into a temporary directory (the native format the JAX package
            loads), read back with MetaModel.from_pretrained (the numpy
            reader; the stub tokenizer handed over as an object), every tensor
            compared bit for bit; the phases below run the loaded weights;
  parity8   as parity with the int8 KV cache (the fused GQA int8 kernel), and
            once over the stacked-cache path (separate projections, read-only
            attention, one bulk write), bf16 and int8;
  paged_parity  the paged path (forward_paged), TinyLlama width, 2 layers, bf16
            and int8 pools: 4 slots of 37 / 64 / 100 / 128 prompt tokens in one
            128-token prefill, 16 teacher-forced decode steps, a 5-token and a
            64-token continuation chunk, CPU against the card; a shuffled page
            table gives bit-identical logits to the identity table on the card;
  serve8    the loaded model through MetaModel.generate with kv_dtype="int8":
            4 prompts x 64 new tokens, launch counts exact;
  stream    MetaModel.stream_generate, one prompt, 64 new tokens, both cache
            types: the stream equals generate's greedy text, counts exact;
  stacked   Generator(unroll_decode=False).generate, both cache types: per step
            7 W4 launches and one read-only attention a layer and ONE stacked
            write, greedy tokens and first-step logits against the unrolled path;
  batcher, batcher8  continuous batching (ContinuousBatcher: 8 slots, 64-token
            pages, decode_steps=8) on the loaded weights with bf16 / int8 page
            pools: 16 requests of 128-token prompts, 64 new tokens; decode
            tok/s, time to first token, device busy ms per step and idle share,
            greedy tokens against the static Generator (printed); launches exact
            (from the batcher's forward_paged calls), the allocator balanced;
  preempt   the same over total_pages=17 (preemption must happen), then short
            passes with prefill_chunk=64, prefix_cache and spec_lookup=4;
  server    the HTTP server (demos/server.py, --continuous) on 127.0.0.1 with the
            loaded model: 8 concurrent /generate, /health, /chat, /stream_generate;
  decode8, decode_unfused  the bench shape with the int8 GQA cache, and with
            fused_attn_write=False (read-only attention + one-token write) for
            both cache types;
  parity7b  LLaMA2-7B width, 2 layers: the same CPU-vs-card comparison through
            a prefill of 8 x 128 = 1024 rows (the many-row W4 kernel) and 4
            decode steps, with the bf16 and with the int8 KV cache (2 layers
            keep the CPU side within about a minute; its seconds are printed);
  serve7b   LLaMA2-7B shape (MHA), 32 layers, W4, random weights from --seed: 8
            prompts in the 128-token bucket (1024 prefill rows) and 32 new
            tokens through MetaModel.generate, once with the bf16 and once with
            the int8 KV cache, with each kernel's launch count checked exactly;
  decode7b  that model at batch 8, 1024-token cache, 50 forward steps from
            position 512, in turns bf16, int8, int8, bf16 KV: ms per step
            against the bytes bound; then 20 steps with fused_attn_write=False
            for each cache type (the read-only one-query-head kernels);
  parity_w8  TinyLlama width, 2 layers, W8A16 (the w8 layout): CPU against the
            card as in parity (the W8 kernel's fused and unfused calls);
  parity_gptq  the same over GPTQ-style std W4 weights (zeros up to 16: the std
            kernel) and their magic repack (the magic kernel), and on the card
            the std model's prefill logits against the same weights folded
            (the W4 planes kernel) and magic;
  serve7b_w8, decode7b_w8  serve7b and decode7b (bf16 KV, 50 steps) with W8
            weights: every projection on the W8 kernel (decode and the 1024-row
            prefill), launch counts exact, the W8 kernel's share of a step;
  serve_gptq, decode_gptq, serve_magic, decode_magic  TinyLlama shape, 22
            layers, from an AutoGPTQ-format directory the script writes from
            --seed (load_gptq_dir + install_gptq_weights, rotary un-permuted):
            serve (4 prompts, 64 new tokens) and decode (batch 8, cache 1024,
            100 steps) on the std weights, then on their magic repack, launch
            counts exact (no w4_matmul);
  serve_w3  TinyLlama shape, W3 RTN (no kernel: dequant + matmul each call):
            4 prompts, 8 new tokens, wall ms a token step;
  train_parity  TinyLlama width, 2 layers, QPEFT (W4 base, LoRA 16, bias and
            norm tuning), bf16, batch 4 x 256, every layer checkpointed: one
            training step on the CPU (plain versions) and one on the card
            (kernels) from the same weights and batch: loss, every trainable
            gradient and the updated leaves within stated tolerances;
  train_qpeft7b  the repo's QPEFT configuration (bench_all.py's LLaMA2-7B: 32
            layers, W4 g128, LoRA 16, bias and norm tuning, batch 8 x 512, full
            remat): 1 warm-up and 5 timed steps: ms per step, tokens/s, model
            flops per second, peak memory, the losses (finite, falling: the same
            batch each step), launches per step (forward, recompute, backward),
            a profiled step split by kernel with the device's idle share;
  train_full  the 700M-class full finetune (dim 2048, 12 layers, 16 / 8 heads,
            batch 2 x 2048, f32 masters, AdamW on every leaf), the same figures;
  finetune  main_finetune.main at tiny size: a generated alpaca JSON through a
            YAML META config and the byte tokenizer, one epoch with --quant
            --only_save_trainable, the optimizer state read back bit for bit,
            and a second call that resumes for the next epoch;
  parity_ffn  as parity with ffn_fuse (each decode step's FFN one fused kernel
            call: CPU plain version vs card kernel), then on the card the fused
            route against the unfused one (logits at parity's tolerances,
            confident greedy tokens equal);
  serve_ffn, decode_ffn  (run after the loaded weights' decode phases) serve
            through MetaModel.generate with ffn_fuse, launch counts exact (2
            w4_matmul + 1 ffn_fused a layer a decode step), the text against
            the unfused route's and both routes' logits teacher-forced; decode
            at the bench shape in turns fused, unfused, unfused, fused;
  decode7b_ffn  (after decode7b) the 7B decode with ffn_fuse in the same turns;
  paged_ro  engine.kvcache.paged_attention_decode driven as a caller would (the
            reference has none): a one-token loop of paged writes and read-only
            paged attention at the TinyLlama shape, launch counts exact;
  cp_shards  context parallelism on the one card: at cp 2, 4 and 8 every shard's
            parallel.cp_shard_attention (the gather a torch.cat, the
            reduce-scatter a sum over shards), LLaMA2-7B width, S 8192, against
            the unsharded flash attention and its backward (outputs, lse and dq
            bit for bit); the shards' summed device time beside the unsharded
            kernels';
  train_cp  the context-parallel training step (make_train_step with
            attn_fn=parallel.make_cp_attn_fn(mesh)) in a one-rank NCCL group,
            the 7B QPEFT configuration at b 1, S 4096: one step against the same
            step without attn_fn (loss, gradients, updated leaves), then timed
            steps with the flash_attention_cp entries' launch counts exact (a
            cp group of more ranks needs a card a rank);
  parity_moe  Mixtral-8x7B width (dim 4096, 8 experts of 14336, 32 / 8 heads), one
            layer, W4 experts and attention (quantize_params of a seeded dense
            layer, the router f32): the CPU against the card, a 2 x 32 prefill and
            8 teacher-forced decode steps; routing agreement per (token, layer),
            each flip with the CPU's gap between its k-th and (k+1)-th router score
            (at most ROUTE_FLIP_GAP), logits at parity's tolerances where every
            layer's routing agreed;
  serve_moe  the full Mixtral-8x7B shape (32 layers, 8 experts, top 2), W4 g128
            built on the card from --seed (~27 GB; the dense model never exists):
            the 8 prompts (1024 prefill rows: every touched expert on the
            many-row kernel) and 32 new tokens through MetaModel.generate, bf16
            KV; launch counts exact, the W4 entries from the recorded routing
            (4 + 3 x touched experts a layer); setup s, peak GB, tok/s;
  decode_moe  that model at batch 8, 1024-token cache, bf16 then int8 KV: a
            counted 8 x 512 prefill (4096 rows), then 50 steps from position
            512: wall ms a step, the mean touched experts, the bytes bound from
            the recorded routing, device time by kernel with the GEMV's share,
            the idle share;
  batcher_moe  that model through ContinuousBatcher (4 slots, 64-token pages,
            bf16 pools): 8 requests of 128-token prompts, 32 new tokens; tok/s,
            TTFT, idle share, launches exact (the calls' shapes and routing);
  parity_zoo  Falcon-40B and InternLM-7B width (huggingface.co/tiiuae/falcon-40b
            and internlm/internlm-7b config.json), one layer each, W4: the CPU
            against the card through a 2 x 32 prefill and 4 teacher-forced
            decode steps, bf16 and int8 KV, logits at parity's tolerances;
  serve_falcon40b, serve_internlm7b  the full models (60 layers, 128 / 8 heads
            of 64, FFN 32768, vocab 65024; 32 layers, MHA of 128, FFN 11008,
            biased Wqkv, vocab 103168), W4 g128 built on the card from --seed:
            the 8 prompts (1024 prefill rows) and 32 new tokens through
            MetaModel.generate, bf16 KV, launch counts exact (6 / 5 W4 products
            a layer); setup s, peak GB, prefill ms, tok/s;
  decode_falcon40b, decode_internlm7b  those models at batch 8, cache 1024,
            30 steps from position 512, bf16 then int8 KV: wall ms a step, the
            bytes bound, device time by kernel (row 1, attention, the head,
            the eager elementwise and reduction kernels) and the idle share;
  torch_import  a consolidated.00-of-02 / 01-of-02 pair at InternLM-7B width
            (2 layers) written with torch.save, loaded through
            MetaModel.from_pretrained(..., quant=True): every leaf and the
            greedy tokens equal to the same tensors built in memory;
  compare   (not in the default run) rows 5, 3 and 26's forward through calls
            every version of the package has had (planes_qmm_bigm's and the
            flash forward's own arguments), device time and the library
            yardstick: copied into a checkout of an earlier commit, it times
            both trees in turns on one card.
The line before the last holds the kernel table ({"kernels": [...]}, launches
summed over the counted main-path runs); the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import subprocess
import shutil
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20

TINYLLAMA = dict(dim=2048, n_layers=22, n_heads=32, n_kv_heads=4, vocab_size=32000,
                 multiple_of=256, dtype="bfloat16")
# TinyLlama's decode-layer projections (name, K, N, the fusion the decode
# path gives them)
TINY_PROJ = [("wqkv", 2048, 2560, "norm+rope"), ("wo", 2048, 2048, "res"),
             ("w13", 2048, 11264, "norm"), ("w2", 5632, 2048, "res")]
LLAMA2_7B = dict(dim=4096, n_layers=32, n_heads=32, vocab_size=32000, multiple_of=256,
                 dtype="bfloat16")
MIXTRAL_8X7B = dict(dim=4096, n_layers=32, n_heads=32, n_kv_heads=8, hidden_dim=14336,
                    num_experts=8, num_experts_per_tok=2, vocab_size=32000, rope_theta=1e6,
                    dtype="bfloat16")
# Falcon-40B (huggingface.co/tiiuae/falcon-40b config.json) and InternLM-7B
# (huggingface.co/internlm/internlm-7b config.json) at full width
FALCON_40B = dict(num_layers=60, hidden_size=8192, num_attention_heads=128, num_kv_heads=8,
                  new_decoder_architecture=True, parallel_attn=True, bias=False,
                  vocab_size=65024, layer_norm_epsilon=1e-5, dtype="bfloat16")
INTERNLM_7B = dict(num_layers=32, hidden_size=4096, num_attention_heads=32, mlp_ratio=8 / 3,
                   multiple_of=256, norm_type="rmsnorm", layer_norm_epsilon=1e-6, bias=True,
                   vocab_size=103168, dtype="bfloat16")
# their W4 products (name, K, N) where the LLaMA2-7B rows do not already
# hold the shape (InternLM's out_proj is 7B's wo; its w3's K 11008 is padded
# to 11264 in the weight)
FALCON_PROJ = [("wq/dense", 8192, 8192), ("wk/wv", 8192, 512), ("h_to_4h", 8192, 32768),
               ("4h_to_h", 32768, 8192)]
INTERNLM_PROJ = [("Wqkv", 4096, 12288), ("w1/w2", 4096, 11008), ("w3", 11008, 4096)]
# Mixtral's quantized products (name, K, N): the attention projections and
# one expert's
MIXTRAL_PROJ = [("wq/wo", 4096, 4096), ("wk/wv", 4096, 1024), ("w1/w3", 4096, 14336),
                ("w2", 14336, 4096)]
KERNEL_NAMES = ("w4_matmul", "w4_matmul_bigm", "decode_attention", "decode_attention8",
                "decode_attention_ro", "decode_attention8_ro", "decode_attention_mha",
                "decode_attention_mha8", "decode_attention_mha_ro", "decode_attention_mha8_ro",
                "flash_attention", "kv_write", "kv_write_q8", "kv_write_col", "kv_write_col_q8",
                "kv_write_stacked", "kv_write_stacked_col", "kv_write_stacked_q8",
                "paged_decode", "paged_decode8", "paged_write", "paged_write_q8",
                "w4_dequant", "flash_attention_bwd_dq", "flash_attention_bwd_dkdv",
                "w8_matmul", "w4_matmul_std", "w4_matmul_magic", "paged_decode_ro", "ffn_fused",
                "flash_attention_cp", "flash_attention_cp_bwd_dq", "flash_attention_cp_bwd_dkdv")

_out_file = None
_empty_traces = 0   # profiler traces that came back without device events
_short_traces = 0   # profiler traces that lost some kernel events


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if _out_file is not None:
        _out_file.write(line + "\n")
        _out_file.flush()


class ByteTokenizer:
    """Bytes 0..255, BOS 256, EOS 257 (the machine has no tokenizer files)."""

    bos_id, eos_id, n_words = 256, 257, 258

    def encode(self, s, bos, eos):
        return ([self.bos_id] if bos else []) + list(s.encode()) + ([self.eos_id] if eos else [])

    def decode(self, t):
        # ids past the byte range (a random model emits them) show as "?"
        return bytes(x if x < 256 else 63 for x in t).decode("utf-8", errors="replace")

    def encode_segment(self, s):
        return self.encode(s.lstrip(" "), False, False)

    def encode_wo_prefix_space(self, s):
        return self.encode(s, False, False)


def bound_ms(nbytes: float, flops: float, rate: float = BF16_FLOPS_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def time_ms(fn, arg_sets, min_iters: int = 30, repeats: int = 3, by=None):
    """Device ms per call over round-robin argument sets: the summed duration
    of every kernel the calls launched, from the profiler's CUDA trace, so
    host overhead between launches is not counted; the median of ``repeats``
    traces, so one stray in a trace does not make the reading. The CUDA
    trace sometimes loses kernel events (all, or a few of a run's), and the
    sum of a trace that lost some reads low. A trace without device time is
    taken again, up to 5 times in all, and then it raises: no other clock
    stands in for it. A trace that holds fewer kernel events than calls
    (every call launches one at least), or than another trace of the same
    calls, is taken again up to twice, then used. Both are counted
    (``_empty_traces``, ``_short_traces``). ``by``: kernel-name substrings;
    then {substring: ms per call} of the kernels whose name holds each."""
    global _empty_traces, _short_traces
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    n = len(arg_sets) * max(1, math.ceil(min_iters / len(arg_sets)))
    per_call, most = [], 0
    for _ in range(repeats):
        events, shorts = None, 0
        for _attempt in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(n):
                    fn(*arg_sets[i % len(arg_sets)])
                torch.cuda.synchronize()
            got = [(e.key, getattr(e, "self_device_time_total", 0), e.count)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            if sum(us for _, us, _ in got) <= 0:
                _empty_traces += 1
                continue
            events, count = got, sum(c for _, _, c in got)
            most = max(most, count)
            if count >= max(n, most):
                break
            _short_traces += 1
            shorts += 1
            if shorts == 3:
                break
        if events is None:
            raise RuntimeError("time_ms: 5 profiler traces in a row held no device time")
        if by is None:
            per_call.append(sum(us for _, us, _ in events) / 1e3 / n)
        else:
            per_call.append({sub: sum(us for key, us, _ in events if sub in key) / 1e3 / n
                             for sub in by})
    if by is None:
        return statistics.median(per_call)
    return {sub: statistics.median(c[sub] for c in per_call) for sub in by}


def wall_ms(fn, arg_sets, min_iters: int = 30) -> float:
    """Ms per call between CUDA events around back-to-back calls: includes
    the host's launch overhead wherever the host is slower than the card."""
    import torch

    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    n = len(arg_sets) * max(1, math.ceil(min_iters / len(arg_sets)))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def n_copies(bytes_per_call: float, most: int = 32) -> int:
    return max(1, min(most, math.ceil(2 * L2_BYTES / max(bytes_per_call, 1))))


def max_err(got, want):
    d = (got.float() - want.float()).abs()
    return float(d.max()), float((d / want.float().abs().clamp_min(1.0)).max())


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values (8 significant bits) at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


def check_close(name, got, want, rtol, atol, rel_l2=1e-2):
    """Elementwise |got - want| <= atol + rtol |want|, and the whole output's
    relative L2 error ||got - want|| / ||want|| <= rel_l2. The L2 check holds
    outputs of small typical size (a softmax average over many tokens) to
    what is compared: one token dropped or counted twice moves it by ~1/pos
    of |v| in every element, several percent, while bf16 rounding of one
    side's output alone gives ~0.2%."""
    import torch

    g, w = got.float(), want.float()
    bad = (g - w).abs() > atol + rtol * w.abs()
    l2 = float((g - w).norm() / w.norm().clamp_min(1e-30))
    if not torch.isfinite(g).all() or bool(bad.any()) or l2 > rel_l2:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"({int(bad.sum())} elements beyond atol {atol} rtol {rtol}; "
                             f"max abs err {max_err(got, want)[0]:.4g}; "
                             f"relative L2 {l2:.3g} against {rel_l2})")


def out_sha(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes: the same
    script run in two checkouts draws the same inputs from --seed, so two
    rows agree on it where the two trees' kernels wrote the same bits."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def check_pools8(name, got, want):
    """int8 pools equal; f32 scale pools to f32 rounding (2e-7 relative)."""
    import torch

    gk, gv, gks, gvs = got
    wk, wv, wks, wvs = want
    if not (torch.equal(gk, wk) and torch.equal(gv, wv)):
        raise AssertionError(f"{name}: int8 pools differ from the plain version's "
                             f"({int((gk != wk).sum()) + int((gv != wv).sum())} entries)")
    for g, w in ((gks, wks), (gvs, wvs)):
        if bool(((g - w).abs() > 2e-7 * w.abs()).any()):
            raise AssertionError(f"{name}: scale pools differ beyond f32 rounding")


# ---------------------------------------------------------------- phases


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def phase_build():
    from accessory_tpu_torch import kernels

    t0 = time.perf_counter()
    paths = kernels.build_all()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name in paths:
        ptxas[name] = [ln.strip() for ln in kernels.build_log(name).splitlines()
                       if "registers" in ln or "spill" in ln][:12]
    emit({"phase": "build", "seconds": round(secs, 3),
          "libraries": {n: str(p) for n, p in paths.items()}, "ptxas": ptxas})


class KernelRows:
    """The kernels phase's rows by kernel, each emitted as it is measured."""

    def __init__(self, seed: int):
        import torch

        self.gen = torch.Generator(device="cuda").manual_seed(seed)
        self.rows = {name: [] for name in KERNEL_NAMES}

    def randn(self, *shape, dtype=None, scale=1.0):
        import torch

        x = torch.randn(shape, generator=self.gen, device="cuda") * scale
        return x.to(dtype or torch.bfloat16)

    def record(self, kernel, shape, err, k_ms, k_wall, p_ms, lib_ms, nbytes, flops,
               rate=BF16_FLOPS_PER_S, **extra):
        b_ms, b_by = bound_ms(nbytes, flops, rate)
        row = {"kernel": kernel, "shape": shape, "max_abs_err": err[0], "max_rel_err": err[1],
               "ms": k_ms, "wall_ms": k_wall, "plain_ms": p_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops, **extra}
        self.rows[kernel].append(row)
        emit({"phase": "kernels", **row})


def _w4_weight_sets(kr, m, k, n, fusion, rope, copies=None):
    """Argument sets for one W4 projection: a fresh quantized weight per copy
    (so a round-robin spills L2) plus the dense weight for the yardstick."""
    import torch

    from accessory_tpu_torch.quant.qtensor import (dequantize_weight, quantize_weight,
                                                   to_folded_layout)
    from accessory_tpu_torch.quant.quantize import pad_to

    cos_rows, sin_rows, style, hd = rope
    qw_bytes = k * n // 2 + 2 * (k // 128) * n * 4
    io_bytes = m * k * 2 + m * n * 2 + (m * n * 2 if fusion == "res" else 0) \
        + (k * 4 if "norm" in fusion else 0) + (2 * n * 4 if "rope" in fusion else 0)
    sets = []
    for _ in range(copies or n_copies(qw_bytes + io_bytes)):
        w = kr.randn(k, n, dtype=torch.float32, scale=k ** -0.5)
        qw = to_folded_layout(quantize_weight(w, 4, 128, pad_in_to=pad_to(k, 128)))
        del w
        args = dict(x2d=kr.randn(m, k), packed=qw.packed, scales=qw.scales, zs=qw.zeros,
                    norm_weight=(1 + 0.1 * kr.randn(k, dtype=torch.float32))
                    if "norm" in fusion else None,
                    residual=kr.randn(m, n) if fusion == "res" else None,
                    rope_cos=cos_rows[511] if "rope" in fusion else None,
                    rope_sin=sin_rows[511] if "rope" in fusion else None,
                    in_dim=qw.in_dim, group_size=128,
                    rope_style=style if "rope" in fusion else "",
                    rope_hd=hd if "rope" in fusion else 0)
        sets.append((args, dequantize_weight(qw, torch.bfloat16)[:k]))
    return sets, qw_bytes + io_bytes


def _split_check(label, split, got, want, launch):
    """Where a kernel's plan splits K (the many-row W4 and W8 tiles, the
    GEMVs' clusters): a second launch bit-equal to the first (the
    partials are summed in split order) and the unsplit plan
    (``launch(1)``) within the rows' tolerance; the row's extra fields."""
    import torch

    extra = {"split": split}
    if split > 1:
        again, unsplit = launch(None), launch(1)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{label}: two launches of the split-{split} plan differ")
        check_close(f"{label} unsplit", unsplit, want, rtol=2e-2, atol=2e-2)
        extra.update(split_bit_equal=True,
                     split_vs_unsplit_max_abs_err=max_err(got, unsplit)[0])
    return extra


def _kernels_w4(kr, tag, specs, ms, rope):
    """planes_qmm (GEMV for M <= 16, the many-row tile above) with its
    fusions; the GEMV's cluster split and the tile's K split checked
    (``_split_check``)."""
    import torch

    from accessory_tpu_torch.ops import w4_tile
    from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm, planes_qmm_plain

    for m in ms:
        for name, k, n, fusion in specs:
            sets, nbytes = _w4_weight_sets(kr, m, k, n, fusion, rope)
            a0 = sets[0][0]
            got = planes_qmm(**a0)
            want = planes_qmm_plain(**a0)
            torch.cuda.synchronize()
            check_close(f"w4_matmul {tag} {name} M={m}", got, want, rtol=2e-2, atol=2e-2)
            split = (w4_tile.folded_gemv_split(n, k) if m <= 16 else
                     w4_tile.folded_plan(m, n, k, 128).split)
            extra = _split_check(f"w4_matmul {tag} {name} M={m}", split, got, want,
                                 lambda sp: planes_qmm(**a0, split=sp))
            k_ms = time_ms(lambda a: planes_qmm(**a), [(s[0],) for s in sets])
            k_wall = wall_ms(lambda a: planes_qmm(**a), [(s[0],) for s in sets])
            p_ms = time_ms(lambda a: planes_qmm_plain(**a), [(s[0],) for s in sets[:1]],
                           min_iters=3)
            lib_ms = time_ms(lambda x, d: torch.matmul(x, d),
                             [(s[0]["x2d"], s[1]) for s in sets])
            kr.record("w4_matmul", f"{tag} {name} M={m} K={k} N={n} {fusion}",
                      max_err(got, want), k_ms, k_wall, p_ms, lib_ms, nbytes, 2.0 * m * k * n,
                      **extra)
            del sets


def _kernels_bigm(kr, specs, tag="7b"):
    """planes_qmm_bigm at the 7B prefill's 1024 rows, the QPEFT step's 8 x 512
    = 4096 and one ragged row count, beside row 1's many-row tile
    (w4_matmul.cu, M > 16) on the same inputs: its C entry is called directly
    (``_kernel_call``, not counted), since planes_qmm refuses M >= 1024. Two
    launches, and a launch on another persistent grid (61 blocks), give the
    same bits (no K split: one f32 sum an output, whatever the grid)."""
    import torch

    from accessory_tpu_torch.ops import w4_tile
    from accessory_tpu_torch.ops.quant_matmul_bigm import (planes_qmm_bigm,
                                                           planes_qmm_bigm_plain)
    from accessory_tpu_torch.ops.quant_matmul_planes import _kernel_call

    def tile_kernel(x2d, packed, scales, zs, in_dim, group_size):
        out = torch.empty((x2d.shape[0], packed.shape[1]), dtype=torch.bfloat16,
                          device=x2d.device)
        rc = _kernel_call(x2d, packed, scales, zs, None, None, None, None, out,
                          group_size=group_size)
        if rc != 0:
            raise RuntimeError(f"w4_matmul tile kernel launch failed: CUDA error {rc}")
        return out

    none_rope = (None, None, "", 0)
    for name, k, n, m in specs:
        sets, nbytes = _w4_weight_sets(kr, m, k, n, "", none_rope)
        calls = [(dict(x2d=s[0]["x2d"], packed=s[0]["packed"], scales=s[0]["scales"],
                       zs=s[0]["zs"], in_dim=s[0]["in_dim"], group_size=128),) for s in sets]
        a0 = calls[0][0]
        got = planes_qmm_bigm(**a0)
        want = planes_qmm_bigm_plain(**a0)
        tile = tile_kernel(**a0)
        again, regrid = planes_qmm_bigm(**a0), planes_qmm_bigm(**a0, ctas=61)
        torch.cuda.synchronize()
        # same bf16 weights and f32 sums in another order: one bf16 rounding step
        check_close(f"w4_matmul_bigm {name} M={m}", got, want, rtol=1e-2, atol=1e-2, rel_l2=5e-3)
        if not (torch.equal(got, again) and torch.equal(got, regrid)):
            raise AssertionError(f"w4_matmul_bigm {name} M={m}: two launches, or two grids, "
                                 "give different bits")
        del again, regrid
        # the tile kernel keeps q exact (another dequant form): held as in the w4_matmul rows
        check_close(f"w4_matmul tile {name} M={m}", tile, want, rtol=2e-2, atol=2e-2)
        k_ms = time_ms(lambda a: planes_qmm_bigm(**a), calls)
        k_wall = wall_ms(lambda a: planes_qmm_bigm(**a), calls)
        t_ms = time_ms(lambda a: tile_kernel(**a), calls)
        p_ms = time_ms(lambda a: planes_qmm_bigm_plain(**a), calls[:1], min_iters=3)
        lib_ms = time_ms(lambda x, d: torch.matmul(x, d), [(s[0]["x2d"], s[1]) for s in sets])
        plan = w4_tile.bigm_plan(m, n)
        kr.record("w4_matmul_bigm", f"{tag} {name} M={m} K={k} N={n}", max_err(got, want), k_ms,
                  k_wall, p_ms, lib_ms, nbytes, 2.0 * m * k * n, tile_kernel_ms=t_ms,
                  bit_equal_across_launches_and_grids=True, tiles=plan.tiles, ctas=plan.ctas,
                  dequants_per_weight=plan.tiles_m,
                  tile_kernel_dequants_per_weight=math.ceil(m / 64))
        del sets, calls


def _qkv_views(kr, b, nq, nkv, hd):
    """q, k_new, v_new as strided views of one fused-projection output."""
    qkv = kr.randn(b, 1, (nq + 2 * nkv) * hd)
    return (qkv[..., :nq * hd].view(b, 1, nq, hd),
            qkv[..., nq * hd:(nq + nkv) * hd].view(b, 1, nkv, hd),
            qkv[..., (nq + nkv) * hd:].view(b, 1, nkv, hd))


def _int8_pools(kr, b, nkv, s_len, hd):
    import torch

    def q8():
        return torch.randint(-127, 128, (b, nkv, s_len, hd), generator=kr.gen, device="cuda",
                             dtype=torch.int8)

    def sc():
        return 0.005 + 0.015 * torch.rand((b, nkv, s_len), generator=kr.gen, device="cuda")

    return q8(), q8(), sc(), sc()


def _kernels_decode(kr, tag, nq, nkv, hd, cases, int8=False, write=True, most_copies=32,
                    separate=False):
    """One decode-attention entry over the bf16 or the int8 cache, fused with
    the write (decode_attention_update[8]) or read-only (cached_attention_t[8]
    at one token): the GQA kernel (nq > nkv) or the one-query-head kernel, by
    the wrapper's own dispatch. The library yardstick is SDPA, for int8 over a
    cache dequantized to bf16 beforehand (its dequantization is not timed). A
    read-only row with pos < S also holds the unfused route (read-only
    attention + one-token write) against the fused kernel: pools equal,
    outputs inside the kernel tolerance. ``separate``: q, k_new and v_new are
    contiguous tensors of their own instead of views of one wqkv output."""
    import torch
    import torch.nn.functional as F

    from accessory_tpu_torch.ops import decode_attention as da

    r = nq // nkv
    kernel = ("decode_attention_mha" if r == 1 else "decode_attention") \
        + ("8" if int8 else "") + ("" if write else "_ro")
    update = da.decode_attention_update8 if int8 else da.decode_attention_update
    if write:
        fn = update
        plain = da.decode_attention_update8_plain if int8 else da.decode_attention_update_plain
    else:
        fn = da.cached_attention_t8 if int8 else da.cached_attention_t
        plain = da.cached_attention_decode8_plain if int8 else da.cached_attention_decode_plain
    ncols = (nq + 2 * nkv) * hd
    tok_bytes = hd + 4 if int8 else 2 * hd        # one cached k or v vector (+ its scale)
    for b, s_len, pos in cases:
        name = f"{kernel} {tag} B={b} S={s_len} pos={pos}"
        nbytes = 2 * b * nkv * pos * tok_bytes + b * ncols * 2 + b * nq * hd * 2 \
            + (2 * b * nkv * tok_bytes if write else 0)
        flops = 4.0 * b * nq * (pos + 1) * hd
        sets = [((kr.randn(b, 1, nq, hd), kr.randn(b, 1, nkv, hd), kr.randn(b, 1, nkv, hd))
                 if separate else _qkv_views(kr, b, nq, nkv, hd))
                + (_int8_pools(kr, b, nkv, s_len, hd) if int8
                   else (kr.randn(b, nkv, s_len, hd), kr.randn(b, nkv, s_len, hd)))
                for _ in range(n_copies(nbytes, most_copies))]
        first = sets[0]
        before = tuple(p.clone() for p in first[3:])   # the pools as they were
        pools2 = tuple(p.clone() for p in before)
        got = fn(*first, pos)
        want = plain(*first[:3], *pools2, pos)
        torch.cuda.synchronize()
        out_g, out_w = (got[0], want[0]) if write else (got, want)
        sha = out_sha(out_g, *(p[:, :, pos] for p in got[1:])) if write else out_sha(out_g)
        # softmax averages of pos + 1 values: held to 4 bf16 ulps of the
        # largest output and 1% (plus the relative L2 check)
        atol = 4 * bf16_ulp(float(out_w.float().abs().max()))
        check_close(name, out_g, out_w, rtol=1e-2, atol=atol)
        if write and int8:
            check_pools8(name, got[1:], want[1:])
        elif write and not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
            raise AssertionError(f"{name}: cache write differs")
        elif not write and not all(torch.equal(a, b_) for a, b_ in zip(first[3:], before)):
            raise AssertionError(f"{name}: a read-only kernel changed the cache")
        if not write and pos < s_len:
            fused = update(*first[:3], *(p.clone() for p in before), pos)
            unfused = update(*first[:3], *(p.clone() for p in before), pos,
                             fused_attn_write=False)
            torch.cuda.synchronize()
            check_close(name + " unfused vs fused", unfused[0], fused[0], rtol=1e-2, atol=atol)
            if int8:
                check_pools8(name + " unfused vs fused", unfused[1:], fused[1:])
            elif not all(torch.equal(a, b_) for a, b_ in zip(unfused[1:], fused[1:])):
                raise AssertionError(f"{name}: the unfused route's pools differ from the fused "
                                     "kernel's")
        del before, pools2
        k_ms = time_ms(lambda *a: fn(*a, pos), sets)
        k_wall = wall_ms(lambda *a: fn(*a, pos), sets)
        p_ms = time_ms(lambda *a: plain(*a, pos), sets[:1], min_iters=5)
        mask = (torch.arange(s_len, device="cuda") <= min(pos, s_len - 1))[None]
        if int8:
            lib_sets = [(s_[0].transpose(1, 2),
                         (s_[3].float() * s_[5][..., None]).to(torch.bfloat16),
                         (s_[4].float() * s_[6][..., None]).to(torch.bfloat16)) for s_ in sets[:2]]
        else:
            lib_sets = [(s_[0].transpose(1, 2), s_[3], s_[4]) for s_ in sets]
        lib_ms = time_ms(lambda qq, kk, vv: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask, enable_gqa=r > 1), lib_sets)
        kr.record(kernel, f"{tag} B={b} NKV={nkv} R={r} HD={hd} S={s_len} pos={pos}"
                  + (" separate-qkv" if separate else ""),
                  max_err(out_g, out_w), k_ms, k_wall, p_ms, lib_ms, nbytes, flops,
                  out_sha=sha)
        del sets, lib_sets


def _kernels_flash(kr, cases):
    """flash_attention (serving: no lse) against grouped attention, SDPA the
    yardstick; the row names the plan's heads a block (fwd_plan)."""
    import torch
    import torch.nn.functional as F

    from accessory_tpu_torch.ops.attention import grouped_attention
    from accessory_tpu_torch.ops.flash_attention import flash_attention, fwd_plan

    for tag, b, s, nq, nkv, hd in cases:
        nbytes = b * s * (2 * nq + 2 * nkv) * hd * 2
        flops = 4.0 * b * nq * hd * s * (s + 1) / 2
        sets = []
        for _ in range(n_copies(nbytes)):
            vbuf = kr.randn(b, s, (nkv + 1) * hd)   # v as a strided view, as in the model
            sets.append((kr.randn(b, s, nq, hd), kr.randn(b, s, nkv, hd),
                         vbuf[..., hd:].view(b, s, nkv, hd)))
        q, k, v = sets[0]
        got = flash_attention(q, k, v)
        want = grouped_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        check_close(f"flash_attention s={s} hd={hd}", got, want, rtol=2e-2, atol=2e-2)
        k_ms = time_ms(flash_attention, sets)
        k_wall = wall_ms(flash_attention, sets)
        p_ms = time_ms(lambda *a: grouped_attention(*a, causal=True), sets[:1], min_iters=5)
        lib_ms = time_ms(lambda qq, kk, vv: F.scaled_dot_product_attention(
            qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2), is_causal=True,
            enable_gqa=True), sets)
        kr.record("flash_attention", f"{tag} B={b} S={s} NQ={nq} NKV={nkv} HD={hd}",
                  max_err(got, want), k_ms, k_wall, p_ms, lib_ms, nbytes, flops,
                  heads_per_block=fwd_plan(b, s, s, 0, nq, nkv).heads_per_block)


def _kv_chunk_views(kr, b, sq, nkv, hd):
    """k and v chunks as strided views of a qkv-like buffer."""
    kbuf = kr.randn(b, sq, 3 * nkv * hd)
    return (kbuf[..., :nkv * hd].view(b, sq, nkv, hd),
            kbuf[..., 2 * nkv * hd:].view(b, sq, nkv, hd))


def _kernels_slab(kr, tag, b, nkv, hd, s_len, sq, positions):
    """write_kv_layer: a chunk (kv_write) or one token (sq 1: kv_write_col)."""
    import torch

    from accessory_tpu_torch.ops.decode_attention import write_kv_layer, write_kv_layer_plain

    kernel = "kv_write_col" if sq == 1 else "kv_write"
    for pos in positions:
        nbytes = 2 * 2 * b * sq * nkv * hd * 2
        sets = [(kr.randn(b, nkv, s_len, hd), kr.randn(b, nkv, s_len, hd))
                + _kv_chunk_views(kr, b, sq, nkv, hd) for _ in range(n_copies(nbytes))]
        ck, cv, nk, nv = sets[0]
        ck2, cv2 = ck.clone(), cv.clone()
        write_kv_layer(ck, cv, nk, nv, pos)
        write_kv_layer_plain(ck2, cv2, nk, nv, pos)
        torch.cuda.synchronize()
        if not (torch.equal(ck, ck2) and torch.equal(cv, cv2)):
            raise AssertionError(f"{kernel} pos={pos}: cache differs from the plain copy_")
        sha = out_sha(ck[:, :, pos:pos + sq], cv[:, :, pos:pos + sq])
        k_ms = time_ms(lambda *a: write_kv_layer(*a, pos), sets)
        k_wall = wall_ms(lambda *a: write_kv_layer(*a, pos), sets)
        p_ms = time_ms(lambda *a: write_kv_layer_plain(*a, pos), sets)
        lib_ms = time_ms(lambda ck, cv, nk, nv: (ck[:, :, pos:pos + sq].copy_(nk.transpose(1, 2)),
                                                 cv[:, :, pos:pos + sq].copy_(nv.transpose(1, 2))),
                         sets)
        kr.record(kernel, f"{tag} B={b} sq={sq} NKV={nkv} HD={hd} S={s_len} pos={pos}",
                  (0.0, 0.0), k_ms, k_wall, p_ms, lib_ms, nbytes, 0.0, out_sha=sha)


def _kernels_slab8(kr, tag, b, nkv, hd, s_len, sq, positions):
    """write_kv_layer8: the quantizing write of a chunk (kv_write_q8) or of one
    token (sq 1: kv_write_col_q8). No single PyTorch call computes a
    quantizing strided write, so it has no library yardstick."""
    import torch

    from accessory_tpu_torch.ops.decode_attention import write_kv_layer8, write_kv_layer8_plain

    kernel = "kv_write_col_q8" if sq == 1 else "kv_write_q8"
    for pos in positions:
        nbytes = 2 * b * sq * nkv * (hd * 2 + hd + 4)
        sets = [_int8_pools(kr, b, nkv, s_len, hd) + _kv_chunk_views(kr, b, sq, nkv, hd)
                for _ in range(n_copies(nbytes))]
        pools2 = tuple(p.clone() for p in sets[0][:4])
        got = write_kv_layer8(*sets[0], pos)
        want = write_kv_layer8_plain(*pools2, *sets[0][4:], pos)
        torch.cuda.synchronize()
        check_pools8(f"{kernel} pos={pos}", got, want)
        sha = out_sha(*(p[:, :, pos:pos + sq] for p in got))
        k_ms = time_ms(lambda *a: write_kv_layer8(*a, pos), sets)
        k_wall = wall_ms(lambda *a: write_kv_layer8(*a, pos), sets)
        p_ms = time_ms(lambda *a: write_kv_layer8_plain(*a, pos), sets)
        kr.record(kernel, f"{tag} B={b} sq={sq} NKV={nkv} HD={hd} S={s_len} pos={pos}",
                  (0.0, 0.0), k_ms, k_wall, p_ms, None, nbytes, 0.0, out_sha=sha)


def _kernels_stacked(kr, tag, n_layers, b, nkv, hd, s_len, sq, pos, int8):
    """write_kv_t / write_kv_t8: all layers' new k/v into the stacked cache in
    one launch, from a torch.stack of per-layer chunks as the model makes it
    (the stack's own device time is reported beside the kernel's)."""
    import torch

    from accessory_tpu_torch.ops import decode_attention as da

    kernel = "kv_write_stacked_q8" if int8 else \
        ("kv_write_stacked_col" if sq == 1 else "kv_write_stacked")
    vec = n_layers * b * sq * nkv
    nbytes = 2 * vec * (hd * 2 + hd + 4) if int8 else 2 * 2 * vec * hd * 2
    chunks = [(kr.randn(b, sq, nkv, hd), kr.randn(b, sq, nkv, hd)) for _ in range(n_layers)]
    stack_ms = time_ms(lambda: (torch.stack([c[0] for c in chunks]),
                                torch.stack([c[1] for c in chunks])), [()])
    nk, nv = torch.stack([c[0] for c in chunks]), torch.stack([c[1] for c in chunks])
    if int8:
        def pools():
            return tuple(torch.stack(ps) for ps in zip(*(_int8_pools(kr, b, nkv, s_len, hd)
                                                         for _ in range(n_layers))))
        fn, plain = da.write_kv_t8, da.write_kv_t8_plain
    else:
        def pools():
            return (kr.randn(n_layers, b, nkv, s_len, hd), kr.randn(n_layers, b, nkv, s_len, hd))
        fn, plain = da.write_kv_t, da.write_kv_t_plain
    pool_bytes = sum(p.numel() * p.element_size() for p in pools())
    sets = [pools() + (nk, nv) for _ in range(max(1, min(4, 2 * L2_BYTES // pool_bytes)))]
    pools2 = tuple(p.clone() for p in sets[0][:-2])
    got = fn(*sets[0], pos)
    want = plain(*pools2, nk, nv, pos)
    torch.cuda.synchronize()
    if int8:
        check_pools8(f"{kernel} pos={pos}", got, want)
    elif not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"{kernel} pos={pos}: stacked cache differs from the plain copy_")
    sha = out_sha(*(p[:, :, :, pos:pos + sq] for p in got))
    del pools2
    k_ms = time_ms(lambda *a: fn(*a, pos), sets)
    k_wall = wall_ms(lambda *a: fn(*a, pos), sets)
    p_ms = time_ms(lambda *a: plain(*a, pos), sets)
    lib_ms = None if int8 else time_ms(
        lambda ck, cv, k, v: (ck[:, :, :, pos:pos + sq].copy_(k.transpose(2, 3)),
                              cv[:, :, :, pos:pos + sq].copy_(v.transpose(2, 3))), sets)
    kr.record(kernel, f"{tag} L={n_layers} B={b} sq={sq} NKV={nkv} HD={hd} S={s_len} pos={pos}",
              (0.0, 0.0), k_ms, k_wall, p_ms, lib_ms, nbytes, 0.0, stack_ms=stack_ms,
              out_sha=sha)


def _paged_table(b, pps, n_pages, lengths, ps, seed, share=True):
    """A shuffled page table (b, pps) int32 on the card: each slot's pages
    drawn from a permutation of the pool (page 0 is TRASH), with ``share``
    every slot's first page the same physical page (a prefix-cache hit), and
    the entries past a slot's allocation TRASH."""
    import torch

    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = perm[:b * pps].reshape(b, pps).to(torch.int32)
    if share:
        table[:, 0] = table[0, 0]
    for i, n in enumerate(lengths):
        table[i, max(1, -(-n // ps)):] = 0
    return table.cuda()


def _paged_pools(kr, n_layers, nkv, n_pages, ps, hd, int8):
    import torch

    shape = (n_layers, nkv, n_pages, ps, hd)
    if int8:
        return (torch.randint(-127, 128, shape, generator=kr.gen, device="cuda", dtype=torch.int8),
                torch.randint(-127, 128, shape, generator=kr.gen, device="cuda", dtype=torch.int8),
                0.005 + 0.015 * torch.rand(shape[:-1], generator=kr.gen, device="cuda"),
                0.005 + 0.015 * torch.rand(shape[:-1], generator=kr.gen, device="cuda"))
    return kr.randn(*shape), kr.randn(*shape)


def _kernels_paged_decode(kr, tag, nkv, r, hd, sq, lengths, int8, ps=64, pps=8, most_copies=32):
    """paged_decode_attention (paged_decode / paged_decode8) over one layer of
    stacked pools through a shuffled table with a shared page and TRASH
    entries, ragged lengths, all ``pps`` pages active, sq new tokens a slot.
    The library yardstick is SDPA over each slot's pages gathered into a
    dense cache beforehand (int8 dequantized to bf16 beforehand), the length
    as a mask; neither step of the preparation is timed."""
    import torch
    import torch.nn.functional as F

    from accessory_tpu_torch.engine.kvcache import gather_pages
    from accessory_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                                      paged_decode_attention_plain)

    kernel = "paged_decode8" if int8 else "paged_decode"
    b, nq = len(lengths), nkv * r
    n_pages = b * pps + 1
    table = _paged_table(b, pps, n_pages, lengths, ps, seed=b * pps + sq)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    tok_bytes = 2 * (hd + 4) if int8 else 2 * 2 * hd       # one cached token's k and v
    cached = sum(min(n, pps * ps) for n in lengths)
    nbytes = cached * nkv * tok_bytes + 2 * b * sq * nq * hd * 2 + 2 * b * sq * nkv * hd * 2 \
        + b * pps * 4 + b * 4
    flops = sum(4.0 * nq * hd * sq * (n + (sq + 1) / 2) for n in lengths)
    pool_bytes = 2 * nkv * n_pages * ps * (hd + 4 if int8 else 2 * hd)
    sets = [(kr.randn(b, sq, nq, hd), kr.randn(b, sq, nkv, hd), kr.randn(b, sq, nkv, hd))
            + _paged_pools(kr, 1, nkv, n_pages, ps, hd, int8)
            for _ in range(n_copies(pool_bytes, most_copies))]

    def call(q, kn, vn, *pools):
        return paged_decode_attention(q, kn, vn, pools[0], pools[1], lens, table, pps,
                                      *(pools[2:] if int8 else (None, None)), layer=0)

    def plain(q, kn, vn, *pools):
        return paged_decode_attention_plain(q, kn, vn, pools[0], pools[1], lens, table, pps,
                                            *(pools[2:] if int8 else (None, None)), layer=0)

    first = sets[0]
    before = tuple(p.clone() for p in first[3:])
    got, want = call(*first), plain(*first)
    torch.cuda.synchronize()
    name = f"{kernel} {tag} SQ={sq}"
    atol = 4 * bf16_ulp(float(want.float().abs().max()))
    check_close(name, got, want, rtol=1e-2, atol=atol)
    if not all(torch.equal(a, b_) for a, b_ in zip(first[3:], before)):
        raise AssertionError(f"{name}: the paged decode kernel changed its pools")
    del before
    k_ms = time_ms(call, sets)
    k_wall = wall_ms(call, sets)
    p_ms = time_ms(plain, sets[:1], min_iters=3)
    mask = (torch.arange(pps * ps, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    lib_sets = []
    for s_ in sets[:4]:
        kd, vd = gather_pages(s_[3][0], s_[4][0], table, None,
                              *((s_[5][0], s_[6][0]) if int8 else (None, None)))
        lib_sets.append((s_[0].transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2)))
    lib_ms = time_ms(lambda qq, kk, vv: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, enable_gqa=r > 1), lib_sets)
    kr.record(kernel, f"{tag} B={b} NKV={nkv} R={r} HD={hd} SQ={sq} PS={ps} J={pps} "
              f"lengths={','.join(map(str, lengths))}", max_err(got, want), k_ms, k_wall, p_ms,
              lib_ms, nbytes, flops)
    del sets, lib_sets


def _kernels_paged_identity(kr, int8, b=8, nkv=4, r=8, hd=64, ps=64, pps=8, pos=300):
    """Over an identity page table the paged kernel computes what the static
    cache's read-only kernel (decode_attention[8]_ro) computes on the same
    contents, within the decode rows' tolerance."""
    import torch

    from accessory_tpu_torch.ops.decode_attention import cached_attention_t, cached_attention_t8
    from accessory_tpu_torch.ops.paged_decode import paged_decode_attention

    s_len = ps * pps
    static = _int8_pools(kr, b, nkv, s_len, hd) if int8 else \
        (kr.randn(b, nkv, s_len, hd), kr.randn(b, nkv, s_len, hd))
    q, kn, vn = kr.randn(b, 1, nkv * r, hd), kr.randn(b, 1, nkv, hd), kr.randn(b, 1, nkv, hd)
    want = (cached_attention_t8 if int8 else cached_attention_t)(q, kn, vn, *static, pos)
    # page j of slot i is physical page i * pps + j
    paged = [p.reshape(b, nkv, pps, ps, *p.shape[3:]).transpose(0, 1)
             .reshape(nkv, b * pps, ps, *p.shape[3:]).contiguous() for p in static]
    table = torch.arange(b * pps, dtype=torch.int32, device="cuda").reshape(b, pps)
    lens = torch.full((b,), pos, dtype=torch.int32, device="cuda")
    got = paged_decode_attention(q, kn, vn, paged[0], paged[1], lens, table, None,
                                 *(paged[2:] if int8 else (None, None)))
    torch.cuda.synchronize()
    name = f"{'paged_decode8' if int8 else 'paged_decode'} identity table vs static read-only"
    check_close(name, got, want, rtol=1e-2, atol=4 * bf16_ulp(float(want.float().abs().max())))
    emit({"phase": "kernels", "check": name, "shape": f"B={b} NKV={nkv} R={r} HD={hd} pos={pos}",
          "max_abs_err": max_err(got, want)[0]})


def _kernels_paged_write(kr, tag, n_layers, b, s, nkv, hd, int8, ps=64, pps=8):
    """paged_write_tokens (paged_write / paged_write_q8): every layer's s new
    tokens a slot into the stacked pools at starts that cross page
    boundaries, one slot's positions running past its table into TRASH.
    Library yardstick (bf16): one index_put_ per pool with the flat row
    indices computed beforehand; the quantizing write has none."""
    import torch

    from accessory_tpu_torch.ops.paged_write import (paged_write_tokens, paged_write_tokens_plain,
                                                     token_slots)

    kernel = "paged_write_q8" if int8 else "paged_write"
    n_pages = b * pps + 1
    table = _paged_table(b, pps, n_pages, [pps * ps] * b, ps, seed=s, share=False)
    cap = pps * ps
    starts = [min(x, cap - s) for x in (0, ps - 2, 2 * ps + 7, 3 * ps - 1, 200, 300, 5 * ps)]
    starts = (starts * b)[:b - 1] + [cap - s // 2]     # the last slot runs past its table
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    vec = n_layers * b * s * nkv
    nbytes = 2 * vec * (hd * 2 + hd + 4) if int8 else 2 * 2 * vec * hd * 2
    kn, vn = kr.randn(n_layers, b, s, nkv, hd), kr.randn(n_layers, b, s, nkv, hd)
    pool_bytes = 2 * n_layers * nkv * n_pages * ps * (hd + 4 if int8 else 2 * hd)
    sets = [_paged_pools(kr, n_layers, nkv, n_pages, ps, hd, int8) + (kn, vn)
            for _ in range(max(1, min(4, 2 * L2_BYTES // pool_bytes)))]

    def call(*a):
        return paged_write_tokens(a[0], a[1], a[-2], a[-1], table, start, *a[2:-2])

    def plain(*a):
        return paged_write_tokens_plain(a[0], a[1], a[-2], a[-1], table, start, *a[2:-2])

    pools2 = tuple(p.clone() for p in sets[0][:-2])
    got = call(*sets[0])
    want = plain(*pools2, kn, vn)
    torch.cuda.synchronize()
    name = f"{kernel} {tag} L={n_layers} s={s}"
    # the TRASH page takes the overflowing slot's junk from concurrent stores
    # in the kernel and from an indexed store with repeated rows in the plain
    # version: it is compared nowhere
    live = [g[:, :, 1:] for g in got], [w[:, :, 1:] for w in want]
    if int8:
        check_pools8(name, *live)
    elif not all(torch.equal(g, w) for g, w in zip(*live)):
        raise AssertionError(f"{name}: pools differ from the plain indexed store")
    sha = out_sha(*live[0])
    del pools2
    k_ms = time_ms(call, sets)
    k_wall = wall_ms(call, sets)
    p_ms = time_ms(plain, sets)
    lib_ms = None
    if not int8:
        page, off = token_slots(table, start, s, ps)                 # (b * s,)
        lh = torch.arange(n_layers * nkv, device="cuda")[:, None]   # (l, h) pairs
        rows = ((lh * n_pages + page[None, :]) * ps + off[None, :])  # (L * nkv, b * s)
        rows = rows.reshape(n_layers, nkv, b * s).transpose(1, 2).reshape(-1)
        vals = [t.reshape(n_layers, b * s, nkv, hd).reshape(-1, hd) for t in (kn, vn)]
        lib_ms = time_ms(lambda kp, vp, *_: (kp.view(-1, hd).index_put_((rows,), vals[0]),
                                             vp.view(-1, hd).index_put_((rows,), vals[1])), sets)
    kr.record(kernel, f"{tag} L={n_layers} B={b} s={s} NKV={nkv} HD={hd} PS={ps} "
              f"starts={','.join(map(str, starts))}", (0.0, 0.0), k_ms, k_wall, p_ms, lib_ms,
              nbytes, 0.0, out_sha=sha)
    del sets


def _kernels_dequant(kr, specs):
    """planes_dequant (the QPEFT backward's one pass per frozen W4 weight)
    against dequantize_weight, bit for bit, at the training path's weight
    shapes (in_dim as quantize_params pads it)."""
    import torch

    from accessory_tpu_torch.ops.quant_matmul_bigm import planes_dequant
    from accessory_tpu_torch.quant.qtensor import (dequantize_weight, quantize_weight,
                                                   to_folded_layout)

    for tag, k, n in specs:
        nbytes = k * n / 2 + k * n * 2 + 2 * (k // 128) * n * 4
        sets = []
        for _ in range(n_copies(nbytes, most=8)):
            qw = to_folded_layout(quantize_weight(kr.randn(k, n, dtype=torch.float32,
                                                           scale=k ** -0.5), 4, 128))
            sets.append((qw.packed, qw.scales, qw.zeros))
        qw_args = dict(in_dim=k, group_size=128)
        got = planes_dequant(*sets[0], **qw_args)
        want = dequantize_weight(_folded_from(sets[0], k, n))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"w4_dequant {tag}: not bit-equal to dequantize_weight "
                                 f"({int((got != want).sum())} elements differ)")
        fn = lambda p, sc, z: planes_dequant(p, sc, z, **qw_args)  # noqa: E731
        k_ms = time_ms(fn, sets)
        k_wall = wall_ms(fn, sets)
        p_ms = time_ms(lambda p, sc, z: dequantize_weight(_folded_from((p, sc, z), k, n)),
                       sets[:1], min_iters=5)
        kr.record("w4_dequant", f"{tag} K={k} N={n} g=128", (0.0, 0.0), k_ms, k_wall, p_ms,
                  None, nbytes, 2.0 * k * n, rate=F32_FLOPS_PER_S)
        del sets


def _folded_from(arrays, k, n):
    from accessory_tpu_torch.quant.qtensor import QuantizedWeight

    p, sc, z = arrays
    return QuantizedWeight(packed=p, scales=sc, zeros=z, bits=4, group_size=128, in_dim=k,
                           out_dim=n, layout="folded")


def _kernels_flash_bwd(kr, cases):
    """flash_attention_bwd (its dq and dk/dv launches) against the plain
    formula over the same forward output and lse; each entry timed from its
    own kernel's device time; the library yardstick is the backward of
    scaled_dot_product_attention (is_causal, enable_gqa) at the same shape."""
    import torch
    import torch.nn.functional as F

    from accessory_tpu_torch.ops.flash_attention import (_forward, flash_attention_bwd,
                                                         flash_attention_bwd_plain)

    for tag, b, s, nq, nkv, hd in cases:
        tok = b * s * hd * 2                       # bytes of one head's rows
        # dq: q, k, v, o, dO and lse read, dq and D written; dk/dv: q, k, v,
        # dO, lse and D read, dk and dv written
        bytes_dq = tok * (4 * nq + 2 * nkv) + 2 * 4 * b * nq * s
        bytes_dkdv = tok * (2 * nq + 4 * nkv) + 2 * 4 * b * nq * s
        causal = b * nq * hd * s * (s + 1) / 2     # one causal product's multiply-adds
        flops_dq, flops_dkdv = 3 * 2 * causal, 4 * 2 * causal   # S, dP, dQ | S, dP, dV, dK
        sets = []
        for _ in range(n_copies(bytes_dq + bytes_dkdv, most=4)):
            q, k, v = kr.randn(b, s, nq, hd), kr.randn(b, s, nkv, hd), kr.randn(b, s, nkv, hd)
            out, lse = _forward(q, k, v, None, with_lse=True)
            sets.append((q, k, v, out, kr.randn(b, s, nq, hd), lse))
        got = flash_attention_bwd(*sets[0])
        want = flash_attention_bwd_plain(*sets[0])
        torch.cuda.synchronize()
        errs = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            top = float(w.float().abs().max())
            check_close(f"flash_attention_bwd {name} {tag} s={s}", g, w, rtol=2e-2,
                        atol=2e-2 * top, rel_l2=2e-2)
            errs.append(max_err(g, w))
        names = ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel")
        k_ms = time_ms(flash_attention_bwd, sets, by=names)
        k_wall = wall_ms(flash_attention_bwd, sets)
        p_ms = time_ms(flash_attention_bwd_plain, sets[:1], min_iters=3)
        q, k, v, _, dout, _ = sets[0]
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = dout.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True),
                         [()], min_iters=10)
        shape = f"{tag} B={b} S={s} NQ={nq} NKV={nkv} HD={hd}"
        err = (max(e[0] for e in errs), max(e[1] for e in errs))
        # the plain and library times are those of the whole backward (both
        # entries), written on each entry's row
        kr.record("flash_attention_bwd_dq", shape, err, k_ms[names[0]], k_wall, p_ms, lib_ms,
                  bytes_dq, flops_dq, both_entries_ms=k_ms[names[0]] + k_ms[names[1]])
        kr.record("flash_attention_bwd_dkdv", shape, err, k_ms[names[1]], k_wall, p_ms, lib_ms,
                  bytes_dkdv, flops_dkdv, both_entries_ms=k_ms[names[0]] + k_ms[names[1]])
        del sets, o, qt, kt, vt


def _cp_work(b, s_l, q0, nq, hd):
    """Multiply-adds of one causal product of a cp shard: its s_l rows at
    positions q0 .. q0 + s_l - 1 each see q0 + i + 1 keys."""
    return b * nq * hd * (s_l * q0 + s_l * (s_l + 1) / 2)


def _masked_sdpa(q, k, v, q0):
    """The library yardstick of a cp shard: scaled_dot_product_attention over
    the gathered keys with an explicit boolean mask (row i sees keys up to
    q0 + i)."""
    import torch
    import torch.nn.functional as F

    s_l, s_k = q.shape[1], k.shape[1]
    mask = (torch.arange(s_k, device=q.device)[None, :]
            <= q0 + torch.arange(s_l, device=q.device)[:, None])
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), attn_mask=mask, enable_gqa=True)


def _kernels_cp(kr, cases):
    """Row 26: flash_attention_cp (forward with the lse) and its two backward
    entries at each named shard of a sequence split over cp, against the plain
    versions (grouped attention at the shard's offset, the explicit backward),
    the library yardstick SDPA with a boolean mask over the gathered keys (and
    its backward). Bounds count the keys the shard needs (0 .. its last row)."""
    import torch

    from accessory_tpu_torch.ops.attention import grouped_attention
    from accessory_tpu_torch.ops.flash_attention import (_forward, attention_lse,
                                                         flash_attention_bwd,
                                                         flash_attention_bwd_plain)

    names = ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel")
    for tag, b, s, nq, nkv, hd, cp, ranks in cases:
        s_l = s // cp
        k, v = kr.randn(b, s, nkv, hd), kr.randn(b, s, nkv, hd)
        for r in ranks:
            q0 = r * s_l
            q, dout = kr.randn(b, s_l, nq, hd), kr.randn(b, s_l, nq, hd)
            fwd = lambda q, k, v: _forward(q, k, v, None, with_lse=True, q_offset=q0)  # noqa: E731
            out, lse = fwd(q, k, v)
            want = grouped_attention(q, k, v, causal=True, q_offset=q0)
            want_lse = attention_lse(q, k, None, q0)
            torch.cuda.synchronize()
            shape = f"{tag} B={b} S={s} cp={cp} rank={r} NQ={nq} NKV={nkv} HD={hd}"
            check_close(f"flash_attention_cp {shape}", out, want, rtol=2e-2, atol=2e-2)
            lse_err = float((lse - want_lse).abs().max())
            if lse_err > 1e-4 * float(want_lse.abs().max()) + 1e-5:
                raise AssertionError(f"flash_attention_cp {shape}: lse off by {lse_err}")
            work = _cp_work(b, s_l, q0, nq, hd)
            tok = b * hd * 2                               # bytes of one head's token row
            keys = (q0 + s_l) * tok * nkv                  # the gathered keys the shard reads
            sets = [(q, k, v)]
            k_ms = time_ms(fwd, sets)
            p_ms = time_ms(lambda *a: grouped_attention(*a, causal=True, q_offset=q0), sets,
                           min_iters=3)
            lib_ms = time_ms(lambda *a: _masked_sdpa(*a, q0), sets, min_iters=10)
            kr.record("flash_attention_cp", shape, max_err(out, want), k_ms, wall_ms(fwd, sets),
                      p_ms, lib_ms, 2 * s_l * tok * nq + 2 * keys + 4 * b * nq * s_l, 4 * work)
            del want, want_lse
            bwd = lambda *a: flash_attention_bwd(*a, None, q0)  # noqa: E731
            got = bwd(q, k, v, out, dout, lse)
            want = flash_attention_bwd_plain(q, k, v, out, dout, lse, None, q0)
            torch.cuda.synchronize()
            errs = []
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                top = float(w.float().abs().max())
                check_close(f"flash_attention_cp_bwd {name} {shape}", g, w, rtol=2e-2,
                            atol=2e-2 * top, rel_l2=2e-2)
                errs.append(max_err(g, w))
            if got[1][:, q0 + s_l:].any() or got[2][:, q0 + s_l:].any():
                raise AssertionError(f"flash_attention_cp_bwd {shape}: dk / dv not zero past "
                                     "the shard's last row")
            del want
            bsets = [(q, k, v, out, dout, lse)]
            kb_ms = time_ms(bwd, bsets, by=names)
            kb_wall = wall_ms(bwd, bsets)
            pb_ms = time_ms(flash_attention_bwd_plain, [(q, k, v, out, dout, lse, None, q0)],
                            min_iters=3)
            qt, kt, vt = (t.detach().requires_grad_(True) for t in (q, k, v))
            o = _masked_sdpa(qt, kt, vt, q0)
            dot = dout.transpose(1, 2)
            lb_ms = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True),
                            [()], min_iters=10)
            err = (max(e[0] for e in errs), max(e[1] for e in errs))
            both = kb_ms[names[0]] + kb_ms[names[1]]
            # dq: q, o, dO, k / v (the needed keys), lse read, D and dq written;
            # dk / dv: q, dO, the needed k / v, lse and D read, all S rows of
            # dk and dv written
            kr.record("flash_attention_cp_bwd_dq", shape, err, kb_ms[names[0]], kb_wall, pb_ms,
                      lb_ms, 4 * s_l * tok * nq + 2 * keys + 8 * b * nq * s_l, 3 * 2 * work,
                      both_entries_ms=both)
            kr.record("flash_attention_cp_bwd_dkdv", shape, err, kb_ms[names[1]], kb_wall, pb_ms,
                      lb_ms, 2 * s_l * tok * nq + 2 * keys + 8 * b * nq * s_l
                      + 2 * s * tok * nkv, 4 * 2 * work, both_entries_ms=both)
            del got, o, qt, kt, vt


def _kernels_cp_identity(kr, cases):
    """At q0 = 0 and SK = SQ the cp entries run the flash entries' body: the
    same bits, forward (with the lse) and both backward launches."""
    import torch

    from accessory_tpu_torch.ops.flash_attention import _forward, flash_attention_bwd

    for tag, b, s, nq, nkv, hd in cases:
        q, k, v, dout = (kr.randn(b, s, n, hd) for n in (nq, nkv, nkv, nq))
        got = _forward(q, k, v, None, with_lse=True, q_offset=0)
        want = _forward(q, k, v, None, with_lse=True)
        got += flash_attention_bwd(q, k, v, got[0], dout, got[1], None, 0)
        want += flash_attention_bwd(q, k, v, want[0], dout, want[1])
        torch.cuda.synchronize()
        same = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
        emit({"phase": "kernels", "kernel": "flash_attention_cp", "check": "q0 = 0, SK = SQ: "
              "bit-equal to the flash entries (out, lse, dq, dk, dv)",
              "shape": f"{tag} B={b} S={s} NQ={nq} NKV={nkv} HD={hd}", "equal": same})
        if not all(same):
            raise AssertionError(f"flash_attention_cp at q0 = 0 differs from flash_attention "
                                 f"({tag}: {same})")


def _w8_weight_sets(kr, m, k, n, fusion, rope):
    """Argument sets for one W8 projection (a fresh weight per copy, so a
    round-robin spills L2) plus the dense bf16 weight for the yardstick."""
    import torch

    from accessory_tpu_torch.quant.qtensor import dense_weight, quantize_weight, to_w8_layout
    from accessory_tpu_torch.quant.quantize import pad_to

    cos_rows, sin_rows, style, hd = rope
    kp = k + (-k) % pad_to(k, 128)
    qw_bytes = kp * n + 2 * (kp // 128) * n * 4
    io_bytes = m * k * 2 + m * n * 2 + (m * n * 2 if fusion == "res" else 0) \
        + (k * 4 if "norm" in fusion else 0) + (2 * n * 4 if "rope" in fusion else 0)
    sets = []
    for _ in range(n_copies(qw_bytes + io_bytes)):
        w = kr.randn(k, n, dtype=torch.float32, scale=k ** -0.5)
        qw = to_w8_layout(quantize_weight(w, 8, 128, pad_in_to=pad_to(k, 128)))
        del w
        args = dict(x2d=kr.randn(m, k), q8=qw.packed, scales=qw.scales, zs=qw.zeros,
                    norm_weight=(1 + 0.1 * kr.randn(k, dtype=torch.float32))
                    if "norm" in fusion else None,
                    residual=kr.randn(m, n) if fusion == "res" else None,
                    rope_cos=cos_rows[511] if "rope" in fusion else None,
                    rope_sin=sin_rows[511] if "rope" in fusion else None,
                    group_size=128, rope_style=style if "rope" in fusion else "",
                    rope_hd=hd if "rope" in fusion else 0)
        sets.append((args, dense_weight(qw, torch.bfloat16)[:k]))
    # the bound counts the rows and groups the function reads: k's, not the padding's
    return sets, k * n + 2 * -(-k // 128) * n * 4 + io_bytes


def _kernels_w8(kr, tag, specs, rope):
    """w8_qmm (GEMV for M <= 8, the wgmma tile above) with its fusions; the
    GEMV's cluster split and the tile's K split checked (``_split_check``)."""
    import torch

    from accessory_tpu_torch.ops import w4_tile
    from accessory_tpu_torch.ops.quant_matmul_w8 import w8_qmm, w8_qmm_plain

    for name, k, n, m, fusion in specs:
        sets, nbytes = _w8_weight_sets(kr, m, k, n, fusion, rope)
        a0 = sets[0][0]
        got = w8_qmm(**a0)
        want = w8_qmm_plain(**a0)
        torch.cuda.synchronize()
        # the same bf16 weights and f32 sums in another order: a rounding step or two
        label = f"w8_matmul {tag} {name} M={m}"
        check_close(label, got, want, rtol=2e-2, atol=2e-2)
        split = w4_tile.w8_gemv_split(n, k) if m <= 8 else w4_tile.w8_plan(m, n, k, 128).split
        extra = _split_check(label, split, got, want, lambda sp: w8_qmm(**a0, split=sp))
        calls = [(s[0],) for s in sets]
        k_ms = time_ms(lambda a: w8_qmm(**a), calls)
        k_wall = wall_ms(lambda a: w8_qmm(**a), calls)
        p_ms = time_ms(lambda a: w8_qmm_plain(**a), calls[:1], min_iters=3)
        lib_ms = time_ms(lambda x, d: torch.matmul(x, d), [(s[0]["x2d"], s[1]) for s in sets])
        kr.record("w8_matmul", f"{tag} {name} M={m} K={k} N={n} {fusion or 'none'}",
                  max_err(got, want), k_ms, k_wall, p_ms, lib_ms, nbytes, 2.0 * m * k * n,
                  **extra)
        del sets


def _gptq_like_weight(gen, k, n, gs=128):
    """A std-layout W4 weight as a GPTQ import gives it: random nibbles,
    zeros z + 1 in [1, 16], small positive scales, on the card."""
    import torch

    from accessory_tpu_torch.quant.qtensor import QuantizedWeight

    words = torch.randint(-2 ** 31, 2 ** 31, (k // 8, n), generator=gen, device="cuda",
                          dtype=torch.int64).to(torch.int32)
    zeros = torch.randint(1, 17, (k // gs, n), generator=gen, device="cuda").to(torch.float32)
    scales = torch.rand((k // gs, n), generator=gen, device="cuda") * 0.004 + 5e-4
    return QuantizedWeight(packed=words, scales=scales, zeros=zeros, bits=4, group_size=gs,
                           in_dim=k, out_dim=n)


def _kernels_w4elem(kr, tag, specs):
    """quant_matmul_pallas (std W4, GPTQ zeros) and magic_qmm (the magic words
    of the same weight) at the GPTQ serve paths' shapes; the GEMV's cluster
    split and the many-row tile's K split checked (``_split_check``). A spec
    (name, K, N, M[, Kx]): Kx < K is x narrower than a padded in_dim."""
    import torch

    from accessory_tpu_torch.ops import w4_tile
    from accessory_tpu_torch.ops.quant_matmul_magic import magic_qmm, magic_qmm_plain
    from accessory_tpu_torch.ops.quant_matmul_pallas import (quant_matmul_pallas,
                                                             quant_matmul_pallas_plain)
    from accessory_tpu_torch.quant.qtensor import dense_weight, to_magic_layout

    for name, k, n, m, *rest in specs:
        kx = rest[0] if rest else k
        io_bytes = m * kx * 2 + m * n * 2
        std = [_gptq_like_weight(kr.gen, k, n)
               for _ in range(n_copies(k * n / 2 + 2 * (k // 128) * n * 4 + io_bytes))]
        # the bound counts the weight rows and groups the function reads: Kx's
        nbytes = kx * n / 2 + 2 * -(-kx // 128) * n * 4 + io_bytes
        xs = [kr.randn(m, kx) for _ in std]
        for kernel, fn, plain in (
                ("w4_matmul_std", quant_matmul_pallas, quant_matmul_pallas_plain),
                ("w4_matmul_magic",
                 lambda x, q, split=None: magic_qmm(x, q.packed, q.scales, q.zeros,
                                                    group_size=128, tk=q.tile_k, split=split),
                 lambda x, q: magic_qmm_plain(x, q.packed, q.scales, q.zeros, group_size=128,
                                              tk=q.tile_k))):
            qws = std if kernel == "w4_matmul_std" else [to_magic_layout(q) for q in std]
            calls = list(zip(xs, qws))
            got, want = fn(*calls[0]), plain(*calls[0])
            torch.cuda.synchronize()
            label = f"{kernel} {tag} {name} M={m}"
            check_close(label, got, want, rtol=2e-2, atol=2e-2)
            tk = None if kernel == "w4_matmul_std" else qws[0].tile_k
            split = (w4_tile.elem_plan(m, n, kx, tk).split if m > 8 else
                     w4_tile.gemv_split(n, w4_tile.elem_units(kx, tk)))
            extra = _split_check(
                label, split, got, want, lambda sp: fn(*calls[0], split=sp))
            dense = [(x, dense_weight(q, torch.bfloat16)[:kx]) for x, q in calls]
            k_ms = time_ms(fn, calls)
            k_wall = wall_ms(fn, calls)
            p_ms = time_ms(plain, calls[:1], min_iters=3)
            lib_ms = time_ms(lambda x, d: torch.matmul(x, d), dense)
            kr.record(kernel, f"{tag} {name} M={m} K={k} N={n}" + (f" Kx={kx}" if kx < k else ""),
                      max_err(got, want), k_ms, k_wall, p_ms, lib_ms, nbytes, 2.0 * m * kx * n,
                      **extra)
            del dense, qws, calls
        del std, xs


def _kernels_ffn(kr, tag, k, ffn, n2, ms):
    """ffn_qmm (one cooperative launch: w13 with the norm prologue, SwiGLU,
    w2 plus the residual) against ffn_qmm_plain at a decode FFN's widths,
    W4 g128, w2's in_dim padded as quantize_params pads it; each row count
    with and without the norm and the residual, timed with both (the model's
    call) beside the unfused chain the path takes without ffn_fuse (w13
    w4_matmul with the norm, silu, the product, w2 w4_matmul with the
    residual: all of its kernels' device time). No single PyTorch call
    computes the function: no library time. The bound counts the weights'
    bytes the function reads (w2's padded rows are not read)."""
    import torch
    import torch.nn.functional as F

    from accessory_tpu_torch.ops import ffn_fused as ffn_mod
    from accessory_tpu_torch.ops.ffn_fused import ffn_qmm, ffn_qmm_plain
    from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm
    from accessory_tpu_torch.quant.qtensor import quantize_weight, to_folded_layout
    from accessory_tpu_torch.quant.quantize import pad_to

    def w4(kk, nn):
        w = kr.randn(kk, nn, dtype=torch.float32, scale=kk ** -0.5)
        return to_folded_layout(quantize_weight(w, 4, 128, pad_in_to=pad_to(kk, 128)))

    w_bytes = (k * ffn + 2 * (k // 128) * 2 * ffn * 4) + (ffn * n2 // 2 + 2 * (ffn // 128) * n2 * 4)
    weights = [(w4(k, 2 * ffn), w4(ffn, n2)) for _ in range(n_copies(w_bytes))]

    def fused(x, a, b, r, nw):
        return ffn_qmm(x, a, b, residual=r, norm_weight=nw)

    def plain(x, a, b, r, nw):
        return ffn_qmm_plain(x, a, b, residual=r, norm_weight=nw)

    def chain(x, a, b, r, nw):
        gu = planes_qmm(x, a.packed, a.scales, a.zeros, nw, in_dim=a.in_dim, group_size=128)
        hh = F.silu(gu[:, :ffn]) * gu[:, ffn:]
        return planes_qmm(hh, b.packed, b.scales, b.zeros, residual=r, in_dim=b.in_dim,
                          group_size=128)

    def ffn_plan_of(m):   # the launch plan (a tree before the split design has none)
        if not hasattr(ffn_mod, "ffn_plan"):
            return None
        return ffn_mod.ffn_plan(m, k, ffn, n2, 128,
                                ffn_mod.resident_blocks(torch.device("cuda", 0), m))

    for m in ms:
        calls = [(kr.randn(m, k), a, b, kr.randn(m, n2),
                  1 + 0.1 * kr.randn(k, dtype=torch.float32)) for a, b in weights]
        x, a, b, r, nw = calls[0]
        errs = {}
        for fusion, extra in (("none", (None, None)), ("norm+res", (r, nw))):
            got, want = fused(x, a, b, *extra), plain(x, a, b, *extra)
            torch.cuda.synchronize()
            check_close(f"ffn_fused {tag} M={m} {fusion}", got, want, rtol=2e-2, atol=2e-2)
            errs[fusion] = max_err(got, want)
        # the unfused chain rounds silu and the product apart: printed, held by parity_ffn
        vs_chain = max_err(fused(*calls[0]), chain(*calls[0]))[0]
        k_ms = time_ms(fused, calls)
        k_wall = wall_ms(fused, calls)
        p_ms = time_ms(plain, calls[:1], min_iters=3)
        chain_ms = time_ms(chain, calls)
        nbytes = w_bytes + m * k * 2 + 2 * m * n2 * 2 + k * 4
        worst = max(errs.values())
        plan = ffn_plan_of(m)
        kr.record("ffn_fused", f"{tag} M={m} K={k} FFN={ffn} N2={n2} norm+res", worst, k_ms,
                  k_wall, p_ms, None, nbytes, 2.0 * m * (k * 2 * ffn + ffn * n2),
                  unfused_chain_ms=chain_ms, max_abs_err_no_fusion=errs["none"][0],
                  max_abs_diff_vs_unfused_chain=vs_chain, weight_bytes=w_bytes,
                  **({"split_a": plan.split_a, "split_b": plan.split_b, "grid": plan.grid}
                     if plan else {}))
        del calls
    del weights


def _kernels_paged_ro(kr, tag, nkv, r, hd, lengths, ps=64, most_copies=32):
    """paged_decode_ro (kvcache.paged_attention_decode's kernel: one token a
    slot whose k/v the bf16 pools already hold, lengths counting it) against
    its plain version (the reference's oracle) through a shuffled table with
    a shared page and TRASH entries; then, on a table of each slot's own
    pages, against paged_decode with sq = 1 over the old lengths after the
    same token's paged write. Library yardstick: SDPA over each slot's pages
    gathered into a dense cache beforehand, the length as a mask."""
    import torch
    import torch.nn.functional as F

    from accessory_tpu_torch.engine.kvcache import gather_pages
    from accessory_tpu_torch.ops.paged_decode import (paged_decode_attention, paged_decode_ro,
                                                      paged_decode_ro_plain)
    from accessory_tpu_torch.ops.paged_write import paged_write_tokens

    b, nq = len(lengths), nkv * r
    pps = -(-max(lengths) // ps)
    n_pages = b * pps + 1
    table = _paged_table(b, pps, n_pages, lengths, ps, seed=b * pps + r)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    pool_bytes = 2 * nkv * n_pages * ps * hd * 2
    sets = [(kr.randn(b, nq, hd),) + _paged_pools(kr, 1, nkv, n_pages, ps, hd, False)
            for _ in range(n_copies(pool_bytes, most_copies))]

    def call(q, kp, vp):
        return paged_decode_ro(q, kp[0], vp[0], lens, table)

    def plain(q, kp, vp):
        return paged_decode_ro_plain(q, kp[0], vp[0], lens, table)

    q, kp, vp = sets[0]
    before = (kp.clone(), vp.clone())
    got, want = call(*sets[0]), plain(*sets[0])
    torch.cuda.synchronize()
    name = f"paged_decode_ro {tag}"
    check_close(name, got, want, rtol=1e-2, atol=4 * bf16_ulp(float(want.float().abs().max())))
    if not (torch.equal(kp, before[0]) and torch.equal(vp, before[1])):
        raise AssertionError(f"{name}: the read-only kernel changed its pools")
    # the write + read-only form against the paged decode that takes the token as new
    own = _paged_table(b, pps, n_pages, lengths, ps, seed=7, share=False)
    old = (lens - 1).clamp_min(0)
    kn, vn = kr.randn(b, 1, nkv, hd), kr.randn(b, 1, nkv, hd)
    kp2, vp2 = before           # the untouched copies take the write
    ref = paged_decode_attention(q[:, None], kn, vn, kp2, vp2, old, own, None, layer=0)[:, 0]
    paged_write_tokens(kp2, vp2, kn[None], vn[None], own, old)
    after = paged_decode_ro(q, kp2[0], vp2[0], old + 1, own)
    torch.cuda.synchronize()
    check_close(f"{name} after paged_write vs paged_decode", after, ref, rtol=1e-2,
                atol=4 * bf16_ulp(float(ref.float().abs().max())))
    del before, kp2, vp2
    k_ms = time_ms(call, sets)
    k_wall = wall_ms(call, sets)
    p_ms = time_ms(plain, sets[:1], min_iters=3)
    mask = (torch.arange(pps * ps, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    lib_sets = []
    for q_, kp_, vp_ in sets[:4]:
        kd, vd = gather_pages(kp_[0], vp_[0], table)
        lib_sets.append((q_[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)))
    lib_ms = time_ms(lambda qq, kk, vv: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, enable_gqa=r > 1), lib_sets)
    cached = sum(lengths)
    nbytes = cached * nkv * 2 * hd * 2 + 2 * b * nq * hd * 2 + b * pps * 4 + b * 4
    kr.record("paged_decode_ro", f"{tag} B={b} NKV={nkv} R={r} HD={hd} PS={ps} J={pps} "
              f"lengths={','.join(map(str, lengths))}", max_err(got, want), k_ms, k_wall, p_ms,
              lib_ms, nbytes, 4.0 * nq * hd * cached,
              after_write_max_abs_err=max_err(after, ref)[0])
    del sets, lib_sets


def phase_kernels(seed: int, names=None):
    """Every kernel against its plain version at the main paths' shapes;
    ``names``: only the groups of rows of these kernels (all when None)."""
    from accessory_tpu_torch.ops.rope import precompute_rope, rope_rows

    kr = KernelRows(seed)

    def want(kernel):
        return names is None or kernel in names

    if want("w4_matmul"):
        # -- TinyLlama-1.1B (GQA) path: the four decode-layer projections at M 1 (the
        #    stream phase's decode: the one-row GEMV), 4 (the serve phases' decode
        #    batch), 8 (the decode phases'), 16 (the GEMV's most rows), 128 (the
        #    stream phase's prefill) and 512 (the serve phases' prefill)
        cos, sin = precompute_rope(64, 1024, device="cuda")
        rope = rope_rows(cos, sin, 36, 4, 64, "interleaved") + ("interleaved", 64)
        _kernels_w4(kr, "tiny", TINY_PROJ, (1, 4, 8, 16, 128, 512), rope)
        # -- the stacked path's separate projections, with no prologue or epilogue
        #    (wk and wv, w1 and w3 share a shape; its wo and w2 are the rows above)
        _kernels_w4(kr, "tiny", [("wq", 2048, 2048, ""), ("wk/wv", 2048, 256, ""),
                                 ("w1/w3", 2048, 5632, "")], (4, 8, 512), rope)
        # -- LLaMA2-7B (MHA) path: the same four at the decode batch 8 and at M 1 and
        #    4 (K 11008 is padded to 11264 in the weight; RoPE at head_dim 128)
        cos, sin = precompute_rope(128, 1024, device="cuda")
        rope = rope_rows(cos, sin, 64, 32, 128, "interleaved") + ("interleaved", 128)
        _kernels_w4(kr, "7b", [("wqkv", 4096, 12288, "norm+rope"), ("wo", 4096, 4096, "res"),
                               ("w13", 4096, 22016, "norm"), ("w2", 11008, 4096, "res")],
                    (1, 4, 8), rope)

        # -- Mixtral-8x7B (MoE): its separate projections and one expert's w1 / w3
        #    and w2 at the decode batch 8 and at one row, K 4096 and 14336
        _kernels_w4(kr, "mixtral", [(nm, k, n, "") for nm, k, n in MIXTRAL_PROJ], (1, 8),
                    (None, None, "", 0))
        # -- Falcon-40B's and InternLM-7B's projections (no fusion: their own
        #    norms and biases) at the decode batch 8, Falcon's also at one row
        _kernels_w4(kr, "falcon40b", [(nm, k, n, "") for nm, k, n in FALCON_PROJ], (1, 8),
                    (None, None, "", 0))
        _kernels_w4(kr, "internlm7b", [(nm, k, n, "") for nm, k, n in INTERNLM_PROJ], (8,),
                    (None, None, "", 0))

    if want("w4_matmul_bigm"):
        # -- Mixtral's 8 x 128 = 1024-row prefill: wk / wv and an expert's products
        #    (its wq / wo are the 7B wo rows below)
        _kernels_bigm(kr, [(nm, k, n, 1024) for nm, k, n in MIXTRAL_PROJ[1:]], tag="mixtral")
        # -- Falcon-40B's and InternLM-7B's 1024-row prefill
        _kernels_bigm(kr, [(nm, k, n, 1024) for nm, k, n in FALCON_PROJ], tag="falcon40b")
        _kernels_bigm(kr, [(nm, k, n, 1024) for nm, k, n in INTERNLM_PROJ], tag="internlm7b")
        # -- its prefill: the many-row kernel at 8 x 128 = 1024 rows, the QPEFT
        #    training step's 8 x 512 = 4096, and one row count that is not a
        #    multiple of the 256-row tile
        _kernels_bigm(kr, [(nm, k, n, m) for m in (1024, 4096)
                           for nm, k, n in (("wqkv", 4096, 12288), ("wo", 4096, 4096),
                                            ("w13", 4096, 22016), ("w2", 11008, 4096))]
                      + [("wo", 4096, 4096, 1000)])

    if want("decode_attention"):
        # -- fused decode attention + KV write, GQA (_kernel_bloop_w): the decode
        #    phases' batch 8 and 1024-token cache, a cache length not a multiple
        #    of 128, and the serve phases' batch 4 and the stream phase's batch 1
        #    over their 192-token caches
        tiny_cases = ((8, 1024, 0), (8, 1024, 1), (8, 1024, 511), (8, 1024, 1023), (4, 192, 150),
                      (1, 192, 150))
        _kernels_decode(kr, "tiny", 32, 4, 64, tiny_cases + ((8, 1000, 999),))
        # -- its int8 form (_kernel_bloop_w8) and the read-only forms (_kernel_bloop
        #    / _kernel, _kernel_bloop8), each also held as "read-only + one-token
        #    write == fused"; an HD 128 GQA shape (NKV 8, R 4)
        _kernels_decode(kr, "tiny", 32, 4, 64, tiny_cases, int8=True)
        _kernels_decode(kr, "tiny", 32, 4, 64, tiny_cases, write=False)
        _kernels_decode(kr, "tiny", 32, 4, 64, tiny_cases, int8=True, write=False)
        for int8, write in ((True, True), (False, False), (True, False)):
            _kernels_decode(kr, "hd128", 32, 8, 128, ((8, 1024, 511),), int8=int8, write=write,
                            most_copies=8)
        # -- Mixtral (NKV 8, R 4, HD 128): the fused bf16 and int8 decode at the
        #    decode phase's shape and the serve phase's 192-token cache
        for int8 in (False, True):
            _kernels_decode(kr, "mixtral", 32, 8, 128, ((8, 1024, 511), (8, 192, 150)),
                            int8=int8, most_copies=8)
        # -- Falcon-40B (NKV 8, R 16, HD 64): the fused bf16 and int8 decode at
        #    the decode and serve shapes, and the read-only forms (unfused route)
        for int8, write in ((False, True), (True, True), (False, False), (True, False)):
            _kernels_decode(kr, "falcon40b", 128, 8, 64,
                            ((8, 1024, 511), (8, 192, 150)) if write else ((8, 1024, 511),),
                            int8=int8, write=write, most_copies=8)
        # -- the read-only forms as the stacked path calls them: q, k, v each a
        #    tensor of its own (separate projections), not views of one wqkv output
        for int8 in (False, True):
            _kernels_decode(kr, "tiny", 32, 4, 64, ((4, 192, 150), (8, 1024, 511)), int8=int8,
                            write=False, separate=True)

    if want("decode_attention_mha"):
        # -- the same for MHA (_kernel_hgrp_w) and its int8 form (_kernel_hgrp_w8)
        #    at the 7B shape, the 7B serve phase's 192-token cache, and one
        #    head_dim-64 shape. The caches are 134 MB a copy, so at most 4 copies
        #    rotate (a short read then stays in L2, as it would in the model).
        mha_cases = ((8, 1024, 0), (8, 1024, 1), (8, 1024, 511), (8, 1024, 1023), (8, 192, 150))
        _kernels_decode(kr, "7b", 32, 32, 128, mha_cases, most_copies=4)
        _kernels_decode(kr, "hd64", 16, 16, 64, ((8, 1000, 999),), most_copies=4)
        _kernels_decode(kr, "7b", 32, 32, 128, mha_cases, int8=True, most_copies=4)
        _kernels_decode(kr, "hd64", 16, 16, 64, ((8, 1000, 999),), int8=True, most_copies=4)
        # -- the read-only forms at one query head per KV head (the MHA kernel
        #    without its write), 7B shape
        ro_cases = ((8, 1024, 511), (8, 1024, 1023))
        _kernels_decode(kr, "7b", 32, 32, 128, ro_cases, write=False, most_copies=4)
        _kernels_decode(kr, "7b", 32, 32, 128, ro_cases, int8=True, write=False, most_copies=4)

    if want("flash_attention"):
        # -- causal prefill flash attention (splash), and the 700M full
        #    finetune's forward (2 x 2048, 16 / 8 heads)
        _kernels_flash(kr, (("tiny", 4, 128, 32, 4, 64), ("tiny", 1, 128, 32, 4, 64),
                            ("tiny", 4, 200, 32, 4, 64),
                            ("hd128", 4, 128, 16, 4, 128), ("7b", 8, 128, 32, 32, 128),
                            ("mixtral", 8, 128, 32, 8, 128), ("falcon40b", 8, 128, 128, 8, 64),
                            ("700m", 2, 2048, 16, 8, 128)))

    if want("kv_write"):
        # -- prefill KV slab writes (_write_slab_layer, _write_slab_layer_q8)
        #    at the serve phases' batch 4 / 8 and the stream phase's batch 1
        _kernels_slab(kr, "tiny", 4, 4, 64, 192, 128, (0, 37))
        _kernels_slab(kr, "tiny", 1, 4, 64, 192, 128, (0,))
        _kernels_slab(kr, "7b", 8, 32, 128, 192, 128, (0,))
        _kernels_slab8(kr, "tiny", 4, 4, 64, 192, 128, (0,))
        _kernels_slab8(kr, "tiny", 1, 4, 64, 192, 128, (0,))
        _kernels_slab8(kr, "7b", 8, 32, 128, 192, 128, (0, 37))
        _kernels_slab(kr, "mixtral", 8, 8, 128, 192, 128, (0,))
        _kernels_slab8(kr, "mixtral", 8, 8, 128, 192, 128, (0,))
        _kernels_slab(kr, "falcon40b", 8, 8, 64, 192, 128, (0,))
        _kernels_slab8(kr, "falcon40b", 8, 8, 64, 192, 128, (0,))
        # -- one-token writes (_write_col_layer, _write_col_layer_q8) at the decode
        #    shapes, and the stacked writes of all 22 layers in one launch
        #    (_write_col_inplace at one token, _write_inplace for the prefill slab,
        #    write_kv_t8)
        _kernels_slab(kr, "tiny", 8, 4, 64, 1024, 1, (0, 511, 1023))
        _kernels_slab8(kr, "tiny", 8, 4, 64, 1024, 1, (0, 511, 1023))
        _kernels_slab(kr, "7b", 8, 32, 128, 1024, 1, (511,))
        _kernels_slab8(kr, "7b", 8, 32, 128, 1024, 1, (511,))
        for int8 in (False, True):
            _kernels_stacked(kr, "tiny", 22, 8, 4, 64, 1024, 1, 511, int8)
            _kernels_stacked(kr, "tiny", 22, 4, 4, 64, 192, 1, 150, int8)
            _kernels_stacked(kr, "tiny", 22, 4, 4, 64, 192, 128, 0, int8)

    if want("paged_decode"):
        # -- the paged KV cache (continuous batching): paged decode attention over
        #    8 slots of ragged lengths (0, 1, page edges, 511) at the decode step
        #    and the speculative verify width 5, TinyLlama (GQA) and the 7B shape
        #    (one query head per KV head)
        ragged = [0, 1, 63, 64, 65, 130, 300, 511]
        for int8 in (False, True):
            for sq in (1, 5):
                _kernels_paged_decode(kr, "tiny", 4, 8, 64, sq, ragged, int8)
            _kernels_paged_decode(kr, "7b", 32, 1, 128, 1, ragged, int8, most_copies=4)
            _kernels_paged_identity(kr, int8)
        # -- Mixtral's batcher (NKV 8, R 4, HD 128, bf16 pools): 4 slots about the
        #    128-token prompts' length at the decode step
        _kernels_paged_decode(kr, "mixtral", 8, 4, 128, 1, [128, 129, 140, 159], False,
                              most_copies=8)

    if want("paged_write"):
        # -- the paged writes of all 22 layers at the decode step, the verify
        #    width and the 128-token prefill bucket
        for int8 in (False, True):
            for s in (1, 5, 128):
                _kernels_paged_write(kr, "tiny", 22, 8, s, 4, 64, int8)
        # -- Mixtral's batcher: 32 layers, 4 slots, a decode step and a prefill
        for s in (1, 128):
            _kernels_paged_write(kr, "mixtral", 32, 4, s, 8, 128, False)

    if want("w4_dequant") or want("flash_attention_bwd_dq"):
        # -- training: the one-pass W4 dequant of the QPEFT backward at the 7B
        #    projections (w2's in_dim 11008 is padded to 11264 in the weight) and
        #    TinyLlama's w1 / w3; the flash-attention backward at the 7B QPEFT
        #    step (8 x 512, MHA), the 700M full finetune (2 x 2048, 16 / 8 heads),
        #    train_parity's TinyLlama GQA (4 x 256, 32 / 4, head_dim 64) and a
        #    ragged length
        _kernels_dequant(kr, [("7b wq/wk/wv/wo", 4096, 4096), ("7b w1/w3", 4096, 11008),
                              ("7b w2", 11264, 4096), ("tiny w1/w3", 2048, 5632)])
        _kernels_flash_bwd(kr, [("7b", 8, 512, 32, 32, 128), ("700m", 2, 2048, 16, 8, 128),
                                ("tiny", 4, 256, 32, 4, 64), ("ragged", 2, 77, 32, 4, 64)])

    if want("w8_matmul"):
        # -- W8A16 (serve7b_w8 / decode7b_w8 / parity_w8): the 7B projections at
        #    the decode batch 8 with their fusions and at one row (the GEMV's
        #    smallest form), at the 1024 prefill rows unfused (the prefill's
        #    route, module_linear_nr) and at 128 rows fused (the wgmma tile, K
        #    split), and TinyLlama's fused at parity_w8's 512 rows
        cos, sin = precompute_rope(128, 1024, device="cuda")
        rope = rope_rows(cos, sin, 64, 32, 128, "interleaved") + ("interleaved", 128)
        proj7b = [("wqkv", 4096, 12288, "norm+rope"), ("wo", 4096, 4096, "res"),
                  ("w13", 4096, 22016, "norm"), ("w2", 11008, 4096, "res")]
        _kernels_w8(kr, "7b", [(nm, k, n, m, f) for m in (8, 1) for nm, k, n, f in proj7b]
                    + [(nm, k, n, 1024, "") for nm, k, n, _ in proj7b]
                    + [(nm, k, n, 128, f) for nm, k, n, f in proj7b], rope)
        cos, sin = precompute_rope(64, 1024, device="cuda")
        rope = rope_rows(cos, sin, 36, 4, 64, "interleaved") + ("interleaved", 64)
        _kernels_w8(kr, "tiny", [(nm, k, n, 512, f) for nm, k, n, f in TINY_PROJ], rope)
    if want("w4_matmul_std") or want("w4_matmul_magic"):
        # -- std W4 (GPTQ imports) and its magic repack: the four projections of
        #    the GPTQ decode at the stream / serve / decode batches (the GEMV),
        #    TinyLlama's w13 at the serve prefill's 4 x 64 rows, all four at the
        #    128-row (stream and batcher prefill) and 512-row (serve prefill)
        #    tiles, and the 7B w13 and w2 (in_dim 11008 in a weight padded to
        #    11264, the magic tile's) at batch 8
        _kernels_w4elem(kr, "tiny", [(nm, k, n, m) for m in (1, 4, 8)
                                     for nm, k, n, _ in TINY_PROJ])
        _kernels_w4elem(kr, "tiny", [("w13", 2048, 11264, 256)])
        _kernels_w4elem(kr, "tiny", [(nm, k, n, m) for m in (128, 512)
                                     for nm, k, n, _ in TINY_PROJ])
        _kernels_w4elem(kr, "7b", [("w13", 4096, 22016, 8), ("w2", 11264, 4096, 8, 11008)])

    if want("ffn_fused"):
        # -- the fused W4 decode FFN (ffn_fuse): TinyLlama and 7B widths at the
        #    stream (1), serve (4), a ragged (5) and the decode (8) batches, the
        #    one-pass row templates' largest (16) and the first of passes of 16
        #    rows (17), and its largest row count (128)
        _kernels_ffn(kr, "tiny", 2048, 5632, 2048, (1, 4, 5, 8, 16, 17, 128))
        _kernels_ffn(kr, "7b", 4096, 11008, 4096, (1, 4, 5, 8, 16, 17, 128))
    if want("paged_decode_ro"):
        # -- the read-only paged decode (kvcache.paged_attention_decode): 8 slots of
        #    lengths 1..1024 over 64-token pages, TinyLlama (GQA) and 7B (MHA)
        tokens = [1, 63, 64, 65, 300, 511, 777, 1024]
        _kernels_paged_ro(kr, "tiny", 4, 8, 64, tokens)
        _kernels_paged_ro(kr, "7b", 32, 1, 128, tokens, most_copies=4)
    if want("flash_attention_cp"):
        # -- context parallelism (row 26): train_cp's shape (the 7B step's b 1 x
        #    4096 on one rank: q0 0, SK = SQ), the first and the last of four
        #    shards of an 8192-token sequence at 7B (MHA, head_dim 128) and
        #    TinyLlama (GQA 32 / 4, head_dim 64) widths, a ragged split (S 8000:
        #    2000-row shards, not a multiple of the 64-row tile), and the q0 = 0
        #    identity
        _kernels_cp(kr, [("train_cp", 1, 4096, 32, 32, 128, 1, (0,)),
                         ("7b", 1, 8192, 32, 32, 128, 4, (0, 3)),
                         ("tiny", 1, 8192, 32, 4, 64, 4, (0, 3)),
                         ("ragged", 1, 8000, 32, 4, 64, 4, (2,))])
        _kernels_cp_identity(kr, [("7b", 1, 2048, 32, 32, 128), ("tiny", 2, 1000, 32, 4, 64)])
    return kr.rows


def _tree_to(node, device):
    """A params tree (dicts, lists, tensors, QuantizedWeights) on ``device``."""
    if isinstance(node, dict):
        return {k: _tree_to(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_tree_to(v, device) for v in node)
    return node.to(device)


# kernel-name substrings of each new weight format's matmul in a profiler
# trace (W8: its tile and the fused GEMV's qgemv::W8 policy)
_MATMUL_SYMBOLS = {"w8_matmul": ("w8_", "qgemv::W8"), "w4_matmul_std": ("StdLayout",),
                   "w4_matmul_magic": ("MagicLayout",)}

# bf16 activations round (2^-8 relative) at different points on the two
# sides (kernel sums in another order, so a rounding may flip by one ulp and
# carry through the layers): logits are held to 2% of the largest |logit| and
# 2% in relative L2, and greedy tokens must agree wherever the CPU's top-2
# margin exceeds the absolute tolerance.
LOGIT_TOL_FRAC = 2e-2
LOGIT_REL_L2 = 2e-2   # ||gpu - cpu|| / ||cpu||


def phase_parity(seed: int, phase: str, cfg: dict, n_layers: int, b: int, plen: int, steps: int,
                 s_len: int, kv_dtypes=(None,), stacked: bool = False, make_params=None,
                 label: str = "W4", ffn_fuse: bool = False, family: str = "llama"):
    """Same weights, CPU through the plain versions vs the card through the
    kernels: prefill logits, then ``steps`` decode steps fed the CPU's greedy
    tokens, once per KV-cache dtype. ``stacked``: the stacked-cache path
    (separate projections, read-only attention, one bulk write per forward).
    ``make_params(args)``: the quantized (unfused) params on the card, W4 RTN
    by default. ``ffn_fuse``: both sides' decode steps take the fused FFN.
    ``family``: the model module (``cfg`` its args' fields; LLaMA's wqkv /
    w13 fused for the unrolled path, the other families' projections as
    they are). Returns the card's prefill logits of the last run."""
    import torch

    from accessory_tpu_torch.config import ARGS_REGISTRY
    from accessory_tpu_torch.models import get_model_module
    from accessory_tpu_torch.quant.fuse import fuse_for_decode
    from accessory_tpu_torch.quant.quantize import quantize_params

    module = get_model_module(family)
    depth = "n_layers" if family == "llama" else "num_layers"
    args = ARGS_REGISTRY[family](**dict(cfg, **{depth: n_layers}), max_seq_len=s_len)
    params_gpu = (make_params(args) if make_params is not None
                  else quantize_params(module.init_params(args, seed=seed)))
    if not stacked and getattr(module, "SUPPORTS_FUSED_QKV", False):
        params_gpu = fuse_for_decode(params_gpu)
    torch.cuda.empty_cache()
    params_cpu = _tree_to(params_gpu, "cpu")
    g = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, args.vocab_size, (b, plen), generator=g)
    for kv_dtype in kv_dtypes:
        cache_g = module.init_kv_cache(args, b, s_len, kv_dtype=kv_dtype, stacked=stacked)
        cache_c = module.init_kv_cache(args, b, s_len, kv_dtype=kv_dtype, device="cpu",
                                       stacked=stacked)
        cpu_s = 0.0

        def cpu_forward(tokens, pos):
            nonlocal cpu_s
            t0 = time.perf_counter()
            out, _ = module.forward(params_cpu, args, tokens, cache=cache_c, cur_pos=pos,
                                    ffn_fuse=ffn_fuse)
            cpu_s += time.perf_counter() - t0
            return out

        lg, _ = module.forward(params_gpu, args, prompt.cuda(), cache=cache_g, cur_pos=0)
        first = lg
        lc = cpu_forward(prompt, 0)
        worst_abs, worst_rel, checked, agreed = 0.0, 0.0, 0, 0
        tol_abs = LOGIT_TOL_FRAC * float(lc.abs().max())

        def compare(gpu, cpu):
            nonlocal worst_abs, worst_rel, checked, agreed
            gpu = gpu.float().cpu()
            if not torch.isfinite(gpu).all():
                raise AssertionError(f"{phase}: non-finite GPU logits")
            worst_abs = max(worst_abs, float((gpu - cpu).abs().max()))
            worst_rel = max(worst_rel, float((gpu - cpu).norm() / cpu.norm()))
            top2 = cpu.topk(2, dim=-1).values
            sure = (top2[..., 0] - top2[..., 1]) > tol_abs
            checked += int(sure.sum())
            agreed += int((gpu.argmax(-1) == cpu.argmax(-1))[sure].sum())

        compare(lg, lc)
        tok = lc[:, -1].argmax(-1)
        for i in range(steps):
            lg, _ = module.forward(params_gpu, args, tok[:, None].cuda(), cache=cache_g,
                                   cur_pos=plen + i, ffn_fuse=ffn_fuse)
            lc = cpu_forward(tok[:, None], plen + i)
            compare(lg, lc)
            tok = lc[:, -1].argmax(-1)
        row = {"phase": phase, "path": "stacked" if stacked else "unrolled", "weights": label,
               "ffn_fuse": ffn_fuse, "family": family,
               "layers": n_layers, "dim": getattr(args, "dim", None) or args.hidden_size,
               "batch": b, "prompt": plen,
               "prefill_rows": b * plen, "decode_steps": steps,
               "kv_dtype": kv_dtype or "bf16", "cpu_seconds": round(cpu_s, 2),
               "max_abs_logit_err": worst_abs, "max_rel_l2_err": worst_rel,
               "logit_absmax": tol_abs / LOGIT_TOL_FRAC, "tol_abs": tol_abs,
               "tol_rel_l2": LOGIT_REL_L2,
               "tokens_checked": checked, "tokens_agreed": agreed}
        emit(row)
        if worst_abs > tol_abs or worst_rel > LOGIT_REL_L2 or agreed != checked:
            raise AssertionError(f"{phase} failed: {row}")
    return first


def _route_logits(params, args, toks, prefill_len: int, start: int, end: int, ffn_fuse: bool):
    """Logits that pick the tokens at positions start .. end - 1, teacher-
    forced on ``toks`` (b, >= end) as the Generator feeds them: a prefill of
    the first ``prefill_len`` tokens, then one decode step a position.
    Returns (b, end - start, vocab) f32."""
    import torch

    from accessory_tpu_torch.models import llama

    cache = llama.init_kv_cache(args, toks.shape[0], toks.shape[1])
    lg, _ = llama.forward(params, args, toks[:, :prefill_len], cache=cache, cur_pos=0,
                          ffn_fuse=ffn_fuse)
    out = [lg[:, start - 1]]
    for cur in range(start, end - 1):
        lg, _ = llama.forward(params, args, toks[:, cur:cur + 1], cache=cache, cur_pos=cur,
                              ffn_fuse=ffn_fuse)
        out.append(lg[:, 0])
    return torch.stack(out, dim=1).float()


def _compare_routes(fused, unfused, picked=None):
    """The fused FFN route's logits against the unfused route's at the
    parity tolerances: 2% of the largest |logit| and 2% relative L2; the
    greedy token must agree wherever the unfused top-2 margin exceeds the
    absolute tolerance (``picked``: the positions whose token was sampled,
    not forced by the prompt)."""
    import torch

    tol_abs = LOGIT_TOL_FRAC * float(unfused.abs().max())
    top2 = unfused.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > tol_abs
    differ = fused.argmax(-1) != unfused.argmax(-1)
    if picked is not None:
        sure, differ = sure & picked, differ & picked
    row = {"max_abs_logit_err": float((fused - unfused).abs().max()),
           "rel_l2_err": float((fused - unfused).norm() / unfused.norm()), "tol_abs": tol_abs,
           "tol_rel_l2": LOGIT_REL_L2, "tokens_checked": int(sure.sum()),
           "tokens_agreed": int((sure & ~differ).sum()),
           "greedy_disagreements_at_near_ties": int((differ & ~sure).sum())}
    row["ok"] = bool(torch.isfinite(fused).all()) and row["max_abs_logit_err"] <= tol_abs \
        and row["rel_l2_err"] <= LOGIT_REL_L2 and row["tokens_agreed"] == row["tokens_checked"]
    return row


def phase_parity_ffn(seed: int):
    """ffn_fuse at TinyLlama width, 2 layers: the CPU (the fused FFN's plain
    version) against the card (the kernel) as in parity, a 64-token prefill
    and 16 teacher-forced decode steps; then on the card the fused route
    against the unfused one over the same prompt and the unfused route's
    greedy tokens, with each route's decode launches counted."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.config import LLaMAArgs
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.quant.fuse import fuse_for_decode
    from accessory_tpu_torch.quant.quantize import quantize_params

    phase_parity(seed, "parity_ffn", TINYLLAMA, 2, b=2, plen=64, steps=16, s_len=128,
                 ffn_fuse=True)
    args = LLaMAArgs(**dict(TINYLLAMA, n_layers=2), max_seq_len=128)
    params = fuse_for_decode(quantize_params(llama.init_params(args, seed=seed)))
    b, plen, steps = 2, 64, 16
    toks = torch.zeros((b, plen + steps), dtype=torch.int64, device="cuda")
    toks[:, :plen] = torch.randint(0, args.vocab_size, (b, plen),
                                   generator=torch.Generator().manual_seed(seed + 1))
    cache = llama.init_kv_cache(args, b, 128)
    lg, _ = llama.forward(params, args, toks[:, :plen], cache=cache, cur_pos=0)
    for i in range(steps):           # the unfused route's greedy tokens
        toks[:, plen + i] = lg[:, -1].argmax(-1)
        lg, _ = llama.forward(params, args, toks[:, plen + i:plen + i + 1], cache=cache,
                              cur_pos=plen + i)
    logits, counts = {}, {}
    for fuse in (True, False):
        kernels.reset_launch_counts()
        logits[fuse] = _route_logits(params, args, toks, plen, plen, plen + steps, fuse)
        counts[fuse] = {k: v for k, v in kernels.launch_counts().items() if v}
    row = {"phase": "parity_ffn", "compare": "card, fused FFN vs unfused route",
           "layers": 2, "batch": b, "prompt": plen, "decode_steps": steps - 1,
           "launches_fused": counts[True], "launches_unfused": counts[False],
           **_compare_routes(logits[True], logits[False])}
    emit(row)
    want_ffn = args.n_layers * (steps - 1)
    if (not row["ok"] or counts[True].get("ffn_fused") != want_ffn
            or "ffn_fused" in counts[False]):
        raise AssertionError(f"parity_ffn failed: {row}")


PROMPTS = [
    "The quick brown fox jumps over the lazy dog while the farmer counts his sheep "
    "twice before the sun sets.",
    "In the beginning the universe was created. This has made a lot of people very "
    "angry and been widely regarded as a bad move.",
    "Four score and seven years ago our fathers brought forth on this continent a new "
    "nation, conceived in liberty.",
    "It was the best of times, it was the worst of times, it was the age of wisdom, it "
    "was the age of foolishness.",
    "Call me Ishmael. Some years ago, never mind how long precisely, having little or no "
    "money in my purse, I went to sea.",
    "It is a truth universally acknowledged, that a single man who has come into a good "
    "fortune, must be in want of a wife.",
    "All happy families are alike; each unhappy family is unhappy in its own way, and "
    "everything was in confusion.",
    "Many years later, as he faced the firing squad, the colonel was to remember that "
    "distant afternoon of ice.",
]


def _zero_counts(**kw):
    return {**{name: 0 for name in KERNEL_NAMES}, **kw}


def _quantized_model(cfg: dict, max_seq_len: int, seed: int, bits: int = 4):
    import torch

    from accessory_tpu_torch.meta import MetaModel

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = MetaModel("llama", dict(cfg), max_seq_len=max_seq_len, seed=seed)
    model.tokenizer = ByteTokenizer()
    model.quantize(bits=bits)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _timed_prefill(model, batch: int, plen: int, buf_len: int, kv_dtype):
    """One prefill forward alone at the serve shape, the second of two runs."""
    import torch

    toks = torch.randint(0, 256, (batch, plen), device="cuda")
    for _ in range(2):
        cache = model.module.init_kv_cache(model.args, batch, buf_len, kv_dtype=kv_dtype)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, _ = model.module.forward(model.generator.params, model.args, toks, cache=cache,
                                         cur_pos=0)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
    if not (logits.shape == (batch, plen, model.args.vocab_size)
            and torch.isfinite(logits).all()):
        raise AssertionError("serve: prefill logits not finite / wrong shape")
    return prefill_ms


def _counted_generate(model, prompts, max_gen_len: int):
    """model.generate with every launch count set to 0 just before and read
    just after. Returns (texts, counts, decode steps, seconds)."""
    import torch

    from accessory_tpu_torch import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = model.generate(prompts, max_gen_len=max_gen_len)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return outs, kernels.launch_counts(), model.generator.last_decode_steps, secs


def phase_serve(phase: str, model, setup_s: float, kv_dtype=None, matmul="w4_matmul",
                max_gen_len: int = 64, ffn_fuse: bool = False):
    """The 22-layer TinyLlama shape (GQA) through MetaModel.generate with the
    bf16 (serve) or the int8 (serve8) KV cache, launch-counted. ``matmul``:
    the quantized-matmul entry every projection must take (None: the weights
    have no kernel, W3). ``ffn_fuse``: each decode step's FFN is one fused
    kernel call (serve_ffn). Returns the counts and the texts."""
    prompts = PROMPTS[:4]
    assert all(100 <= len(p) <= 126 for p in prompts), [len(p) for p in prompts]
    int8 = kv_dtype == "int8"
    model.kv_dtype = kv_dtype
    model.ffn_fuse = ffn_fuse
    model._reset_generator()
    n_layers = model.args.n_layers
    prefill_ms = _timed_prefill(model, 4, 128, 192, kv_dtype)
    outs, counts, steps, total_s = _counted_generate(model, prompts, max_gen_len)
    want = _zero_counts(
        flash_attention=n_layers,
        **{"decode_attention8" if int8 else "decode_attention": n_layers * steps,
           "kv_write_q8" if int8 else "kv_write": n_layers})
    if matmul:
        want[matmul] = 4 * n_layers * (1 + steps)
    if ffn_fuse:
        want.update(w4_matmul=4 * n_layers + 2 * n_layers * steps, ffn_fused=n_layers * steps)
    row = {"phase": phase, "model": "TinyLlama-1.1B shape", "kv_dtype": kv_dtype or "bf16",
           "layers": n_layers, "ffn_fuse": ffn_fuse,
           "batch": len(prompts), "prompt_tokens": [len(p) + 1 for p in prompts],
           "prefill_rows": 4 * 128, "decode_steps": steps,
           "launches": counts, "launches_expected": want, "setup_s": setup_s,
           "prefill_ms": prefill_ms, "generate_s": total_s,
           "decode_tok_s": len(prompts) * steps / max(total_s - prefill_ms / 1e3, 1e-9),
           "wall_ms_per_token_step": (total_s * 1e3 - prefill_ms) / max(steps, 1),
           "outputs_chars": [len(o) for o in outs]}
    emit(row)
    if counts != want or steps < 1 or len(outs) != len(prompts):
        raise AssertionError(f"{phase}: launch counts {counts} != expected {want}")
    return counts, outs


def phase_serve_ffn(model, setup_s: float):
    """serve with ffn_fuse on the loaded weights (4 prompts x 64 new tokens
    through MetaModel.generate): launch counts exact (per decode step 2
    w4_matmul and 1 ffn_fused a layer); the greedy text against the unfused
    route's on the same weights (serve's route); and both routes' logits,
    teacher-forced on the unfused route's tokens, held to the parity
    tolerances, the greedy token equal wherever the unfused choice is
    confident, so a difference in text can only start at a near-tie."""
    import numpy as np
    import torch

    from accessory_tpu_torch.engine.generate import _round_up

    counts, fused = phase_serve("serve_ffn", model, setup_s, ffn_fuse=True)
    fused_tokens = model.generator.last_tokens
    model.ffn_fuse = False
    model._reset_generator()
    unfused = model.generate(PROMPTS[:4], max_gen_len=64)
    gen = model.generator
    toks_np = gen.last_tokens
    plens = [len(gen.tokenizer.encode(p, bos=True, eos=False)) for p in PROMPTS[:4]]
    start, end = min(plens), min(model.args.max_seq_len, 64 + max(plens))
    prefill_len = min(_round_up(start), toks_np.shape[1])
    toks = torch.from_numpy(toks_np).cuda()
    logits = {f: _route_logits(gen.params, model.args, toks, prefill_len, start, end, f)
              for f in (True, False)}
    picked = torch.tensor([[j >= n for j in range(start, end)] for n in plens], device="cuda")
    same = [fused_tokens[i, n:n + 64] == toks_np[i, n:n + 64] for i, n in enumerate(plens)]
    row = {"phase": "serve_ffn", "compare": "fused FFN vs unfused route, loaded weights",
           "text_equal": fused == unfused,
           "greedy_share_equal": float(np.mean(np.concatenate(same))),
           **_compare_routes(logits[True], logits[False], picked)}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve_ffn failed: {row}")
    return counts


def _same_params(a, b, path=""):
    """Every tensor of two params trees equal bit for bit; returns the count."""
    import torch

    from accessory_tpu_torch.quant.qtensor import QuantizedWeight

    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"checkpoint: keys differ at {path}: {set(a) ^ set(b)}")
        return sum(_same_params(a[k], b[k], f"{path}/{k}") for k in a)
    if isinstance(a, list):
        if len(a) != len(b):
            raise AssertionError(f"checkpoint: {len(b)} layers came back, {len(a)} were saved")
        return sum(_same_params(x, y, f"{path}/{i}") for i, (x, y) in enumerate(zip(a, b)))
    if isinstance(a, QuantizedWeight):
        ma, mb = ((w.bits, w.group_size, w.in_dim, w.out_dim, w.act_dtype, w.layout)
                  for w in (a, b))
        if ma != mb:
            raise AssertionError(f"checkpoint: {path} came back as {mb}, was {ma}")
        return sum(_same_params(getattr(a, f), getattr(b, f), f"{path}#{f}")
                   for f in ("packed", "scales", "zeros"))
    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
        raise AssertionError(f"checkpoint: tensor {path} differs after the round trip")
    return 1


def phase_checkpoint(model):
    """save_pretrained of the quantized 22-layer model into a temporary
    directory, MetaModel.from_pretrained on it (meta.json and config.json
    probed; the byte-level stub tokenizer writes no file, so the tokenizer
    object is handed over; quant=True must leave the W4 leaves as they are),
    every tensor compared bit for bit. Returns the loaded MetaModel."""
    import os

    import torch

    from accessory_tpu_torch.meta import MetaModel

    tmp = tempfile.mkdtemp(prefix="accessory_ckpt_")
    try:
        t0 = time.perf_counter()
        model.save_pretrained(tmp)
        save_s = time.perf_counter() - t0
        files = {f: os.path.getsize(os.path.join(tmp, f)) for f in sorted(os.listdir(tmp))}
        t0 = time.perf_counter()
        loaded = MetaModel.from_pretrained(tmp, max_seq_len=model.args.max_seq_len, quant=True,
                                           kv_dtype="int8", tokenizer=ByteTokenizer())
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if loaded.args != model.args:
        raise AssertionError(f"checkpoint: config.json gave {loaded.args}, saved {model.args}")
    if loaded.llama_type != model.llama_type or loaded.kv_dtype != "int8":
        raise AssertionError("checkpoint: from_pretrained lost llama_type or kv_dtype")
    n = _same_params(model.params, loaded.params)
    emit({"phase": "checkpoint", "layers": model.args.n_layers, "files": files,
          "bytes": sum(files.values()), "save_s": save_s, "load_s": load_s,
          "tensors_compared_bit_for_bit": n, "w4_layout_on_disk": "planes"})
    return loaded


def phase_stream(model):
    """MetaModel.stream_generate: one prompt, 64 new tokens, both cache types.
    The concatenated stream must equal generate([prompt])'s greedy text."""
    import torch

    from accessory_tpu_torch import kernels

    prompt = PROMPTS[0]
    n_layers = model.args.n_layers
    total = {name: 0 for name in KERNEL_NAMES}
    for kv_dtype in (None, "int8"):
        int8 = kv_dtype == "int8"
        model.kv_dtype = kv_dtype
        model._reset_generator()
        list(model.stream_generate(prompt, max_gen_len=4))        # warm-up
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        chunks = list(model.stream_generate(prompt, max_gen_len=64))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = kernels.launch_counts()
        steps = model.generator.last_decode_steps
        want = _zero_counts(
            w4_matmul=4 * n_layers * (1 + steps), flash_attention=n_layers,
            **{"decode_attention8" if int8 else "decode_attention": n_layers * steps,
               "kv_write_q8" if int8 else "kv_write": n_layers})
        whole = model.generate([prompt], max_gen_len=64)[0]
        row = {"phase": "stream", "kv_dtype": kv_dtype or "bf16", "layers": n_layers,
               "prompt_tokens": len(prompt) + 1, "yields": len(chunks), "decode_steps": steps,
               "seconds": secs, "tok_s": steps / secs, "launches": counts,
               "launches_expected": want, "chars": len(chunks[-1]["text"]),
               "equals_generate": chunks[-1]["text"] == whole}
        emit(row)
        if (counts != want or steps < 1 or not chunks[-1]["end_of_content"]
                or any(c["end_of_content"] for c in chunks[:-1]) or not row["equals_generate"]):
            raise AssertionError(f"stream failed: {row}")
        for name in total:
            total[name] += counts[name]
    return total


def phase_stacked(model):
    """Generator(unroll_decode=False).generate on the loaded weights, both
    cache types: separate projections (7 W4 launches a layer), read-only
    attention, one stacked write per forward. Its greedy tokens are compared
    with the unrolled path's (share printed) and its logits of the prefill
    and the first decode step held to the parity tolerance against the
    unrolled path's."""
    import numpy as np
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.engine.generate import Generator
    from accessory_tpu_torch.models import llama

    prompts = PROMPTS[:4]
    args, n_layers = model.args, model.args.n_layers
    total = {name: 0 for name in KERNEL_NAMES}
    toks = torch.randint(0, 256, (4, 129), device="cuda")
    for kv_dtype in (None, "int8"):
        int8 = kv_dtype == "int8"
        model.kv_dtype = kv_dtype
        model._reset_generator()
        model.generate(prompts, max_gen_len=64)
        unrolled_tokens = model.generator.last_tokens
        gen = Generator(llama, args, model.params, model.tokenizer, kv_dtype=kv_dtype,
                        unroll_decode=False)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        outs = gen.generate(prompts, max_gen_len=64)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, steps = kernels.launch_counts(), gen.last_decode_steps
        want = _zero_counts(
            w4_matmul=7 * n_layers * (1 + steps), flash_attention=n_layers,
            **{"decode_attention8_ro" if int8 else "decode_attention_ro": n_layers * steps})
        if int8:
            want["kv_write_stacked_q8"] = 1 + steps
        else:
            want.update(kv_write_stacked=1, kv_write_stacked_col=steps)
        plens = [len(p) + 1 for p in prompts]
        same = [unrolled_tokens[i, n:n + 64] == gen.last_tokens[i, n:n + 64]
                for i, n in enumerate(plens)]
        # logits: a 128-token prefill and one decode step through both paths
        logits = {}
        for name, params, stacked in (("unrolled", model.generator.params, False),
                                      ("stacked", gen.params, True)):
            cache = llama.init_kv_cache(args, 4, 192, kv_dtype=kv_dtype, stacked=stacked)
            pre, _ = llama.forward(params, args, toks[:, :128], cache=cache, cur_pos=0)
            dec, _ = llama.forward(params, args, toks[:, 128:], cache=cache, cur_pos=128)
            logits[name] = torch.cat([pre, dec], dim=1).float()
        ref = logits["unrolled"]
        tol_abs = LOGIT_TOL_FRAC * float(ref.abs().max())
        err = float((logits["stacked"] - ref).abs().max())
        step_err = float((logits["stacked"][:, -1] - ref[:, -1]).abs().max())
        rel = float((logits["stacked"] - ref).norm() / ref.norm())
        row = {"phase": "stacked", "kv_dtype": kv_dtype or "bf16", "layers": n_layers,
               "batch": len(prompts), "decode_steps": steps, "generate_s": secs,
               "launches": counts, "launches_expected": want,
               "greedy_share_equal_to_unrolled": float(np.mean(np.concatenate(same))),
               "max_abs_logit_err_vs_unrolled": err, "first_decode_step_err": step_err,
               "rel_l2_vs_unrolled": rel, "tol_abs": tol_abs, "tol_rel_l2": LOGIT_REL_L2,
               "outputs_chars": [len(o) for o in outs]}
        emit(row)
        if (counts != want or steps < 1 or err > tol_abs or rel > LOGIT_REL_L2
                or not torch.isfinite(logits["stacked"]).all()):
            raise AssertionError(f"stacked failed: {row}")
        for name in total:
            total[name] += counts[name]
        _add_counts(total, phase_decode("stacked", model, kv_dtype, steps=50, stacked=True))
    return total


def phase_paged_parity(seed: int):
    """The paged path, CPU through the plain versions against the card
    through the kernels, TinyLlama width, 2 layers, bf16 and int8 pools: 4
    slots with prompts of 37 / 64 / 100 / 128 tokens in one 128-token fresh
    prefill (lengths then set to the prompts', as the batcher does), 16
    one-token decode steps teacher-forced on the CPU's greedy tokens, a
    5-token continuation chunk (the paged decode kernel's multi-query form)
    and a 64-token one (gather + cached_attention). Logits at the valid
    positions are held to the parity tolerance; on the card a shuffled page
    table gives logits bit-identical to the identity table's."""
    import dataclasses

    import torch

    from accessory_tpu_torch.config import LLaMAArgs
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.quant.fuse import fuse_for_decode
    from accessory_tpu_torch.quant.quantize import quantize_params

    args = LLaMAArgs(**dict(TINYLLAMA, n_layers=2), max_seq_len=256)
    params_gpu = fuse_for_decode(quantize_params(llama.init_params(args, seed=seed)))
    params_cpu = _tree_to(params_gpu, "cpu")
    plens, steps, ps, pps = [37, 64, 100, 128], 16, 64, 4
    b = len(plens)
    g = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, args.vocab_size, (b, 128), generator=g)
    chunks = [torch.randint(0, args.vocab_size, (b, n), generator=g) for n in (5, 64)]
    final = [n + steps + 5 + 64 for n in plens]
    # identity allocation (slot i holds pages 1 + i * pps ...) and a shuffled
    # one, each slot holding only the pages its final length needs
    identity = torch.arange(1, b * pps + 1, dtype=torch.int32).reshape(b, pps)
    shuffled = (torch.randperm(b * pps, generator=g) + 1).to(torch.int32).reshape(b, pps)
    for t in (identity, shuffled):
        for i, n in enumerate(final):
            t[i, -(-n // ps):] = 0

    def run(params, device, table, kv_dtype, feed=None):
        """Logits of every forward (valid positions only, f32 on the CPU) and
        the greedy tokens fed to the decode steps."""
        pc = llama.init_paged_cache(args, slots=b, total_pages=b * pps + 1, page_size=ps,
                                    pages_per_seq=pps, kv_dtype=kv_dtype, device=device)
        pc = dataclasses.replace(pc, page_indices=table.to(device))
        t0 = time.perf_counter()
        lg, pc = llama.forward_paged(params, args, prompt.to(device), pc)
        out = [torch.cat([lg[i, :n].float().cpu() for i, n in enumerate(plens)])]
        pc = dataclasses.replace(pc, lengths=torch.tensor(plens, dtype=torch.int32,
                                                          device=device))
        tok = torch.stack([lg[i, n - 1] for i, n in enumerate(plens)]).argmax(-1).cpu()
        fed = []
        for i in range(steps):
            tok = tok if feed is None else feed[i]
            fed.append(tok)
            lg, pc = llama.forward_paged(params, args, tok[:, None].to(device), pc,
                                         active_pages=pps)
            out.append(lg[:, 0].float().cpu())
            tok = lg[:, 0].argmax(-1).cpu()
        for ch in chunks:
            lg, pc = llama.forward_paged(params, args, ch.to(device), pc, active_pages=pps,
                                         continuation=True)
            out.append(lg.float().cpu().reshape(-1, lg.shape[-1]))
        if device != "cpu":
            torch.cuda.synchronize()
        if pc.lengths.cpu().tolist() != final:
            raise AssertionError(f"paged_parity: lengths {pc.lengths.tolist()} != {final}")
        return out, fed, time.perf_counter() - t0

    for kv_dtype in (None, "int8"):
        cpu, fed, cpu_s = run(params_cpu, "cpu", identity, kv_dtype)
        gpu, _, _ = run(params_gpu, "cuda", identity, kv_dtype, feed=fed)
        gpu_shuffled, _, _ = run(params_gpu, "cuda", shuffled, kv_dtype, feed=fed)
        tol_abs = LOGIT_TOL_FRAC * float(cpu[0].abs().max())
        worst_abs = max(float((gg - c).abs().max()) for gg, c in zip(gpu, cpu))
        worst_rel = max(float((gg - c).norm() / c.norm()) for gg, c in zip(gpu, cpu))
        checked = agreed = 0
        for gg, c in zip(gpu, cpu):
            top2 = c.topk(2, dim=-1).values
            sure = (top2[..., 0] - top2[..., 1]) > tol_abs
            checked += int(sure.sum())
            agreed += int((gg.argmax(-1) == c.argmax(-1))[sure].sum())
        after_prefill = max(float((gg - c).abs().max()) for gg, c in zip(gpu[1:], cpu[1:]))
        bit_identical = all(torch.equal(a, c) for a, c in zip(gpu, gpu_shuffled))
        row = {"phase": "paged_parity", "kv_dtype": kv_dtype or "bf16", "layers": 2,
               "dim": args.dim, "slots": b, "prompts": plens, "prefill_rows": b * 128,
               "decode_steps": steps, "chunks": [5, 64], "cpu_seconds": round(cpu_s, 2),
               "max_abs_logit_err": worst_abs, "max_abs_logit_err_after_prefill": after_prefill,
               "max_rel_l2_err": worst_rel,
               "tol_abs": tol_abs, "tol_rel_l2": LOGIT_REL_L2, "tokens_checked": checked,
               "tokens_agreed": agreed, "shuffled_table_bit_identical": bit_identical,
               "finite": all(bool(torch.isfinite(gg).all()) for gg in gpu)}
        emit(row)
        if (worst_abs > tol_abs or worst_rel > LOGIT_REL_L2 or agreed != checked
                or not bit_identical or not row["finite"]):
            raise AssertionError(f"paged_parity failed: {row}")


class _CountingModule:
    """The model module as the batcher sees it, recording the shape of every
    forward_paged call, from which the launches of each kernel follow."""

    def __init__(self, module):
        self._module = module
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._module, name)

    def forward_paged(self, params, args, tokens, pcache, active_pages=None, continuation=False):
        self.calls.append((tokens.shape[0], tokens.shape[1], continuation))
        return self._module.forward_paged(params, args, tokens, pcache,
                                          active_pages=active_pages, continuation=continuation)

    def expected(self, n_layers, int8):
        """Per call: 4 W4 launches a layer (the many-row kernel from 1024
        rows), causal flash for a fresh prefill, the paged decode kernel for
        a decode step or a continuation of up to 16 tokens (a longer one
        gathers), and one paged write."""
        want = _zero_counts()
        for b, sq, continuation in self.calls:
            want["w4_matmul_bigm" if b * sq >= 1024 else "w4_matmul"] += 4 * n_layers
            if sq > 1 and not continuation:
                want["flash_attention"] += n_layers
            elif sq <= 16:
                want["paged_decode8" if int8 else "paged_decode"] += n_layers
            want["paged_write_q8" if int8 else "paged_write"] += 1
        return want


def phase_paged_ro(seed: int, steps: int = 32):
    """kvcache.paged_attention_decode as a caller drives it (the reference
    has no caller of its own): one layer's bf16 pools at the TinyLlama shape
    (8 slots, 4 KV heads, head_dim 64, 64-token pages, 16 a slot, a shuffled
    table), ``steps`` one-token steps from ragged lengths, each writing every
    slot's new k/v (kvcache.write_tokens, the paged write) and then attending
    read-only with the lengths counting it. Launch counts exact; the last
    step's output finite and within the kernel rows' tolerance of the
    oracle (its plain version)."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.engine import kvcache

    b, nkv, r, hd, ps, pps = 8, 4, 8, 64, 64, 16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    start = [0, 1, 63, 64, 200, 511, 700, 1024 - steps]
    pools = kvcache.init_paged_cache(1, nkv, hd, b * pps + 1, ps, b, pps)
    kp, vp = pools.k_pages[0], pools.v_pages[0]
    kp.copy_(torch.randn(kp.shape, generator=gen, device="cuda"))
    vp.copy_(torch.randn(vp.shape, generator=gen, device="cuda"))
    table = _paged_table(b, pps, b * pps + 1, [pps * ps] * b, ps, seed=seed, share=False)
    lengths = torch.tensor(start, dtype=torch.int32, device="cuda")
    qs = torch.randn((steps, b, nkv * r, hd), generator=gen, device="cuda").to(torch.bfloat16)
    kvs = torch.randn((steps, 2, b, 1, nkv, hd), generator=gen,
                      device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        kvcache.write_tokens(kp, vp, kvs[i, 0], kvs[i, 1], table, lengths)
        lengths = lengths + 1
        out = kvcache.paged_attention_decode(qs[i], kp, vp, lengths, table)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = _zero_counts(paged_write=steps, paged_decode_ro=steps)
    ref = kvcache.paged_attention_xla(qs[-1], kp, vp, lengths, table)
    row = {"phase": "paged_ro", "entry": "engine.kvcache.paged_attention_decode",
           "slots": b, "kv_heads": nkv, "group": r, "head_dim": hd, "page_size": ps,
           "lengths_first": start, "steps": steps, "ms_per_step": secs * 1e3 / steps,
           "launches": counts, "launches_expected": want,
           "max_abs_err_vs_oracle": max_err(out, ref)[0]}
    emit(row)
    check_close("paged_ro last step vs the oracle", out, ref, rtol=1e-2,
                atol=4 * bf16_ulp(float(ref.float().abs().max())))
    if counts != want:
        raise AssertionError(f"paged_ro: launch counts {counts} != expected {want}")
    return counts


def _p5_prompts(n: int):
    """n prompts of 127 bytes: 128 tokens with BOS, the serving bench's length."""
    text = " ".join(PROMPTS)
    return [(text[i * 41:] + " " + text)[:127] for i in range(n)]


def _batcher(model, module, kv_dtype, slots=8, **kw):
    from accessory_tpu_torch.engine.scheduler import ContinuousBatcher

    return ContinuousBatcher(module, model.args, model.params, model.tokenizer, slots=slots,
                             page_size=64, decode_steps=8, kv_dtype=kv_dtype, seed=0, **kw)


def _balanced(cb):
    return (cb.pool.free_pages + len(cb._prefix_map) == cb.total_pages - 1
            and all(not v for v in cb.slot_pages.values()))


def _drive(cb, prompts, max_gen_len):
    """Submit every prompt, step until drained. Returns (requests in
    submission order, seconds, time to first token of each, decode dispatch
    seconds and steps). The first token of a request shows when the step()
    whose admission sampled it returns."""
    import torch

    dispatch = []
    real = cb._decode

    def timed(*a, **kw):
        t = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        dispatch.append((time.perf_counter() - t, a[2]))
        return out

    cb._decode = timed
    t0 = time.perf_counter()
    uids = [cb.add_request(p, max_gen_len=max_gen_len) for p in prompts]
    first = {}
    while cb.pending or any(r is not None for r in cb.active.values()):
        cb.step()
        now = time.perf_counter() - t0
        for req in list(cb.active.values()) + cb.finished:
            if req is not None and req.uid not in first and req.output_tokens:
                first[req.uid] = now
    secs = time.perf_counter() - t0
    del cb._decode
    by_uid = {r.uid: r for r in cb.finished}
    return [by_uid[u] for u in uids], secs, [first[u] for u in uids], dispatch


def _profile_dispatch(cb, prompts):
    """Device time of one decode dispatch with every slot busy (torch.profiler
    CUDA trace) against the same dispatch's wall time unprofiled: device busy
    ms per step and the idle share; and from the same trace the device
    kernels a step and the host operations with the most self CPU time (the
    profiler slows the host, so those are shares, not times to quote)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        cb.add_request(p, max_gen_len=64)
    cb.step()                                  # admission + the first dispatch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cb.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cb.step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0) for e in dev) / 1e3
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    host_total = sum(e.self_cpu_time_total for e in host) or 1
    while cb.pending or any(r is not None for r in cb.active.values()):
        cb.step()
    n = cb.decode_steps
    out = {"wall_ms_per_step": wall / n,
           "device_kernels_per_step": sum(e.count for e in dev) / n,
           "host_ops_per_step": sum(e.count for e in host) / n,
           "host_self_cpu_share_top": {e.key[:60]: round(e.self_cpu_time_total / host_total, 4)
                                       for e in host[:8]}}
    if busy == 0:
        return {**out, "device_busy_ms_per_step": "not measured (no device events)"}
    attn = sum(getattr(e, "self_device_time_total", 0) for e in dev
               if "paged_decode" in e.key) / 1e3
    return {**out, "device_busy_ms_per_step": busy / n,
            "device_idle_share": max(0.0, 1 - busy / wall),
            "paged_decode_ms_per_step": attn / n, "paged_decode_share_of_busy": attn / busy}


def phase_batcher(phase: str, model, kv_dtype):
    """P5: the 22-layer TinyLlama shape through ContinuousBatcher (8 slots,
    64-token pages, decode_steps=8), 16 requests of 128-token prompts and 64
    new tokens. Every request finishes, the allocator balances, and each
    kernel's launches equal what the batcher's forward_paged calls imply.
    Decode tok/s, time to first token, device busy ms per step and the idle
    share are printed, and how many greedy tokens equal the static
    Generator's on the same prompts (random weights tie: not asserted)."""
    import numpy as np
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.models import llama

    int8 = kv_dtype == "int8"
    prompts = _p5_prompts(16)
    module = _CountingModule(llama)
    _drive(_batcher(model, module, kv_dtype), prompts[:8], 8)          # warm-up
    module.calls.clear()
    cb = _batcher(model, module, kv_dtype)
    kernels.reset_launch_counts()
    reqs, secs, ttft, dispatch = _drive(cb, prompts, 64)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = module.expected(model.args.n_layers, int8)
    n_tok = sum(len(r.output_tokens) for r in reqs)
    dec_s = sum(t for t, _ in dispatch)
    dec_steps = sum(n for _, n in dispatch)
    prof = _profile_dispatch(_batcher(model, llama, kv_dtype), prompts[:8])
    # the static Generator on the same prompts, 8 at a time
    model.kv_dtype = kv_dtype
    model._reset_generator()
    same = []
    for lo in (0, 8):
        model.generate(prompts[lo:lo + 8], max_gen_len=64)
        for i, req in enumerate(reqs[lo:lo + 8]):
            ref = model.generator.last_tokens[i, 128:128 + 64]
            got = np.asarray(req.output_tokens[:len(ref)])
            same.append(got == ref[:len(got)])
    row = {"phase": phase, "model": "TinyLlama-1.1B shape", "kv_dtype": kv_dtype or "bf16",
           "layers": model.args.n_layers, "slots": 8, "page_size": 64, "decode_steps": 8,
           "requests": len(prompts), "prompt_tokens": 128, "max_gen_len": 64,
           "generated_tokens": n_tok, "run_s": secs, "tok_s": n_tok / secs,
           "decode_tok_s": 8 * dec_steps / dec_s if dec_s else None,
           "decode_dispatches": len(dispatch), "decode_ms_per_step": dec_s * 1e3 / dec_steps,
           "ttft_s_median": statistics.median(ttft), "ttft_s_first_wave_median":
           statistics.median(ttft[:8]), "ttft_s_max": max(ttft),
           "forward_calls": len(module.calls), "launches": counts, "launches_expected": want,
           "balanced": _balanced(cb), "preemptions": cb.preemptions, **prof,
           "greedy_share_equal_to_static_generator": float(np.mean(np.concatenate(same)))}
    emit(row)
    if (counts != want or not row["balanced"] or len(reqs) != 16
            or not all(r.done and len(r.output_tokens) for r in reqs)):
        raise AssertionError(f"{phase} failed: {row}")
    return counts


def phase_preempt(model):
    """P5 over an oversubscribed pool (total_pages=17, 16 usable pages for 8
    slots of 3 pages' need): preemption of the youngest with recompute must
    happen. Then short passes through the batcher's options: prefill_chunk=64
    (64-token continuation chunks), prefix_cache (a shared 64-token prefix
    served from a shared page) and spec_lookup=4 (verify dispatches of 5
    tokens a slot: the paged decode kernel at SQ 5). Launch counts exact,
    allocator balanced, every request finished."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.models import llama

    prompts = _p5_prompts(16)
    shared = prompts[0][:63]                    # BOS + 63 bytes: one full page
    total = {name: 0 for name in KERNEL_NAMES}
    with_prefix = [shared + p[63:] for p in prompts[1:5]]
    # each pass: the batcher's options and its groups of prompts, each group
    # drained before the next is submitted (the prefix cache serves later
    # admissions from what earlier ones registered)
    passes = (("preempt", dict(total_pages=17), [prompts], 64),
              ("prefill_chunk", dict(prefill_chunk=64), [prompts[:4]], 16),
              ("prefix_cache", dict(prefix_cache=True), [with_prefix[:1], with_prefix[1:]], 16),
              ("spec_lookup", dict(spec_lookup=4), [prompts[:4]], 24))
    for name, kw, groups, max_gen in passes:
        module = _CountingModule(llama)
        cb = _batcher(model, module, None, **kw)
        kernels.reset_launch_counts()
        reqs, secs = [], 0.0
        for group in groups:
            r, t, _, _ = _drive(cb, group, max_gen)
            reqs, secs = reqs + r, secs + t
        torch.cuda.synchronize()
        ps = [p for group in groups for p in group]
        counts = kernels.launch_counts()
        want = module.expected(model.args.n_layers, False)
        sq5 = sum(model.args.n_layers for _, sq, c in module.calls if c and sq == 5)
        row = {"phase": "preempt", "pass": name, "options": kw, "requests": len(ps),
               "max_gen_len": max_gen, "seconds": secs, "preemptions": cb.preemptions,
               "prefix_hits": cb.prefix_hits, "spec_steps": cb.spec_steps,
               "spec_accepted": cb.spec_accepted, "paged_decode_sq5_launches": sq5,
               "forward_calls": len(module.calls), "launches": counts,
               "launches_expected": want, "balanced": _balanced(cb)}
        emit(row)
        ok = (counts == want and row["balanced"] and len(reqs) == len(ps)
              and all(r.done and len(r.output_tokens) for r in reqs))
        ok = ok and {"preempt": cb.preemptions > 0, "prefill_chunk": True,
                     "prefix_cache": cb.prefix_hits > 0,
                     "spec_lookup": cb.spec_steps > 0 and sq5 > 0}[name]
        if not ok:
            raise AssertionError(f"preempt ({name}) failed: {row}")
        _add_counts(total, counts)
    return total


def phase_server(model):
    """P6: serve(model, port=0, continuous=True, slots=8, decode_steps=8) on
    127.0.0.1: 8 concurrent /generate posts, then /health, /chat and
    /stream_generate; every answer 200 and well formed; shutdown stops the
    batching thread. The batcher's paged launches equal what its
    forward_paged calls imply (the other kernels are shared with the
    /chat and /stream_generate routes' static path)."""
    import threading
    import urllib.request

    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.demos.server import serve
    from accessory_tpu_torch.models import llama

    module = _CountingModule(llama)
    real_module = model.module
    model.module = module
    model.kv_dtype = None
    model._reset_generator()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    server = serve(model, host="127.0.0.1", port=0, continuous=True, slots=8, decode_steps=8)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def post(path, body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read().decode()

    results = {}
    try:
        def gen(i):
            results[i] = post("/generate", {"prompts": [PROMPTS[i]], "max_gen_len": 32})

        ts = [threading.Thread(target=gen, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as r:
            health = (r.status, json.loads(r.read()))
        chat = post("/chat", {"qas": [["Name three colours.", None]], "max_gen_len": 16})
        stream = post("/stream_generate", {"prompt": PROMPTS[0], "max_gen_len": 16})
    finally:
        server.shutdown()
        server.server_close()
        model.module = real_module
        model._reset_generator()
    thread.join(timeout=60)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = module.expected(model.args.n_layers, False)
    events = [json.loads(x[len("data: "):]) for x in stream[1].split("\n\n") if x]
    gens = [results.get(i) for i in range(8)]
    ok_gen = all(g is not None and g[0] == 200 and isinstance(json.loads(g[1])["outputs"][0], str)
                 for g in gens)
    paged = ("paged_decode", "paged_write")
    row = {"phase": "server", "requests": 8, "seconds": secs, "generate_ok": ok_gen,
           "health": health, "chat_status": chat[0],
           "chat_response_chars": len(json.loads(chat[1])["response"]),
           "stream_status": stream[0], "stream_events": len(events),
           "batcher_forward_calls": len(module.calls), "launches": counts,
           "paged_launches_expected": {k: want[k] for k in paged},
           "server_thread_stopped": not thread.is_alive(),
           "batching_thread_stopped": not server.engine._thread.is_alive()}
    emit(row)
    if not (ok_gen and health == (200, {"status": "ok"}) and chat[0] == 200
            and stream[0] == 200 and events and events[-1]["end_of_content"]
            and all(counts[k] == want[k] for k in paged) and want["paged_decode"] > 0
            and row["server_thread_stopped"] and row["batching_thread_stopped"]
            and server.engine.error is None):
        raise AssertionError(f"server failed: {row}")
    return counts


def phase_serve7b(seed: int, bits: int = 4, phase: str = "serve7b"):
    """The 32-layer LLaMA2-7B shape (MHA) through MetaModel.generate: 8 prompts
    in the 128-token bucket (1024 prefill rows), 32 new tokens, with the bf16
    and then the int8 KV cache on the same weights, launch-counted. ``bits``
    8: W8A16, every projection on the W8 kernel (its 1024-row prefill too)."""
    import numpy as np

    prompts = PROMPTS
    assert len(prompts) == 8 and all(100 <= len(p) <= 126 for p in prompts), \
        [len(p) for p in prompts]
    model, setup_s, setup_peak = _quantized_model(LLAMA2_7B, 512, seed, bits)
    n_layers = model.args.n_layers
    plens = [len(p) + 1 for p in prompts]
    total = {name: 0 for name in KERNEL_NAMES}
    tokens = {}
    for kv_dtype in (None, "int8"):
        model.kv_dtype = kv_dtype
        model._reset_generator()
        int8 = kv_dtype == "int8"
        prefill_ms = _timed_prefill(model, 8, 128, 192, kv_dtype)
        outs, counts, steps, total_s = _counted_generate(model, prompts, 32)
        matmuls = ({"w4_matmul": 4 * n_layers * steps, "w4_matmul_bigm": 4 * n_layers}
                   if bits == 4 else {"w8_matmul": 4 * n_layers * (steps + 1)})
        want = _zero_counts(
            flash_attention=n_layers, **matmuls,
            **{"decode_attention_mha8" if int8 else "decode_attention_mha": n_layers * steps,
               "kv_write_q8" if int8 else "kv_write": n_layers})
        tokens[kv_dtype] = model.generator.last_tokens
        row = {"phase": phase, "model": "LLaMA2-7B shape", "kv_dtype": kv_dtype or "bf16",
               "weight_bits": bits,
               "layers": n_layers, "batch": len(prompts), "prompt_tokens": plens,
               "prefill_rows": 8 * 128, "decode_steps": steps, "launches": counts,
               "launches_expected": want, "setup_s": setup_s,
               "setup_peak_bytes": setup_peak, "prefill_ms": prefill_ms, "generate_s": total_s,
               "decode_tok_s": len(prompts) * steps / max(total_s - prefill_ms / 1e3, 1e-9),
               "outputs_chars": [len(o) for o in outs]}
        emit(row)
        if counts != want or steps < 32 or len(outs) != len(prompts):
            raise AssertionError(f"{phase} {kv_dtype}: launch counts {counts} != expected {want}")
        for name in total:
            total[name] += counts[name]
    # greedy tokens of the two runs over the generated positions (printed, not
    # asserted: random weights give flat logits)
    a, b = tokens[None], tokens["int8"]
    same = [a[i, n:n + 32] == b[i, n:n + 32] for i, n in enumerate(plens)]
    emit({"phase": phase, "compare": "greedy tokens, bf16 KV vs int8 KV",
          "generated_tokens": int(sum(s.size for s in same)),
          "share_equal": float(np.mean(np.concatenate(same)))})
    return model, total


def _gptq_params(args, seed: int):
    """Per-layer llama params on the card whose projections are std-layout
    W4 weights as a GPTQ import gives them (``_gptq_like_weight``), drawn from
    ``seed``: the same weights for every call."""
    import torch

    from accessory_tpu_torch.models import llama

    params = llama.init_params(args, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    for layer in params["layers"]:
        for part in ("attention", "feed_forward"):
            for mod in layer[part].values():
                k, n = mod["weight"].shape
                mod["weight"] = _gptq_like_weight(gen, k, n)
    return params


def _map_weights(params, fn):
    """Every projection of per-layer params through ``fn`` (in place)."""
    for layer in params["layers"]:
        for part in ("attention", "feed_forward"):
            for mod in layer[part].values():
                mod["weight"] = fn(mod["weight"])
    return params


def phase_parity_gptq(seed: int):
    """GPTQ-style std W4 (row 24) at TinyLlama width, 2 layers, CPU against
    the card, and its magic repack (row 25) the same way; then on the card
    the prefill logits of the std model against the same weights folded (row
    1: the same weights, held to the parity tolerances) and in the magic
    layout. The magic layout rounds s / 16 to bf16 (the reference's design),
    a relative change of up to 2^-9 in every group's scale: another model,
    held to the relative-L2 tolerance only, its largest deviation printed."""
    import torch

    from accessory_tpu_torch.config import LLaMAArgs
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.quant.fuse import fuse_for_decode
    from accessory_tpu_torch.quant.qtensor import to_folded_layout, to_magic_layout

    kw = dict(b=2, plen=64, s_len=128)
    std = phase_parity(seed, "parity_gptq", TINYLLAMA, 2, steps=8,
                       make_params=lambda a: _gptq_params(a, seed), label="GPTQ W4 std", **kw)
    magic = phase_parity(seed, "parity_gptq", TINYLLAMA, 2, steps=4,
                         make_params=lambda a: _map_weights(_gptq_params(a, seed),
                                                            to_magic_layout),
                         label="GPTQ W4 magic", **kw)
    args = LLaMAArgs(**dict(TINYLLAMA, n_layers=2), max_seq_len=kw["s_len"])
    folded_params = fuse_for_decode(_map_weights(_gptq_params(args, seed), to_folded_layout))
    prompt = torch.randint(0, args.vocab_size, (kw["b"], kw["plen"]),
                           generator=torch.Generator().manual_seed(seed))
    folded, _ = llama.forward(folded_params, args, prompt.cuda(),
                              cache=llama.init_kv_cache(args, kw["b"], kw["s_len"]), cur_pos=0)
    ref = std.float()
    tol = LOGIT_TOL_FRAC * float(ref.abs().max())
    for label, other, same_weights in (("folded (w4_matmul)", folded, True),
                                       ("magic (w4_matmul_magic)", magic, False)):
        d = other.float() - ref
        row = {"phase": "parity_gptq", "compare": f"std (w4_matmul_std) vs {label}, card",
               "max_abs_logit_err": float(d.abs().max()),
               "tol_abs": tol if same_weights else None,
               "rel_l2": float(d.norm() / ref.norm()), "tol_rel_l2": LOGIT_REL_L2}
        emit(row)
        if (same_weights and row["max_abs_logit_err"] > tol) or row["rel_l2"] > LOGIT_REL_L2:
            raise AssertionError(f"parity_gptq: {row}")


def _write_gptq_dir(path: str, cfg: dict, seed: int) -> int:
    """An AutoGPTQ-format safetensors file for the llama shape ``cfg``: per
    layer and projection ``model.layers.{i}.{module}.qweight`` (K/8, N) int32,
    ``.qzeros`` (K/128, N/8) int32 (stored zero points, GPTQ's z + 1 = 1..16)
    and ``.scales`` (K/128, N) f16, random from ``seed``, written with the
    port's own numpy writer. Returns the file's bytes."""
    import os

    import torch

    from accessory_tpu_torch.checkpoint.native import write_safetensors
    from accessory_tpu_torch.config import LLaMAArgs

    args = LLaMAArgs(**cfg)
    dim, hd = args.dim, args.dim // args.n_heads
    hidden = args.ffn_hidden_dim
    shapes = {"self_attn.q_proj": (dim, args.n_heads * hd),
              "self_attn.k_proj": (dim, args.kv_heads * hd),
              "self_attn.v_proj": (dim, args.kv_heads * hd),
              "self_attn.o_proj": (args.n_heads * hd, dim),
              "mlp.gate_proj": (dim, hidden), "mlp.up_proj": (dim, hidden),
              "mlp.down_proj": (hidden, dim)}
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def words(rows, cols):
        return torch.randint(-2 ** 31, 2 ** 31, (rows, cols), generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32).cpu().numpy()

    tensors = {}
    for i in range(args.n_layers):
        for mod, (k, n) in shapes.items():
            base = f"model.layers.{i}.{mod}"
            tensors[base + ".qweight"] = words(k // 8, n)
            tensors[base + ".qzeros"] = words(k // 128, n // 8)
            tensors[base + ".scales"] = (torch.rand((k // 128, n), generator=gen, device="cuda")
                                         * 0.004 + 5e-4).to(torch.float16).cpu().numpy()
    f = os.path.join(path, "model.safetensors")
    write_safetensors(f, tensors)
    return os.path.getsize(f)


def _gptq_model(seed: int):
    """The TinyLlama shape (22 layers) served from a GPTQ directory written
    from ``seed``: MetaModel's random dense weights, then load_gptq_dir +
    install_gptq_weights (rotary un-permuted) for every projection. Returns
    (model, setup seconds, setup row)."""
    import torch

    from accessory_tpu_torch.meta import MetaModel
    from accessory_tpu_torch.quant.omniquant import install_gptq_weights, load_gptq_dir

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        nbytes = _write_gptq_dir(tmp, TINYLLAMA, seed)
        t1 = time.perf_counter()
        model = MetaModel("llama", dict(TINYLLAMA), max_seq_len=512, seed=seed)
        model.tokenizer = ByteTokenizer()
        gptq = load_gptq_dir(tmp, n_heads=model.args.n_heads, n_kv_heads=model.args.kv_heads)
        install_gptq_weights(model.params, gptq)
        del gptq
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    wq = model.params["layers"][0]["attention"]["wq"]["weight"]
    row = {"phase": "serve_gptq", "setup": "GPTQ dir -> load_gptq_dir -> install_gptq_weights",
           "dir_bytes": nbytes, "write_s": t1 - t0, "load_install_s": t2 - t1,
           "layout": wq.layout, "bits": wq.bits, "zeros_max": float(wq.zeros.max())}
    emit(row)
    if wq.layout != "std" or wq.bits != 4 or row["zeros_max"] != 16.0:
        raise AssertionError(f"serve_gptq: the imported weights are not GPTQ std W4: {row}")
    model._reset_generator()
    return model, t2 - t0


def phase_decode(phase: str, model, kv_dtype, steps: int, fused_attn_write: bool = True,
                 stacked: bool = False, matmul: str = "w4_matmul", ffn_fuse: bool = False):
    """The bench shape: batch 8, cache 1024, ``steps`` forward steps from pos
    512; with ``fused_attn_write=False`` through read-only attention and the
    one-token write; with ``stacked`` over the unfused params and a stacked
    cache; ``matmul``: the quantized-matmul entry of the weights; with
    ``ffn_fuse`` each layer's FFN in one fused kernel call. Returns the
    launch counts of the timed steps."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.quant.qtensor import QuantizedWeight

    args, params = model.args, (model.params if stacked else model.generator.params)
    batch, cache_len, pos0 = 8, 1024, 512
    cache = llama.init_kv_cache(args, batch, cache_len, kv_dtype=kv_dtype, stacked=stacked)
    tok = torch.ones((batch, 1), dtype=torch.int64, device="cuda")
    int8 = "ks" in cache
    mha = args.kv_heads == args.n_heads

    def weight_bytes(node):
        if isinstance(node, QuantizedWeight):
            return sum(t.numel() * t.element_size() for t in (node.packed, node.scales, node.zeros))
        if isinstance(node, dict):
            return sum(weight_bytes(v) for k, v in node.items() if k != "tok_embeddings")
        if isinstance(node, list):
            return sum(weight_bytes(v) for v in node)
        return node.numel() * node.element_size()

    w_bytes = weight_bytes(params)
    mid = pos0 + steps // 2
    token_bytes = sum(c[0].numel() * c[0].element_size() for c in cache.values()) \
        // (batch * args.kv_heads * cache_len)   # k + v (+ scales) of one cached token of a head
    fused_attn_write = fused_attn_write and not stacked   # a stacked cache is only read in a layer
    kv_bytes = args.n_layers * batch * args.kv_heads * mid * token_bytes
    b_ms, _ = bound_ms(w_bytes + kv_bytes, 0.0)
    kw = dict(fused_attn_write=fused_attn_write, ffn_fuse=ffn_fuse)
    for i in range(5):
        llama.forward(params, args, tok, cache=cache, cur_pos=pos0 + i, **kw)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, _ = llama.forward(params, args, tok, cache=cache, cur_pos=pos0 + i, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = kernels.launch_counts()
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{phase}: non-finite logits")
    attn = ("decode_attention_mha" if mha else "decode_attention") + ("8" if int8 else "") \
        + ("" if fused_attn_write else "_ro")
    want = _zero_counts(**{matmul: (7 if stacked else 2 if ffn_fuse else 4) * args.n_layers
                           * steps, attn: args.n_layers * steps})
    if ffn_fuse:
        want["ffn_fused"] = args.n_layers * steps
    if stacked:
        want["kv_write_stacked_q8" if int8 else "kv_write_stacked_col"] = steps
    elif not fused_attn_write:
        want["kv_write_col_q8" if int8 else "kv_write_col"] = args.n_layers * steps
    row = {"phase": phase, "kv_dtype": kv_dtype or "bf16", "layers": args.n_layers,
           "path": "stacked" if stacked else "unrolled", "fused_attn_write": fused_attn_write,
           "ffn_fuse": ffn_fuse,
           "batch": batch, "cache_len": cache_len, "steps": steps,
           "ms_per_step": ms, "tok_s": batch / ms * 1e3, "bound_ms_per_step": b_ms,
           "bound_tok_s": batch / b_ms * 1e3, "weight_bytes": w_bytes,
           "kv_bytes_mid": kv_bytes, "launches": counts, "launches_expected": want}
    if counts != want:
        emit(row)
        raise AssertionError(f"{phase}: launch counts {counts} != expected {want}")
    row["profile"] = _profile_steps(params, args, tok, cache, pos0, ms, **kw)
    top = row["profile"].get("top_kernels_ms_per_step", {})
    row["ffn_kernels_ms_per_step"] = {    # the FFN's kernels' device time: fused, or GEMVs
        sym: sum(v for k, v in top.items() if sym in k) for sym in ("ffn_fused", "W4Folded")}
    # decode attention's device time and share (the GQA and MHA kernels' names)
    busy = row["profile"].get("device_busy_ms_per_step")
    row["attention_ms_per_step"] = sum(v for k, v in top.items() if "decode_attn" in k)
    row["attention_share_of_busy"] = row["attention_ms_per_step"] / busy if busy else None
    if matmul != "w4_matmul":   # the new weight formats' kernel share of the device time
        prof = row["profile"]
        busy = prof.get("device_busy_ms_per_step")
        mm = sum(v for k, v in prof.get("top_kernels_ms_per_step", {}).items()
                 if any(sym in k for sym in _MATMUL_SYMBOLS[matmul]))
        row["matmul_ms_per_step"] = mm
        row["matmul_share_of_busy"] = mm / busy if busy else None
    emit(row)
    return counts


def _profile_steps(params, args, tok, cache, pos0, ms_per_step: float, steps: int = 10,
                   module=None, shares=(), **kw):
    """Device time by kernel over a few decode steps (torch.profiler). Only
    the trace's device events are summed: an aten op's row repeats the time
    of the kernels it launched. The idle share is taken against the
    unprofiled ``ms_per_step``, since tracing slows the host loop.
    ``module``: the model module (LLaMA by default); ``shares``: kernel-name
    substrings whose device ms a step (over every kernel of the trace) and
    share of busy are added."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from accessory_tpu_torch.models import llama

    module = module or llama
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for i in range(steps):
            module.forward(params, args, tok, cache=cache, cur_pos=pos0 + i, **kw)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in p.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0)
        if e.device_type == DeviceType.CUDA and dev_us:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + dev_us / 1e3 / steps
    busy = sum(by_kernel.values())
    if busy == 0:
        return {"device_time": "not measured (no device events in the trace)"}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    out = {"wall_ms_per_step_profiled": wall / steps, "device_busy_ms_per_step": busy,
           "device_idle_share": max(0.0, 1 - busy / ms_per_step),
           "top_kernels_ms_per_step": {k[:80]: v for k, v in top}}
    for sub in shares:
        ms = sum(v for k, v in by_kernel.items() if sub in k)
        out[f"{sub}_ms_per_step"], out[f"{sub}_share_of_busy"] = ms, ms / busy
    return out


# ---------------------------------------------------------------- training


QPEFT = dict(lora_rank=16, bias_tuning=True, norm_tuning=True)
LLAMA_700M = dict(dim=2048, n_layers=12, n_heads=16, n_kv_heads=8, vocab_size=32000,
                  multiple_of=256, dtype="bfloat16")
# the device's kernels by what they do in a training step (name substrings)
TRAIN_SPLIT = (("forward W4 (many-row)", ("w4_bigm_wgmma_kernel",)),
               ("forward W4 (tile / GEMV)", ("FoldedB", "W4Folded")),
               ("W4 dequant", ("w4_dequant_kernel",)),
               ("attention forward", ("flash_fwd_wgmma_kernel",)),
               ("attention backward", ("flash_bwd_dq_wgmma_kernel",
                                       "flash_bwd_dkdv_wgmma_kernel")),
               ("dense products (dx, LoRA, head, full-finetune dW)",
                ("gemm", "nvjet", "xmma", "cutlass", "sm90", "Kernel2")))


def _train_model(cfg: dict, seed: int, qpeft: bool, device="cuda", seq_len: int = 512):
    """Random weights from ``seed`` (QPEFT: the W4 base quantized layer by
    layer), trainable leaves promoted to f32 masters. Returns (args, params,
    trainable)."""
    from accessory_tpu_torch.meta import MetaModel
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.train.precision import promote_trainable_params_to_fp32

    model = MetaModel("llama", dict(cfg), max_seq_len=seq_len, seed=seed, device=device)
    if qpeft:
        model.quantize()
    trainable = llama.get_trainable_params_filter(model.args)
    return model.args, promote_trainable_params_to_fp32(model.params, trainable), trainable


def _train_step(args, params, trainable, lr, remat, device="cuda"):
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step

    tx = make_optimizer(params, lr, weight_decay=0.02, clip_norm=2.0, trainable=trainable)
    return tx, TrainState.create(params, tx), make_train_step(llama, args, tx, remat=remat,
                                                              device=device)


def _token_batch(seed: int, b: int, s: int, vocab: int):
    """Random token ids as bench_all.py's train bench draws them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {"examples": rng.randint(3, vocab, (b, s)).astype(np.int32),
            "labels": rng.randint(3, vocab, (b, s)).astype(np.int32)}


def _train_counts(n_layers: int, qpeft: bool, bigm: bool, steps: int = 1):
    """Launches of ``steps`` training steps with every layer checkpointed:
    the forward, its recompute in the backward, and the backward."""
    w4 = "w4_matmul_bigm" if bigm else "w4_matmul"
    fwd = _zero_counts(flash_attention=n_layers, **({w4: 7 * n_layers} if qpeft else {}))
    bwd = _zero_counts(flash_attention_bwd_dq=n_layers, flash_attention_bwd_dkdv=n_layers,
                       **({"w4_dequant": 7 * n_layers} if qpeft else {}))
    total = {k: steps * (2 * fwd[k] + bwd[k]) for k in fwd}
    return {"forward": fwd, "recompute": fwd, "backward": bwd}, total


def phase_train_parity(seed: int):
    """TinyLlama width, 2 layers, W4 base, LoRA 16 + bias + norm tuning, bf16
    compute, batch 4 x 256 (1024 rows: the many-row W4 kernel), every layer
    checkpointed: one step on the CPU through the plain versions and one on
    the card through the kernels, from the same weights and batch. Held: the
    loss to 1e-2 relative, every trainable leaf's gradient to 6e-2 relative
    L2 (bf16 activations round at other points on the two sides, as in
    tests/test_torch_train_step.py against JAX), and each updated leaf where
    its CPU gradient is at least a tenth of the leaf's largest (there the first
    AdamW step is lr * sign(g)) to 1e-2 of an lr."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.train.train_step import grads_of
    from accessory_tpu_torch.train.tree import named_leaves

    cfg = dict(TINYLLAMA, n_layers=2, **QPEFT)
    args, params, trainable = _train_model(cfg, seed, True, device="cpu", seq_len=256)
    gen = torch.Generator().manual_seed(seed)
    for layer in params["layers"]:          # non-zero lora_b / bias: every gradient moves
        for part in ("attention", "feed_forward"):
            for mod in layer[part].values():
                for name in ("lora_b", "bias"):
                    mod[name] = torch.randn(mod[name].shape, generator=gen) * 0.02
    card = _tree_to(params, "cuda")
    batch = _token_batch(seed, 4, 256, args.vocab_size)
    lr = 1e-3
    res = {}
    for device, p in (("cpu", params), ("cuda", card)):
        before = {k: v.detach().clone() for k, v in named_leaves(p) if trainable(k)}
        _, state, step = _train_step(args, p, trainable, lr, "full", device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["c_loss"])
        secs = time.perf_counter() - t0
        res[device] = dict(loss=loss, secs=secs, counts=kernels.launch_counts(),
                           grads={k: g.float().cpu() for k, g in grads_of(state).items()},
                           before=before, after=dict(named_leaves(state.params)))
    c, g = res["cpu"], res["cuda"]
    _, want_counts = _train_counts(2, True, True)
    leaves = {}
    worst = {"grad_rel_l2": 0.0, "update_err": 0.0}
    for path in c["before"]:
        gc, gg = c["grads"][path], g["grads"][path]
        rel = float((gg - gc).norm() / gc.norm().clamp_min(1e-30))
        uc = (c["after"][path].detach().float() - c["before"][path].float()) / lr
        ug = (g["after"][path].detach().float().cpu() - g["before"][path].float().cpu()) / lr
        sure = gc.abs() >= 0.1 * gc.abs().max()
        uerr = float((ug - uc).abs()[sure].max())
        leaves[path] = {"grad_max_abs_err": float((gg - gc).abs().max()), "grad_rel_l2": rel,
                        "update_max_err_lr": uerr}
        worst["grad_rel_l2"] = max(worst["grad_rel_l2"], rel)
        worst["update_err"] = max(worst["update_err"], uerr)
    row = {"phase": "train_parity", "model": "TinyLlama width, 2 layers, QPEFT (W4 g128, "
           "LoRA 16, bias, norm)", "batch": [4, 256], "remat": "full", "lr": lr,
           "loss_cpu": c["loss"], "loss_cuda": g["loss"], "cpu_s": c["secs"],
           "cuda_s": g["secs"], "tolerances": {"loss_rel": 1e-2, "grad_rel_l2": 6e-2,
                                              "update_err_lr": 1e-2},
           "worst": worst, "launches": g["counts"], "launches_expected": want_counts,
           "leaves": leaves}
    emit(row)
    if not (abs(g["loss"] - c["loss"]) <= 1e-2 * abs(c["loss"]) and worst["grad_rel_l2"] <= 6e-2
            and worst["update_err"] <= 1e-2):
        raise AssertionError(f"train_parity: card step disagrees with the CPU step ({worst}, "
                             f"loss {g['loss']} vs {c['loss']})")
    if g["counts"] != want_counts:
        raise AssertionError(f"train_parity: launch counts {g['counts']} != {want_counts}")
    return g["counts"]


def _split_profile(step_fn, state, batch, step_ms: float):
    """Device time of one step by kernel (torch.profiler), grouped by
    TRAIN_SPLIT; the idle share against the unprofiled step time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        state, m = step_fn(state, batch)
        float(m["c_loss"])
        torch.cuda.synchronize()
    by_kernel = {}
    for e in p.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if e.device_type == DeviceType.CUDA and us:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3
    busy = sum(by_kernel.values())
    if busy == 0:
        return state, {"device_time": "not measured (no device events in the trace)"}
    split, seen = {}, set()
    for label, subs in TRAIN_SPLIT:
        keys = [k for k in by_kernel if k not in seen and any(sub in k for sub in subs)]
        seen.update(keys)
        split[label] = sum(by_kernel[k] for k in keys)
    split["other (elementwise, norms, loss, optimizer)"] = busy - sum(split.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return state, {"device_busy_ms_per_step": busy,
                   "device_idle_share": max(0.0, 1 - busy / step_ms),
                   "split_ms": split, "top_kernels_ms": {k[:90]: v for k, v in top}}


def _matmul_params(params) -> int:
    """Matmul-visited parameter count as bench_all.py counts it (embedding
    lookup and norms excluded, the output head included; a W4 weight counts
    its padded in_dim x out_dim)."""
    from accessory_tpu_torch.quant.qtensor import QuantizedWeight
    from accessory_tpu_torch.train.tree import named_leaves

    total = 0
    for path, leaf in named_leaves(params):
        if "tok_embeddings" in path or "norm" in path:
            continue
        total += leaf.in_dim * leaf.out_dim if isinstance(leaf, QuantizedWeight) else leaf.numel()
    return total


def phase_train(phase: str, cfg: dict, seed: int, batch: int, seq_len: int, qpeft: bool,
                lr: float, steps: int = 5):
    """One model's training step at full width and depth: 1 warm-up step and
    ``steps`` timed steps on the same random token batch (so the loss must
    fall), every layer checkpointed; ms per step, tokens/s, model flops per
    second against 989 TFLOP/s (bench_all.py's count: 4N + 3 attention for
    QPEFT, 6N + 3 attention for full finetuning), peak memory, each step's
    loss, launch counts per step (exact), and one profiled step split by
    kernel."""
    import torch

    from accessory_tpu_torch import kernels

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    args, params, trainable = _train_model(cfg, seed, qpeft, seq_len=seq_len)
    tx, state, step = _train_step(args, params, trainable, lr, "full")
    data = _token_batch(seed, batch, seq_len, args.vocab_size)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses = []
    state, m = step(state, data)                      # warm-up
    losses.append(float(m["c_loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = []
    for _ in range(steps):
        t1 = time.perf_counter()
        state, m = step(state, data)
        losses.append(float(m["c_loss"]))         # a host fetch each step, as main_finetune
        times.append((time.perf_counter() - t1) * 1e3)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    by_pass, want = _train_counts(args.n_layers, qpeft, batch * seq_len >= 1024, steps)
    ms = statistics.median(times)
    tok_s = batch * seq_len / ms * 1e3
    n_mm = _matmul_params(state.params)
    attn = 2 * seq_len * args.n_heads * args.head_dim * args.n_layers
    model_tok = (4 if qpeft else 6) * n_mm + 3 * attn
    hw_tok = (6 if qpeft else 8) * n_mm + 4 * attn
    state, prof = _split_profile(step, state, data, ms)
    row = {"phase": phase, "layers": args.n_layers, "dim": args.dim,
           "heads": [args.n_heads, args.kv_heads], "batch": [batch, seq_len],
           "mode": "QPEFT (W4 g128 base, LoRA 16, bias, norm)" if qpeft
           else "full finetune (f32 masters, AdamW on every leaf)", "remat": "full", "lr": lr,
           "setup_s": setup_s, "ms_per_step": ms, "ms_per_step_all": times, "tok_s": tok_s,
           "matmul_params": n_mm, "model_flops_per_token": model_tok,
           "model_tflop_s": model_tok * tok_s / 1e12,
           "mfu_vs_989": model_tok * tok_s / BF16_FLOPS_PER_S,
           "hw_flops_per_token": hw_tok, "peak_bytes": peak, "losses": losses,
           "launches_per_step": {k: v // steps for k, v in counts.items()},
           "launches_per_step_by_pass": by_pass, "launches": counts,
           "launches_expected": want, "profile": prof}
    emit(row)
    if counts != want:
        raise AssertionError(f"{phase}: launch counts {counts} != expected {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: losses not finite and falling: {losses}")
    del state, params, step, tx
    torch.cuda.empty_cache()
    return counts


def _compare_decode(kr, tag, nq, nkv, hd, b, s_len, pos, int8, write):
    """One static decode entry through the call every version of the package
    takes (decode_attention_update[8] fused, cached_attention_t[8] read-only),
    SDPA beside it (int8 over a cache dequantized to bf16 beforehand)."""
    import torch
    import torch.nn.functional as F

    from accessory_tpu_torch.ops import decode_attention as da

    r = nq // nkv
    kernel = "decode_attention" + ("8" if int8 else "") + ("" if write else "_ro")
    if write:
        fn = da.decode_attention_update8 if int8 else da.decode_attention_update
    else:
        fn = da.cached_attention_t8 if int8 else da.cached_attention_t
    tok_bytes = hd + 4 if int8 else 2 * hd
    nbytes = 2 * b * nkv * pos * tok_bytes + b * (nq + 2 * nkv) * hd * 2 + b * nq * hd * 2 \
        + (2 * b * nkv * tok_bytes if write else 0)
    sets = [_qkv_views(kr, b, nq, nkv, hd)
            + (_int8_pools(kr, b, nkv, s_len, hd) if int8
               else (kr.randn(b, nkv, s_len, hd), kr.randn(b, nkv, s_len, hd)))
            for _ in range(n_copies(nbytes, 32 if hd == 64 else 8))]
    ms = time_ms(lambda *a: fn(*a, pos), sets)
    mask = (torch.arange(s_len, device="cuda") <= min(pos, s_len - 1))[None]
    if int8:
        lib_sets = [(s_[0].transpose(1, 2), (s_[3].float() * s_[5][..., None]).to(torch.bfloat16),
                     (s_[4].float() * s_[6][..., None]).to(torch.bfloat16)) for s_ in sets[:2]]
    else:
        lib_sets = [(s_[0].transpose(1, 2), s_[3], s_[4]) for s_ in sets]
    lib = time_ms(lambda qq, kk, vv: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, enable_gqa=True), lib_sets)
    b_ms, b_by = bound_ms(nbytes, 4.0 * b * nq * (pos + 1) * hd)
    emit({"phase": "compare", "kernel": kernel,
          "shape": f"{tag} B={b} NKV={nkv} R={r} HD={hd} S={s_len} pos={pos}",
          "ms": ms, "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by})


def _compare_paged(kr, tag, nkv, r, hd, sq, lengths, int8, ro=False, ps=64, most=32):
    """paged_decode_attention (paged_decode[8]) over 8 pages a slot, or
    paged_decode_ro over as many pages as the longest slot needs, through a
    shuffled table with a shared page and TRASH entries; SDPA beside it over
    each slot's pages gathered into a dense cache beforehand (int8
    dequantized beforehand), the length as a mask."""
    import torch
    import torch.nn.functional as F

    from accessory_tpu_torch.engine.kvcache import gather_pages
    from accessory_tpu_torch.ops.paged_decode import paged_decode_attention, paged_decode_ro

    kernel = "paged_decode_ro" if ro else "paged_decode8" if int8 else "paged_decode"
    b, nq = len(lengths), nkv * r
    pps = -(-max(lengths) // ps) if ro else 8
    n_pages = b * pps + 1
    table = _paged_table(b, pps, n_pages, lengths, ps, seed=b * pps + (r if ro else sq))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    tok_bytes = 2 * (hd + 4) if int8 else 2 * 2 * hd
    cached = sum(min(n, pps * ps) for n in lengths)
    nbytes = cached * nkv * tok_bytes + (1 if ro else 2) * b * sq * nq * hd * 2 \
        + (0 if ro else 2 * b * sq * nkv * hd * 2) + b * pps * 4 + b * 4
    flops = 4.0 * nq * hd * cached if ro else \
        sum(4.0 * nq * hd * sq * (n + (sq + 1) / 2) for n in lengths)
    pool_bytes = 2 * nkv * n_pages * ps * (hd + 4 if int8 else 2 * hd)
    sets = [(kr.randn(b, sq, nq, hd), kr.randn(b, sq, nkv, hd), kr.randn(b, sq, nkv, hd))
            + _paged_pools(kr, 1, nkv, n_pages, ps, hd, int8)
            for _ in range(n_copies(pool_bytes, most))]

    def call(q, kn, vn, *pools):
        if ro:
            return paged_decode_ro(q[:, 0], pools[0][0], pools[1][0], lens, table)
        return paged_decode_attention(q, kn, vn, pools[0], pools[1], lens, table, pps,
                                      *(pools[2:] if int8 else (None, None)), layer=0)

    ms = time_ms(call, sets)
    mask = (torch.arange(pps * ps, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    lib_sets = []
    for s_ in sets[:4]:
        kd, vd = gather_pages(s_[3][0], s_[4][0], table, None,
                              *((s_[5][0], s_[6][0]) if int8 else (None, None)))
        lib_sets.append((s_[0].transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2)))
    lib = time_ms(lambda qq, kk, vv: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, enable_gqa=r > 1), lib_sets)
    b_ms, b_by = bound_ms(nbytes, flops)
    emit({"phase": "compare", "kernel": kernel,
          "shape": f"{tag} B={b} NKV={nkv} R={r} HD={hd} SQ={sq} PS={ps} J={pps} "
                   f"lengths={','.join(map(str, lengths))}",
          "ms": ms, "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by})


def phase_compare(seed: int, names=None):
    """Rows 5, 3 and 26's forward and backward and the decode attention rows
    through calls an earlier version of the package also takes (no plan
    arguments), so the same script times a parent checkout and this one in
    turns: the many-row W4 matmul at the 7B projections' 1024 and 4096 rows
    and wo at 1000 (``torch.matmul`` on the dense weight beside it), the
    flash forward at the prefills, the training shapes and two cp shards
    (SDPA, with a boolean mask for a shard, beside it), the flash backward
    (``flash_attention_bwd``, its dq and dk / dv kernels apart) at the
    training shapes and the cp shards beside SDPA's backward, and rows 2, 8,
    13, 15 (static GQA decode) and 18, 19 and the bundled row (paged decode)
    at the kernels phase's shapes beside SDPA. Device time from the
    profiler, inputs rotated past L2. ``names``: only the groups of these
    kernels (w4_matmul_bigm, flash_attention, flash_attention_bwd_dq,
    decode_attention, paged_decode; all when None)."""
    import torch
    import torch.nn.functional as F

    from accessory_tpu_torch.ops.flash_attention import _forward, flash_attention_bwd
    from accessory_tpu_torch.ops.quant_matmul_bigm import planes_qmm_bigm
    from accessory_tpu_torch.quant.qtensor import (dequantize_weight, quantize_weight,
                                                   to_folded_layout)

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def want(kernel):
        return names is None or kernel in names

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    if want("decode_attention"):
        kr = KernelRows(seed)
        for int8 in (False, True):
            for write in (True, False):
                for pos in (1, 511, 1023):
                    _compare_decode(kr, "tiny", 32, 4, 64, 8, 1024, pos, int8, write)
                _compare_decode(kr, "hd128", 32, 8, 128, 8, 1024, 511, int8, write)
                for b in (4, 1):
                    _compare_decode(kr, "tiny", 32, 4, 64, b, 192, 150, int8, write)
    if want("paged_decode"):
        kr = KernelRows(seed)
        ragged = [0, 1, 63, 64, 65, 130, 300, 511]
        for int8 in (False, True):
            for sq in (1, 5):
                _compare_paged(kr, "tiny", 4, 8, 64, sq, ragged, int8)
            _compare_paged(kr, "7b", 32, 1, 128, 1, ragged, int8, most=4)
        tokens = [1, 63, 64, 65, 300, 511, 777, 1024]
        _compare_paged(kr, "tiny", 4, 8, 64, 1, tokens, False, ro=True)
        _compare_paged(kr, "7b", 32, 1, 128, 1, tokens, False, ro=True, most=4)
    specs = [(m, name, k, kx, n) for m in (1024, 4096)
             for name, k, kx, n in (("wqkv", 4096, 4096, 12288), ("wo", 4096, 4096, 4096),
                                    ("w13", 4096, 4096, 22016), ("w2", 11264, 11008, 4096))]
    for m, name, k, kx, n in (specs + [(1000, "wo", 4096, 4096, 4096)]
                              if want("w4_matmul_bigm") else []):
        sets = []
        for _ in range(n_copies(kx * n // 2 + m * kx * 2, most=4)):
            w = torch.randn(kx, n, generator=gen, device="cuda") * kx ** -0.5
            sets.append((randn(m, kx), to_folded_layout(quantize_weight(w, 4, 128, pad_in_to=k))))
            del w
        ms = time_ms(lambda x, qw: planes_qmm_bigm(x, qw.packed, qw.scales, qw.zeros,
                                                   in_dim=qw.in_dim, group_size=128), sets)
        lib = time_ms(lambda x, d: x @ d, [(x, dequantize_weight(qw, torch.bfloat16)[:kx])
                                           for x, qw in sets[:2]])
        b_ms, b_by = bound_ms(0, 2.0 * m * kx * n)
        emit({"phase": "compare", "kernel": "w4_matmul_bigm", "shape": f"7b {name} M={m}",
              "ms": ms, "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by})
        del sets
    for tag, b, s, nq, nkv, hd, q0, sk in ((
            ("tiny", 4, 128, 32, 4, 64, 0, 128), ("7b", 8, 128, 32, 32, 128, 0, 128),
            ("700m", 2, 2048, 16, 8, 128, 0, 2048), ("7b qpeft", 8, 512, 32, 32, 128, 0, 512),
            ("train_cp", 1, 4096, 32, 32, 128, 0, 4096),
            ("7b cp4 rank3", 1, 2048, 32, 32, 128, 6144, 8192),
            ("tiny cp4 rank3", 1, 2048, 32, 4, 64, 6144, 8192))
            if want("flash_attention") else ()):
        nbytes = b * s * 2 * nq * hd * 2 + b * sk * 2 * nkv * hd * 2
        sets = [(randn(b, s, nq, hd), randn(b, sk, nkv, hd), randn(b, sk, nkv, hd))
                for _ in range(n_copies(nbytes, most=8))]
        if q0 == 0 and sk == s:
            ms = time_ms(lambda q, k, v: _forward(q, k, v, None, with_lse=True), sets)
            lib = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                enable_gqa=True), sets)
        else:
            ms = time_ms(lambda q, k, v: _forward(q, k, v, None, with_lse=True, q_offset=q0),
                         sets)
            lib = time_ms(lambda q, k, v: _masked_sdpa(q, k, v, q0), sets)
        b_ms, b_by = bound_ms(nbytes, 4 * _cp_work(b, s, q0, nq, hd))
        emit({"phase": "compare", "kernel": "flash_attention_fwd",
              "shape": f"{tag} B={b} S={s} q0={q0} SK={sk} NQ={nq} NKV={nkv} HD={hd}",
              "ms": ms, "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by})
        del sets
    # the backward (rows 3b and 26): flash_attention_bwd(q, k, v, out, dout,
    # lse[, None, q0]), split into its dq and dk / dv kernels by name (both
    # the earlier design's names and this one's hold the substrings), beside
    # the backward of SDPA (a boolean mask for a shard) and the bound of its
    # seven causal products
    parts = ("flash_bwd_dq", "flash_bwd_dkdv")
    for tag, b, s, nq, nkv, hd, q0, sk in ((
            ("tiny", 4, 256, 32, 4, 64, 0, 256), ("7b qpeft", 8, 512, 32, 32, 128, 0, 512),
            ("700m", 2, 2048, 16, 8, 128, 0, 2048), ("train_cp", 1, 4096, 32, 32, 128, 0, 4096),
            ("7b cp4 rank3", 1, 2048, 32, 32, 128, 6144, 8192),
            ("tiny cp4 rank3", 1, 2048, 32, 4, 64, 6144, 8192))
            if want("flash_attention_bwd_dq") else ()):
        off = None if q0 == 0 and sk == s else q0
        # q, out, dout read, dq written; k / v read, dk / dv written; lse and D
        nbytes = 4 * b * s * nq * hd * 2 + 4 * b * sk * nkv * hd * 2 + 3 * b * nq * s * 4
        sets = []
        for _ in range(n_copies(nbytes, most=4)):
            q, k, v = randn(b, s, nq, hd), randn(b, sk, nkv, hd), randn(b, sk, nkv, hd)
            out, lse = _forward(q, k, v, None, with_lse=True, q_offset=off)
            sets.append((q, k, v, out, randn(b, s, nq, hd), lse, None, off))
        ms = time_ms(flash_attention_bwd, sets, by=parts)
        q, k, v, _, dout, *_ = sets[0]
        qt, kt, vt = (t.detach().requires_grad_(True) for t in (q, k, v))
        if off is None:
            o = F.scaled_dot_product_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                                               vt.transpose(1, 2), is_causal=True,
                                               enable_gqa=True)
        else:
            o = _masked_sdpa(qt, kt, vt, q0)
        lib = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dout.transpose(1, 2),
                                                  retain_graph=True), [()], min_iters=10)
        b_ms, b_by = bound_ms(nbytes, 14 * _cp_work(b, s, q0, nq, hd))
        emit({"phase": "compare", "kernel": "flash_attention_bwd",
              "shape": f"{tag} B={b} S={s} q0={q0} SK={sk} NQ={nq} NKV={nkv} HD={hd}",
              "ms": ms[parts[0]] + ms[parts[1]], "dq_ms": ms[parts[0]],
              "dkdv_ms": ms[parts[1]], "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by})
        del sets, o, qt, kt, vt


def phase_cp_shards(seed: int, s: int = 8192):
    """Context parallelism on one card at cp 2, 4 and 8: every shard's
    parallel.cp_shard_attention (the step each rank runs between its
    collectives; here the gather is a torch.cat of the shards' keys and the
    reduce-scatter a sum over the shards' dk / dv), LLaMA2-7B width (32 / 32
    heads, head_dim 128), b 1, S 8192. Held against the unsharded
    flash_attention and its backward: the concatenated outputs, lse and dq
    bit for bit (a row's arithmetic, forward and dq, does not depend on the
    block that computes it, and the key tiles are aligned at key 0), the
    summed dk / dv within a rounding step. Times between CUDA events around
    back-to-back calls (each call is 0.2-13 ms of kernel work, far above its
    host cost): the shards' forward and backward summed, beside
    the unsharded kernels' and each shard's own; the profiler's device time of
    the unsharded calls is printed beside them as a cross-check. Launch
    counts are set to 0 just before each shard's cp_shard_attention forward
    and backward and read just after (one launch of each row-26 entry a
    shard: 14 over cp 2, 4 and 8); they are the phase's return."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.ops.flash_attention import _forward, flash_attention_bwd
    from accessory_tpu_torch.parallel.context import cp_shard_attention

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, nq, nkv, hd = 1, 32, 32, 128
    q, k, v, dout = (torch.randn((b, s, n, hd), generator=gen, device="cuda")
                     .to(torch.bfloat16) for n in (nq, nkv, nkv, nq))
    out, lse = _forward(q, k, v, None, with_lse=True)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse)
    fwd_names, bwd_names = (("flash_fwd_wgmma_kernel",),
                            ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel"))
    full_fwd = wall_ms(lambda: _forward(q, k, v, None, with_lse=True), [()], min_iters=10)
    full_bwd = wall_ms(lambda: flash_attention_bwd(q, k, v, out, dout, lse), [()], min_iters=10)
    prof_fwd = time_ms(lambda: _forward(q, k, v, None, with_lse=True), [()], min_iters=10,
                       by=fwd_names)
    prof_bwd = time_ms(lambda: flash_attention_bwd(q, k, v, out, dout, lse), [()], min_iters=10,
                       by=bwd_names)
    flops = 4.0 * b * nq * hd * s * (s + 1) / 2
    counts = {}
    for cp in (2, 4, 8):
        s_l = s // cp
        shards = [slice(r * s_l, (r + 1) * s_l) for r in range(cp)]
        kg = torch.cat([k[:, sl] for sl in shards], 1)          # the all-gather
        vg = torch.cat([v[:, sl] for sl in shards], 1)
        outs, lses, dqs = [], [], []
        dk_sum = torch.zeros(k.shape, dtype=torch.float32, device="cuda")
        dv_sum = torch.zeros_like(dk_sum)
        for r, sl in enumerate(shards):
            leaves = [q[:, sl].detach().clone().requires_grad_(True),
                      kg.detach().clone().requires_grad_(True),
                      vg.detach().clone().requires_grad_(True)]
            kernels.reset_launch_counts()
            o = cp_shard_attention(*leaves, r)
            o.backward(dout[:, sl])
            _add_counts(counts, kernels.launch_counts())
            outs.append(o.detach())
            lses.append(_forward(leaves[0].detach(), kg, vg, None, with_lse=True,
                                 q_offset=r * s_l)[1])
            dqs.append(leaves[0].grad)
            dk_sum += leaves[1].grad.float()                      # the reduce-scatter
            dv_sum += leaves[2].grad.float()
        torch.cuda.synchronize()
        exact = {"out": bool(torch.equal(torch.cat(outs, 1), out)),
                 "lse": bool(torch.equal(torch.cat(lses, 2), lse)),
                 "dq": bool(torch.equal(torch.cat(dqs, 1), dq))}
        for name, got, want in (("dk", dk_sum, dk), ("dv", dv_sum, dv)):
            check_close(f"cp_shards cp={cp} {name}", got, want.float(), rtol=2e-2,
                        atol=2e-2 * float(want.float().abs().max()), rel_l2=2e-2)
        errs = {"dk": max_err(dk_sum, dk)[0], "dv": max_err(dv_sum, dv)[0]}
        shard_args = [(q[:, sl].contiguous(), r * s_l) for r, sl in enumerate(shards)]
        per_fwd, per_bwd = [], []
        saved = [_forward(qs, kg, vg, None, with_lse=True, q_offset=off)
                 for qs, off in shard_args]
        for (qs, off), (o, l), sl in zip(shard_args, saved, shards):
            per_fwd.append(wall_ms(lambda: _forward(qs, kg, vg, None, with_lse=True,
                                                    q_offset=off), [()], min_iters=10))
            per_bwd.append(wall_ms(lambda: flash_attention_bwd(qs, kg, vg, o, dout[:, sl], l,
                                                               None, off), [()], min_iters=10))
        row = {"phase": "cp_shards", "cp": cp, "shape": f"7b B={b} S={s} NQ={nq} NKV={nkv} "
               f"HD={hd}", "exact": exact, "max_abs_err": errs,
               "clock": "CUDA events", "fwd_ms_shards_sum": sum(per_fwd),
               "fwd_ms_unsharded": full_fwd, "bwd_ms_shards_sum": sum(per_bwd),
               "bwd_ms_unsharded": full_bwd,
               "profiler_ms_unsharded": {"fwd": prof_fwd[fwd_names[0]],
                                         "bwd": prof_bwd[bwd_names[0]] + prof_bwd[bwd_names[1]]},
               "fwd_ms_by_shard": per_fwd, "bwd_ms_by_shard": per_bwd,
               "fwd_bound_ms_by_shard": [bound_ms(0, 4 * _cp_work(b, s_l, r * s_l, nq, hd))[0]
                                         for r in range(cp)],
               "fwd_bound_ms_unsharded": bound_ms(0, flops)[0]}
        emit(row)
        if not all(exact.values()):
            raise AssertionError(f"cp_shards cp={cp}: shards differ from the unsharded kernel "
                                 f"({exact})")
        del saved, kg, vg, dk_sum, dv_sum, outs, dqs, lses
    counts = {n: c for n, c in counts.items() if c}
    want = {n: 2 + 4 + 8 for n in ("flash_attention_cp", "flash_attention_cp_bwd_dq",
                                   "flash_attention_cp_bwd_dkdv")}
    emit({"phase": "cp_shards", "launches": counts, "launches_expected": want})
    if counts != want:
        raise AssertionError(f"cp_shards: launch counts {counts} != expected {want}")
    return counts


def phase_train_cp(seed: int, batch: int = 1, seq_len: int = 4096, steps: int = 3):
    """The context-parallel training path on one card: a one-rank NCCL group
    (init_distributed_mode over a FileStore in a temporary directory), mesh
    (dp 1, cp 1, tp 1), the 7B QPEFT configuration (train_qpeft7b's: 32
    layers, W4 g128 base, LoRA 16, bias and norm tuning, full remat) at b 1,
    S 4096, with attn_fn=make_cp_attn_fn(mesh): labels shifted up front, the
    loss normalized by the all-reduced count, row 26's three entries in place
    of the flash ones. One step against the same step without attn_fn from
    the same weights: loss to 1e-5 relative, every gradient to 1e-3 relative
    L2 and the updated trainable leaves to 1e-2 of an lr where the gradient is
    at least a tenth of its leaf's largest (bit-equality is reported). Then
    1 warm-up and ``steps`` timed steps: ms per step, tokens/s, model flops
    against 989 TFLOP/s, the device's busy share and peak memory; launch
    counts exact."""
    import torch
    import torch.distributed as dist

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.parallel import (init_distributed_mode, local_mesh,
                                              make_cp_attn_fn)
    from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from accessory_tpu_torch.train.train_step import grads_of
    from accessory_tpu_torch.train.tree import named_leaves

    lr = 1e-3
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        info = init_distributed_mode(init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            mesh = local_mesh()
            args, params, trainable = _train_model(dict(LLAMA2_7B, **QPEFT), seed, True,
                                                   seq_len=seq_len)
            data = _token_batch(seed, batch, seq_len, args.vocab_size)
            before = {k: v.detach().clone() for k, v in named_leaves(params) if trainable(k)}
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            res = {}
            for tag, attn_fn in (("plain", None), ("cp", make_cp_attn_fn(mesh))):
                for k, v in named_leaves(params):
                    if k in before:
                        v.data.copy_(before[k])
                tx = make_optimizer(params, lr, weight_decay=0.02, clip_norm=2.0,
                                    trainable=trainable)
                state = TrainState.create(params, tx)
                step = make_train_step(llama, args, tx, remat="full", attn_fn=attn_fn)
                kernels.reset_launch_counts()
                state, m = step(state, data)
                loss = float(m["c_loss"])
                res[tag] = dict(loss=loss, counts=kernels.launch_counts(),
                                grads={k: g.detach().clone() for k, g in grads_of(state).items()},
                                after={k: v.detach().clone() for k, v in named_leaves(params)
                                       if k in before})
            p, c = res.pop("plain"), res.pop("cp")
            worst, bit_equal = {"grad_rel_l2": 0.0, "update_err_lr": 0.0}, 0
            for k, gp in p["grads"].items():
                gc = c["grads"][k]
                bit_equal += bool(torch.equal(gp, gc))
                rel = float((gc.float() - gp.float()).norm() / gp.float().norm().clamp_min(1e-30))
                worst["grad_rel_l2"] = max(worst["grad_rel_l2"], rel)
            for k, b0 in before.items():
                g = p["grads"][k].float()
                sure = g.abs() >= 0.1 * g.abs().max()
                if sure.any():
                    d = ((c["after"][k].float() - p["after"][k].float()) / lr).abs()[sure]
                    worst["update_err_lr"] = max(worst["update_err_lr"], float(d.max()))
            want = {n: v for n, v in _train_counts(args.n_layers, True, True)[1].items()}
            want_cp = dict(want, flash_attention=0, flash_attention_bwd_dq=0,
                           flash_attention_bwd_dkdv=0,
                           flash_attention_cp=want["flash_attention"],
                           flash_attention_cp_bwd_dq=want["flash_attention_bwd_dq"],
                           flash_attention_cp_bwd_dkdv=want["flash_attention_bwd_dkdv"])
            step_counts = c["counts"]
            n_grads = len(p["grads"])
            for r in (p, c):
                del r["grads"], r["after"]
            # timed: the cp step from here on (the comparison's step was the warm-up)
            torch.cuda.reset_peak_memory_stats()
            losses, times = [c["loss"]], []
            for _ in range(steps):
                t1 = time.perf_counter()
                state, m = step(state, data)
                losses.append(float(m["c_loss"]))
                times.append((time.perf_counter() - t1) * 1e3)
            peak = torch.cuda.max_memory_allocated()
            ms = statistics.median(times)
            tok_s = batch * seq_len / ms * 1e3
            n_mm = _matmul_params(state.params)
            attn = 2 * seq_len * args.n_heads * args.head_dim * args.n_layers
            model_tok = 4 * n_mm + 3 * attn
            state, prof = _split_profile(step, state, data, ms)
        finally:
            dist.destroy_process_group()
    row = {"phase": "train_cp", "process_group": {k: info[k] for k in ("world_size", "backend")},
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "layers": args.n_layers,
           "dim": args.dim, "heads": [args.n_heads, args.kv_heads], "batch": [batch, seq_len],
           "mode": "QPEFT (W4 g128 base, LoRA 16, bias, norm)", "remat": "full", "lr": lr,
           "setup_s": setup_s, "loss_plain": p["loss"], "loss_cp": c["loss"],
           "grads_bit_equal": f"{bit_equal} of {n_grads}", "worst": worst,
           "tolerances": {"loss_rel": 1e-5, "grad_rel_l2": 1e-3, "update_err_lr": 1e-2},
           "ms_per_step": ms, "ms_per_step_all": times, "tok_s": tok_s,
           "model_flops_per_token": model_tok, "model_tflop_s": model_tok * tok_s / 1e12,
           "mfu_vs_989": model_tok * tok_s / BF16_FLOPS_PER_S, "peak_bytes": peak,
           "losses": losses, "launches": step_counts, "launches_expected": want_cp,
           "profile": prof}
    emit(row)
    if not (abs(c["loss"] - p["loss"]) <= 1e-5 * abs(p["loss"]) and worst["grad_rel_l2"] <= 1e-3
            and worst["update_err_lr"] <= 1e-2):
        raise AssertionError(f"train_cp: the cp step disagrees with the plain step ({worst}, "
                             f"loss {c['loss']} vs {p['loss']})")
    if step_counts != want_cp:
        raise AssertionError(f"train_cp: launch counts {step_counts} != {want_cp}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_cp: losses not finite and falling: {losses}")
    del state, params, step, tx
    torch.cuda.empty_cache()
    return step_counts


def phase_finetune(seed: int):
    """main_finetune.main on the card at tiny size: a generated alpaca JSON
    read through a YAML META config and the byte tokenizer, one epoch with
    --quant --only_save_trainable --checkpointing, the checkpoint's optimizer
    state read back bit for bit, then a second call that resumes from it and
    runs the next epoch (the step count goes on from the saved one). Launch
    counts of the first call are exact."""
    import numpy as np
    import torch

    from accessory_tpu_torch import kernels, main_finetune
    from accessory_tpu_torch.train.ckpt import resume_stage2

    rng = np.random.RandomState(seed)
    words = "the of a kernel card train token step layer weight loss".split()

    def text(lo, hi):
        return " ".join(rng.choice(words, rng.randint(lo, hi)))

    with tempfile.TemporaryDirectory() as tmp:
        data = [{"instruction": text(3, 9), "input": text(1, 4) if i % 2 else "",
                 "output": text(3, 12)} for i in range(16)]
        with open(f"{tmp}/alpaca.json", "w") as f:
            json.dump(data, f)
        with open(f"{tmp}/data.yaml", "w") as f:
            f.write(f"META:\n  - path: {tmp}/alpaca.json\n    type: text\n"
                    "    prompt_type: None\n")
        with open(f"{tmp}/llama.json", "w") as f:
            json.dump(dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=258,
                           multiple_of=128, lora_rank=8, bias_tuning=True, norm_tuning=True), f)

        def args(epochs):
            return main_finetune.get_args_parser().parse_args([
                "--llama_config", f"{tmp}/llama.json", "--tokenizer_path", "unused",
                "--data_config", f"{tmp}/data.yaml", "--output_dir", f"{tmp}/out",
                "--batch_size", "4", "--epochs", str(epochs), "--max_words", "128",
                "--quant", "--only_save_trainable", "--checkpointing", "--lr", "1e-3",
                "--warmup_epochs", "0", "--log_every", "1000", "--seed", str(seed)])

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state = main_finetune.main(args(1), tokenizer=ByteTokenizer())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = kernels.launch_counts()
        steps = int(state.step)
        _, want = _train_counts(2, True, False, steps)
        back, _, _ = resume_stage2(f"{tmp}/out/epoch0", state)
        same = all(torch.equal(back.opt_state[part][k], v)
                   for part in ("mu", "nu") for k, v in state.opt_state[part].items())
        same = same and back.opt_state["count"] == state.opt_state["count"] == steps
        state2 = main_finetune.main(args(2), tokenizer=ByteTokenizer())
        logs = [json.loads(x) for x in open(f"{tmp}/out/log.txt").read().splitlines()]
    row = {"phase": "finetune", "steps_epoch0": steps, "seconds_epoch0": secs,
           "resumed_step_after_epoch1": int(state2.step), "opt_state_bit_equal": same,
           "log": logs, "launches": counts, "launches_expected": want}
    emit(row)
    if counts != want or steps != 4 or not same or int(state2.step) != 2 * steps \
            or len(logs) != 2 or not all(math.isfinite(x["closs"]) for x in logs):
        raise AssertionError(f"finetune: {row}")
    return counts


# kernel -> (source, the TPU kernel it replaces, the main-path shape whose row
# the summary line reports: the 7B serve phase's where the kernel runs there)
# ---------------------------------------------------------------- Mixtral (MoE)


# a routing flip between the CPU and the card passes only where the CPU's
# router scores of the k-th and the (k+1)-th expert lie closer than this
ROUTE_FLIP_GAP = 2e-2


def _routing_compare(cpu_log, gpu_log, k: int):
    """Per (token, layer): the chosen experts as sets on each side; a flip's
    gap is the CPU's score k minus score k + 1. Returns (agree (T, layers)
    bool, [flip gaps])."""
    import torch

    agree, gaps = [], []
    for c, g in zip(cpu_log, gpu_log):
        same = (c["idx"].sort(dim=-1).values == g["idx"].sort(dim=-1).values).all(dim=-1)
        top = c["scores"].sort(dim=-1, descending=True).values
        gaps += (top[:, k - 1] - top[:, k])[~same].tolist()
        agree.append(same)
    return torch.stack(agree, dim=-1), gaps


def phase_parity_moe(seed: int, b: int = 2, plen: int = 32, steps: int = 8):
    """Mixtral width (dim 4096, 8 experts of 14336, 32 / 8 heads), one layer:
    the CPU (plain versions) against the card (kernels) on the same W4 weights
    (``quantize_params`` of a seeded dense layer, the router f32), a prefill
    of b x plen tokens and ``steps`` decode steps teacher-forced on the CPU's
    greedy tokens. Routing agreement per (token, layer), each flip with the
    CPU's gap between scores k and k + 1 (at most ROUTE_FLIP_GAP); logits
    held to parity's tolerances where every layer's routing agreed, for each
    batch row up to its first flip (a flip moves the next layers' k / v, and
    through the cache every later token of the row)."""
    import torch

    from accessory_tpu_torch.config import MixtralArgs
    from accessory_tpu_torch.models import mixtral
    from accessory_tpu_torch.ops import moe
    from accessory_tpu_torch.quant.quantize import DEFAULT_BLOCKLIST, quantize_params

    args = MixtralArgs(**dict(MIXTRAL_8X7B, n_layers=1), max_seq_len=128)
    block = tuple(DEFAULT_BLOCKLIST) + tuple(mixtral.get_quant_blocklist(args))
    params_gpu = quantize_params(mixtral.init_params(args, seed=seed), blocklist=block)
    torch.cuda.empty_cache()
    params_cpu = _tree_to(params_gpu, "cpu")
    prompt = torch.randint(0, args.vocab_size, (b, plen),
                           generator=torch.Generator().manual_seed(seed))
    cache_g = mixtral.init_kv_cache(args, b, 128)
    cache_c = mixtral.init_kv_cache(args, b, 128, device="cpu")
    cpu_s, logits, agree, gaps = 0.0, [], [], []
    clean = torch.ones(b, dtype=torch.bool)
    tok = prompt
    for i in range(steps + 1):
        pos = 0 if i == 0 else plen + i - 1
        with moe.record_routing(detail=True) as glog:
            lg, _ = mixtral.forward(params_gpu, args, tok.cuda(), cache=cache_g, cur_pos=pos)
        t0 = time.perf_counter()
        with moe.record_routing(detail=True) as clog:
            lc, _ = mixtral.forward(params_cpu, args, tok, cache=cache_c, cur_pos=pos)
        cpu_s += time.perf_counter() - t0
        same, flip_gaps = _routing_compare(clog, glog, args.num_experts_per_tok)
        tok_ok = same.all(dim=-1).reshape(tok.shape)
        agree.append(clean[:, None] & (tok_ok.cumprod(dim=1) > 0))
        clean &= tok_ok.all(dim=1)
        gaps += flip_gaps
        logits.append((lg.float().cpu(), lc))
        tok = lc[:, -1:].argmax(-1)
    tol_abs = LOGIT_TOL_FRAC * float(logits[0][1].abs().max())
    gpu = torch.cat([g.reshape(-1, g.shape[-1]) for g, _ in logits])
    cpu = torch.cat([c.reshape(-1, c.shape[-1]) for _, c in logits])
    ok = torch.cat([a.reshape(-1) for a in agree])
    d = (gpu - cpu)[ok]
    top2 = cpu[ok].topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > tol_abs
    row = {"phase": "parity_moe", "model": "Mixtral-8x7B width, 1 layer", "weights": "W4",
           "batch": b, "prompt": plen, "decode_steps": steps, "cpu_seconds": round(cpu_s, 2),
           "routing_tokens": int(ok.numel()), "routing_flips": len(gaps),
           "tokens_compared": int(ok.sum()),
           "routing_flip_gaps": gaps, "flip_gap_limit": ROUTE_FLIP_GAP,
           "max_abs_logit_err": float(d.abs().max()) if d.numel() else None,
           "max_rel_l2_err": float(d.norm() / cpu[ok].norm()) if d.numel() else None,
           "tol_abs": tol_abs, "tol_rel_l2": LOGIT_REL_L2,
           "tokens_checked": int(sure.sum()),
           "tokens_agreed": int((gpu[ok].argmax(-1) == cpu[ok].argmax(-1))[sure].sum())}
    emit(row)
    if (not torch.isfinite(gpu).all() or not d.numel() or row["max_abs_logit_err"] > tol_abs
            or row["max_rel_l2_err"] > LOGIT_REL_L2 or any(g > ROUTE_FLIP_GAP for g in gaps)
            or row["tokens_agreed"] != row["tokens_checked"]):
        raise AssertionError(f"parity_moe failed: {row}")


def _random_w4(gen, k: int, n: int, gs: int = 128):
    """A folded W4 g128 weight straight from random bits on the card: uniform
    nibbles, scales about k^-0.5 / 4.6 (so x @ W keeps x's scale; uniform
    nibbles have a standard deviation of 4.6) and zs = 7.5 s (zero mean)."""
    import torch

    from accessory_tpu_torch.quant.qtensor import QuantizedWeight

    words = torch.randint(-2 ** 31, 2 ** 31, (k // 8, n), generator=gen, device="cuda",
                          dtype=torch.int64).to(torch.int32)
    scales = (torch.rand((k // gs, n), generator=gen, device="cuda") * 0.5 + 0.75) \
        * (k ** -0.5 / 4.6)
    return QuantizedWeight(packed=words, scales=scales, zeros=7.5 * scales, bits=4,
                           group_size=gs, in_dim=k, out_dim=n, layout="folded")


def _qw_bytes(node) -> int:
    """Bytes of the quantized weights in a subtree (packed words, scales, zeros)."""
    from accessory_tpu_torch.quant.qtensor import QuantizedWeight

    if isinstance(node, QuantizedWeight):
        return sum(t.numel() * t.element_size() for t in (node.packed, node.scales, node.zeros))
    if isinstance(node, dict):
        return sum(_qw_bytes(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return sum(_qw_bytes(v) for v in node)
    return 0


def _mixtral_model(seed: int, max_seq_len: int):
    """The full Mixtral-8x7B shape (32 layers, 8 experts, dim 4096, hidden
    14336, 32 / 8 heads), W4 g128 folded, built leaf by leaf on the card from
    ``seed`` (the dense bf16 model, ~93 GB, is never made): every projection
    and expert a ``_random_w4``, the router f32, embeddings and head bf16,
    norms one; a MetaModel holding them. Returns (model, setup s, peak
    bytes)."""
    import torch

    from accessory_tpu_torch.meta import MetaModel

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = MetaModel("mixtral", dict(MIXTRAL_8X7B), max_seq_len=max_seq_len, init_params=False)
    a = model.args
    d, hidden, nkv_d = a.dim, a.hidden_dim, a.kv_heads * a.head_dim

    def dense(shape, scale, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    def ones():
        return torch.ones(d, dtype=torch.bfloat16, device="cuda")

    layers = []
    for _ in range(a.n_layers):
        layers.append({
            "attention_norm": {"weight": ones()}, "ffn_norm": {"weight": ones()},
            "attention": {name: {"weight": _random_w4(gen, k, n)} for name, k, n in
                          (("wq", d, d), ("wk", d, nkv_d), ("wv", d, nkv_d), ("wo", d, d))},
            "feed_forward": {
                "gate": {"weight": dense((d, a.num_experts), d ** -0.5, torch.float32)},
                "w1": {"weight": tuple(_random_w4(gen, d, hidden) for _ in range(a.num_experts))},
                "w2": {"weight": tuple(_random_w4(gen, hidden, d) for _ in range(a.num_experts))},
                "w3": {"weight": tuple(_random_w4(gen, d, hidden) for _ in range(a.num_experts))},
            }})
    model.params = {"tok_embeddings": {"weight": dense((a.vocab_size, d), 1.0)},
                    "layers": layers, "norm": {"weight": ones()},
                    "output": {"weight": dense((d, a.vocab_size), d ** -0.5)}}
    model.tokenizer = ByteTokenizer()
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _moe_matmul_counts(log, attention: bool = True) -> dict:
    """The W4 launches of Mixtral forwards, from the routing they recorded
    (one entry a layer a forward): wq, wk, wv, wo (unless ``attention`` is
    False) and w1, w3, w2 of each touched expert, on the many-row kernel
    from 1024 rows."""
    want = {"w4_matmul": 0, "w4_matmul_bigm": 0}
    for entry in log:
        want["w4_matmul_bigm" if entry["rows"] >= 1024 else "w4_matmul"] += \
            4 * attention + 3 * sum(entry["touched"])
    return want


def _touched_mean(log, rows=None) -> float:
    picked = [sum(e["touched"]) for e in log if rows is None or e["rows"] == rows]
    return sum(picked) / max(len(picked), 1)


def phase_serve_moe(seed: int):
    """The full Mixtral-8x7B shape, W4 from --seed, through
    MetaModel.generate: the 8 PROMPTS in the 128-token bucket (1024 prefill
    rows), 32 new tokens, greedy, bf16 KV. Launch counts exact per kernel
    entry, row 1 and row 5 from the routing the run recorded. Returns the
    model and the counts."""
    import torch

    from accessory_tpu_torch.ops import moe

    prompts = PROMPTS
    assert len(prompts) == 8 and all(100 <= len(p) <= 126 for p in prompts)
    model, setup_s, setup_peak = _mixtral_model(seed, 512)
    n_layers = model.args.n_layers
    model.kv_dtype = None
    model._reset_generator()
    prefill_ms = _timed_prefill(model, 8, 128, 192, None)
    with moe.record_routing() as log:
        outs, counts, steps, total_s = _counted_generate(model, prompts, 32)
    want = _zero_counts(flash_attention=n_layers, kv_write=n_layers,
                        decode_attention=n_layers * steps, **_moe_matmul_counts(log))
    row = {"phase": "serve_moe", "model": "Mixtral-8x7B shape", "kv_dtype": "bf16",
           "layers": n_layers, "experts": model.args.num_experts, "top_k": 2,
           "batch": len(prompts), "prompt_tokens": [len(p) + 1 for p in prompts],
           "prefill_rows": 8 * 128, "decode_steps": steps, "launches": counts,
           "launches_expected": want, "setup_s": setup_s, "setup_peak_gb": setup_peak / 1e9,
           "weight_gb": _qw_bytes(model.params) / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "touched_experts_prefill_mean": _touched_mean(log, 1024),
           "touched_experts_decode_mean": _touched_mean(log, len(prompts)),
           "prefill_ms": prefill_ms, "generate_s": total_s,
           "decode_tok_s": len(prompts) * steps / max(total_s - prefill_ms / 1e3, 1e-9),
           "outputs_chars": [len(o) for o in outs]}
    emit(row)
    if (counts != want or steps < 32 or len(outs) != len(prompts)
            or len(log) != n_layers * (steps + 1)):
        raise AssertionError(f"serve_moe: launch counts {counts} != expected {want}")
    return model, counts


def phase_decode_moe(model, kv_dtype, steps: int = 50):
    """The Mixtral model at batch 8 and a 1024-token cache: a counted prefill
    of 8 x 512 random tokens (4096 rows: the many-row kernel, flash and the
    slab write of the cache type), then ``steps`` forward steps from
    position 512 (8 different tokens): wall ms a step, launch counts
    exact from the recorded routing, the mean touched experts a layer, the
    bytes bound from that routing (each touched expert's W4 bytes, the
    attention projections', the router, the head and the KV read, once a
    step, at 3.35 TB/s), then device time by kernel over 4 profiled steps
    (about 3800 kernels a step) with row 1's share and the idle share."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.ops import moe

    args, params, module = model.args, model.generator.params, model.module
    batch, cache_len, pos0 = 8, 1024, 512
    cache = module.init_kv_cache(args, batch, cache_len, kv_dtype=kv_dtype)
    tok = (torch.arange(batch, device="cuda")[:, None] * 37 + 11).to(torch.int64)
    int8 = "ks" in cache
    prompt = torch.randint(0, 256, (batch, pos0), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(pos0))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with moe.record_routing() as plog:
        t0 = time.perf_counter()
        module.forward(params, args, prompt, cache=cache, cur_pos=0)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_counts = kernels.launch_counts()
    prefill_want = _zero_counts(flash_attention=args.n_layers, **_moe_matmul_counts(plog),
                                **{"kv_write_q8" if int8 else "kv_write": args.n_layers})
    if prefill_counts != prefill_want:
        raise AssertionError(f"decode_moe prefill: launch counts {prefill_counts} != "
                             f"expected {prefill_want}")
    for i in range(5):
        module.forward(params, args, tok, cache=cache, cur_pos=pos0 + i)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with moe.record_routing() as log:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, _ = module.forward(params, args, tok, cache=cache, cur_pos=pos0 + i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = kernels.launch_counts()
    if not torch.isfinite(logits).all():
        raise AssertionError("decode_moe: non-finite logits")
    want = _zero_counts(**_moe_matmul_counts(log),
                        **{"decode_attention8" if int8 else "decode_attention":
                           args.n_layers * steps})
    layer0 = params["layers"][0]
    att_bytes = _qw_bytes(layer0["attention"])
    expert_bytes = sum(_qw_bytes(layer0["feed_forward"][n]["weight"][0])
                       for n in ("w1", "w2", "w3"))
    fixed = sum(t.numel() * t.element_size() for t in
                (params["output"]["weight"], params["norm"]["weight"])) \
        + args.n_layers * (att_bytes + layer0["feed_forward"]["gate"]["weight"].numel() * 4)
    token_bytes = sum(c[0].numel() * c[0].element_size() for c in cache.values()) \
        // (batch * args.kv_heads * cache_len)   # k + v (+ scales) of one cached token of a head
    touched = sum(sum(e["touched"]) for e in log)
    kv_read = sum(args.n_layers * batch * args.kv_heads * (pos0 + i) * token_bytes
                  for i in range(steps))
    bound_bytes = (steps * fixed + touched * expert_bytes + kv_read) / steps
    b_ms, _ = bound_ms(bound_bytes, 0.0)
    row = {"phase": "decode_moe", "model": "Mixtral-8x7B shape", "kv_dtype": kv_dtype or "bf16",
           "layers": args.n_layers, "batch": batch, "cache_len": cache_len, "steps": steps,
           "prefill_rows": batch * pos0, "prefill_ms": prefill_ms,
           "touched_experts_prefill_mean": _touched_mean(plog),
           "prefill_launches": {k: v for k, v in prefill_counts.items() if v},
           "ms_per_step": ms, "tok_s": batch / ms * 1e3,
           "touched_experts_mean": _touched_mean(log), "bound_ms_per_step": b_ms,
           "bound_gb_per_step": bound_bytes / 1e9,
           "bound_parts_gb_per_step": {"experts": touched * expert_bytes / steps / 1e9,
                                       "attention_w4": args.n_layers * att_bytes / 1e9,
                                       "head_norm_router": (fixed - args.n_layers * att_bytes)
                                       / 1e9, "kv_read": kv_read / steps / 1e9},
           "launches": counts, "launches_expected": want}
    if counts != want or len(log) != args.n_layers * steps:
        emit(row)
        raise AssertionError(f"decode_moe: launch counts {counts} != expected {want}")
    row["profile"] = _profile_steps(params, args, tok, cache, pos0, ms, steps=4, module=module,
                                    shares=("W4Folded", "decode_attn"))
    emit(row)
    return {name: counts[name] + prefill_counts[name] for name in counts}


def phase_batcher_moe(model):
    """The Mixtral model through ContinuousBatcher: 4 slots, 64-token pages,
    decode_steps=8, bf16 pools, 8 requests of 128-token prompts and 32 new
    tokens. Every request finishes, the allocator balances, each kernel's
    launches equal what the forward_paged calls and the recorded routing
    imply; tok/s, time to first token, device busy ms a step and the idle
    share; greedy tokens against the static Generator's (printed)."""
    import numpy as np
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.models import mixtral
    from accessory_tpu_torch.ops import moe

    prompts = _p5_prompts(8)
    module = _CountingModule(mixtral)
    _drive(_batcher(model, module, None, slots=4), prompts[:2], 8)          # warm-up
    module.calls.clear()
    cb = _batcher(model, module, None, slots=4)
    kernels.reset_launch_counts()
    with moe.record_routing() as log:
        reqs, secs, ttft, dispatch = _drive(cb, prompts, 32)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    # the calls' shapes give the attention's 4 W4 launches a layer, the routing the experts'
    want = module.expected(model.args.n_layers, False)
    for name, n in _moe_matmul_counts(log, attention=False).items():
        want[name] += n
    n_tok = sum(len(r.output_tokens) for r in reqs)
    dec_s = sum(t for t, _ in dispatch)
    dec_steps = sum(n for _, n in dispatch)
    prof = _profile_dispatch(_batcher(model, mixtral, None, slots=4), prompts[:4])
    model.kv_dtype = None
    model._reset_generator()
    model.generate(prompts, max_gen_len=32)
    same = [np.asarray(r.output_tokens[:32]) == model.generator.last_tokens[i, 128:128 + 32]
            [:len(r.output_tokens[:32])] for i, r in enumerate(reqs)]
    row = {"phase": "batcher_moe", "model": "Mixtral-8x7B shape", "kv_dtype": "bf16",
           "layers": model.args.n_layers, "slots": 4, "page_size": 64, "decode_steps": 8,
           "requests": len(prompts), "prompt_tokens": 128, "max_gen_len": 32,
           "generated_tokens": n_tok, "run_s": secs, "tok_s": n_tok / secs,
           "decode_tok_s": 4 * dec_steps / dec_s if dec_s else None,
           "decode_ms_per_step": dec_s * 1e3 / dec_steps,
           "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
           "touched_experts_decode_mean": _touched_mean(log, 4),
           "forward_calls": len(module.calls), "launches": counts, "launches_expected": want,
           "balanced": _balanced(cb), "preemptions": cb.preemptions, **prof,
           "greedy_share_equal_to_static_generator": float(np.mean(np.concatenate(same)))}
    emit(row)
    if (counts != want or not row["balanced"] or len(reqs) != len(prompts)
            or not all(r.done and len(r.output_tokens) for r in reqs)):
        raise AssertionError(f"batcher_moe failed: {row}")
    return counts


# ---------------------------------------------------------------- InternLM and Falcon


def _zoo_family(name: str):
    """(llama_type, config, module, W4 products a layer) of a zoo model."""
    from accessory_tpu_torch.models import falcon, internlm

    return {"Falcon-40B": ("falcon", FALCON_40B, falcon, 6),
            "InternLM-7B": ("internlm", INTERNLM_7B, internlm, 5)}[name]


def phase_parity_zoo(seed: int):
    """Falcon-40B and InternLM-7B at full width, one layer each (W4 from
    ``quantize_params`` of a seeded dense layer, the embeddings and head
    dense): the CPU (plain versions) against the card (kernels) through a
    2 x 32 prefill and 4 teacher-forced decode steps, bf16 then int8 KV,
    logits within LOGIT_TOL_FRAC / LOGIT_REL_L2 (phase_parity)."""
    import torch

    for name in ("Falcon-40B", "InternLM-7B"):
        family, cfg, _, _ = _zoo_family(name)
        phase_parity(seed, "parity_zoo", cfg, 1, b=2, plen=32, steps=4, s_len=128,
                     kv_dtypes=(None, "int8"), family=family)
        gc.collect()
        torch.cuda.empty_cache()


def _zoo_model(name: str, seed: int, max_seq_len: int):
    """The full-width model ``name`` (FALCON_40B: 60 layers, 128 / 8 heads of
    64, FFN 32768; INTERNLM_7B: 32 layers, MHA of 128, FFN 11008, biased
    Wqkv / out_proj), W4 g128 folded, built leaf by leaf on the card from
    ``seed`` (the dense bf16 model never exists): every projection a
    ``_random_w4`` (K padded to the multiple of 1024 ``quantize_params``
    gives it), biases 0.02-scaled, norms one, embeddings and head bf16.
    Returns (model, setup s, peak bytes)."""
    import torch

    from accessory_tpu_torch.meta import MetaModel
    from accessory_tpu_torch.quant.quantize import pad_to

    family, cfg, module, _ = _zoo_family(name)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = MetaModel(family, dict(cfg), max_seq_len=max_seq_len, init_params=False)
    a = model.args
    d = a.hidden_size

    def dense(shape, scale):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def w4(k, n, bias=False):
        mod = {"weight": _random_w4(gen, k + (-k) % pad_to(k, 128), n)}
        if bias:
            mod["bias"] = dense((n,), 0.02)
        return mod

    def norm(bias):
        mod = {"weight": torch.ones(d, dtype=torch.bfloat16, device="cuda")}
        if bias:
            mod["bias"] = torch.zeros(d, dtype=torch.bfloat16, device="cuda")
        return mod

    layers = []
    for _ in range(a.num_layers):
        if family == "falcon":
            kvd = a.kv_heads * a.head_dim
            layers.append({"ln_attn": norm(True), "ln_mlp": norm(True),
                           "self_attention": {"wq": w4(d, d), "wk": w4(d, kvd),
                                              "wv": w4(d, kvd), "dense": w4(d, d)},
                           "mlp": {"dense_h_to_4h": w4(d, 4 * d),
                                   "dense_4h_to_h": w4(4 * d, d)}})
        else:
            hidden = module._hidden_dim(a)
            layers.append({"norm1": norm(False), "norm2": norm(False),
                           "mixer": {"Wqkv": w4(d, 3 * d, True), "out_proj": w4(d, d, True)},
                           "mlp": {"w1": w4(d, hidden), "w2": w4(d, hidden),
                                   "w3": w4(hidden, d)}})
    final = {"ln_f": norm(True)} if family == "falcon" else {"norm": norm(False)}
    model.params = {"word_embeddings": {"weight": dense((a.vocab_size, d), 1.0)},
                    "layers": layers, **final,
                    "output": {"weight": dense((d, a.vocab_size), d ** -0.5)}}
    model.tokenizer = ByteTokenizer()
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def phase_serve_zoo(name: str, seed: int):
    """The full-width model ``name`` through MetaModel.generate: the 8 PROMPTS
    in the 128-token bucket (a 1024-row prefill: every projection on row
    5), 32 new tokens, greedy, bf16 KV, launch counts exact (W4 products a
    layer x layers on row 5 once and on row 1 a decode step; flash and the
    slab write once a layer; the decode attention, GQA or one-query-head, a
    layer a step). Returns (model, counts)."""
    import torch

    family, _, _, n_proj = _zoo_family(name)
    phase = "serve_" + name.lower().replace("-", "")
    model, setup_s, setup_peak = _zoo_model(name, seed, 512)
    n_layers, mha = model.args.num_layers, model.args.kv_heads == model.args.num_attention_heads
    model.kv_dtype = None
    model._reset_generator()
    prefill_ms = _timed_prefill(model, 8, 128, 192, None)
    outs, counts, steps, total_s = _counted_generate(model, PROMPTS, 32)
    want = _zero_counts(flash_attention=n_layers, kv_write=n_layers,
                        w4_matmul=n_proj * n_layers * steps, w4_matmul_bigm=n_proj * n_layers,
                        **{"decode_attention_mha" if mha else "decode_attention":
                           n_layers * steps})
    row = {"phase": phase, "model": f"{name} shape", "family": family, "kv_dtype": "bf16",
           "layers": n_layers, "batch": len(PROMPTS),
           "prompt_tokens": [len(p) + 1 for p in PROMPTS], "prefill_rows": 8 * 128,
           "decode_steps": steps, "launches": counts, "launches_expected": want,
           "setup_s": setup_s, "setup_peak_gb": setup_peak / 1e9,
           "weight_gb": _qw_bytes(model.params) / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "prefill_ms": prefill_ms,
           "generate_s": total_s,
           "decode_tok_s": len(PROMPTS) * steps / max(total_s - prefill_ms / 1e3, 1e-9),
           "outputs_chars": [len(o) for o in outs]}
    emit(row)
    if counts != want or steps < 32 or len(outs) != len(PROMPTS):
        raise AssertionError(f"{phase}: launch counts {counts} != expected {want}")
    return model, counts


def phase_decode_zoo(name: str, model, kv_dtype, steps: int = 30):
    """The model at batch 8, a 1024-token cache, ``steps`` forward steps from
    position 512 (8 different tokens): wall ms a step, launch counts exact,
    the bytes bound (every weight byte but the embedding table's, and the
    KV read of each step at 3.35 TB/s), then device time by kernel over 4
    profiled steps with the shares of row 1, the attention, the head
    (cuBLAS, "nvjet") and the eager elementwise and reduction kernels, and
    the idle share. Returns the counts."""
    import torch

    from accessory_tpu_torch import kernels

    _, _, module, n_proj = _zoo_family(name)
    phase = "decode_" + name.lower().replace("-", "")
    args, params = model.args, model.generator.params
    batch, cache_len, pos0 = 8, 1024, 512
    cache = module.init_kv_cache(args, batch, cache_len, kv_dtype=kv_dtype)
    tok = (torch.arange(batch, device="cuda")[:, None] * 37 + 11).to(torch.int64)
    int8, mha = "ks" in cache, args.kv_heads == args.num_attention_heads
    n_layers = args.num_layers
    for i in range(3):
        module.forward(params, args, tok, cache=cache, cur_pos=pos0 + i)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, _ = module.forward(params, args, tok, cache=cache, cur_pos=pos0 + i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = kernels.launch_counts()
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{phase}: non-finite logits")
    attn = ("decode_attention_mha" if mha else "decode_attention") + ("8" if int8 else "")
    want = _zero_counts(w4_matmul=n_proj * n_layers * steps, **{attn: n_layers * steps})

    def nbytes(node):
        if isinstance(node, dict):
            return sum(nbytes(v) for k, v in node.items() if k != "word_embeddings")
        if isinstance(node, list):
            return sum(nbytes(v) for v in node)
        if hasattr(node, "packed"):
            return _qw_bytes(node)
        return node.numel() * node.element_size()

    w_bytes = nbytes(params)
    token_bytes = sum(c[0].numel() * c[0].element_size() for c in cache.values()) \
        // (batch * args.kv_heads * cache_len)   # k + v (+ scales) of one cached token of a head
    kv_read = sum(n_layers * batch * args.kv_heads * (pos0 + i) * token_bytes
                  for i in range(steps)) / steps
    b_ms, _ = bound_ms(w_bytes + kv_read, 0.0)
    row = {"phase": phase, "model": f"{name} shape", "kv_dtype": kv_dtype or "bf16",
           "layers": n_layers, "batch": batch, "cache_len": cache_len, "steps": steps,
           "ms_per_step": ms, "tok_s": batch / ms * 1e3, "bound_ms_per_step": b_ms,
           "bound_gb_per_step": (w_bytes + kv_read) / 1e9,
           "bound_parts_gb_per_step": {"weights": w_bytes / 1e9, "kv_read": kv_read / 1e9},
           "launches": counts, "launches_expected": want}
    if counts != want:
        emit(row)
        raise AssertionError(f"{phase}: launch counts {counts} != expected {want}")
    row["profile"] = _profile_steps(params, args, tok, cache, pos0, ms, steps=4, module=module,
                                    shares=("W4Folded", "decode_attn", "nvjet", "elementwise",
                                            "reduce_kernel"))
    emit(row)
    return counts


def _reference_state_dict(cfg: dict, seed: int):
    """An InternLM state dict in the reference's names and (out, in)
    orientation, bf16, drawn on the host from ``seed``."""
    import torch

    from accessory_tpu_torch.config import InternLMArgs
    from accessory_tpu_torch.models import internlm

    a = InternLMArgs(**cfg)
    d, hidden, v = a.hidden_size, internlm._hidden_dim(a), a.vocab_size
    g = torch.Generator().manual_seed(seed)

    def w(*shape, scale=None):
        scale = scale or shape[-1] ** -0.5
        return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16)

    sd = {"word_embeddings.weight": w(v, d, scale=1.0), "norm.weight": w(d, scale=0.1) + 1,
          "output.weight": w(v, d)}
    for i in range(a.num_layers):
        p = f"layers.{i}."
        sd.update({p + "norm1.weight": w(d, scale=0.1) + 1,
                   p + "norm2.weight": w(d, scale=0.1) + 1,
                   p + "mixer.Wqkv.weight": w(3 * d, d),
                   p + "mixer.Wqkv.bias": w(3 * d, scale=0.02),
                   p + "mixer.out_proj.weight": w(d, d),
                   p + "mixer.out_proj.bias": w(d, scale=0.02),
                   p + "mlp.w1.weight": w(hidden, d), p + "mlp.w2.weight": w(hidden, d),
                   p + "mlp.w3.weight": w(d, hidden)})
    return sd


def phase_torch_import(seed: int, n_layers: int = 2):
    """The reference's checkpoint format on the card: an InternLM-7B-width
    state dict (``n_layers`` layers, bf16, from ``seed``) split by the
    tensor-parallel dim table into a ``consolidated.00-of-02.model.pth`` /
    ``01-of-02`` pair written with torch.save, loaded with
    ``MetaModel.from_pretrained(..., quant=True)``, against a MetaModel built
    from the same tensors in memory and quantized: every leaf bit for bit,
    and identical greedy tokens (4 prompts, 16 new tokens)."""
    import os

    import torch

    from accessory_tpu_torch.checkpoint.torch_import import _merge_rule
    from accessory_tpu_torch.meta import MetaModel

    cfg = dict(INTERNLM_7B, num_layers=n_layers)
    t0 = time.perf_counter()
    sd = _reference_state_dict(cfg, seed)
    draw_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="accessory_consolidated_")
    try:
        t0 = time.perf_counter()
        shards = [{}, {}]
        for name, t in sd.items():
            rule, dim = _merge_rule(name, "internlm")
            parts = [t, t] if rule == "rep" else t.chunk(2, dim)
            for shard, part in zip(shards, parts):
                # a copy of its own: torch.save writes a view's whole storage
                shard["llma." + name] = part.clone()
        for r, shard in enumerate(shards):
            torch.save({"model": shard}, os.path.join(tmp, f"consolidated.{r:02d}-of-02.model.pth"))
        del shards
        files = {f: os.path.getsize(os.path.join(tmp, f)) for f in sorted(os.listdir(tmp))}
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = MetaModel.from_pretrained(tmp, llama_type="internlm", llama_config=[cfg],
                                           max_seq_len=256, quant=True, tokenizer=ByteTokenizer())
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def lin(name):
        mod = {"weight": sd[name + ".weight"].t().contiguous().cuda()}
        if name + ".bias" in sd:
            mod["bias"] = sd[name + ".bias"].cuda()
        return mod

    mem = MetaModel("internlm", cfg, max_seq_len=256, init_params=False)
    mem.params = {"word_embeddings": {"weight": sd["word_embeddings.weight"].cuda()},
                  "norm": {"weight": sd["norm.weight"].cuda()}, "output": lin("output"),
                  "layers": [{"norm1": {"weight": sd[f"layers.{i}.norm1.weight"].cuda()},
                              "norm2": {"weight": sd[f"layers.{i}.norm2.weight"].cuda()},
                              "mixer": {m: lin(f"layers.{i}.mixer.{m}")
                                        for m in ("Wqkv", "out_proj")},
                              "mlp": {m: lin(f"layers.{i}.mlp.{m}") for m in ("w1", "w2", "w3")}}
                             for i in range(n_layers)]}
    mem.tokenizer = ByteTokenizer()
    mem.quantize()
    del sd
    n_same = _same_params(mem.params, loaded.params)
    prompts = PROMPTS[:4]
    texts = [m.generate(prompts, max_gen_len=16) for m in (loaded, mem)]
    same = bool((loaded.generator.last_tokens == mem.generator.last_tokens).all())
    row = {"phase": "torch_import", "model": f"InternLM-7B width, {n_layers} layers",
           "format": "consolidated mp 2", "files": files, "bytes": sum(files.values()),
           "draw_s": draw_s, "save_s": save_s, "from_pretrained_s": load_s,
           "tensors_compared_bit_for_bit": n_same, "greedy_tokens_identical": same,
           "texts_equal": texts[0] == texts[1]}
    emit(row)
    if not same or texts[0] != texts[1]:
        raise AssertionError(f"torch_import: greedy tokens differ: {row}")


KERNELS = {
    "w4_matmul": ("accessory_tpu_torch/csrc/w4_matmul.cu",
                  "accessory_tpu/ops/quant_matmul_planes.py:313", "7b w13 M=8"),
    "w4_matmul_bigm": ("accessory_tpu_torch/csrc/w4_matmul_bigm.cu",
                       "accessory_tpu/ops/quant_matmul_bigm.py:93", "7b w13 M=1024"),
    "decode_attention": ("accessory_tpu_torch/csrc/decode_attention.cu",
                         "accessory_tpu/ops/decode_attention.py:123", "tiny B=4 S=192"),
    "decode_attention8": ("accessory_tpu_torch/csrc/decode_attention.cu",
                          "accessory_tpu/ops/decode_attention.py:740", "tiny B=4 S=192"),
    # _decode_attn_bloop; the (B, NKV)-grid entry _decode_attn_pallas (:327) is the same kernel here
    "decode_attention_ro": ("accessory_tpu_torch/csrc/decode_attention.cu",
                            "accessory_tpu/ops/decode_attention.py:296", "tiny B=4 S=192"),
    "decode_attention8_ro": ("accessory_tpu_torch/csrc/decode_attention.cu",
                             "accessory_tpu/ops/decode_attention.py:1106", "tiny B=4 S=192"),
    "decode_attention_mha": ("accessory_tpu_torch/csrc/decode_attention_mha.cu",
                             "accessory_tpu/ops/decode_attention.py:884", "7b B=8 S=192"),
    "decode_attention_mha8": ("accessory_tpu_torch/csrc/decode_attention_mha.cu",
                              "accessory_tpu/ops/decode_attention.py:988", "7b B=8 S=192"),
    # the same two read-only TPU entries at one query head per KV head
    "decode_attention_mha_ro": ("accessory_tpu_torch/csrc/decode_attention_mha.cu",
                                "accessory_tpu/ops/decode_attention.py:296", "7b B=8 pos=511"),
    "decode_attention_mha8_ro": ("accessory_tpu_torch/csrc/decode_attention_mha.cu",
                                 "accessory_tpu/ops/decode_attention.py:1106", "7b B=8 pos=511"),
    "flash_attention": ("accessory_tpu_torch/csrc/flash_attention.cu",
                        "accessory_tpu/ops/flash_attention.py:86", "7b B=8 S=128"),
    "kv_write": ("accessory_tpu_torch/csrc/kv_write.cu",
                 "accessory_tpu/ops/decode_attention.py:581", "7b B=8 pos=0"),
    "kv_write_q8": ("accessory_tpu_torch/csrc/kv_write.cu",
                    "accessory_tpu/ops/decode_attention.py:1291", "7b B=8 pos=0"),
    "kv_write_col": ("accessory_tpu_torch/csrc/kv_write.cu",
                     "accessory_tpu/ops/decode_attention.py:540", "tiny B=8 pos=511"),
    "kv_write_col_q8": ("accessory_tpu_torch/csrc/kv_write.cu",
                        "accessory_tpu/ops/decode_attention.py:1228", "tiny B=8 pos=511"),
    "kv_write_stacked": ("accessory_tpu_torch/csrc/kv_write.cu",
                         "accessory_tpu/ops/decode_attention.py:506", "tiny L=22 sq=128"),
    "kv_write_stacked_col": ("accessory_tpu_torch/csrc/kv_write.cu",
                             "accessory_tpu/ops/decode_attention.py:458", "tiny L=22 sq=1"),
    "kv_write_stacked_q8": ("accessory_tpu_torch/csrc/kv_write.cu",
                            "accessory_tpu/ops/decode_attention.py:1349", "tiny L=22 sq=1"),
    "paged_decode": ("accessory_tpu_torch/csrc/paged_decode.cu",
                     "accessory_tpu/ops/paged_decode.py:264", "tiny R=8 SQ=1"),
    "paged_decode8": ("accessory_tpu_torch/csrc/paged_decode.cu",
                      "accessory_tpu/ops/paged_decode.py:304", "tiny R=8 SQ=1"),
    "paged_write": ("accessory_tpu_torch/csrc/paged_write.cu",
                    "accessory_tpu/ops/paged_write.py:179", "tiny s=1"),
    # one launch quantizes, stores the values (_write_kv :179) and the scales
    # (_write_scales :222)
    "paged_write_q8": ("accessory_tpu_torch/csrc/paged_write.cu",
                       "accessory_tpu/ops/paged_write.py:222", "tiny s=1"),
    # planes_dequant (:185), its Pallas body _dequant_kernel at :162
    "w4_dequant": ("accessory_tpu_torch/csrc/w4_dequant.cu",
                   "accessory_tpu/ops/quant_matmul_bigm.py:185", "7b w1/w3"),
    # the splash kernel's custom VJP (_splash_kernel :61): JAX's bundled
    # _splash_attention_bwd_dq and _splash_attention_bwd_dkv
    "flash_attention_bwd_dq": ("accessory_tpu_torch/csrc/flash_attention_bwd.cu",
                               "accessory_tpu/ops/flash_attention.py:61", "7b B=8 S=512"),
    "flash_attention_bwd_dkdv": ("accessory_tpu_torch/csrc/flash_attention_bwd.cu",
                                 "accessory_tpu/ops/flash_attention.py:61", "7b B=8 S=512"),
    # w8_qmm :119, its Pallas body _kernel at :46
    "w8_matmul": ("accessory_tpu_torch/csrc/w8_matmul.cu",
                  "accessory_tpu/ops/quant_matmul_w8.py:119", "7b w13 M=8"),
    # _qmm :83 (entry quant_matmul_pallas :134), its Pallas body _kernel at :33
    "w4_matmul_std": ("accessory_tpu_torch/csrc/w4_matmul_std.cu",
                      "accessory_tpu/ops/quant_matmul_pallas.py:83", "tiny w13 M=8"),
    # magic_qmm :120, its Pallas body _kernel at :74
    "w4_matmul_magic": ("accessory_tpu_torch/csrc/w4_matmul_magic.cu",
                        "accessory_tpu/ops/quant_matmul_magic.py:120", "tiny w13 M=8"),
    # paged_attention_decode :414 -> JAX's bundled paged_attention (called at :431)
    "paged_decode_ro": ("accessory_tpu_torch/csrc/paged_decode.cu",
                        "accessory_tpu/engine/kvcache.py:414", "tiny R=8"),
    # ffn_qmm :121, its Pallas body _ffn_kernel at :44
    "ffn_fused": ("accessory_tpu_torch/csrc/ffn_fused.cu",
                  "accessory_tpu/ops/ffn_fused.py:121", "7b M=8"),
    # _splash_cp_kernel :46 (reached through cp_attention :77): JAX's bundled
    # splash kernel with q_seq_shards, its forward and its custom VJP
    "flash_attention_cp": ("accessory_tpu_torch/csrc/flash_attention.cu",
                           "accessory_tpu/parallel/context.py:46", "train_cp"),
    "flash_attention_cp_bwd_dq": ("accessory_tpu_torch/csrc/flash_attention_bwd.cu",
                                  "accessory_tpu/parallel/context.py:46", "train_cp"),
    "flash_attention_cp_bwd_dkdv": ("accessory_tpu_torch/csrc/flash_attention_bwd.cu",
                                    "accessory_tpu/parallel/context.py:46", "train_cp"),
}


def summary(rows, counts_by_path):
    """The kernel table. ``launches`` sums the main paths' counted runs (each
    run's counts were set to 0 just before it and read just after)."""
    out = []
    for name, (src, replaces, shape) in KERNELS.items():
        rs = rows.get(name, [])
        pick = next((r for r in rs if all(t in r["shape"].split() for t in shape.split())),
                    rs[0] if rs else None)
        out.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": sum(c.get(name, 0) for c in counts_by_path.values()),
                    "launches_by_path": {p: c.get(name, 0) for p, c in counts_by_path.items()},
                    "max_abs_err": max((r["max_abs_err"] for r in rs), default=None),
                    "ms": pick and pick["ms"], "plain_ms": pick and pick["plain_ms"],
                    "bound_ms": pick and pick["bound_ms"], "bound_by": pick and pick["bound_by"],
                    "library_ms": pick and pick["library_ms"],
                    "shape": pick and pick["shape"]})
    return {"kernels": out}


ALL_PHASES = ("device,build,kernels,parity,serve,decode,checkpoint,parity8,paged_parity,serve8,"
              "stream,stacked,batcher,batcher8,preempt,server,decode8,decode_unfused,parity7b,"
              "serve7b,decode7b,parity_w8,parity_gptq,serve7b_w8,decode7b_w8,serve_gptq,"
              "decode_gptq,serve_magic,decode_magic,serve_w3,train_parity,train_qpeft7b,"
              "train_full,finetune,parity_ffn,serve_ffn,decode_ffn,decode7b_ffn,paged_ro,"
              "cp_shards,train_cp,parity_moe,serve_moe,decode_moe,batcher_moe,parity_zoo,"
              "serve_falcon40b,decode_falcon40b,serve_internlm7b,decode_internlm7b,torch_import")
TINY_MODEL_PHASES = ("serve", "decode", "checkpoint", "serve8", "stream", "stacked", "batcher",
                     "batcher8", "preempt", "server", "decode8", "decode_unfused", "serve_ffn",
                     "decode_ffn")


def _add_counts(total, counts):
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n



def main() -> int:
    global _out_file
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=ALL_PHASES)
    ap.add_argument("--out", default=None, help="also append every JSON line to this file")
    ap.add_argument("--kernel_names", default=None,
                    help="kernels and compare phases: only the rows of these kernels "
                         "(comma-separated)")
    opts = ap.parse_args()
    phases = opts.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from accessory_tpu_torch import kernels  # noqa: F401  (fails outside the repo)
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.quant.qtensor import to_magic_layout
    from accessory_tpu_torch.quant.quantize import quantize_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if opts.out:
        _out_file = open(opts.out, "a")
    t_start = time.perf_counter()
    try:
        smi = phase_device()
        if "build" in phases:
            phase_build()
        rows, counts_by_path = {}, {}
        if "kernels" in phases:
            rows = phase_kernels(opts.seed, opts.kernel_names and opts.kernel_names.split(","))
            emit({"phase": "timing", "empty_traces_retried": _empty_traces,
                  "short_traces": _short_traces,
                  "seconds_so_far": round(time.perf_counter() - t_start, 1)})
        if "parity" in phases:
            phase_parity(opts.seed, "parity", TINYLLAMA, 2, b=2, plen=64, steps=16, s_len=128)
        if "parity8" in phases:
            phase_parity(opts.seed, "parity8", TINYLLAMA, 2, b=2, plen=64, steps=16, s_len=128,
                         kv_dtypes=("int8",))
            phase_parity(opts.seed, "parity8", TINYLLAMA, 2, b=2, plen=64, steps=8, s_len=128,
                         kv_dtypes=(None, "int8"), stacked=True)
        if "paged_parity" in phases:
            phase_paged_parity(opts.seed)
        if "parity_ffn" in phases:
            phase_parity_ffn(opts.seed)
        if "paged_ro" in phases:
            counts_by_path["paged ro"] = phase_paged_ro(opts.seed)
        if any(ph in phases for ph in TINY_MODEL_PHASES):
            model, setup_s, _ = _quantized_model(TINYLLAMA, 512, opts.seed)
            if "serve" in phases:
                counts_by_path["tiny"] = phase_serve("serve", model, setup_s)[0]
            if "decode" in phases:
                phase_decode("decode", model, None, steps=100)
            if "checkpoint" in phases:
                # from here on the paths run the weights that came back from the file
                loaded = phase_checkpoint(model)
                del model
                model = loaded
                torch.cuda.empty_cache()
            if "serve8" in phases:
                counts_by_path["tiny int8"] = phase_serve("serve8", model, setup_s, "int8")[0]
            if "stream" in phases:
                counts_by_path["stream"] = phase_stream(model)
            if "stacked" in phases:
                counts_by_path["stacked"] = phase_stacked(model)
            if "batcher" in phases:
                counts_by_path["batcher"] = phase_batcher("batcher", model, None)
            if "batcher8" in phases:
                counts_by_path["batcher int8"] = phase_batcher("batcher8", model, "int8")
            if "preempt" in phases:
                counts_by_path["batcher options"] = phase_preempt(model)
            if "server" in phases:
                counts_by_path["server"] = phase_server(model)
            bench = {}
            if "decode8" in phases:
                model.kv_dtype = "int8"
                model._reset_generator()
                _add_counts(bench, phase_decode("decode8", model, "int8", steps=100))
            if "decode_unfused" in phases:
                for kv_dtype in (None, "int8"):
                    model.kv_dtype = kv_dtype
                    model._reset_generator()
                    _add_counts(bench, phase_decode("decode_unfused", model, kv_dtype, steps=100,
                                                    fused_attn_write=False))
            if bench:
                counts_by_path["tiny bench"] = bench
            if "serve_ffn" in phases:
                counts_by_path["tiny ffn"] = phase_serve_ffn(model, setup_s)
            if "decode_ffn" in phases:
                # in turns with the unfused route (fused, unfused, unfused, fused)
                bench = {}
                model.kv_dtype = None
                model._reset_generator()
                for fuse in (True, False, False, True):
                    counts = phase_decode("decode_ffn", model, None, steps=100, ffn_fuse=fuse)
                    if fuse:
                        _add_counts(bench, counts)
                counts_by_path["tiny ffn bench"] = bench
            del model
            torch.cuda.empty_cache()
        if "parity7b" in phases:
            phase_parity(opts.seed, "parity7b", LLAMA2_7B, 2, b=8, plen=128, steps=4, s_len=192,
                         kv_dtypes=(None, "int8"))
        if "serve7b" in phases:
            model, counts_by_path["7b"] = phase_serve7b(opts.seed)
            if "decode7b" in phases:
                # in turns (bf16, int8, int8, bf16), so a drift of the host's
                # speed during the phase does not favour one cache type
                for kv_dtype in (None, "int8", "int8", None):
                    model.kv_dtype = kv_dtype
                    model._reset_generator()
                    phase_decode("decode7b", model, kv_dtype, steps=50)
                bench = {}
                for kv_dtype in (None, "int8"):
                    model.kv_dtype = kv_dtype
                    model._reset_generator()
                    _add_counts(bench, phase_decode("decode7b", model, kv_dtype, steps=20,
                                                    fused_attn_write=False))
                counts_by_path["7b unfused"] = bench
            if "decode7b_ffn" in phases:
                bench = {}
                model.kv_dtype = None
                model._reset_generator()
                for fuse in (True, False, False, True):
                    counts = phase_decode("decode7b_ffn", model, None, steps=50, ffn_fuse=fuse)
                    if fuse:
                        _add_counts(bench, counts)
                counts_by_path["7b ffn"] = bench
            del model
            torch.cuda.empty_cache()
        if "parity_w8" in phases:
            phase_parity(opts.seed, "parity_w8", TINYLLAMA, 2, b=2, plen=64, steps=16, s_len=128,
                         make_params=lambda a: quantize_params(
                             llama.init_params(a, seed=opts.seed), bits=8), label="W8")
        if "parity_gptq" in phases:
            phase_parity_gptq(opts.seed)
        if "serve7b_w8" in phases:
            model, counts_by_path["7b w8"] = phase_serve7b(opts.seed, bits=8, phase="serve7b_w8")
            if "decode7b_w8" in phases:
                model.kv_dtype = None
                model._reset_generator()
                counts_by_path["7b w8 bench"] = phase_decode("decode7b_w8", model, None,
                                                             steps=50, matmul="w8_matmul")
            del model
            torch.cuda.empty_cache()
        if any(ph in phases for ph in ("serve_gptq", "decode_gptq", "serve_magic",
                                       "decode_magic")):
            model, setup_s = _gptq_model(opts.seed)
            if "serve_gptq" in phases:
                counts_by_path["gptq"] = phase_serve("serve_gptq", model, setup_s,
                                                     matmul="w4_matmul_std")[0]
            if "decode_gptq" in phases:
                counts_by_path["gptq bench"] = phase_decode("decode_gptq", model, None,
                                                            steps=100, matmul="w4_matmul_std")
            _map_weights(model.params, to_magic_layout)
            model._reset_generator()
            if "serve_magic" in phases:
                counts_by_path["magic"] = phase_serve("serve_magic", model, setup_s,
                                                      matmul="w4_matmul_magic")[0]
            if "decode_magic" in phases:
                counts_by_path["magic bench"] = phase_decode("decode_magic", model, None,
                                                             steps=100,
                                                             matmul="w4_matmul_magic")
            del model
            torch.cuda.empty_cache()
        if "serve_w3" in phases:
            model, setup_s, _ = _quantized_model(TINYLLAMA, 512, opts.seed, bits=3)
            counts_by_path["w3"] = phase_serve("serve_w3", model, setup_s, matmul=None,
                                               max_gen_len=8)[0]
            del model
            torch.cuda.empty_cache()
        if "train_parity" in phases:
            counts_by_path["train parity"] = phase_train_parity(opts.seed)
        if "train_qpeft7b" in phases:
            counts_by_path["train qpeft7b"] = phase_train(
                "train_qpeft7b", dict(LLAMA2_7B, **QPEFT), opts.seed, 8, 512, qpeft=True,
                lr=1e-3)
        if "train_full" in phases:
            counts_by_path["train full"] = phase_train("train_full", LLAMA_700M, opts.seed, 2,
                                                       2048, qpeft=False, lr=1e-4)
        if "finetune" in phases:
            counts_by_path["finetune"] = phase_finetune(opts.seed)
        if "compare" in phases:
            phase_compare(opts.seed, opts.kernel_names and opts.kernel_names.split(","))
        if "cp_shards" in phases:
            counts_by_path["cp shards"] = phase_cp_shards(opts.seed)
        if "train_cp" in phases:
            counts_by_path["train cp"] = phase_train_cp(opts.seed)
        if "parity_moe" in phases:
            phase_parity_moe(opts.seed)
        if any(ph in phases for ph in ("serve_moe", "decode_moe", "batcher_moe")):
            # Mixtral-8x7B W4 (~27 GB) on the card: every earlier model is freed
            gc.collect()
            torch.cuda.empty_cache()
            model, counts_by_path["mixtral"] = phase_serve_moe(opts.seed)
            if "decode_moe" in phases:
                bench = {}
                for kv_dtype in (None, "int8"):
                    model.kv_dtype = kv_dtype
                    model._reset_generator()
                    _add_counts(bench, phase_decode_moe(model, kv_dtype))
                counts_by_path["mixtral bench"] = bench
            if "batcher_moe" in phases:
                counts_by_path["mixtral batcher"] = phase_batcher_moe(model)
            del model
            torch.cuda.empty_cache()
        if "parity_zoo" in phases:
            phase_parity_zoo(opts.seed)
        for name in ("Falcon-40B", "InternLM-7B"):
            tag = name.lower().replace("-", "")
            if f"serve_{tag}" not in phases and f"decode_{tag}" not in phases:
                continue
            # the full-width W4 model on the card: every earlier model is freed
            gc.collect()
            torch.cuda.empty_cache()
            model, counts_by_path[tag] = phase_serve_zoo(name, opts.seed)
            if f"decode_{tag}" in phases:
                bench = {}
                for kv_dtype in (None, "int8"):
                    model.kv_dtype = kv_dtype
                    model._reset_generator()
                    _add_counts(bench, phase_decode_zoo(name, model, kv_dtype))
                counts_by_path[tag + " bench"] = bench
            del model
            torch.cuda.empty_cache()
        if "torch_import" in phases:
            phase_torch_import(opts.seed)
            gc.collect()
            torch.cuda.empty_cache()
        if set(ALL_PHASES.split(",")) <= set(phases):
            idle = [n for n in KERNEL_NAMES
                    if not sum(c.get(n, 0) for c in counts_by_path.values())]
            if idle:
                raise AssertionError(f"kernels never launched on a main path: {idle}")
        emit({"phase": "total", "seconds": round(time.perf_counter() - t_start, 1)})
        print(smi, flush=True)
        emit(summary(rows, counts_by_path))
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
    finally:
        if _out_file is not None:
            _out_file.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
