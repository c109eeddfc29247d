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
                                               finetune,pretrain,parity_ffn,serve_ffn,
                                               decode_ffn,
                                               decode7b_ffn,paged_ro,cp_shards,train_cp,
                                               parity_moe,serve_moe,decode_moe,batcher_moe,
                                               train_moe,
                                               parity_zoo,serve_falcon40b,decode_falcon40b,
                                               serve_internlm7b,decode_internlm7b,
                                               torch_import,parity_sphinx,serve_sphinx,
                                               score,parity_adapter,serve_adapter,
                                               parity_sphinx_moe,serve_sphinx_moe,
                                               train_sphinx_moe,train_mm]
                          [--out FILE] [--kernel_names w8_matmul,w4_matmul_std,...]
    python3 chip_smoke.py --phases device,build,compare   (parent / change timing)

Phases, each printing JSON lines (any failure raises and exits non-zero):
  device    the card (nvidia-smi name and power limit), torch and CUDA versions;
  build     compiles every kernel in accessory_tpu_torch/csrc with nvcc;
  kernels   each kernel against its plain PyTorch version on CUDA tensors at
            the main paths' shapes (TinyLlama-1.1B, LLaMA2-7B, Mixtral-8x7B,
            Falcon-40B, InternLM-7B, SPHINX-7B, LLaMA-Adapter, SPHINX-MoE and
            the image training step, the last seven tagged "mixtral",
            "falcon40b", "internlm7b", "sphinx", "adapter", "sphinx_moe" and
            "train_mm"): max error,
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
            a profiled step split by kernel with the device's idle share; then
            one step under remat True beside one under "full" (the same loss
            and grad_norm, 32 flash forwards a step against 64, ms and peak);
  train_full  the 700M-class full finetune (dim 2048, 12 layers, 16 / 8 heads,
            batch 2 x 2048, f32 masters, AdamW on every leaf), the same figures
            (remat True beside "full" too);
  finetune  main_finetune.main at tiny size: a generated alpaca JSON through a
            YAML META config and the byte tokenizer, one epoch with --quant
            --only_save_trainable, the optimizer state read back bit for bit,
            and a second call that resumes for the next epoch;
  pretrain  main_pretrain.main over packed shards the port's tool writes
            (native.pack_stream's C library asserted): TinyLlama at full width
            and depth, bf16, 2 x 2048, --checkpointing: ms an iteration,
            tokens/s, c_loss, peak, launches exact, a profiled iteration; then
            a 2-layer leg with a save, validation and a resume (iteration,
            step and the dataset's position carried over);
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
  train_moe  that model trained with the MoE loss: 2 layers CPU vs card on 64
            tokens (the card on the CPU's routing), then 1 warm-up and 2 steps
            at full depth on 1 x 2048, remat "full", every dense leaf trained:
            ms, tokens/s, metrics, peak, a profiled step, launches exact to
            the recorded routing, the recompute's routing against the
            forward's;
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
  parity_sphinx  SPHINX at production widths (the four towers at full width, 2
            blocks each, ConvNeXt-XXL depths 1, 1, 1, 1; 2 decoder layers of
            LLaMA2-7B width, W4), one 448-px image: the card against the CPU,
            each tower's f32 features and the Q-Former's (1e-4 relative L2, 1e-3
            of the largest |value|; TF32 off, the depthwise convolution outside
            cuDNN), encode_image's bf16 tokens, the 1487-row prefill and 4
            decode steps at positions shifted by the 1455 image words (parity's
            logit gate);
  serve_sphinx  SPHINX-7B (llama_ens5, 448 px, 5 crops, 1455 image words;
            LLaMA2-7B W4 g128 drawn on the card from --seed, the production
            towers in f32): sphinx_api.batch_caption of 8 images (normal noise
            as CLIP-normalized pixels: no PIL on the machine) with 32 new
            tokens, then SPHINXModel.generate_response on one, launch counts
            exact; encode_image ms by tower, the prefill (8 x 1711 rows), a
            decode step's ms, device time by kernel and idle share, setup s,
            peak GB; each counted run's decode ms on CUDA events and its tok/s;
  score     (A4) evaluate_examples on SPHINX-7B: six text examples batched
            against each scored alone from compute_logits (5e-3 of |ll|; a
            planted mask fault must read above it; max_equal equal), two
            examples with an image; launches counted;
  parity_adapter  LLaMA-Adapter at TinyLlama width, 2 layers, the prefix (10
            tokens) on the last, gates drawn nonzero, W4: parity's gate over the
            stacked cache (prefill and 16 decode steps), then the cache-free
            forward(images=) through a narrow visual branch;
  serve_adapter  LLaMA-Adapter at LLaMA2-7B widths (prefix 10 on the last 30
            layers, the published adapter's), W4 drawn from --seed: the 8
            prompts and 32 new tokens through MetaModel.generate (the stacked
            route), then batch 8 over a 1024-token stacked cache from position
            512: prefill ms, ms a step, tok/s, busy and idle; launches exact;
  parity_sphinx_moe  a narrow SPHINX-MoE (2 layers, 4 experts, narrow
            towers, ens5: 1455 image words): image tokens, then the prefill
            and 8 decode steps CPU vs card, routing compared (a flip's gap
            within twice the router scores' noise where no flip reaches);
  serve_sphinx_moe  SPHINX-MoE (mixtral_sparse_ens5: Mixtral-8x7B W4 drawn
            on the card and the production towers in f32): batch_caption of 8
            images, 32 new tokens; the time to first token split into the
            towers and the 13688-row prefill (row 5's share of its device
            time), decode ms a step, busy and idle, peak GB; the W4 launches
            from the recorded routing;
  train_sphinx_moe  that model's image step with the MoE loss, its decoder
            cut to 8 layers, 1 x (1455 + 64) rows (as train_moe); then a
            narrow SPHINX-MoE (2 layers) image step CPU vs card;
  train_mm  one image training step at small width (llama_ens, TinyLlama
            width, narrow towers) CPU vs card, loss and gradients; then the
            SPHINX-7B QPEFT image step at full width, 4 x (1455 + 512) rows:
            ms a step, peak GB, the step split by kernel, launches exact;
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
# Falcon-7B (huggingface.co/tiiuae/falcon-7b config.json): 71 query heads of
# 64 over one KV head (multi_query), one input_layernorm feeding both
# branches (parallel_attn), no new_decoder_architecture
FALCON_7B = dict(num_layers=32, hidden_size=4544, num_attention_heads=71, multi_query=True,
                 new_decoder_architecture=False, parallel_attn=True, bias=False,
                 vocab_size=65024, layer_norm_epsilon=1e-5, dtype="bfloat16")
INTERNLM_7B = dict(num_layers=32, hidden_size=4096, num_attention_heads=32, mlp_ratio=8 / 3,
                   multiple_of=256, norm_type="rmsnorm", layer_norm_epsilon=1e-6, bias=True,
                   vocab_size=103168, dtype="bfloat16")
# their W4 products (name, K, N) where the LLaMA2-7B rows do not already
# hold the shape (InternLM's out_proj is 7B's wo; its w3's K 11008 is padded
# to 11264 in the weight)
FALCON_PROJ = [("wq/dense", 8192, 8192), ("wk/wv", 8192, 512), ("h_to_4h", 8192, 32768),
               ("4h_to_h", 32768, 8192)]
# Falcon-7B's one W4 product: quantize_params takes a leaf whose in_dim is a
# multiple of the group, and 4544 is not, so only dense_4h_to_h (in 18176,
# padded to 18432 in the weight; N 4544, half a 128-column tile past 35)
FALCON7B_PROJ = [("4h_to_h", 18176, 4544)]
INTERNLM_PROJ = [("Wqkv", 4096, 12288), ("w1/w2", 4096, 11008), ("w3", 11008, 4096)]
# Mixtral's quantized products (name, K, N): the attention projections and
# one expert's
MIXTRAL_PROJ = [("wq/wo", 4096, 4096), ("wk/wv", 4096, 1024), ("w1/w3", 4096, 14336),
                ("w2", 14336, 4096)]
# LLaMA-Adapter at LLaMA2-7B's widths with the published adapter's
# adapter_len 10 and adapter_layer 30 (prefix_len, prefix_layers), served at
# batch 8
ADAPTER_7B = dict(LLAMA2_7B, prefix_len=10, prefix_layers=30)
ADAPTER_BATCH = 8
# the image training step (train_mm): SPHINX-7B (llama_ens5) QPEFT, 4
# examples of 1455 image words and 512 text tokens
TRAIN_MM_BATCH, TRAIN_MM_TEXT = 4, 512
TRAIN_MM_ROWS = TRAIN_MM_BATCH * (1455 + TRAIN_MM_TEXT)
# train_moe: Mixtral-8x7B at 1 x 2048 tokens a step; pretrain: TinyLlama at
# 2 x 2048
TRAIN_MOE_ROWS = 2048
PRETRAIN_BATCH, PRETRAIN_WORDS = 2, 2048
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


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print a JSON line (a phase's line carries "t", the script's seconds so
    far) and append it to --out."""
    if "phase" in obj:
        obj = dict(obj, t=round(time.perf_counter() - _T0, 1))
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
    of every kernel the calls launched, the median of ``repeats`` traces,
    with the retakes of traces that lose kernel events
    (``util.profiling.kernel_ms``, which counts them in its ``retakes``).
    ``by``: kernel-name substrings; then {substring: ms per call}."""
    from accessory_tpu_torch.util import profiling

    return profiling.kernel_ms(fn, arg_sets, min_iters, repeats, by)


def yardstick_ms(fn, arg_sets, min_iters: int = 30) -> float:
    """``time_ms`` from one trace (no median of three): the plain version's
    and the library call's times beside a kernel's, which are yardsticks and
    not the measurement a row stands for."""
    return time_ms(fn, arg_sets, min_iters, repeats=1)


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
        """One row; a row checked but not timed (``k_ms`` None: a duplicate
        shape of a design whose times PERF.md holds) says so with "timed"."""
        b_ms, b_by = bound_ms(nbytes, flops, rate)
        row = {"kernel": kernel, "shape": shape, "max_abs_err": err[0], "max_rel_err": err[1],
               "ms": k_ms, "wall_ms": k_wall, "plain_ms": p_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
               **({"timed": False} if k_ms is None else {}), **extra}
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


def _kernels_w4(kr, tag, specs, ms, rope, untimed=()):
    """planes_qmm (GEMV for M <= 16, the many-row tile above) with its
    fusions; the GEMV's cluster split and the tile's K split checked
    (``_split_check``). Row counts in ``untimed`` are checked, not timed."""
    import torch

    from accessory_tpu_torch.ops import w4_tile
    from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm, planes_qmm_plain

    for m in ms:
        for name, k, n, fusion in specs:
            sets, nbytes = _w4_weight_sets(kr, m, k, n, fusion, rope,
                                           copies=1 if m in untimed else None)
            a0 = sets[0][0]
            got = planes_qmm(**a0)
            want = planes_qmm_plain(**a0)
            torch.cuda.synchronize()
            check_close(f"w4_matmul {tag} {name} M={m}", got, want, rtol=2e-2, atol=2e-2)
            split = (w4_tile.folded_gemv_split(n, k) if m <= 16 else
                     w4_tile.folded_plan(m, n, k, 128).split)
            extra = _split_check(f"w4_matmul {tag} {name} M={m}", split, got, want,
                                 lambda sp: planes_qmm(**a0, split=sp))
            k_ms = k_wall = p_ms = lib_ms = None
            if m not in untimed:
                k_ms = time_ms(lambda a: planes_qmm(**a), [(s[0],) for s in sets])
                k_wall = wall_ms(lambda a: planes_qmm(**a), [(s[0],) for s in sets])
                p_ms = yardstick_ms(lambda a: planes_qmm_plain(**a), [(s[0],) for s in sets[:1]],
                                    min_iters=3)
                lib_ms = yardstick_ms(lambda x, d: torch.matmul(x, d),
                                      [(s[0]["x2d"], s[1]) for s in sets])
            kr.record("w4_matmul", f"{tag} {name} M={m} K={k} N={n} {fusion}",
                      max_err(got, want), k_ms, k_wall, p_ms, lib_ms, nbytes, 2.0 * m * k * n,
                      **extra)
            del sets


def _kernels_bigm(kr, specs, tag="7b", untimed=()):
    """planes_qmm_bigm at the 7B prefill's 1024 rows, the QPEFT step's 8 x 512
    = 4096 and one ragged row count, beside row 1's many-row tile
    (w4_matmul.cu, M > 16) on the same inputs: its C entry is called directly
    (``_kernel_call``, not counted), since planes_qmm refuses M >= 1024. Two
    launches, and a launch on another persistent grid (61 blocks), give the
    same bits (no K split: one f32 sum an output, whatever the grid). Row
    counts in ``untimed`` are checked, not timed."""
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
        sets, nbytes = _w4_weight_sets(kr, m, k, n, "", none_rope,
                                       copies=1 if m in untimed else None)
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
        k_ms = k_wall = t_ms = p_ms = lib_ms = None
        if m not in untimed:
            k_ms = time_ms(lambda a: planes_qmm_bigm(**a), calls)
            k_wall = wall_ms(lambda a: planes_qmm_bigm(**a), calls)
            t_ms = time_ms(lambda a: tile_kernel(**a), calls)
            p_ms = yardstick_ms(lambda a: planes_qmm_bigm_plain(**a), calls[:1], min_iters=3)
            lib_ms = yardstick_ms(lambda x, d: torch.matmul(x, d),
                                  [(s[0]["x2d"], s[1]) for s in sets])
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
                    separate=False, untimed=()):
    """One decode-attention entry over the bf16 or the int8 cache, fused with
    the write (decode_attention_update[8]) or read-only (cached_attention_t[8]
    at one token): the GQA kernel (nq > nkv) or the one-query-head kernel, by
    the wrapper's own dispatch. The library yardstick is SDPA, for int8 over a
    cache dequantized to bf16 beforehand (its dequantization is not timed). A
    read-only row with pos < S also holds the unfused route (read-only
    attention + one-token write) against the fused kernel: pools equal,
    outputs inside the kernel tolerance. ``separate``: q, k_new and v_new are
    contiguous tensors of their own instead of views of one wqkv output.
    Cases in ``untimed`` are checked, not timed."""
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
                for _ in range(1 if (b, s_len, pos) in untimed else n_copies(nbytes, most_copies))]
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
        k_ms = k_wall = p_ms = lib_ms = None
        lib_sets = []
        if (b, s_len, pos) not in untimed:
            k_ms = time_ms(lambda *a: fn(*a, pos), sets)
            k_wall = wall_ms(lambda *a: fn(*a, pos), sets)
            p_ms = yardstick_ms(lambda *a: plain(*a, pos), sets[:1], min_iters=5)
            mask = (torch.arange(s_len, device="cuda") <= min(pos, s_len - 1))[None]
            if int8:
                lib_sets = [(s_[0].transpose(1, 2),
                             (s_[3].float() * s_[5][..., None]).to(torch.bfloat16),
                             (s_[4].float() * s_[6][..., None]).to(torch.bfloat16))
                            for s_ in sets[:2]]
            else:
                lib_sets = [(s_[0].transpose(1, 2), s_[3], s_[4]) for s_ in sets]
            lib_ms = yardstick_ms(lambda qq, kk, vv: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask, enable_gqa=r > 1), lib_sets)
        dp = da.decode_plan(b, nkv, s_len, r, hd)
        plan = {} if r == 1 else {"row_tiles": da.row_tiles(r, hd), "split": dp.split,
                                  "blocks": dp.blocks}
        kr.record(kernel, f"{tag} B={b} NKV={nkv} R={r} HD={hd} S={s_len} pos={pos}"
                  + (" separate-qkv" if separate else ""),
                  max_err(out_g, out_w), k_ms, k_wall, p_ms, lib_ms, nbytes, flops,
                  out_sha=sha, **plan)
        del sets, lib_sets


def _kernels_pos_dev(kr):
    """Every static decode entry and one-token write with its position a 0-d
    int32 tensor on the card, as a captured decode step passes it: the
    outputs and the written pools bit-equal to the same launch at the int
    position, bf16 and int8 caches. One shape a decode entry is timed (the
    int position's times are the kernel table's) against its plain version;
    the writes and Falcon-7B's R 71 are checked, not timed."""
    import torch

    from accessory_tpu_torch.ops import decode_attention as da

    cases = [("tiny", 32, 4, 64, 8, 1024, 511, True), ("falcon7b", 71, 1, 64, 8, 1024, 511, False),
             ("7b", 32, 32, 128, 8, 1024, 511, True)]
    for tag, nq, nkv, hd, b, s_len, pos, timed in cases:
        r = nq // nkv
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        for int8 in (False, True):
            for write in (True, False):
                kernel = ("decode_attention_mha" if r == 1 else "decode_attention") \
                    + ("8" if int8 else "") + ("" if write else "_ro")
                if write:
                    fn = da.decode_attention_update8 if int8 else da.decode_attention_update
                    plain = (da.decode_attention_update8_plain if int8
                             else da.decode_attention_update_plain)
                else:
                    fn = da.cached_attention_t8 if int8 else da.cached_attention_t
                    plain = (da.cached_attention_decode8_plain if int8
                             else da.cached_attention_decode_plain)
                tok_bytes = hd + 4 if int8 else 2 * hd
                nbytes = 2 * b * nkv * pos * tok_bytes + b * (nq + 2 * nkv) * hd * 2 \
                    + b * nq * hd * 2 + (2 * b * nkv * tok_bytes if write else 0)
                # the timed shape round-robins copies past L2, as the int rows do
                sets = [_qkv_views(kr, b, nq, nkv, hd)
                        + (_int8_pools(kr, b, nkv, s_len, hd) if int8
                           else (kr.randn(b, nkv, s_len, hd), kr.randn(b, nkv, s_len, hd)))
                        for _ in range(n_copies(nbytes, 4 if r == 1 else 32) if timed else 1)]
                qkv, pools = sets[0][:3], sets[0][3:]
                a = tuple(p.clone() for p in pools)
                c = tuple(p.clone() for p in pools)
                got_int = fn(*qkv, *a, pos)
                got_dev = fn(*qkv, *c, pos_t)
                want_ = plain(*qkv, *(p.clone() for p in pools), pos)
                torch.cuda.synchronize()
                out_i = got_int[0] if write else got_int
                out_d = got_dev[0] if write else got_dev
                out_w = want_[0] if write else want_
                name = f"{kernel} {tag} B={b} S={s_len} pos={pos} pos-on-card"
                if not (torch.equal(out_i, out_d) and all(torch.equal(x, y)
                                                          for x, y in zip(a, c))):
                    raise AssertionError(f"{name}: the position on the card gave other bits "
                                         "than the int position")
                k_ms = p_ms = None
                if timed:
                    k_ms = time_ms(lambda *x: fn(*x, pos_t), sets)
                    p_ms = yardstick_ms(lambda *x: plain(*x, pos), sets[:1], min_iters=5)
                kr.record(kernel, f"{tag} B={b} NKV={nkv} R={r} HD={hd} S={s_len} pos={pos} "
                          "pos-on-card", max_err(out_d, out_w), k_ms, None, p_ms, None, nbytes,
                          4.0 * b * nq * (pos + 1) * hd, bits_equal_int_pos=True)
    # the one-token writes: per layer (rows 10, 16) and stacked (row 11, write_kv_t8)
    for stacked in (False, True):
        for int8 in (False, True):
            lead = (22, 8) if stacked else (8,)
            nk = kr.randn(*lead, 1, 4, 64)
            nv = kr.randn(*lead, 1, 4, 64)
            if int8:
                pools = (torch.zeros(*lead, 4, 1024, 64, dtype=torch.int8, device="cuda"),) * 2 \
                    + (torch.zeros(*lead, 4, 1024, device="cuda"),) * 2
            else:
                pools = (torch.zeros(*lead, 4, 1024, 64, dtype=torch.bfloat16, device="cuda"),) * 2
            fn = {(False, False): da.write_kv_layer, (False, True): da.write_kv_layer8,
                  (True, False): da.write_kv_t, (True, True): da.write_kv_t8}[(stacked, int8)]
            a = tuple(p.clone() for p in pools)
            c = tuple(p.clone() for p in pools)
            fn(*a, nk, nv, 511)
            fn(*c, nk, nv, torch.tensor(511, dtype=torch.int32, device="cuda"))
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(a, c)):
                raise AssertionError(f"{fn.__name__}: the position on the card wrote other "
                                     "bits than the int position")
    emit({"phase": "kernels", "check": "one-token writes with the position on the card",
          "bits_equal_int_pos": True})


def _kernels_gate(kr):
    """Row 1's GEMV at Mixtral's expert w1 / w3 (4096 -> 14336) and w2 (14336
    -> 4096), M 8, with the gate set (bits equal to the ungated launch) and
    cleared (zeros out, the weight read nowhere): device time of both."""
    import torch

    from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm, planes_qmm_plain

    on = torch.tensor(1, dtype=torch.int32, device="cuda")
    off = torch.tensor(0, dtype=torch.int32, device="cuda")
    for name, k, n in (("w1/w3", 4096, 14336), ("w2", 14336, 4096)):
        sets, _ = _w4_weight_sets(kr, 8, k, n, "", (None, None, "", 0))
        a = dict(sets[0][0])
        ungated = planes_qmm(**a)
        gated = planes_qmm(**a, gate=on)
        cleared = planes_qmm(**a, gate=off)
        plain = planes_qmm_plain(**a)
        torch.cuda.synchronize()
        if not torch.equal(ungated, gated) or bool(cleared.ne(0).any()):
            raise AssertionError(f"w4_matmul gate {name}: a set gate changed the bits, or a "
                                 "cleared one left a nonzero")
        wbytes = sum(t.numel() * t.element_size() for t in (a["packed"], a["scales"], a["zs"]))
        for label, g in (("set", on), ("cleared", off)):
            k_ms = time_ms(lambda aa, g=g: planes_qmm(**aa, gate=g), [(s[0],) for s in sets])
            p_ms = yardstick_ms(lambda aa: planes_qmm_plain(**aa), [(sets[0][0],)], min_iters=3) \
                if label == "set" else None
            nbytes = (wbytes + 8 * k * 2 if label == "set" else 0) + 8 * n * 2
            kr.record("w4_matmul", f"mixtral {name} K={k} N={n} M=8 gate {label}",
                      max_err(gated if label == "set" else cleared,
                              plain if label == "set" else torch.zeros_like(plain)),
                      k_ms, None, p_ms, None, nbytes, 2.0 * 8 * k * n if label == "set" else 0)


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
        p_ms = yardstick_ms(lambda *a: grouped_attention(*a, causal=True), sets[:1], min_iters=5)
        lib_ms = yardstick_ms(lambda qq, kk, vv: F.scaled_dot_product_attention(
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
        p_ms = yardstick_ms(lambda *a: write_kv_layer_plain(*a, pos), sets)
        lib_ms = yardstick_ms(
            lambda ck, cv, nk, nv: (ck[:, :, pos:pos + sq].copy_(nk.transpose(1, 2)),
                                    cv[:, :, pos:pos + sq].copy_(nv.transpose(1, 2))), sets)
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
        p_ms = yardstick_ms(lambda *a: write_kv_layer8_plain(*a, pos), sets)
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
    p_ms = yardstick_ms(lambda *a: plain(*a, pos), sets)
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
    p_ms = yardstick_ms(plain, sets[:1], min_iters=3)
    mask = (torch.arange(pps * ps, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    lib_sets = []
    for s_ in sets[:4]:
        kd, vd = gather_pages(s_[3][0], s_[4][0], table, None,
                              *((s_[5][0], s_[6][0]) if int8 else (None, None)))
        lib_sets.append((s_[0].transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2)))
    lib_ms = yardstick_ms(lambda qq, kk, vv: F.scaled_dot_product_attention(
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
    p_ms = yardstick_ms(plain, sets)
    lib_ms = None
    if not int8:
        page, off = token_slots(table, start, s, ps)                 # (b * s,)
        lh = torch.arange(n_layers * nkv, device="cuda")[:, None]   # (l, h) pairs
        rows = ((lh * n_pages + page[None, :]) * ps + off[None, :])  # (L * nkv, b * s)
        rows = rows.reshape(n_layers, nkv, b * s).transpose(1, 2).reshape(-1)
        vals = [t.reshape(n_layers, b * s, nkv, hd).reshape(-1, hd) for t in (kn, vn)]
        lib_ms = yardstick_ms(
            lambda kp, vp, *_: (kp.view(-1, hd).index_put_((rows,), vals[0]),
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
        p_ms = yardstick_ms(lambda p, sc, z: dequantize_weight(_folded_from((p, sc, z), k, n)),
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
        p_ms = yardstick_ms(flash_attention_bwd_plain, sets[:1], min_iters=3)
        q, k, v, _, dout, _ = sets[0]
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = dout.transpose(1, 2)
        lib_ms = yardstick_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True),
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
            p_ms = yardstick_ms(lambda *a: grouped_attention(*a, causal=True, q_offset=q0), sets,
                                min_iters=3)
            lib_ms = yardstick_ms(lambda *a: _masked_sdpa(*a, q0), sets, min_iters=10)
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
            pb_ms = yardstick_ms(flash_attention_bwd_plain, [(q, k, v, out, dout, lse, None, q0)],
                                 min_iters=3)
            qt, kt, vt = (t.detach().requires_grad_(True) for t in (q, k, v))
            o = _masked_sdpa(qt, kt, vt, q0)
            dot = dout.transpose(1, 2)
            lb_ms = yardstick_ms(
                lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True), [()],
                min_iters=10)
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
        p_ms = yardstick_ms(lambda a: w8_qmm_plain(**a), calls[:1], min_iters=3)
        lib_ms = yardstick_ms(lambda x, d: torch.matmul(x, d), [(s[0]["x2d"], s[1]) for s in sets])
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


def _kernels_w4elem(kr, tag, specs, untimed=()):
    """quant_matmul_pallas (std W4, GPTQ zeros) and magic_qmm (the magic words
    of the same weight) at the GPTQ serve paths' shapes; the GEMV's cluster
    split and the many-row tile's K split checked (``_split_check``). A spec
    (name, K, N, M[, Kx]): Kx < K is x narrower than a padded in_dim. Row
    counts in ``untimed`` are checked, not timed."""
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
               for _ in range(1 if m in untimed else
                              n_copies(k * n / 2 + 2 * (k // 128) * n * 4 + io_bytes))]
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
            k_ms = k_wall = p_ms = lib_ms = None
            dense = []
            if m not in untimed:
                dense = [(x, dense_weight(q, torch.bfloat16)[:kx]) for x, q in calls]
                k_ms = time_ms(fn, calls)
                k_wall = wall_ms(fn, calls)
                p_ms = yardstick_ms(plain, calls[:1], min_iters=3)
                lib_ms = yardstick_ms(lambda x, d: torch.matmul(x, d), dense)
            kr.record(kernel, f"{tag} {name} M={m} K={k} N={n}" + (f" Kx={kx}" if kx < k else ""),
                      max_err(got, want), k_ms, k_wall, p_ms, lib_ms, nbytes, 2.0 * m * kx * n,
                      **extra)
            del dense, qws, calls
        del std, xs


def _kernels_ffn(kr, tag, k, ffn, n2, ms, untimed=()):
    """ffn_qmm (one cooperative launch: w13 with the norm prologue, SwiGLU,
    w2 plus the residual) against ffn_qmm_plain at a decode FFN's widths,
    W4 g128, w2's in_dim padded as quantize_params pads it; each row count
    with and without the norm and the residual, timed with both (the model's
    call) beside the unfused chain the path takes without ffn_fuse (w13
    w4_matmul with the norm, silu, the product, w2 w4_matmul with the
    residual: all of its kernels' device time). No single PyTorch call
    computes the function: no library time. The bound counts the weights'
    bytes the function reads (w2's padded rows are not read). Row counts in
    ``untimed`` are checked, not timed."""
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
        k_ms = k_wall = p_ms = chain_ms = None
        if m not in untimed:
            k_ms = time_ms(fused, calls)
            k_wall = wall_ms(fused, calls)
            p_ms = yardstick_ms(plain, calls[:1], min_iters=3)
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
    p_ms = yardstick_ms(plain, sets[:1], min_iters=3)
    mask = (torch.arange(pps * ps, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    lib_sets = []
    for q_, kp_, vp_ in sets[:4]:
        kd, vd = gather_pages(kp_[0], vp_[0], table)
        lib_sets.append((q_[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)))
    lib_ms = yardstick_ms(lambda qq, kk, vv: F.scaled_dot_product_attention(
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
        #    stream phase's prefill) and 512 (the serve phases' prefill); M 1 and 4
        #    (and M 4 of the stacked path, M 1 of 7B, Mixtral, Falcon-40B) checked,
        #    not timed: PERF.md's kernel table holds this GEMV design's times there
        cos, sin = precompute_rope(64, 1024, device="cuda")
        rope = rope_rows(cos, sin, 36, 4, 64, "interleaved") + ("interleaved", 64)
        _kernels_w4(kr, "tiny", TINY_PROJ, (1, 4, 8, 16, 128, 512), rope, untimed=(1, 4))
        # -- the stacked path's separate projections, with no prologue or epilogue
        #    (wk and wv, w1 and w3 share a shape; its wo and w2 are the rows above)
        _kernels_w4(kr, "tiny", [("wq", 2048, 2048, ""), ("wk/wv", 2048, 256, ""),
                                 ("w1/w3", 2048, 5632, "")], (4, 8, 512), rope, untimed=(4,))
        # -- LLaMA2-7B (MHA) path: the same four at the decode batch 8 and at M 1 and
        #    4 (K 11008 is padded to 11264 in the weight; RoPE at head_dim 128)
        cos, sin = precompute_rope(128, 1024, device="cuda")
        rope = rope_rows(cos, sin, 64, 32, 128, "interleaved") + ("interleaved", 128)
        _kernels_w4(kr, "7b", [("wqkv", 4096, 12288, "norm+rope"), ("wo", 4096, 4096, "res"),
                               ("w13", 4096, 22016, "norm"), ("w2", 11008, 4096, "res")],
                    (1, 4, 8), rope, untimed=(1, 4))

        # -- Mixtral-8x7B (MoE): its separate projections and one expert's w1 / w3
        #    and w2 at the decode batch 8 and at one row, K 4096 and 14336
        _kernels_w4(kr, "mixtral", [(nm, k, n, "") for nm, k, n in MIXTRAL_PROJ], (1, 8),
                    (None, None, "", 0), untimed=(1,))
        # -- Falcon-40B's and InternLM-7B's projections (no fusion: their own
        #    norms and biases) at the decode batch 8, Falcon's also at one row
        _kernels_w4(kr, "falcon40b", [(nm, k, n, "") for nm, k, n in FALCON_PROJ], (1, 8),
                    (None, None, "", 0), untimed=(1,))
        _kernels_w4(kr, "internlm7b", [(nm, k, n, "") for nm, k, n in INTERNLM_PROJ], (8,),
                    (None, None, "", 0))
        # -- Falcon-7B's one W4 product (dense_4h_to_h, N 4544: a last 128-column
        #    tile of 64) at the decode batch 8 (the GEMV) and at the many-row
        #    tile's 128 and 512 rows (serve_falcon7b's 4 x 128-row prefill)
        _kernels_w4(kr, "falcon7b", [(nm, k, n, "") for nm, k, n in FALCON7B_PROJ],
                    (8, 128, 512), (None, None, "", 0))
        # -- LLaMA-Adapter at 7B widths: its separate projections (no fusion:
        #    the adapter's blocks take none) at the decode batch 8, and a prefix
        #    layer's wk / wv over the batch's 8 x 10 prefix rows (the many-row
        #    tile, every forward). SPHINX-MoE's decode products are Mixtral's
        #    M = 8 rows above.
        _kernels_w4(kr, "adapter", [("wq/wk/wv/wo", 4096, 4096, ""), ("w1/w3", 4096, 11008, ""),
                                    ("w2", 11008, 4096, "")], (8,), (None, None, "", 0))
        _kernels_w4(kr, "adapter", [("prefix wk/wv", 4096, 4096, "")],
                    (ADAPTER_BATCH * ADAPTER_7B["prefix_len"],), (None, None, "", 0))

    if want("w4_matmul_bigm"):
        # -- Mixtral's 8 x 128 = 1024-row prefill: wk / wv and an expert's products
        #    (its wq / wo are the 7B wo rows below)
        _kernels_bigm(kr, [(nm, k, n, 1024) for nm, k, n in MIXTRAL_PROJ[1:]], tag="mixtral")
        # -- Falcon-40B's and InternLM-7B's 1024-row prefill
        _kernels_bigm(kr, [(nm, k, n, 1024) for nm, k, n in FALCON_PROJ], tag="falcon40b")
        _kernels_bigm(kr, [(nm, k, n, 1024) for nm, k, n in INTERNLM_PROJ], tag="internlm7b")
        # -- Falcon-7B's (N 4544: a last column panel of 64)
        _kernels_bigm(kr, [(nm, k, n, 1024) for nm, k, n in FALCON7B_PROJ], tag="falcon7b")
        # -- its prefill: the many-row kernel at 8 x 128 = 1024 rows, the QPEFT
        #    training step's 8 x 512 = 4096, and one row count that is not a
        #    multiple of the 256-row tile
        #    (4096 and 1000 rows checked, not timed: PERF.md holds this design's times)
        _kernels_bigm(kr, [(nm, k, n, m) for m in (1024, 4096)
                           for nm, k, n in (("wqkv", 4096, 12288), ("wo", 4096, 4096),
                                            ("w13", 4096, 22016), ("w2", 11008, 4096))]
                      + [("wo", 4096, 4096, 1000)], untimed=(4096, 1000))
        # -- SPHINX-7B's caption prefill: 8 x (the prompt's 256-token bucket +
        #    1455 image words) rows
        sph = _sphinx_shapes()
        _kernels_bigm(kr, [(nm, k, n, SPHINX_BATCH * sph["prefill_positions"])
                           for nm, k, n in (("wqkv", 4096, 12288), ("wo", 4096, 4096),
                                            ("w13", 4096, 22016), ("w2", 11008, 4096))],
                      tag="sphinx")
        # -- SPHINX-MoE's caption prefill (the same 13688 rows): Mixtral's
        #    attention products and an expert's, which every touched expert
        #    runs on all rows
        _kernels_bigm(kr, [(nm, k, n, SPHINX_BATCH * sph["prefill_positions"])
                           for nm, k, n in MIXTRAL_PROJ], tag="sphinx_moe")
        # -- the image training step (train_mm): 4 x (1455 + 512) rows through
        #    the 7B separate projections (training composes them unfused)
        # -- Mixtral's training step (train_moe): 1 x 2048 rows through each
        #    projection and expert product, forward and recompute
        _kernels_bigm(kr, [(nm, k, n, TRAIN_MOE_ROWS) for nm, k, n in MIXTRAL_PROJ],
                      tag="train_moe")
        _kernels_bigm(kr, [(nm, k, n, TRAIN_MM_ROWS)
                           for nm, k, n in (("wq/wk/wv/wo", 4096, 4096), ("w1/w3", 4096, 11008),
                                            ("w2", 11008, 4096))], tag="train_mm")

    if want("decode_attention"):
        # -- fused decode attention + KV write, GQA (_kernel_bloop_w): the decode
        #    phases' batch 8 and 1024-token cache, a cache length not a multiple
        #    of 128, and the serve phases' batch 4 and the stream phase's batch 1
        #    over their 192-token caches; the cache's edges checked, not timed
        #    (PERF.md holds the split design's times there)
        tiny_cases = ((8, 1024, 0), (8, 1024, 1), (8, 1024, 511), (8, 1024, 1023), (4, 192, 150),
                      (1, 192, 150))
        edges = ((8, 1024, 0), (8, 1024, 1), (8, 1024, 1023), (8, 1000, 999))
        _kernels_decode(kr, "tiny", 32, 4, 64, tiny_cases + ((8, 1000, 999),), untimed=edges)
        # -- its int8 form (_kernel_bloop_w8) and the read-only forms (_kernel_bloop
        #    / _kernel, _kernel_bloop8), each also held as "read-only + one-token
        #    write == fused"; an HD 128 GQA shape (NKV 8, R 4)
        _kernels_decode(kr, "tiny", 32, 4, 64, tiny_cases, int8=True, untimed=edges)
        _kernels_decode(kr, "tiny", 32, 4, 64, tiny_cases, write=False, untimed=edges)
        _kernels_decode(kr, "tiny", 32, 4, 64, tiny_cases, int8=True, write=False, untimed=edges)
        for int8, write in ((True, True), (False, False), (True, False)):
            _kernels_decode(kr, "hd128", 32, 8, 128, ((8, 1024, 511),), int8=int8, write=write,
                            most_copies=8)
        # -- Mixtral (NKV 8, R 4, HD 128): the fused bf16 and int8 decode at the
        #    decode phase's shape and the serve phase's 192-token cache
        for int8 in (False, True):
            _kernels_decode(kr, "mixtral", 32, 8, 128, ((8, 1024, 511), (8, 192, 150)),
                            int8=int8, most_copies=8)
        # -- SPHINX-MoE's caption decode (NKV 8, R 4): the first and last of its
        #    32 positions past the image words, in its cache
        sph = _sphinx_shapes()
        _kernels_decode(kr, "sphinx_moe", 32, 8, 128,
                        tuple((SPHINX_BATCH, sph["cache_len"], sph[p])
                              for p in ("first_decode_pos", "last_decode_pos")), most_copies=8)
        # -- Falcon-40B (NKV 8, R 16, HD 64): the fused bf16 and int8 decode at
        #    the decode and serve shapes, and the read-only forms (unfused route)
        for int8, write in ((False, True), (True, True), (False, False), (True, False)):
            _kernels_decode(kr, "falcon40b", 128, 8, 64,
                            ((8, 1024, 511), (8, 192, 150)) if write else ((8, 1024, 511),),
                            int8=int8, write=write, most_copies=8)
        # -- Falcon-7B (NKV 1, R 71, HD 64: a tile of 64 query rows and one of 7,
        #    each a cluster over the same tokens): the fused bf16 and int8 decode
        #    and the read-only forms at the decode and serve shapes
        for int8, write in ((False, True), (True, True), (False, False), (True, False)):
            _kernels_decode(kr, "falcon7b", 71, 1, 64, ((8, 1024, 511), (8, 192, 150)),
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
        #    (pos 0 and 1 checked, not timed: PERF.md holds this design's times)
        mha_cases = ((8, 1024, 0), (8, 1024, 1), (8, 1024, 511), (8, 1024, 1023), (8, 192, 150))
        mha_edges = ((8, 1024, 0), (8, 1024, 1))
        _kernels_decode(kr, "7b", 32, 32, 128, mha_cases, most_copies=4, untimed=mha_edges)
        _kernels_decode(kr, "hd64", 16, 16, 64, ((8, 1000, 999),), most_copies=4)
        _kernels_decode(kr, "7b", 32, 32, 128, mha_cases, int8=True, most_copies=4,
                        untimed=mha_edges)
        _kernels_decode(kr, "hd64", 16, 16, 64, ((8, 1000, 999),), int8=True, most_copies=4)
        # -- the read-only forms at one query head per KV head (the MHA kernel
        #    without its write), 7B shape
        ro_cases = ((8, 1024, 511), (8, 1024, 1023))
        _kernels_decode(kr, "7b", 32, 32, 128, ro_cases, write=False, most_copies=4)
        _kernels_decode(kr, "7b", 32, 32, 128, ro_cases, int8=True, write=False, most_copies=4)
        # -- SPHINX-7B's decode: the first and last positions of its 32 steps,
        #    past the image words, in its cache
        sph = _sphinx_shapes()
        sph_cases = tuple((SPHINX_BATCH, sph["cache_len"], sph[p])
                          for p in ("first_decode_pos", "last_decode_pos"))
        _kernels_decode(kr, "sphinx", 32, 32, 128, sph_cases, most_copies=4)
        _kernels_decode(kr, "sphinx", 32, 32, 128, sph_cases, int8=True, most_copies=4)
        # -- LLaMA-Adapter's decode: the read-only one-query-head kernel over its
        #    stacked cache at the bench shape, q / k / v separate projections
        _kernels_decode(kr, "adapter", 32, 32, 128, ((ADAPTER_BATCH, 1024, 511),), write=False,
                        most_copies=4, separate=True)

    if want("flash_attention"):
        # -- causal prefill flash attention (splash), and the 700M full
        #    finetune's forward (2 x 2048, 16 / 8 heads)
        _kernels_flash(kr, (("tiny", 4, 128, 32, 4, 64), ("tiny", 1, 128, 32, 4, 64),
                            ("tiny", 4, 200, 32, 4, 64),
                            ("hd128", 4, 128, 16, 4, 128), ("7b", 8, 128, 32, 32, 128),
                            ("mixtral", 8, 128, 32, 8, 128), ("falcon40b", 8, 128, 128, 8, 64),
                            ("falcon7b", 8, 128, 71, 1, 64),
                            ("700m", 2, 2048, 16, 8, 128),
                            ("sphinx", SPHINX_BATCH, _sphinx_shapes()["prefill_positions"],
                             32, 32, 128),
                            ("sphinx_moe", SPHINX_BATCH, _sphinx_shapes()["prefill_positions"],
                             32, 8, 128),
                            ("train_mm", TRAIN_MM_BATCH, TRAIN_MM_ROWS // TRAIN_MM_BATCH,
                             32, 32, 128),
                            ("train_moe", 1, TRAIN_MOE_ROWS, 32, 8, 128),
                            ("pretrain", PRETRAIN_BATCH, PRETRAIN_WORDS, 32, 4, 64)))

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
        _kernels_slab(kr, "falcon7b", 8, 1, 64, 192, 128, (0,))
        _kernels_slab8(kr, "falcon7b", 8, 1, 64, 192, 128, (0,))
        # -- SPHINX-7B's prefill slab: 1711 positions into its 1711-token cache
        sph = _sphinx_shapes()
        _kernels_slab(kr, "sphinx", SPHINX_BATCH, 32, 128, sph["cache_len"],
                      sph["prefill_positions"], (0,))
        _kernels_slab(kr, "sphinx_moe", SPHINX_BATCH, 8, 128, sph["cache_len"],
                      sph["prefill_positions"], (0,))
        # -- LLaMA-Adapter's stacked writes, 32 layers: its serve prefill (the
        #    128-token bucket into a 192-token cache) and a bench decode step
        _kernels_stacked(kr, "adapter", 32, ADAPTER_BATCH, 32, 128, 192, 128, 0, False)
        _kernels_stacked(kr, "adapter", 32, ADAPTER_BATCH, 32, 128, 1024, 1, 511, False)
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
                              ("7b w2", 11264, 4096), ("tiny w1/w3", 2048, 5632)]
                         + [("mixtral " + nm, k, n) for nm, k, n in MIXTRAL_PROJ])
        _kernels_flash_bwd(kr, [("7b", 8, 512, 32, 32, 128), ("700m", 2, 2048, 16, 8, 128),
                                ("tiny", 4, 256, 32, 4, 64), ("ragged", 2, 77, 32, 4, 64),
                                ("train_mm", TRAIN_MM_BATCH, TRAIN_MM_ROWS // TRAIN_MM_BATCH,
                                 32, 32, 128),
                                ("train_moe", 1, TRAIN_MOE_ROWS, 32, 8, 128),
                                ("pretrain", PRETRAIN_BATCH, PRETRAIN_WORDS, 32, 4, 64)])

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
        #    (M 1 and 4 checked, not timed: PERF.md holds this GEMV's times)
        _kernels_w4elem(kr, "tiny", [(nm, k, n, m) for m in (1, 4, 8)
                                     for nm, k, n, _ in TINY_PROJ], untimed=(1, 4))
        _kernels_w4elem(kr, "tiny", [("w13", 2048, 11264, 256)])
        _kernels_w4elem(kr, "tiny", [(nm, k, n, m) for m in (128, 512)
                                     for nm, k, n, _ in TINY_PROJ])
        _kernels_w4elem(kr, "7b", [("w13", 4096, 22016, 8), ("w2", 11264, 4096, 8, 11008)])

    if want("ffn_fused"):
        # -- the fused W4 decode FFN (ffn_fuse): TinyLlama and 7B widths at the
        #    stream (1), serve (4), a ragged (5) and the decode (8) batches, the
        #    one-pass row templates' largest (16) and the first of passes of 16
        #    rows (17), and its largest row count (128)
        #    (M 4, 5 and 16 checked, not timed: PERF.md holds this design's times)
        _kernels_ffn(kr, "tiny", 2048, 5632, 2048, (1, 4, 5, 8, 16, 17, 128), untimed=(4, 5, 16))
        _kernels_ffn(kr, "7b", 4096, 11008, 4096, (1, 4, 5, 8, 16, 17, 128), untimed=(4, 5, 16))
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
    if want("decode_attention") or want("decode_attention_mha"):
        # -- the position on the card (a captured decode step's): rows 2, 8, 13, 15
        #    (TinyLlama, Falcon-7B's R 71) and 7, 14 with their read-only twins
        #    (7B), bits against the int position's launch; the one-token writes
        _kernels_pos_dev(kr)
    if want("w4_matmul"):
        # -- row 1's GEMV with the gate set and cleared (a MoE expert no row chose)
        _kernels_gate(kr)
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
    depth = "num_layers" if family in ("internlm", "falcon") else "n_layers"
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


# ---------------------------------------------------------------- graphs


def _decode_busy(gen, run):
    """``run()`` (one generate on ``gen``) under a trace: the card's busy ms
    over its decode steps (``util.profiling.device_busy_from_trace`` over
    the window from the first step on, the card drained before it, so the
    prefill's kernels lie before the window) and the steps."""
    import torch

    from accessory_tpu_torch.util import profiling

    real, first = gen._advance, []

    def advance(st, step):
        if not first:
            torch.cuda.synchronize()
            first.append(time.perf_counter())
            with torch.profiler.record_function("first_decode_step"):
                real(st, step)
            return
        real(st, step)

    gen._advance = advance
    try:
        with profiling.trace() as prof:
            run()
    finally:
        del gen._advance
    events = profiling.trace_events(prof)
    marks = [e["ts"] for e in events.get("traceEvents", [])
             if e.get("name") == "first_decode_step" and e.get("ph") == "X"]
    if not marks:
        return None, gen.last_decode_steps
    busy = profiling.device_busy_from_trace(events, window=(min(marks), math.inf))
    return busy["busy_s"] * 1e3 / max(gen.last_decode_steps, 1), gen.last_decode_steps


def _route_run(make_gen, compiled: bool, prompts, max_gen_len: int):
    """One route of a Generator path: on the graph route a greedy run that
    captures the step, then the timed greedy run (launches counted, each
    step's device-clock time from ``_DecodeTimer``), a traced greedy run
    (busy) and a sampled run (temperature 0.8, seed 7)."""
    import torch

    from accessory_tpu_torch import kernels

    gen = make_gen(compiled)
    if compiled:
        gen.generate(prompts, max_gen_len=max_gen_len)
    timer = _DecodeTimer(gen)
    kernels.reset_launch_counts()
    gen.generate(prompts, max_gen_len=max_gen_len)
    torch.cuda.synchronize()
    timer.close()
    counts = kernels.launch_counts()
    greedy, steps = gen.last_tokens, gen.last_decode_steps
    n, decode_ms = timer.decode()
    busy, _ = _decode_busy(gen, lambda: gen.generate(prompts, max_gen_len=max_gen_len))
    gen.generate(prompts, max_gen_len=max_gen_len, temperature=0.8, seed=7)
    out = {"greedy": greedy, "sampled": gen.last_tokens, "counts": counts, "steps": steps,
           "graphs": gen.graphs, "wall_ms_per_step": decode_ms / max(n, 1),
           "busy_ms_per_step": busy}
    del gen
    torch.cuda.empty_cache()
    return out


def _generator_of(model, **kw):
    """compiled -> a Generator over the MetaModel's module, params and
    tokenizer (``kw``: its other settings)."""
    from accessory_tpu_torch.engine.generate import Generator

    def make(compiled: bool):
        return Generator(model.module, model.args, model.params, model.tokenizer,
                         compiled=compiled, **kw)

    return make


def phase_graphs(path: str, make_gen, prompts, max_gen_len: int, **extra):
    """One Generator path on the graph route (the default: each decode step
    a CUDA graph replayed) and the eager route (``compiled=False``), in
    turns (eager, graph): greedy tokens and the tokens sampled with one seed
    identical, the launch counts of the timed runs equal, and each route's
    wall ms a step (device clock, ``_DecodeTimer``), busy ms a step and idle
    share (``util.profiling``). ``make_gen(compiled)`` builds the Generator."""
    import numpy as np

    from accessory_tpu_torch.util import profiling

    runs = {name: _route_run(make_gen, compiled, prompts, max_gen_len)
            for name, compiled in (("eager", False), ("graph", True))}
    e, g = runs["eager"], runs["graph"]
    row = {"phase": "graphs", "path": path, "batch": len(prompts), "max_gen_len": max_gen_len,
           **extra, "graph_route_captured": g["graphs"], "decode_steps": g["steps"],
           "greedy_equal": bool(np.array_equal(e["greedy"], g["greedy"])),
           "sampled_equal": bool(np.array_equal(e["sampled"], g["sampled"])),
           "launches_equal": e["counts"] == g["counts"],
           "launches": {k: v for k, v in g["counts"].items() if v}}
    for name, r in runs.items():
        row[f"{name}_wall_ms_per_step"] = r["wall_ms_per_step"]
        row[f"{name}_busy_ms_per_step"] = r["busy_ms_per_step"]
        row[f"{name}_idle_share"] = (None if r["busy_ms_per_step"] is None else
                                     profiling.idle_share(r["busy_ms_per_step"],
                                                          r["wall_ms_per_step"]))
    emit(row)
    if not (row["greedy_equal"] and row["sampled_equal"] and row["launches_equal"]
            and g["graphs"] and e["steps"] == g["steps"]):
        raise AssertionError(f"graphs {path}: the routes differ: {row}")
    return g["counts"]


def phase_graphs_batcher(model, module):
    """The batcher on both routes (8 slots, decode_steps 8, 16 requests of
    128-token prompts, 32 new tokens, every other request sampled at
    temperature 0.8 from the batcher's seed): tokens identical, launch
    counts equal, the decode wall ms a step (dispatches timed to a
    synchronize), busy ms a step and idle share (``_profile_dispatch``)."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.util import profiling

    prompts = _p5_prompts(16)
    runs = {}
    for name, compiled in (("eager", False), ("graph", True)):
        outs = []
        cb = _batcher(model, module, None, compiled=compiled)
        for timed in (False, True):   # the second run replays every key the first captured
            real, dispatch = cb._decode, []

            def decode(*a, real=real, dispatch=dispatch):
                t = time.perf_counter()
                out = real(*a)
                torch.cuda.synchronize()
                dispatch.append((time.perf_counter() - t, a[2]))
                return out

            cb._decode = decode
            kernels.reset_launch_counts()
            uids = [cb.add_request(p, max_gen_len=32, temperature=0.8 * (i % 2))
                    for i, p in enumerate(prompts)]
            while cb.pending or any(r is not None for r in cb.active.values()):
                cb.step()
            torch.cuda.synchronize()
            by_uid = {r.uid: r for r in cb.finished}
            outs = [by_uid[u].output_tokens for u in uids]
            counts = kernels.launch_counts()
            del cb._decode
        prof = _profile_dispatch(_batcher(model, module, None, compiled=compiled), prompts[:8])
        wall = sum(t for t, _ in dispatch) * 1e3 / sum(n for _, n in dispatch)
        busy = prof.get("device_busy_ms_per_step")
        runs[name] = {"tokens": outs, "counts": counts, "graphs": cb.graphs,
                      "wall_ms_per_step": wall, "busy_ms_per_step": busy,
                      "idle_share": profiling.idle_share(busy, wall)
                      if isinstance(busy, float) else None}
    e, g = runs["eager"], runs["graph"]
    row = {"phase": "graphs", "path": "batcher", "slots": 8, "decode_steps": 8,
           "requests": len(prompts), "graph_route_captured": g["graphs"],
           "tokens_equal": e["tokens"] == g["tokens"], "launches_equal": e["counts"] == g["counts"],
           "launches": {k: v for k, v in g["counts"].items() if v}}
    for name, r in runs.items():
        for key in ("wall_ms_per_step", "busy_ms_per_step", "idle_share"):
            row[f"{name}_{key}"] = r[key]
    emit(row)
    if not (row["tokens_equal"] and row["launches_equal"] and g["graphs"]):
        raise AssertionError(f"graphs batcher: the routes differ: {row}")
    return g["counts"]


def phase_graphs_sync_check():
    """A capture whose step reads a value on the host fails (the capture runs
    under ``torch.cuda.set_sync_debug_mode("error")``), raises, and leaves the
    card usable."""
    import torch

    from accessory_tpu_torch.engine.graphs import GraphPool, StepGraph

    x = torch.ones(16, device="cuda")
    raised = False
    try:
        StepGraph(lambda: float(x.sum()), GraphPool())
    except RuntimeError:
        raised = True
    after = float((x * 2).sum())
    row = {"phase": "graphs", "path": "planted host read", "capture_raised": raised,
           "card_usable_after": after == 32.0}
    emit(row)
    if not (raised and after == 32.0):
        raise AssertionError(f"graphs: a host read in a captured step went unnoticed: {row}")


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
    forward_paged call that runs eagerly (not one a CUDA graph captures),
    from which, with the decode forwards the dispatches ran (replays
    included), the launches of each kernel follow."""

    def __init__(self, module):
        self._module = module
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._module, name)

    def forward_paged(self, params, args, tokens, pcache, active_pages=None, continuation=False):
        import torch

        if not torch.cuda.is_current_stream_capturing():
            self.calls.append((tokens.shape[0], tokens.shape[1], continuation))
        return self._module.forward_paged(params, args, tokens, pcache,
                                          active_pages=active_pages, continuation=continuation)

    def expected(self, n_layers, int8, decode_forwards):
        """Per call: 4 W4 launches a layer (the many-row kernel from 1024
        rows), causal flash for a fresh prefill, the paged decode kernel for
        a decode step or a continuation of up to 16 tokens (a longer one
        gathers), and one paged write. The decode steps (one token a slot)
        are ``decode_forwards`` (the dispatches' steps: a replayed graph
        calls no forward_paged), the recorded calls the rest."""
        want = _zero_counts()
        rest = [c for c in self.calls if c[1] > 1 or c[2]]
        for b, sq, continuation in rest + [(0, 1, False)] * decode_forwards:
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
    """Device time of one decode dispatch with every slot busy
    (``util.profiling.busy_profile``: the union of its kernels' intervals)
    against the same dispatch's wall time unprofiled: device busy ms per
    step, the idle share and the device kernels a step. The batcher's
    second dispatch of a key captures it, so the wall and the trace are
    taken at the third and fourth."""
    import torch

    from accessory_tpu_torch.util import profiling

    for p in prompts:
        cb.add_request(p, max_gen_len=64)
    cb.step()                                  # admission + the first dispatch
    cb.step()                                  # the key's capture on the graph route
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cb.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prof = profiling.busy_profile(cb.step, 1, wall_ms=wall, shares=("paged_decode",))
    while cb.pending or any(r is not None for r in cb.active.values()):
        cb.step()
    n = cb.decode_steps
    out = {"wall_ms_per_step": wall / n, "route": "graph" if cb.graphs else "eager"}
    if "device_busy_ms_per_call" not in prof:
        return {**out, "device_busy_ms_per_step": "not measured (no device events)"}
    return {**out, "device_busy_ms_per_step": prof["device_busy_ms_per_call"] / n,
            "device_idle_share": prof["device_idle_share"],
            "device_kernels_per_step": prof["n_kernels_per_call"] / n,
            "paged_decode_ms_per_step": prof["paged_decode_ms_per_call"] / n,
            "paged_decode_share_of_busy": prof["paged_decode_share_of_busy"]}


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
    dec_s = sum(t for t, _ in dispatch)
    dec_steps = sum(n for _, n in dispatch)
    want = module.expected(model.args.n_layers, int8, dec_steps)
    n_tok = sum(len(r.output_tokens) for r in reqs)
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
        reqs, secs, dec_steps = [], 0.0, 0
        for group in groups:
            r, t, _, dispatch = _drive(cb, group, max_gen)
            reqs, secs = reqs + r, secs + t
            dec_steps += sum(n for _, n in dispatch)
        torch.cuda.synchronize()
        ps = [p for group in groups for p in group]
        counts = kernels.launch_counts()
        want = module.expected(model.args.n_layers, False, dec_steps)
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
    cb, dispatched = server.engine.b, []   # the decode steps the batcher dispatches
    real_decode = cb._decode

    def decode(*a):
        dispatched.append(a[2])
        return real_decode(*a)

    cb._decode = decode
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
    want = module.expected(model.args.n_layers, False, sum(dispatched))
    del cb._decode
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
    """Device time by kernel over a few decode steps
    (``util.profiling.busy_profile``: busy is the union of the kernels'
    intervals). The idle share is taken against the unprofiled
    ``ms_per_step``, since tracing slows the host loop. ``module``: the
    model module (LLaMA by default); ``shares``: kernel-name substrings whose
    device ms a step and share of busy are added."""
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.util import profiling

    module = module or llama
    pos = [pos0]

    def step():
        module.forward(params, args, tok, cache=cache, cur_pos=pos[0], **kw)
        pos[0] += 1

    prof = profiling.busy_profile(step, steps, wall_ms=ms_per_step, shares=shares)
    if "device_busy_ms_per_call" not in prof:
        return prof
    out = {"wall_ms_per_step_profiled": prof["wall_ms_per_call_profiled"],
           "device_busy_ms_per_step": prof["device_busy_ms_per_call"],
           "device_idle_share": prof["device_idle_share"],
           "top_kernels_ms_per_step": prof["top_kernels_ms_per_call"]}
    for sub in shares:
        out[f"{sub}_ms_per_step"] = prof[f"{sub}_ms_per_call"]
        out[f"{sub}_share_of_busy"] = prof[f"{sub}_share_of_busy"]
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


def _train_counts(n_layers: int, qpeft: bool, bigm: bool, steps: int = 1, remat="full"):
    """Launches of ``steps`` training steps with every layer checkpointed:
    the forward, its recompute in the backward (under ``remat`` True the
    flash output is kept: no flash launch), and the backward."""
    w4 = "w4_matmul_bigm" if bigm else "w4_matmul"
    fwd = _zero_counts(flash_attention=n_layers, **({w4: 7 * n_layers} if qpeft else {}))
    rec = dict(fwd, flash_attention=0) if remat is True else fwd
    bwd = _zero_counts(flash_attention_bwd_dq=n_layers, flash_attention_bwd_dkdv=n_layers,
                       **({"w4_dequant": 7 * n_layers} if qpeft else {}))
    total = {k: steps * (fwd[k] + rec[k] + bwd[k]) for k in fwd}
    return {"forward": fwd, "recompute": rec, "backward": bwd}, total


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
                lr: float, steps: int = 5, compare_remat: bool = False):
    """One model's training step at full width and depth: 1 warm-up step and
    ``steps`` timed steps on the same random token batch (so the loss must
    fall), every layer checkpointed; ms per step, tokens/s, model flops per
    second against 989 TFLOP/s (bench_all.py's count: 4N + 3 attention for
    QPEFT, 6N + 3 attention for full finetuning), peak memory, each step's
    loss, launch counts per step (exact), and one profiled step split by
    kernel. ``compare_remat``: then one step under remat "full" beside one
    under True (``_remat_compare``)."""
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
    remat_cmp = (_remat_compare(args, state.params, trainable, data, lr, qpeft,
                                batch * seq_len >= 1024) if compare_remat else None)
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
           "launches_expected": want, "profile": prof,
           **({"remat_compare": remat_cmp} if remat_cmp else {})}
    emit(row)
    if counts != want:
        raise AssertionError(f"{phase}: launch counts {counts} != expected {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: losses not finite and falling: {losses}")
    if remat_cmp and not remat_cmp["agree"]:
        raise AssertionError(f"{phase}: remat True against full: {remat_cmp}")
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
        # --checkpointing is remat True: each layer's flash output kept
        _, want = _train_counts(2, True, False, steps, remat=True)
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
    """Per (token, layer): whether the chosen experts agree as sets, the
    CPU's gap between its scores k and k + 1 (a flip's gap), and the largest
    |card - CPU| router score; each (T, layers). Also whether the card chose
    the top k of its own scores everywhere."""
    import torch

    agree, gaps, diffs, own = [], [], [], True
    for c, g in zip(cpu_log, gpu_log):
        agree.append((c["idx"].sort(dim=-1).values == g["idx"].sort(dim=-1).values).all(dim=-1))
        top = c["scores"].sort(dim=-1, descending=True).values
        gaps.append(top[:, k - 1] - top[:, k])
        diffs.append((c["scores"] - g["scores"]).abs().amax(dim=-1))
        g_top = torch.sort(g["scores"], dim=-1, descending=True, stable=True).indices[:, :k]
        own &= bool((g_top.sort(dim=-1).values == g["idx"].sort(dim=-1).values.long()).all())
    return (torch.stack(agree, dim=-1), torch.stack(gaps, dim=-1), torch.stack(diffs, dim=-1),
            own)


def _moe_parity(phase: str, desc: str, module, args, params_gpu, params_cpu, prompt, steps: int,
                image_tokens=None, flip_gap=ROUTE_FLIP_GAP):
    """The CPU (plain versions) against the card (kernels) on the same
    weights: a prefill of ``prompt`` (after the image words, when
    ``image_tokens`` (card, CPU) are given: the splice's embeddings) and
    ``steps`` decode steps teacher-forced on the CPU's greedy tokens.
    Routing agreement per (token, layer); the card's choice must be the top
    k of its own router scores. A flip at layer l' and position p reaches
    every layer above l' at p and after it (through the cache in later
    steps too); a flip that no earlier flip reaches must have a CPU gap
    between scores k and k + 1 of at most ``flip_gap`` (None: twice the
    scores' own noise, the largest |card - CPU| router score of a (token,
    layer) that no flip reaches), while a reached flip follows from its
    inputs' difference and is only reported; logits
    held to parity's tolerances where every layer's routing agreed, for
    each batch row up to its first flip (a flip moves the next layers' k /
    v, and through the cache every later token of the row). Returns the
    row."""
    import torch

    from accessory_tpu_torch.ops import moe

    b, plen = prompt.shape
    n_img = 0 if image_tokens is None else image_tokens[1].shape[1]
    s_len = max(128, n_img + plen + steps)
    cache_g = module.init_kv_cache(args, b, s_len)
    cache_c = module.init_kv_cache(args, b, s_len, device="cpu")
    cpu_s, logits, agree, gaps, gated, noise, own = 0.0, [], [], [], [], 0.0, True
    clean = torch.ones(b, dtype=torch.bool)
    n_moe = args.n_layers
    layer_ids = torch.arange(n_moe)
    reached_from = torch.full((b,), n_moe)     # a row's lowest flipped layer so far
    tok = prompt
    for i in range(steps + 1):
        pos = 0 if i == 0 else n_img + plen + i - 1
        kw_g, kw_c = {}, {}
        if i == 0 and image_tokens is not None:
            kw_g = {"embeds": module.splice(params_gpu, tok.cuda(), image_tokens[0])}
            kw_c = {"embeds": module.splice(params_cpu, tok, image_tokens[1])}
        with torch.no_grad(), moe.record_routing(detail=True) as glog:
            lg, _ = module.forward(params_gpu, args, tok.cuda(), cache=cache_g, cur_pos=pos,
                                   **kw_g)
        t0 = time.perf_counter()
        with torch.no_grad(), moe.record_routing(detail=True) as clog:
            lc, _ = module.forward(params_cpu, args, tok, cache=cache_c, cur_pos=pos, **kw_c)
        cpu_s += time.perf_counter() - t0
        same, gap, diff, step_own = _routing_compare(clog, glog, args.num_experts_per_tok)
        own = own and step_own
        flip = ~same.reshape(b, lc.shape[1], n_moe)
        gap, diff = gap.reshape(flip.shape), diff.reshape(flip.shape)
        below = (flip.int().cumsum(dim=2) - flip.int()) > 0      # a flip under layer l at t
        reached = (below.int().cummax(dim=1).values > 0) \
            | (layer_ids[None, None, :] > reached_from[:, None, None])
        quiet = ~flip & ~reached
        if quiet.any():
            noise = max(noise, float(diff[quiet].max()))
        gaps += gap[flip].tolist()
        gated += gap[flip & ~reached].tolist()
        reached_from = torch.minimum(
            reached_from, torch.where(flip, layer_ids, n_moe).amin(dim=(1, 2)))
        tok_ok = same.all(dim=-1).reshape(b, lc.shape[1])
        agree.append(clean[:, None] & (tok_ok.cumprod(dim=1) > 0))
        clean &= tok_ok.all(dim=1)
        logits.append((lg.float().cpu(), lc))
        tok = lc[:, -1:].argmax(-1)
    tol_abs = LOGIT_TOL_FRAC * float(logits[0][1].abs().max())
    gpu = torch.cat([g.reshape(-1, g.shape[-1]) for g, _ in logits])
    cpu = torch.cat([c.reshape(-1, c.shape[-1]) for _, c in logits])
    ok = torch.cat([a.reshape(-1) for a in agree])
    d = (gpu - cpu)[ok]
    top2 = cpu[ok].topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > tol_abs
    limit = 2 * noise if flip_gap is None else flip_gap
    row = {"phase": phase, "model": desc, "weights": "W4",
           "batch": b, "prompt": plen, "image_words": n_img, "decode_steps": steps,
           "cpu_seconds": round(cpu_s, 2),
           "routing_tokens": int(ok.numel()), "routing_flips": len(gaps),
           "tokens_compared": int(ok.sum()),
           "routing_flip_gaps": gaps, "unreached_flip_gaps": gated,
           "flip_gap_limit": limit,
           "router_score_noise": noise, "card_routes_its_own_top_k": own,
           "max_abs_logit_err": float(d.abs().max()) if d.numel() else None,
           "max_rel_l2_err": float(d.norm() / cpu[ok].norm()) if d.numel() else None,
           "tol_abs": tol_abs, "tol_rel_l2": LOGIT_REL_L2,
           "tokens_checked": int(sure.sum()),
           "tokens_agreed": int((gpu[ok].argmax(-1) == cpu[ok].argmax(-1))[sure].sum())}
    if (not torch.isfinite(gpu).all() or not d.numel() or row["max_abs_logit_err"] > tol_abs
            or row["max_rel_l2_err"] > LOGIT_REL_L2 or any(g > limit for g in gated)
            or not own or row["tokens_agreed"] != row["tokens_checked"]):
        emit(row)
        raise AssertionError(f"{phase} failed: {row}")
    return row


def phase_parity_moe(seed: int, b: int = 2, plen: int = 32, steps: int = 8):
    """Mixtral width (dim 4096, 8 experts of 14336, 32 / 8 heads), one layer:
    ``_moe_parity`` on W4 weights (``quantize_params`` of a seeded dense
    layer, the router f32), a prefill of b x plen tokens and ``steps``
    decode steps."""
    import torch

    from accessory_tpu_torch.config import MixtralArgs
    from accessory_tpu_torch.models import mixtral
    from accessory_tpu_torch.quant.quantize import DEFAULT_BLOCKLIST, quantize_params

    args = MixtralArgs(**dict(MIXTRAL_8X7B, n_layers=1), max_seq_len=128)
    block = tuple(DEFAULT_BLOCKLIST) + tuple(mixtral.get_quant_blocklist(args))
    params_gpu = quantize_params(mixtral.init_params(args, seed=seed), blocklist=block)
    torch.cuda.empty_cache()
    params_cpu = _tree_to(params_gpu, "cpu")
    prompt = torch.randint(0, args.vocab_size, (b, plen),
                           generator=torch.Generator().manual_seed(seed))
    emit(_moe_parity("parity_moe", "Mixtral-8x7B width, 1 layer", mixtral, args, params_gpu,
                     params_cpu, prompt, steps))


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


def _mixtral_model(seed: int, max_seq_len: int, llama_type: str = "mixtral"):
    """The full Mixtral-8x7B shape (32 layers, 8 experts, dim 4096, hidden
    14336, 32 / 8 heads), W4 g128 folded, built leaf by leaf on the card from
    ``seed`` (the dense bf16 model, ~93 GB, is never made): every projection
    and expert a ``_random_w4``, the router f32, embeddings and head bf16,
    norms one; a MetaModel of ``llama_type`` holding them, with the f32
    towers of ``sphinx.init_visual`` for a SPHINX-MoE type. Returns (model,
    setup s, peak bytes)."""
    import torch

    from accessory_tpu_torch.meta import MetaModel
    from accessory_tpu_torch.models import sphinx

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = MetaModel(llama_type, dict(MIXTRAL_8X7B), max_seq_len=max_seq_len, init_params=False)
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
    if model.with_visual:
        model.params["visual"] = sphinx.init_visual(a, seed)
    model.tokenizer = ByteTokenizer()
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _moe_matmul_counts(log, experts: int, decode_forwards=None,
                       attention: bool = True) -> dict:
    """The W4 launches of Mixtral forwards (one routing entry a layer a
    forward): wq, wk, wv, wo (unless ``attention`` is False), then a
    forward of more than 16 rows (a prefill) w1, w3, w2 of each expert its
    recorded routing touched, on the many-row kernel from 1024 rows, and a
    decode forward (at most ``ops.moe.GATED_ROWS`` rows) w1, w3, w2 of every
    expert, gated on the card: 4 + 3 E a layer whatever the routing.
    ``decode_forwards``: the decode layer-forwards (a replayed graph records
    no routing); None: the log's own entries of at most 16 rows."""
    from accessory_tpu_torch.ops.moe import GATED_ROWS

    want = {"w4_matmul": 0, "w4_matmul_bigm": 0}
    decode = [e for e in log if e["rows"] <= GATED_ROWS]
    for entry in log:
        if entry["rows"] > GATED_ROWS:
            want["w4_matmul_bigm" if entry["rows"] >= 1024 else "w4_matmul"] += \
                4 * attention + 3 * sum(entry["touched"])
    n = len(decode) if decode_forwards is None else decode_forwards
    want["w4_matmul"] += n * (4 * attention + 3 * experts)
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
                        decode_attention=n_layers * steps,
                        **_moe_matmul_counts(log, model.args.num_experts,
                                             decode_forwards=n_layers * steps))
    # routing is recorded by eager forwards: the prefill and every decode
    # step, or on the graph route the prefill and the first (eager) step
    eager_steps = 1 if model.generator.graphs else steps
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
            or len(log) != n_layers * (eager_steps + 1)):
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
    prefill_want = _zero_counts(flash_attention=args.n_layers,
                                **_moe_matmul_counts(plog, args.num_experts),
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
    want = _zero_counts(**_moe_matmul_counts(log, args.num_experts),
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
    # the calls' shapes give the attention's 4 W4 launches a layer, the routing the prefills'
    # experts, every decode step 3 gated launches an expert
    dec_s = sum(t for t, _ in dispatch)
    dec_steps = sum(n for _, n in dispatch)
    want = module.expected(model.args.n_layers, False, dec_steps)
    for name, n in _moe_matmul_counts(log, model.args.num_experts,
                                      decode_forwards=model.args.n_layers * dec_steps,
                                      attention=False).items():
        want[name] += n
    n_tok = sum(len(r.output_tokens) for r in reqs)
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


ZOO_MODELS = ("Falcon-40B", "InternLM-7B", "Falcon-7B")


def _zoo_family(name: str):
    """(llama_type, config, module, W4 products a layer) of a zoo model."""
    from accessory_tpu_torch.models import falcon, internlm

    return {"Falcon-40B": ("falcon", FALCON_40B, falcon, 6),
            "InternLM-7B": ("internlm", INTERNLM_7B, internlm, 5),
            "Falcon-7B": ("falcon", FALCON_7B, falcon, 1)}[name]


def phase_parity_zoo(seed: int):
    """Falcon-40B, InternLM-7B and Falcon-7B at full width, one layer each (W4
    from ``quantize_params`` of a seeded dense layer, which leaves Falcon-7B
    one W4 product, the embeddings and head dense): the CPU (plain versions)
    against the card (kernels) through a 2 x 32 prefill and 4 teacher-forced
    decode steps, bf16 then int8 KV, logits within LOGIT_TOL_FRAC /
    LOGIT_REL_L2 (phase_parity)."""
    import torch

    for name in ZOO_MODELS:
        family, cfg, _, _ = _zoo_family(name)
        phase_parity(seed, "parity_zoo", cfg, 1, b=2, plen=32, steps=4, s_len=128,
                     kv_dtypes=(None, "int8"), family=family)
        gc.collect()
        torch.cuda.empty_cache()


def _zoo_model(name: str, seed: int, max_seq_len: int):
    """The full-width model ``name`` (FALCON_40B: 60 layers, 128 / 8 heads of
    64, FFN 32768; INTERNLM_7B: 32 layers, MHA of 128, FFN 11008, biased
    Wqkv / out_proj; FALCON_7B: 32 layers, 71 heads of 64 over one, FFN
    18176), built leaf by leaf on the card from ``seed`` (the dense bf16
    model never exists): each projection W4 g128 folded where
    ``quantize_params`` would quantize it (in_dim a multiple of 128: every
    projection of the first two, Falcon-7B's dense_4h_to_h alone), a
    ``_random_w4`` (K padded to the multiple of 1024 ``quantize_params``
    gives it), else a fan-in-scaled bf16 weight; biases 0.02-scaled, norms
    one, embeddings and head bf16. Returns (model, setup s, peak bytes)."""
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

    def proj(k, n, bias=False):
        mod = {"weight": _random_w4(gen, k + (-k) % pad_to(k, 128), n) if k % 128 == 0
               else dense((k, n), k ** -0.5)}
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
            lns = ({"ln_attn": norm(True), "ln_mlp": norm(True)}
                   if a.new_decoder_architecture else {"input_layernorm": norm(True)})
            layers.append({**lns,
                           "self_attention": {"wq": proj(d, d), "wk": proj(d, kvd),
                                              "wv": proj(d, kvd), "dense": proj(d, d)},
                           "mlp": {"dense_h_to_4h": proj(d, 4 * d),
                                   "dense_4h_to_h": proj(4 * d, d)}})
        else:
            hidden = module._hidden_dim(a)
            layers.append({"norm1": norm(False), "norm2": norm(False),
                           "mixer": {"Wqkv": proj(d, 3 * d, True), "out_proj": proj(d, d, True)},
                           "mlp": {"w1": proj(d, hidden), "w2": proj(d, hidden),
                                   "w3": proj(hidden, d)}})
    final = {"ln_f": norm(True)} if family == "falcon" else {"norm": norm(False)}
    model.params = {"word_embeddings": {"weight": dense((a.vocab_size, d), 1.0)},
                    "layers": layers, **final,
                    "output": {"weight": dense((d, a.vocab_size), d ** -0.5)}}
    model.tokenizer = ByteTokenizer()
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _weight_bytes(node, skip=()) -> int:
    """Bytes of every weight in a subtree (quantized: packed words, scales,
    zeros; dense tensors as they are), leaving out the keys in ``skip``."""
    if isinstance(node, dict):
        return sum(_weight_bytes(v, skip) for k, v in node.items() if k not in skip)
    if isinstance(node, (list, tuple)):
        return sum(_weight_bytes(v, skip) for v in node)
    if hasattr(node, "packed"):
        return _qw_bytes(node)
    return node.numel() * node.element_size() if hasattr(node, "numel") else 0


def phase_serve_zoo(name: str, seed: int, tile_rows: int = 0):
    """The full-width model ``name`` through MetaModel.generate: the 8 PROMPTS
    in the 128-token bucket (a 1024-row prefill: every W4 projection on row
    5), 32 new tokens, greedy, bf16 KV, launch counts exact (W4 products a
    layer x layers on row 5 once and on row 1 a decode step; flash and the
    slab write once a layer; the decode attention, GQA or one-query-head, a
    layer a step). ``tile_rows``: then one more counted prefill of that many
    rows (4 x 128 = 512: row 1's many-row tile, each W4 product once a
    layer, flash and the slab write once a layer). Returns (model, counts)."""
    import torch

    from accessory_tpu_torch import kernels

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
           "decode_steps": steps, "launches": dict(counts), "launches_expected": want,
           "setup_s": setup_s, "setup_peak_gb": setup_peak / 1e9,
           "weight_gb": _weight_bytes(model.params) / 1e9,
           "w4_gb": _qw_bytes(model.params) / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "prefill_ms": prefill_ms,
           "generate_s": total_s,
           "decode_tok_s": len(PROMPTS) * steps / max(total_s - prefill_ms / 1e3, 1e-9),
           "outputs_chars": [len(o) for o in outs]}
    ok = counts == want and steps >= 32 and len(outs) == len(PROMPTS)
    if tile_rows and ok:
        b = tile_rows // 128
        cache = model.module.init_kv_cache(model.args, b, 192)
        toks = (torch.arange(b * 128, device="cuda").reshape(b, 128) * 7 + 3) % 256
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _ = model.module.forward(model.generator.params, model.args, toks, cache=cache,
                                         cur_pos=0)
        torch.cuda.synchronize()
        tile_counts = kernels.launch_counts()
        tile_want = _zero_counts(w4_matmul=n_proj * n_layers, flash_attention=n_layers,
                                 kv_write=n_layers)
        row.update(tile_prefill_rows=tile_rows, tile_prefill_ms=(time.perf_counter() - t0) * 1e3,
                   tile_prefill_launches=tile_counts, tile_prefill_launches_expected=tile_want)
        ok = tile_counts == tile_want and bool(torch.isfinite(logits).all())
        _add_counts(counts, tile_counts)
        del cache, logits
    emit(row)
    if not ok:
        raise AssertionError(f"{phase}: launch counts {row['launches']} != expected "
                             f"{row['launches_expected']}, or the {tile_rows}-row prefill's "
                             f"{row.get('tile_prefill_launches')} != "
                             f"{row.get('tile_prefill_launches_expected')}")
    return model, counts


def phase_decode_zoo(name: str, model, kv_dtype, steps: int = 30):
    """The model at batch 8, a 1024-token cache, ``steps`` forward steps from
    position 512 (8 different tokens): wall ms a step, launch counts exact,
    the bytes bound (every weight byte but the embedding table's, and the
    KV read of each step at 3.35 TB/s), then device time by kernel over 4
    profiled steps with the shares of row 1, the attention, the head and
    Falcon-7B's bf16 products (cuBLAS, "nvjet"), the eager elementwise and
    reduction kernels, and the idle share. Returns the counts."""
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
    w_bytes = _weight_bytes(params, skip=("word_embeddings",))
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


# SPHINX-7B (BASELINE.json config 5, the reference's batch_inference.py
# workload): llama_ens5 at 448 px (a global view and a 2 x 2 grid: 5 crops,
# 1455 image words), the LLaMA2-7B decoder in W4 g128 and the production
# towers of config._VisualTowerFields (CLIP ViT-L/14, DINOv2 ViT-g/14,
# ConvNeXt-XXL, the Q-Former) in f32, 8 images a batch, 32 new tokens
SPHINX_TYPE = "llama_ens5"
SPHINX_MAX_SEQ = 2048
SPHINX_BATCH = 8
SPHINX_NEW_TOKENS = 32
CAPTION = "Describe the image."
# the towers compute in f32 on both sides of parity_sphinx (cuBLAS without
# TF32: main() sets torch.backends.cuda.matmul.allow_tf32 = False; the
# ConvNeXt depthwise convolution is elementwise, never cuDNN): features are
# held to 1e-4 in relative L2 and 1e-3 of their largest |value|
TOWER_REL_L2 = 1e-4
TOWER_TOL_FRAC = 1e-3


def _sphinx_shapes():
    """The SPHINX-7B caption run's shapes as the Generator forms them: image
    words, prompt tokens (the conversation template around CAPTION, BOS
    included, byte tokens), prefill positions a sequence (the prompt's
    64-token bucket plus the image words), the cache length, and the first and
    last decode positions."""
    from accessory_tpu_torch.config import SphinxArgs
    from accessory_tpu_torch.data.conversation import default_conversation
    from accessory_tpu_torch.engine.generate import _round_up
    from accessory_tpu_torch.models import sphinx

    n_img = sphinx.image_words(SphinxArgs(visual="ens5", image_size=448))
    conv = default_conversation()
    conv.load_qas([[CAPTION, None]])
    plen = len(ByteTokenizer().encode(conv.get_prompt(), True, False))
    max_text = SPHINX_MAX_SEQ - n_img
    total = min(max_text, plen + SPHINX_NEW_TOKENS)
    buf = max(min(_round_up(total), max_text), total)
    prefill = min(_round_up(plen), buf)
    return {"image_words": n_img, "prompt_tokens": plen, "prefill_positions": prefill + n_img,
            "cache_len": buf + n_img, "first_decode_pos": plen + n_img,
            "last_decode_pos": total - 1 + n_img}


def _close_f32(name, got, want):
    """f32 towers, card against CPU: relative L2 and max |error| against the
    largest |value| (TOWER_REL_L2, TOWER_TOL_FRAC). Returns the row."""
    import torch

    got, want = got.float().cpu(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"parity_sphinx {name}: non-finite values on the card")
    err = float((got - want).abs().max())
    rel = float((got - want).norm() / want.norm())
    absmax = float(want.abs().max())
    row = {"output": name, "shape": list(want.shape), "max_abs_err": err, "rel_l2_err": rel,
           "absmax": absmax}
    if rel > TOWER_REL_L2 or err > TOWER_TOL_FRAC * absmax:
        raise AssertionError(f"parity_sphinx {name}: card vs CPU {row}")
    return row


def phase_parity_sphinx(seed: int, steps: int = 4):
    """SPHINX at production widths, cut in depth: the towers at full width
    with 2 blocks each (ConvNeXt-XXL depths 1, 1, 1, 1) and 2 decoder layers
    of LLaMA2-7B width, W4; one 448-px image (5 crops). The card against the
    port's CPU plain path on the same weights: each tower's features and the
    Q-Former's in f32 (TOWER_REL_L2 / TOWER_TOL_FRAC), encode_image's bf16
    tokens to 2 bf16 ulps of their largest |value| and 4e-3 in relative L2,
    then the prefill over [BOS, 1455 image words, 31 text tokens] (1487 rows:
    the many-row W4 kernel, flash over a ragged tail tile, the slab write) and
    ``steps`` decode steps at positions shifted by the image words, logits
    within LOGIT_TOL_FRAC / LOGIT_REL_L2 and greedy tokens equal where the
    CPU is sure (phase_parity's gate)."""
    import torch

    from accessory_tpu_torch.config import SphinxArgs
    from accessory_tpu_torch.models import sphinx
    from accessory_tpu_torch.models.visual import qformer_forward
    from accessory_tpu_torch.quant.fuse import fuse_for_decode
    from accessory_tpu_torch.quant.quantize import quantize_params

    args = SphinxArgs(**dict(LLAMA2_7B, n_layers=2), visual="ens5", image_size=448,
                      clip_layers=2, dino_layers=2, qformer_layers=2,
                      convnext_depths=(1, 1, 1, 1), max_seq_len=SPHINX_MAX_SEQ)
    params_g = fuse_for_decode(quantize_params(sphinx.init_params(args, seed=seed)))
    torch.cuda.empty_cache()
    params_c = _tree_to(params_g, "cpu")
    g = torch.Generator().manual_seed(seed)
    img = torch.randn((1, 3, 448, 448), generator=g)
    plen = 32
    prompt = torch.randint(0, args.vocab_size, (1, plen), generator=g)
    rows = []
    t0 = time.perf_counter()
    crops_c = sphinx._split_crops(args, img)
    feats_c = sphinx.tower_features(params_c, args, crops_c)
    q_c = qformer_forward(params_c["visual"]["qformer"], sphinx._tower_cfgs(args)[3],
                          feats_c["clip"])
    tok_c = sphinx.encode_image(params_c, args, img)
    cpu_tower_s = time.perf_counter() - t0
    with torch.no_grad():
        crops_g = sphinx._split_crops(args, img.cuda())
        rows.append(_close_f32("crops", crops_g, crops_c))
        feats_g = sphinx.tower_features(params_g, args, crops_g)
        for name in ("clip", "convnext", "dinov2"):
            rows.append(_close_f32(name, feats_g[name], feats_c[name]))
        q_g = qformer_forward(params_g["visual"]["qformer"], sphinx._tower_cfgs(args)[3],
                              feats_g["clip"])
        rows.append(_close_f32("qformer", q_g, q_c))
        tok_g = sphinx.encode_image(params_g, args, img.cuda())
    n_img = sphinx.image_words(args)
    assert tok_g.shape == tok_c.shape == (1, n_img, args.dim) and n_img == 1455
    tok_absmax = float(tok_c.float().abs().max())
    tok_err = max_err(tok_g.float().cpu(), tok_c.float())
    tok_rel = float((tok_g.float().cpu() - tok_c.float()).norm() / tok_c.float().norm())
    rows.append({"output": "encode_image (bf16)", "shape": list(tok_c.shape),
                 "max_abs_err": tok_err[0], "rel_l2_err": tok_rel, "absmax": tok_absmax})
    if tok_err[0] > 2 * bf16_ulp(tok_absmax) or tok_rel > 4e-3:
        raise AssertionError(f"parity_sphinx encode_image: card vs CPU {rows[-1]}")

    s_len = plen + n_img + steps
    cache_g = sphinx.init_kv_cache(args, 1, s_len)
    cache_c = sphinx.init_kv_cache(args, 1, s_len, device="cpu")
    cpu_s = 0.0
    with torch.no_grad():
        lg, _ = sphinx.forward(params_g, args, prompt.cuda(), cache=cache_g, cur_pos=0,
                               embeds=sphinx.splice(params_g, prompt.cuda(), tok_g))
        t0 = time.perf_counter()
        lc, _ = sphinx.forward(params_c, args, prompt, cache=cache_c, cur_pos=0,
                               embeds=sphinx.splice(params_c, prompt, tok_c))
        cpu_s += time.perf_counter() - t0
    worst_abs, worst_rel, checked, agreed = 0.0, 0.0, 0, 0
    tol_abs = LOGIT_TOL_FRAC * float(lc.abs().max())

    def compare(gpu, cpu):
        nonlocal worst_abs, worst_rel, checked, agreed
        gpu = gpu.float().cpu()
        if not torch.isfinite(gpu).all():
            raise AssertionError("parity_sphinx: non-finite GPU logits")
        worst_abs = max(worst_abs, float((gpu - cpu).abs().max()))
        worst_rel = max(worst_rel, float((gpu - cpu).norm() / cpu.norm()))
        top2 = cpu.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > tol_abs
        checked += int(sure.sum())
        agreed += int((gpu.argmax(-1) == cpu.argmax(-1))[sure].sum())

    compare(lg, lc)
    tok = lc[:, -1].argmax(-1)
    with torch.no_grad():
        for i in range(steps):
            pos = n_img + plen + i
            lg, _ = sphinx.forward(params_g, args, tok[:, None].cuda(), cache=cache_g, cur_pos=pos)
            t0 = time.perf_counter()
            lc, _ = sphinx.forward(params_c, args, tok[:, None], cache=cache_c, cur_pos=pos)
            cpu_s += time.perf_counter() - t0
            compare(lg, lc)
            tok = lc[:, -1].argmax(-1)
    row = {"phase": "parity_sphinx", "model": "SPHINX-7B widths (llama_ens5, 448 px)",
           "depth": {"decoder": 2, "clip": 2, "dinov2": 2, "qformer": 2,
                     "convnext": [1, 1, 1, 1]},
           "towers_precision": "f32 (matmul TF32 off, depthwise conv outside cuDNN)",
           "image_words": n_img, "prefill_rows": plen + n_img, "decode_steps": steps,
           "tower_rows": rows, "cpu_tower_seconds": round(cpu_tower_s, 2),
           "cpu_decoder_seconds": round(cpu_s, 2), "max_abs_logit_err": worst_abs,
           "max_rel_l2_err": worst_rel, "tol_abs": tol_abs, "tol_rel_l2": LOGIT_REL_L2,
           "tokens_checked": checked, "tokens_agreed": agreed}
    emit(row)
    if worst_abs > tol_abs or worst_rel > LOGIT_REL_L2 or agreed != checked:
        raise AssertionError(f"parity_sphinx failed: {row}")


def _event_ms(fn, reps: int = 2):
    """Ms of one call between CUDA events, the last of ``reps`` calls (the
    first warms the allocator)."""
    import torch

    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _sphinx_images(seed: int, n: int):
    """n CLIP-normalized stand-ins (3, 448, 448) f32 on the card from ``seed``
    (normal noise: the card's machine has no PIL and no image files)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return list(torch.randn((n, 3, 448, 448), generator=g, device="cuda"))


def _sphinx_model(seed: int):
    """SPHINXModel(llama_ens5) with LLaMA2-7B's decoder drawn on the card from
    ``seed`` and quantized to W4 layer by layer, the towers f32. Returns
    (model, setup s, setup peak bytes)."""
    import torch

    from accessory_tpu_torch.sphinx_api import SPHINXModel

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = SPHINXModel(SPHINX_TYPE, dict(LLAMA2_7B), max_seq_len=SPHINX_MAX_SEQ, seed=seed)
    model.tokenizer = ByteTokenizer()
    model.quantize()
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


class _DecodeTimer:
    """CUDA events around each decode step a Generator runs (its
    ``_advance``: an eager step, or a captured step's replay, the step that
    captures it included), the rest of the Generator untouched: it times the
    run's decode on the device's clock, from the first step's start to the
    last step's end. ``close()`` puts the Generator's own method back."""

    def __init__(self, gen):
        import torch

        self._gen, self._events = gen, []
        real = gen._advance

        def advance(st, step):
            self._events.append(torch.cuda.Event(enable_timing=True))
            self._events[-1].record()
            real(st, step)
            self._events.append(torch.cuda.Event(enable_timing=True))
            self._events[-1].record()

        gen._advance = advance

    def close(self):
        del self._gen._advance

    def decode(self):
        """(decode steps, ms from the first one's start to the last one's
        end); call after a synchronize."""
        if not self._events:
            return 0, 0.0
        return len(self._events) // 2, self._events[0].elapsed_time(self._events[-1])


def phase_serve_sphinx(seed: int):
    """SPHINX-7B at full width and depth: sphinx_api.batch_caption of 8
    images (32 new tokens, greedy), then SPHINXModel.generate_response on one,
    each launch-counted exactly (W4 products: 4 a layer on row 5 at the
    prefill, 4 a layer a decode step on row 1; flash and the slab write once a
    layer; the one-query-head decode attention a layer a step). Also:
    encode_image ms split by tower (CUDA events), the prefill alone, a decode
    step's wall ms and its device time by kernel with the idle share, setup s
    and peak GB; in each counted run its decode ms (CUDA events from the
    first decode step's start to the last one's end, _DecodeTimer) and the
    tok/s that gives. Returns (model, counts by run)."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.models import sphinx
    from accessory_tpu_torch.models.visual import (_depthwise7, convnext_forward,
                                                   qformer_forward, resize_linear, vit_forward)
    from accessory_tpu_torch.sphinx_api import batch_caption

    sh = _sphinx_shapes()
    model, setup_s, setup_peak = _sphinx_model(seed)
    args, n_layers = model.args, model.args.n_layers
    if sphinx.image_words(args) != sh["image_words"]:
        raise AssertionError(f"serve_sphinx: {sphinx.image_words(args)} image words")
    imgs = _sphinx_images(seed, SPHINX_BATCH)
    batch = torch.stack(imgs)
    params, vis = model.generator.params, model.params["visual"]
    vit, dino, conv, qf = sphinx._tower_cfgs(args)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        split_ms, crops = _event_ms(lambda: sphinx._split_crops(args, batch))
        tower_ms = {
            "clip": _event_ms(lambda: vit_forward(vis["clip"], vit, crops))[0],
            "convnext": _event_ms(lambda: convnext_forward(
                vis["convnext"], conv, resize_linear(crops, (256, 256))))[0],
            "dinov2": _event_ms(lambda: vit_forward(vis["dinov2"], dino, crops))[0]}
        # the ConvNeXt tower's 40 depthwise sums alone, at each block's shape
        tower_ms["convnext_depthwise"] = 0.0
        for si, stage in enumerate(vis["convnext"]["stages"]):
            side = 64 >> si
            x = torch.randn((crops.shape[0], side, side, conv.dims[si]), device="cuda")
            for i in range(stage["blocks"]["dw"].shape[0]):
                tower_ms["convnext_depthwise"] += _event_ms(
                    lambda: _depthwise7(x, stage["blocks"]["dw"][i]), reps=1)[0]
        del x
        clip_feats = vit_forward(vis["clip"], vit, crops)
        tower_ms["qformer"] = _event_ms(lambda: qformer_forward(vis["qformer"], qf,
                                                                clip_feats))[0]
        del clip_feats
        enc_ms, img_tok = _event_ms(lambda: sphinx.encode_image(params, args, batch))
        encode_peak = torch.cuda.max_memory_allocated()
        toks = torch.full((SPHINX_BATCH, sh["prefill_positions"] - sh["image_words"]), 65,
                          dtype=torch.int64, device="cuda")
        cache = sphinx.init_kv_cache(args, SPHINX_BATCH, sh["cache_len"])
        prefill_ms, (logits, _) = _event_ms(lambda: sphinx.forward(
            params, args, toks, cache=cache, cur_pos=0,
            embeds=sphinx.splice(params, toks, img_tok)))
        if logits.shape[1] != sh["prefill_positions"] or not torch.isfinite(logits).all():
            raise AssertionError("serve_sphinx: prefill logits not finite / wrong shape")
        del logits
        tok = torch.full((SPHINX_BATCH, 1), 66, dtype=torch.int64, device="cuda")
        pos0 = sh["first_decode_pos"]
        for i in range(3):
            sphinx.forward(params, args, tok, cache=cache, cur_pos=pos0 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_steps = 16
        for i in range(n_steps):
            sphinx.forward(params, args, tok, cache=cache, cur_pos=pos0 + i)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        profile = _profile_steps(params, args, tok, cache, pos0, step_ms, steps=4, module=sphinx,
                                 shares=("W4Folded", "decode_attn", "nvjet", "elementwise"))
        del cache
    torch.cuda.empty_cache()

    counts_by_run = {}
    gen = model.generator
    for run in ("batch_caption", "generate_response"):
        timer = _DecodeTimer(gen)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if run == "batch_caption":
            outs = batch_caption(model, imgs, prompt=CAPTION, batch_size=SPHINX_BATCH,
                                 max_gen_len=SPHINX_NEW_TOKENS)
        else:
            outs = [model.generate_response([[CAPTION, None]], image=imgs[0],
                                            max_gen_len=SPHINX_NEW_TOKENS)]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        timer.close()
        counts, steps = kernels.launch_counts(), gen.last_decode_steps
        decode_calls, decode_ms = timer.decode()
        want = _zero_counts(flash_attention=n_layers, kv_write=n_layers,
                            w4_matmul=4 * n_layers * steps, w4_matmul_bigm=4 * n_layers,
                            decode_attention_mha=n_layers * steps)
        b = SPHINX_BATCH if run == "batch_caption" else 1
        row = {"phase": "serve_sphinx", "run": run, "model": "SPHINX-7B (llama_ens5)",
               "batch": b, **sh, "prefill_rows": b * sh["prefill_positions"],
               "decode_steps": steps, "launches": counts, "launches_expected": want,
               "seconds": secs, "outputs_chars": [len(o) for o in outs],
               "decode_ms": decode_ms, "decode_ms_per_step_in_run": decode_ms / max(steps, 1),
               "decode_tok_s": b * steps / max(decode_ms / 1e3, 1e-9)}
        if run == "batch_caption":
            row.update({
                "setup_s": setup_s, "setup_peak_gb": setup_peak / 1e9,
                "weight_gb_w4": _qw_bytes(model.params) / 1e9,
                "tower_gb_f32": sum(t.numel() * 4 for t in _leaves_of(vis)) / 1e9,
                "split_ms": split_ms, "tower_ms": tower_ms, "encode_image_ms": enc_ms,
                "encode_peak_gb": encode_peak / 1e9, "prefill_ms": prefill_ms,
                "decode_ms_per_step": step_ms, "decode_profile": profile,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        emit(row)
        if (counts != want or steps < SPHINX_NEW_TOKENS or len(outs) != b
                or decode_calls != steps):
            raise AssertionError(f"serve_sphinx {run}: launch counts {counts} != {want}, "
                                 f"{decode_calls} timed decode forwards, {steps} steps")
        counts_by_run[run] = counts
    return model, counts_by_run


def _leaves_of(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves_of(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves_of(v)
    else:
        yield node


SCORE_CONTEXTS = ["The capital of France is", "Two plus two equals", "The sky is",
                  "A cat sat on the", "Water boils at one hundred degrees",
                  "The quick brown fox jumps over the lazy dog and then the"]
SCORE_CONTINUATIONS = [" Paris.", " four.", " blue.", " mat.", " Celsius.", " farmer ran away."]
# batched vs per-example log-likelihood, relative: sound runs on the H100 read
# 9.8e-4 (PERF.md); a mask that drops one scored token reads far above
SCORE_TOL_REL = 5e-3


def _forward_counts(n_layers: int, rows):
    """The launches of cache-free forwards of the given row counts: flash once
    a layer, four W4 products a layer on row 5 at 1024 rows or more, on row
    1's many-row tile below."""
    want = _zero_counts()
    for m in rows:
        want["flash_attention"] += n_layers
        want["w4_matmul_bigm" if m >= 1024 else "w4_matmul"] += 4 * n_layers
    return want


def phase_score(model, seed: int):
    """A4 on SPHINX-7B: evaluate_examples of six text examples (batches of 8
    in the 64- and the 128-token bucket: 512 rows on row 1's tile, 1024 on
    row 5) against each example scored alone from compute_logits (the
    reference's per-example path): log-likelihoods within SCORE_TOL_REL of
    |ll| (bf16 logits: the batched and the single forward take other W4
    tiles), max_equal equal; a planted mask fault (the per-example sum
    started one continuation token late) must read above the gate for every
    example. Then two examples with an image each (1455 image words plus
    the text: row 5), finite. Launches counted over both calls, exact
    against the forwards' row counts. Returns the counts."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.models import sphinx

    tok = model.tokenizer
    lens = [len(tok.encode(c + x, bos=True, eos=False))
            for c, x in zip(SCORE_CONTEXTS, SCORE_CONTINUATIONS)]
    buckets = sorted({64 if n <= 64 else 128 for n in lens})
    rows = [8 * b for b in buckets] + [sphinx.image_words(model.args) + n for n in lens[:2]]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = model.evaluate_examples(SCORE_CONTEXTS, SCORE_CONTINUATIONS, batch_size=8)
    imgs = _sphinx_images(seed + 1, 2)
    got_img = model.evaluate_examples(SCORE_CONTEXTS[:2], SCORE_CONTINUATIONS[:2],
                                      images=torch.stack(imgs))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    worst, planted = 0.0, math.inf
    for ctx, cont, r in zip(SCORE_CONTEXTS, SCORE_CONTINUATIONS, got):
        ctx_t = tok.encode(ctx, bos=True, eos=False)
        full = tok.encode(ctx + cont, bos=True, eos=False)
        logp = torch.log_softmax(model.compute_logits([full])[0, :-1].float(), dim=-1)
        tgt = torch.tensor(full[1:], device=logp.device)
        lp = logp.gather(1, tgt[:, None])[:, 0][len(ctx_t) - 1:]
        ll = float(lp.sum())
        same = bool((logp[len(ctx_t) - 1:].argmax(-1) == tgt[len(ctx_t) - 1:]).all())
        worst = max(worst, abs(r["loglikelihood"] - ll) / max(abs(ll), 1e-6))
        planted = min(planted, abs(r["loglikelihood"] - float(lp[1:].sum())) / max(abs(ll), 1e-6))
        if same != r["max_equal"]:
            raise AssertionError(f"score: max_equal {r['max_equal']} != per-example {same}")
    row = {"phase": "score", "model": "SPHINX-7B (llama_ens5)", "text_examples": len(got),
           "image_examples": len(got_img), "seconds": secs,
           "max_rel_ll_err_vs_per_example": worst, "tol_rel": SCORE_TOL_REL,
           "min_rel_ll_err_planted_mask_fault": planted,
           "loglikelihood": [r["loglikelihood"] for r in got + got_img],
           "max_equal": [r["max_equal"] for r in got + got_img], "forward_rows": rows,
           "launches": counts}
    want = _forward_counts(model.args.n_layers, rows)
    emit(row)
    bad = [r for r in got + got_img if not (math.isfinite(r["loglikelihood"]) and r["ppl"] >= 1)]
    if worst > SCORE_TOL_REL or planted <= SCORE_TOL_REL or bad or counts != want:
        raise AssertionError(f"score failed (launches expected {want}): {row}")
    return counts


# ---------------------------------------------------------------- LLaMA-Adapter, SPHINX-MoE and
# finetuning with images


def _open_gates(params, seed: int):
    """The adapter's gates drawn normal from ``seed``, in place (zero gates,
    the init, make the model its LLaMA base). Returns params."""
    import torch

    gate = params["adapter"]["gate"]
    g = torch.Generator(device=gate.device).manual_seed(seed + 7)
    params["adapter"]["gate"] = torch.randn(gate.shape, generator=g,
                                            device=gate.device).to(gate.dtype)
    return params


def _logit_gate(phase: str, gpu, cpu, extra: dict):
    """phase_parity's gate on one pair of logits: max |error| within
    LOGIT_TOL_FRAC of the CPU's largest |logit|, LOGIT_REL_L2 in relative L2,
    greedy tokens equal where the CPU is sure. Emits and returns the row."""
    import torch

    gpu = gpu.float().cpu()
    tol_abs = LOGIT_TOL_FRAC * float(cpu.abs().max())
    top2 = cpu.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > tol_abs
    row = {"phase": phase, **extra, "max_abs_logit_err": float((gpu - cpu).abs().max()),
           "max_rel_l2_err": float((gpu - cpu).norm() / cpu.norm()), "tol_abs": tol_abs,
           "tol_rel_l2": LOGIT_REL_L2, "tokens_checked": int(sure.sum()),
           "tokens_agreed": int((gpu.argmax(-1) == cpu.argmax(-1))[sure].sum())}
    emit(row)
    if (not torch.isfinite(gpu).all() or row["max_abs_logit_err"] > tol_abs
            or row["max_rel_l2_err"] > LOGIT_REL_L2
            or row["tokens_agreed"] != row["tokens_checked"]):
        raise AssertionError(f"{phase} failed: {row}")
    return row


def phase_parity_adapter(seed: int):
    """LLaMA-Adapter at TinyLlama width, 2 layers, the prefix (10 tokens) on
    the last, gates drawn nonzero, W4: phase_parity's CPU-vs-card gate over
    the stacked cache (prefill logits and 16 greedy decode steps teacher-
    forced on the CPU's tokens: flash, the read-only decode kernel, the
    stacked writes, row 1 on the projections and the prefix rows), then the
    cache-free forward(images=) of 2 images through a narrow visual branch
    (v_embed_dim 256: a 2-layer ViT at patch 14), logits at the same gate."""
    import torch

    from accessory_tpu_torch.config import AdapterArgs
    from accessory_tpu_torch.models import llama_adapter
    from accessory_tpu_torch.quant.quantize import quantize_params

    cfg = dict(TINYLLAMA, prefix_len=10, prefix_layers=1, v_embed_dim=256, v_depth=2,
               v_num_heads=4)

    def make(args):
        return quantize_params(_open_gates(llama_adapter.init_params(
            args, seed=seed, with_visual=True), seed))

    phase_parity(seed, "parity_adapter", cfg, 2, b=2, plen=64, steps=16, s_len=128,
                 stacked=True, make_params=make, family="llama_adapter")
    args = AdapterArgs(**dict(cfg, n_layers=2), max_seq_len=128)
    params_g = make(args)
    params_c = _tree_to(params_g, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    imgs = torch.randn((2, 3, 224, 224), generator=g)
    toks = torch.randint(0, args.vocab_size, (2, 64), generator=g)
    with torch.no_grad():
        lg, _ = llama_adapter.forward(params_g, args, toks.cuda(), images=imgs.cuda())
        t0 = time.perf_counter()
        lc, _ = llama_adapter.forward(params_c, args, toks, images=imgs)
        cpu_s = time.perf_counter() - t0
        text_c, _ = llama_adapter.forward(params_c, args, toks)
    _logit_gate("parity_adapter", lg, lc, {
        "path": "cache-free forward(images=)", "layers": 2, "batch": 2, "tokens": 64,
        "visual": "ViT 256 wide, 2 layers, patch 14; projector 2 blocks",
        "cpu_seconds": round(cpu_s, 2),
        "image_moves_logits_max": float((lc - text_c).abs().max())})


def _adapter_model(seed: int):
    """LLaMA-Adapter at 7B widths (ADAPTER_7B): drawn on the card from
    ``seed``, gates opened, quantized to W4 layer by layer. Returns (model,
    setup s, setup peak bytes)."""
    import torch

    from accessory_tpu_torch.meta import MetaModel

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = MetaModel("llama_adapter", dict(ADAPTER_7B), max_seq_len=1024, seed=seed)
    _open_gates(model.params, seed)
    model.tokenizer = ByteTokenizer()
    model.quantize()
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _adapter_counts(n_layers: int, prefix_layers: int, prefill_rows: int, steps: int,
                    prefill: bool = True):
    """The launches of an adapter prefill (if ``prefill``) and ``steps`` decode
    steps: 7 W4 products a layer (row 5 from 1024 rows) and 2 on each prefix
    layer's prefix rows (row 1's tile) a forward; flash a layer and one
    stacked slab write at the prefill; the read-only one-query-head decode a
    layer and one stacked column write a step."""
    forwards = steps + int(prefill)
    w4 = 2 * prefix_layers * forwards + 7 * n_layers * steps
    want = _zero_counts(w4_matmul=w4, decode_attention_mha_ro=n_layers * steps,
                        kv_write_stacked_col=steps)
    if prefill:
        want.update(flash_attention=n_layers, kv_write_stacked=1)
        want["w4_matmul_bigm" if prefill_rows >= 1024 else "w4_matmul"] += 7 * n_layers
    return want


def phase_serve_adapter(seed: int, steps: int = 30):
    """LLaMA-Adapter at LLaMA2-7B widths (32 layers, MHA, prefix_len 10 on
    the last 30 layers, gates nonzero), W4 g128 drawn on the card: the 8
    PROMPTS (1024 prefill rows) and 32 new tokens through MetaModel.generate
    (the Generator's stacked route), then the bench shape (batch 8, a
    1024-token stacked cache, a counted 8 x 512 prefill and ``steps`` decode
    steps from position 512): prefill ms, wall ms a step, tok/s, device busy
    and idle share from a profiled window, launch counts exact. Returns
    (serve counts, bench counts)."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.models import llama_adapter
    from accessory_tpu_torch.quant.qtensor import QuantizedWeight

    model, setup_s, setup_peak = _adapter_model(seed)
    args, n_layers = model.args, model.args.n_layers
    pl = args.prefix_layers
    if model.generator.unroll_decode:
        raise AssertionError("serve_adapter: the Generator must take the stacked route")
    prompts = PROMPTS
    prefill_ms = _timed_prefill(model, 8, 128, 192, None)
    outs, counts, steps_g, total_s = _counted_generate(model, prompts, 32)
    want = _adapter_counts(n_layers, pl, 8 * 128, steps_g)
    row = {"phase": "serve_adapter", "model": "LLaMA-Adapter, LLaMA2-7B widths",
           "prefix_len": args.prefix_len, "prefix_layers": pl, "layers": n_layers,
           "batch": len(prompts), "prefill_rows": 8 * 128, "decode_steps": steps_g,
           "launches": counts, "launches_expected": want, "setup_s": setup_s,
           "setup_peak_gb": setup_peak / 1e9, "weight_gb_w4": _qw_bytes(model.params) / 1e9,
           "prefill_ms": prefill_ms, "generate_s": total_s,
           "decode_tok_s": len(prompts) * steps_g / max(total_s - prefill_ms / 1e3, 1e-9),
           "outputs_chars": [len(o) for o in outs]}
    emit(row)
    if counts != want or steps_g < 32 or len(outs) != len(prompts):
        raise AssertionError(f"serve_adapter: launch counts {counts} != expected {want}")

    params, batch, cache_len, pos0 = model.params, ADAPTER_BATCH, 1024, 512
    cache = llama_adapter.init_kv_cache(args, batch, cache_len)
    prompt = torch.randint(0, 256, (batch, pos0), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(seed))
    tok = torch.ones((batch, 1), dtype=torch.int64, device="cuda")
    with torch.no_grad():
        kernels.reset_launch_counts()
        bench_prefill_ms, (logits, _) = _event_ms(lambda: llama_adapter.forward(
            params, args, prompt, cache=cache, cur_pos=0), reps=1)
        for i in range(3):
            llama_adapter.forward(params, args, tok, cache=cache, cur_pos=pos0 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            logits, _ = llama_adapter.forward(params, args, tok, cache=cache, cur_pos=pos0 + i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        bench = kernels.launch_counts()
        profile = _profile_steps(params, args, tok, cache, pos0, ms, steps=5,
                                 module=llama_adapter,
                                 shares=("W4Folded", "FoldedB", "decode_attn", "elementwise"))
    want = _adapter_counts(n_layers, pl, batch * pos0, steps + 3)
    w_bytes = sum(_qw_bytes(v) for k, v in params.items() if k != "tok_embeddings") \
        + sum(t.numel() * t.element_size() for k, t in
              (("output", params["output"]["weight"]), ("prefix", params["adapter"]["prefix"])))
    mid = pos0 + steps // 2
    kv_bytes = 2 * n_layers * batch * args.kv_heads * mid * args.head_dim * 2
    b_ms, _ = bound_ms(w_bytes + kv_bytes, 0.0)
    row = {"phase": "serve_adapter", "bench": "batch 8, stacked cache 1024, decode from 512",
           "prefill_rows": batch * pos0, "prefill_ms": bench_prefill_ms, "steps": steps,
           "ms_per_step": ms, "tok_s": batch / ms * 1e3, "bound_ms_per_step": b_ms,
           "weight_bytes": w_bytes, "kv_bytes_mid": kv_bytes, "profile": profile,
           "launches": bench, "launches_expected": want,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    if bench != want or not torch.isfinite(logits).all():
        raise AssertionError(f"serve_adapter bench: launch counts {bench} != {want} "
                             "or non-finite logits")
    del model, cache, params
    torch.cuda.empty_cache()
    return counts, bench


# SPHINX-MoE (mixtral_sparse_ens5): the Mixtral-8x7B decoder of
# BASELINE.json config 3 and SPHINX's production towers at 448 px (5 crops,
# 1455 image words), the caption workload of serve_sphinx
SPHINX_MOE_TYPE = "mixtral_sparse_ens5"
# narrow SPHINX-MoE for parity_sphinx_moe: 4 experts, 2 layers, head_dim 128,
# towers 256 wide (2 blocks each, patch 14: every tower's 257 tokens)
SPHINX_MOE_NARROW = dict(dim=1024, n_heads=8, n_kv_heads=2, hidden_dim=2048, num_experts=4,
                         num_experts_per_tok=2, vocab_size=32000, rope_theta=1e6,
                         dtype="bfloat16", clip_width=256, clip_layers=2, clip_heads=4,
                         dino_width=256, dino_layers=2, dino_heads=4,
                         convnext_depths=(1, 1, 1, 1), convnext_dims=(64, 128, 256, 512),
                         qformer_width=256, qformer_layers=2, qformer_heads=4)


def phase_parity_sphinx_moe(seed: int, plen: int = 32, steps: int = 8):
    """A narrow SPHINX-MoE (SPHINX_MOE_NARROW: 2 layers, 4 experts top 2,
    narrow towers, ens5 at 448 px: 1455 image words), W4, one image a row, 2
    rows: the card against the CPU on the same weights: encode_image's bf16
    tokens (2 bf16 ulps of their largest |value|, 4e-3 relative L2), then
    ``_moe_parity`` over the prefill of [BOS, image words, text] and
    ``steps`` decode steps at positions shifted by the image words (logits
    where the routing agreed; a flip's gap within twice the router scores'
    measured noise, the card's choice the top 2 of its own scores)."""
    import torch

    from accessory_tpu_torch.config import SphinxMoEArgs
    from accessory_tpu_torch.models import sphinx_moe
    from accessory_tpu_torch.quant.quantize import DEFAULT_BLOCKLIST, quantize_params

    args = SphinxMoEArgs(**dict(SPHINX_MOE_NARROW, n_layers=2), visual="ens5", image_size=448,
                         max_seq_len=SPHINX_MAX_SEQ)
    block = tuple(DEFAULT_BLOCKLIST) + tuple(sphinx_moe.get_quant_blocklist(args))
    params_g = quantize_params(sphinx_moe.init_params(args, seed=seed), blocklist=block)
    torch.cuda.empty_cache()
    params_c = _tree_to(params_g, "cpu")
    g = torch.Generator().manual_seed(seed)
    imgs = torch.randn((2, 3, 448, 448), generator=g)
    prompt = torch.randint(0, args.vocab_size, (2, plen), generator=g)
    with torch.no_grad():
        tok_g = sphinx_moe.encode_image(params_g, args, imgs.cuda())
        t0 = time.perf_counter()
        tok_c = sphinx_moe.encode_image(params_c, args, imgs)
        tower_s = time.perf_counter() - t0
    n_img = sphinx_moe.image_words(args)
    tok_absmax = float(tok_c.float().abs().max())
    tok_err = max_err(tok_g.float().cpu(), tok_c.float())
    tok_rel = float((tok_g.float().cpu() - tok_c.float()).norm() / tok_c.float().norm())
    if tok_g.shape != (2, n_img, args.dim) or n_img != 1455 or \
            tok_err[0] > 2 * bf16_ulp(tok_absmax) or tok_rel > 4e-3:
        raise AssertionError(f"parity_sphinx_moe encode_image: {tok_err}, {tok_rel}, "
                             f"{tuple(tok_g.shape)}")
    # 4 experts: router scores twice Mixtral's 8-expert scale, so a flip's
    # gap is held to the scores' measured noise, not parity_moe's fixed one
    row = _moe_parity("parity_sphinx_moe", "SPHINX-MoE narrow (ens5, 2 layers, 4 experts)",
                      sphinx_moe, args, params_g, params_c, prompt, steps,
                      image_tokens=(tok_g, tok_c), flip_gap=None)
    emit(dict(row, image_tokens_max_abs_err=tok_err[0], image_tokens_rel_l2=tok_rel,
              image_tokens_absmax=tok_absmax, cpu_tower_seconds=round(tower_s, 2)))


def _device_split(fn, groups):
    """Device ms of one call of ``fn`` by kernel-name substring groups
    ({label: (substrings)}), from torch.profiler's CUDA trace; (busy ms,
    {label: ms}, the call's result)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        out = fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in p.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if e.device_type == DeviceType.CUDA and us:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3
    split = {label: sum(v for k, v in by_kernel.items() if any(sub in k for sub in subs))
             for label, subs in groups.items()}
    return sum(by_kernel.values()), split, out


def phase_serve_sphinx_moe(seed: int):
    """SPHINX-MoE at full width and depth (mixtral_sparse_ens5: Mixtral-8x7B
    W4 g128 drawn on the card, the production towers in f32, 448 px, 1455
    image words): the time to first token split into encode_image (CUDA
    events) and the 13688-row prefill (CUDA events; a profiled second
    prefill gives row 5's share of its device time), a separate decode loop
    (wall ms a step, device busy and idle share), then sphinx_api.
    batch_caption of 8 images with 32 new tokens, counted: flash and the
    slab write a layer, the fused GQA decode a layer a step, the W4 entries
    from the routing the run recorded (4 + 3 x touched experts a layer a
    forward), its decode timed on CUDA events. Setup s and peak GB. Returns
    the caption run's counts and the model."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.models import sphinx_moe
    from accessory_tpu_torch.ops import moe
    from accessory_tpu_torch.sphinx_api import batch_caption

    sh = _sphinx_shapes()
    model, setup_s, setup_peak = _mixtral_model(seed, SPHINX_MAX_SEQ, SPHINX_MOE_TYPE)
    args, n_layers = model.args, model.args.n_layers
    if sphinx_moe.image_words(args) != sh["image_words"] or not model.with_visual:
        raise AssertionError(f"serve_sphinx_moe: {sphinx_moe.image_words(args)} image words")
    imgs = _sphinx_images(seed, SPHINX_BATCH)
    batch = torch.stack(imgs)
    params = model.generator.params
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        enc_ms, img_tok = _event_ms(lambda: sphinx_moe.encode_image(params, args, batch))
        toks = torch.full((SPHINX_BATCH, sh["prefill_positions"] - sh["image_words"]), 65,
                          dtype=torch.int64, device="cuda")
        cache = sphinx_moe.init_kv_cache(args, SPHINX_BATCH, sh["cache_len"])
        emb = sphinx_moe.splice(params, toks, img_tok)

        def prefill():
            return sphinx_moe.forward(params, args, toks, cache=cache, cur_pos=0, embeds=emb)

        prefill_ms, (logits, _) = _event_ms(prefill, reps=1)
        if logits.shape[1] != sh["prefill_positions"] or not torch.isfinite(logits).all():
            raise AssertionError("serve_sphinx_moe: prefill logits not finite / wrong shape")
        del logits
        busy, split, _ = _device_split(prefill, {
            "row 5 (w4_bigm_wgmma_kernel)": ("w4_bigm_wgmma_kernel",),
            "row 3 (flash_fwd_wgmma_kernel)": ("flash_fwd_wgmma_kernel",),
            "row 4 (kv_write_kernel)": ("kv_write_kernel",)})
        tok = torch.full((SPHINX_BATCH, 1), 66, dtype=torch.int64, device="cuda")
        pos0 = sh["first_decode_pos"]
        for i in range(2):
            sphinx_moe.forward(params, args, tok, cache=cache, cur_pos=pos0 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_steps = 8
        for i in range(n_steps):
            sphinx_moe.forward(params, args, tok, cache=cache, cur_pos=pos0 + i)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        profile = _profile_steps(params, args, tok, cache, pos0, step_ms, steps=3,
                                 module=sphinx_moe,
                                 shares=("W4Folded", "decode_attn", "elementwise"))
        del cache, emb, img_tok
    torch.cuda.empty_cache()

    gen = model.generator
    timer = _DecodeTimer(gen)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with moe.record_routing() as log:
        outs = batch_caption(model, imgs, prompt=CAPTION, batch_size=SPHINX_BATCH,
                             max_gen_len=SPHINX_NEW_TOKENS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    timer.close()
    counts, steps = kernels.launch_counts(), gen.last_decode_steps
    decode_calls, decode_ms = timer.decode()
    want = _zero_counts(flash_attention=n_layers, kv_write=n_layers,
                        decode_attention=n_layers * steps,
                        **_moe_matmul_counts(log, model.args.num_experts,
                                             decode_forwards=n_layers * steps))
    row = {"phase": "serve_sphinx_moe", "run": "batch_caption",
           "model": "SPHINX-MoE (mixtral_sparse_ens5)", "batch": SPHINX_BATCH, **sh,
           "prefill_rows": SPHINX_BATCH * sh["prefill_positions"], "decode_steps": steps,
           "launches": counts, "launches_expected": want, "seconds": secs,
           "outputs_chars": [len(o) for o in outs],
           "setup_s": setup_s, "setup_peak_gb": setup_peak / 1e9,
           "weight_gb_w4": _qw_bytes(model.params) / 1e9,
           "tower_gb_f32": sum(t.numel() * 4 for t in _leaves_of(model.params["visual"])) / 1e9,
           "encode_image_ms": enc_ms, "prefill_ms": prefill_ms,
           "time_to_first_token_ms": enc_ms + prefill_ms,
           "prefill_device_busy_ms": busy, "prefill_device_ms": split,
           "prefill_row5_share_of_busy": split["row 5 (w4_bigm_wgmma_kernel)"] / busy
           if busy else None,
           "touched_experts_prefill_mean": _touched_mean(log, SPHINX_BATCH
                                                         * sh["prefill_positions"]),
           "touched_experts_decode_mean": _touched_mean(log, SPHINX_BATCH),
           "decode_ms_per_step": step_ms, "decode_profile": profile,
           "decode_ms": decode_ms, "decode_ms_per_step_in_run": decode_ms / max(steps, 1),
           "decode_tok_s": SPHINX_BATCH * steps / max(decode_ms / 1e3, 1e-9),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    if (counts != want or steps < SPHINX_NEW_TOKENS or len(outs) != SPHINX_BATCH
            or decode_calls != steps
            or len(log) != n_layers * (1 + (1 if gen.graphs else steps))):
        raise AssertionError(f"serve_sphinx_moe: launch counts {counts} != {want}, "
                             f"{decode_calls} timed decode forwards, {steps} steps")
    return counts, model


# the image step's small-width parity: SPHINX (llama_ens, one 224-px crop:
# 291 image words) at TinyLlama width, 2 layers, QPEFT, narrow towers
TRAIN_MM_NARROW = dict(TINYLLAMA, n_layers=2, **QPEFT, clip_width=256, clip_layers=2,
                       clip_heads=4, dino_width=256, dino_layers=2, dino_heads=4,
                       convnext_depths=(1, 1, 1, 1), convnext_dims=(64, 128, 256, 512),
                       qformer_width=256, qformer_layers=2, qformer_heads=4)


def _mm_model(llama_type: str, cfg: dict, seed: int, device="cuda", seq_len: int = 2048):
    """A SPHINX family's QPEFT training model: random weights from ``seed``,
    the decoder's base quantized to W4, trainable leaves as f32 masters, the
    towers f32. Returns (module, args, params, trainable)."""
    from accessory_tpu_torch.meta import MetaModel
    from accessory_tpu_torch.train.precision import promote_trainable_params_to_fp32

    model = MetaModel(llama_type, dict(cfg), max_seq_len=seq_len, seed=seed, device=device)
    model.quantize()
    trainable = model.module.get_trainable_params_filter(model.args)
    return (model.module, model.args,
            promote_trainable_params_to_fp32(model.params, trainable), trainable)


def _mm_batch(seed: int, b: int, s: int, size: int, vocab: int, device="cpu"):
    import torch

    g = torch.Generator().manual_seed(seed)
    return {"examples": torch.randint(3, vocab, (b, s), generator=g),
            "labels": torch.randint(3, vocab, (b, s), generator=g),
            "images": torch.randn((b, 3, size, size), generator=g).to(device)}


def phase_train_mm_parity(seed: int):
    """One image training step (make_train_step with images) at small width
    (TRAIN_MM_NARROW: llama_ens, 4 examples of 291 image words and 64 text
    tokens, 1420 rows on row 5, bf16, every layer checkpointed) on the CPU
    through the plain versions and on the card through the kernels, same
    weights and batch: the loss to 1e-2 relative and every trainable leaf's
    gradient to 6e-2 relative L2 (train_parity's tolerances), no gradient on
    a frozen tower leaf, launch counts exact."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from accessory_tpu_torch.train.train_step import grads_of

    module, args, params, trainable = _mm_model("llama_ens", TRAIN_MM_NARROW, seed, "cpu",
                                                seq_len=512)
    gen = torch.Generator().manual_seed(seed)
    for layer in params["layers"]:          # non-zero lora_b / bias: every gradient moves
        for part in ("attention", "feed_forward"):
            for mod in layer[part].values():
                for name in ("lora_b", "bias"):
                    mod[name] = torch.randn(mod[name].shape, generator=gen) * 0.02
    card = _tree_to(params, "cuda")
    batch = _mm_batch(seed, 4, 64, 224, args.vocab_size)
    res = {}
    for device, p in (("cpu", params), ("cuda", card)):
        tx = make_optimizer(p, 1e-3, weight_decay=0.02, clip_norm=2.0, trainable=trainable)
        state = TrainState.create(p, tx)
        step = make_train_step(module, args, tx, remat="full", device=device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        res[device] = dict(loss=float(m["c_loss"]), secs=time.perf_counter() - t0,
                           counts=kernels.launch_counts(),
                           grads={k: g.float().cpu() for k, g in grads_of(state).items()})
    c, g = res["cpu"], res["cuda"]
    train = sorted(k for k in c["grads"] if trainable(k))
    worst = max(float((g["grads"][k] - c["grads"][k]).norm()
                      / c["grads"][k].norm().clamp_min(1e-30)) for k in train)
    _, want = _train_counts(args.n_layers, True, True)
    row = {"phase": "train_mm", "part": "parity", "model": "llama_ens, TinyLlama width, "
           "2 layers, QPEFT (W4 g128, LoRA 16, bias, norm), narrow towers",
           "batch": [4, 64], "image_words": 291, "rows": 4 * (291 + 64), "remat": "full",
           "loss_cpu": c["loss"], "loss_cuda": g["loss"], "cpu_s": c["secs"],
           "cuda_s": g["secs"], "trainable_leaves": len(train),
           "tolerances": {"loss_rel": 1e-2, "grad_rel_l2": 6e-2}, "worst_grad_rel_l2": worst,
           "visual_leaves_with_grad": [k for k in g["grads"] if k.startswith("visual/")],
           "launches": g["counts"], "launches_expected": want}
    emit(row)
    if not (abs(g["loss"] - c["loss"]) <= 1e-2 * abs(c["loss"]) and worst <= 6e-2
            and not row["visual_leaves_with_grad"] and g["counts"] == want):
        raise AssertionError(f"train_mm parity failed: {row}")
    return g["counts"]


def phase_train_mm(seed: int, steps: int = 2):
    """The full-width image step: SPHINX-7B (llama_ens5: LLaMA2-7B W4 g128
    QPEFT, LoRA 16, bias and norm tuning; the production towers frozen in
    f32) on TRAIN_MM_BATCH examples of 448-px images (1455 image words) and
    TRAIN_MM_TEXT text tokens, every layer checkpointed: a warm-up and
    ``steps`` timed steps on the same batch (losses finite and falling), ms a
    step, rows and text tokens a second, peak memory, launch counts exact,
    and one profiled step split by kernel with its idle share."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    module, args, params, trainable = _mm_model(SPHINX_TYPE, dict(LLAMA2_7B, **QPEFT), seed)
    tx = make_optimizer(params, 1e-3, weight_decay=0.02, clip_norm=2.0, trainable=trainable)
    state = TrainState.create(params, tx)
    step = make_train_step(module, args, tx, remat="full")
    data = _mm_batch(seed, TRAIN_MM_BATCH, TRAIN_MM_TEXT, 448, args.vocab_size, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
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
        losses.append(float(m["c_loss"]))
        times.append((time.perf_counter() - t1) * 1e3)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    by_pass, want = _train_counts(args.n_layers, True, True, steps)
    ms = statistics.median(times)
    state, prof = _split_profile(step, state, data, ms)
    row = {"phase": "train_mm", "part": "full width",
           "model": "SPHINX-7B (llama_ens5) QPEFT (W4 g128, LoRA 16, bias, norm), towers f32",
           "batch": TRAIN_MM_BATCH, "text_tokens": TRAIN_MM_TEXT, "image_words": 1455,
           "rows": TRAIN_MM_ROWS, "remat": "full", "setup_s": setup_s,
           "setup_peak_gb": setup_peak / 1e9, "ms_per_step": ms, "ms_per_step_all": times,
           "rows_per_s": TRAIN_MM_ROWS / ms * 1e3,
           "text_tok_s": TRAIN_MM_BATCH * TRAIN_MM_TEXT / ms * 1e3, "peak_gb": peak / 1e9,
           "losses": losses, "launches_per_step_by_pass": by_pass, "launches": counts,
           "launches_expected": want, "profile": prof}
    emit(row)
    if counts != want:
        raise AssertionError(f"train_mm: launch counts {counts} != expected {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_mm: losses not finite and falling: {losses}")
    del state, params, step, tx, data
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- the rest of training



def _moe_train_counts(log, n_layers: int) -> dict:
    """Launches of one Mixtral training step with every layer checkpointed
    ("full") from the routing it recorded (``record_routing``: the forward's
    entries, then the recompute's, which replay them): the forward and the
    recompute each launch wq, wk, wv, wo and w1 / w3 / w2 of every touched
    expert on all rows (row 5 from 1024 rows, row 1's tile below), the
    backward one W4 dequant a product and the flash backward a layer."""
    fwd = [e for e in log if not e.get("replayed")]
    if len(fwd) != n_layers or len(log) != 2 * n_layers:
        raise AssertionError(f"{len(fwd)} forward and {len(log) - len(fwd)} recompute "
                             f"routings for {n_layers} layers")
    w4 = sum(4 + 3 * sum(e["touched"]) for e in fwd)
    name = "w4_matmul_bigm" if fwd[0]["rows"] >= 1024 else "w4_matmul"
    return _zero_counts(**{name: 2 * w4}, w4_dequant=w4, flash_attention=2 * n_layers,
                        flash_attention_bwd_dq=n_layers, flash_attention_bwd_dkdv=n_layers)


def _recompute_routing(log, n_layers: int) -> dict:
    """The recompute's routing against the forward's: the experts each
    recomputed layer took (replayed: equal to the forward's, asserted) and
    the rows where its own router scores would have chosen others."""
    import torch

    fwd, rec = log[:n_layers], log[n_layers:][::-1]       # the backward runs the layers last first
    rerouted = 0
    for f, r in zip(fwd, rec):
        if not (r.get("replayed") and torch.equal(r["idx"], f["idx"])
                and r["touched"] == f["touched"]):
            raise AssertionError("train_moe: a recompute did not route as its forward")
        own = r["own_idx"].sort(dim=-1).values.cpu().to(f["idx"].dtype)
        rerouted += int((own != f["idx"].sort(dim=-1).values).any(dim=-1).sum())
    return {"layers_replayed": len(rec), "rows_own_scores_would_reroute": rerouted}


def _train_sub(model, n_layers: int):
    """The first ``n_layers`` of a model's params (the same tensors) and args."""
    import dataclasses

    params = dict(model.params, layers=model.params["layers"][:n_layers])
    return params, dataclasses.replace(model.args, n_layers=n_layers)


def _moe_train_parity(phase: str, desc: str, module, args, params, batch, trainable,
                      device="cuda"):
    """One training step with the MoE loss on the CPU through the plain
    versions and on ``device`` through the kernels, same weights (each side
    its own f32 masters) and batch, every layer kept (remat False); the card
    runs inside the CPU's recorded routing (``ops.moe.routing_replay``), so
    a bf16 tie cannot flip an expert between the two. Held: loss, c_loss and
    aux_loss to 1e-2 relative, every trainable leaf's gradient to 6e-2
    relative L2 (tests/test_torch_train_step.py's bf16 TOL), launch counts
    exact to the routing."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.ops import moe
    from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from accessory_tpu_torch.train.precision import promote_trainable_params_to_fp32
    from accessory_tpu_torch.train.train_step import grads_of

    cpu = _tree_to(params, "cpu")
    memo, res = [], {}
    for dev, p in (("cpu", cpu), (device, _tree_to(cpu, device))):
        p = promote_trainable_params_to_fp32(p, trainable)
        tx = make_optimizer(p, 1e-4, clip_norm=1.0, trainable=trainable)
        step = make_train_step(module, args, tx, remat=False, moe_aux=True, device=dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with moe.record_routing() as log, moe.routing_replay(
                [m.to(dev) for m in memo] if memo else memo):
            state, m = step(TrainState.create(p, tx), batch)
            met = {k: float(v) for k, v in m.items()}
        res[dev] = dict(met=met, secs=time.perf_counter() - t0, counts=kernels.launch_counts(),
                        log=log, grads={k: g.float().cpu() for k, g in grads_of(state).items()})
        del state, tx, p
    c, g = res["cpu"], res[device]
    paths = sorted(k for k in c["grads"] if trainable(k))
    worst = max(float((g["grads"][k] - c["grads"][k]).norm()
                      / c["grads"][k].norm().clamp_min(1e-30)) for k in paths)
    rows = g["log"][0]["rows"]
    w4 = sum(4 + 3 * sum(e["touched"]) for e in g["log"])
    want = _zero_counts(**{"w4_matmul_bigm" if rows >= 1024 else "w4_matmul": w4},
                        w4_dequant=w4, flash_attention=args.n_layers,
                        flash_attention_bwd_dq=args.n_layers,
                        flash_attention_bwd_dkdv=args.n_layers)
    rel = {k: abs(g["met"][k] - c["met"][k]) / abs(c["met"][k])
           for k in ("loss", "c_loss", "aux_loss")}
    row = {"phase": phase, "part": "parity", "model": desc, "rows": rows, "remat": False,
           "cpu": c["met"], "cuda": g["met"], "rel_err": rel, "worst_grad_rel_l2": worst,
           "trainable_leaves": len(paths), "cpu_s": c["secs"], "cuda_s": g["secs"],
           "touched": [e["touched"] for e in g["log"]],
           "tolerances": {"loss_rel": 1e-2, "grad_rel_l2": 6e-2},
           "launches": g["counts"], "launches_expected": want}
    emit(row)
    if not (max(rel.values()) <= 1e-2 and worst <= 6e-2 and g["counts"] == want
            and [e["touched"] for e in g["log"]] == [e["touched"] for e in c["log"]]
            and c["met"]["aux_loss"] > 0):
        raise AssertionError(f"{phase} parity failed: {row}")
    return g["counts"]


def _moe_steps(phase: str, module, args, params, batch, trainable, steps: int, lr: float,
               images_rows: int = 0):
    """A warm-up and ``steps`` timed training steps with the MoE loss, every
    layer checkpointed ("full"), on the same batch: per step ms, tokens (rows)
    a second, loss, c_loss, aux_loss, grad_norm and the launch counts, exact
    to the routing the step recorded, and the recompute's routing against
    the forward's; then one profiled step (busy ms and idle share,
    ``util.profiling.busy_profile``). Returns (rows, counts of the timed
    steps)."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.ops import moe
    from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from accessory_tpu_torch.train.precision import promote_trainable_params_to_fp32
    from accessory_tpu_torch.util import profiling

    params = promote_trainable_params_to_fp32(params, trainable)
    tx = make_optimizer(params, lr, weight_decay=0.0, clip_norm=1.0, trainable=trainable)
    holder = [TrainState.create(params, tx)]
    step = make_train_step(module, args, tx, remat="full", moe_aux=True)
    n_rows = batch["examples"].shape[0] * batch["examples"].shape[1] + images_rows

    def one():
        holder[0], m = step(holder[0], batch)
        return {k: float(v) for k, v in m.items()}

    warm = one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total, per_step = {}, []
    for _ in range(steps):
        kernels.reset_launch_counts()
        with moe.record_routing(detail=True) as log:
            t1 = time.perf_counter()
            met = one()
            ms = (time.perf_counter() - t1) * 1e3
        counts = kernels.launch_counts()
        want = _moe_train_counts(log, args.n_layers)
        if counts != want:
            raise AssertionError(f"{phase}: launch counts {counts} != expected {want}")
        _add_counts(total, counts)
        per_step.append({"ms": ms, "tok_s": n_rows / ms * 1e3, **met,
                         "touched_mean": _touched_mean(log[:args.n_layers]),
                         **_recompute_routing(log, args.n_layers)})
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(s["ms"] for s in per_step)
    prof = profiling.busy_profile(one, 1, wall_ms=ms,
                                  shares=("w4_bigm_wgmma_kernel", "w4_dequant",
                                          "flash_fwd_wgmma_kernel", "flash_bwd"))
    if not all(math.isfinite(s[k]) for s in per_step + [warm]
               for k in ("loss", "c_loss", "aux_loss", "grad_norm")) \
            or not all(s["aux_loss"] > 0 for s in per_step):
        raise AssertionError(f"{phase}: metrics not finite, or aux_loss not > 0: {per_step}")
    del holder, tx, params
    return {"rows_per_step": n_rows, "warm_up": warm, "steps": per_step, "ms_per_step": ms,
            "peak_bytes": peak, "profile": prof}, total


def phase_train_moe(model, seed: int, steps: int = 2):
    """Mixtral-8x7B trained with the MoE loss at full width and depth on the
    serve phases' model (W4 g128 experts and attention, router f32, from
    --seed): first a parity of its first 2 layers, CPU against the card, on
    1 x 64 tokens (``_moe_train_parity``); then a warm-up and ``steps``
    timed steps on 1 x TRAIN_MOE_ROWS tokens, ``moe_aux``, remat "full", the W4 base
    frozen and every dense leaf trained (norms, router, embedding, head) as
    f32 masters (``_moe_steps``: rows 5, 6, 3 and 3b, launches exact to the
    recorded routing, the recompute routed as the forward). Returns the
    counts of the timed steps."""
    import torch

    from accessory_tpu_torch.models import mixtral

    trainable = mixtral.get_trainable_params_filter(model.args)
    sub, args2 = _train_sub(model, 2)
    _moe_train_parity("train_moe", "Mixtral-8x7B width, 2 layers, W4 g128", mixtral, args2,
                      sub, _token_batch(seed, 1, 64, args2.vocab_size), trainable)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res, counts = _moe_steps("train_moe", mixtral, model.args, model.params,
                             _token_batch(seed, 1, TRAIN_MOE_ROWS, model.args.vocab_size),
                             trainable, steps, lr=1e-5)
    emit({"phase": "train_moe", "part": "full width and depth",
          "model": "Mixtral-8x7B shape, W4 g128 experts and attention, router f32",
          "layers": model.args.n_layers, "batch": [1, TRAIN_MOE_ROWS], "remat": "full",
          "moe_aux": True, "trained": "every dense leaf (norms, router, embedding, head), "
          "f32 masters; W4 frozen", "seconds": time.perf_counter() - t0, **res,
          "launches": counts})
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# SPHINX-MoE's training step: one 448-px image (1455 image words) and 64 text
# tokens; its decoder cut to TRAIN_SPHINX_MOE_LAYERS of 32 layers to fit the run
TRAIN_SPHINX_MOE_TEXT, TRAIN_SPHINX_MOE_LAYERS = 64, 8


def phase_train_sphinx_moe(model, seed: int, steps: int = 1):
    """SPHINX-MoE (mixtral_sparse_ens5) trained with the MoE loss on the
    model ``phase_serve_sphinx_moe`` built (full width: Mixtral-8x7B W4 g128,
    the production towers f32 and frozen), its decoder cut to its first
    TRAIN_SPHINX_MOE_LAYERS layers: a warm-up and ``steps`` timed image
    steps of 1 x (1455 + TRAIN_SPHINX_MOE_TEXT) rows (``_moe_steps``). Returns
    the timed steps' counts."""
    import torch

    sub, args = _train_sub(model, TRAIN_SPHINX_MOE_LAYERS)
    trainable = model.module.get_trainable_params_filter(model.args)
    batch = _mm_batch(seed, 1, TRAIN_SPHINX_MOE_TEXT, 448, args.vocab_size, "cuda")
    t0 = time.perf_counter()
    res, counts = _moe_steps("train_sphinx_moe", model.module, args, sub, batch, trainable,
                             steps, lr=1e-5, images_rows=1455)
    emit({"phase": "train_sphinx_moe", "part": "full width, depth cut",
          "model": f"SPHINX-MoE (mixtral_sparse_ens5), Mixtral-8x7B width W4 g128, the first "
          f"{TRAIN_SPHINX_MOE_LAYERS} of {model.args.n_layers} layers, towers f32 frozen",
          "batch": [1, TRAIN_SPHINX_MOE_TEXT], "image_words": 1455, "remat": "full",
          "moe_aux": True, "seconds": time.perf_counter() - t0, **res, "launches": counts})
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_train_sphinx_moe_parity(seed: int):
    """A narrow SPHINX-MoE (SPHINX_MOE_NARROW: 2 layers, 4 experts top 2,
    narrow towers at 448 px, 1455 image words) image step with the MoE loss,
    CPU against the card (``_moe_train_parity``, W4 g128 decoder, every dense
    decoder leaf trained, towers frozen), on one image and 32 text tokens."""
    from accessory_tpu_torch.meta import MetaModel

    model = MetaModel(SPHINX_MOE_TYPE, dict(SPHINX_MOE_NARROW, n_layers=2), max_seq_len=2048,
                      seed=seed, device="cpu")
    model.quantize()
    trainable = model.module.get_trainable_params_filter(model.args)
    batch = _mm_batch(seed, 1, 32, 448, model.args.vocab_size)
    return _moe_train_parity("train_sphinx_moe", "SPHINX-MoE narrow (SPHINX_MOE_NARROW, 2 "
                             "layers), W4 g128, 1 image of 1455 words + 32 tokens",
                             model.module, model.args, model.params, batch, trainable)


def _pretrain_args(tmp: str, cfg_path: str, out: str, iters: int, freq: int):
    from accessory_tpu_torch import main_pretrain

    return main_pretrain.get_args_parser().parse_args([
        "--llama_config", cfg_path, "--tokenizer_path", "unused", "--data_meta_path",
        f"{tmp}/packed", "--packed_data", "--output_dir", out, "--batch_size",
        str(PRETRAIN_BATCH), "--max_words", str(PRETRAIN_WORDS), "--precision", "bf16",
        "--checkpointing", "--max_iters", str(iters), "--save_freq", str(freq), "--val_freq",
        str(freq), "--val_iters", "1", "--warmup_iters", "1", "--lr_decay_iters", "100",
        "--lr", "3e-4", "--log_every", "1000"])


def phase_pretrain(seed: int, iters: int = 5):
    """Pretraining through ``main_pretrain.main``: packed train and
    validation shards written from seeded tokens by the port's tool
    (``tools.generate_packed_data.pack_tokens`` over ``native.pack_stream``,
    the C library built on the card, asserted), then TinyLlama at full width
    and depth (22 layers, bf16 weights and AdamW moments, no f32 masters, as
    the reference's loop), ``--checkpointing`` (the selective remat),
    PRETRAIN_BATCH x PRETRAIN_WORDS tokens an iteration, ``iters``
    iterations: per iteration ms, tokens/s and c_loss (finite), peak memory,
    launch counts exact (22 flash forwards an iteration: the selective remat
    keeps each layer's flash output), the last iteration profiled (busy ms
    and idle share against the others' median). Then the save, validation
    and resume leg at 2 layers: 2 iterations with a save and a validation at iteration
    2, and a second call resuming to 4: the iteration, the step and the
    dataset position carried over, validation losses finite. Returns the
    full-width run's counts."""
    import os

    import numpy as np
    import torch

    from accessory_tpu_torch import kernels, main_pretrain, native, train
    from accessory_tpu_torch.tools.generate_packed_data import pack_tokens
    from accessory_tpu_torch.util import profiling

    if not native.available():
        raise AssertionError(f"pretrain: the native library did not build: {native.build_error}")
    rec, prof = [], {}
    inner = train.make_train_step

    def recording(*a, **k):
        step = inner(*a, **k)

        def run(state, batch):
            out = {}
            t1 = time.perf_counter()
            if profile_last and len(rec) == iters - 1:
                wall = statistics.median(r["ms"] for r in rec[1:])
                prof.update(profiling.busy_profile(lambda: out.update(r=step(state, batch)), 1,
                                                   wall_ms=wall, shares=("flash_",)))
            else:
                out["r"] = step(state, batch)
            state, m = out["r"]
            c = float(m["c_loss"])
            rec.append({"ms": (time.perf_counter() - t1) * 1e3, "c_loss": c,
                        "grad_norm": float(m["grad_norm"])})
            return state, m

        return run

    rng = np.random.RandomState(seed)
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/packed")
        for name, rows in (("train", PRETRAIN_BATCH * (iters + 2)), ("val", 4)):
            pack_tokens(rng.randint(3, TINYLLAMA["vocab_size"], rows * PRETRAIN_WORDS),
                        f"{tmp}/packed/{'a' if name == 'train' else 'b'}_{name}.pkl",
                        PRETRAIN_WORDS)
        for n_layers in (TINYLLAMA["n_layers"], 2):
            with open(f"{tmp}/cfg{n_layers}.json", "w") as f:
                json.dump(dict(TINYLLAMA, n_layers=n_layers), f)
        train.make_train_step = recording
        profile_last = True
        try:
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            full_cfg = f"{tmp}/cfg{TINYLLAMA['n_layers']}.json"
            state = main_pretrain.main(_pretrain_args(tmp, full_cfg, f"{tmp}/full", iters, 1000),
                                       tokenizer=ByteTokenizer())
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            full = list(rec)
            del state
            gc.collect()
            torch.cuda.empty_cache()
            rec.clear()
            profile_last = False
            leg = []
            for it in (2, 4):
                st = main_pretrain.main(_pretrain_args(tmp, f"{tmp}/cfg2.json", f"{tmp}/leg", it,
                                                       2), tokenizer=ByteTokenizer())
                leg.append(int(st.step))
            ds = [json.loads(open(f"{tmp}/leg/epoch0-iter{i}/dataset-shard-0.json").read())
                  for i in (2, 4)]
            logs = [json.loads(x) for x in open(f"{tmp}/leg/log.txt").read().splitlines()]
        finally:
            train.make_train_step = inner
    layers = TINYLLAMA["n_layers"]
    want = _zero_counts(flash_attention=layers * iters, flash_attention_bwd_dq=layers * iters,
                        flash_attention_bwd_dkdv=layers * iters)
    tok = PRETRAIN_BATCH * PRETRAIN_WORDS
    timed = [r["ms"] for r in full[1:-1]]
    row = {"phase": "pretrain", "model": "TinyLlama-1.1B shape, bf16, every leaf trained",
           "batch": [PRETRAIN_BATCH, PRETRAIN_WORDS], "iterations": iters,
           "remat": "True (--checkpointing: selective)", "native_c_library": True,
           "seconds": secs, "per_iteration": full,
           "ms_per_iteration": statistics.median(timed),
           "tok_s": tok / statistics.median(timed) * 1e3, "peak_bytes": peak, "profile": prof,
           "launches": counts, "launches_expected": want,
           "leg_2_layers": {"steps_after_each_call": leg, "dataset_state": ds, "log": logs,
                            "c_loss": [r["c_loss"] for r in rec]}}
    emit(row)
    if counts != want or len(full) != iters or not all(math.isfinite(r["c_loss"]) for r in full):
        raise AssertionError(f"pretrain: {row}")
    if (leg != [2, 4] or len(rec) != 4 or ds[0] == ds[1]
            or ds[1] != {"_file_idx": 0, "_curr_idx": 4 * PRETRAIN_BATCH}
            or [x["iter"] for x in logs] != [2, 4]
            or not all(math.isfinite(x["val_loss"]) for x in logs)):
        raise AssertionError(f"pretrain: the save / resume leg went wrong: {row['leg_2_layers']}")
    return counts


def _remat_compare(args, params, trainable, data, lr: float, qpeft: bool, bigm: bool):
    """Steps under remat "full" and under True (the selective policy) in turns
    (full, True, True, full), each turn from the same trainable leaves and a
    fresh optimizer state: its first step's loss and grad_norm (held to 1e-3
    relative: the two recompute the same products on the same inputs) and
    launch counts (exact: True keeps the flash forward's output, one flash
    forward a layer and not two, and recomputes the W4 products), then two
    timed steps; ms a step (the median over a setting's turns) and the peak
    memory of each."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from accessory_tpu_torch.train.tree import named_leaves

    leaves = {k: v for k, v in named_leaves(params) if trainable(k)}
    snapshot = {k: v.detach().clone() for k, v in leaves.items()}

    def restore():
        with torch.no_grad():
            for k, v in leaves.items():
                v.copy_(snapshot[k])

    out = {"full": {"ms_all": [], "peak_bytes": 0}, "True": {"ms_all": [], "peak_bytes": 0}}
    for remat in ("full", True, True, "full"):
        res = out[str(remat)]
        restore()
        tx = make_optimizer(params, lr, weight_decay=0.02, clip_norm=2.0, trainable=trainable)
        step = make_train_step(llama, args, tx, remat=remat)
        state = TrainState.create(params, tx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        state, m = step(state, data)
        if "loss" not in res:
            res.update({k: float(m[k]) for k in ("loss", "grad_norm")},
                       counts=kernels.launch_counts())
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step(state, data)
            float(m["c_loss"])
            res["ms_all"].append((time.perf_counter() - t1) * 1e3)
        res["peak_bytes"] = max(res["peak_bytes"], torch.cuda.max_memory_allocated())
        del state, tx
    restore()
    for res in out.values():
        res["ms"] = statistics.median(res["ms_all"])
    _, want = _train_counts(args.n_layers, qpeft, bigm)
    _, want_sel = _train_counts(args.n_layers, qpeft, bigm, remat=True)
    full, sel = out["full"], out["True"]
    ok = (full["counts"] == want and sel["counts"] == want_sel
          and all(abs(sel[k] - full[k]) <= 1e-3 * abs(full[k]) for k in ("loss", "grad_norm")))
    return {"remat_full": full, "remat_true": sel, "launches_expected_true": want_sel,
            "tolerance_rel": 1e-3, "agree": ok}


ALL_PHASES = ("device,build,kernels,parity,serve,decode,checkpoint,parity8,paged_parity,serve8,"
              "stream,stacked,batcher,batcher8,preempt,server,decode8,decode_unfused,parity7b,"
              "serve7b,decode7b,parity_w8,parity_gptq,serve7b_w8,decode7b_w8,serve_gptq,"
              "decode_gptq,serve_magic,decode_magic,serve_w3,train_parity,train_qpeft7b,"
              "train_full,finetune,pretrain,parity_ffn,serve_ffn,graphs,decode_ffn,decode7b_ffn,"
              "paged_ro,cp_shards,train_cp,parity_moe,serve_moe,decode_moe,batcher_moe,train_moe,"
              "parity_zoo,"
              "serve_falcon40b,decode_falcon40b,serve_internlm7b,decode_internlm7b,"
              "serve_falcon7b,decode_falcon7b,torch_import,"
              "parity_sphinx,serve_sphinx,score,parity_adapter,serve_adapter,parity_sphinx_moe,"
              "serve_sphinx_moe,train_sphinx_moe,train_mm")
TINY_MODEL_PHASES = ("serve", "decode", "checkpoint", "serve8", "stream", "stacked", "batcher",
                     "batcher8", "preempt", "server", "decode8", "decode_unfused", "serve_ffn",
                     "graphs", "decode_ffn")


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
            from accessory_tpu_torch.util import profiling

            emit({"phase": "timing", "empty_traces_retried": profiling.retakes["empty"],
                  "short_traces": profiling.retakes["short"],
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
            if "graphs" in phases:
                # the compiled decode loops against the eager route: both cache types,
                # the fused FFN, the stacked route and the batcher
                phase_graphs_sync_check()
                for kv_dtype in (None, "int8"):
                    counts_by_path[f"graphs tiny {kv_dtype or 'bf16'}"] = phase_graphs(
                        "serve", _generator_of(model, kv_dtype=kv_dtype), PROMPTS[:4], 32,
                        kv_dtype=kv_dtype or "bf16")
                phase_graphs("serve_ffn", _generator_of(model, ffn_fuse=True), PROMPTS[:4], 32)
                phase_graphs("stacked", _generator_of(model, unroll_decode=False), PROMPTS[:4],
                             32)
                counts_by_path["graphs batcher"] = phase_graphs_batcher(model, llama)
            if "decode_ffn" in phases:
                # in turns with the unfused route (fused, unfused, unfused, fused)
                bench = {}
                model.kv_dtype = None
                model._reset_generator()
                for fuse in (True, False, False, True):
                    counts = phase_decode("decode_ffn", model, None, steps=50, ffn_fuse=fuse)
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
            if "graphs" in phases:
                phase_graphs("serve7b", _generator_of(model), PROMPTS, 16)
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
                    counts = phase_decode("decode7b_ffn", model, None, steps=30, ffn_fuse=fuse)
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
                lr=1e-3, compare_remat=True)
        if "train_full" in phases:
            counts_by_path["train full"] = phase_train("train_full", LLAMA_700M, opts.seed, 2,
                                                       2048, qpeft=False, lr=1e-4,
                                                       compare_remat=True)
        if "finetune" in phases:
            counts_by_path["finetune"] = phase_finetune(opts.seed)
        if "pretrain" in phases:
            counts_by_path["pretrain"] = phase_pretrain(opts.seed)
            gc.collect()
            torch.cuda.empty_cache()
        if "compare" in phases:
            phase_compare(opts.seed, opts.kernel_names and opts.kernel_names.split(","))
        if "cp_shards" in phases:
            counts_by_path["cp shards"] = phase_cp_shards(opts.seed)
        if "train_cp" in phases:
            counts_by_path["train cp"] = phase_train_cp(opts.seed)
        if "parity_moe" in phases:
            phase_parity_moe(opts.seed)
        if any(ph in phases for ph in ("serve_moe", "decode_moe", "batcher_moe", "train_moe")):
            # Mixtral-8x7B W4 (~27 GB) on the card: every earlier model is freed
            gc.collect()
            torch.cuda.empty_cache()
            model, counts_by_path["mixtral"] = phase_serve_moe(opts.seed)
            if "graphs" in phases:
                phase_graphs("decode_moe", _generator_of(model), PROMPTS, 8)
            if "decode_moe" in phases:
                bench = {}
                for kv_dtype in (None, "int8"):
                    model.kv_dtype = kv_dtype
                    model._reset_generator()
                    _add_counts(bench, phase_decode_moe(model, kv_dtype))
                counts_by_path["mixtral bench"] = bench
            if "batcher_moe" in phases:
                counts_by_path["mixtral batcher"] = phase_batcher_moe(model)
            if "train_moe" in phases:
                # last on this model: the step trains its router in place
                counts_by_path["train moe"] = phase_train_moe(model, opts.seed)
            del model
            torch.cuda.empty_cache()
        if "parity_zoo" in phases:
            phase_parity_zoo(opts.seed)
        for name in ZOO_MODELS:
            tag = name.lower().replace("-", "")
            if f"serve_{tag}" not in phases and f"decode_{tag}" not in phases:
                continue
            # the full-width W4 model on the card: every earlier model is freed
            gc.collect()
            torch.cuda.empty_cache()
            # Falcon-7B's one W4 product (N 4544) also on row 1's many-row tile
            model, counts_by_path[tag] = phase_serve_zoo(
                name, opts.seed, tile_rows=512 if name == "Falcon-7B" else 0)
            if name == "Falcon-7B" and "graphs" in phases:
                phase_graphs("falcon7b", _generator_of(model), PROMPTS, 16)
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
        if "parity_sphinx" in phases:
            phase_parity_sphinx(opts.seed)
            gc.collect()
            torch.cuda.empty_cache()
        if "serve_sphinx" in phases or "score" in phases:
            # SPHINX-7B on the card: every earlier model is freed
            gc.collect()
            torch.cuda.empty_cache()
            if "serve_sphinx" in phases:
                model, runs = phase_serve_sphinx(opts.seed)
                counts_by_path["sphinx caption"] = runs["batch_caption"]
                counts_by_path["sphinx response"] = runs["generate_response"]
            else:
                model = _sphinx_model(opts.seed)[0]
            if "score" in phases:
                counts_by_path["sphinx score"] = phase_score(model, opts.seed)
            del model
            torch.cuda.empty_cache()
        if "parity_adapter" in phases:
            phase_parity_adapter(opts.seed)
        if "serve_adapter" in phases:
            gc.collect()
            torch.cuda.empty_cache()
            counts_by_path["adapter"], counts_by_path["adapter bench"] = \
                phase_serve_adapter(opts.seed)
        if "parity_sphinx_moe" in phases:
            phase_parity_sphinx_moe(opts.seed)
            gc.collect()
            torch.cuda.empty_cache()
        if "serve_sphinx_moe" in phases or "train_sphinx_moe" in phases:
            # SPHINX-MoE on the card (~36 GB): every earlier model is freed
            gc.collect()
            torch.cuda.empty_cache()
            counts_by_path["sphinx-moe caption"], model = phase_serve_sphinx_moe(opts.seed)
            if "train_sphinx_moe" in phases:
                counts_by_path["train sphinx-moe"] = phase_train_sphinx_moe(model, opts.seed)
            del model
            gc.collect()
            torch.cuda.empty_cache()
        if "train_sphinx_moe" in phases:
            counts_by_path["train sphinx-moe parity"] = phase_train_sphinx_moe_parity(opts.seed)
        if "train_mm" in phases:
            counts_by_path["train mm parity"] = phase_train_mm_parity(opts.seed)
            gc.collect()
            torch.cuda.empty_cache()
            counts_by_path["train mm"] = phase_train_mm(opts.seed)
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
