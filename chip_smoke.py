#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (accessory_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--phases device,build,kernels,parity,serve,decode,
                                               checkpoint,parity8,paged_parity,serve8,stream,
                                               stacked,batcher,batcher8,preempt,server,
                                               decode8,decode_unfused,
                                               parity7b,serve7b,decode7b] [--out FILE]

Phases, each printing JSON lines (any failure raises and exits non-zero):
  device    the card (nvidia-smi name and power limit), torch and CUDA versions;
  build     compiles every kernel in accessory_tpu_torch/csrc with nvcc;
  kernels   each kernel against its plain PyTorch version on CUDA tensors at
            the main paths' shapes (TinyLlama-1.1B and LLaMA2-7B): max error,
            kernel / plain / library-call device time (profiler CUDA trace,
            median of 3; inputs rotated through enough copies to spill the
            50 MB L2 where the model reads them cold), the kernel's wall time
            between CUDA events, and the bound from bytes and operations at the
            H100's 3.35 TB/s and 989 TFLOP/s;
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
            for each cache type (the read-only one-query-head kernels).
The line before the last holds the kernel table ({"kernels": [...]}, launches
summed over the counted main-path runs); the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
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
L2_BYTES = 50 * 2 ** 20

TINYLLAMA = dict(dim=2048, n_layers=22, n_heads=32, n_kv_heads=4, vocab_size=32000,
                 multiple_of=256, dtype="bfloat16")
LLAMA2_7B = dict(dim=4096, n_layers=32, n_heads=32, vocab_size=32000, multiple_of=256,
                 dtype="bfloat16")
KERNEL_NAMES = ("w4_matmul", "w4_matmul_bigm", "decode_attention", "decode_attention8",
                "decode_attention_ro", "decode_attention8_ro", "decode_attention_mha",
                "decode_attention_mha8", "decode_attention_mha_ro", "decode_attention_mha8_ro",
                "flash_attention", "kv_write", "kv_write_q8", "kv_write_col", "kv_write_col_q8",
                "kv_write_stacked", "kv_write_stacked_col", "kv_write_stacked_q8",
                "paged_decode", "paged_decode8", "paged_write", "paged_write_q8")

_out_file = None
_empty_traces = 0   # profiler traces that came back without device events


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


def bound_ms(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def time_ms(fn, arg_sets, min_iters: int = 30, repeats: int = 3) -> float:
    """Device ms per call over round-robin argument sets: the summed duration
    of every kernel the calls launched, from the profiler's CUDA trace, so
    host overhead between launches is not counted; the median of ``repeats``
    traces, so one stray in a trace does not make the reading. A trace
    that comes back without device events (the CUDA trace is sometimes
    empty) is taken again, up to 5 times, and counted in ``_empty_traces``;
    then it raises: no other clock stands in for it."""
    global _empty_traces
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    n = len(arg_sets) * max(1, math.ceil(min_iters / len(arg_sets)))
    per_call = []
    for _ in range(repeats):
        for _attempt in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(n):
                    fn(*arg_sets[i % len(arg_sets)])
                torch.cuda.synchronize()
            dev_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA)
            if dev_us > 0:
                break
            _empty_traces += 1
        else:
            raise RuntimeError("time_ms: 5 profiler traces in a row held no device time")
        per_call.append(dev_us / 1e3 / n)
    return statistics.median(per_call)


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

    def record(self, kernel, shape, err, k_ms, k_wall, p_ms, lib_ms, nbytes, flops, **extra):
        b_ms, b_by = bound_ms(nbytes, flops)
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


def _kernels_w4(kr, tag, specs, ms, rope):
    """planes_qmm (GEMV for M <= 16, the 64-row tile kernel above) with its fusions."""
    import torch

    from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm, planes_qmm_plain

    for m in ms:
        for name, k, n, fusion in specs:
            sets, nbytes = _w4_weight_sets(kr, m, k, n, fusion, rope)
            a0 = sets[0][0]
            got = planes_qmm(**a0)
            want = planes_qmm_plain(**a0)
            torch.cuda.synchronize()
            check_close(f"w4_matmul {tag} {name} M={m}", got, want, rtol=2e-2, atol=2e-2)
            k_ms = time_ms(lambda a: planes_qmm(**a), [(s[0],) for s in sets])
            k_wall = wall_ms(lambda a: planes_qmm(**a), [(s[0],) for s in sets])
            p_ms = time_ms(lambda a: planes_qmm_plain(**a), [(s[0],) for s in sets[:1]],
                           min_iters=3)
            lib_ms = time_ms(lambda x, d: torch.matmul(x, d),
                             [(s[0]["x2d"], s[1]) for s in sets])
            kr.record("w4_matmul", f"{tag} {name} M={m} K={k} N={n} {fusion}",
                      max_err(got, want), k_ms, k_wall, p_ms, lib_ms, nbytes, 2.0 * m * k * n)
            del sets


def _kernels_bigm(kr, specs):
    """planes_qmm_bigm at the 7B prefill's 1024 rows (and one ragged row
    count), beside the 64-row tile kernel of w4_matmul.cu on the same inputs:
    its C entry is called directly, since planes_qmm refuses M >= 1024."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.ops.quant_matmul_bigm import (planes_qmm_bigm,
                                                           planes_qmm_bigm_plain)
    from accessory_tpu_torch.ops.quant_matmul_planes import _ARGS as TILE_ARGS

    tile_fn = kernels.function("w4_matmul", "w4_matmul", TILE_ARGS)

    def tile_kernel(x2d, packed, scales, zs, in_dim, group_size):
        m, kx = x2d.shape
        out = torch.empty((m, packed.shape[1]), dtype=torch.bfloat16, device=x2d.device)
        rc = tile_fn(x2d.data_ptr(), m, kx, x2d.stride(0), packed.data_ptr(), scales.data_ptr(),
                     zs.data_ptr(), packed.shape[1], group_size, None, 1e-5, None, None, None, 0,
                     0, out.data_ptr(), kernels.stream_ptr(x2d))
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
        torch.cuda.synchronize()
        # same bf16 weights and f32 sums in another order: one bf16 rounding step
        check_close(f"w4_matmul_bigm {name} M={m}", got, want, rtol=1e-2, atol=1e-2, rel_l2=5e-3)
        # the tile kernel keeps q exact (another dequant form): held as in the w4_matmul rows
        check_close(f"w4_matmul tile {name} M={m}", tile, want, rtol=2e-2, atol=2e-2)
        k_ms = time_ms(lambda a: planes_qmm_bigm(**a), calls)
        k_wall = wall_ms(lambda a: planes_qmm_bigm(**a), calls)
        t_ms = time_ms(lambda a: tile_kernel(**a), calls)
        p_ms = time_ms(lambda a: planes_qmm_bigm_plain(**a), calls[:1], min_iters=3)
        lib_ms = time_ms(lambda x, d: torch.matmul(x, d), [(s[0]["x2d"], s[1]) for s in sets])
        kr.record("w4_matmul_bigm", f"7b {name} M={m} K={k} N={n}", max_err(got, want), k_ms,
                  k_wall, p_ms, lib_ms, nbytes, 2.0 * m * k * n, tile_kernel_ms=t_ms,
                  dequants_per_weight=math.ceil(m / 128),
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
                  max_err(out_g, out_w), k_ms, k_wall, p_ms, lib_ms, nbytes, flops)
        del sets, lib_sets


def _kernels_flash(kr, cases):
    import torch
    import torch.nn.functional as F

    from accessory_tpu_torch.ops.attention import grouped_attention
    from accessory_tpu_torch.ops.flash_attention import flash_attention

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
                  max_err(got, want), k_ms, k_wall, p_ms, lib_ms, nbytes, flops)


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
        k_ms = time_ms(lambda *a: write_kv_layer(*a, pos), sets)
        k_wall = wall_ms(lambda *a: write_kv_layer(*a, pos), sets)
        p_ms = time_ms(lambda *a: write_kv_layer_plain(*a, pos), sets)
        lib_ms = time_ms(lambda ck, cv, nk, nv: (ck[:, :, pos:pos + sq].copy_(nk.transpose(1, 2)),
                                                 cv[:, :, pos:pos + sq].copy_(nv.transpose(1, 2))),
                         sets)
        kr.record(kernel, f"{tag} B={b} sq={sq} NKV={nkv} HD={hd} S={s_len} pos={pos}",
                  (0.0, 0.0), k_ms, k_wall, p_ms, lib_ms, nbytes, 0.0)


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
        k_ms = time_ms(lambda *a: write_kv_layer8(*a, pos), sets)
        k_wall = wall_ms(lambda *a: write_kv_layer8(*a, pos), sets)
        p_ms = time_ms(lambda *a: write_kv_layer8_plain(*a, pos), sets)
        kr.record(kernel, f"{tag} B={b} sq={sq} NKV={nkv} HD={hd} S={s_len} pos={pos}",
                  (0.0, 0.0), k_ms, k_wall, p_ms, None, nbytes, 0.0)


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
    del pools2
    k_ms = time_ms(lambda *a: fn(*a, pos), sets)
    k_wall = wall_ms(lambda *a: fn(*a, pos), sets)
    p_ms = time_ms(lambda *a: plain(*a, pos), sets)
    lib_ms = None if int8 else time_ms(
        lambda ck, cv, k, v: (ck[:, :, :, pos:pos + sq].copy_(k.transpose(2, 3)),
                              cv[:, :, :, pos:pos + sq].copy_(v.transpose(2, 3))), sets)
    kr.record(kernel, f"{tag} L={n_layers} B={b} sq={sq} NKV={nkv} HD={hd} S={s_len} pos={pos}",
              (0.0, 0.0), k_ms, k_wall, p_ms, lib_ms, nbytes, 0.0, stack_ms=stack_ms)


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
              nbytes, 0.0)
    del sets


def phase_kernels(seed: int):
    """Every kernel against its plain version at the main paths' shapes."""
    from accessory_tpu_torch.ops.rope import precompute_rope, rope_rows

    kr = KernelRows(seed)

    # -- TinyLlama-1.1B (GQA) path: the four decode-layer projections at M 1 (the
    #    stream phase's decode: the one-row GEMV), 4 (the serve phases' decode
    #    batch), 8 (the decode phases'), 128 (the stream phase's prefill) and 512
    #    (the serve phases' prefill)
    cos, sin = precompute_rope(64, 1024, device="cuda")
    rope = rope_rows(cos, sin, 36, 4, 64, "interleaved") + ("interleaved", 64)
    _kernels_w4(kr, "tiny", [("wqkv", 2048, 2560, "norm+rope"), ("wo", 2048, 2048, "res"),
                             ("w13", 2048, 11264, "norm"), ("w2", 5632, 2048, "res")],
                (1, 4, 8, 128, 512), rope)
    # -- the stacked path's separate projections, with no prologue or epilogue
    #    (wk and wv, w1 and w3 share a shape; its wo and w2 are the rows above)
    _kernels_w4(kr, "tiny", [("wq", 2048, 2048, ""), ("wk/wv", 2048, 256, ""),
                             ("w1/w3", 2048, 5632, "")], (4, 8, 512), rope)
    # -- LLaMA2-7B (MHA) path: the same four at the decode batch 8 (K 11008 is
    #    padded to 11264 in the weight; RoPE at head_dim 128)
    cos, sin = precompute_rope(128, 1024, device="cuda")
    rope = rope_rows(cos, sin, 64, 32, 128, "interleaved") + ("interleaved", 128)
    _kernels_w4(kr, "7b", [("wqkv", 4096, 12288, "norm+rope"), ("wo", 4096, 4096, "res"),
                           ("w13", 4096, 22016, "norm"), ("w2", 11008, 4096, "res")], (8,), rope)
    # -- its prefill: the many-row kernel at 8 x 128 = 1024 rows, and one row
    #    count that is not a multiple of the 128-row tile
    _kernels_bigm(kr, [("wqkv", 4096, 12288, 1024), ("wo", 4096, 4096, 1024),
                       ("w13", 4096, 22016, 1024), ("w2", 11008, 4096, 1024),
                       ("wo", 4096, 4096, 1000)])

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
    # -- the read-only forms as the stacked path calls them: q, k, v each a
    #    tensor of its own (separate projections), not views of one wqkv output
    for int8 in (False, True):
        _kernels_decode(kr, "tiny", 32, 4, 64, ((4, 192, 150), (8, 1024, 511)), int8=int8,
                        write=False, separate=True)
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

    # -- causal prefill flash attention (splash)
    _kernels_flash(kr, (("tiny", 4, 128, 32, 4, 64), ("tiny", 1, 128, 32, 4, 64),
                        ("tiny", 4, 200, 32, 4, 64),
                        ("hd128", 4, 128, 16, 4, 128), ("7b", 8, 128, 32, 32, 128)))

    # -- prefill KV slab writes (_write_slab_layer, _write_slab_layer_q8)
    #    at the serve phases' batch 4 / 8 and the stream phase's batch 1
    _kernels_slab(kr, "tiny", 4, 4, 64, 192, 128, (0, 37))
    _kernels_slab(kr, "tiny", 1, 4, 64, 192, 128, (0,))
    _kernels_slab(kr, "7b", 8, 32, 128, 192, 128, (0,))
    _kernels_slab8(kr, "tiny", 4, 4, 64, 192, 128, (0,))
    _kernels_slab8(kr, "tiny", 1, 4, 64, 192, 128, (0,))
    _kernels_slab8(kr, "7b", 8, 32, 128, 192, 128, (0, 37))
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

    # -- the paged KV cache (continuous batching): paged decode attention over
    #    8 slots of ragged lengths (0, 1, page edges, 511) at the decode step
    #    and the speculative verify width 5, TinyLlama (GQA) and the 7B shape
    #    (one query head per KV head); the paged writes of all 22 layers at the
    #    decode step, the verify width and the 128-token prefill bucket
    ragged = [0, 1, 63, 64, 65, 130, 300, 511]
    for int8 in (False, True):
        for sq in (1, 5):
            _kernels_paged_decode(kr, "tiny", 4, 8, 64, sq, ragged, int8)
        _kernels_paged_decode(kr, "7b", 32, 1, 128, 1, ragged, int8, most_copies=4)
        _kernels_paged_identity(kr, int8)
        for s in (1, 5, 128):
            _kernels_paged_write(kr, "tiny", 22, 8, s, 4, 64, int8)
    return kr.rows


def _tree_to(node, device):
    """A params tree (dicts, lists, tensors, QuantizedWeights) on ``device``."""
    if isinstance(node, dict):
        return {k: _tree_to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_to(v, device) for v in node]
    return node.to(device)


# bf16 activations round (2^-8 relative) at different points on the two
# sides (kernel sums in another order, so a rounding may flip by one ulp and
# carry through the layers): logits are held to 2% of the largest |logit| and
# 2% in relative L2, and greedy tokens must agree wherever the CPU's top-2
# margin exceeds the absolute tolerance.
LOGIT_TOL_FRAC = 2e-2
LOGIT_REL_L2 = 2e-2   # ||gpu - cpu|| / ||cpu||


def phase_parity(seed: int, phase: str, cfg: dict, n_layers: int, b: int, plen: int, steps: int,
                 s_len: int, kv_dtypes=(None,), stacked: bool = False):
    """Same weights, CPU through the plain versions vs the card through the
    kernels: prefill logits, then ``steps`` decode steps fed the CPU's greedy
    tokens, once per KV-cache dtype. ``stacked``: the stacked-cache path
    (separate projections, read-only attention, one bulk write per forward)."""
    import torch

    from accessory_tpu_torch.config import LLaMAArgs
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.quant.fuse import fuse_for_decode
    from accessory_tpu_torch.quant.quantize import quantize_params

    args = LLaMAArgs(**dict(cfg, n_layers=n_layers), max_seq_len=s_len)
    params_gpu = quantize_params(llama.init_params(args, seed=seed))
    if not stacked:
        params_gpu = fuse_for_decode(params_gpu)
    params_cpu = _tree_to(params_gpu, "cpu")
    g = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, args.vocab_size, (b, plen), generator=g)
    for kv_dtype in kv_dtypes:
        cache_g = llama.init_kv_cache(args, b, s_len, kv_dtype=kv_dtype, stacked=stacked)
        cache_c = llama.init_kv_cache(args, b, s_len, kv_dtype=kv_dtype, device="cpu",
                                      stacked=stacked)
        cpu_s = 0.0

        def cpu_forward(tokens, pos):
            nonlocal cpu_s
            t0 = time.perf_counter()
            out, _ = llama.forward(params_cpu, args, tokens, cache=cache_c, cur_pos=pos)
            cpu_s += time.perf_counter() - t0
            return out

        lg, _ = llama.forward(params_gpu, args, prompt.cuda(), cache=cache_g, cur_pos=0)
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
            lg, _ = llama.forward(params_gpu, args, tok[:, None].cuda(), cache=cache_g,
                                  cur_pos=plen + i)
            lc = cpu_forward(tok[:, None], plen + i)
            compare(lg, lc)
            tok = lc[:, -1].argmax(-1)
        row = {"phase": phase, "path": "stacked" if stacked else "unrolled",
               "layers": args.n_layers, "dim": args.dim, "batch": b, "prompt": plen,
               "prefill_rows": b * plen, "decode_steps": steps,
               "kv_dtype": kv_dtype or "bf16", "cpu_seconds": round(cpu_s, 2),
               "max_abs_logit_err": worst_abs, "max_rel_l2_err": worst_rel,
               "logit_absmax": tol_abs / LOGIT_TOL_FRAC, "tol_abs": tol_abs,
               "tol_rel_l2": LOGIT_REL_L2,
               "tokens_checked": checked, "tokens_agreed": agreed}
        emit(row)
        if worst_abs > tol_abs or worst_rel > LOGIT_REL_L2 or agreed != checked:
            raise AssertionError(f"{phase} failed: {row}")


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


def _quantized_model(cfg: dict, max_seq_len: int, seed: int):
    import torch

    from accessory_tpu_torch.meta import MetaModel

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = MetaModel("llama", dict(cfg), max_seq_len=max_seq_len, seed=seed)
    model.tokenizer = ByteTokenizer()
    model.quantize()
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _timed_prefill(model, batch: int, plen: int, buf_len: int, kv_dtype):
    """One prefill forward alone at the serve shape, the second of two runs."""
    import torch

    from accessory_tpu_torch.models import llama

    toks = torch.randint(0, 256, (batch, plen), device="cuda")
    for _ in range(2):
        cache = llama.init_kv_cache(model.args, batch, buf_len, kv_dtype=kv_dtype)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, _ = llama.forward(model.generator.params, model.args, toks, cache=cache, cur_pos=0)
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


def phase_serve(phase: str, model, setup_s: float, kv_dtype=None):
    """The 22-layer TinyLlama shape (GQA) through MetaModel.generate with the
    bf16 (serve) or the int8 (serve8) KV cache, launch-counted."""
    prompts = PROMPTS[:4]
    assert all(100 <= len(p) <= 126 for p in prompts), [len(p) for p in prompts]
    int8 = kv_dtype == "int8"
    model.kv_dtype = kv_dtype
    model._reset_generator()
    n_layers = model.args.n_layers
    prefill_ms = _timed_prefill(model, 4, 128, 192, kv_dtype)
    outs, counts, steps, total_s = _counted_generate(model, prompts, 64)
    want = _zero_counts(
        w4_matmul=4 * n_layers * (1 + steps), flash_attention=n_layers,
        **{"decode_attention8" if int8 else "decode_attention": n_layers * steps,
           "kv_write_q8" if int8 else "kv_write": n_layers})
    row = {"phase": phase, "model": "TinyLlama-1.1B shape", "kv_dtype": kv_dtype or "bf16",
           "layers": n_layers,
           "batch": len(prompts), "prompt_tokens": [len(p) + 1 for p in prompts],
           "prefill_rows": 4 * 128, "decode_steps": steps,
           "launches": counts, "launches_expected": want, "setup_s": setup_s,
           "prefill_ms": prefill_ms, "generate_s": total_s,
           "decode_tok_s": len(prompts) * steps / max(total_s - prefill_ms / 1e3, 1e-9),
           "outputs_chars": [len(o) for o in outs]}
    emit(row)
    if counts != want or steps < 1 or len(outs) != len(prompts):
        raise AssertionError(f"{phase}: launch counts {counts} != expected {want}")
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


def _p5_prompts(n: int):
    """n prompts of 127 bytes: 128 tokens with BOS, the serving bench's length."""
    text = " ".join(PROMPTS)
    return [(text[i * 41:] + " " + text)[:127] for i in range(n)]


def _batcher(model, module, kv_dtype, **kw):
    from accessory_tpu_torch.engine.scheduler import ContinuousBatcher

    return ContinuousBatcher(module, model.args, model.params, model.tokenizer, slots=8,
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
    return {**out, "device_busy_ms_per_step": busy / n,
            "device_idle_share": max(0.0, 1 - busy / wall)}


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


def phase_serve7b(seed: int):
    """The 32-layer LLaMA2-7B shape (MHA) through MetaModel.generate: 8 prompts
    in the 128-token bucket (1024 prefill rows), 32 new tokens, with the bf16
    and then the int8 KV cache on the same weights, launch-counted."""
    import numpy as np

    prompts = PROMPTS
    assert len(prompts) == 8 and all(100 <= len(p) <= 126 for p in prompts), \
        [len(p) for p in prompts]
    model, setup_s, setup_peak = _quantized_model(LLAMA2_7B, 512, seed)
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
        want = _zero_counts(
            w4_matmul=4 * n_layers * steps, w4_matmul_bigm=4 * n_layers,
            flash_attention=n_layers,
            **{"decode_attention_mha8" if int8 else "decode_attention_mha": n_layers * steps,
               "kv_write_q8" if int8 else "kv_write": n_layers})
        tokens[kv_dtype] = model.generator.last_tokens
        row = {"phase": "serve7b", "model": "LLaMA2-7B shape", "kv_dtype": kv_dtype or "bf16",
               "layers": n_layers, "batch": len(prompts), "prompt_tokens": plens,
               "prefill_rows": 8 * 128, "decode_steps": steps, "launches": counts,
               "launches_expected": want, "setup_s": setup_s,
               "setup_peak_bytes": setup_peak, "prefill_ms": prefill_ms, "generate_s": total_s,
               "decode_tok_s": len(prompts) * steps / max(total_s - prefill_ms / 1e3, 1e-9),
               "outputs_chars": [len(o) for o in outs]}
        emit(row)
        if counts != want or steps < 32 or len(outs) != len(prompts):
            raise AssertionError(f"serve7b {kv_dtype}: launch counts {counts} != expected {want}")
        for name in total:
            total[name] += counts[name]
    # greedy tokens of the two runs over the generated positions (printed, not
    # asserted: random weights give flat logits)
    a, b = tokens[None], tokens["int8"]
    same = [a[i, n:n + 32] == b[i, n:n + 32] for i, n in enumerate(plens)]
    emit({"phase": "serve7b", "compare": "greedy tokens, bf16 KV vs int8 KV",
          "generated_tokens": int(sum(s.size for s in same)),
          "share_equal": float(np.mean(np.concatenate(same)))})
    return model, total


def phase_decode(phase: str, model, kv_dtype, steps: int, fused_attn_write: bool = True,
                 stacked: bool = False):
    """The bench shape: batch 8, cache 1024, ``steps`` forward steps from pos
    512; with ``fused_attn_write=False`` through read-only attention and the
    one-token write; with ``stacked`` over the unfused params and a stacked
    cache. Returns the launch counts of the timed steps."""
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
    kw = dict(fused_attn_write=fused_attn_write)
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
    want = _zero_counts(w4_matmul=(7 if stacked else 4) * args.n_layers * steps,
                        **{attn: args.n_layers * steps})
    if stacked:
        want["kv_write_stacked_q8" if int8 else "kv_write_stacked_col"] = steps
    elif not fused_attn_write:
        want["kv_write_col_q8" if int8 else "kv_write_col"] = args.n_layers * steps
    row = {"phase": phase, "kv_dtype": kv_dtype or "bf16", "layers": args.n_layers,
           "path": "stacked" if stacked else "unrolled", "fused_attn_write": fused_attn_write,
           "batch": batch, "cache_len": cache_len, "steps": steps,
           "ms_per_step": ms, "tok_s": batch / ms * 1e3, "bound_ms_per_step": b_ms,
           "bound_tok_s": batch / b_ms * 1e3, "weight_bytes": w_bytes,
           "kv_bytes_mid": kv_bytes, "launches": counts, "launches_expected": want}
    if counts != want:
        emit(row)
        raise AssertionError(f"{phase}: launch counts {counts} != expected {want}")
    row["profile"] = _profile_steps(params, args, tok, cache, pos0, ms, **kw)
    emit(row)
    return counts


def _profile_steps(params, args, tok, cache, pos0, ms_per_step: float, steps: int = 10, **kw):
    """Device time by kernel over a few decode steps (torch.profiler). Only
    the trace's device events are summed: an aten op's row repeats the time
    of the kernels it launched. The idle share is taken against the
    unprofiled ``ms_per_step``, since tracing slows the host loop."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from accessory_tpu_torch.models import llama

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for i in range(steps):
            llama.forward(params, args, tok, cache=cache, cur_pos=pos0 + i, **kw)
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
    return {"wall_ms_per_step_profiled": wall / steps, "device_busy_ms_per_step": busy,
            "device_idle_share": max(0.0, 1 - busy / ms_per_step),
            "top_kernels_ms_per_step": {k[:80]: v for k, v in top}}


# kernel -> (source, the TPU kernel it replaces, the main-path shape whose row
# the summary line reports: the 7B serve phase's where the kernel runs there)
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
              "serve7b,decode7b")
TINY_MODEL_PHASES = ("serve", "decode", "checkpoint", "serve8", "stream", "stacked", "batcher",
                     "batcher8", "preempt", "server", "decode8", "decode_unfused")


def _add_counts(total, counts):
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n



def main() -> int:
    global _out_file
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=ALL_PHASES)
    ap.add_argument("--out", default=None, help="also append every JSON line to this file")
    opts = ap.parse_args()
    phases = opts.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from accessory_tpu_torch import kernels  # noqa: F401  (fails outside the repo)

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
            rows = phase_kernels(opts.seed)
            emit({"phase": "timing", "empty_traces_retried": _empty_traces,
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
        if any(ph in phases for ph in TINY_MODEL_PHASES):
            model, setup_s, _ = _quantized_model(TINYLLAMA, 512, opts.seed)
            if "serve" in phases:
                counts_by_path["tiny"] = phase_serve("serve", model, setup_s)
            if "decode" in phases:
                phase_decode("decode", model, None, steps=100)
            if "checkpoint" in phases:
                # from here on the paths run the weights that came back from the file
                loaded = phase_checkpoint(model)
                del model
                model = loaded
                torch.cuda.empty_cache()
            if "serve8" in phases:
                counts_by_path["tiny int8"] = phase_serve("serve8", model, setup_s, "int8")
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
            del model
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
