#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (accessory_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--phases device,build,kernels,parity,serve,decode,
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
            against the bytes bound.
The line before the last holds the kernel table ({"kernels": [...]}, launches
summed over the serve phases' counted runs); the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
L2_BYTES = 50 * 2 ** 20

TINYLLAMA = dict(dim=2048, n_layers=22, n_heads=32, n_kv_heads=4, vocab_size=32000,
                 multiple_of=256, dtype="bfloat16")
LLAMA2_7B = dict(dim=4096, n_layers=32, n_heads=32, vocab_size=32000, multiple_of=256,
                 dtype="bfloat16")
KERNEL_NAMES = ("w4_matmul", "w4_matmul_bigm", "decode_attention", "decode_attention_mha",
                "decode_attention_mha8", "flash_attention", "kv_write", "kv_write_q8")

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


def _kernels_decode_attention(kr, tag, nq, nkv, hd, cases, most_copies=32):
    """Fused decode attention + KV write over the bf16 cache: the GQA kernel
    (nq > nkv) or the MHA kernel (nq == nkv), by decode_attention_update's
    own dispatch."""
    import torch
    import torch.nn.functional as F

    from accessory_tpu_torch.ops.decode_attention import (decode_attention_update,
                                                          decode_attention_update_plain)

    kernel = "decode_attention_mha" if nq == nkv else "decode_attention"
    ncols = (nq + 2 * nkv) * hd
    for b, s_len, pos in cases:
        kv_read = 2 * b * nkv * pos * hd * 2
        nbytes = kv_read + b * ncols * 2 + b * nq * hd * 2 + 2 * b * nkv * hd * 2
        flops = 4.0 * b * nq * (pos + 1) * hd
        sets = [_qkv_views(kr, b, nq, nkv, hd) + (kr.randn(b, nkv, s_len, hd),
                                                  kr.randn(b, nkv, s_len, hd))
                for _ in range(n_copies(nbytes, most_copies))]
        q, kn, vn, ck, cv = sets[0]
        ck2, cv2 = ck.clone(), cv.clone()
        got, gk, gv = decode_attention_update(q, kn, vn, ck, cv, pos)
        want, wk, wv = decode_attention_update_plain(q, kn, vn, ck2, cv2, pos)
        torch.cuda.synchronize()
        # softmax averages of pos + 1 values: held to 4 bf16 ulps of the
        # largest output and 1% (plus the relative L2 check)
        check_close(f"{kernel} {tag} B={b} S={s_len} pos={pos}", got, want, rtol=1e-2,
                    atol=4 * bf16_ulp(float(want.float().abs().max())))
        if not (torch.equal(gk, wk) and torch.equal(gv, wv)):
            raise AssertionError(f"{kernel} S={s_len} pos={pos}: cache write differs")
        del ck2, cv2
        k_ms = time_ms(lambda *a: decode_attention_update(*a, pos), sets)
        k_wall = wall_ms(lambda *a: decode_attention_update(*a, pos), sets)
        p_ms = time_ms(lambda *a: decode_attention_update_plain(*a, pos), sets[:1], min_iters=5)
        mask = (torch.arange(s_len, device="cuda") <= pos)[None]  # cache now holds the new token
        lib_sets = [(s[0].transpose(1, 2), s[3], s[4]) for s in sets]
        lib_ms = time_ms(lambda qq, kk, vv: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask, enable_gqa=True), lib_sets)
        kr.record(kernel, f"{tag} B={b} NKV={nkv} R={nq // nkv} HD={hd} S={s_len} pos={pos}",
                  max_err(got, want), k_ms, k_wall, p_ms, lib_ms, nbytes, flops)
        del sets, lib_sets


def _int8_pools(kr, b, nkv, s_len, hd):
    import torch

    def q8():
        return torch.randint(-127, 128, (b, nkv, s_len, hd), generator=kr.gen, device="cuda",
                             dtype=torch.int8)

    def sc():
        return 0.005 + 0.015 * torch.rand((b, nkv, s_len), generator=kr.gen, device="cuda")

    return q8(), q8(), sc(), sc()


def _kernels_decode_attention8(kr, tag, nkv, hd, cases, most_copies=32):
    """The MHA kernel's int8 form. The yardstick is SDPA over a cache that was
    dequantized to bf16 beforehand (its dequantization is not timed)."""
    import torch
    import torch.nn.functional as F

    from accessory_tpu_torch.ops.decode_attention import (decode_attention_update8,
                                                          decode_attention_update8_plain)

    ncols = 3 * nkv * hd
    for b, s_len, pos in cases:
        kv_read = 2 * b * nkv * pos * (hd + 4)
        nbytes = kv_read + b * ncols * 2 + b * nkv * hd * 2 + 2 * b * nkv * (hd + 4)
        flops = 4.0 * b * nkv * (pos + 1) * hd
        sets = [_qkv_views(kr, b, nkv, nkv, hd) + _int8_pools(kr, b, nkv, s_len, hd)
                for _ in range(n_copies(nbytes, most_copies))]
        first = sets[0]
        pools2 = tuple(p.clone() for p in first[3:])
        got = decode_attention_update8(*first, pos)
        want = decode_attention_update8_plain(*first[:3], *pools2, pos)
        torch.cuda.synchronize()
        check_close(f"decode_attention_mha8 {tag} B={b} S={s_len} pos={pos}", got[0], want[0],
                    rtol=1e-2, atol=4 * bf16_ulp(float(want[0].float().abs().max())))
        check_pools8(f"decode_attention_mha8 {tag} S={s_len} pos={pos}", got[1:], want[1:])
        del pools2
        k_ms = time_ms(lambda *a: decode_attention_update8(*a, pos), sets)
        k_wall = wall_ms(lambda *a: decode_attention_update8(*a, pos), sets)
        p_ms = time_ms(lambda *a: decode_attention_update8_plain(*a, pos), sets[:1], min_iters=5)
        mask = (torch.arange(s_len, device="cuda") <= pos)[None]
        lib_sets = [(s[0].transpose(1, 2),
                     (s[3].float() * s[5][..., None]).to(torch.bfloat16),
                     (s[4].float() * s[6][..., None]).to(torch.bfloat16)) for s in sets[:2]]
        lib_ms = time_ms(lambda qq, kk, vv: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask), lib_sets)
        kr.record("decode_attention_mha8", f"{tag} B={b} NKV={nkv} R=1 HD={hd} S={s_len} pos={pos}",
                  max_err(got[0], want[0]), k_ms, k_wall, p_ms, lib_ms, nbytes, flops)
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
    import torch

    from accessory_tpu_torch.ops.decode_attention import write_kv_layer, write_kv_layer_plain

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
            raise AssertionError(f"kv_write pos={pos}: cache differs from the plain copy_")
        k_ms = time_ms(lambda *a: write_kv_layer(*a, pos), sets)
        k_wall = wall_ms(lambda *a: write_kv_layer(*a, pos), sets)
        p_ms = time_ms(lambda *a: write_kv_layer_plain(*a, pos), sets)
        lib_ms = time_ms(lambda ck, cv, nk, nv: (ck[:, :, pos:pos + sq].copy_(nk.transpose(1, 2)),
                                                 cv[:, :, pos:pos + sq].copy_(nv.transpose(1, 2))),
                         sets)
        kr.record("kv_write", f"{tag} B={b} sq={sq} NKV={nkv} HD={hd} S={s_len} pos={pos}",
                  (0.0, 0.0), k_ms, k_wall, p_ms, lib_ms, nbytes, 0.0)


def _kernels_slab8(kr, tag, b, nkv, hd, s_len, sq, positions):
    """The quantizing slab write; no single PyTorch call computes it, so it
    has no library yardstick."""
    import torch

    from accessory_tpu_torch.ops.decode_attention import write_kv_layer8, write_kv_layer8_plain

    for pos in positions:
        nbytes = 2 * b * sq * nkv * (hd * 2 + hd + 4)
        sets = [_int8_pools(kr, b, nkv, s_len, hd) + _kv_chunk_views(kr, b, sq, nkv, hd)
                for _ in range(n_copies(nbytes))]
        pools2 = tuple(p.clone() for p in sets[0][:4])
        got = write_kv_layer8(*sets[0], pos)
        want = write_kv_layer8_plain(*pools2, *sets[0][4:], pos)
        torch.cuda.synchronize()
        check_pools8(f"kv_write_q8 pos={pos}", got, want)
        k_ms = time_ms(lambda *a: write_kv_layer8(*a, pos), sets)
        k_wall = wall_ms(lambda *a: write_kv_layer8(*a, pos), sets)
        p_ms = time_ms(lambda *a: write_kv_layer8_plain(*a, pos), sets)
        kr.record("kv_write_q8", f"{tag} B={b} sq={sq} NKV={nkv} HD={hd} S={s_len} pos={pos}",
                  (0.0, 0.0), k_ms, k_wall, p_ms, None, nbytes, 0.0)


def phase_kernels(seed: int):
    """Every kernel against its plain version at the main paths' shapes."""
    from accessory_tpu_torch.ops.rope import precompute_rope, rope_rows

    kr = KernelRows(seed)

    # -- TinyLlama-1.1B (GQA) path: the four decode-layer projections at M 4 (the
    #    serve phase's decode batch), 8 (the decode phase's) and 512 (its prefill)
    cos, sin = precompute_rope(64, 1024, device="cuda")
    rope = rope_rows(cos, sin, 36, 4, 64, "interleaved") + ("interleaved", 64)
    _kernels_w4(kr, "tiny", [("wqkv", 2048, 2560, "norm+rope"), ("wo", 2048, 2048, "res"),
                             ("w13", 2048, 11264, "norm"), ("w2", 5632, 2048, "res")],
                (4, 8, 512), rope)
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
    #    phase's batch 8 and 1024-token cache, a cache length not a multiple
    #    of 128, and the serve phase's batch 4 over its 192-token cache
    _kernels_decode_attention(kr, "tiny", 32, 4, 64,
                              ((8, 1024, 0), (8, 1024, 1), (8, 1024, 511), (8, 1024, 1023),
                               (8, 1000, 999), (4, 192, 150)))
    # -- the same for MHA (_kernel_hgrp_w) and its int8 form (_kernel_hgrp_w8)
    #    at the 7B shape, the 7B serve phase's 192-token cache, and one
    #    head_dim-64 shape. The caches are 134 MB a copy, so at most 4 copies
    #    rotate (a short read then stays in L2, as it would in the model).
    mha_cases = ((8, 1024, 0), (8, 1024, 1), (8, 1024, 511), (8, 1024, 1023), (8, 192, 150))
    _kernels_decode_attention(kr, "7b", 32, 32, 128, mha_cases, most_copies=4)
    _kernels_decode_attention(kr, "hd64", 16, 16, 64, ((8, 1000, 999),), most_copies=4)
    _kernels_decode_attention8(kr, "7b", 32, 128, mha_cases, most_copies=4)
    _kernels_decode_attention8(kr, "hd64", 16, 64, ((8, 1000, 999),), most_copies=4)

    # -- causal prefill flash attention (splash)
    _kernels_flash(kr, (("tiny", 4, 128, 32, 4, 64), ("tiny", 4, 200, 32, 4, 64),
                        ("hd128", 4, 128, 16, 4, 128), ("7b", 8, 128, 32, 32, 128)))

    # -- prefill KV slab writes (_write_slab_layer, _write_slab_layer_q8)
    _kernels_slab(kr, "tiny", 4, 4, 64, 192, 128, (0, 37))
    _kernels_slab(kr, "7b", 8, 32, 128, 192, 128, (0,))
    _kernels_slab8(kr, "7b", 8, 32, 128, 192, 128, (0, 37))
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
                 s_len: int, kv_dtypes=(None,)):
    """Same weights, CPU through the plain versions vs the card through the
    kernels: prefill logits, then ``steps`` decode steps fed the CPU's greedy
    tokens, once per KV-cache dtype."""
    import torch

    from accessory_tpu_torch.config import LLaMAArgs
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.quant.fuse import fuse_for_decode
    from accessory_tpu_torch.quant.quantize import quantize_params

    args = LLaMAArgs(**dict(cfg, n_layers=n_layers), max_seq_len=s_len)
    params_gpu = fuse_for_decode(quantize_params(llama.init_params(args, seed=seed)))
    params_cpu = _tree_to(params_gpu, "cpu")
    g = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, args.vocab_size, (b, plen), generator=g)
    for kv_dtype in kv_dtypes:
        cache_g = llama.init_kv_cache(args, b, s_len, kv_dtype=kv_dtype)
        cache_c = llama.init_kv_cache(args, b, s_len, kv_dtype=kv_dtype, device="cpu")
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
        row = {"phase": phase, "layers": args.n_layers, "dim": args.dim, "batch": b,
               "prompt": plen, "prefill_rows": b * plen, "decode_steps": steps,
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


def phase_serve(seed: int):
    """The 22-layer TinyLlama shape (GQA) through MetaModel.generate, launch-counted."""
    prompts = PROMPTS[:4]
    assert all(100 <= len(p) <= 126 for p in prompts), [len(p) for p in prompts]
    model, setup_s, _ = _quantized_model(TINYLLAMA, 512, seed)
    n_layers = model.args.n_layers
    prefill_ms = _timed_prefill(model, 4, 128, 192, None)
    outs, counts, steps, total_s = _counted_generate(model, prompts, 64)
    want = _zero_counts(w4_matmul=4 * n_layers * (1 + steps), decode_attention=n_layers * steps,
                        flash_attention=n_layers, kv_write=n_layers)
    row = {"phase": "serve", "model": "TinyLlama-1.1B shape", "layers": n_layers,
           "batch": len(prompts), "prompt_tokens": [len(p) + 1 for p in prompts],
           "prefill_rows": 4 * 128, "decode_steps": steps,
           "launches": counts, "launches_expected": want, "setup_s": setup_s,
           "prefill_ms": prefill_ms, "generate_s": total_s,
           "decode_tok_s": len(prompts) * steps / max(total_s - prefill_ms / 1e3, 1e-9),
           "outputs_chars": [len(o) for o in outs]}
    emit(row)
    if counts != want or steps < 1 or len(outs) != len(prompts):
        raise AssertionError(f"serve: launch counts {counts} != expected {want}")
    return model, counts


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


def phase_decode(phase: str, model, kv_dtype, steps: int):
    """bench.py's shape: batch 8, cache 1024, ``steps`` forward steps from pos 512."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.quant.qtensor import QuantizedWeight

    args, params = model.args, model.generator.params
    batch, cache_len, pos0 = 8, 1024, 512
    cache = llama.init_kv_cache(args, batch, cache_len, kv_dtype=kv_dtype)
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
    kv_bytes = args.n_layers * batch * args.kv_heads * mid * token_bytes
    b_ms, _ = bound_ms(w_bytes + kv_bytes, 0.0)
    for i in range(5):
        llama.forward(params, args, tok, cache=cache, cur_pos=pos0 + i)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, _ = llama.forward(params, args, tok, cache=cache, cur_pos=pos0 + i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = kernels.launch_counts()
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{phase}: non-finite logits")
    attn = ("decode_attention_mha8" if int8 else "decode_attention_mha") if mha \
        else "decode_attention"
    want = _zero_counts(w4_matmul=4 * args.n_layers * steps, **{attn: args.n_layers * steps})
    row = {"phase": phase, "kv_dtype": kv_dtype or "bf16", "layers": args.n_layers,
           "batch": batch, "cache_len": cache_len, "steps": steps,
           "ms_per_step": ms, "tok_s": batch / ms * 1e3, "bound_ms_per_step": b_ms,
           "bound_tok_s": batch / b_ms * 1e3, "weight_bytes": w_bytes,
           "kv_bytes_mid": kv_bytes, "launches": counts, "launches_expected": want}
    if counts != want:
        emit(row)
        raise AssertionError(f"{phase}: launch counts {counts} != expected {want}")
    row["profile"] = _profile_steps(params, args, tok, cache, pos0, ms)
    emit(row)


def _profile_steps(params, args, tok, cache, pos0, ms_per_step: float, steps: int = 10):
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
            llama.forward(params, args, tok, cache=cache, cur_pos=pos0 + i)
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
    "decode_attention_mha": ("accessory_tpu_torch/csrc/decode_attention_mha.cu",
                             "accessory_tpu/ops/decode_attention.py:884", "7b B=8 S=192"),
    "decode_attention_mha8": ("accessory_tpu_torch/csrc/decode_attention_mha.cu",
                              "accessory_tpu/ops/decode_attention.py:988", "7b B=8 S=192"),
    "flash_attention": ("accessory_tpu_torch/csrc/flash_attention.cu",
                        "accessory_tpu/ops/flash_attention.py:86", "7b B=8 S=128"),
    "kv_write": ("accessory_tpu_torch/csrc/kv_write.cu",
                 "accessory_tpu/ops/decode_attention.py:581", "7b B=8 pos=0"),
    "kv_write_q8": ("accessory_tpu_torch/csrc/kv_write.cu",
                    "accessory_tpu/ops/decode_attention.py:1291", "7b B=8 pos=0"),
}


def summary(rows, counts_by_path):
    """The kernel table. ``launches`` sums the serve phases' counted runs (each
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


ALL_PHASES = "device,build,kernels,parity,serve,decode,parity7b,serve7b,decode7b"


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
        if "serve" in phases:
            model, counts_by_path["tiny"] = phase_serve(opts.seed)
            if "decode" in phases:
                phase_decode("decode", model, None, steps=100)
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
