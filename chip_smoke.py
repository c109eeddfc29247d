#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (accessory_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--phases device,build,kernels,parity,serve,decode]
                          [--out FILE]

Phases, each printing one JSON line (any failure raises and exits non-zero):
  device   the card (nvidia-smi name and power limit), torch and CUDA versions;
  build    compiles every kernel in accessory_tpu_torch/csrc with nvcc;
  kernels  each kernel against its plain PyTorch version on CUDA tensors at
           the main path's shapes: max error, kernel / plain / library-call
           device time (profiler CUDA trace, median of 3; inputs rotated
           through enough copies to spill the 50 MB L2 where the model reads
           them cold), the kernel's wall time between CUDA events, and the
           bound from bytes and operations at the H100's 3.35 TB/s and
           989 TFLOP/s;
  parity   TinyLlama width, 2 layers: CPU through the plain versions against
           the card through the kernels, prefill logits and 16 greedy decode
           steps (teacher-forced on the CPU tokens);
  serve    TinyLlama-1.1B shape, 22 layers, W4, random weights from --seed:
           4 prompts through MetaModel.generate, with each kernel's launch
           count checked;
  decode   the bench shape (batch 8, 1024-token cache, 100 forward steps from
           position 512): ms per step against the bytes bound, with each
           kernel's launch count checked over the timed steps.
The line before the last holds the kernel table ({"kernels": [...]}); the last
line is {"ok": true, "device": {...}}. Without a CUDA device it exits 1.
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


def n_copies(bytes_per_call: float) -> int:
    return max(1, min(32, math.ceil(2 * L2_BYTES / max(bytes_per_call, 1))))


def max_err(got, want):
    import torch

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
                       if "registers" in ln or "spill" in ln][:8]
    emit({"phase": "build", "seconds": round(secs, 3),
          "libraries": {n: str(p) for n, p in paths.items()}, "ptxas": ptxas})


def phase_kernels(seed: int):
    """Every kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from accessory_tpu_torch.ops.attention import grouped_attention
    from accessory_tpu_torch.ops.decode_attention import (decode_attention_update,
                                                          decode_attention_update_plain,
                                                          write_kv_layer,
                                                          write_kv_layer_plain)
    from accessory_tpu_torch.ops.flash_attention import flash_attention
    from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm, planes_qmm_plain
    from accessory_tpu_torch.ops.rope import precompute_rope, rope_rows
    from accessory_tpu_torch.quant.qtensor import (dequantize_weight, quantize_weight,
                                                   to_folded_layout)
    from accessory_tpu_torch.quant.quantize import pad_to

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = {"w4_matmul": [], "decode_attention": [], "flash_attention": [], "kv_write": []}

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def record(kernel, shape, err, k_ms, k_wall, p_ms, lib_ms, nbytes, flops):
        b_ms, b_by = bound_ms(nbytes, flops)
        row = {"kernel": kernel, "shape": shape, "max_abs_err": err[0], "max_rel_err": err[1],
               "ms": k_ms, "wall_ms": k_wall, "plain_ms": p_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops}
        rows[kernel].append(row)
        emit({"phase": "kernels", **row})

    # -- W4 matmul (planes_qmm): the four decode-layer projections at M 4 (the
    #    serve phase's decode batch), 8 (the decode phase's) and 512 (its prefill)
    cos, sin = precompute_rope(64, 1024, device=dev)
    cos_rows, sin_rows = rope_rows(cos, sin, 36, 4, 64, "interleaved")
    specs = [("wqkv", 2048, 2560, "norm+rope"), ("wo", 2048, 2048, "res"),
             ("w13", 2048, 11264, "norm"), ("w2", 5632, 2048, "res")]
    for m in (4, 8, 512):
        for name, k, n, fusion in specs:
            kx = k
            qw_bytes = kx * n // 2 + 2 * (kx // 128) * n * 4
            io_bytes = m * kx * 2 + m * n * 2 + (m * n * 2 if fusion == "res" else 0) \
                + (kx * 4 if "norm" in fusion else 0) + (2 * n * 4 if "rope" in fusion else 0)
            sets = []
            for _ in range(n_copies(qw_bytes + io_bytes)):
                w = randn(k, n, dtype=torch.float32, scale=k ** -0.5)
                qw = to_folded_layout(quantize_weight(w, 4, 128, pad_in_to=pad_to(k, 128)))
                args = dict(x2d=randn(m, kx), packed=qw.packed, scales=qw.scales, zs=qw.zeros,
                            norm_weight=(1 + 0.1 * randn(kx, dtype=torch.float32))
                            if "norm" in fusion else None,
                            residual=randn(m, n) if fusion == "res" else None,
                            rope_cos=cos_rows[511] if "rope" in fusion else None,
                            rope_sin=sin_rows[511] if "rope" in fusion else None,
                            in_dim=qw.in_dim, group_size=128,
                            rope_style="interleaved" if "rope" in fusion else "",
                            rope_hd=64 if "rope" in fusion else 0)
                dense = dequantize_weight(qw, torch.bfloat16)[:kx]
                sets.append((args, dense))
            a0 = sets[0][0]
            got = planes_qmm(**a0)
            want = planes_qmm_plain(**a0)
            torch.cuda.synchronize()
            check_close(f"w4_matmul {name} M={m}", got, want, rtol=2e-2, atol=2e-2)
            k_ms = time_ms(lambda a: planes_qmm(**a), [(s[0],) for s in sets])
            k_wall = wall_ms(lambda a: planes_qmm(**a), [(s[0],) for s in sets])
            p_ms = time_ms(lambda a: planes_qmm_plain(**a), [(s[0],) for s in sets[:1]],
                           min_iters=3)
            lib_ms = time_ms(lambda x, d: torch.matmul(x, d),
                             [(s[0]["x2d"], s[1]) for s in sets])
            record("w4_matmul", f"{name} M={m} K={kx} N={n} {fusion}", max_err(got, want),
                   k_ms, k_wall, p_ms, lib_ms, qw_bytes + io_bytes, 2.0 * m * kx * n)

    # -- fused decode attention + KV write (_kernel_bloop_w): the decode
    #    phase's batch 8 and 1024-token cache, a cache length not a multiple
    #    of 128, and the serve phase's batch 4 over its 192-token cache
    nq, nkv, hd = 32, 4, 64
    ncols = (nq + 2 * nkv) * hd
    for b, s_len, pos in ((8, 1024, 0), (8, 1024, 1), (8, 1024, 511), (8, 1024, 1023),
                          (8, 1000, 999), (4, 192, 150)):
        kv_read = 2 * b * nkv * pos * hd * 2
        nbytes = kv_read + b * ncols * 2 + b * nq * hd * 2 + 2 * b * nkv * hd * 2
        flops = 4.0 * b * nq * (pos + 1) * hd
        sets = []
        for _ in range(n_copies(nbytes)):
            qkv = randn(b, 1, ncols)
            q = qkv[..., :nq * hd].view(b, 1, nq, hd)
            kn = qkv[..., nq * hd:(nq + nkv) * hd].view(b, 1, nkv, hd)
            vn = qkv[..., (nq + nkv) * hd:].view(b, 1, nkv, hd)
            sets.append((q, kn, vn, randn(b, nkv, s_len, hd), randn(b, nkv, s_len, hd)))
        q, kn, vn, ck, cv = sets[0]
        ck2, cv2 = ck.clone(), cv.clone()
        got, gk, gv = decode_attention_update(q, kn, vn, ck, cv, pos)
        want, wk, wv = decode_attention_update_plain(q, kn, vn, ck2, cv2, pos)
        torch.cuda.synchronize()
        # softmax averages of pos + 1 values: held to 4 bf16 ulps of the
        # largest output and 1% (plus the relative L2 check)
        check_close(f"decode_attention B={b} S={s_len} pos={pos}", got, want, rtol=1e-2,
                    atol=4 * bf16_ulp(float(want.float().abs().max())))
        if not (torch.equal(gk, wk) and torch.equal(gv, wv)):
            raise AssertionError(f"decode_attention S={s_len} pos={pos}: cache write differs")
        k_ms = time_ms(lambda *a: decode_attention_update(*a, pos), sets)
        k_wall = wall_ms(lambda *a: decode_attention_update(*a, pos), sets)
        p_ms = time_ms(lambda *a: decode_attention_update_plain(*a, pos), sets[:1], min_iters=5)
        mask = (torch.arange(s_len, device=dev) <= pos)[None]  # cache now holds the new token
        lib_sets = [(s[0].transpose(1, 2), s[3], s[4]) for s in sets]
        lib_ms = time_ms(lambda qq, kk, vv: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask, enable_gqa=True), lib_sets)
        record("decode_attention", f"B={b} NKV={nkv} R={nq // nkv} HD={hd} S={s_len} pos={pos}",
               max_err(got, want), k_ms, k_wall, p_ms, lib_ms, nbytes, flops)

    # -- causal prefill flash attention (splash)
    for b, s, nq, nkv, hd in ((4, 128, 32, 4, 64), (4, 200, 32, 4, 64), (4, 128, 16, 4, 128)):
        nbytes = b * s * (2 * nq + 2 * nkv) * hd * 2
        flops = 4.0 * b * nq * hd * s * (s + 1) / 2
        sets = []
        for _ in range(n_copies(nbytes)):
            vbuf = randn(b, s, (nkv + 1) * hd)   # v as a strided view, as in the model
            sets.append((randn(b, s, nq, hd), randn(b, s, nkv, hd),
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
        record("flash_attention", f"B={b} S={s} NQ={nq} NKV={nkv} HD={hd}",
               max_err(got, want), k_ms, k_wall, p_ms, lib_ms, nbytes, flops)

    # -- prefill KV slab write (_write_slab_layer)
    b, nkv, hd, s_len, sq = 4, 4, 64, 192, 128
    for pos in (0, 37):
        nbytes = 2 * 2 * b * sq * nkv * hd * 2
        sets = []
        for _ in range(n_copies(nbytes)):
            kbuf = randn(b, sq, 3 * nkv * hd)  # k and v as strided views of a qkv-like buffer
            sets.append((randn(b, nkv, s_len, hd), randn(b, nkv, s_len, hd),
                         kbuf[..., :nkv * hd].view(b, sq, nkv, hd),
                         kbuf[..., 2 * nkv * hd:].view(b, sq, nkv, hd)))
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
        record("kv_write", f"B={b} sq={sq} NKV={nkv} HD={hd} S={s_len} pos={pos}",
               (0.0, 0.0), k_ms, k_wall, p_ms, lib_ms, nbytes, 0.0)
    return rows


def _tinyllama(n_layers: int, max_seq_len: int):
    from accessory_tpu_torch.config import LLaMAArgs

    return LLaMAArgs(**dict(TINYLLAMA, n_layers=n_layers), max_seq_len=max_seq_len)


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


def phase_parity(seed: int):
    """Same weights, CPU through the plain versions vs the card through the
    kernels: prefill logits, then 16 decode steps fed the CPU's greedy tokens."""
    import torch

    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.quant.fuse import fuse_for_decode
    from accessory_tpu_torch.quant.quantize import quantize_params

    args = _tinyllama(2, 256)
    params_gpu = fuse_for_decode(quantize_params(llama.init_params(args, seed=seed)))
    params_cpu = _tree_to(params_gpu, "cpu")
    b, plen, steps, s_len = 2, 64, 16, 128
    g = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, args.vocab_size, (b, plen), generator=g)
    cache_g = llama.init_kv_cache(args, b, s_len)
    cache_c = llama.init_kv_cache(args, b, s_len, device="cpu")
    lg, _ = llama.forward(params_gpu, args, prompt.cuda(), cache=cache_g, cur_pos=0)
    lc, _ = llama.forward(params_cpu, args, prompt, cache=cache_c, cur_pos=0)
    worst_abs, worst_rel, checked, agreed = 0.0, 0.0, 0, 0
    tol_abs = LOGIT_TOL_FRAC * float(lc.abs().max())

    def compare(gpu, cpu):
        nonlocal worst_abs, worst_rel, checked, agreed
        gpu = gpu.float().cpu()
        if not torch.isfinite(gpu).all():
            raise AssertionError("parity: non-finite GPU logits")
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
        lc, _ = llama.forward(params_cpu, args, tok[:, None], cache=cache_c, cur_pos=plen + i)
        compare(lg, lc)
        tok = lc[:, -1].argmax(-1)
    row = {"phase": "parity", "layers": args.n_layers, "batch": b, "prompt": plen, "decode_steps": steps,
           "max_abs_logit_err": worst_abs, "max_rel_l2_err": worst_rel,
           "logit_absmax": tol_abs / LOGIT_TOL_FRAC, "tol_abs": tol_abs,
           "tol_rel_l2": LOGIT_REL_L2,
           "tokens_checked": checked, "tokens_agreed": agreed}
    emit(row)
    if worst_abs > tol_abs or worst_rel > LOGIT_REL_L2 or agreed != checked:
        raise AssertionError(f"parity failed: {row}")


PROMPTS = [
    "The quick brown fox jumps over the lazy dog while the farmer counts his sheep "
    "twice before the sun sets.",
    "In the beginning the universe was created. This has made a lot of people very "
    "angry and been widely regarded as a bad move.",
    "Four score and seven years ago our fathers brought forth on this continent a new "
    "nation, conceived in liberty.",
    "It was the best of times, it was the worst of times, it was the age of wisdom, it "
    "was the age of foolishness.",
]


def phase_serve(seed: int):
    """The 22-layer TinyLlama shape through MetaModel.generate, launch-counted."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.meta import MetaModel
    from accessory_tpu_torch.models import llama

    assert all(100 <= len(p) <= 126 for p in PROMPTS), [len(p) for p in PROMPTS]
    t0 = time.perf_counter()
    model = MetaModel("llama", dict(TINYLLAMA), max_seq_len=512, seed=seed)
    model.tokenizer = ByteTokenizer()
    model.quantize()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gen = model.generator
    n_layers = model.args.n_layers

    # prefill alone at the serve shape (4 x 128 rows), timed before the counted run
    toks = torch.randint(0, 256, (4, 128), device="cuda")
    for _ in range(2):
        cache = llama.init_kv_cache(model.args, 4, 192)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, _ = llama.forward(gen.params, model.args, toks, cache=cache, cur_pos=0)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
    if not (logits.shape == (4, 128, model.args.vocab_size) and torch.isfinite(logits).all()):
        raise AssertionError("serve: prefill logits not finite / wrong shape")

    kernels.reset_launch_counts()
    t2 = time.perf_counter()
    outs = model.generate(PROMPTS, max_gen_len=64)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t2
    counts = kernels.launch_counts()
    steps = gen.last_decode_steps
    want = {"w4_matmul": 4 * n_layers * (1 + steps), "decode_attention": n_layers * steps,
            "flash_attention": n_layers, "kv_write": n_layers}
    plens = [len(p) + 1 for p in PROMPTS]
    row = {"phase": "serve", "layers": n_layers, "batch": len(PROMPTS),
           "prompt_tokens": plens, "prefill_rows": 4 * 128, "decode_steps": steps,
           "launches": counts, "launches_expected": want, "setup_s": setup_s,
           "prefill_ms": prefill_ms, "generate_s": total_s,
           "decode_tok_s": len(PROMPTS) * steps / max(total_s - prefill_ms / 1e3, 1e-9),
           "outputs_chars": [len(o) for o in outs]}
    emit(row)
    if counts != want or steps < 1 or len(outs) != len(PROMPTS):
        raise AssertionError(f"serve: launch counts {counts} != expected {want}")
    return model, counts


def phase_decode(model):
    """bench.py's shape: batch 8, cache 1024, 100 forward steps from pos 512."""
    import torch

    from accessory_tpu_torch import kernels
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.quant.qtensor import QuantizedWeight

    args, params = model.args, model.generator.params
    batch, cache_len, steps, pos0 = 8, 1024, 100, 512
    cache = llama.init_kv_cache(args, batch, cache_len)
    tok = torch.ones((batch, 1), dtype=torch.int64, device="cuda")

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
    kv_bytes = args.n_layers * 2 * batch * args.kv_heads * mid * args.head_dim * 2
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
        raise AssertionError("decode: non-finite logits")
    want = {"w4_matmul": 4 * args.n_layers * steps, "decode_attention": args.n_layers * steps,
            "flash_attention": 0, "kv_write": 0}
    row = {"phase": "decode", "batch": batch, "cache_len": cache_len, "steps": steps,
           "ms_per_step": ms, "tok_s": batch / ms * 1e3, "bound_ms_per_step": b_ms,
           "bound_tok_s": batch / b_ms * 1e3, "weight_bytes": w_bytes,
           "kv_bytes_mid": kv_bytes, "launches": counts, "launches_expected": want}
    if counts != want:
        emit(row)
        raise AssertionError(f"decode: launch counts {counts} != expected {want}")
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


SOURCES = {
    "w4_matmul": ("accessory_tpu_torch/csrc/w4_matmul.cu",
                  "accessory_tpu/ops/quant_matmul_planes.py:313"),
    "decode_attention": ("accessory_tpu_torch/csrc/decode_attention.cu",
                         "accessory_tpu/ops/decode_attention.py:123"),
    "flash_attention": ("accessory_tpu_torch/csrc/flash_attention.cu",
                        "accessory_tpu/ops/flash_attention.py:86"),
    "kv_write": ("accessory_tpu_torch/csrc/kv_write.cu",
                 "accessory_tpu/ops/decode_attention.py:581"),
}
# the serve phase's shape (the main path, whose launches the summary line
# counts) reported in the summary line for each kernel
SUMMARY_SHAPE = {"w4_matmul": "w13 M=4", "decode_attention": "B=4 S=192",
                 "flash_attention": "S=128 NQ=32", "kv_write": "pos=0"}


def summary(rows, counts):
    out = []
    for name, (src, replaces) in SOURCES.items():
        rs = rows.get(name, [])
        pick = next((r for r in rs if all(t in r["shape"] for t in SUMMARY_SHAPE[name].split())),
                    rs[0] if rs else None)
        out.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": counts.get(name, 0) if counts else 0,
                    "max_abs_err": max((r["max_abs_err"] for r in rs), default=None),
                    "ms": pick and pick["ms"], "plain_ms": pick and pick["plain_ms"],
                    "bound_ms": pick and pick["bound_ms"], "bound_by": pick and pick["bound_by"],
                    "library_ms": pick and pick["library_ms"],
                    "shape": pick and pick["shape"]})
    return {"kernels": out}


def main() -> int:
    global _out_file
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="device,build,kernels,parity,serve,decode")
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
    try:
        smi = phase_device()
        if "build" in phases:
            phase_build()
        rows, counts = {}, None
        if "kernels" in phases:
            rows = phase_kernels(opts.seed)
            emit({"phase": "timing", "empty_traces_retried": _empty_traces})
        if "parity" in phases:
            phase_parity(opts.seed)
        if "serve" in phases:
            model, counts = phase_serve(opts.seed)
            if "decode" in phases:
                phase_decode(model)
        print(smi, flush=True)
        emit(summary(rows, counts))
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
