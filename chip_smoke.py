#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ops/csrc (one nvcc per source, all
   started together) and print the build seconds and ptxas report;
3. hold each kernel against its plain PyTorch version at the main paths'
   shapes, in f32 and bf16 (the flash kernels also at head_dim 32 and at
   tile-edge lengths, the recurrent kernels also with ragged and
   time-reversed masks and at an odd shape), and time kernel, plain
   version and a PyTorch library yardstick with CUDA events; the flash
   kernels and their SDPA yardsticks also by device time per call
   (torch.profiler), the flash backward must repeat bit for bit, and both
   flash libraries must hold tensor-core instructions (HMMA in
   cuobjdump -sass);
4. serve the full-width transformer LM (vocab 32000, 12 layers, d_model
   768, 12 heads, d_ff 3072; seeded random weights saved as a model
   directory and loaded through DecodeEngine.from_model_dir) in bf16
   with 16 slots: 32 concurrent requests with prompts of 8..1024 tokens
   and 64 new tokens each.  Kernel launch counts are zeroed just before
   and read just after; every serving kernel must have launched.  Two
   streams are recomputed through greedy_decode_full and their logits
   compared;
5. train the repo's at-scale config (vocab 8192, T 512, 12 layers,
   d_model 768, 12 heads, d_ff 3072; 90.6 M parameters) in f32 with TF32
   off, through transformer_lm_train_program + Executor.run: startup from
   a fixed seed, then 20 Adam steps at batch 16 on a seeded copy task,
   launch counts zeroed just before and read just after (12 flash
   forward and backward, 24 LayerNorm forward and backward, 1 softmax-
   xent forward and backward per step), every loss finite and the last
   below the first; one more step under torch.profiler;
6. one full-width step at batch 1 from the same carried-in state and
   feed on the card and on the CPU (Executor(CPUPlace()), the plain
   versions): the loss and every parameter's @GRAD must agree;
7. train ResNet-50 (bench.py bench_resnet: 224x224, 1000 classes, NHWC,
   program.amp) through resnet_train_program + Executor.run: startup from
   a fixed seed, then 20 Momentum steps at batch 128 on one fixed seeded
   batch, launch counts zeroed just before and read just after (53
   BatchNorm backward launches per step), every loss finite and the last
   below the first; one more step under torch.profiler;
8. the same ResNet-50 program in f32 (amp off, TF32 off) at batch 2: one
   step from phase 7's state and one feed on the card and on the CPU; the
   loss and every @GRAD must agree;
9. train the stacked dynamic LSTM (bench.py bench_lstm: lstm_net with
   dict 30000, emb 512, hid 512, 3 recurrences; batch 32, T 80, Adam,
   program.amp) through Executor.run on one seeded batch: launch counts
   zeroed just before and read just after (2 LSTM forward and 2 LSTM
   backward launches per step, nothing else of the port's), every loss
   finite and the last below the first; one more step under
   torch.profiler;
10. the same for the GRU classifier of tools/gru_bench.py (vocab 30000,
   H 512; 1 GRU forward and 1 backward launch per step);
11. one f32 step of each sequence model at full width, batch 4, ragged
   lengths, from its phase's state, on the card and on the CPU: the loss
   and every @GRAD must agree;
then a JSON line with every ported kernel's launches, error and times,
the card's name and power limit, and the last line:
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet): memory rate and dense op rates.
#: "float32" is the CUDA cores' rate; "float32_3xtf32" that of an f32
#: product on the tensor cores as three TF32 products (the flash kernels)
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12,
            "float32_3xtf32": 495e12 / 3}
#: stated tolerances of kernel vs plain version.  Every kernel accumulates
#: in f32 and rounds its output once, as the plain version does.
#: An f32 output (any f32 output, the lse and the LN statistics of bf16
#: inputs included): max abs error <= F32_TOL * max(1, max |plain|), the
#: same f32 math summed in another order (the flash kernels' 3xTF32
#: products included).  A bf16 output, per element:
#: |kernel - plain| <= BF16_REL * |plain| + BF16_FLOOR, i.e. one bf16
#: rounding step (2^-7 relative at most) apart, plus a floor for the f32
#: reordering error of values near 0 (f32 errors measured at <= 3e-6).
#: The bf16 flash kernels round p and ds to bf16 as product operands,
#: which the plain versions do not; their outputs are held to one bf16
#: step of max(1, max |plain|) ("bf16_max" in `_err`).
F32_TOL = 2e-5
BF16_REL, BF16_FLOOR = 2.0 ** -7, 1e-4
#: engine logits against the full-prefix recompute after 12 bf16 layers:
#: max abs error over max(1, max |logit|)
E2E_TOL = 2e-2
FULL_WIDTH = dict(vocab=32000, max_len=2048, n_layers=12, d_model=768,
                  n_heads=12, d_ff=3072, eos_id=None)
#: the kernels the serving path runs
SERVE_KERNELS = ("paged_attention", "flash_attention_fwd", "layer_norm_fwd")
#: the repo's at-scale training config (bench.py bench_transformer_big):
#: 90.6 M trainable parameters, Adam, f32
TRAIN_CONFIG = dict(vocab=8192, max_len=512, n_layers=12, d_model=768,
                    n_heads=12, d_ff=3072)
TRAIN_BATCH, TRAIN_STEPS = 16, 20
#: kernel launches per training step: one attention and two LayerNorms in
#: each of the 12 layers, one loss head
TRAIN_LAUNCHES_PER_STEP = {
    "flash_attention_fwd": 12, "flash_attention_bwd": 12,
    "layer_norm_fwd": 24, "layer_norm_bwd": 24,
    "softmax_xent_fwd": 1, "softmax_xent_bwd": 1, "paged_attention": 0,
    "batch_norm_bwd": 0, "lstm_fwd": 0, "lstm_bwd": 0, "gru_fwd": 0,
    "gru_bwd": 0}
#: one step on the card against the same step on the CPU, both in full
#: f32 (TF32 off): the two devices sum every GEMM and reduction in
#: another order, and 12 post-LN layers of backward compound those
#: roundings; f32 reordering alone is ~1e-6 relative per sum, so the
#: limits leave an order of magnitude over what we expect (<= 1e-4):
#: loss relative error, and each @GRAD's max abs error over that
#: gradient's max |value|
CPU_LOSS_RTOL = 1e-4
CPU_GRAD_RTOL = 1e-3
#: the repo's ResNet-50 training config (bench.py bench_resnet, data
#: format NHWC, program.amp on): 25.6 M trainable parameters, Momentum
RESNET_CONFIG = dict(depth=50, class_dim=1000, image_shape=(224, 224, 3),
                     data_format="NHWC", lr=0.01, optimizer="momentum")
RESNET_BATCH, RESNET_STEPS = 128, 20
#: kernel launches per ResNet-50 step: one BatchNorm backward for each of
#: the 53 conv + BatchNorm layers, nothing else of the port's
RESNET_LAUNCHES_PER_STEP = dict(
    {name: 0 for name in TRAIN_LAUNCHES_PER_STEP}, batch_norm_bwd=53)
#: ResNet-50 card against CPU in full f32 at batch 2 (resnet_card_vs_cpu):
#: each @GRAD's norm-wise error may reach this many times the CPU's own
#: spread between two orders of summation
RESNET_CPU_BATCH = 2
RESNET_SPREAD_FACTOR = 4
#: BatchNorm backward shapes of ResNet-50 at batch 128, (N, H, W, C), and
#: a ragged one (R 1000 x C 96): each is checked as NHWC (N*H*W, C, 1)
#: and as NCHW (N, C, H*W)
BN_SHAPES = {"stem": (128, 112, 112, 64),
             "stage-1 expansion": (128, 56, 56, 256),
             "stage 4": (128, 7, 7, 2048), "ragged": (8, 5, 25, 96)}
#: the stacked dynamic LSTM at bench.py bench_lstm's config (:591-626:
#: models/stacked_lstm.py lstm_net, dict 30000, emb 512, hid 512, three
#: recurrences) and the GRU classifier of tools/gru_bench.py (vocab 30000,
#: H 512), each at batch 32, T 80, Adam lr 1e-3, program.amp on, on one
#: seeded batch with full lengths (as the bench feeds)
LSTM_CONFIG = dict(dict_dim=30000, emb_dim=512, hid_dim=512, stacked_num=3)
GRU_CONFIG = dict(vocab=30000, hid=512)
SEQ_BATCH, SEQ_T, SEQ_STEPS = 32, 80, 20
#: kernel launches per step: the two dynamic_lstm layers (the DynamicRNN
#: layer is eager torch) run one LSTM forward and one backward each; the
#: GRU classifier one GRU forward and backward
SEQ_LAUNCHES_PER_STEP = {
    "lstm": dict({name: 0 for name in TRAIN_LAUNCHES_PER_STEP},
                 lstm_fwd=2, lstm_bwd=2),
    "gru": dict({name: 0 for name in TRAIN_LAUNCHES_PER_STEP},
                gru_fwd=1, gru_bwd=1)}
#: phase 11: one f32 step of each at full width on the card and the CPU,
#: batch 4, ragged lengths
SEQ_CPU_BATCH = 4


def _time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes, ops, dtype):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _err(out, ref, rule=None):
    """(max abs error of ``out`` against ``ref``, its share of the stated
    tolerance); equal infinities count as no error.  ``rule`` is "f32"
    (F32_TOL relative to max(1, max |ref|)), "bf16" (per element, one
    bf16 rounding step plus BF16_FLOOR) or "bf16_max" (one bf16 rounding
    step of max(1, max |ref|)); by default the rule of ``ref``'s dtype."""
    import torch
    a, b = out.float(), ref.float()
    both_inf = torch.isinf(a) & torch.isinf(b) & (torch.sign(a)
                                                  == torch.sign(b))
    d = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
    mag = torch.where(torch.isinf(b), torch.zeros_like(b), b.abs())
    rule = rule or ("bf16" if ref.dtype == torch.bfloat16 else "f32")
    if rule == "bf16":
        share = (d / (BF16_REL * mag + BF16_FLOOR)).max()
    elif rule == "bf16_max":
        share = d.max() / (BF16_REL * max(1.0, float(mag.max())))
    else:
        share = d.max() / (F32_TOL * max(1.0, float(mag.max())))
    return float(d.max()), float(share)


def _check(name, pairs, dtype, label, rec, rule=None):
    """Fail unless every (kernel output, plain output) pair is within the
    tolerance of its dtype (or of ``rule``, see `_err`); keep the largest
    abs error and the largest share of the tolerance in the kernel's
    record ``rec``."""
    import torch
    errs = [_err(o, r, rule) for o, r in pairs]
    err = max(e for e, _ in errs)
    share = max(s for _, s in errs)
    ok = share <= 1.0
    differ = sum(int((o != r).sum()) for o, r in pairs)
    mag = max(float(torch.nan_to_num(r.float(), posinf=0.0,
                                     neginf=0.0).abs().max())
              for _, r in pairs)
    print(f"  {name} {label} {dtype}: max_abs_err {err:.3e}, "
          f"{share:.3f} of the tolerance {'ok' if ok else 'FAIL'} "
          f"({differ} elements differ; max |plain| {mag:.3e})",
          flush=True)
    if not ok:
        raise AssertionError(f"{name} {label} {dtype} disagrees with its "
                             f"plain version: {share:.3f} of the tolerance")
    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
    rec["limit_share"] = max(rec.get("limit_share", 0.0), share)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_paged_attention(rec):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    S, H, D, L, P = 16, 12, 64, 16, 128
    N = S * P
    g = torch.Generator(device="cpu").manual_seed(11)
    # ragged positions; slots 3 and 9 idle (sentinel row, index 0)
    index = torch.randint(0, P * L, (S,), generator=g).to(torch.int32)
    table = torch.full((S, P), N, dtype=torch.int32)
    perm = torch.randperm(N, generator=g).to(torch.int32)
    for s in range(S):
        if s in (3, 9):
            index[s] = 0
            continue
        need = int(index[s]) // L + 1
        table[s, :need] = perm[s * P:s * P + need]
    dev = torch.device("cuda")
    index, table = index.to(dev), table.to(dev)
    n_pos = sum(min(int(i), P * L - 1) + 1 for i in index.cpu())
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        q = torch.randn(S, H, 1, D, generator=g).to(dev, dtype)
        pk = torch.randn(N, L, H, D, generator=g).to(dev, dtype)
        pv = torch.randn(N, L, H, D, generator=g).to(dev, dtype)
        out = K.paged_attention(q, pk, pv, table, index)
        ref = K.paged_attention_plain(q, pk, pv, table, index)
        torch.cuda.synchronize()
        _check("paged_attention", [(out, ref)], dn,
               f"S{S} H{H} D{D} L{L} P{P}", rec)
        if dtype is torch.bfloat16:
            item = 2
            nbytes = (n_pos * H * D * 2 + 2 * S * H * D) * item \
                + table.numel() * 4 + index.numel() * 4
            ops = 4 * n_pos * H * D
            rec["ms"] = _time_ms(
                lambda: K.paged_attention(q, pk, pv, table, index))
            rec["plain_ms"] = _time_ms(
                lambda: K.paged_attention_plain(q, pk, pv, table, index))
            live = (torch.arange(P * L, device=dev)[None, :]
                    <= index[:, None].long())[:, None, None, :]

            def library():
                k = K.gather_slot_kv(pk, table)
                v = K.gather_slot_kv(pv, table)
                return F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=live)
            rec["library_ms"] = _time_ms(library)
            rec["bound_ms"], rec["bound_by"] = _bound(nbytes, ops, dn)
            rec["shape"] = (f"S{S} H{H} D{D} L{L} P{P} bf16, "
                            f"{n_pos} positions")


#: flash cases, (batch, tq, tk, causal): the serving prefill lengths, the
#: training shape B16 T512, and the tile edges (64-row tiles); at head_dim
#: 64 (the models') all of them, at 32 the edges and a long prefill
FLASH_EDGES = [(1, t, t, True) for t in (63, 65, 129)] + [
    (1, 65, 1000, True), (1, 65, 1000, False)]
FLASH_CASES = {64: [(1, t, t, True) for t in (7, 128, 1000, 2048)]
               + [(1, 100, 1000, True), (1, 100, 1000, False),
                  (16, 512, 512, True)] + FLASH_EDGES,
               32: [(1, 7, 7, True), (2, 128, 128, False),
                    (1, 1000, 1000, True)] + FLASH_EDGES}


def _device_ms(fn, iters=20, warmup=3):
    """Device time per call of ``fn`` from torch.profiler: the CUDA time of
    every kernel it launched, summed by name over ``iters`` calls, so,
    unlike `_time_ms`, without the host's enqueue.  Returns (ms per call,
    {kernel name: ms per call}), or (None, {}) when the profiler shows no
    device time (a measurement aid: reported, not fatal)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names = {r.key: r.device_time_total / 1e3 / iters
             for r in prof.key_averages()
             if r.device_type == torch.autograd.DeviceType.CUDA
             and r.device_time_total > 0}
    if not names:
        print("  profiler shows no device time", flush=True)
        return None, {}
    return sum(names.values()), names


def _flash_times(rec, kernel, plain, library, nbytes, ops, dtype, shape):
    """Fill ``rec`` with the times of one flash shape: CUDA-event ms of
    kernel, plain version and library (SDPA, or its backward), device ms
    per call of kernel and library, and the bound: f32 against 3xTF32 on
    the tensor cores, with the CUDA cores' bound beside it."""
    rec["ms"] = _time_ms(kernel, iters=50)
    rec["plain_ms"] = _time_ms(plain)
    rec["library_ms"] = _time_ms(library, iters=50)
    rec["device_ms"], names = _device_ms(kernel)
    rec["library_device_ms"], lib_names = _device_ms(library)
    f32 = dtype == "float32"
    rec["bound_ms"], rec["bound_by"] = _bound(
        nbytes, ops, "float32_3xtf32" if f32 else dtype)
    if f32:
        rec["bound_cuda_core_ms"] = _bound(nbytes, ops, "float32")[0]
    rec["shape"] = shape
    print(f"  {shape}: kernel {rec['ms']:.4f} ms (device "
          f"{rec['device_ms']}), library {rec['library_ms']:.4f} ms (device "
          f"{rec['library_device_ms']}), plain {rec['plain_ms']:.4f} ms, "
          f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}"
          + (f"; CUDA cores {rec['bound_cuda_core_ms']:.4f}" if f32 else "")
          + ")", flush=True)
    for what, table in (("kernel", names), ("library", lib_names)):
        print(f"    {what} device ms per call by name: " + "; ".join(
            f"{n[:70]} {t:.4f}" for n, t in sorted(table.items(),
                                                     key=lambda x: -x[1])),
              flush=True)
    return rec


def _flash_check(name, got, want, dtype, label, rec):
    """Hold a flash kernel's outputs to the plain version's: every f32
    output to F32_TOL; bf16 outputs to one bf16 step of their largest value
    ("bf16_max": the kernels round p and ds as product operands)."""
    import torch
    f32 = [(o, r) for o, r in zip(got, want) if r.dtype == torch.float32]
    bf = [(o, r) for o, r in zip(got, want) if r.dtype == torch.bfloat16]
    if f32:
        _check(name, f32, dtype, label + (" f32 lse" if bf else ""), rec,
               "f32")
    if bf:
        _check(name, bf, dtype, label + " (bf16_max)", rec, "bf16_max")


def check_flash_attention(rec):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    H = 12
    g = torch.Generator(device="cpu").manual_seed(12)
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        for D, cases in FLASH_CASES.items():
            for b, tq, tk, causal in cases:
                q = torch.randn(b, H, tq, D, generator=g).to(dev, dtype)
                k = torch.randn(b, H, tk, D, generator=g).to(dev, dtype)
                v = torch.randn(b, H, tk, D, generator=g).to(dev, dtype)
                out, lse = K.flash_attention_fwd(q, k, v, causal)
                ref, ref_lse = K.flash_attention_fwd_plain(q, k, v, causal)
                torch.cuda.synchronize()
                _flash_check("flash_attention_fwd", (out, lse),
                             (ref, ref_lse), dn,
                             f"D{D} B{b} tq{tq} tk{tk} causal={causal}", rec)
                if D != 64:
                    continue
                if dtype is torch.float32 and b == 16:
                    pairs = b * H * tq * (tq + 1) // 2
                    n = b * H * tq * D
                    rec["training"] = _flash_times(
                        {},
                        lambda: K.flash_attention_fwd(q, k, v, True),
                        lambda: K.flash_attention_fwd_plain(q, k, v, True),
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True),
                        4 * n * 4 + b * H * tq * 4, 4 * pairs * D, dn,
                        f"B{b} H{H} T{tq} D{D} causal f32")
                if dtype is torch.bfloat16 and (tq, tk, causal) == (
                        1000, 1000, True):
                    pairs = tq * (tq + 1) // 2
                    _flash_times(
                        rec,
                        lambda: K.flash_attention_fwd(q, k, v, True),
                        lambda: K.flash_attention_fwd_plain(q, k, v, True),
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True),
                        4 * tq * H * D * 2 + tq * H * 4, 4 * pairs * H * D,
                        dn, f"B1 H{H} T{tq} D{D} causal bf16")


def check_tensor_cores(paths):
    """Count the tensor-core instructions (HMMA) in the flash libraries'
    machine code with cuobjdump (beside nvcc, or in Triton's package);
    fail when either has none."""
    import glob
    from paddle_tpu_torch.ops import _build
    cands = [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")]
    try:
        import triton
        cands += glob.glob(os.path.join(os.path.dirname(triton.__file__),
                                        "backends", "nvidia", "bin",
                                        "cuobjdump"))
    except ImportError:
        pass
    tool = next((c for c in cands if os.path.exists(c)), None)
    if tool is None:
        raise AssertionError("cuobjdump not found: " + ", ".join(cands))
    counts = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        sass = subprocess.run([tool, "-sass", str(paths[name])],
                              capture_output=True, text=True,
                              check=True).stdout
        counts[name] = sum("HMMA" in line for line in sass.splitlines())
        print(f"  {name}: {counts[name]} HMMA instructions "
              f"(cuobjdump -sass)", flush=True)
        if counts[name] == 0:
            raise AssertionError(f"{name} holds no tensor-core instruction")
    return counts


def check_layer_norm(rec):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cpu").manual_seed(13)
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        for r in (16, 2048, 8192):
            for f in ((768,) if r == 8192 else (768, 3072, 1000)):
                x = (3 * torch.randn(r, f, generator=g) + 1).to(dev, dtype)
                sc = (1 + 0.1 * torch.randn(f, generator=g)).to(dev)
                bi = (0.1 * torch.randn(f, generator=g)).to(dev)
                y, mean, var = K.layer_norm_fwd(x, sc, bi, 1e-5)
                ry, rmean, rvar = K.layer_norm_fwd_plain(x, sc, bi, 1e-5)
                torch.cuda.synchronize()
                _check("layer_norm_fwd",
                       [(y, ry), (mean, rmean), (var, rvar)], dn,
                       f"R{r} F{f}", rec)
                if dtype is torch.float32 and r == 8192:
                    rec["training"] = _timings(
                        lambda: K.layer_norm_fwd(x, sc, bi, 1e-5),
                        lambda: K.layer_norm_fwd_plain(x, sc, bi, 1e-5),
                        lambda: F.layer_norm(x, (f,), sc, bi, 1e-5),
                        2 * r * f * 4 + 2 * f * 4 + 2 * r * 4, 8 * r * f,
                        dn, f"R{r} F{f} f32")
                if dtype is torch.bfloat16 and (r, f) == (16, 768):
                    nbytes = 2 * r * f * 2 + 2 * f * 4 + 2 * r * 4
                    ops = 8 * r * f
                    rec["ms"] = _time_ms(
                        lambda: K.layer_norm_fwd(x, sc, bi, 1e-5), iters=100)
                    rec["plain_ms"] = _time_ms(
                        lambda: K.layer_norm_fwd_plain(x, sc, bi, 1e-5),
                        iters=100)
                    w16, b16 = sc.to(dtype), bi.to(dtype)
                    rec["library_ms"] = _time_ms(
                        lambda: F.layer_norm(x, (f,), w16, b16, 1e-5),
                        iters=100)
                    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, ops,
                                                              "float32")
                    rec["shape"] = f"R{r} F{f} bf16"


def check_batch_norm_bwd(rec):
    import torch
    from paddle_tpu_torch.ops import kernels as K
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    for label, (n, h, w, c) in BN_SHAPES.items():
        numel = n * h * w * c
        xs = (1.5 * torch.randn(numel, generator=g, device=dev) + 0.3)
        dys = torch.randn(numel, generator=g, device=dev)
        sc = (1 + 0.3 * torch.randn(c, generator=g, device=dev))
        bi = 0.5 * torch.randn(c, generator=g, device=dev)
        for layout, view in (("NHWC", (n * h * w, c, 1)),
                             ("NCHW", (n, c, h * w))):
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).replace("torch.", "")
                x, dy = xs.to(dtype).view(view), dys.to(dtype).view(view)
                xf = x.float()
                mean = xf.mean(dim=(0, 2))
                inv = torch.rsqrt(xf.var(dim=(0, 2), unbiased=False) + 1e-5)
                del xf
                for act in (None, "relu"):
                    args = (x, dy, sc, bi, mean, inv, act)
                    got = K.batch_norm_bwd(*args)
                    ref = K.batch_norm_bwd_plain(*args)
                    torch.cuda.synchronize()
                    _check("batch_norm_bwd", list(zip(got, ref)), dn,
                           f"{label} {layout} {view} act={act}", rec)
                    del got, ref
                    # the main path's dtype and layout: the largest
                    # launch (the stem, relu fused) and a stage-1 one
                    case = (label, layout, dn, act)
                    if case == ("stem", "NHWC", "bfloat16", "relu"):
                        rec.update(_bn_timings(args, (n, h, w, c)))
                    elif case == ("stage-1 expansion", "NHWC", "bfloat16",
                                  None):
                        rec["training"] = _bn_timings(args, (n, h, w, c))


def _bn_timings(args, nhwc):
    """Kernel, plain and library ms and the bound of the BatchNorm
    backward on NHWC ``args``; the library is F.batch_norm's backward
    (cuDNN) on the same tensors in channels_last memory, no relu."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    x, dy, sc, bi = args[:4]
    n, h, w, c = nhwc
    numel = x.numel()
    xx, ww, bb = (t.detach().requires_grad_(True)
                  for t in (x.view(nhwc).permute(0, 3, 1, 2), sc, bi))
    lib = F.batch_norm(xx, None, None, ww, bb, training=True)
    bound, by = _bound(3 * numel * x.element_size() + 6 * c * 4,
                       15 * numel, "float32")
    return {"ms": _time_ms(lambda: K.batch_norm_bwd(*args)),
            "plain_ms": _time_ms(lambda: K.batch_norm_bwd_plain(*args)),
            "library_ms": _grad_ms(lib, (xx, ww, bb),
                                   dy.view(nhwc).permute(0, 3, 1, 2)),
            "bound_ms": bound, "bound_by": by,
            "shape": f"R{n * h * w} C{c} NHWC {x.dtype} act={args[6]}"}


def _timings(kernel, plain, library, nbytes, ops, dtype, shape):
    """Kernel, plain and library ms and the bound of one more shape."""
    bound, by = _bound(nbytes, ops, dtype)
    return {"ms": _time_ms(kernel), "plain_ms": _time_ms(plain),
            "library_ms": _time_ms(library), "bound_ms": bound,
            "bound_by": by, "shape": shape}


def _grad_ms(outputs, inputs, grads):
    """Time one autograd backward of a library call (its yardstick)."""
    import torch
    return _time_ms(lambda: torch.autograd.grad(outputs, inputs, grads,
                                                retain_graph=True))


def check_flash_attention_bwd(rec):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    H = 12
    g = torch.Generator(device="cpu").manual_seed(14)
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        for D, cases in FLASH_CASES.items():
            for b, tq, tk, causal in cases:
                if tq == 2048:     # the plain backward's [T, T] tensors
                    continue
                q = torch.randn(b, H, tq, D, generator=g).to(dev, dtype)
                k = torch.randn(b, H, tk, D, generator=g).to(dev, dtype)
                v = torch.randn(b, H, tk, D, generator=g).to(dev, dtype)
                do = torch.randn(b, H, tq, D, generator=g).to(dev, dtype)
                out, lse = K.flash_attention_fwd(q, k, v, causal)
                got = K.flash_attention_bwd(q, k, v, out, lse, do, causal)
                ref = K.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                  causal)
                torch.cuda.synchronize()
                label = f"D{D} B{b} tq{tq} tk{tk} causal={causal}"
                _flash_check("flash_attention_bwd", got, ref, dn, label, rec)
                if (D, b, tq, tk) != (64, 16, 512, 512):
                    continue
                again = K.flash_attention_bwd(q, k, v, out, lse, do, causal)
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                print(f"  flash_attention_bwd {label} {dn}: a second run "
                      f"is {'bitwise equal' if same else 'DIFFERENT'}",
                      flush=True)
                if not same:
                    raise AssertionError("the flash backward does not "
                                         "repeat bit for bit")
                rec.setdefault("bitwise_repeat", []).append(dn)
                if dtype is not torch.float32:
                    continue
                pairs = b * H * tq * (tq + 1) // 2
                n = b * H * tq * D
                qq, kk, vv = (t.detach().requires_grad_(True)
                              for t in (q, k, v))
                lib = F.scaled_dot_product_attention(qq, kk, vv,
                                                     is_causal=True)
                _flash_times(
                    rec, lambda: K.flash_attention_bwd(
                        q, k, v, out, lse, do, True),
                    lambda: K.flash_attention_bwd_plain(
                        q, k, v, out, lse, do, True),
                    lambda: torch.autograd.grad(lib, (qq, kk, vv), do,
                                                retain_graph=True),
                    (5 * n + 3 * n) * 4 + b * H * tq * 4, 10 * pairs * D,
                    dn, f"B{b} H{H} T{tq} D{D} causal f32")


def check_layer_norm_bwd(rec):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cpu").manual_seed(15)
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        for r, f in ((8192, 768), (16, 3072), (16, 1000), (2048, 1000)):
            x = (3 * torch.randn(r, f, generator=g) + 1).to(dev, dtype)
            dy = torch.randn(r, f, generator=g).to(dev, dtype)
            sc = (1 + 0.1 * torch.randn(f, generator=g)).to(dev)
            bi = (0.1 * torch.randn(f, generator=g)).to(dev)
            _, mean, var = K.layer_norm_fwd(x, sc, bi, 1e-5)
            inv = torch.rsqrt(var + 1e-5)
            got = K.layer_norm_bwd(x, sc, mean, inv, dy)
            ref = K.layer_norm_bwd_plain(x, sc, mean, inv, dy)
            torch.cuda.synchronize()
            _check("layer_norm_bwd", list(zip(got, ref)), dn,
                   f"R{r} F{f}", rec)
            if dtype is torch.float32 and (r, f) == (8192, 768):
                nbytes = 3 * r * f * 4 + 3 * f * 4 + 2 * r * 4
                ops = 12 * r * f
                rec["ms"] = _time_ms(
                    lambda: K.layer_norm_bwd(x, sc, mean, inv, dy), iters=50)
                rec["plain_ms"] = _time_ms(
                    lambda: K.layer_norm_bwd_plain(x, sc, mean, inv, dy),
                    iters=50)
                xx, ww, bb = (t.detach().requires_grad_(True)
                              for t in (x, sc, bi))
                lib = F.layer_norm(xx, (f,), ww, bb, 1e-5)
                rec["library_ms"] = _grad_ms(lib, (xx, ww, bb), dy)
                rec["bound_ms"], rec["bound_by"] = _bound(nbytes, ops, dn)
                rec["shape"] = f"R{r} F{f} f32"


def check_softmax_xent(rec_fwd, rec_bwd):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cpu").manual_seed(16)
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        for r, v, extreme in ((8192, 8192, False), (64, 1000, False),
                              (64, 8192, True)):
            x = (2 * torch.randn(r, v, generator=g))
            if extreme:     # +-1e4 logits, rows that saturate the exp
                x[::2, ::3] = 1e4
                x[1::2, 1::5] = -1e4
            x = x.to(dev, dtype)
            lab = torch.randint(0, v, (r,), generator=g)
            lab[3], lab[5] = -1, v          # out of range: gold 0
            lab = lab.to(dev, torch.int32)
            dl = torch.rand(r, generator=g).to(dev)
            loss, lse = K.softmax_xent_fwd(x, lab)
            rloss, rlse = K.softmax_xent_fwd_plain(x, lab)
            dx = K.softmax_xent_bwd(x, lab, lse, dl)
            rdx = K.softmax_xent_bwd_plain(x, lab, lse, dl)
            torch.cuda.synchronize()
            label = f"R{r} V{v}" + (" +-1e4" if extreme else "")
            _check("softmax_xent_fwd", [(loss, rloss), (lse, rlse)], dn,
                   label, rec_fwd)
            _check("softmax_xent_bwd", [(dx, rdx)], dn, label, rec_bwd)
            if dtype is torch.float32 and (r, v, extreme) == (8192, 8192,
                                                              False):
                shape = f"R{r} V{v} f32"
                rec_fwd["ms"] = _time_ms(lambda: K.softmax_xent_fwd(x, lab))
                rec_fwd["plain_ms"] = _time_ms(
                    lambda: K.softmax_xent_fwd_plain(x, lab))
                # the library asserts on a label outside [0, V): it is
                # timed on the in-range labels
                lab64 = lab.long().clamp(0, v - 1)
                rec_fwd["library_ms"] = _time_ms(lambda: F.cross_entropy(
                    x, lab64, reduction="none"))
                rec_fwd["bound_ms"], rec_fwd["bound_by"] = _bound(
                    r * v * 4 + r * 4 + 2 * r * 4, 4 * r * v, dn)
                rec_fwd["shape"] = shape
                rec_bwd["ms"] = _time_ms(
                    lambda: K.softmax_xent_bwd(x, lab, lse, dl))
                rec_bwd["plain_ms"] = _time_ms(
                    lambda: K.softmax_xent_bwd_plain(x, lab, lse, dl))
                xx = x.detach().requires_grad_(True)
                lib = F.cross_entropy(xx, lab64, reduction="none")
                rec_bwd["library_ms"] = _grad_ms(lib, (xx,), dl)
                rec_bwd["bound_ms"], rec_bwd["bound_by"] = _bound(
                    2 * r * v * 4 + 3 * r * 4, 4 * r * v, dn)
                rec_bwd["shape"] = shape


def _recurrent_inputs(gates, t, b, h, lens, reverse, g):
    """Seeded inputs of a recurrent kernel on the card: xs, w (f32), h0,
    c0, the [T, B, 1] mask of ``lens`` ("full" or "ragged": seeded lengths
    in [1, T], every seventh row of length 1; reversed in time for
    ``reverse``, as the rule hands an is_reverse layer to the kernel), and
    the cotangents dhs, dcs."""
    import torch
    dev = torch.device("cuda")
    if lens == "full":
        n = torch.full((b,), t)
    else:
        n = torch.randint(1, t + 1, (b,), generator=g)
        n[::7] = 1
        n[1] = t
    mask = (torch.arange(t)[:, None] < n[None, :]).float()[:, :, None]
    if reverse:
        mask = mask.flip(0)
    xs = 0.5 * torch.randn(t, b, gates * h, generator=g)
    w = torch.randn(h, gates * h, generator=g) / math.sqrt(h)
    h0, c0 = (0.5 * torch.randn(b, h, generator=g) for _ in range(2))
    dhs, dcs = (torch.randn(t, b, h, generator=g) for _ in range(2))
    return [x.to(dev).contiguous()
            for x in (xs, w, h0, c0, mask.contiguous(), dhs, dcs)]


def check_recurrent(kind, rec_fwd, rec_bwd):
    """Phase 3 for the LSTM (``kind`` "lstm") or GRU ("gru") kernels:
    forward and backward against their plain versions at T80 B32 H512 with
    full and ragged lengths and one is_reverse mask, and at T7 B5 H96;
    the LSTM with f32 w and with the bf16 w of program.amp, the GRU with
    f32 w (and one bf16 w case off the main path).  f32 w: F32_TOL.  bf16
    w: the kernel and the plain version round h_prev to bf16 each step,
    and an f32 reordering can flip one rounding, which the recurrence
    carries on to values near 0: the outputs are held to one bf16
    rounding step of their largest value ("bf16_max"); the share of the
    per-element bf16 rule is printed beside it, not held.  Times at the
    main path's shape and w dtype (the LSTM's bf16 w under program.amp,
    the GRU's f32), and the LSTM's also with f32 w, the dtype of its
    library yardstick.  At H 1024 (8 units a block) the forward is
    checked too, and the backward, whose w slices do not fit shared
    memory, must refuse to launch."""
    import torch
    from paddle_tpu_torch.ops import kernels as K
    lstm = kind == "lstm"
    gates = 4 if lstm else 3
    g = torch.Generator(device="cpu").manual_seed(18 if lstm else 19)
    cases = [(80, 32, 512, "full", False), (80, 32, 512, "ragged", False),
             (80, 32, 512, "ragged", True), (7, 5, 96, "ragged", False)]
    runs = [(c, wd) for wd in (torch.float32, torch.bfloat16)
            for c in cases]
    if not lstm:
        runs = [(c, torch.float32) for c in cases] + [
            (cases[0], torch.bfloat16)]
    for (t, b, h, lens, rev), wdt in runs:
        xs, w32, h0, c0, mask, dhs, dcs = _recurrent_inputs(
            gates, t, b, h, lens, rev, g)
        w = w32.to(wdt)
        dn = str(wdt).replace("torch.", "")
        label = (f"T{t} B{b} H{h} {lens}" + (" reverse" if rev else "")
                 + f" w {dn}")
        bf = wdt is torch.bfloat16
        if lstm:
            fwd_args = (xs, w, h0, c0, mask)
            got = K.lstm_fwd(*fwd_args)
            ref = K.lstm_fwd_plain(*fwd_args)
            bwd_args = fwd_args + tuple(ref) + (dhs, dcs)
            dgot = K.lstm_bwd(*bwd_args)
            dref = K.lstm_bwd_plain(*bwd_args)
        else:
            fwd_args = (xs, w, h0, mask)
            got = (K.gru_fwd(*fwd_args),)
            ref = (K.gru_fwd_plain(*fwd_args),)
            bwd_args = fwd_args + (ref[0], dhs)
            dgot = K.gru_bwd(*bwd_args)
            dref = K.gru_bwd_plain(*bwd_args)
        torch.cuda.synchronize()
        for name, pairs, rec in ((f"{kind}_fwd", list(zip(got, ref)),
                                  rec_fwd),
                                 (f"{kind}_bwd", list(zip(dgot, dref)),
                                  rec_bwd)):
            _check(name, pairs, "float32", label, rec,
                   "bf16_max" if bf else None)
            if bf:
                print(f"    per-element bf16 rule: "
                      f"{max(_err(o, r, 'bf16')[1] for o, r in pairs):.3f} "
                      "of it (not held)", flush=True)
        main_dtype = torch.bfloat16 if lstm else torch.float32
        if (t, lens, rev, wdt) == (80, "full", False, main_dtype):
            rec_fwd.update(_recurrent_timings(kind, False, fwd_args,
                                              bwd_args))
            rec_bwd.update(_recurrent_timings(kind, True, fwd_args,
                                              bwd_args))
        elif lstm and (t, lens, rev) == (80, "full", False):
            # the f32 w, in the library's dtype
            rec_fwd["f32_w"] = _recurrent_timings(kind, False, fwd_args,
                                                  bwd_args)
            rec_bwd["f32_w"] = _recurrent_timings(kind, True, fwd_args,
                                                  bwd_args)
        del got, ref, dgot, dref
    # H 1024: 8 units a block; the forward fits, the backward's w slices
    # do not fit shared memory, and its launch must be refused, not hang
    xs, w, h0, c0, mask, dhs, dcs = _recurrent_inputs(
        gates, 3, 4, 1024, "ragged", False, g)
    if lstm:
        got, ref = K.lstm_fwd(xs, w, h0, c0, mask), \
            K.lstm_fwd_plain(xs, w, h0, c0, mask)
        refused = lambda: K.lstm_bwd(xs, w, h0, c0, mask, *ref, dhs, dcs)
    else:
        got, ref = (K.gru_fwd(xs, w, h0, mask),), \
            (K.gru_fwd_plain(xs, w, h0, mask),)
        refused = lambda: K.gru_bwd(xs, w, h0, mask, ref[0], dhs)
    torch.cuda.synchronize()
    _check(f"{kind}_fwd", list(zip(got, ref)), "float32",
           "T3 B4 H1024 ragged w float32", rec_fwd)
    try:
        refused()
    except RuntimeError as e:
        if "cannot be placed" not in str(e):
            raise
        print(f"  {kind}_bwd T3 B4 H1024: refused ({e})", flush=True)
    else:
        raise AssertionError(f"{kind}_bwd launched at H 1024, whose w "
                             "slices do not fit shared memory")


def _recurrent_timings(kind, backward, fwd_args, bwd_args):
    """Kernel, plain and library ms and the bound of a recurrent kernel.
    Bytes: each input read once, each output written once.  Operations:
    the products, 2*T*B*H*G*H forward (G = 4 gates for the LSTM, 3 for the
    GRU) and three times that backward (the gates again, dw, dh_prev), at
    the rate of w's dtype.  Library: torch.nn.LSTM (cuDNN) forward or
    backward at the same T, B, H in f32, which also does the input
    product x . W_ih; none for the GRU (cuDNN's GRU computes
    r * (h . W_c), another function than (r * h) . W_c)."""
    import torch
    from paddle_tpu_torch.ops import kernels as K
    lstm = kind == "lstm"
    args = bwd_args if backward else fwd_args
    xs, w = args[0], args[1]
    t, b, gh = xs.shape
    h = w.shape[0]
    if lstm:
        fn = K.lstm_bwd if backward else K.lstm_fwd
        plain = K.lstm_bwd_plain if backward else K.lstm_fwd_plain
        out_bytes = (xs.numel() + w.numel() + 2 * b * h) * 4 if backward \
            else 2 * t * b * h * 4
    else:
        fn = K.gru_bwd if backward else K.gru_fwd
        plain = K.gru_bwd_plain if backward else K.gru_fwd_plain
        out_bytes = (xs.numel() + w.numel() + b * h) * 4 if backward \
            else t * b * h * 4
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    ops = 2 * t * b * h * gh * (3 if backward else 1)
    dn = str(w.dtype).replace("torch.", "")
    bound, by = _bound(in_bytes + out_bytes, ops, dn)
    library = None
    if lstm:
        lib = torch.nn.LSTM(h, h).cuda()
        x = torch.randn(t, b, h, device="cuda")
        if backward:
            x.requires_grad_(True)
            out, _ = lib(x)
            library = _grad_ms(out, [x] + list(lib.parameters()),
                               torch.randn_like(out))
        else:
            with torch.no_grad():
                library = _time_ms(lambda: lib(x))
    return {"ms": _time_ms(lambda: fn(*args)),
            "plain_ms": _time_ms(lambda: plain(*args), iters=5, warmup=1),
            "library_ms": library, "bound_ms": bound, "bound_by": by,
            "shape": f"T{t} B{b} H{h} w {dn}" + (
                "" if lstm else "; library none: cuDNN's GRU computes "
                "r*(h.W_c), not (r*h).W_c")}


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

def _save_model(model_dir, spec, seed):
    import numpy as np
    from paddle_tpu_torch.models.transformer import (GENERATION_SPEC_FILENAME,
                                                     random_params)
    os.makedirs(model_dir, exist_ok=True)
    for f in os.listdir(model_dir):
        os.unlink(os.path.join(model_dir, f))
    for name, arr in random_params(spec, seed).items():
        np.save(os.path.join(model_dir, name + ".npy"), arr)
    with open(os.path.join(model_dir, GENERATION_SPEC_FILENAME), "w") as f:
        json.dump(spec, f)


def serve(seed=0):
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                        greedy_decode_full)
    spec = dict(FULL_WIDTH)
    model_dir = os.path.join(HERE, "build", "smoke_model")
    t0 = time.perf_counter()
    _save_model(model_dir, spec, seed)
    engine = DecodeEngine.from_model_dir(model_dir, precision="bf16",
                                         slots=16, block_len=16, warmup=True)
    torch.cuda.synchronize()
    pool_bytes = sum(p.numel() * p.element_size()
                     for pair in engine._pools for p in pair)
    print(f"  model saved and loaded, engine warm: "
          f"{time.perf_counter() - t0:.1f} s; KV pools "
          f"{pool_bytes / 2**30:.2f} GiB", flush=True)
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, 1025, 32)
    prompts = [rng.integers(0, spec["vocab"], n).tolist() for n in lens]
    checked = (0, 17)        # streams recomputed through the full model
    max_new = 64
    try:
        K.reset_launches()
        t0 = time.perf_counter()
        handles = [engine.submit(p, max_new, capture_logits=i in checked)
                   for i, p in enumerate(prompts)]
        results = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in K.KERNELS}
        stats = engine.stats()
    finally:
        engine.close()
    n_tok = sum(len(r["tokens"]) for r in results)
    for r in results:
        if len(r["tokens"]) != max_new or r["finish_reason"] != "length":
            raise AssertionError(f"stream ended early: {r['finish_reason']}"
                                 f" after {len(r['tokens'])} tokens")
        if not all(0 <= t < spec["vocab"] for t in r["tokens"]):
            raise AssertionError("token id out of range")
    print(f"  launches on the serving path: {launches}", flush=True)
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "serving path")
    print(f"  32 requests, {n_tok} tokens in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tokens/s; TTFT ms {stats['ttft_ms']}; "
          f"step ms {stats['step_ms']}; prefills {stats['prefills']}, "
          f"decode steps {stats['iterations']}", flush=True)
    # cross-check two streams against the full-prefix recompute
    n_check = 8
    for i in checked:
        full = greedy_decode_full(engine.model, [prompts[i]], n_check,
                                  capture_logits=True)
        kv_logits = results[i]["logits"]
        compared = 0
        for step in range(n_check):
            a = kv_logits[step]
            b = full["logits"][step][0]
            err = float(np.abs(a - b).max())
            tol = E2E_TOL * max(1.0, float(np.abs(b).max()))
            if err > tol:
                raise AssertionError(
                    f"stream {i} token {step}: engine logits differ from "
                    f"the full recompute by {err}")
            compared += 1
            if full["tokens"][0][step] != results[i]["tokens"][step]:
                top2 = np.sort(b)[-2:]
                if top2[1] - top2[0] > tol:
                    raise AssertionError(
                        f"stream {i} token {step}: greedy choice differs "
                        f"from the full recompute without a near tie")
                print(f"  stream {i} diverges at token {step} on a near "
                      f"tie (top-2 gap {top2[1] - top2[0]:.3e})")
                break
        print(f"  stream {i} (prompt {len(prompts[i])}): engine logits "
              f"match the full recompute at {compared} tokens", flush=True)
    return launches, {"tokens_per_s": n_tok / wall,
                      "ttft_ms": stats["ttft_ms"],
                      "step_ms": stats["step_ms"]}


# ---------------------------------------------------------------------------
# phases 5 and 6: training through the Fluid front end
# ---------------------------------------------------------------------------

def _train_program(seed):
    """Build the training config in fresh default programs; returns
    (main, startup, avg_cost)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer
    fluid.core.program.reset_default_programs()
    _, _, avg_cost = transformer.transformer_lm_train_program(**TRAIN_CONFIG)
    startup = fluid.default_startup_program()
    startup.random_seed = seed
    return fluid.default_main_program(), startup, avg_cost


def _copy_feed(batch, seed):
    """One fixed batch of seeded tokens; labels are the tokens shifted by
    one (tests/test_transformer.py's copy task)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, TRAIN_CONFIG["vocab"],
                        (batch, TRAIN_CONFIG["max_len"])).astype(np.int64)
    return {"tokens": seqs, "labels": np.roll(seqs, -1, axis=1)}


def _train_steps(main, startup, avg_cost, feed, steps, per_step,
                 other="other"):
    """Startup, then ``steps`` steps of ``main`` on the card on one fixed
    feed, with the launch counts zeroed just before the steps and read
    just after, then one profiled step.  Fails unless each kernel
    launched ``per_step[name]`` times a step and the loss is finite and
    falls.  Returns (launches, end-to-end numbers, state after the
    steps)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import kernels as K
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters()
                   if p.trainable)
    n_persist = sum(int(np.prod(v.shape)) for v in main.list_vars()
                    if v.persistable and not v.desc.is_data)
    scope = fluid.core.scope.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        print(f"  {n_params / 1e6:.2f} M trainable parameters, "
              f"{n_persist * 4 / 2**30:.2f} GiB of f32 state; startup "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        losses, ms = [], []
        for step in range(steps):
            t = time.perf_counter()
            (loss,) = exe.run(main, feed=feed, fetch_list=[avg_cost])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(loss))
            print(f"  step {step + 1}: loss {losses[-1]:.6f}, "
                  f"{ms[-1]:.2f} ms", flush=True)
        launches = {k.name: k.launches for k in K.KERNELS}
        peak = torch.cuda.max_memory_allocated()
        device = _profile_step(exe, main, feed, avg_cost, other)
        state = {n: t.cpu().numpy() for n, t in scope._vars.items()}
    print(f"  launches in {steps} steps: {launches}", flush=True)
    for name, n in per_step.items():
        if launches[name] != n * steps:
            raise AssertionError(
                f"{name}: {launches[name]} launches in {steps} steps, "
                f"want {n} per step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    # step 1 pays one-time costs (cuBLAS handles, cuDNN plans, allocator
    # growth): it is reported apart from the steady-state percentiles
    p50, p99 = np.percentile(ms[1:], 50), np.percentile(ms[1:], 99)
    e2e = {"step1_ms": ms[0], "step_ms_p50": float(p50),
           "step_ms_p99": float(p99),
           "loss_first": losses[0], "loss_last": losses[-1],
           "peak_mem_gib": peak / 2**30, "profiled_device_ms": device,
           "device_busy_share": (device["all"] / p50 if device is not None
                                 else None)}
    return launches, e2e, state


def train(seed=0):
    """Phase 5: TRAIN_STEPS Adam steps at batch TRAIN_BATCH on the card."""
    main, startup, avg_cost = _train_program(seed)
    launches, e2e, state = _train_steps(
        main, startup, avg_cost, _copy_feed(TRAIN_BATCH, seed), TRAIN_STEPS,
        TRAIN_LAUNCHES_PER_STEP)
    per_s = 1e3 / e2e["step_ms_p50"]
    e2e.update(examples_per_s=TRAIN_BATCH * per_s,
               tokens_per_s=TRAIN_BATCH * TRAIN_CONFIG["max_len"] * per_s)
    return launches, e2e, state


def _profile_step(exe, main, feed, avg_cost, other="other"):
    """One more step under torch.profiler: device time by kernel name;
    returns the step's device ms in all and by group (None if the
    profiler fails); ``other`` names the group of everything that is not
    a port kernel, a library product or a reduction.  A measurement aid
    only; its failure is reported, not fatal."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            exe.run(main, feed=feed, fetch_list=[avg_cost])
            torch.cuda.synchronize()
        kernels = [r for r in prof.key_averages()
                   if r.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(r.device_time_total for r in kernels)
        print(f"  profiled step (first 15 kernels, then the port's): "
              f"{total / 1e3:.2f} ms of device time in "
              f"{sum(r.count for r in kernels)} kernel launches; by "
              "kernel (ms, launches):", flush=True)
        ours = ("flash_", "ln_", "sm_xent_", "paged_", "bn_", "lstm_",
                "gru_")
        ranked = sorted(kernels, key=lambda r: -r.device_time_total)
        for i, r in enumerate(ranked):
            if i < 15 or any(f in r.key for f in ours):
                print(f"    {r.device_time_total / 1e3:9.3f}  "
                      f"x{r.count:<5d} {r.key[:100]}")
        # the same time in groups: the port's kernels, library products
        # (cuDNN convolutions, cuBLAS/CUTLASS GEMMs), PyTorch reductions,
        # and the rest (elementwise math, casts, copies, fills)
        groups = {"port": ours,
                  "library products": ("xmma", "gemm", "conv", "cudnn",
                                       "cutlass", "implicit", "wgrad",
                                       "dgrad", "fprop", "nvjet"),
                  "reductions": ("reduce_kernel",)}
        sums = dict.fromkeys(list(groups) + [other], 0.0)
        for r in kernels:
            name = next((g for g, keys in groups.items()
                         if any(k in r.key.lower() for k in keys)), other)
            sums[name] += r.device_time_total / 1e3
        print("  by group (ms): " + ", ".join(
            f"{g} {t:.2f}" for g, t in sums.items()), flush=True)
        return dict({"all": total / 1e3}, **sums)
    except Exception as e:  # noqa: BLE001  (a measurement aid)
        print(f"  profiler unavailable: {type(e).__name__}: {e}",
              flush=True)
        return None


def _step(place, main, avg_cost, feed, state):
    """One step of ``main`` on ``place`` from the carried-in ``state``:
    (parameter names, [loss, then each parameter's @GRAD])."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    params = [p.name for p in main.all_parameters() if p.trainable]
    exe = fluid.Executor(place)
    scope = fluid.core.scope.Scope()
    pio.scope_from_numpy(scope, main, state, exe.device)
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope,
                  fetch_list=[avg_cost.name] + [p + "@GRAD" for p in params])
    print(f"  {type(place).__name__}: loss {float(out[0]):.7f} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return params, out


def card_vs_cpu(state, seed=0):
    """Phase 6: the training program at full width, batch 1: one step from
    the same carried-in state and feed on the card (kernels) and on the
    CPU (plain versions); the loss and every @GRAD must agree."""
    import numpy as np
    import paddle_tpu_torch as fluid
    main, _, avg_cost = _train_program(seed)
    feed = _copy_feed(1, seed + 1)
    params, card = _step(fluid.CUDAPlace(0), main, avg_cost, feed, state)
    _, cpu = _step(fluid.CPUPlace(), main, avg_cost, feed, state)
    loss_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    errs = sorted(((float(np.abs(a - b).max())
                    / max(float(np.abs(b).max()), 1e-30), n)
                   for n, a, b in zip(params, card[1:], cpu[1:])),
                  reverse=True)
    print(f"  loss relative error {loss_err:.3e} (limit {CPU_LOSS_RTOL}); "
          f"largest @GRAD errors over each gradient's max |value| "
          f"(limit {CPU_GRAD_RTOL}): "
          + ", ".join(f"{n} {e:.3e}" for e, n in errs[:5]), flush=True)
    if loss_err > CPU_LOSS_RTOL or errs[0][0] > CPU_GRAD_RTOL:
        raise AssertionError("the card's step disagrees with the CPU's")
    return {"loss_rel_err": loss_err, "grad_rel_err_max": errs[0][0],
            "grads_compared": len(params)}


# ---------------------------------------------------------------------------
# phases 7 and 8: ResNet-50 training through the Fluid front end
# ---------------------------------------------------------------------------

def _resnet_program(seed, amp):
    """Build ResNet-50 in fresh default programs; returns (main, startup,
    avg_cost)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    fluid.core.program.reset_default_programs()
    _, _, avg_cost, _ = resnet.resnet_train_program(**RESNET_CONFIG)
    main = fluid.default_main_program()
    main.amp = amp
    startup = fluid.default_startup_program()
    startup.random_seed = seed
    return main, startup, avg_cost


def _image_feed(batch, seed, device):
    """One fixed batch of seeded random images in [0, 1) and labels, as
    tensors on ``device`` (bench.py bench_resnet stages its batches on the
    device too)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    shape = (batch,) + RESNET_CONFIG["image_shape"]
    return {"data": torch.from_numpy(
                rng.random(shape, dtype=np.float32)).to(device),
            "label": torch.from_numpy(rng.integers(
                0, RESNET_CONFIG["class_dim"], (batch, 1))).to(device)}


def train_resnet(seed=0):
    """Phase 7: RESNET_STEPS Momentum steps of ResNet-50 at RESNET_BATCH
    under program.amp on the card."""
    import torch
    main, startup, avg_cost = _resnet_program(seed, amp=True)
    launches, e2e, state = _train_steps(
        main, startup, avg_cost,
        _image_feed(RESNET_BATCH, seed, torch.device("cuda")), RESNET_STEPS,
        RESNET_LAUNCHES_PER_STEP)
    e2e["images_per_s"] = RESNET_BATCH * 1e3 / e2e["step_ms_p50"]
    e2e["conv_outputs_contiguous_nhwc"] = _nhwc_conv_outputs(state, seed)
    # the BatchNorm backward's least time in a step: read x and dy and
    # write dx of every BatchNorm layer once, in bf16 (program.amp)
    elems = sum(RESNET_BATCH * math.prod(op.block.var(
        op.desc.inputs["X"][0]).shape[1:]) for op in main.global_block().ops
        if op.type == "batch_norm")
    e2e["bn_elements_per_step"] = elems
    e2e["bn_bwd_bound_ms_per_step"] = 3 * elems * 2 / MEM_BYTES_PER_S * 1e3
    return launches, e2e, state


def _norm_errs(params, got, want):
    """Each @GRAD's relative error ||got - want|| / ||want||, largest
    first."""
    import numpy as np
    return sorted(((float(np.linalg.norm(a - b))
                    / max(float(np.linalg.norm(b)), 1e-30), n)
                   for n, a, b in zip(params, got, want)), reverse=True)


def _nhwc_conv_outputs(state, seed):
    """How many of the ResNet-50 step's conv outputs are contiguous NHWC
    tensors (one more step at batch 8 from ``state``): cuDNN must return
    channels_last outputs, or every BatchNorm would copy its input.
    Fails unless all are."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    main, _, _ = _resnet_program(seed, amp=True)
    names = [op.desc.outputs["Output"][0] for op in main.global_block().ops
             if op.type == "conv2d"]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.core.scope.Scope()
    pio.scope_from_numpy(scope, main, state, exe.device)
    outs = exe.run(main, feed=_image_feed(8, seed, exe.device),
                   fetch_list=names, scope=scope, return_numpy=False)
    n = sum(int(t.is_contiguous()) for t in outs)
    print(f"  conv outputs contiguous NHWC: {n} of {len(names)}", flush=True)
    if n != len(names):
        raise AssertionError("a conv output is not contiguous NHWC")
    return n


def resnet_card_vs_cpu(state, seed=0):
    """Phase 8: ResNet-50 in f32 at batch RESNET_CPU_BATCH: one step from
    phase 7's state and one feed on the card (kernel) and on the CPU
    (plain version).  The loss must agree to CPU_LOSS_RTOL.  The gradients
    of this step are ill-conditioned in f32: BatchNorm over as few as 98
    rows, 53 times over, magnifies a reordered sum's 1e-7 into percents.
    So the CPU takes the step a second time on one thread (another order
    of every sum), and each @GRAD's norm-wise error on the card must stay
    within RESNET_SPREAD_FACTOR x the largest such spread of the CPU
    against itself (and CPU_GRAD_RTOL at least)."""
    import torch
    import paddle_tpu_torch as fluid
    main, _, avg_cost = _resnet_program(seed, amp=False)
    feed = {k: v.numpy() for k, v in _image_feed(
        RESNET_CPU_BATCH, seed + 1, torch.device("cpu")).items()}
    params, card = _step(fluid.CUDAPlace(0), main, avg_cost, feed, state)
    _, cpu = _step(fluid.CPUPlace(), main, avg_cost, feed, state)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, cpu1 = _step(fluid.CPUPlace(), main, avg_cost, feed, state)
    finally:
        torch.set_num_threads(threads)
    loss_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    errs = _norm_errs(params, card[1:], cpu[1:])
    spread = _norm_errs(params, cpu1[1:], cpu[1:])
    limit = max(CPU_GRAD_RTOL, RESNET_SPREAD_FACTOR * spread[0][0])
    print(f"  loss relative error {loss_err:.3e} (limit {CPU_LOSS_RTOL}); "
          f"CPU {threads} threads against 1, largest @GRAD norm-wise "
          "spreads: " + ", ".join(f"{n} {e:.3e}" for e, n in spread[:3])
          + f"; card against CPU (limit {limit:.3e}): "
          + ", ".join(f"{n} {e:.3e}" for e, n in errs[:5]), flush=True)
    if loss_err > CPU_LOSS_RTOL or errs[0][0] > limit:
        raise AssertionError("the card's ResNet-50 step disagrees with the "
                             "CPU's")
    return {"loss_rel_err": loss_err, "grad_norm_rel_err_max": errs[0][0],
            "cpu_spread_max": spread[0][0], "grad_limit": limit,
            "grads_compared": len(params)}


# ---------------------------------------------------------------------------
# phases 9, 10 and 11: the sequence models through the Fluid front end
# ---------------------------------------------------------------------------

def _seq_program(model, seed, amp):
    """Build the stacked LSTM (``model`` "lstm") or the GRU classifier
    ("gru") + Adam in fresh default programs; returns (main, startup,
    avg_cost)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.models.stacked_lstm import lstm_net
    fluid.core.program.reset_default_programs()
    data = layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = layers.data(name="label", shape=[1], dtype="int64")
    if model == "lstm":
        avg_cost, _, _ = lstm_net(data, label, **LSTM_CONFIG)
    else:
        vocab, hid = GRU_CONFIG["vocab"], GRU_CONFIG["hid"]
        emb = layers.embedding(input=data, size=[vocab, hid])
        proj = layers.fc(input=emb, size=3 * hid, num_flatten_dims=2)
        seq = layers.dynamic_gru(input=proj, size=hid)
        pooled = layers.sequence_pool(input=seq, pool_type="max")
        pred = layers.fc(input=pooled, size=2, act="softmax")
        avg_cost = layers.mean(layers.cross_entropy(input=pred, label=label))
    optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    main = fluid.default_main_program()
    main.amp = amp
    startup = fluid.default_startup_program()
    startup.random_seed = seed
    return main, startup, avg_cost


def _word_feed(batch, seed, ragged=False):
    """One seeded batch of token ids [batch, SEQ_T], their lengths (all
    SEQ_T, or seeded in [1, SEQ_T] with the first row full and the last of
    length 1) and binary labels, as numpy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = np.full(batch, SEQ_T, np.int32)
    if ragged:
        lens = rng.integers(1, SEQ_T + 1, batch).astype(np.int32)
        lens[0], lens[-1] = SEQ_T, 1
    return {"words": rng.integers(0, 30000, (batch, SEQ_T)),
            "words@SEQ_LEN": lens,
            "label": rng.integers(0, 2, (batch, 1))}


def train_sequence(model, seed=0):
    """Phases 9 and 10: SEQ_STEPS Adam steps of the stacked LSTM or the GRU
    classifier at SEQ_BATCH x SEQ_T under program.amp on the card, the
    batch staged on the card."""
    import torch
    main, startup, avg_cost = _seq_program(model, seed, amp=True)
    feed = {k: torch.from_numpy(v).to("cuda")
            for k, v in _word_feed(SEQ_BATCH, seed).items()}
    launches, e2e, state = _train_steps(
        main, startup, avg_cost, feed, SEQ_STEPS,
        SEQ_LAUNCHES_PER_STEP[model],
        other="the DynamicRNN's eager per-step ops and other elementwise")
    per_s = 1e3 / e2e["step_ms_p50"]
    e2e.update(examples_per_s=SEQ_BATCH * per_s,
               tokens_per_s=SEQ_BATCH * SEQ_T * per_s)
    return launches, e2e, state


def seq_card_vs_cpu(model, state, seed=0):
    """Phase 11: the model in f32 (amp off, TF32 off) at full width, batch
    SEQ_CPU_BATCH with ragged lengths: one step from the carried-in state
    on the card (kernels) and on the CPU (plain versions), held to the LM's
    rule (CPU_LOSS_RTOL; CPU_GRAD_RTOL on each @GRAD's max abs error over
    its max |value|).  The CPU's own spread between its thread count and 1
    thread is measured and printed beside it."""
    import numpy as np
    import torch
    import paddle_tpu_torch as fluid
    main, _, avg_cost = _seq_program(model, seed, amp=False)
    feed = _word_feed(SEQ_CPU_BATCH, seed + 1, ragged=True)
    params, card = _step(fluid.CUDAPlace(0), main, avg_cost, feed, state)
    _, cpu = _step(fluid.CPUPlace(), main, avg_cost, feed, state)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, cpu1 = _step(fluid.CPUPlace(), main, avg_cost, feed, state)
    finally:
        torch.set_num_threads(threads)

    def errs(got, want):
        return sorted(((float(np.abs(a - b).max())
                        / max(float(np.abs(b).max()), 1e-30), n)
                       for n, a, b in zip(params, got[1:], want[1:])),
                      reverse=True)
    loss_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    card_errs, spread = errs(card, cpu), errs(cpu1, cpu)
    print(f"  loss relative error {loss_err:.3e} (limit {CPU_LOSS_RTOL}); "
          f"largest @GRAD errors over each gradient's max |value| (limit "
          f"{CPU_GRAD_RTOL}): "
          + ", ".join(f"{n} {e:.3e}" for e, n in card_errs[:5])
          + f"; CPU {threads} threads against 1: "
          + ", ".join(f"{n} {e:.3e}" for e, n in spread[:3]), flush=True)
    if loss_err > CPU_LOSS_RTOL or card_errs[0][0] > CPU_GRAD_RTOL:
        raise AssertionError(f"the card's {model} step disagrees with the "
                             "CPU's")
    return {"loss_rel_err": loss_err, "grad_rel_err_max": card_errs[0][0],
            "cpu_spread_max": spread[0][0], "grads_compared": len(params)}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from paddle_tpu_torch.ops import _build, kernels as K
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"phase 1: card: {smi}", flush=True)

    t0 = time.perf_counter()
    paths = _build.build_all(k.source for k in K.KERNELS)
    print(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in _build.build_logs.items():
        kernel = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1][:90]
            if "Used" in line or "spill" in line:
                print(f"  {name} {kernel}: {line.strip()}")

    print("phase 3: kernels against their plain versions", flush=True)
    hmma = check_tensor_cores(paths)
    recs = {k.name: {} for k in K.KERNELS}
    check_paged_attention(recs["paged_attention"])
    check_flash_attention(recs["flash_attention_fwd"])
    check_layer_norm(recs["layer_norm_fwd"])
    check_flash_attention_bwd(recs["flash_attention_bwd"])
    check_layer_norm_bwd(recs["layer_norm_bwd"])
    check_softmax_xent(recs["softmax_xent_fwd"], recs["softmax_xent_bwd"])
    check_batch_norm_bwd(recs["batch_norm_bwd"])
    for kind in ("lstm", "gru"):
        check_recurrent(kind, recs[f"{kind}_fwd"], recs[f"{kind}_bwd"])

    print(f"phase 4: DecodeEngine, {FULL_WIDTH['n_layers']}-layer d768 LM, "
          "bf16", flush=True)
    serve_launches, e2e = serve()
    print(f"  end to end: {json.dumps(e2e)}", flush=True)

    print(f"phase 5: training {TRAIN_CONFIG} at batch {TRAIN_BATCH}, f32 "
          "(TF32 off), Adam, through transformer_lm_train_program + "
          "Executor.run", flush=True)
    train_launches, train_e2e, state = train()
    print(f"  end to end: {json.dumps(train_e2e)}", flush=True)

    print("phase 6: one full-width step at batch 1, card against CPU",
          flush=True)
    cpu_check = card_vs_cpu(state)
    print(f"  {json.dumps(cpu_check)}", flush=True)
    del state

    print(f"phase 7: ResNet-50 {RESNET_CONFIG} at batch {RESNET_BATCH}, "
          "program.amp, Momentum, through resnet_train_program + "
          "Executor.run", flush=True)
    resnet_launches, resnet_e2e, state = train_resnet()
    print(f"  end to end: {json.dumps(resnet_e2e)}", flush=True)

    print(f"phase 8: ResNet-50 in f32 at batch {RESNET_CPU_BATCH}, card "
          "against CPU", flush=True)
    resnet_cpu_check = resnet_card_vs_cpu(state)
    print(f"  {json.dumps(resnet_cpu_check)}", flush=True)
    del state

    seq = {}
    for phase, model, what in ((9, "lstm", f"stacked dynamic LSTM "
                                f"{LSTM_CONFIG} (bench.py bench_lstm)"),
                               (10, "gru", f"GRU classifier {GRU_CONFIG} "
                                "(tools/gru_bench.py)")):
        print(f"phase {phase}: {what} at batch {SEQ_BATCH}, T {SEQ_T}, "
              "program.amp, Adam, through Executor.run", flush=True)
        seq[model] = train_sequence(model)
        print(f"  end to end: {json.dumps(seq[model][1])}", flush=True)
    print(f"phase 11: one f32 step of each at batch {SEQ_CPU_BATCH}, ragged "
          "lengths, card against CPU", flush=True)
    for model in ("lstm", "gru"):
        check = seq_card_vs_cpu(model, seq[model][2])
        print(f"  {model}: {json.dumps(check)}", flush=True)

    kernels = []
    for k in K.KERNELS:
        r = recs[k.name]
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/csrc/{k.source}.cu",
            "replaces": k.replaces,
            "launches": (serve_launches[k.name] + train_launches[k.name]
                         + resnet_launches[k.name]
                         + seq["lstm"][0][k.name] + seq["gru"][0][k.name]),
            "launches_serving": serve_launches[k.name],
            "launches_training": (train_launches[k.name]
                                  + resnet_launches[k.name]
                                  + seq["lstm"][0][k.name]
                                  + seq["gru"][0][k.name]),
            "launches_resnet_training": resnet_launches[k.name],
            "launches_lstm_training": seq["lstm"][0][k.name],
            "launches_gru_training": seq["gru"][0][k.name],
            "max_abs_err": r["max_abs_err"],
            "limit_share": r["limit_share"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r.get("device_ms"),
            "library_device_ms": r.get("library_device_ms"),
            "shape": r["shape"],
            **({"bound_cuda_core_ms": r["bound_cuda_core_ms"]}
               if "bound_cuda_core_ms" in r else {}),
            **({"hmma": hmma[k.source]} if k.source in hmma else {}),
            **({"bitwise_repeat": r["bitwise_repeat"]}
               if "bitwise_repeat" in r else {}),
            **({"training_shape": r["training"]} if "training" in r
               else {}),
            **({"f32_w": r["f32_w"]} if "f32_w" in r else {})})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
