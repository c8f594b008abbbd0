#!/usr/bin/env python3
"""Time the port's kernels of one checkout at the main paths' shapes, to
compare two versions on one card:

    python3 kernel_ab.py ROOT LABEL

builds ROOT's flash, paged-attention, LSTM and GRU sources (one nvcc a
source, all started together, each source's wall seconds printed), prints
their ptxas lines for the f32 flash codes at head dim 64 and the
recurrent kernels, then the device ms per call (torch.profiler, kernel
time summed over 20 calls after 3 warm-ups) of: the flash forward at
B16 H12 T512 and B1 H12 T1000 and the backward at B16 H12 T512, head dim
64, causal, f32 and bf16; paged attention at S16 H12 D64 L16 P128; the
LSTM and GRU forward and backward at T80 B32 H512 with f32 and bf16 w,
and the LSTM's at H1024 with an f32 w (8 units a block).
One JSON line, prefixed by LABEL.  Unpack the other version under
build/ (git archive) and run both in one call in turns (parent, change,
change, parent): a card's readings spread between calls.
"""
import json
import os
import subprocess
import sys
import time

SOURCES = ("flash_attention", "flash_attention_bwd", "paged_attention",
           "lstm", "gru")


def build(_build, label):
    """Compile every source at once, as _build.build_all does, timing
    each; then load them through _build (which finds them built)."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs, secs = {}, {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = _build._lib_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
               str(_build.CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter())
    logs = {}
    for name, (proc, start) in procs.items():
        logs[name] = proc.communicate()[0]
        secs[name] = time.perf_counter() - start
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{logs[name]}")
    print(f"{label} build s {time.perf_counter() - t0:.1f}, by source "
          f"{json.dumps({k: round(v, 1) for k, v in secs.items()})}",
          flush=True)
    for name, log in logs.items():
        kern = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kern = line.split("'")[1][:80]
            if ("Used" in line or "spill" in line) and (
                    "IfLi64" in kern or "lstm_" in kern or "gru_" in kern):
                print(f"  {label} {name} {kern}: {line.strip()}")


def device_ms(fn, iters=20):
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(r.device_time_total for r in prof.key_averages()
               if r.device_type == torch.autograd.DeviceType.CUDA
               ) / 1e3 / iters


def main(root, label):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    from paddle_tpu_torch.ops import _build, kernels as K
    if not K.__file__.startswith(root):
        raise RuntimeError(f"imported {K.__file__}, not {root}'s port")
    torch.backends.cuda.matmul.allow_tf32 = False
    build(_build, label)
    g = torch.Generator(device="cpu").manual_seed(5)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        for b, t in ((16, 512), (1, 1000)):
            q, k, v, do = (torch.randn(b, 12, t, 64, generator=g).to(
                "cuda", dt) for _ in range(4))
            o, lse = K.flash_attention_fwd(q, k, v, True)
            out[f"flash_fwd B{b} T{t} {dt}"] = device_ms(
                lambda: K.flash_attention_fwd(q, k, v, True))
            if b == 16:
                out[f"flash_bwd B{b} T{t} {dt}"] = device_ms(
                    lambda: K.flash_attention_bwd(q, k, v, o, lse, do, True))
    S, H, D, L, P = 16, 12, 64, 16, 128
    index = torch.randint(0, P * L, (S,), generator=g).to(torch.int32)
    table = torch.randperm(S * P, generator=g).to(torch.int32).reshape(S, P)
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn(S, H, 1, D, generator=g).to("cuda", dt)
        pk, pv = (torch.randn(S * P, L, H, D, generator=g).to("cuda", dt)
                  for _ in range(2))
        ti, tt = index.cuda(), table.cuda()
        out[f"paged S16 H12 D64 {dt}"] = device_ms(
            lambda: K.paged_attention(q, pk, pv, tt, ti))
    for kind, h, dts in (("lstm", 512, (torch.float32, torch.bfloat16)),
                         ("gru", 512, (torch.float32, torch.bfloat16)),
                         ("lstm", 1024, (torch.float32,))):
        gates = 4 if kind == "lstm" else 3
        for dt in dts:
            xs = 0.5 * torch.randn(80, 32, gates * h, generator=g)
            w = (torch.randn(h, gates * h, generator=g) / h ** 0.5).to(dt)
            h0, c0 = (0.5 * torch.randn(32, h, generator=g) for _ in range(2))
            dhs, dcs = (torch.randn(80, 32, h, generator=g) for _ in range(2))
            xs, w, h0, c0, dhs, dcs = (x.cuda() for x in (xs, w, h0, c0, dhs,
                                                          dcs))
            mask = torch.ones(80, 32, 1, device="cuda")
            if kind == "lstm":
                hs, cs = K.lstm_fwd(xs, w, h0, c0, mask)
                fwd = lambda: K.lstm_fwd(xs, w, h0, c0, mask)
                bwd = lambda: K.lstm_bwd(xs, w, h0, c0, mask, hs, cs, dhs,
                                         dcs)
            else:
                hs = K.gru_fwd(xs, w, h0, mask)
                fwd = lambda: K.gru_fwd(xs, w, h0, mask)
                bwd = lambda: K.gru_bwd(xs, w, h0, mask, hs, dhs)
            out[f"{kind}_fwd H{h} w {dt}"] = device_ms(fwd)
            out[f"{kind}_bwd H{h} w {dt}"] = device_ms(bwd)
    print(label, json.dumps(out), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    main(sys.argv[1], sys.argv[2])
