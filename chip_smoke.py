#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the serving path from ops/csrc (one nvcc
   per source, all started together) and print the build seconds and
   ptxas report;
3. hold each kernel against its plain PyTorch version at the main path's
   shapes, in f32 and bf16, and time kernel, plain version and a PyTorch
   library yardstick with CUDA events;
4. serve the full-width transformer LM (vocab 32000, 12 layers, d_model
   768, 12 heads, d_ff 3072; seeded random weights saved as a model
   directory and loaded through DecodeEngine.from_model_dir) in bf16
   with 16 slots: 32 concurrent requests with prompts of 8..1024 tokens
   and 64 new tokens each.  Kernel launch counts are zeroed just before
   and read just after; every kernel must have launched.  Two streams are
   recomputed through greedy_decode_full and their logits compared;
5. a JSON line with every ported kernel's launches, error and times;
6. the last line: {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet): memory rate and dense op rates
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
#: stated tolerances of kernel vs plain version.  Every kernel accumulates
#: in f32 and rounds its output once, as the plain version does.
#: An f32 output (any f32 output, the lse and the LN statistics of bf16
#: inputs included): max abs error <= F32_TOL * max(1, max |plain|), the
#: same f32 math summed in another order.  A bf16 output, per element:
#: |kernel - plain| <= BF16_REL * |plain| + BF16_FLOOR, i.e. one bf16
#: rounding step (2^-7 relative at most) apart, plus a floor for the f32
#: reordering error of values near 0 (f32 errors measured at <= 3e-6).
F32_TOL = 2e-5
BF16_REL, BF16_FLOOR = 2.0 ** -7, 1e-4
#: engine logits against the full-prefix recompute after 12 bf16 layers:
#: max abs error over max(1, max |logit|)
E2E_TOL = 2e-2
FULL_WIDTH = dict(vocab=32000, max_len=2048, n_layers=12, d_model=768,
                  n_heads=12, d_ff=3072, eos_id=None)


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


def _err(out, ref):
    """(max abs error of ``out`` against ``ref``, its share of the stated
    tolerance for ``ref``'s dtype); equal infinities count as no error."""
    import torch
    a, b = out.float(), ref.float()
    both_inf = torch.isinf(a) & torch.isinf(b) & (torch.sign(a)
                                                  == torch.sign(b))
    d = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
    mag = torch.where(torch.isinf(b), torch.zeros_like(b), b.abs())
    if ref.dtype == torch.bfloat16:
        share = (d / (BF16_REL * mag + BF16_FLOOR)).max()
    else:
        share = d.max() / (F32_TOL * max(1.0, float(mag.max())))
    return float(d.max()), float(share)


def _check(name, pairs, dtype, label):
    """Fail unless every (kernel output, plain output) pair is within the
    tolerance of its dtype; return the largest abs error."""
    errs = [_err(o, r) for o, r in pairs]
    err = max(e for e, _ in errs)
    share = max(s for _, s in errs)
    ok = share <= 1.0
    print(f"  {name} {label} {dtype}: max_abs_err {err:.3e}, "
          f"{share:.3f} of the tolerance {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name} {label} {dtype} disagrees with its "
                             f"plain version: {share:.3f} of the tolerance")
    return err


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
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        q = torch.randn(S, H, 1, D, generator=g).to(dev, dtype)
        pk = torch.randn(N, L, H, D, generator=g).to(dev, dtype)
        pv = torch.randn(N, L, H, D, generator=g).to(dev, dtype)
        out = K.paged_attention(q, pk, pv, table, index)
        ref = K.paged_attention_plain(q, pk, pv, table, index)
        torch.cuda.synchronize()
        err = _check("paged_attention", [(out, ref)], dn,
                     f"S{S} H{H} D{D} L{L} P{P}")
        worst = max(worst, err)
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
    rec["max_abs_err"] = worst


def check_flash_attention(rec):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    H, D = 12, 64
    g = torch.Generator(device="cpu").manual_seed(12)
    dev = torch.device("cuda")
    cases = [(t, t, True) for t in (7, 128, 1000, 2048)]
    cases += [(100, 1000, True), (100, 1000, False)]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        for tq, tk, causal in cases:
            q = torch.randn(1, H, tq, D, generator=g).to(dev, dtype)
            k = torch.randn(1, H, tk, D, generator=g).to(dev, dtype)
            v = torch.randn(1, H, tk, D, generator=g).to(dev, dtype)
            out, lse = K.flash_attention_fwd(q, k, v, causal)
            ref, ref_lse = K.flash_attention_fwd_plain(q, k, v, causal)
            torch.cuda.synchronize()
            err = _check("flash_attention_fwd",
                         [(out, ref), (lse, ref_lse)], dn,
                         f"tq{tq} tk{tk} causal={causal}")
            worst = max(worst, err)
            if dtype is torch.bfloat16 and (tq, tk, causal) == (1000, 1000,
                                                               True):
                pairs = tq * (tq + 1) // 2
                nbytes = 4 * tq * H * D * 2 + tq * H * 4
                ops = 4 * pairs * H * D
                rec["ms"] = _time_ms(
                    lambda: K.flash_attention_fwd(q, k, v, True))
                rec["plain_ms"] = _time_ms(
                    lambda: K.flash_attention_fwd_plain(q, k, v, True))
                rec["library_ms"] = _time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True))
                rec["bound_ms"], rec["bound_by"] = _bound(nbytes, ops, dn)
                rec["shape"] = f"B1 H{H} T{tq} D{D} causal bf16"
    rec["max_abs_err"] = worst


def check_layer_norm(rec):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cpu").manual_seed(13)
    dev = torch.device("cuda")
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        for r in (16, 2048):
            for f in (768, 3072, 1000):
                x = (3 * torch.randn(r, f, generator=g) + 1).to(dev, dtype)
                sc = (1 + 0.1 * torch.randn(f, generator=g)).to(dev)
                bi = (0.1 * torch.randn(f, generator=g)).to(dev)
                y, mean, var = K.layer_norm_fwd(x, sc, bi, 1e-5)
                ry, rmean, rvar = K.layer_norm_fwd_plain(x, sc, bi, 1e-5)
                torch.cuda.synchronize()
                err = _check("layer_norm_fwd",
                             [(y, ry), (mean, rmean), (var, rvar)], dn,
                             f"R{r} F{f}")
                worst = max(worst, err)
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
    rec["max_abs_err"] = worst


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
    print(f"  launches on the main path: {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
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
    _build.build_all(k.source for k in K.KERNELS)
    print(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("phase 3: kernels against their plain versions", flush=True)
    recs = {k.name: {} for k in K.KERNELS}
    check_paged_attention(recs["paged_attention"])
    check_flash_attention(recs["flash_attention_fwd"])
    check_layer_norm(recs["layer_norm_fwd"])

    print(f"phase 4: DecodeEngine, {FULL_WIDTH['n_layers']}-layer d768 LM, "
          "bf16", flush=True)
    launches, e2e = serve()
    print(f"  end to end: {json.dumps(e2e)}", flush=True)

    kernels = []
    for k in K.KERNELS:
        r = recs[k.name]
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/csrc/{k.source}.cu",
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
