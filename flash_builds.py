#!/usr/bin/env python3
"""Measurement builds of the port's flash attention kernels on one NVIDIA GPU.

    python3 flash_builds.py

Each build is a copy of paddle_tpu_torch/ops/csrc under
build/flash_builds/<build>/ with one edit, compiled with the port's nvcc
flags (every build at once).  The flash entry points of each build are
called at chip_smoke.py's timed flash shapes and timed by device time per
call (torch.profiler, as in chip_smoke.py's phase 3), two rounds in
opposite order; every build that still computes attention is first held
to the plain version (its share of F32_TOL).  The builds:

- shipped: the sources as they are;
- products_only: the forward without its mask and online softmax, the
  raw scores fed straight into P.V (wrong results): its time against the
  shipped forward's splits the kernel between products and softmax;
- cvt_rna: the tf32 split by the literal PTX cvt.rna.tf32.f32 for the
  high and the low part, against the kernels' integer rounding;
- uncapped: the forward without its register cap (f32, head_dim 64:
  three blocks an SM at 168 registers), ptxas choosing the count.

Prints the ptxas report of each build's flash kernels and, as its last
line, one JSON object of the shares and times.  Nothing here is on a main
path of the port: the kernels ship as `shipped`.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

FWD_SOFTMAX_START = "      if (k0 + kRows > Tk ||"
FWD_PV = "      ptt::fa::gemm_pn<T, kRows, D, true>(o, s, Vt, LD);"
SPLIT_TF32 = ("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
              "  lo = __float_as_uint(x - __uint_as_float(hi));\n")
SPLIT_CVT_RNA = (
    '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));\n'
    '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo)\n'
    '      : "f"(x - __uint_as_float(hi)));\n')
CAPPED = "__launch_bounds__(kThreads, sizeof(T) == 4 && D == 64 ? 3 : 1)"


def _cut_softmax(src):
    start, end = src.index(FWD_SOFTMAX_START), src.index(FWD_PV)
    return src[:start] + src[end:]


def _replace(old, new):
    def edit(src):
        if src.count(old) != 1:
            raise ValueError(f"edit target found {src.count(old)} times: "
                             f"{old!r}")
        return src.replace(old, new)
    return edit


#: build -> (file edited, edit, sources compiled)
BUILDS = {
    "shipped": (None, None, ("flash_attention", "flash_attention_bwd")),
    "products_only": ("flash_attention.cu", _cut_softmax,
                      ("flash_attention",)),
    "cvt_rna": ("flash_mma.cuh", _replace(SPLIT_TF32, SPLIT_CVT_RNA),
                ("flash_attention", "flash_attention_bwd")),
    "uncapped": ("flash_attention.cu",
                 _replace(CAPPED, "__launch_bounds__(kThreads)"),
                 ("flash_attention",)),
}
#: timed shapes (chip_smoke.py's): name -> (entry, batch, T, dtype, builds)
SHAPES = {
    "fwd B1 H12 T1000 D64 causal bf16": (
        "fwd", 1, 1000, "bfloat16", ("shipped", "products_only")),
    "fwd B16 H12 T512 D64 causal f32": (
        "fwd", 16, 512, "float32",
        ("shipped", "products_only", "cvt_rna", "uncapped")),
    "bwd B16 H12 T512 D64 causal f32": (
        "bwd", 16, 512, "float32", ("shipped", "cvt_rna")),
}
H, D = 12, 64


def build_all():
    """Copy, edit and compile every build at once; returns
    {(build, source): (library path, ptxas report)}."""
    from paddle_tpu_torch.ops import _build
    root = os.path.join(HERE, "build", "flash_builds")
    procs = {}
    for name, (target, edit, sources) in BUILDS.items():
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        if edit is not None:
            path = os.path.join(d, target)
            with open(path) as f:
                src = edit(f.read())
            with open(path, "w") as f:
                f.write(src)
        for s in sources:
            lib = os.path.join(d, f"lib{s}.so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                   os.path.join(d, f"{s}.cu")]
            procs[(name, s)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    out = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {key} failed:\n{log}")
        out[key] = (lib, log)
    return out


def _ptxas(log):
    """[(kernel, 'N registers, S B spill stores, L B spill loads')] of the
    flash kernels in one nvcc report."""
    rows, kernel, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "spill stores" in line and kernel:
            spill = line.split("bytes stack frame,")[-1].strip()
        elif "Used" in line and "registers" in line and kernel:
            regs = line.split("Used")[1].split("registers")[0].strip()
            if "flash" in kernel:
                rows.append((kernel, f"{regs} registers, {spill}"))
            kernel = None
    filt = shutil.which("c++filt")
    if filt and rows:
        names = subprocess.run([filt], input="\n".join(k for k, _ in rows),
                               capture_output=True, text=True).stdout
        rows = [(re.search(r"flash_\w+(<[^>]*>)?", n).group(0), r)
                for n, (_, r) in zip(names.splitlines(), rows)]
    return rows


def _entry(lib, which):
    from paddle_tpu_torch.ops import kernels as K
    kern = K.FLASH_ATTENTION_FWD if which == "fwd" else K.FLASH_ATTENTION_BWD
    fn = getattr(ctypes.CDLL(lib), kern.entry)
    fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
    return fn


def _call(fn, which, t):
    """One launch of a build's entry point on the tensors ``t``; raises on
    a launch error."""
    import torch
    q = t["q"]
    bh, tq, d = q.shape[0] * q.shape[1], q.shape[2], q.shape[3]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    bf = int(q.dtype == torch.bfloat16)
    if which == "fwd":
        args = [t[n].data_ptr() for n in ("q", "k", "v", "out", "lse")]
    else:
        args = [t[n].data_ptr() for n in ("q", "k", "v", "o", "do", "lse",
                                          "delta", "dq", "dk", "dv")]
    rc = fn(*args, bh, tq, tq, d, 1, 1.0 / math.sqrt(d), bf, stream)
    if rc != 0:
        raise RuntimeError(f"flash {which} launch failed: CUDA error {rc}")


def _tensors(which, b, t, dtype):
    import torch
    from paddle_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cpu").manual_seed(12)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(b, H, t, D, generator=g).to("cuda", dt)
                   for _ in range(4))
    ts = {"q": q, "k": k, "v": v, "out": torch.empty_like(q),
          "lse": torch.empty(b, H, t, device="cuda")}
    if which == "bwd":
        o, lse = K.flash_attention_fwd(q, k, v, True)
        ts.update(o=o, lse=lse, do=do, delta=torch.empty_like(lse),
                  dq=torch.empty_like(q), dk=torch.empty_like(k),
                  dv=torch.empty_like(v))
    return ts


def _share(which, ts):
    """Largest share of F32_TOL of the outputs in ``ts`` against the plain
    version."""
    from chip_smoke import _err
    from paddle_tpu_torch.ops import kernels as K
    if which == "fwd":
        got = (ts["out"], ts["lse"])
        want = K.flash_attention_fwd_plain(ts["q"], ts["k"], ts["v"], True)
    else:
        got = (ts["dq"], ts["dk"], ts["dv"])
        want = K.flash_attention_bwd_plain(ts["q"], ts["k"], ts["v"],
                                           ts["o"], ts["lse"], ts["do"], True)
    return max(_err(o, r, "f32")[1] for o, r in zip(got, want))


def main():
    import torch
    if not torch.cuda.is_available():
        print("flash_builds: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import _device_ms
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    libs = build_all()
    report = {"card": smi, "ptxas": {}, "shapes": {}}
    for (name, src), (_, log) in sorted(libs.items()):
        for kernel, regs in _ptxas(log):
            print(f"  {name} {kernel}: {regs}", flush=True)
            report["ptxas"][f"{name} {kernel}"] = regs
    for label, (which, b, t, dtype, builds) in SHAPES.items():
        ts = _tensors(which, b, t, dtype)
        src = "flash_attention" if which == "fwd" else "flash_attention_bwd"
        fns = {n: _entry(libs[(n, src)][0], which) for n in builds}
        rec = {n: {"device_ms": []} for n in builds}
        for n in builds:
            _call(fns[n], which, ts)
            torch.cuda.synchronize()
            if dtype == "float32" and n != "products_only":
                rec[n]["f32_tol_share"] = _share(which, ts)
        for order in (builds, builds[::-1]):
            for n in order:
                ms, _ = _device_ms(lambda: _call(fns[n], which, ts))
                rec[n]["device_ms"].append(ms)
        for n in builds:
            print(f"  {label} {n}: {rec[n]}", flush=True)
        report["shapes"][label] = rec
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
