#!/usr/bin/env python3
"""Measurement builds of the port's LSTM backward kernel on one NVIDIA GPU.

    python3 recurrent_builds.py

Each build is a copy of paddle_tpu_torch/ops/csrc under
build/recurrent_builds/<build>/ with edits to lstm.cu, compiled with the
port's nvcc flags (every build at once).  The LSTM backward of each build
is called through the port's wrapper (`kernels.lstm_bwd`, its C entry
swapped for the build's) at chip_smoke.py's main shape, T80 B32 H512,
with bf16 w (program.amp) and with f32 w, and timed by device time per
call (torch.profiler), two rounds in opposite order.  The builds:

- shipped: the sources as they are;
- no_products: the backward without its products (the gates recompute,
  dh_prev's and dw's products are skipped);
- no_sync: the backward without its grid-wide barrier;
- no_dw: the backward without its dw product.

Every build but `shipped` computes wrong results by design: it is only
timed against the shipped build, and its time splits the step between
products, barrier and the rest.  The edits find their targets by exact
text, and the script raises when a kernel change moves them.  Each known
version of lstm.cu has its own set of edits (`EDITS`); the set whose
targets are all present is taken, so a checkout of an older version of
the port with this script copied into it measures that version.

Prints the ptxas report of each build's LSTM kernels and, as its last
line, one JSON object of the times.  Nothing here is on a main path of
the port: the kernels ship as `shipped`.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ZERO_ACC = "      for (auto& row : acc) for (float& v : row) v = 0.f;\n"


def _cut(start, end):
    """Remove the text from ``start`` up to (not including) ``end``."""
    def edit(src):
        for t in (start, end):
            if src.count(t) != 1:
                raise ValueError(f"edit target found {src.count(t)} times: "
                                 f"{t!r}")
        i, j = src.index(start), src.index(end)
        return src[:i] + src[j:]
    return edit


def _replace(old, new):
    def edit(src):
        if src.count(old) != 1:
            raise ValueError(f"edit target found {src.count(old)} times: "
                             f"{old!r}")
        return src.replace(old, new)
    return edit


#: version of lstm.cu -> build -> edits of lstm.cu
EDITS = {
    # the persistent kernel of PR 4: gates, dw and dh_prev inside the
    # serial loop, on the CUDA cores
    "pr4": {
        "no_products": [
            _replace("      warp_rows_dot<W, R, G, false>(hp, H, b0, B, H, "
                     "wc_s, acc);\n", ZERO_ACC),
            _replace("      warp_rows_dot<W, RD, HB, true>(dxt, H4, b0, B, "
                     "4 * H, wr_s, acc);\n", ZERO_ACC),
            _cut("    // 3. dw of the units' columns",
                 "    // every block's dgates of step t are in dxs\n")],
        "no_sync": [_replace("    grid.sync();\n    // 4. dh_prev",
                             "    // 4. dh_prev")],
        "no_dw": [_cut("    // 3. dw of the units' columns",
                       "    // every block's dgates of step t are in dxs\n")],
    },
    # the redesign: gates and dw as products before and after the
    # recurrence; in the recurrence each block's share of dh_prev (on the
    # tensor cores for a bf16 w) goes through an exchange
    "pr7": {
        "no_products": [
            _replace("  launch_gemm<W, false>(", "  if (0) launch_gemm<W, false>("),
            _replace("  launch_gemm<W, true>(", "  if (0) launch_gemm<W, true>("),
            _replace("    partial_dh<W, HB>(", "    if (0) partial_dh<W, HB>(")],
        "no_sync": [_replace("    grid.sync();  // step barrier\n", "")],
        "no_dw": [_replace("  launch_gemm<W, true>(", "  if (0) launch_gemm<W, true>(")],
    },
}
BUILDS = ("shipped", "no_products", "no_sync", "no_dw")
T, B, H = 80, 32, 512


def _version(src):
    """The EDITS version whose every edit applies to ``src``."""
    for version, builds in EDITS.items():
        try:
            for edits in builds.values():
                for edit in edits:
                    edit(src)
        except ValueError:
            continue
        return version
    raise ValueError("no known version of lstm.cu: every EDITS set misses a "
                     "target")


def build_all():
    """Copy, edit and compile every build at once; returns (version,
    {build: (library path, ptxas report)})."""
    from paddle_tpu_torch.ops import _build
    with open(os.path.join(_build.CSRC, "lstm.cu")) as f:
        version = _version(f.read())
    root = os.path.join(HERE, "build", "recurrent_builds")
    procs = {}
    for name in BUILDS:
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        path = os.path.join(d, "lstm.cu")
        with open(path) as f:
            src = f.read()
        for edit in EDITS[version].get(name, []):
            src = edit(src)
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(d, "liblstm.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    out = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        out[name] = (lib, log)
    return version, out


def _ptxas(log):
    """[(kernel, 'N registers, ...')] of the LSTM backward kernels in one
    nvcc report."""
    rows, kernel = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "Used" in line and "registers" in line and kernel:
            if "lstm_bwd" in kernel:
                rows.append((kernel[:90], line.split("info    :")[-1].strip()))
            kernel = None
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("recurrent_builds: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import _device_ms, _recurrent_inputs
    from paddle_tpu_torch.ops import kernels as K
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    version, libs = build_all()
    report = {"card": smi, "version": version, "ptxas": {}, "device_ms": {}}
    for name, (_, log) in libs.items():
        for kernel, regs in _ptxas(log):
            print(f"  {name} {kernel}: {regs}", flush=True)
            report["ptxas"][f"{name} {kernel}"] = regs
    fns = {}
    for name, (lib, _) in libs.items():
        fn = getattr(ctypes.CDLL(lib), K.LSTM_BWD.entry)
        fn.argtypes, fn.restype = K.LSTM_BWD.argtypes, ctypes.c_int
        fns[name] = fn
    g = torch.Generator(device="cpu").manual_seed(18)
    xs, w32, h0, c0, mask, dhs, dcs = _recurrent_inputs(4, T, B, H, "full",
                                                        False, g)
    shipped_fn = K.LSTM_BWD._fn
    try:
        for wdt in (torch.bfloat16, torch.float32):
            w = w32.to(wdt)
            hs, cs = K.lstm_fwd_plain(xs, w, h0, c0, mask)
            args = (xs, w, h0, c0, mask, hs, cs, dhs, dcs)
            label = f"T{T} B{B} H{H} w {str(wdt)[6:]}"
            rec = {n: [] for n in BUILDS}
            for order in (BUILDS, BUILDS[::-1]):
                for n in order:
                    K.LSTM_BWD._fn = fns[n]
                    _, names = _device_ms(lambda: K.lstm_bwd(*args))
                    rec[n].append(sum(t for k, t in names.items()
                                      if "lstm" in k))
            for n in BUILDS:
                print(f"  {label} {n}: device ms of the LSTM kernels "
                      f"{rec[n]}", flush=True)
            report["device_ms"][label] = rec
    finally:
        K.LSTM_BWD._fn = shipped_fn
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
