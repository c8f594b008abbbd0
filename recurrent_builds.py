#!/usr/bin/env python3
"""Measurement builds of the port's recurrent kernels on one NVIDIA GPU.

    python3 recurrent_builds.py

Each build is a copy of paddle_tpu_torch/ops/csrc under
build/recurrent_builds/<build>/ with edits to one kernel's source,
compiled with the port's nvcc flags (every build at once).  The kernel of
each build is called through the port's wrapper (its C entry swapped for
the build's) at chip_smoke.py's main shape, T80 B32 H512, and timed by
device time per call (torch.profiler, every kernel of the call but
PyTorch's own), two rounds in opposite order.  The LSTM kernels run with
bf16 w (program.amp) and f32 w, the GRU kernels with f32 w (their main
path) and bf16 w.  The builds, by kernel:

- shipped: the sources as they are (lstm.cu and gru.cu);
- LSTM backward (lstm.cu):
  - lstm_bwd-no_products: without its products (the gates recompute,
    dh_prev's and dw's products are skipped);
  - lstm_bwd-no_sync: without its grid-wide barrier;
  - lstm_bwd-no_dw: without its dw product;
- LSTM forward (lstm.cu):
  - lstm_fwd-fwd_no_product: the step product skipped;
  - lstm_fwd-fwd_no_sync: the grid-wide barrier removed;
  - lstm_fwd-fwd_no_load: h_prev not read (a constant, or what the
    staging buffer holds, used instead);
  - lstm_fwd-fwd_f32_cuda_cores (pr8 only): the f32 w's step product on the
    CUDA cores (an FMA chain a value over the warp's k-range) instead of
    3xTF32 on the tensor cores: the same function by another route, so
    its outputs are held to the plain version's;
- GRU forward (gru.cu, pr8 and later):
  - gru_fwd-fwd_no_product: both step products skipped (in pr8 with
    their h_prev and r * h_prev reads, which the products make);
  - gru_fwd-fwd_no_sync: both grid-wide barriers removed;
  - gru_fwd-fwd_no_load: h_prev and r * h_prev not read (a constant, or
    what the staging buffer holds, used instead);
- GRU backward (gru.cu):
  - gru_bwd-no_recompute: the r, z and c products skipped;
  - gru_bwd-no_dw: both dw products (or loops) skipped;
  - gru_bwd-no_sync: the grid-wide barriers removed.

Every build but `shipped` and those in `EXACT` computes wrong results by
design: it is only timed against the shipped build, and its time splits
the call between products, loads, barriers and the rest.  A build in
`EXACT` computes the kernel's function another way; its outputs are held
to the plain version's (F32_TOL, or one bf16 step of the largest value
for a bf16 w, as chip_smoke.py holds the kernel) and printed.  The edits find their targets by
exact text, and the script raises when a kernel change moves them.  Each
known version of the sources has its own set of edits (`EDITS`: pr4, the
first persistent kernels; pr7, the LSTM backward with its products
outside the loop; pr8, the staged LSTM forward and the three-stage GRU
backward; pr9, the staged GRU forward, its staging and product shared
with the LSTM forward in recurrent.cuh); the set whose targets are all
present is taken, so a checkout of an older
version of the port with this script copied into it measures that
version.

Prints the ptxas report of each build's edited kernels and, as its last
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


def _swap(start, end, new):
    """Replace the text from ``start`` up to (not including) ``end`` with
    ``new``."""
    def edit(src):
        return _cut(start, end)(src).replace(end, new + end, 1)
    return edit


def _replace(old, new):
    def edit(src):
        if src.count(old) != 1:
            raise ValueError(f"edit target found {src.count(old)} times: "
                             f"{old!r}")
        return src.replace(old, new)
    return edit


# --- the edits, by kernel and version: build -> [(file, edit)] ---------
#
# pr4's LSTM backward: gates, dw and dh_prev inside the serial loop, on
# the CUDA cores
LSTM_BWD_PR4 = {
    "no_products": [
        ("lstm.cu", _replace("      warp_rows_dot<W, R, G, false>(hp, H, b0, "
                             "B, H, wc_s, acc);\n", ZERO_ACC)),
        ("lstm.cu", _replace("      warp_rows_dot<W, RD, HB, true>(dxt, H4, "
                             "b0, B, 4 * H, wr_s, acc);\n", ZERO_ACC)),
        ("lstm.cu", _cut("    // 3. dw of the units' columns",
                         "    // every block's dgates of step t are in "
                         "dxs\n"))],
    "no_sync": [("lstm.cu", _replace("    grid.sync();\n    // 4. dh_prev",
                                     "    // 4. dh_prev"))],
    "no_dw": [("lstm.cu", _cut("    // 3. dw of the units' columns",
                               "    // every block's dgates of step t are "
                               "in dxs\n"))],
}
# pr7's LSTM backward: gates and dw as products around the recurrence,
# dh_prev's shares through an exchange
LSTM_BWD_PR7 = {
    "no_products": [
        ("lstm.cu", _replace("  launch_gemm<W, false>(",
                             "  if (0) launch_gemm<W, false>(")),
        ("lstm.cu", _replace("  launch_gemm<W, true>(",
                             "  if (0) launch_gemm<W, true>(")),
        ("lstm.cu", _replace("    partial_dh<W, HB>(",
                             "    if (0) partial_dh<W, HB>("))],
    "no_sync": [("lstm.cu", _replace("    grid.sync();  // step barrier\n",
                                     ""))],
    "no_dw": [("lstm.cu", _replace("  launch_gemm<W, true>(",
                                   "  if (0) launch_gemm<W, true>("))],
}
# pr8's LSTM backward: the same design, the products and the exchange
# moved into shared headers
LSTM_BWD_PR8 = {
    "no_products": [
        ("lstm.cu", _replace("  launch_gemm<W, false>(",
                             "  if (0) launch_gemm<W, false>(")),
        ("lstm.cu", _replace("  launch_gemm<W, true>(",
                             "  if (0) launch_gemm<W, true>(")),
        ("lstm.cu", _replace("    exchange_share<W, HB, KO>(",
                             "    if (0) exchange_share<W, HB, KO>("))],
    "no_sync": [("lstm.cu", _replace("    grid.sync();  // step barrier\n",
                                     ""))],
    "no_dw": [("lstm.cu", _replace("  launch_gemm<W, true>(",
                                   "  if (0) launch_gemm<W, true>("))],
}
# pr4's LSTM forward: each warp reads h_prev from L2 4 bytes a lane and
# reduces its dot products with shuffles
LSTM_FWD_PR4 = {
    "fwd_no_product": [
        ("lstm.cu", _replace("      warp_rows_dot<W, R, G, true>(hp, H, b0, "
                             "B, H, w_s, acc);\n", ZERO_ACC))],
    "fwd_no_sync": [
        ("lstm.cu", _replace("    grid.sync();\n  }\n}\n\n// --- backward",
                             "  }\n}\n\n// --- backward"))],
    "fwd_no_load": [
        ("recurrent.cuh", _replace("        x = kL2 ? __ldcg(p) : *p;\n",
                                   "        x = kL2 ? 0.5f : *p;\n"))],
}
# the f32 step product of pr8's LSTM forward on the CUDA cores: lane (g, t)
# takes the values of the tensor cores' layout (rows g and g + 8, columns
# 2t and 2t + 1 of each n-block), 4 k at a time from 16-byte reads, one FMA
# chain a value over the warp's k-range
FWD_F32_FMA = """\
      for (int k = k0; k < k1; k += 4) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(h_s + (m0 + g) * ldk + k);
        const float4 a1 =
            *reinterpret_cast<const float4*>(h_s + (m0 + g + 8) * ldk + k);
#pragma unroll
        for (int nb = 0; nb < NP / 8; ++nb) {
          const float4 w0 = *reinterpret_cast<const float4*>(
              w_s + (nb * 8 + 2 * t) * ldk + k);
          const float4 w1 = *reinterpret_cast<const float4*>(
              w_s + (nb * 8 + 2 * t + 1) * ldk + k);
          const float4 av[2] = {a0, a1}, wv[2] = {w0, w1};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 x = av[e >> 1], y = wv[e & 1];
            float v = acc[nb][e];
            v = fmaf(x.x, y.x, v);
            v = fmaf(x.y, y.y, v);
            v = fmaf(x.z, y.z, v);
            acc[nb][e] = fmaf(x.w, y.w, v);
          }
        }
      }
    }
"""
# pr8's LSTM forward: h_prev staged by 16-byte cp.async, the step product
# K-split over the warps (bf16 mma.sync, 3xTF32 for f32)
LSTM_FWD_PR8 = {
    "fwd_no_product": [
        ("lstm.cu", _replace("      fwd_step_product<W, HB>(",
                             "      if (0) fwd_step_product<W, HB>("))],
    "fwd_no_sync": [
        ("lstm.cu", _replace("    grid.sync();  // forward step barrier\n",
                             ""))],
    "fwd_no_load": [
        ("lstm.cu", _replace("      stage_h<W>(",
                             "      if (0) stage_h<W>("))],
    "fwd_f32_cuda_cores": [
        ("lstm.cu", _swap("      // m16n8k8 fragments read element by "
                          "element",
                          "    // (row g / g + 8, columns 2t, 2t + 1) of "
                          "each n-block", FWD_F32_FMA))],
}
# pr4's GRU backward: r, z, c recomputed and dw accumulated inside the
# serial loop, three barriers a step
GRU_BWD_PR4 = {
    "no_recompute": [
        ("gru.cu", _replace("      warp_rows_dot<W, R2, RZ, false>(hp, H, b0, "
                            "B, H, wc_s, acc);\n", ZERO_ACC)),
        ("gru.cu", _replace("      warp_rows_dot<W, R1, HB, true>(rh, H, b0, "
                            "B, H, wc_s + RZ * H, acc);\n", ZERO_ACC))],
    "no_dw": [
        ("gru.cu", _cut("    // 4. dw of the units' c columns",
                        "    // every block's dc_in of step t is in dxs\n")),
        ("gru.cu", _cut("    // 6. dw of the units' r and z columns",
                        "    // every block's dr_in and dz_in of step t "
                        "are in dxs\n"))],
    "no_sync": [
        ("gru.cu", _replace("    grid.sync();\n    // 2. c of the units",
                            "    // 2. c of the units")),
        ("gru.cu", _replace("    grid.sync();\n    // 5. drh",
                            "    // 5. drh")),
        ("gru.cu", _replace("    grid.sync();\n    // 7. dh_prev",
                            "    // 7. dh_prev"))],
}
# pr8's GRU backward: gates and dw as products around the recurrence,
# two exchanges and two barriers a step
GRU_BWD_PR8 = {
    "no_recompute": [
        ("gru.cu", _replace("  launch_gemm<W, false>(hprev",
                            "  if (0) launch_gemm<W, false>(hprev")),
        ("gru.cu", _replace("  launch_gemm<W, false>(rh",
                            "  if (0) launch_gemm<W, false>(rh"))],
    "no_dw": [
        ("gru.cu", _replace("  launch_gemm<W, true>(hprev",
                            "  if (0) launch_gemm<W, true>(hprev")),
        ("gru.cu", _replace("  launch_gemm<W, true>(rh",
                            "  if (0) launch_gemm<W, true>(rh"))],
    "no_sync": [
        ("gru.cu", _replace("    grid.sync();  // barrier 1\n", "")),
        ("gru.cu", _replace("    grid.sync();  // barrier 2\n", ""))],
}

# pr4's GRU forward (unchanged through pr8): each warp reads h_prev and
# the rh scratch from L2 4 bytes a lane and reduces its dot products with
# shuffles; the block re-reads its own units' h_prev from L2 twice a step
GRU_FWD_PR4 = {
    "fwd_no_product": [
        ("gru.cu", _replace("      warp_rows_dot<W, R2, RZ, true>(hp, H, b0, "
                            "B, H, w_s, acc);\n", ZERO_ACC)),
        ("gru.cu", _replace("      warp_rows_dot<W, R1, HB, true>(rh, H, b0, "
                            "B, H, w_s + RZ * H, acc);\n", ZERO_ACC))],
    "fwd_no_sync": [
        ("gru.cu", _replace("    // every unit's r * h_prev is in the "
                            "scratch\n    grid.sync();\n", "")),
        ("gru.cu", _replace("    grid.sync();\n  }\n}\n\n// --- backward",
                            "  }\n}\n\n// --- backward"))],
    "fwd_no_load": [
        ("recurrent.cuh", _replace("        x = kL2 ? __ldcg(p) : *p;\n",
                                   "        x = kL2 ? 0.5f : *p;\n")),
        ("gru.cu", _replace("rz_s[b * RZ + u] * __ldcg(hp + at);",
                            "rz_s[b * RZ + u] * 0.5f;")),
        ("gru.cu", _replace("      const float h_prev = __ldcg(hp + at);",
                            "      const float h_prev = 0.5f;"))],
}

# pr9's LSTM forward: pr8's design, its staging and step product moved
# into recurrent.cuh (shared with the GRU forward), each warp staging its
# own k-range, two m-tiles a warp at once
LSTM_FWD_PR9 = {
    "fwd_no_product": [
        ("lstm.cu", _replace("      step_product<W, NP>(",
                             "      if (0) step_product<W, NP>("))],
    "fwd_no_sync": LSTM_FWD_PR8["fwd_no_sync"],
    "fwd_no_load": LSTM_FWD_PR8["fwd_no_load"],
}
# pr9's GRU forward: both step products staged (h_prev, then r * h_prev)
# and K-split over the warps on the tensor cores, two barriers a step
GRU_FWD_PR9 = {
    "fwd_no_product": [
        ("gru.cu", _replace("      step_product<W, NPR>(",
                            "      if (0) step_product<W, NPR>(")),
        ("gru.cu", _replace("      step_product<W, NPC>(",
                            "      if (0) step_product<W, NPC>("))],
    "fwd_no_sync": [
        ("gru.cu", _replace("    grid.sync();  // forward barrier 1",
                            "    // forward barrier 1")),
        ("gru.cu", _replace("    grid.sync();  // forward barrier 2",
                            "    // forward barrier 2"))],
    "fwd_no_load": [
        ("gru.cu", _replace("      stage_h<W>(h_s, ldk, hf, hb,",
                            "      if (0) stage_h<W>(h_s, ldk, hf, hb,")),
        ("gru.cu", _replace("      stage_h<W>(h_s, ldk, rhf, rh16,",
                            "      if (0) stage_h<W>(h_s, ldk, rhf, rh16,"))],
}

#: version of the sources -> kernel -> build -> [(file, edit)]
EDITS = {
    "pr4": {"lstm_bwd": LSTM_BWD_PR4, "lstm_fwd": LSTM_FWD_PR4,
            "gru_bwd": GRU_BWD_PR4},
    "pr7": {"lstm_bwd": LSTM_BWD_PR7, "lstm_fwd": LSTM_FWD_PR4,
            "gru_bwd": GRU_BWD_PR4},
    "pr8": {"lstm_bwd": LSTM_BWD_PR8, "lstm_fwd": LSTM_FWD_PR8,
            "gru_bwd": GRU_BWD_PR8, "gru_fwd": GRU_FWD_PR4},
    "pr9": {"lstm_bwd": LSTM_BWD_PR8, "lstm_fwd": LSTM_FWD_PR9,
            "gru_bwd": GRU_BWD_PR8, "gru_fwd": GRU_FWD_PR9},
}
#: builds that compute the kernel's function by another route: their
#: outputs are held to the plain version's
EXACT = {"lstm_fwd-fwd_f32_cuda_cores"}
#: the source each kernel's builds compile
SOURCE = {"lstm_bwd": "lstm", "lstm_fwd": "lstm", "gru_bwd": "gru",
          "gru_fwd": "gru"}
T, B, H = 80, 32, 512


def _version(read):
    """The EDITS version whose every edit applies to the sources
    (``read(file)`` gives a file's text)."""
    for version, kernels in EDITS.items():
        try:
            for builds in kernels.values():
                for edits in builds.values():
                    for name, edit in edits:
                        edit(read(name))
        except ValueError:
            continue
        return version
    raise ValueError("no known version of lstm.cu and gru.cu: every EDITS "
                     "set misses a target")


def _builds(version):
    """[(build name, source to compile, [(file, edit)])], shipped first."""
    out = [("shipped", src, []) for src in ("lstm", "gru")]
    for kernel, builds in EDITS[version].items():
        for name, edits in builds.items():
            out.append((f"{kernel}-{name}", SOURCE[kernel], edits))
    return out


def build_all():
    """Copy, edit and compile every build at once; returns (version,
    {(build, source): (library path, ptxas report)})."""
    from paddle_tpu_torch.ops import _build

    def read(name):
        with open(os.path.join(_build.CSRC, name)) as f:
            return f.read()
    version = _version(read)
    root = os.path.join(HERE, "build", "recurrent_builds")
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name, source, edits in _builds(version):
        d = os.path.join(root, name)
        if not os.path.isdir(d):
            shutil.copytree(_build.CSRC, d)
        for fname, edit in edits:
            path = os.path.join(d, fname)
            with open(path) as f:
                src = f.read()
            with open(path, "w") as f:
                f.write(edit(src))
        lib = os.path.join(d, f"lib{source}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
               os.path.join(d, f"{source}.cu")]
        procs[(name, source)] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {key} failed:\n{log}")
        out[key] = (lib, log)
    return version, out


def _ptxas(log, build):
    """[(kernel, 'N registers, ...')] of the kernels an edited build
    changes (every recurrent kernel of the shipped build) in one nvcc
    report."""
    keys = {"lstm_fwd": ("lstm_fwd",), "lstm_bwd": ("lstm_bwd", "rnn_"),
            "gru_bwd": ("gru_bwd", "gru_gates", "rnn_"),
            "gru_fwd": ("gru_fwd",)}.get(
                build.split("-")[0], ("lstm", "gru", "rnn_"))
    rows, kernel = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "Used" in line and "registers" in line and kernel:
            if any(k in kernel for k in keys):
                rows.append((kernel[:90], line.split("info    :")[-1].strip()))
            kernel = None
    return rows


def _recurrent_ms(names):
    """Device ms of the recurrent kernels among a call's kernels (every
    kernel of the port's sources, none of PyTorch's own)."""
    return sum(t for k, t in names.items()
               if any(s in k for s in ("lstm", "gru", "rnn_")))


def main():
    import torch
    if not torch.cuda.is_available():
        print("recurrent_builds: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import _device_ms, _err, _recurrent_inputs
    from paddle_tpu_torch.ops import kernels as K
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    version, libs = build_all()
    print(f"version of the sources: {version}", flush=True)
    report = {"card": smi, "version": version, "ptxas": {}, "device_ms": {}}
    for (name, source), (_, log) in libs.items():
        for kernel, regs in _ptxas(log, name):
            print(f"  {name} {kernel}: {regs}", flush=True)
            report["ptxas"][f"{name} {kernel}"] = regs
    wrapped = {k: w for k, w in (("lstm_bwd", K.LSTM_BWD),
                                  ("lstm_fwd", K.LSTM_FWD),
                                  ("gru_bwd", K.GRU_BWD),
                                  ("gru_fwd", K.GRU_FWD))
               if k in EDITS[version]}
    shipped = {k: w._fn for k, w in wrapped.items()}
    g = torch.Generator(device="cpu").manual_seed(18)
    try:
        for kernel, wrapper in wrapped.items():
            src = SOURCE[kernel]
            fns = {}
            for (name, source), (lib, _) in libs.items():
                if source == src and (name == "shipped"
                                      or name.startswith(kernel + "-")):
                    fn = getattr(ctypes.CDLL(lib), wrapper.entry)
                    fn.argtypes, fn.restype = wrapper.argtypes, ctypes.c_int
                    fns[name] = fn
            builds = tuple(fns)
            lstm = kernel.startswith("lstm")
            xs, w32, h0, c0, mask, dhs, dcs = _recurrent_inputs(
                4 if lstm else 3, T, B, H, "full", False, g)
            for wdt in ((torch.bfloat16, torch.float32) if lstm
                        else (torch.float32, torch.bfloat16)):
                w = w32.to(wdt)
                if kernel == "lstm_fwd":
                    args = (xs, w, h0, c0, mask)
                elif kernel == "lstm_bwd":
                    hs, cs = K.lstm_fwd_plain(xs, w, h0, c0, mask)
                    args = (xs, w, h0, c0, mask, hs, cs, dhs, dcs)
                elif kernel == "gru_fwd":
                    args = (xs, w, h0, mask)
                else:
                    hs = K.gru_fwd_plain(xs, w, h0, mask)
                    args = (xs, w, h0, mask, hs, dhs)

                def call(fn=getattr(K, kernel), a=args):
                    return fn(*a)
                label = f"{kernel} T{T} B{B} H{H} w {str(wdt)[6:]}"
                rec = {n: [] for n in builds}
                for order in (builds, builds[::-1]):
                    for n in order:
                        wrapper._fn = fns[n]
                        _, names = _device_ms(call)
                        rec[n].append(_recurrent_ms(names))
                for n in builds:
                    print(f"  {label} {n}: device ms of the recurrent "
                          f"kernels {rec[n]}", flush=True)
                report["device_ms"][label] = rec
                for n in (n for n in builds if n in EXACT):
                    wrapper._fn = fns[n]
                    pairs = list(zip(call(), getattr(K, kernel + "_plain")(
                        *args)))
                    errs = [_err(o, r, "bf16_max" if wdt is torch.bfloat16
                                 else None) for o, r in pairs]
                    err = max(e for e, _ in errs)
                    share = max(x for _, x in errs)
                    print(f"  {label} {n}: max_abs_err {err:.3e} against "
                          f"the plain version, {share:.3f} of the "
                          "tolerance", flush=True)
                    report.setdefault("exact", {})[f"{label} {n}"] = [
                        err, share]
                    if share > 1.0:
                        raise AssertionError(f"{label} {n} disagrees with "
                                             "the plain version")
                wrapper._fn = shipped[kernel]
    finally:
        for kernel, wrapper in wrapped.items():
            wrapper._fn = shipped[kernel]
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
