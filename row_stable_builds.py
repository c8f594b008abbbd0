#!/usr/bin/env python3
"""Measurement builds of the row-stable product's small-M code on one
NVIDIA GPU.

    python3 row_stable_builds.py

Each build is a copy of paddle_tpu_torch/ops/csrc under
build/row_stable_builds/<build>/ with one edit to row_stable_mm.cu,
compiled with the port's nvcc flags (every build at once).  Each build's
entry point is called at the exact LM's decode products (M 4: QKV, FFN1,
FFN2, the head) at each strip width in STRIPS, with its weights read cold
(chip_smoke.py's rotation over copies that together pass three times the
L2), and timed by device time per call (torch.profiler, as in
chip_smoke.py's phase 3), two rounds in opposite order; every build that
still computes the product is first held bitwise to the plain version.
The builds:

- shipped: the sources as they are;
- no_products: the ring without the FMUL/FADD chain (wrong results): the
  copies' time alone;
- no_x: x never copied into the ring (wrong results): the time the
  blocks' reads of the same x cost in L2;
- stages_3 and stages_16: the ring with 3 or 16 stages instead of 8;
- bk_16: stages of 16 k-rows instead of 64;
- bulk_ring and bulk_ring_3: the ring filled by bulk copies through the
  TMA unit (one a row segment, completing on a stage's mbarrier) instead
  of 16-byte cp.async copies, with 8 and with 3 stages.

Prints the ptxas report of each build's small-M kernels and, as its last
line, one JSON object of the times.  Nothing here is on a main path of
the port: the kernel ships as `shipped`.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

STAGES = "constexpr int kSmallBK = 64, kStages = 8, kSmallMaxRows = 64;"
PRODUCTS_START = "    const float* xr = xs + (stage * MB + i0) * kXLd;\n"
PRODUCTS_END = "  ptt::fa::cp_async_wait<0>();"
X_LOAD_START = "    for (int q = tid; q < MB * (kSmallBK / 4); q += kT) {"
X_LOAD_END = "  };\n"
KERNEL_START = ("template <int MB, int BN>\n__global__ void __launch_bounds__"
                "(small_threads<MB, BN>())")
KERNEL_END = "template <int MB, int BN>\ncudaError_t launch_small("
#: the small-M kernel with its ring filled by bulk copies (cp.async.bulk,
#: the TMA unit's one-dimensional copy: one a row segment of w or of x,
#: a stage's completing on the stage's mbarrier) instead of 16-byte
#: cp.async copies
BULK_RING = r'''// The ring's copies are bulk copies (cp.async.bulk, the TMA unit's
// one-dimensional form): one a row segment, each stage's completing on
// the stage's mbarrier, which counts the stage's bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   ptt::fa::smem_u32(bar))
               : "memory");
}

// the issuing thread's arrival, with the bytes the stage's copies bring
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          ptt::fa::smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(ptt::fa::smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to this block's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(ptt::fa::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(ptt::fa::smem_u32(bar))
      : "memory");
}

template <int MB, int BN>
__global__ void __launch_bounds__(small_threads<MB, BN>())
    row_stable_mm_small_kernel(const float* __restrict__ x,
                               const float* __restrict__ w,
                               const float* __restrict__ bias,
                               float* __restrict__ out, int M, int N, int K) {
  constexpr int kT = small_threads<MB, BN>();
  constexpr int kRowStep = kT / BN;         // rows between a thread's sums
  constexpr int kSums = MB / kRowStep;      // elements a thread sums
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  float* xs = smem;                         // [kStages][MB][kXLd]
  float* ws = smem + kStages * MB * kXLd;   // [kStages][kSmallBK][BN]
  const int tid = threadIdx.x;
  const int c = tid % BN, i0 = tid / BN;
  const int n0 = blockIdx.x * BN;
  const int cols = min(BN, N - n0);         // a multiple of 4
  const int n_steps = (K + kSmallBK - 1) / kSmallBK;

  // warp 0 fills a stage: kn k-rows of the strip's columns and M rows of
  // kn values of x (kn < kSmallBK only in the last stage); what lies
  // past K, M or N is left as it is and never read into a written sum
  auto load = [&](int step) {
    const int stage = step % kStages, k0 = step * kSmallBK;
    const int kn = min(kSmallBK, K - k0);
    uint64_t* bar = &full[stage];
    if (tid == 0)
      mbar_expect_bytes(bar, static_cast<uint32_t>(kn) * (cols + M) * 4);
    __syncwarp();
    for (int r = tid; r < kn; r += 32)
      bulk_copy(ws + (stage * kSmallBK + r) * BN,
                w + static_cast<int64_t>(k0 + r) * N + n0, cols * 4, bar);
    for (int r = tid; r < M; r += 32)
      bulk_copy(xs + (stage * MB + r) * kXLd,
                x + static_cast<int64_t>(r) * K + k0, kn * 4, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < 32)
    for (int s = 0; s < kStages - 1 && s < n_steps; ++s) load(s);
  float acc[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) acc[j] = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    const int stage = step % kStages;
    mbar_wait(&full[stage], (step / kStages) & 1);
    // every thread is past the reads of the stage refilled next (read in
    // the previous step); the fence orders them before the copies' writes
    __syncthreads();
    if (tid < 32 && step + kStages - 1 < n_steps) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load(step + kStages - 1);
    }
    const int kn = min(kSmallBK, K - step * kSmallBK);
    const float* xr = xs + (stage * MB + i0) * kXLd;
    const float* wr = ws + stage * kSmallBK * BN + c;
#pragma unroll
    for (int kk = 0; kk < kSmallBK; kk += 4) {
      if (kk >= kn) break;
      float4 a[kSums];
#pragma unroll
      for (int j = 0; j < kSums; ++j)
        a[j] = *reinterpret_cast<const float4*>(xr + j * kRowStep * kXLd +
                                                kk);
      const float w0 = wr[(kk + 0) * BN], w1 = wr[(kk + 1) * BN];
      const float w2 = wr[(kk + 2) * BN], w3 = wr[(kk + 3) * BN];
#pragma unroll
      for (int j = 0; j < kSums; ++j) {
        acc[j] = __fadd_rn(acc[j], __fmul_rn(a[j].x, w0));
        acc[j] = __fadd_rn(acc[j], __fmul_rn(a[j].y, w1));
        acc[j] = __fadd_rn(acc[j], __fmul_rn(a[j].z, w2));
        acc[j] = __fadd_rn(acc[j], __fmul_rn(a[j].w, w3));
      }
    }
  }
  const int col = n0 + c;
  if (c >= cols) return;
  const float bv = bias != nullptr ? bias[col] : 0.f;
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
    const int row = i0 + j * kRowStep;
    if (row < M)
      out[static_cast<int64_t>(row) * N + col] =
          bias != nullptr ? __fadd_rn(acc[j], bv) : acc[j];
  }
}

'''


def _replace(old, new):
    def edit(src):
        if src.count(old) != 1:
            raise ValueError(f"edit target found {src.count(old)} times: "
                             f"{old!r}")
        return src.replace(old, new)
    return edit


def _cut(start, end, keep=""):
    """Cut from ``start`` up to (not including) the first ``end`` after
    it, leaving ``keep``."""
    def edit(src):
        if src.count(start) != 1:
            raise ValueError(f"edit target found {src.count(start)} times: "
                             f"{start!r}")
        a = src.index(start)
        b = src.index(end, a)
        return src[:a] + keep + src[b:]
    return edit


def _both(*edits):
    def edit(src):
        for e in edits:
            src = e(src)
        return src
    return edit


#: build -> edit of row_stable_mm.cu (None: as shipped), and whether it
#: still computes the product
BUILDS = {
    "shipped": (None, True),
    "no_products": (_cut(PRODUCTS_START, PRODUCTS_END,
                         "    acc[0] += ws[stage];\n  }\n"), False),
    "no_x": (_cut(X_LOAD_START, X_LOAD_END), False),
    "stages_3": (_replace(STAGES, STAGES.replace("kStages = 8",
                                                 "kStages = 3")), True),
    "stages_16": (_replace(STAGES, STAGES.replace("kStages = 8",
                                                  "kStages = 16")), True),
    "bk_16": (_replace(STAGES, STAGES.replace("kSmallBK = 64",
                                              "kSmallBK = 16")), True),
    "bulk_ring": (_cut(KERNEL_START, KERNEL_END, BULK_RING), True),
    "bulk_ring_3": (_both(_cut(KERNEL_START, KERNEL_END, BULK_RING),
                          _replace(STAGES, STAGES.replace("kStages = 8",
                                                          "kStages = 3"))),
                    True),
}
#: the decode products of chip_smoke.py's exact LM: label -> (K, N)
SHAPES = {"QKV": (768, 2304), "FFN1": (768, 3072), "FFN2": (3072, 768),
          "head": (768, 32000)}
M = 4
STRIPS = (8, 32)


def build_all():
    """Copy, edit and compile every build at once; returns
    {build: (library path, nvcc report)}."""
    from paddle_tpu_torch.ops import _build
    root = os.path.join(HERE, "build", "row_stable_builds")
    procs = {}
    for name, (edit, _) in BUILDS.items():
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        if edit is not None:
            path = os.path.join(d, "row_stable_mm.cu")
            with open(path) as f:
                src = edit(f.read())
            with open(path, "w") as f:
                f.write(src)
        lib = os.path.join(d, "librow_stable_mm.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
               os.path.join(d, "row_stable_mm.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    out = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        out[name] = (lib, log)
    return out


def _ptxas(log):
    """['<4, BN> N registers'] of the small-M kernels at M 4."""
    rows, kernel = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "Used" in line and "registers" in line and kernel:
            if "row_stable_mm_small_kernelILi4E" in kernel:
                bn = kernel.split("ILi4ELi")[1].split("E")[0]
                rows.append(f"<4, {bn}> {line.split('Used')[1].strip()}")
            kernel = None
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("row_stable_builds: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import _cold_weights, _device_ms
    from paddle_tpu_torch.ops import kernels as K
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    libs = build_all()
    report = {"card": smi, "ptxas": {}, "shapes": {}}
    fns = {}
    for name, (lib, log) in libs.items():
        report["ptxas"][name] = _ptxas(log)
        print(f"  {name}: {report['ptxas'][name]}", flush=True)
        fn = getattr(ctypes.CDLL(lib), K.ROW_STABLE_MM.entry)
        fn.argtypes, fn.restype = K.ROW_STABLE_MM.argtypes, ctypes.c_int
        fns[name] = fn
    g = torch.Generator(device="cpu").manual_seed(17)
    for label, (k, n) in SHAPES.items():
        x = torch.randn(M, k, generator=g).cuda()
        w = (torch.randn(k, n, generator=g) / k ** 0.5).cuda()
        b = (0.1 * torch.randn(n, generator=g)).cuda()
        out = torch.empty(M, n, device="cuda")
        ws, copies = _cold_weights(w)
        want = K.row_stable_mm_plain(x, w, b)

        def call(name, strip, wt):
            rc = fns[name](x.data_ptr(), wt.data_ptr(), b.data_ptr(),
                           out.data_ptr(), M, n, k, strip,
                           torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name} strip {strip}: CUDA error {rc}")

        for strip in STRIPS:
            rec = {}
            for name, (_, computes) in BUILDS.items():
                call(name, strip, w)
                torch.cuda.synchronize()
                rec[name] = {"device_ms": []}
                if computes:
                    rec[name]["differ"] = int((out != want).sum())
                    if rec[name]["differ"]:
                        raise AssertionError(f"{name} {label}: not bitwise "
                                             "the plain version")
            for order in (list(BUILDS), list(BUILDS)[::-1]):
                for name in order:
                    ms, _ = _device_ms(lambda: call(name, strip, next(ws)))
                    rec[name]["device_ms"].append(ms)
            key = f"{label} M{M} K{k} N{n} strip {strip} ({copies} w copies)"
            for name in BUILDS:
                print(f"  {key} {name}: {rec[name]}", flush=True)
            report["shapes"][key] = rec
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
