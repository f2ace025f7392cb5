// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, h_0 = 0, over the
// sequence axis of (B, S, W) float32 planes.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py::rglru_scan
// (_rglru_kernel, rglru_scan.py:26; pallas_call at :65), which steps the
// recurrence sequentially over rows with the state of a channel block in
// VMEM, padding the sequence with identity steps (a = 1, b = 0). Here no
// padding is needed: each thread stops at S.
//
// Bound on an H100 (3.35 TB/s): memory. a and b are read once and h
// written once, 12 bytes per element: 377 MB at recurrentgemma-2b's
// prefill (B 4, S 3072, W 2560), 0.113 ms. What limits this kernel is
// latency instead: one thread per (batch, channel) walks its S steps in
// order, and B * W = 10,240 threads are about 78 per SM, too few to keep
// the memory busy by numbers. The design answers with depth: each thread
// issues the loads of the next 16 steps before it runs the dependent
// multiply-adds of the current 16, and blocks of 32 threads spread the
// channels over every SM.
//
// Rounding: each step is a float32 multiply and then an add, each rounded
// on its own (__fmul_rn / __fadd_rn, never contracted into an FMA; the
// build also passes -fmad=false) — the arithmetic of the sequential plain
// version, so the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kAhead = 16;  // steps whose loads are in flight per thread

__global__ void __launch_bounds__(kThreads)
rglru_scan_cols(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, int s, int w, int64_t nch) {
  const int64_t ch = static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x;
  if (ch >= nch) return;
  const int64_t base = (ch / w) * static_cast<int64_t>(s) * w + ch % w;
  const float* pa = a + base;
  const float* pb = b + base;
  float* po = out + base;

  float ca[kAhead], cb[kAhead], na[kAhead], nb[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (i < s) {
      ca[i] = pa[static_cast<int64_t>(i) * w];
      cb[i] = pb[static_cast<int64_t>(i) * w];
    }
  }
  float h = 0.0f;
  for (int t0 = 0; t0 < s; t0 += kAhead) {
    const int t1 = t0 + kAhead;
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (t1 + i < s) {
        na[i] = pa[static_cast<int64_t>(t1 + i) * w];
        nb[i] = pb[static_cast<int64_t>(t1 + i) * w];
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (t0 + i < s) {
        h = __fadd_rn(__fmul_rn(ca[i], h), cb[i]);
        po[static_cast<int64_t>(t0 + i) * w] = h;
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      ca[i] = na[i];
      cb[i] = nb[i];
    }
  }
}

}  // namespace

// C entry point, bound with ctypes: out = the scan of (a, b), all three
// contiguous (bsz, s, w) float32. Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int rglru_scan_launch(const float* a, const float* b, float* out,
                                 int bsz, int s, int w, void* stream) {
  const int64_t nch = static_cast<int64_t>(bsz) * w;
  const int64_t nblocks = (nch + kThreads - 1) / kThreads;
  rglru_scan_cols<<<static_cast<unsigned>(nblocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, b, out, s, w,
                                                         nch);
  return static_cast<int>(cudaGetLastError());
}
