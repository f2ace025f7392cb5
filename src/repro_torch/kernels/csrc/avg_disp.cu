// Fused worker average + Eq. 4 dispersion + broadcast on the (M, P) f32
// parameter plane.
//
// Replaces the TPU kernel repro/kernels/avg_disp.py::avg_disp
// (_avg_disp_kernel, avg_disp.py:38; pallas_call at :184) for groups >= 1
// (global mean, or the means of `groups` contiguous worker groups — the
// hierarchical schedule's inner event); the dispersion is always taken
// against the global mean. The `alive` (fault-masked) variant is not part
// of this kernel.
//
// Bound on an H100 (3.35 TB/s): memory. The pass reads the plane once and
// writes the output plane once, 2 * M * P * 4 bytes: 11.58 GB at M = 4,
// P = 361,821,120 (3.46 ms); at the paper's least-squares shape
// (M = 24, P = 1024) it is 196,608 B (0.06 us), where launch latency
// rules instead.
//
// Design: the same column sweep as opt_step.cu without the update — one
// thread per column, the M values in registers (compile-time bound MAXM)
// for the mean, the dispersion term and the broadcast, so each byte is
// read once; coalesced row accesses; masked ragged tail; 64-bit offsets;
// per-block dispersion partials summed by a fixed second pass (no
// atomics, bitwise reproducible). Built with -fmad=false.
#include "plane_common.cuh"

namespace {

template <int MAXM>
__global__ void __launch_bounds__(kPlaneThreads)
avg_disp_cols(const float* __restrict__ x, float* __restrict__ out,
              float* __restrict__ dpart, int m, int64_t p, int groups) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kPlaneThreads +
                    threadIdx.x;
  float dsq = 0.0f;
  if (j < p) {
    float u[MAXM];
    load_column(x, m, p, j, u);
    const float mean = column_mean_dsq(u, m, &dsq);
    if (groups == 1) {
#pragma unroll
      for (int i = 0; i < MAXM; ++i)
        if (i < m) out[static_cast<int64_t>(i) * p + j] = mean;
    } else {
      const int gs = m / groups;
      for (int k = 0; k < groups; ++k) {
        const int lo = k * gs, hi = lo + gs;
        float gsum = 0.0f;
#pragma unroll
        for (int i = 0; i < MAXM; ++i)
          if (i >= lo && i < hi) gsum += u[i];
        const float gmean = gsum / static_cast<float>(gs);
#pragma unroll
        for (int i = 0; i < MAXM; ++i)
          if (i >= lo && i < hi) out[static_cast<int64_t>(i) * p + j] = gmean;
      }
    }
  }
  block_partial(dsq, dpart);
}

}  // namespace

// C entry point, bound with ctypes: out = broadcast (group) mean of x,
// disp = Eq. 4 dispersion; dpart is ceil(P / 256) floats of scratch.
// Returns cudaGetLastError() after both launches (0 = success).
extern "C" int avg_disp_launch(const float* x, float* out, float* dpart,
                               float* disp, int m, long long p, int groups,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nblocks = (p + kPlaneThreads - 1) / kPlaneThreads;
  const dim3 grid(static_cast<unsigned>(nblocks));
  dispatch_m(m, [&](auto t) {
    avg_disp_cols<decltype(t)::value><<<grid, kPlaneThreads, 0, st>>>(
        x, out, dpart, m, p, groups);
  });
  sum_partials<<<1, kSumThreads, 0, st>>>(dpart, nblocks,
                                           static_cast<float>(m), disp);
  return static_cast<int>(cudaGetLastError());
}
