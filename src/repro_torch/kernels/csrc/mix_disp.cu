// Gossip mixing event + Eq. 4 dispersion on the (M, P) f32 parameter
// plane: out = W @ x for a doubly-stochastic (M, M) W — each worker keeps
// its own mixed row, no broadcast — and the dispersion of the input
// (pre-mix) plane.
//
// Replaces the TPU kernel repro/kernels/avg_disp.py::mix_disp
// (_mix_disp_kernel, avg_disp.py:51; pallas_call at :229) without the
// `alive` (fault-masked) variant, and without rounding codes, as on the
// TPU: planes with codes take the plain version in the engine.
//
// Bound on an H100 (3.35 TB/s): memory. The pass reads the plane once and
// writes the output plane once, 2 * M * P * 4 bytes (W is M * M * 4):
// 11.58 GB at M = 4, P = 361,821,120 (3.46 ms). It does 2 M + 4 flops per
// element (12 at M = 4), far below the 295 flop/byte ridge.
//
// Design against that bound: the column sweep of avg_disp.cu. One thread
// owns one column and holds its M values in registers (compile-time bound
// MAXM); the block stages W (at most 64 x 64 f32, 16 KB) in shared memory
// once; each thread writes out_i = sum_j W_ij x_j, j in order from 0 with
// no FMA contraction (-fmad=false), for i = 0 .. M-1 — the plain version's
// loop, so the two agree bitwise. Every thread of a warp reads the same W
// entry (a shared-memory broadcast) and neighbouring threads touch
// neighbouring columns (coalesced rows). Masked ragged tail, 64-bit
// offsets, per-block dispersion partials summed by a fixed second pass
// (no atomics, bitwise reproducible).
#include "plane_common.cuh"

namespace {

template <int MAXM>
__global__ void __launch_bounds__(kPlaneThreads)
mix_disp_cols(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, float* __restrict__ dpart, int m,
              int64_t p) {
  __shared__ float sw[MAXM * MAXM];
  stage_matrix(w, m, sw);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kPlaneThreads +
                    threadIdx.x;
  float dsq = 0.0f;
  if (j < p) {
    float u[MAXM];
    load_column(x, m, p, j, u);
    column_mean_dsq(u, m, &dsq);
#pragma unroll 1
    for (int i = 0; i < m; ++i)
      out[static_cast<int64_t>(i) * p + j] = mix_row(u, sw, m, i);
  }
  block_partial(dsq, dpart);
}

}  // namespace

// C entry point, bound with ctypes: out = W @ x (w row-major (m, m)),
// disp = Eq. 4 dispersion of x; dpart is ceil(P / 256) floats of scratch.
// Returns cudaGetLastError() after both launches (0 = success).
extern "C" int mix_disp_launch(const float* x, const float* w, float* out,
                               float* dpart, float* disp, int m,
                               long long p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nblocks = (p + kPlaneThreads - 1) / kPlaneThreads;
  const dim3 grid(static_cast<unsigned>(nblocks));
  dispatch_m(m, [&](auto t) {
    mix_disp_cols<decltype(t)::value><<<grid, kPlaneThreads, 0, st>>>(
        x, w, out, dpart, m, p);
  });
  sum_partials<<<1, kSumThreads, 0, st>>>(dpart, nblocks,
                                           static_cast<float>(m), disp);
  return static_cast<int>(cudaGetLastError());
}
