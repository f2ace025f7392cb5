// Gossip mixing event + Eq. 4 dispersion on the (M, P) f32 parameter
// plane: out = W @ x for a doubly-stochastic (M, M) W — each worker keeps
// its own mixed row, no broadcast — and the dispersion of the input
// (pre-mix) plane.
//
// Replaces the TPU kernel repro/kernels/avg_disp.py::mix_disp
// (_mix_disp_kernel, avg_disp.py:51; pallas_call at :229). Two template
// flags cover what the TPU kernel leaves to its wrapper and its jnp twin:
//   - CODES: a (P,) f32 row of rounding codes (0 f32, 1 bf16, 2 f16);
//     each mixed row goes through round_code, as mix_disp_ref rounds;
//   - MASKED: the fault-degraded event (the wrapper's `alive` branch,
//     avg_disp.py:215-220), the alive rows a 64-bit row word by value and
//     W the degraded matrix (faults.degraded_matrix). Only alive rows are
//     read; each alive row is written IN PLACE with masked_mix_row over
//     the alive columns (bitwise the plain version's full sum, see
//     plane_common.cuh); the dispersion is the pre-mix one over the alive
//     rows. Dead rows are neither read nor written.
// The unmasked instantiations write a new plane. x and out carry no
// __restrict__: the masked ones are called with out == x, and each thread
// reads its column whole before it writes it.
//
// Bound on an H100 (3.35 TB/s): memory. The pass reads the plane once and
// writes the output plane once, 2 * M * P * 4 bytes (W is M * M * 4):
// 11.58 GB at M = 4, P = 361,821,120 (3.46 ms); the codes row adds P * 4
// (13.03 GB, 3.89 ms); masked with one dead row of four, 3 rows each way,
// 8.68 GB (2.59 ms), 10.13 GB coded (3.02 ms). It does 2 M + 4 flops per
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
// (no atomics, bitwise reproducible). An unmasked pass is the masked one
// over every row (kAllRows folds the row tests away).
#include "plane_common.cuh"

namespace {

template <int MAXM, bool MASKED, bool CODES>
__global__ void __launch_bounds__(kPlaneThreads)
mix_disp_cols(const float* x, const float* __restrict__ w, float* out,
              const float* __restrict__ codes, float* __restrict__ dpart,
              int m, int64_t p, unsigned long long alive, float n_alive) {
  __shared__ float sw[MAXM * MAXM];
  stage_matrix(w, m, sw);
  const unsigned long long rows = MASKED ? alive : kAllRows;
  const float n_rows = MASKED ? n_alive : static_cast<float>(m);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kPlaneThreads +
                    threadIdx.x;
  float dsq = 0.0f;
  if (j < p) {
    const float code = CODES ? codes[j] : 0.0f;
    float u[MAXM];
    load_column(x, m, p, j, u, rows);
    masked_column_mean_dsq(u, m, rows, n_rows, &dsq);
#pragma unroll 1
    for (int i = 0; i < m; ++i)
      if (row_on(rows, i))
        out[static_cast<int64_t>(i) * p + j] =
            round_code(masked_mix_row(u, sw, m, i, rows), code);
  }
  block_partial(dsq, dpart);
}

}  // namespace

// C entry point, bound with ctypes: out = W @ x (w row-major (m, m)),
// rounded through `codes` (null: none), disp = Eq. 4 dispersion of x;
// dpart is ceil(P / 256) floats of scratch. masked != 0 mixes the rows set
// in `alive` (bit i is row i) with the degraded W, in place: out must be
// x. Returns cudaGetLastError() after both launches (0 = success).
extern "C" int mix_disp_launch(const float* x, const float* w, float* out,
                               const float* codes, float* dpart, float* disp,
                               int m, long long p, int masked,
                               unsigned long long alive, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float rows = masked ? static_cast<float>(__builtin_popcountll(alive))
                            : static_cast<float>(m);
  const int64_t nblocks = (p + kPlaneThreads - 1) / kPlaneThreads;
  const dim3 grid(static_cast<unsigned>(nblocks));
  dispatch_m(m, [&](auto t) {
    dispatch_flags(masked != 0, codes != nullptr, [&](auto mk, auto cd) {
      mix_disp_cols<decltype(t)::value, decltype(mk)::value,
                    decltype(cd)::value><<<grid, kPlaneThreads, 0, st>>>(
          x, w, out, codes, dpart, m, p, alive, rows);
    });
  });
  sum_partials<<<1, kSumThreads, 0, st>>>(dpart, nblocks, rows, disp);
  return static_cast<int>(cudaGetLastError());
}
