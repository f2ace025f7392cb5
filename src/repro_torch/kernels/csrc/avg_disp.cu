// Fused worker average + Eq. 4 dispersion + broadcast on the (M, P) f32
// parameter plane.
//
// Replaces the TPU kernel repro/kernels/avg_disp.py::avg_disp
// (_avg_disp_kernel, avg_disp.py:38; pallas_call at :184) for groups >= 1
// (global mean, or the means of `groups` contiguous worker groups — the
// hierarchical schedule's inner event); the dispersion is always taken
// against the global mean. Two template flags cover what the TPU kernel
// leaves to its wrapper and its jnp twin:
//   - CODES: a (P,) f32 row of rounding codes (0 f32, 1 bf16, 2 f16); the
//     broadcast (group) mean goes through round_code, the dispersion stays
//     against the unrounded global mean (plane_average_ref's codes path,
//     the reference's engine.py:596-600);
//   - MASKED: the fault-degraded event (the wrapper's `alive` branch,
//     avg_disp.py:170-175), the alive rows a 64-bit row word by value.
//     Only alive rows are read; the (group) mean of a group's alive rows,
//     summed in row order and divided once, is written IN PLACE to those
//     rows only (a group with no alive row is left alone); the dispersion
//     is over the alive rows, divided by their count. Dead rows are
//     neither read nor written.
// The unmasked instantiations write a new plane. x and out carry no
// __restrict__: the masked ones are called with out == x, and each thread
// reads its column whole before it writes it.
//
// Bound on an H100 (3.35 TB/s): memory. The pass reads the plane once and
// writes the output plane once, 2 * M * P * 4 bytes: 11.58 GB at M = 4,
// P = 361,821,120 (3.46 ms); the codes row adds P * 4 (13.03 GB, 3.89 ms).
// Masked, with one dead row of four, it moves 3 rows each way: 8.68 GB
// (2.59 ms), 10.13 GB coded (3.02 ms). At the paper's least-squares shape
// (M = 24, P = 1024) a pass is 196,608 B (0.06 us): launch latency rules.
//
// Design: the same column sweep as opt_step.cu without the update — one
// thread per column, the M values in registers (compile-time bound MAXM)
// for the mean, the dispersion term and the broadcast, so each byte is
// read once; coalesced row accesses; masked ragged tail; 64-bit offsets;
// per-block dispersion partials summed by a fixed second pass (no
// atomics, bitwise reproducible). An unmasked pass is the masked one over
// every row (kAllRows folds the row tests away). With one group the
// broadcast value is the dispersion's own mean (one sum, one division a
// column). Built with -fmad=false.
#include "plane_common.cuh"

namespace {

template <int MAXM, bool MASKED, bool CODES>
__global__ void __launch_bounds__(kPlaneThreads)
avg_disp_cols(const float* x, float* out, const float* __restrict__ codes,
              float* __restrict__ dpart, int m, int64_t p, int groups,
              unsigned long long alive, float n_alive) {
  const unsigned long long rows = MASKED ? alive : kAllRows;
  const float n_rows = MASKED ? n_alive : static_cast<float>(m);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kPlaneThreads +
                    threadIdx.x;
  float dsq = 0.0f;
  if (j < p) {
    const float code = CODES ? codes[j] : 0.0f;
    float u[MAXM];
    load_column(x, m, p, j, u, rows);
    const float mean = masked_column_mean_dsq(u, m, rows, n_rows, &dsq);
    if (groups == 1) {
      // the one group's mean is the dispersion's: the same sum and count
      const float v = round_code(mean, code);
#pragma unroll
      for (int i = 0; i < MAXM; ++i)
        if (i < m && row_on(rows, i))
          out[static_cast<int64_t>(i) * p + j] = v;
    } else {
      write_masked_means(u, m, m / groups, rows, code, out, p, j);
    }
  }
  block_partial(dsq, dpart);
}

}  // namespace

// C entry point, bound with ctypes: out = broadcast (group) mean of x,
// rounded through `codes` (null: none), disp = Eq. 4 dispersion; dpart is
// ceil(P / 256) floats of scratch. masked != 0 runs the fault-degraded
// event over the rows set in `alive` (bit i is row i), in place: out must
// be x. Returns cudaGetLastError() after both launches (0 = success).
extern "C" int avg_disp_launch(const float* x, float* out,
                               const float* codes, float* dpart, float* disp,
                               int m, long long p, int groups, int masked,
                               unsigned long long alive, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float rows = masked ? static_cast<float>(__builtin_popcountll(alive))
                            : static_cast<float>(m);
  const int64_t nblocks = (p + kPlaneThreads - 1) / kPlaneThreads;
  const dim3 grid(static_cast<unsigned>(nblocks));
  dispatch_m(m, [&](auto t) {
    dispatch_flags(masked != 0, codes != nullptr, [&](auto mk, auto cd) {
      avg_disp_cols<decltype(t)::value, decltype(mk)::value,
                    decltype(cd)::value><<<grid, kPlaneThreads, 0, st>>>(
          x, out, codes, dpart, m, p, groups, alive, rows);
    });
  });
  sum_partials<<<1, kSumThreads, 0, st>>>(dpart, nblocks, rows, disp);
  return static_cast<int>(cudaGetLastError());
}
