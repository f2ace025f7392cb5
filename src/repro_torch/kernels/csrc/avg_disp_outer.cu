// All-worker average + Eq. 4 dispersion + the outer optimizer's momentum
// step (DiLoCo-style, optionally Nesterov) + broadcast, on the (M, P) f32
// parameter plane:
//
//   avg = mean_i x_i;  g = prev - avg;  vel' = mu * vel + g;
//   step = nesterov ? mu * vel' + g : vel';  new = prev - lr * step;
//   out_i = new for every row i.
//
// Replaces the TPU kernel repro/kernels/avg_disp.py::avg_disp_outer
// (_avg_disp_outer_kernel, avg_disp.py:62; pallas_call at :270). The TPU
// kernel takes no rounding codes: the reference's engine sends planes
// with codes to its jnp twin (engine.py:595-600, 628-633). Here a CODES
// template flag takes that twin's function, avg_disp_outer_ref(codes=):
// a (P,) f32 row of rounding codes (0 f32, 1 bf16, 2 f16); the mean goes
// through round_code before g = prev - avg, the dispersion stays against
// the unrounded mean, and new goes through round_code before it is
// written and broadcast; vel' stays f32.
//
// Bound on an H100 (3.35 TB/s): memory. The pass reads the plane, prev and
// vel once and writes the output plane, new and vel' once:
// 2 * M * P * 4 + 4 * P * 4 bytes = 17.37 GB at M = 4, P = 361,821,120
// (5.18 ms); the codes row adds P * 4 (18.82 GB, 5.62 ms). About 10 flops
// per column — far below the ridge.
//
// Design: the column sweep of avg_disp.cu — one thread per column, the M
// values in registers (compile-time bound MAXM) for the mean and the
// dispersion term, then the (P,) momentum step on that column and the
// broadcast; each byte is read once, rows are coalesced, the ragged tail
// is masked, offsets are 64-bit, and the dispersion partials are summed by
// a fixed second pass (no atomics). Built with -fmad=false, so every step
// rounds as the plain version's separate PyTorch ops do.
#include "plane_common.cuh"

namespace {

template <int MAXM, bool CODES>
__global__ void __launch_bounds__(kPlaneThreads)
avg_disp_outer_cols(const float* __restrict__ x,
                    const float* __restrict__ prev,
                    const float* __restrict__ vel,
                    const float* __restrict__ codes, float* __restrict__ out,
                    float* __restrict__ new_avg, float* __restrict__ new_vel,
                    float* __restrict__ dpart, int m, int64_t p, float lr,
                    float momentum, int nesterov) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kPlaneThreads +
                    threadIdx.x;
  float dsq = 0.0f;
  if (j < p) {
    const float code = CODES ? codes[j] : 0.0f;
    float u[MAXM];
    load_column(x, m, p, j, u);
    // the dispersion is against the unrounded mean; g against the rounded
    const float avg = round_code(column_mean_dsq(u, m, &dsq), code);
    const float pa = prev[j];
    const float g = pa - avg;
    const float v = momentum * vel[j] + g;
    const float step = nesterov ? momentum * v + g : v;
    const float upd = round_code(pa - lr * step, code);
    new_avg[j] = upd;
    new_vel[j] = v;
#pragma unroll
    for (int i = 0; i < MAXM; ++i)
      if (i < m) out[static_cast<int64_t>(i) * p + j] = upd;
  }
  block_partial(dsq, dpart);
}

}  // namespace

// C entry point, bound with ctypes: out = broadcast outer-updated mean,
// new_avg / new_vel = the (P,) outer state after the step, the mean and
// new rounded through `codes` (null: none), disp = Eq. 4 dispersion of x;
// dpart is ceil(P / 256) floats of scratch. Returns cudaGetLastError()
// after both launches (0 = success).
extern "C" int avg_disp_outer_launch(const float* x, const float* prev,
                                     const float* vel, const float* codes,
                                     float* out,
                                     float* new_avg, float* new_vel,
                                     float* dpart, float* disp, int m,
                                     long long p, float lr, float momentum,
                                     int nesterov, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nblocks = (p + kPlaneThreads - 1) / kPlaneThreads;
  const dim3 grid(static_cast<unsigned>(nblocks));
  dispatch_m(m, [&](auto t) {
    constexpr int kM = decltype(t)::value;
    if (codes != nullptr)
      avg_disp_outer_cols<kM, true><<<grid, kPlaneThreads, 0, st>>>(
          x, prev, vel, codes, out, new_avg, new_vel, dpart, m, p, lr,
          momentum, nesterov);
    else
      avg_disp_outer_cols<kM, false><<<grid, kPlaneThreads, 0, st>>>(
          x, prev, vel, codes, out, new_avg, new_vel, dpart, m, p, lr,
          momentum, nesterov);
  });
  sum_partials<<<1, kSumThreads, 0, st>>>(dpart, nblocks,
                                           static_cast<float>(m), disp);
  return static_cast<int>(cudaGetLastError());
}
