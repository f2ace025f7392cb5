// All-worker average + Eq. 4 dispersion + the outer optimizer's momentum
// step (DiLoCo-style, optionally Nesterov) + broadcast, on the (M, P) f32
// parameter plane:
//
//   avg = mean_i x_i;  g = prev - avg;  vel' = mu * vel + g;
//   step = nesterov ? mu * vel' + g : vel';  new = prev - lr * step;
//   out_i = new for every row i.
//
// Replaces the TPU kernel repro/kernels/avg_disp.py::avg_disp_outer
// (_avg_disp_outer_kernel, avg_disp.py:62; pallas_call at :270). Like it,
// it takes no rounding codes: planes with codes take the plain version in
// the engine, as the reference prescribes.
//
// Bound on an H100 (3.35 TB/s): memory. The pass reads the plane, prev and
// vel once and writes the output plane, new and vel' once:
// 2 * M * P * 4 + 4 * P * 4 bytes = 17.37 GB at M = 4, P = 361,821,120
// (5.18 ms), at about 10 flops per column — far below the ridge.
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

template <int MAXM>
__global__ void __launch_bounds__(kPlaneThreads)
avg_disp_outer_cols(const float* __restrict__ x,
                    const float* __restrict__ prev,
                    const float* __restrict__ vel, float* __restrict__ out,
                    float* __restrict__ new_avg, float* __restrict__ new_vel,
                    float* __restrict__ dpart, int m, int64_t p, float lr,
                    float momentum, int nesterov) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kPlaneThreads +
                    threadIdx.x;
  float dsq = 0.0f;
  if (j < p) {
    float u[MAXM];
    load_column(x, m, p, j, u);
    const float mean = column_mean_dsq(u, m, &dsq);
    const float pa = prev[j];
    const float g = pa - mean;
    const float v = momentum * vel[j] + g;
    const float step = nesterov ? momentum * v + g : v;
    const float upd = pa - lr * step;
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
// new_avg / new_vel = the (P,) outer state after the step, disp = Eq. 4
// dispersion of x; dpart is ceil(P / 256) floats of scratch. Returns
// cudaGetLastError() after both launches (0 = success).
extern "C" int avg_disp_outer_launch(const float* x, const float* prev,
                                     const float* vel, float* out,
                                     float* new_avg, float* new_vel,
                                     float* dpart, float* disp, int m,
                                     long long p, float lr, float momentum,
                                     int nesterov, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nblocks = (p + kPlaneThreads - 1) / kPlaneThreads;
  const dim3 grid(static_cast<unsigned>(nblocks));
  dispatch_m(m, [&](auto t) {
    avg_disp_outer_cols<decltype(t)::value><<<grid, kPlaneThreads, 0, st>>>(
        x, prev, vel, out, new_avg, new_vel, dpart, m, p, lr, momentum,
        nesterov);
  });
  sum_partials<<<1, kSumThreads, 0, st>>>(dpart, nblocks,
                                           static_cast<float>(m), disp);
  return static_cast<int>(cudaGetLastError());
}
