// Compressed averaging / mixing event on the (M, P) f32 parameter plane,
// with error feedback:
//
//   v = x + e (or x without feedback);  q = Q(v);  e' = v - q;
//   out = mean(q) | group means of q | W @ q, rounded through the codes;
//
// and the Eq. 4 dispersion of the input plane x (pre-encode). Q is the
// wire format: bf16 (round to nearest even), int8 (per-row scale
// s = max|v| / 127, q = clamp(floor(v / s + u), -127, 127) * s with the
// uniforms u) or one_bit (per-row s = sum |v| / P, q = v >= 0 ? s : -s).
//
// Replaces the TPU kernel repro/kernels/avg_disp.py::compressed_mix
// (_compressed_mix_kernel, avg_disp.py:83; pallas_call at :364), with its
// `alive` (fault-masked) branch (:325-337) as the MASKED instantiations;
// it also serves the `wire` path of opt_step (opt_step.py:101-149), run on
// the plane opt_step.cu has just updated.
//
// Bound on an H100 (3.35 TB/s): memory. Reading x, e and the codes row
// once and writing the plane and e' once is 4 * M * P * 4 + P * 4 bytes =
// 24.60 GB at M = 4, P = 361,821,120 (7.34 ms); int8 also reads u,
// 30.39 GB (9.07 ms). It does a few tens of flops per element, far below
// the ridge.
//
// Design. On the TPU the (2, nb) grid runs in order, and phase 0 carries
// the per-row statistic across column blocks in VMEM scratch. Hopper
// blocks run in no order, so the scaled formats take three launches
// instead of one with a carried sum:
//   1. row_stats: each block covers kStatCols columns and, row by row,
//      reduces its partial statistic (max |v| for int8, sum |v| in double
//      for one_bit) in a fixed tree, one partial per (block, row);
//   2. row_scales: one block reduces the partials of each row in a fixed
//      order and writes the M scales;
//   3. emit_cols: one thread per column encodes, writes e', applies the
//      event to the decoded column held in registers (W staged in shared
//      memory for the mix, summed in j order) and writes the plane;
// then the fixed second pass sums the dispersion partials. bf16 needs no
// statistic and is the emit launch alone. The scaled formats read x and e
// twice (launches 1 and 3): 7 plane transfers instead of the bound's 5
// (int8: 8 instead of 6). x and e are updated IN PLACE: launch 3 reads a
// column whole before it writes it, and launch 1 has finished before it
// starts. No atomics anywhere, so two runs give the same bits; -fmad=false
// and IEEE division make every quantized value equal the plain version's.
// The one_bit sum is kept in double in both, so the two float32 scales
// agree whatever order each sums in.
//
// The masked event takes the `alive` rows as a 64-bit mask by value. A
// dead row ships no bytes: row_stats and row_scales skip it, and
// emit_cols neither reads nor encodes nor writes its plane row or its
// residual, so it keeps both without being saved. The dispersion is the
// pre-encode one over the alive rows, divided by their count; modes mean
// / group take the exact masked (group) mean of the alive rows' decoded
// q, mode mix the degraded W (faults.degraded_matrix) over the alive q,
// each written to the alive rows only. At full width with one dead row
// (one_bit, ring, codes) that is 3 rows x 4 transfers + the codes,
// 18.8 GB (5.6 ms) against the bound; the scaled formats read the alive
// x and e twice, as unmasked.
#include "plane_common.cuh"

namespace {

enum Wire { kBf16 = 0, kInt8 = 1, kOneBit = 2 };
enum EventMode { kMean = 0, kGroup = 1, kMix = 2 };

// Columns per thread and per block of the row-statistic pass.
constexpr int kStatIters = 16;
constexpr int kStatCols = kPlaneThreads * kStatIters;

template <int WIRE>
__device__ __forceinline__ double stat_op(double a, double b) {
  return WIRE == kInt8 ? fmax(a, b) : a + b;
}

template <int WIRE, bool MASKED>
__global__ void __launch_bounds__(kPlaneThreads)
row_stats(const float* __restrict__ x, const float* __restrict__ e, int ef,
          double* __restrict__ rowpart, int m, int64_t p,
          unsigned long long alive) {
  __shared__ double red[kPlaneThreads];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kStatCols;
  for (int i = 0; i < m; ++i) {
    if (MASKED && !row_on(alive, i)) continue;  // the same for the block
    const int64_t row = static_cast<int64_t>(i) * p;
    double acc = 0.0;
    for (int k = 0; k < kStatIters; ++k) {
      const int64_t j = base + k * kPlaneThreads + threadIdx.x;
      if (j < p) {
        const float v = ef ? x[row + j] + e[row + j] : x[row + j];
        acc = stat_op<WIRE>(acc, static_cast<double>(fabsf(v)));
      }
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int s = kPlaneThreads / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s)
        red[threadIdx.x] = stat_op<WIRE>(red[threadIdx.x],
                                         red[threadIdx.x + s]);
      __syncthreads();
    }
    if (threadIdx.x == 0)
      rowpart[static_cast<int64_t>(blockIdx.x) * m + i] = red[0];
    __syncthreads();  // red is reused by the next row
  }
}

template <int WIRE, bool MASKED>
__global__ void row_scales(const double* __restrict__ rowpart, int64_t nblk,
                           int m, int64_t p, float* __restrict__ scales,
                           unsigned long long alive) {
  __shared__ double red[kSumThreads];
  for (int i = 0; i < m; ++i) {
    if (MASKED && !row_on(alive, i)) continue;
    double acc = 0.0;
    for (int64_t b = threadIdx.x; b < nblk; b += kSumThreads)
      acc = stat_op<WIRE>(acc, rowpart[b * m + i]);
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int s = kSumThreads / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s)
        red[threadIdx.x] = stat_op<WIRE>(red[threadIdx.x],
                                         red[threadIdx.x + s]);
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      if (WIRE == kInt8) {
        const float amax = static_cast<float>(red[0]);
        scales[i] = amax > 0.0f ? amax / 127.0f : 1.0f;
      } else {
        scales[i] = static_cast<float>(red[0] / static_cast<double>(p));
      }
    }
    __syncthreads();
  }
}

template <int MAXM, int WIRE, bool MASKED>
__global__ void __launch_bounds__(kPlaneThreads)
emit_cols(float* __restrict__ x, float* __restrict__ e,
          const float* __restrict__ u, const float* __restrict__ codes,
          const float* __restrict__ w, const float* __restrict__ scales,
          float* __restrict__ dpart, int m, int64_t p, int mode, int groups,
          int ef, unsigned long long alive, float n_alive) {
  __shared__ float sw[MAXM * MAXM];
  __shared__ float ss[MAXM];
  if (WIRE != kBf16)
    for (int k = threadIdx.x; k < m; k += blockDim.x) ss[k] = scales[k];
  if (mode == kMix)
    for (int k = threadIdx.x; k < m * m; k += blockDim.x) sw[k] = w[k];
  __syncthreads();
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kPlaneThreads +
                    threadIdx.x;
  float dsq = 0.0f;
  if (j < p) {
    const float code = codes != nullptr ? codes[j] : 0.0f;
    float xr[MAXM];
    float q[MAXM];
    // x, e and u are loaded in one loop, so that all their loads are in
    // flight together (loading x first, as load_column does, made the int8
    // event about 9% slower on an H100 at M = 4, P = 361,821,120)
#pragma unroll
    for (int i = 0; i < MAXM; ++i) {
      if (i < m && (!MASKED || row_on(alive, i))) {
        const int64_t o = static_cast<int64_t>(i) * p + j;
        xr[i] = x[o];
        const float v = ef ? xr[i] + e[o] : xr[i];
        float qi;
        if (WIRE == kBf16) {
          qi = __bfloat162float(__float2bfloat16_rn(v));
        } else if (WIRE == kInt8) {
          const float s = ss[i];
          qi = fminf(fmaxf(floorf(v / s + u[o]), -127.0f), 127.0f) * s;
        } else {
          qi = v >= 0.0f ? ss[i] : -ss[i];
        }
        q[i] = qi;
        if (ef) e[o] = v - qi;
      }
    }
    if constexpr (MASKED) {
      masked_column_mean_dsq(xr, m, alive, n_alive, &dsq);
      if (mode == kMix) {
#pragma unroll 1
        for (int i = 0; i < m; ++i)
          if (row_on(alive, i))
            x[static_cast<int64_t>(i) * p + j] =
                round_code(masked_mix_row(q, sw, m, i, alive), code);
      } else {
        write_masked_means(q, m, mode == kGroup ? m / groups : m, alive,
                           code, x, p, j);
      }
    } else {
      column_mean_dsq(xr, m, &dsq);
      if (mode == kMix) {
#pragma unroll 1
        for (int i = 0; i < m; ++i)
          x[static_cast<int64_t>(i) * p + j] =
              round_code(mix_row(q, sw, m, i), code);
      } else {
        const int gs = mode == kGroup ? m / groups : m;
        for (int lo = 0; lo < m; lo += gs) {
          const int hi = lo + gs;
          float gsum = 0.0f;
#pragma unroll
          for (int i = 0; i < MAXM; ++i)
            if (i >= lo && i < hi) gsum += q[i];
          const float out = round_code(gsum / static_cast<float>(gs), code);
#pragma unroll
          for (int i = 0; i < MAXM; ++i)
            if (i >= lo && i < hi) x[static_cast<int64_t>(i) * p + j] = out;
        }
      }
    }
  }
  block_partial(dsq, dpart);
}

template <int WIRE, bool MASKED>
void launch_wire(cudaStream_t st, float* x, float* e, const float* u,
                 const float* codes, const float* w, double* rowpart,
                 float* scales, float* dpart, int m, int64_t p, int mode,
                 int groups, int ef, unsigned long long alive,
                 float n_alive) {
  if (WIRE != kBf16) {
    const int64_t nstat = (p + kStatCols - 1) / kStatCols;
    row_stats<WIRE, MASKED>
        <<<static_cast<unsigned>(nstat), kPlaneThreads, 0, st>>>(
            x, e, ef, rowpart, m, p, alive);
    row_scales<WIRE, MASKED><<<1, kSumThreads, 0, st>>>(rowpart, nstat, m,
                                                          p, scales, alive);
  }
  const int64_t nblocks = (p + kPlaneThreads - 1) / kPlaneThreads;
  dispatch_m(m, [&](auto t) {
    emit_cols<decltype(t)::value, WIRE, MASKED>
        <<<static_cast<unsigned>(nblocks), kPlaneThreads, 0, st>>>(
            x, e, u, codes, w, scales, dpart, m, p, mode, groups, ef, alive,
            n_alive);
  });
}

template <bool MASKED>
void launch_format(cudaStream_t st, int wire, float* x, float* e,
                   const float* u, const float* codes, const float* w,
                   double* rowpart, float* scales, float* dpart, int m,
                   int64_t p, int mode, int groups, int ef,
                   unsigned long long alive, float n_alive) {
  if (wire == kBf16)
    launch_wire<kBf16, MASKED>(st, x, e, u, codes, w, rowpart, scales,
                               dpart, m, p, mode, groups, ef, alive,
                               n_alive);
  else if (wire == kInt8)
    launch_wire<kInt8, MASKED>(st, x, e, u, codes, w, rowpart, scales,
                               dpart, m, p, mode, groups, ef, alive,
                               n_alive);
  else
    launch_wire<kOneBit, MASKED>(st, x, e, u, codes, w, rowpart, scales,
                                 dpart, m, p, mode, groups, ef, alive,
                                 n_alive);
}

}  // namespace

// C entry point, bound with ctypes. x (the plane) and e (the residual) are
// updated in place; u (int8 uniforms), codes and w (row-major (m, m), mode
// mix; under a mask the degraded one) may be null where unused. Scratch:
// rowpart holds ceil(P / 4096) * m doubles and scales m floats (both
// unused for bf16), dpart ceil(P / 256) floats; disp receives the Eq. 4
// dispersion of the input plane. wire: 0 bf16, 1 int8, 2 one_bit; mode:
// 0 mean, 1 group, 2 mix. masked != 0 masks the event over the rows set in
// `alive` (bit i = row i). Returns cudaGetLastError() after every launch
// (0 = success).
extern "C" int compressed_mix_launch(float* x, float* e, const float* u,
                                     const float* codes, const float* w,
                                     double* rowpart, float* scales,
                                     float* dpart, float* disp, int m,
                                     long long p, int wire, int mode,
                                     int groups, int ef, int masked,
                                     unsigned long long alive,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float rows = masked ? static_cast<float>(__builtin_popcountll(alive))
                            : static_cast<float>(m);
  if (masked)
    launch_format<true>(st, wire, x, e, u, codes, w, rowpart, scales, dpart,
                        m, p, mode, groups, ef, alive, rows);
  else
    launch_format<false>(st, wire, x, e, u, codes, w, rowpart, scales,
                         dpart, m, p, mode, groups, ef, alive, rows);
  const int64_t nblocks = (p + kPlaneThreads - 1) / kPlaneThreads;
  sum_partials<<<1, kSumThreads, 0, st>>>(dpart, nblocks, rows, disp);
  return static_cast<int>(cudaGetLastError());
}
