// Shared pieces of the (M, P) plane kernels: per-column dtype rounding,
// a column loaded into registers with its mean and dispersion term, the
// mixing matrix staged in shared memory and one row of its product, the
// same over the rows of a 64-bit row mask (the fault-degraded passes) with
// the masked (group) means, the register-array size dispatch and that of
// two template flags, the fixed-order block reduction of the dispersion
// partials, and the fixed-order second pass that sums them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Threads per block of the column sweeps (one column per thread).
constexpr int kPlaneThreads = 256;
// Threads of the single-block partial-sum pass.
constexpr int kSumThreads = 1024;

// Round x through the column's original dtype and back (codes from
// FlatSpec.rounding_codes: 0 f32, 1 bf16, 2 f16), round-to-nearest-even —
// what PyTorch's x.to(torch.bfloat16).float() computes.
__device__ __forceinline__ float round_code(float x, float code) {
  if (code == 1.0f) return __bfloat162float(__float2bfloat16_rn(x));
  if (code == 2.0f) return __half2float(__float2half_rn(x));
  return x;
}

// Every row of a 64-bit row mask (see row_on): the unmasked passes.
constexpr unsigned long long kAllRows = ~0ull;

// Bit i of a 64-bit row mask: bit i is worker row i (the plane kernels
// take at most 64 rows).
__device__ __forceinline__ bool row_on(unsigned long long mask, int i) {
  return (mask >> i) & 1ull;
}

// Load column j of the m rows of the (m, p) plane x into registers: only
// the rows set in `rows` are read, the others' registers are left unset.
template <int MAXM>
__device__ __forceinline__ void load_column(const float* __restrict__ x,
                                            int m, int64_t p, int64_t j,
                                            float (&u)[MAXM],
                                            unsigned long long rows =
                                                kAllRows) {
#pragma unroll
  for (int i = 0; i < MAXM; ++i)
    if (i < m && row_on(rows, i)) u[i] = x[static_cast<int64_t>(i) * p + j];
}

// The mean of a column held in registers, and its Eq. 4 dispersion term
// sum_i (u_i - mean)^2 into *dsq: both summed over i = 0 .. m-1 in order
// from 0, each step rounded on its own (-fmad=false), as the plain
// versions sum.
template <int MAXM>
__device__ __forceinline__ float column_mean_dsq(const float (&u)[MAXM],
                                                 int m, float* dsq) {
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < MAXM; ++i)
    if (i < m) sum += u[i];
  const float mean = sum / static_cast<float>(m);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < MAXM; ++i) {
    if (i < m) {
      const float d = u[i] - mean;
      acc += d * d;
    }
  }
  *dsq = acc;
  return mean;
}

// column_mean_dsq over the rows set in `alive` only: their sum in row
// order from 0 divided once by n_alive, and their squared deviations
// summed in the same order — the terms of faults.masked_dispersion.
template <int MAXM>
__device__ __forceinline__ float masked_column_mean_dsq(
    const float (&u)[MAXM], int m, unsigned long long alive, float n_alive,
    float* dsq) {
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < MAXM; ++i)
    if (i < m && row_on(alive, i)) sum += u[i];
  const float mean = sum / n_alive;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < MAXM; ++i) {
    if (i < m && row_on(alive, i)) {
      const float d = u[i] - mean;
      acc += d * d;
    }
  }
  *dsq = acc;
  return mean;
}

// Copy the (m, m) mixing matrix into shared memory, then sync the block.
// Every thread of the block must call it.
__device__ __forceinline__ void stage_matrix(const float* __restrict__ w,
                                             int m, float* sw) {
  for (int k = threadIdx.x; k < m * m; k += blockDim.x) sw[k] = w[k];
  __syncthreads();
}

// Row i of the mix: sum_k W[i, k] * u[k] for k = 0 .. m-1 in order,
// starting from 0, each product and sum rounded on its own (-fmad=false)
// — the arithmetic of the plain version's loop.
template <int MAXM>
__device__ __forceinline__ float mix_row(const float (&u)[MAXM],
                                         const float* sw, int m, int i) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < MAXM; ++k)
    if (k < m) acc += sw[i * m + k] * u[k];
  return acc;
}

// mix_row over the rows set in `alive`: W[i, k] * u[k] for alive k only.
// The plain version sums every k, but the degraded W
// (faults.degraded_matrix) has W[i, k] = 0 for an alive i and a dead k,
// and a term 0 * u[k] = +-0 (u finite) added to a sum that starts from
// +0 never changes it (a sum of two floats is -0 only when both are), so
// the two agree bitwise while a dead row's u[k] is neither read nor set.
template <int MAXM>
__device__ __forceinline__ float masked_mix_row(const float (&u)[MAXM],
                                                const float* sw, int m,
                                                int i,
                                                unsigned long long alive) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < MAXM; ++k)
    if (k < m && row_on(alive, k)) acc += sw[i * m + k] * u[k];
  return acc;
}

// The masked (group) means of column j: for each group of gs contiguous
// rows, its rows set in `alive` summed in row order from 0, divided once
// by their count (IEEE), rounded through the code and written to those
// rows of x only. A group without an alive row is left as it is. The
// arithmetic of faults.masked_mean / masked_group_mean.
template <int MAXM>
__device__ __forceinline__ void write_masked_means(
    const float (&u)[MAXM], int m, int gs, unsigned long long alive,
    float code, float* __restrict__ x, int64_t p, int64_t j) {
  for (int lo = 0; lo < m; lo += gs) {
    const int hi = lo + gs;
    float gsum = 0.0f;
    int n = 0;
#pragma unroll
    for (int i = 0; i < MAXM; ++i) {
      if (i >= lo && i < hi && row_on(alive, i)) {
        gsum += u[i];
        ++n;
      }
    }
    if (n == 0) continue;
    const float out = round_code(gsum / static_cast<float>(n), code);
#pragma unroll
    for (int i = 0; i < MAXM; ++i)
      if (i >= lo && i < hi && row_on(alive, i))
        x[static_cast<int64_t>(i) * p + j] = out;
  }
}

// Call f(MaxM<N>{}) with the smallest register-array bound N in
// {4, 8, 16, 32, 64} that holds m worker rows.
template <int N>
struct MaxM {
  static constexpr int value = N;
};
template <class F>
void dispatch_m(int m, F&& f) {
  if (m <= 4)
    f(MaxM<4>{});
  else if (m <= 8)
    f(MaxM<8>{});
  else if (m <= 16)
    f(MaxM<16>{});
  else if (m <= 32)
    f(MaxM<32>{});
  else
    f(MaxM<64>{});
}

// Call f(a, b) with the two run-time flags as std::bool_constant values,
// so that f can take them as template flags (a kernel's MASKED and CODES
// instantiations).
template <class F>
void dispatch_flags(bool a, bool b, F&& f) {
  using T = std::true_type;
  using N = std::false_type;
  if (a && b)
    f(T{}, T{});
  else if (a)
    f(T{}, N{});
  else if (b)
    f(N{}, T{});
  else
    f(N{}, N{});
}

// Sum one float per thread over the block in a fixed tree order and
// write it to dpart[blockIdx.x]. No atomics: two launches on the same
// inputs give the same bits.
__device__ __forceinline__ void block_partial(float v, float* dpart) {
  __shared__ float red[kPlaneThreads];
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kPlaneThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) dpart[blockIdx.x] = red[0];
}

// One block of kSumThreads: out[0] = (sum of the n partials) / m, m the
// row count (the alive rows' under a mask). Each thread sums a fixed
// strided slice in double, then a fixed tree.
__global__ void sum_partials(const float* __restrict__ dpart, int64_t n,
                             float m, float* __restrict__ out) {
  __shared__ double red[kSumThreads];
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < n; i += kSumThreads) acc += dpart[i];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kSumThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = static_cast<float>(red[0]) / m;
}
