// Shared pieces of the (M, P) plane kernels: per-column dtype rounding,
// a column loaded into registers with its mean and dispersion term, the
// mixing matrix staged in shared memory and one row of its product, the
// register-array size dispatch, the fixed-order block reduction of the
// dispersion partials, and the fixed-order second pass that sums them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Load column j of the m rows of the (m, p) plane x into registers.
template <int MAXM>
__device__ __forceinline__ void load_column(const float* __restrict__ x,
                                            int m, int64_t p, int64_t j,
                                            float (&u)[MAXM]) {
#pragma unroll
  for (int i = 0; i < MAXM; ++i)
    if (i < m) u[i] = x[static_cast<int64_t>(i) * p + j];
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

// One block of kSumThreads: out[0] = (sum of the n partials) / m. Each
// thread sums a fixed strided slice in double, then a fixed tree.
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
