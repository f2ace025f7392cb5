// Shared pieces of the (M, P) plane kernels: per-column dtype rounding,
// the fixed-order block reduction of the dispersion partials, and the
// fixed-order second pass that sums them.
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
