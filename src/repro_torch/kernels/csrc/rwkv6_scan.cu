// RWKV6 (Finch) WKV recurrence over the sequence axis, per (batch, head)
// with head dim n and data-dependent per-channel decay:
//   y_t = r_t · (S_{t-1} + (u∘k_t) v_tᵀ);  S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_tᵀ
// with S_0 = 0, in float32.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_scan
// (_wkv_kernel, rwkv6_scan.py:23; pallas_call at :69), which transposes r,
// k, v and the decays to (B, H, S, n) float32, pads S to a 128-step block
// with identity steps, takes exp in its wrapper and carries the (n, n)
// state in VMEM across a sequential grid. Here the kernel reads the
// model's layout and types directly: r, k, v (B, S, H, n) in float32 or
// bfloat16, log_w (B, S, H, n) float32, u (H * n) float32, out (B, S, H,
// n) float32. It takes expf itself (IEEE, no fast math) and stops at S:
// no transpose, no padding, no float32 copy.
//
// Bound on an H100 (67 TFLOP/s float32, 3.35 TB/s): operations. Per
// (token, head) r·S takes 2 n² flops, the state update 3 n², the bonus
// (below) 5 n: at rwkv6-7b's prefill (B 4, S 2048, 64 heads of 64)
// 1.09e10 flops, 0.163 ms, against 470 MB of inputs and output, 0.140 ms.
//
// Design, simple first. One block per (batch, head); the columns j of S
// are independent, and each is owned by kParts = 4 adjacent threads of a
// warp, each holding n / 4 rows of S[:, j] in registers (16 at n = 64:
// 256 threads a block, 256 blocks at the serving shape). A step is, per
// owned entry, one fmaf into y and the state update; the four lanes of a
// column reduce y with two xor shuffles (no atomics: two runs agree
// bitwise). The bonus term factors out, y_j += v_j (r · (u∘k)), so that
// sum is taken once per step while the chunk is staged. r, k, exp(log_w)
// and v for kChunk = 32 steps are staged in shared memory as float32 —
// one __syncthreads pair per chunk, not per step — and the next chunk's
// global loads are issued into registers before the current chunk's
// steps run, so their latency hides behind the compute. A thread reads
// its rows of r, k and w as float4 broadcasts; each part's rows are
// padded by 4 floats so that the four parts of a warp hit distinct banks.
//
// Rounding: the state update multiplies and adds with __fmul_rn /
// __fadd_rn, each rounded on its own (the build also passes
// -fmad=false), as the sequential plain version does, so the two carry
// the same state bit for bit given the same exp; y's dot product is
// summed in another order (4 fmaf chains, then the lanes), so y is held
// to a tolerance, not bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kParts = 4;   // threads per state column
constexpr int kChunk = 32;  // steps staged in shared memory at a time

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int N, typename In>
__global__ void __launch_bounds__(N * kParts)
rwkv6_scan_heads(const In* __restrict__ r, const In* __restrict__ k,
                 const In* __restrict__ v, const float* __restrict__ log_w,
                 const float* __restrict__ u, float* __restrict__ out, int s,
                 int h) {
  constexpr int kThreads = N * kParts;
  constexpr int kRows = N / kParts;      // rows of a column a thread owns
  constexpr int kPad = kRows + 4;        // a part's stride in shared memory
  constexpr int kRow = kParts * kPad;    // a step's stride (r, k, w)
  constexpr int kPer = kChunk * N / kThreads;  // staged values a thread
  constexpr int kGroup = N < 32 ? N : 32;      // lanes of one step's row
  constexpr int kSums = N / kGroup;            // bonus partials per step
  static_assert(kRows % 4 == 0, "rows are read as float4");

  __shared__ __align__(16) float sr[kChunk * kRow];
  __shared__ __align__(16) float sk[kChunk * kRow];
  __shared__ __align__(16) float sw[kChunk * kRow];
  __shared__ float sv[kChunk * N];
  __shared__ float sb[kChunk * kSums];

  const int tid = threadIdx.x;
  const int col = tid / kParts;   // the state column j this thread owns
  const int part = tid % kParts;  // its rows part * kRows + (0 .. kRows-1)
  const int hh = blockIdx.x % h;
  const int64_t stride = static_cast<int64_t>(h) * N;  // one step
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x / h) * s * h + hh) * N;

  // Staging: value q of a thread is element tid + q * kThreads of the
  // chunk, step (tid + q * kThreads) / N, channel tid % N for every q.
  const int ch = tid % N;
  const int slot = (ch / kRows) * kPad + ch % kRows;
  const float uc = u[hh * N + ch];
  In pr[kPer], pk[kPer], pv[kPer];
  float pw[kPer];

  auto fetch = [&](int t0) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int t = t0 + (tid + q * kThreads) / N;
      if (t < s) {
        const int64_t i = base + t * stride + ch;
        pr[q] = r[i];
        pk[q] = k[i];
        pv[q] = v[i];
        pw[q] = log_w[i];
      } else {
        pr[q] = pk[q] = pv[q] = In(0.0f);
        pw[q] = 0.0f;
      }
    }
  };

  float S[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) S[i] = 0.0f;

  fetch(0);
  for (int t0 = 0; t0 < s; t0 += kChunk) {
    __syncthreads();  // every step of the last chunk has read its values
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int t = (tid + q * kThreads) / N;
      const float rv = to_float(pr[q]), kv = to_float(pk[q]);
      sr[t * kRow + slot] = rv;
      sk[t * kRow + slot] = kv;
      sw[t * kRow + slot] = expf(pw[q]);
      sv[t * N + ch] = to_float(pv[q]);
      // r_t · (u∘k_t) over the kGroup lanes holding this step's channels
      float bonus = rv * uc * kv;
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1)
        bonus += __shfl_xor_sync(0xffffffffu, bonus, off);
      if (ch % kGroup == 0) sb[t * kSums + ch / kGroup] = bonus;
    }
    __syncthreads();
    if (t0 + kChunk < s) fetch(t0 + kChunk);  // in flight during the steps

    const int steps = min(kChunk, s - t0);
    for (int t = 0; t < steps; ++t) {
      const float* rt = sr + t * kRow + part * kPad;
      const float* kt = sk + t * kRow + part * kPad;
      const float* wt = sw + t * kRow + part * kPad;
      const float vj = sv[t * N + col];
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < kRows; q += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(rt + q);
        const float4 kk = *reinterpret_cast<const float4*>(kt + q);
        const float4 ww = *reinterpret_cast<const float4*>(wt + q);
        acc[0] = fmaf(rr.x, S[q], acc[0]);
        acc[1] = fmaf(rr.y, S[q + 1], acc[1]);
        acc[2] = fmaf(rr.z, S[q + 2], acc[2]);
        acc[3] = fmaf(rr.w, S[q + 3], acc[3]);
        S[q] = __fadd_rn(__fmul_rn(ww.x, S[q]), __fmul_rn(kk.x, vj));
        S[q + 1] = __fadd_rn(__fmul_rn(ww.y, S[q + 1]), __fmul_rn(kk.y, vj));
        S[q + 2] = __fadd_rn(__fmul_rn(ww.z, S[q + 2]), __fmul_rn(kk.z, vj));
        S[q + 3] = __fadd_rn(__fmul_rn(ww.w, S[q + 3]), __fmul_rn(kk.w, vj));
      }
      float y = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      y += __shfl_xor_sync(0xffffffffu, y, 1);
      y += __shfl_xor_sync(0xffffffffu, y, 2);
      float bonus = sb[t * kSums];
#pragma unroll
      for (int i = 1; i < kSums; ++i) bonus += sb[t * kSums + i];
      y = fmaf(vj, bonus, y);
      if (part == 0) out[base + (t0 + t) * stride + col] = y;
    }
  }
}

template <int N, typename In>
int launch(const void* r, const void* k, const void* v, const float* log_w,
           const float* u, float* out, int b, int s, int h,
           cudaStream_t st) {
  rwkv6_scan_heads<N, In><<<b * h, N * kParts, 0, st>>>(
      static_cast<const In*>(r), static_cast<const In*>(k),
      static_cast<const In*>(v), log_w, u, out, s, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int launch_n(int n, const void* r, const void* k, const void* v,
             const float* log_w, const float* u, float* out, int b, int s,
             int h, cudaStream_t st) {
  switch (n) {
    case 16:
      return launch<16, In>(r, k, v, log_w, u, out, b, s, h, st);
    case 32:
      return launch<32, In>(r, k, v, log_w, u, out, b, s, h, st);
    case 64:
      return launch<64, In>(r, k, v, log_w, u, out, b, s, h, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry point, bound with ctypes: out = WKV6(r, k, v, log_w, u). dtype
// (of r, k, v): 0 float32, 1 bfloat16; n in {16, 32, 64}; every tensor
// contiguous (the wrapper checks). Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const float* log_w, const float* u,
                                 float* out, int b, int s, int h, int n,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_n<float>(n, r, k, v, log_w, u, out, b, s, h, st);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(n, r, k, v, log_w, u, out, b, s, h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
