// Online-softmax attention: causal, sliding window, GQA/MQA, keys beyond
// the sequence masked, f32 accumulation. Two kernels, one per input type:
// bfloat16 runs on Hopper's tensor cores (flash_fwd_wgmma), float32 on the
// CUDA cores (flash_fwd_f32).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_attn_kernel, flash_attention.py:28-69; pallas_call at :107). It computes
// what the TPU kernel computes, in the reference's layout: q (B, S, H, hd),
// k and v (B, S, Hkv, hd), out (B, S, H, hd) in q's type. Query head h
// reads key/value head h / (H / Hkv). A key is masked unless key < S, and
// key <= query (causal), and key > query - window (window > 0). Scores are
// the dot products times the scale, applied after the dot; the running
// max, the sum l and the output accumulator stay float32. A row with no key
// left gives 0.
//
// Bound on an H100 (989 TFLOP/s bf16 tensor cores, 3.35 TB/s): operations.
// recurrentgemma-2b's prefill (B 4, S 3072, 10 heads, MQA, hd 256, window
// 2048) has 4,195,328 (query, key) pairs per (batch, head) in its band,
// 1.72e11 flops: 0.174 ms; smollm-360m's (B 4, S 2048, 15 / 5 heads, hd 64,
// causal) 2,098,176 pairs, 3.22e10 flops: 0.033 ms.
//
// bfloat16, flash_fwd_wgmma<hd>: one block of two warpgroups per (batch,
// query head, 128 query rows), 64 rows per warpgroup (wgmma's M), the
// heaviest query tiles (last under a causal mask) first.
//  - Only the key tiles that meet the block's causal / window band are
//    visited (the TPU grid visits every tile and masks it); a warpgroup
//    skips a tile that none of its rows sees, and masks only a tile that
//    crosses the band's edge or the end of the sequence.
//  - Staging: Q once, then K and V tiles (64 keys at hd 256, 128 below) in
//    a ring of two stages in shared memory, filled by TMA
//    (cp.async.bulk.tensor, completion on mbarriers) with the 128-byte
//    swizzle that wgmma's descriptors read (64-byte at hd 32), rows past S
//    filled with zeros. Thread 0 issues the copies: tile j + 2 as soon as
//    both warpgroups have released tile j, so each load overlaps the
//    previous tile's products.
//  - S = Q K^T: wgmma m64nBKk16, bf16 x bf16 -> f32, Q and K K-major in
//    shared memory. A bf16 product is exact in f32, so S is the quantity
//    the reference computes, summed in another order.
//  - Online softmax on the accumulator fragment: a row lives on the four
//    lanes of a quad, its max is taken with two shuffles. The scores are
//    multiplied by c = scale * log2(e), one multiplier that folds the
//    scale and exp2f's base together, so P = exp2f(s c - max). l sums the
//    f32 P, as the reference sums its P.
//  - O += P V, 16 keys per step: P rounded once to bf16 in registers is
//    wgmma's A operand, each step's P computed while the previous steps'
//    products run; V is read from shared memory as an MN-major B operand
//    (the transpose bit), so it needs no transpose in memory. O stays an
//    f32 accumulator in registers (64 x hd per warpgroup: 128 registers a
//    thread at hd 256). Rounding P to bf16 is the only rounding the
//    reference does not make; the serving shapes stay within
//    card_check.FLASH_SERVE_TOL with it, so P is not split into a bf16
//    high and low part.
//  - Registers (ptxas, CUDA 12.8, sm_90a): 208 at hd 256, 210 at 128, 128
//    at 64 and 32 (two blocks per SM there); no spills.
//  - out = O / l (l == 0 -> 1), rounded once to bf16, stored from the
//    registers; no atomics, so two runs are bitwise equal.
//  The tensor maps are encoded on the host with cuTensorMapEncodeTiled, a
//  libcuda function looked up in the loaded libcuda.so.1 with dlsym (no
//  -lcuda at link time, no runtime entry-point API whose signature moves
//  between toolkits), and passed as __grid_constant__ kernel parameters
//  over a 3-D view (B, S, heads * hd) of each tensor, so that rows past S
//  are outside the view and read as zeros.
//
// float32, flash_fwd_f32<hd>: the CUDA-core kernel. The suite's float32
// tolerance (2e-5) holds the port to f32 products, which bf16 tensor cores
// cannot meet, and no serving path runs attention in float32 on the card.
// 256 threads per (batch, query head, 64 queries); the Q tile, one K tile
// and one V tile (64 keys) in shared memory, Q and K rows padded by one
// word so that the score loop's column reads hit distinct banks; each
// thread owns 4 query rows x 4 keys of the score tile and 4 rows x hd/16
// columns of the accumulator; the probabilities go through shared memory
// to the PV loop. Products are explicit fmaf.
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

// ---- float32: the CUDA cores -------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kPS = kBQ + 4;  // row stride (floats) of the probability tile
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

template <int HD>
struct F32Tile {
  static constexpr int kQW = HD + 1;   // padded row stride of Q and K, floats
  static constexpr int kCPT = HD / 16;  // accumulator columns per thread
  static constexpr int kKFloats =
      (kBK * kQW > kBK * kPS) ? kBK * kQW : kBK * kPS;
  static constexpr int kSmemFloats = kBQ * kQW + kKFloats + kBK * HD;
  static_assert(HD % 16 == 0, "head_dim too small for the tile layout");
};

// Copy `rows` rows of HD floats (row r at src + r * stride, rows >= valid
// read as zeros) into shared memory at a row stride of `sw` floats.
// Consecutive threads take consecutive rows, so the stores of a warp land
// in distinct banks (sw is odd).
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, int sw,
                                          const float* __restrict__ src,
                                          int64_t stride, int rows,
                                          int valid) {
  constexpr int kVPR = HD / 4;  // 16-byte vectors per row
  for (int f = threadIdx.x; f < rows * kVPR; f += kThreads) {
    const int r = f % rows, v = f / rows;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < valid) x = reinterpret_cast<const float4*>(src + r * stride)[v];
    float* d = dst + r * sw + 4 * v;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int s,
              int h, int hkv, float scale, int causal, int window) {
  using L = F32Tile<HD>;
  constexpr int QW = L::kQW, CPT = L::kCPT;
  extern __shared__ float smem_f32[];
  float* qs = smem_f32;            // (kBQ, QW)
  float* ks = qs + kBQ * QW;       // (kBK, QW)
  float* pt = ks;                  // (kBK, kPS), after the scores
  float* vs = ks + L::kKFloats;    // (kBK, HD)

  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  // the heaviest query tiles (last under a causal mask) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int hh = blockIdx.y, b = blockIdx.z, hk = hh / (h / hkv);
  const int64_t qstride = static_cast<int64_t>(h) * HD;
  const int64_t kstride = static_cast<int64_t>(hkv) * HD;
  const float* qb = q + (static_cast<int64_t>(b) * s + q0) * qstride +
                    static_cast<int64_t>(hh) * HD;
  const float* kb = k + static_cast<int64_t>(b) * s * kstride +
                    static_cast<int64_t>(hk) * HD;
  const float* vb = v + static_cast<int64_t>(b) * s * kstride +
                    static_cast<int64_t>(hk) * HD;

  load_rows<HD>(qs, QW, qb, qstride, kBQ, s - q0);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;
  }

  // the key tiles that meet the band of queries q0 .. q0 + kBQ - 1
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(s, q0 + kBQ) : s;
  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();  // the previous tile's V and P reads are done
    load_rows<HD>(ks, QW, kb + k0 * kstride, kstride, kBK, s - k0);
    load_rows<HD>(vs, HD, vb + k0 * kstride, kstride, kBK, s - k0);
    __syncthreads();

    // scores of rows 4r .. 4r+3 against keys c, c+16, c+32, c+48
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int w = 0; w < HD; ++w) {
      float qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[i] = qs[(4 * r + i) * QW + w];
#pragma unroll
      for (int j = 0; j < 4; ++j) kf[j] = ks[(c + 16 * j) * QW + w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qf[i], kf[j], sc[i][j]);
    }

    // mask, scale, online softmax; rows are shared by 16 lanes
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * r + i;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + c + 16 * j;
        valid[j] = kpos < s && (!causal || kpos <= qpos) &&
                   (window <= 0 || kpos > qpos - window);
        sc[i][j] = valid[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = valid[j] ? expf(sc[i][j] - m_new) : 0.0f;
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // every thread is done reading the K tile
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (c + 16 * j) * kPS + 4 * r) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    // acc[rows 4r..4r+3][columns c, c+16, ...] += P V
    const int nk = min(kBK, s - k0);
    for (int j = 0; j < nk; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(pt + j * kPS + 4 * r);
      const float pr[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
      for (int t = 0; t < CPT; ++t) {
        const float vf = vs[j * HD + c + 16 * t];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][t] = fmaf(pr[i], vf, acc[i][t]);
      }
    }
  }

  // out = acc / l, a fully masked row (l == 0) gives 0
  float* ob = o + (static_cast<int64_t>(b) * s + q0) * qstride +
              static_cast<int64_t>(hh) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * r + i;
    if (q0 + row >= s) continue;
    const float li = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int t = 0; t < CPT; ++t)
      ob[row * qstride + c + 16 * t] = acc[i][t] / li;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int s, int h, int hkv, float scale, int causal, int window,
               cudaStream_t st) {
  const size_t smem = F32Tile<HD>::kSmemFloats * sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((s + kBQ - 1) / kBQ, h, b);
  flash_fwd_f32<HD><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s, h, hkv, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---- bfloat16: the tensor cores ------------------------------------------

constexpr int kTcThreads = 256;  // two warpgroups
constexpr int kQRows = 128;      // query rows per block, 64 per warpgroup
constexpr int kBoxRows = 64;     // rows of one TMA box
constexpr int kEncodeError = 10000;  // + CUresult of a failed map encode

template <int HD>
struct Tc {
  static constexpr int kCB = HD < 64 ? HD : 64;  // elements of a swizzled row
  static constexpr int kRB = 2 * kCB;            // its bytes: 128 (64 at hd 32)
  static constexpr int kNCB = HD / kCB;          // column blocks of a row
  static constexpr int kBK = HD == 256 ? 64 : 128;  // keys per tile
  // blocks per SM: two at hd <= 64 (at most 128 registers a thread, 80 KB
  // of shared memory each), so four warpgroups hide each other's softmax
  static constexpr int kMinBlocks = HD <= 64 ? 2 : 1;
  static constexpr int kQBytes = kQRows * HD * 2;
  static constexpr int kTileBytes = kBK * HD * 2;   // one K or V tile
  // Q, two stages of K, two of V, then the barriers: Q full, K full[2],
  // V full[2], empty[2]; 1024 bytes of slack to align the swizzle atoms
  static constexpr int kBarOff = kQBytes + 4 * kTileBytes;
  static constexpr int kSmem = kBarOff + 7 * 8 + 1024;
  // the descriptors' swizzle mode: 1 = 128-byte, 2 = 64-byte
  static constexpr uint64_t kSwizzle = kRB == 128 ? 1 : 2;
  static_assert(kBK % kBoxRows == 0 && HD % kCB == 0, "tile layout");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of the 3-D map (columns c0.., rows c1.., batch c2) into
// shared memory at dst; completion counted on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// `rows` rows (from row0) of the head at column col0, all HD columns, into
// a tile laid out as [column block][row][kCB elements], swizzled.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int col0, int row0,
                                          int b, int rows) {
  using C = Tc<HD>;
  for (int c = 0; c < C::kNCB; ++c)
    for (int r = 0; r < rows; r += kBoxRows)
      tma_load(dst + (c * rows + r) * C::kRB, map, bar, col0 + c * C::kCB,
               row0 + r, b);
}

// Key tile k0 .. k0 + kBK - 1 of K and of V into stage st, each counted on
// its own barrier, so that S = Q K^T can start before V has arrived.
template <int HD>
__device__ __forceinline__ void load_kv(int st, uint32_t sk, uint32_t sv,
                                        uint32_t k_full, uint32_t v_full,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int col0,
                                        int k0, int b) {
  using C = Tc<HD>;
  mbar_expect_tx(k_full + 8 * st, C::kTileBytes);
  load_tile<HD>(sk + st * C::kTileBytes, tk, k_full + 8 * st, col0, k0, b,
                C::kBK);
  mbar_expect_tx(v_full + 8 * st, C::kTileBytes);
  load_tile<HD>(sv + st * C::kTileBytes, tv, v_full + 8 * st, col0, k0, b,
                C::kBK);
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode. Every operand here is
// stored in swizzle atoms of 8 rows of kRB bytes, so the stride between
// 8-row groups (K-major: along M / N; MN-major: along K) is 8 * kRB. A
// K-major swizzled operand ignores the leading offset (1, as CUTLASS
// writes it); an MN-major one whose N is one atom wide, as each column
// block of V is, never steps to a next atom along N, so its leading
// offset is set to the same 8 * kRB.
template <int HD, bool kMnMajor>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  using C = Tc<HD>;
  constexpr uint64_t kStride = (8 * C::kRB) >> 4;
  constexpr uint64_t kLead = kMnMajor ? kStride : 1;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kLead << 16) |
         (kStride << 32) | (C::kSwizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from touching an accumulator across the asynchronous
// products: each register is redefined here, after the wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 64, f32) (+)= A (64 x 16) B (16 x 64); A and B bf16, K-major, in
// shared memory. accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) (+)= A (64 x 16) B (16 x 128); A and B bf16, K-major, in
// shared memory. accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 32, f32) += A (64 x 16, bf16 pairs in registers) B (16 x 32);
// B bf16, MN-major (the transpose bit), in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) B (16 x 64);
// B bf16, MN-major (the transpose bit), in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, Tc<HD>::kMinBlocks)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int s, int h, int hkv,
                float scale_log2, int causal, int window) {
  using C = Tc<HD>;
  constexpr int BK = C::kBK, CB = C::kCB, RB = C::kRB, NCB = C::kNCB;
  constexpr int NS = BK / 2;  // scores per thread (64 rows x BK keys)
  constexpr int NO = CB / 2;  // outputs per thread and column block
  constexpr int KPB = CB / 16;  // k-steps of 16 per column block
  extern __shared__ uint8_t smem_tc[];
  const uint32_t base = (smem_u32(smem_tc) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + C::kQBytes;
  const uint32_t sv = sk + 2 * C::kTileBytes;
  const uint32_t q_full = base + C::kBarOff;
  const uint32_t k_full = q_full + 8, v_full = q_full + 24;  // + 8 * stage
  const uint32_t empty = q_full + 40;                        // + 8 * stage

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  // the heaviest query tiles (last under a causal mask) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQRows;
  const int hh = blockIdx.y, b = blockIdx.z, hk = hh / (h / hkv);
  const int qw0 = q0 + 64 * wg;  // this warpgroup's first query row
  // the key tiles that meet the band of queries q0 .. q0 + kQRows - 1
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(s, q0 + kQRows) : s;
  const int kt0 = (lo / BK) * BK;
  const int nt = (hi - kt0 + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, 8);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_full, C::kQBytes);
    load_tile<HD>(sq, &tq, q_full, hh * HD, q0, b, kQRows);
    for (int j = 0; j < 2 && j < nt; ++j)
      load_kv<HD>(j & 1, sk, sv, k_full, v_full, &tk, &tv, hk * HD,
                  kt0 + j * BK, b);
  }
  __syncwarp();

  float acc[NCB][NO];
#pragma unroll
  for (int c = 0; c < NCB; ++c)
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[c][i] = 0.0f;
  // this thread's rows: r_lo and r_lo + 8 (accumulator fragment halves
  // i = 0, 1); its columns in each group of 8: cq and cq + 1
  const int r_lo = qw0 + 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const bool no_rows = qw0 >= s;
  const uint32_t sqw = sq + 64 * wg * RB;  // this warpgroup's Q rows

  mbar_wait(q_full, 0);
  for (int j = 0; j < nt; ++j) {
    const int st = j & 1, k0 = kt0 + j * BK;
    const uint32_t par = (j >> 1) & 1;
    const uint32_t skt = sk + st * C::kTileBytes, svt = sv + st * C::kTileBytes;
    // a tile none of this warpgroup's rows sees is waited for, not used
    const bool skip = no_rows || (causal && k0 > qw0 + 63) ||
                      (window > 0 && k0 + BK - 1 <= qw0 - window);
    mbar_wait(k_full + 8 * st, par);
    if (!skip) {
      // S = Q K^T
      float sc[NS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        // column block kk / KPB, 32 bytes per k-step within its rows
        const uint32_t blk = kk / KPB, off = (kk % KPB) * 32;
        const uint64_t da = desc<HD, false>(sqw + blk * kQRows * RB + off);
        const uint64_t db = desc<HD, false>(skt + blk * BK * RB + off);
        if constexpr (BK == 64)
          wgmma_ss_n64(sc, da, db, kk > 0);
        else
          wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);

      // scores times c = scale * log2(e), one multiplier for the scale and
      // exp2f's base; a tile that crosses the band's edge or the
      // sequence's end is masked. Score (i, jj, e) is sc[4 jj + 2 i + e]:
      // row r_lo + 8 i, key k0 + 8 jj + cq + e
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = __fmul_rn(sc[i], scale_log2);
      if (k0 + BK > s || (causal && k0 + BK - 1 > qw0) ||
          (window > 0 && k0 <= qw0 + 63 - window)) {
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kp = k0 + 8 * jj + cq + e, qp = r_lo + 8 * i;
              if (!(kp < s && (!causal || kp <= qp) &&
                    (window <= 0 || kp > qp - window)))
                sc[4 * jj + 2 * i + e] = -INFINITY;
            }
      }

      // online softmax: a row's max over its quad, P = 2^(s - m); a row
      // with no key yet (m = -inf) subtracts 0, so its P and alpha are 0
      float mx[2] = {-INFINITY, -INFINITY}, ms[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mx[i] = fmaxf(mx[i], fmaxf(sc[4 * jj + 2 * i],
                                     sc[4 * jj + 2 * i + 1]));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        ms[i] = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = exp2f(__fsub_rn(m[i], ms[i]));
        m[i] = m_new;
        l[i] = __fmul_rn(l[i], alpha);
#pragma unroll
        for (int c = 0; c < NCB; ++c)
#pragma unroll
          for (int jj = 0; jj < CB / 8; ++jj) {
            acc[c][4 * jj + 2 * i] = __fmul_rn(acc[c][4 * jj + 2 * i], alpha);
            acc[c][4 * jj + 2 * i + 1] =
                __fmul_rn(acc[c][4 * jj + 2 * i + 1], alpha);
          }
      }
      // O += P V, 16 keys per k-step: P in f32 for l, rounded once to bf16
      // for the product. The A fragment of k-step kk holds rows r_lo,
      // r_lo + 8 at keys 16 kk + cq, + 1 and 16 kk + 8 + cq, + 1:
      // sc[8 kk .. 8 kk + 7] in pairs. Each step's P is computed while the
      // previous steps' products run; V's column block c is an MN-major B
      // operand.
      mbar_wait(v_full + 8 * st, par);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = t & 1;  // fragment register t: row half i
          const float p0 = exp2f(__fsub_rn(sc[8 * kk + 2 * t], ms[i]));
          const float p1 = exp2f(__fsub_rn(sc[8 * kk + 2 * t + 1], ms[i]));
          sum[i] = __fadd_rn(sum[i], __fadd_rn(p0, p1));
          a[t] = pack_bf16(p0, p1);
        }
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NCB; ++c) {
          const uint64_t db =
              desc<HD, true>(svt + c * BK * RB + kk * 16 * RB);
          if constexpr (CB == 64)
            wgmma_rs_n64(acc[c], a, db);
          else
            wgmma_rs_n32(acc[c], a, db);
        }
      }
      l[0] = __fadd_rn(l[0], sum[0]);
      l[1] = __fadd_rn(l[1], sum[1]);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NCB; ++c) reg_fence(acc[c]);
    } else {
      mbar_wait(v_full + 8 * st, par);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
    if (tid == 0 && j + 2 < nt) {
      mbar_wait(empty + 8 * st, par);  // both warpgroups released tile j
      load_kv<HD>(st, sk, sv, k_full, v_full, &tk, &tv, hk * HD,
                  k0 + 2 * BK, b);
    }
    __syncwarp();
  }

  // out = O / l, a fully masked row (l == 0) gives 0; l summed over the quad
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 1));
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 2));
    const int row = r_lo + 8 * i;
    if (row >= s) continue;
    const float li = l[i] == 0.0f ? 1.0f : l[i];
    __nv_bfloat16* orow =
        o + ((static_cast<int64_t>(b) * s + row) * h + hh) * HD;
#pragma unroll
    for (int c = 0; c < NCB; ++c)
#pragma unroll
      for (int jj = 0; jj < CB / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(orow + c * CB + 8 * jj + cq) =
            __floats2bfloat162_rn(__fdiv_rn(acc[c][4 * jj + 2 * i], li),
                                  __fdiv_rn(acc[c][4 * jj + 2 * i + 1], li));
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda.so.1 the process has loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A (B, S, heads * HD) bf16 tensor as a 3-D TMA map of (64 rows, kCB
// columns) boxes, swizzled as wgmma reads them; rows past S lie outside
// the map and are filled with zeros.
template <int HD>
int make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads) {
  using C = Tc<HD>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr)
    return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * HD;
  const cuuint64_t dims[3] = {row, static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {row * 2, row * 2 * s};  // bytes
  const cuuint32_t box[3] = {C::kCB, kBoxRows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      C::kRB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o, int b,
              int s, int h, int hkv, float scale, int causal, int window,
              cudaStream_t st) {
  using C = Tc<HD>;
  CUtensorMap mq, mk, mv;
  int e = make_map<HD>(&mq, q, b, s, h);
  if (e == 0) e = make_map<HD>(&mk, k, b, s, hkv);
  if (e == 0) e = make_map<HD>(&mv, v, b, s, hkv);
  if (e != 0) return e;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((s + kQRows - 1) / kQRows, h, b);
  // the softmax's one multiplier: scale * log2(e), rounded once
  const float scale_log2 =
      static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  flash_fwd_wgmma<HD><<<grid, kTcThreads, C::kSmem, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), s, h, hkv, scale_log2,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int b, int s, int h, int hkv, float scale, int causal, int window,
           cudaStream_t st) {
  return dtype == 0 ? launch_f32<HD>(q, k, v, o, b, s, h, hkv, scale, causal,
                                     window, st)
                    : launch_tc<HD>(q, k, v, o, b, s, h, hkv, scale, causal,
                                    window, st);
}

}  // namespace

// C entry point, bound with ctypes: o = attention(q, k, v). dtype: 0
// float32 (flash_fwd_f32), 1 bfloat16 (flash_fwd_wgmma); hd in {32, 64,
// 128, 256}; every tensor contiguous and 16-byte aligned (the wrapper
// checks). Returns the first CUDA error (0 = success), or 10000 + the
// CUresult of a tensor map that could not be encoded.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int s,
                                      int h, int hkv, int hd, int dtype,
                                      int causal, int window, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch<32>(dtype, q, k, v, o, b, s, h, hkv, scale, causal,
                        window, st);
    case 64:
      return launch<64>(dtype, q, k, v, o, b, s, h, hkv, scale, causal,
                        window, st);
    case 128:
      return launch<128>(dtype, q, k, v, o, b, s, h, hkv, scale, causal,
                         window, st);
    case 256:
      return launch<256>(dtype, q, k, v, o, b, s, h, hkv, scale, causal,
                         window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
