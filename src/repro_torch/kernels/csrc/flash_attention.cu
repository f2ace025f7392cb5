// Online-softmax attention over one (batch, query head, 64-query tile)
// per block: causal, sliding window, GQA/MQA, keys beyond the sequence
// masked, float32 accumulation.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_attn_kernel, flash_attention.py:30; pallas_call at :107). It computes
// what the TPU kernel computes, in the reference's layout: q (B, S, H, hd),
// k and v (B, S, Hkv, hd), float32 or bfloat16, out (B, S, H, hd) in q's
// type. Query head h reads key/value head h / (H / Hkv). A key is masked
// unless key < S, and key <= query (causal), and key > query - window
// (window > 0). Scores are float32 products of the inputs summed in
// float32, times the scale after the dot; the running max, sum and the
// (64, hd) accumulator stay float32, and the probabilities enter the PV
// product in float32. A row with no key left gives 0.
//
// Bound on an H100 (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s float32,
// 3.35 TB/s): operations. recurrentgemma-2b's prefill (B 4, S 3072, 10
// heads, MQA, hd 256, window 2048) has 4,195,328 (query, key) pairs per
// (batch, head) in its band, 1.72e11 flops: 0.17 ms at the bf16
// tensor-core peak, 2.6 ms at the float32 peak this kernel computes at.
//
// Design, simple first: 256 threads; the block's Q tile (64 rows), one K
// tile and one V tile (64 keys each) sit in shared memory in the input
// type, Q and K rows padded by one 32-bit word so that the column reads
// of the score loop hit distinct banks; each thread owns 4 query rows x 4
// keys of the score tile and 4 query rows x hd/16 columns of the
// accumulator; a row's max and sum are reduced over its 16 threads with
// warp shuffles; the probabilities go through shared memory (in the K
// tile's place, once the scores are done) to the PV loop. Only key tiles
// that meet the causal / window band of the query tile are visited (the
// TPU grid visits every tile and masks it): at the serving shape that is
// 2.25x fewer pairs. The products are explicit fmaf; no library call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;      // query rows per block
constexpr int kBK = 64;      // keys per tile
constexpr int kPS = kBQ + 4;  // row stride (floats) of the probability tile
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

// The input type's 32-bit words: elements per word and their float values.
template <typename T>
struct Words;

template <>
struct Words<float> {
  static constexpr int kPerWord = 1;
  __device__ __forceinline__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w);
  }
  __device__ __forceinline__ static uint32_t pack(const float* f) {
    return __float_as_uint(f[0]);
  }
};

template <>
struct Words<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  // element 2i in the low half, 2i + 1 in the high half (little endian)
  __device__ __forceinline__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static uint32_t pack(const float* f) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[0]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(f[1]));
    return lo | (hi << 16);
  }
};

template <typename T, int HD>
struct Tile {
  static constexpr int kEPW = Words<T>::kPerWord;
  static constexpr int kWPR = HD / kEPW;   // 32-bit words per row
  static constexpr int kQW = kWPR + 1;     // padded row stride, words
  static constexpr int kWPT = kWPR / 16;   // accumulator words per thread
  static constexpr int kKWords =
      (kBK * kQW > kBK * kPS) ? kBK * kQW : kBK * kPS;
  static constexpr int kSmemWords = kBQ * kQW + kKWords + kBK * kWPR;
  static_assert(kWPR % 16 == 0, "head_dim too small for the tile layout");
};

// Copy `rows` rows of hd elements (row r at src + r * stride elements,
// rows >= valid read as zeros) into shared memory at a row stride of
// `sw` words. Consecutive threads take consecutive rows, so the word
// stores of a warp land in distinct banks (sw is odd).
template <typename T, int HD>
__device__ __forceinline__ void load_rows(uint32_t* dst, int sw,
                                          const T* __restrict__ src,
                                          int64_t stride, int rows,
                                          int valid) {
  constexpr int kVPR = Tile<T, HD>::kWPR / 4;  // 16-byte vectors per row
  for (int f = threadIdx.x; f < rows * kVPR; f += kThreads) {
    const int r = f % rows, v = f / rows;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      x = reinterpret_cast<const uint4*>(src + r * stride)[v];
    uint32_t* d = dst + r * sw + 4 * v;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int s, int h, int hkv,
          float scale, int causal, int window) {
  using L = Tile<T, HD>;
  constexpr int EPW = L::kEPW, QW = L::kQW, WPR = L::kWPR, WPT = L::kWPT;
  extern __shared__ uint32_t smem[];
  uint32_t* qs = smem;                      // (kBQ, QW)
  uint32_t* ks = qs + kBQ * QW;             // (kBK, QW)
  float* pt = reinterpret_cast<float*>(ks);  // (kBK, kPS), after the scores
  uint32_t* vs = ks + L::kKWords;           // (kBK, WPR)

  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  // the heaviest query tiles (last under a causal mask) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int hh = blockIdx.y, b = blockIdx.z, hk = hh / (h / hkv);
  const int64_t qstride = static_cast<int64_t>(h) * HD;
  const int64_t kstride = static_cast<int64_t>(hkv) * HD;
  const T* qb = q + (static_cast<int64_t>(b) * s + q0) * qstride +
                static_cast<int64_t>(hh) * HD;
  const T* kb = k + static_cast<int64_t>(b) * s * kstride +
                static_cast<int64_t>(hk) * HD;
  const T* vb = v + static_cast<int64_t>(b) * s * kstride +
                static_cast<int64_t>(hk) * HD;

  load_rows<T, HD>(qs, QW, qb, qstride, kBQ, s - q0);

  float m[4], l[4], acc[4][WPT * EPW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < WPT * EPW; ++j) acc[i][j] = 0.0f;
  }

  // the key tiles that meet the band of queries q0 .. q0 + kBQ - 1
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(s, q0 + kBQ) : s;
  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();  // the previous tile's V and P reads are done
    load_rows<T, HD>(ks, QW, kb + k0 * kstride, kstride, kBK, s - k0);
    load_rows<T, HD>(vs, WPR, vb + k0 * kstride, kstride, kBK, s - k0);
    __syncthreads();

    // scores of rows 4r .. 4r+3 against keys c, c+16, c+32, c+48
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int w = 0; w < WPR; ++w) {
      float qf[4][EPW], kf[4][EPW];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Words<T>::unpack(qs[(4 * r + i) * QW + w], qf[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Words<T>::unpack(ks[(c + 16 * j) * QW + w], kf[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < EPW; ++e)
            sc[i][j] = fmaf(qf[i][e], kf[j][e], sc[i][j]);
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
      for (int j = 0; j < WPT * EPW; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // every thread is done reading the K tile
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (c + 16 * j) * kPS + 4 * r) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    // acc[rows 4r..4r+3][words c, c+16, ...] += P V
    const int nk = min(kBK, s - k0);
    for (int j = 0; j < nk; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(pt + j * kPS + 4 * r);
      const float pr[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
      for (int t = 0; t < WPT; ++t) {
        float vf[EPW];
        Words<T>::unpack(vs[j * WPR + c + 16 * t], vf);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < EPW; ++e)
            acc[i][t * EPW + e] = fmaf(pr[i], vf[e], acc[i][t * EPW + e]);
      }
    }
  }

  // out = acc / l, a fully masked row (l == 0) gives 0
  uint32_t* ob = reinterpret_cast<uint32_t*>(
      o + (static_cast<int64_t>(b) * s + q0) * qstride +
      static_cast<int64_t>(hh) * HD);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * r + i;
    if (q0 + row >= s) continue;
    const float li = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int t = 0; t < WPT; ++t) {
      float f[EPW];
#pragma unroll
      for (int e = 0; e < EPW; ++e) f[e] = acc[i][t * EPW + e] / li;
      ob[row * (qstride / EPW) + c + 16 * t] = Words<T>::pack(f);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s, int h, int hkv, float scale, int causal, int window,
           cudaStream_t st) {
  const size_t smem = Tile<T, HD>::kSmemWords * sizeof(uint32_t);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((s + kBQ - 1) / kBQ, h, b);
  flash_fwd<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, h, hkv, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int b, int s, int h, int hkv, float scale, int causal,
              int window, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, s, h, hkv, scale, causal, window, st);
    case 64:
      return launch<T, 64>(q, k, v, o, b, s, h, hkv, scale, causal, window, st);
    case 128:
      return launch<T, 128>(q, k, v, o, b, s, h, hkv, scale, causal, window,
                            st);
    case 256:
      return launch<T, 256>(q, k, v, o, b, s, h, hkv, scale, causal, window,
                            st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry point, bound with ctypes: o = attention(q, k, v). dtype: 0
// float32, 1 bfloat16; hd in {32, 64, 128, 256}; every tensor contiguous
// and 16-byte aligned (the wrapper checks). Returns the first CUDA error
// (0 = success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int s,
                                      int h, int hkv, int hd, int dtype,
                                      int causal, int window, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, b, s, h, hkv, scale, causal,
                            window, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, b, s, h, hkv, scale,
                                    causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
