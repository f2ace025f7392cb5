// RWKV6 (Finch) WKV recurrence over the sequence axis, per (batch, head)
// with head dim n and data-dependent per-channel decay:
//   y_t = r_t · (S_{t-1} + (u∘k_t) v_tᵀ);  S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_tᵀ
// with S_0 = 0, in float32.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_scan
// (_wkv_kernel, rwkv6_scan.py:23; pallas_call at :69), which carries the
// (n, n) state in VMEM across a sequential grid and takes one rank-1
// update per step. Here the kernel reads the model's layout and types
// directly: r, k, v (B, S, H, n) in float32 or bfloat16, log_w (B, S, H,
// n) float32, u (H * n) float32, out (B, S, H, n) float32.
//
// Bound on an H100 (67 TFLOP/s float32, 3.35 TB/s): per (token, head)
// the sequential form takes 5 n² + 5 n flops, which at rwkv6-7b's prefill
// (B 4, S 2048, 64 heads of 64) is 1.09e10 flops, 0.163 ms, against 470
// MB of inputs and output, 0.140 ms. A sequential kernel cannot get
// there: 2048 dependent steps of 4 issued operations per state entry.
//
// Design: the chunked form, with its products on the tensor cores.
// Chunks of C = 16 steps; within a chunk, with L_t the cumulative sum of
// log_w from the chunk's start (summed in float32 in step order, as the
// reference's rwkv_attention sums it) and m = 7 the chunk's middle step,
//   rd_t = r_t ∘ e^{L_{t-1} - L_m},  kd_s = k_s ∘ e^{L_m - L_s},
//   ra_t = rd_t ∘ e^{L_m},           ks_s = kd_s ∘ e^{L_C - L_m} (ks_15 = k_15),
//   A = rd kdᵀ masked to s < t, with r_t·(u∘k_t) on the diagonal,
//   y = A v + ra S,   S ← diag(e^{L_C}) S + ksᵀ v.
// The dependent chain falls from S steps to S / 16 chunks. One block per
// (batch, head) holds two groups of n / 16 warps, a two-stage pipeline
// with one barrier per chunk: the factor warps stage chunk c + 1's
// inputs (cp.async, two stages), take its factors (two expf per step and
// channel), split them into TF32 parts and compute its scores A (each
// warp a 16-key slice, the slices added in warp order), while the state
// warps take chunk c's output and state update. State
// warp w owns value columns 16w..16w+15 and keeps Sᵀ (value rows, key
// columns) in registers as mma.sync accumulators (n / 2 floats a lane).
// No accumulator goes through shared memory: Sᵀ's accumulator pairs
// (2q, 2q+1) are read as its own A fragment's k-slots (q, q+4), and the
// other operands are staged with their k rows in that order; the output
// is computed transposed, yᵀ = vᵀ Aᵀ + Sᵀ raᵀ.
//
// Why C = 16 and mma.sync, not wgmma: the factors e^{±(L - L_m)} must
// stay inside float32. The model clips log_w at -5, so a 16-step chunk
// spans at most 80 and each half at most 40; wgmma's 64-row tiles would
// need 64-step chunks, whose factors overflow. mma.sync.m16n8k8 in TF32
// takes exactly 16 rows.
//
// Precision. Every product runs in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi
// b_hi with hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi); a bf16 v is
// exact in TF32 and takes two passes (one TF32 pass is some 600x over the
// tolerance). The tensor cores add the products into the accumulator
// with truncation at the accumulator's exponent, so no small product is
// added inside them to a large sum: each 8-deep product starts from zero
// and is added in float32 (round to nearest) outside, and the state takes
// each chunk's update as S = fmaf(S, e^{L_C}, Δ), one rounding a chunk.
// e^{L_C}, which the state carries from chunk to chunk, is exp in
// float64 rounded once, so that its error does not build up with a
// bias.
//
// Steep decays: the factored form is taken only where every channel's
// half-chunk decays, -L_m and L_m - L_{C-2}, stay within kSteep = 64,
// so that no factor leaves e^{±64}. A chunk where some channel decays
// faster (never at the model's clip) runs its 16 steps as sequential
// rank-1 updates on the same registers, in plain float32, inside this
// kernel: the factor warps raise the flag for the whole chunk and hand
// over r, k, v and exp(log_w) in place of the factors.
//
// Rounding: the state is no longer bitwise the sequential plain
// version's (sums are reassociated, the decays multiplied as exp of a
// sum). Both are held to the same recurrence evaluated in float64
// (card_check.py), within the JAX suite's rtol / atol 2e-5. No atomics:
// two runs agree bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kC = 16;           // steps per chunk
constexpr int kMid = 7;          // the chunk's middle step m
constexpr int kStages = 2;       // raw input stages
constexpr float kSteep = 64.0f;  // steepest half-chunk decay factored

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// an In is exact in TF32 (one part, no lo)
template <typename In>
constexpr bool kExact = std::is_same_v<In, __nv_bfloat16>;

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b over one 16 x 8 x 8 tile, TF32 operands, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b with the B fragment's parts bh, bl: in 3xTF32, small terms
// first, or in two passes where a is exact (a bf16 v)
template <bool exact>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint2 bh,
                                     uint2 bl) {
  if constexpr (!exact) mma(d, al, bh.x, bh.y);
  mma(d, ah, bl.x, bl.y);
  mma(d, ah, bh.x, bh.y);
}

// d += one 8-deep product, summed from zero in the tensor cores and
// added to d in float32
template <bool exact>
__device__ __forceinline__ void add_tile(float (&d)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], uint2 bh,
                                         uint2 bl) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma3<exact>(t, ah, al, bh, bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], t[e]);
}

__device__ __forceinline__ uint2 ld2(const uint32_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool on) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(on ? 16 : 0));
}

// barrier 1 over the factor warps' `count` threads
__device__ __forceinline__ void factor_bar(int count) {
  asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");
}

// the same barrier, returning the OR of `pred` over those threads
__device__ __forceinline__ bool factor_bar_or(int count, bool pred) {
  uint32_t r;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.u32 q, %1, 0;\n\t"
      "bar.red.or.pred p, 1, %2, q;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(pred)), "r"(count)
      : "memory");
  return r != 0;
}

// keep H of the 2H sums b[0 .. 2H) (the upper half where `up`), adding
// in those of the lane `off` away
template <int H>
__device__ __forceinline__ void halve(float (&b)[8], bool up, int off) {
#pragma unroll
  for (int x = 0; x < H; ++x) {
    const float give = up ? b[x] : b[x + H];
    const float keep = up ? b[x + H] : b[x];
    b[x] = keep + __shfl_xor_sync(0xffffffffu, give, off);
  }
}

template <int N, typename In>
struct Smem {
  static constexpr int P = N + 8;   // row stride of the [t][i] tiles
  static constexpr int Q = kC + 8;  // row stride of the [i][s], [t][s] ones
  static constexpr int G = N < 32 ? 1 : N / 32;  // bonus partials a step
  static constexpr int V = kExact<In> ? 1 : 2;  // TF32 parts of v
  In raw[kStages][3][kC * N];       // r, k, v, [t][i]
  float lw[kStages][kC * N];        // log_w, [t][i]
  // a chunk handed from the factor warps to the state warps, two deep;
  // the [2] arrays hold TF32 parts (hi, lo)
  struct alignas(16) Hand {
    uint32_t ra[2][kC * P];         // [t][i]
    uint32_t ks[2][N * Q];          // [i][s]
    uint32_t vT[V][N * Q];          // [j][s]
    uint32_t A[2][kC * Q];          // masked scores with the bonus, [t][s]
    float dec[N];                   // e^{L_C}
    float bon[kC];                  // r_t·(u∘k_t)
    int steep;
  } hand[2];
  // the factor warps' own
  uint32_t rd[2][kC * P], kd[2][kC * P];  // [t][i]
  float pA[N / 16][kC * Q];         // scores, one partial a factor warp
  float part[kC * G];               // bonus partial sums
};

// two bf16 blocks share an SM (128 registers a thread); a float32 block
// needs more shared memory than half an SM has
template <int N, typename In>
__global__ void __launch_bounds__(4 * N, kExact<In> ? 2 : 1)
rwkv6_chunk_mma(const In* __restrict__ r, const In* __restrict__ k,
                const In* __restrict__ v, const float* __restrict__ log_w,
                const float* __restrict__ u, float* __restrict__ out, int s,
                int h) {
  static_assert(N % 16 == 0, "a warp owns 16 value columns");
  using Sm = Smem<N, In>;
  constexpr int P = Sm::P, Q = Sm::Q, G = Sm::G;
  constexpr int kGroup = N < 32 ? N : 32;  // factor lanes of one bonus sum
  constexpr int kFactor = 2 * N;           // factor threads, 2 a channel
  constexpr int NT = N / 8;                // 8-wide key tiles of the state
  constexpr bool kExactV = kExact<In>;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_bytes);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4, q = lane % 4;  // mma group, thread in group
  const int hh = blockIdx.x % h;
  const int stride = h * N;  // one step
  {                          // this (batch, head)'s first element
    const int64_t base =
        (static_cast<int64_t>(blockIdx.x / h) * s * h + hh) * N;
    r += base, k += base, v += base, log_w += base, out += base;
  }
  const int nch = (s + kC - 1) / kC;

  if (tid >= 2 * N) {
    // ============ factor warps: chunk it, one chunk ahead ===============
    const int ft = tid - 2 * N, fw = ft / 32;
    const int ci = ft % N, half = ft / N;  // channel; steps 8 half + 0..7
    const float uc = u[hh * N + ci];

    auto fetch = [&](int c) {
      constexpr int kRowIn = N * static_cast<int>(sizeof(In)) / 16;
      constexpr int kRowW = N * 4 / 16;
      const int t0 = c * kC, st = c % kStages;
      for (int p = ft; p < 3 * kC * kRowIn; p += kFactor) {
        const int a = p / (kC * kRowIn), t = (p / kRowIn) % kC;
        const int e = (p % kRowIn) * (16 / static_cast<int>(sizeof(In)));
        const In* src = a == 0 ? r : (a == 1 ? k : v);
        const bool on = t0 + t < s;
        cp16(&sm.raw[st][a][t * N + e],
             src + (on ? static_cast<int64_t>(t0 + t) * stride + e : 0), on);
      }
      for (int p = ft; p < kC * kRowW; p += kFactor) {
        const int t = p / kRowW, e = (p % kRowW) * 4;
        const bool on = t0 + t < s;
        cp16(&sm.lw[st][t * N + e],
             log_w + (on ? static_cast<int64_t>(t0 + t) * stride + e : 0),
             on);
      }
      asm volatile("cp.async.commit_group;");
    };

    fetch(0);
    for (int it = 0; it <= nch; ++it) {
      if (it < nch) {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        factor_bar(kFactor);  // chunk it staged for every factor thread
        if (it + 1 < nch) fetch(it + 1);
        const int st = it % kStages;
        const In* sr = sm.raw[st][0];
        const In* sk = sm.raw[st][1];
        const In* sv = sm.raw[st][2];
        const float* sw = sm.lw[st];
        auto& hd = sm.hand[it & 1];

        float L[kC];
        {
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < kC; ++t) {
            acc = __fadd_rn(acc, sw[t * N + ci]);
            L[t] = acc;
          }
        }
        const float Lm = L[kMid], LC = L[kC - 1];
        const bool steep =
            Lm < -kSteep || __fsub_rn(L[kC - 2], Lm) < -kSteep;
        const float em = expf(Lm), ecm = expf(__fsub_rn(LC, Lm));
        if (half == 0)  // exp in float64, rounded once
          hd.dec[ci] = static_cast<float>(exp(static_cast<double>(LC)));
        // this half's L_{t-1} (Lh[tt]) and L_t (Lh[tt + 1])
        float Lh[kC / 2 + 1];
#pragma unroll
        for (int tt = 0; tt <= kC / 2; ++tt)
          Lh[tt] = half ? L[kC / 2 - 1 + tt] : (tt ? L[tt - 1] : 0.0f);
        float bb[8];
#pragma unroll
        for (int tt = 0; tt < kC / 2; ++tt) {
          const int t = half * (kC / 2) + tt;
          const float Lt = Lh[tt + 1], Lp = Lh[tt];
          const float rv = to_float(sr[t * N + ci]);
          const float kv = to_float(sk[t * N + ci]);
          const float vv = to_float(sv[t * N + ci]);
          const float rd = rv * expf(__fsub_rn(Lp, Lm));
          const float kd =
              t == kC - 1 ? 0.0f : kv * expf(__fsub_rn(Lm, Lt));
          split(rd, sm.rd[0][t * P + ci], sm.rd[1][t * P + ci]);
          split(kd, sm.kd[0][t * P + ci], sm.kd[1][t * P + ci]);
          split(rd * em, hd.ra[0][t * P + ci], hd.ra[1][t * P + ci]);
          split(t == kC - 1 ? kv : kd * ecm, hd.ks[0][ci * Q + t],
                hd.ks[1][ci * Q + t]);
          if constexpr (kExactV)
            hd.vT[0][ci * Q + t] = __float_as_uint(vv);
          else
            split(vv, hd.vT[0][ci * Q + t], hd.vT[Sm::V - 1][ci * Q + t]);
          bb[tt] = rv * uc * kv;
        }
        // r_t·(u∘k_t) over the kGroup lanes of this half: three halvings
        // leave a lane one step's sum, step 4 u1 + 2 u2 + u3 of the half
        const bool u1 = lane & (kGroup / 2), u2 = lane & (kGroup / 4),
                   u3 = lane & (kGroup / 8);
        halve<4>(bb, u1, kGroup / 2);
        halve<2>(bb, u2, kGroup / 4);
        halve<1>(bb, u3, kGroup / 8);
#pragma unroll
        for (int off = kGroup / 16; off > 0; off >>= 1)
          bb[0] += __shfl_xor_sync(0xffffffffu, bb[0], off);
        if (lane % (kGroup / 8) == 0)
          sm.part[(half * 8 + 4 * u1 + 2 * u2 + u3) * G + ci / kGroup] =
              bb[0];
        const bool any_steep = factor_bar_or(kFactor, steep);
        if (ft < kC) {
          float b = sm.part[ft * G];
#pragma unroll
          for (int p = 1; p < G; ++p) b += sm.part[ft * G + p];
          hd.bon[ft] = b;
        }
        if (ft == 0) hd.steep = any_steep;
        if (any_steep) {
          // the sequential branch's inputs in place of the factors: w =
          // exp(log_w) and r [t][i], k [i][t], v [j][t], as float32
#pragma unroll
          for (int tt = 0; tt < kC / 2; ++tt) {
            const int t = half * (kC / 2) + tt;
            hd.ra[0][t * P + ci] = __float_as_uint(expf(sw[t * N + ci]));
            hd.ra[1][t * P + ci] = __float_as_uint(to_float(sr[t * N + ci]));
            hd.ks[0][ci * Q + t] = __float_as_uint(to_float(sk[t * N + ci]));
            hd.vT[0][ci * Q + t] = __float_as_uint(to_float(sv[t * N + ci]));
          }
        } else {
          // ---- the scores A = rd kdᵀ (rows t, columns s), K = channels:
          //      factor warp fw sums keys 16fw..16fw+15, and the partials
          //      are added in warp order
          float A[2][4] = {};
#pragma unroll
          for (int kx = 0; kx < 2; ++kx) {
            // A fragment: (t = g / g+8, slot q = key 8kk+2q), q+4: +1
            const int i0 = 8 * (2 * fw + kx) + 2 * q;
            const uint2 x0h = ld2(&sm.rd[0][g * P + i0]);
            const uint2 x1h = ld2(&sm.rd[0][(g + 8) * P + i0]);
            const uint2 x0l = ld2(&sm.rd[1][g * P + i0]);
            const uint2 x1l = ld2(&sm.rd[1][(g + 8) * P + i0]);
            const uint32_t ah[4] = {x0h.x, x1h.x, x0h.y, x1h.y};
            const uint32_t al[4] = {x0l.x, x1l.x, x0l.y, x1l.y};
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              add_tile<false>(A[nt], ah, al,
                              ld2(&sm.kd[0][(8 * nt + g) * P + i0]),
                              ld2(&sm.kd[1][(8 * nt + g) * P + i0]));
          }
          // A[nt][e] is (t = g + 8 (e / 2), s = 8 nt + 2q + e % 2)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float* pa = &sm.pA[fw][g * Q + 8 * nt + 2 * q];
            *reinterpret_cast<float2*>(pa) = make_float2(A[nt][0], A[nt][1]);
            *reinterpret_cast<float2*>(pa + 8 * Q) =
                make_float2(A[nt][2], A[nt][3]);
          }
          factor_bar(kFactor);
          // the causal mask and the bonus on the diagonal, split
          for (int x = ft; x < kC * kC; x += kFactor) {
            const int t = x / kC, sj = x % kC;
            float a = sm.pA[0][t * Q + sj];
#pragma unroll
            for (int w = 1; w < N / 16; ++w) a += sm.pA[w][t * Q + sj];
            if (sj == t) {
              a = sm.part[t * G];
#pragma unroll
              for (int p = 1; p < G; ++p) a += sm.part[t * G + p];
            }
            split(sj <= t ? a : 0.0f, hd.A[0][t * Q + sj],
                  hd.A[1][t * Q + sj]);
          }
        }
      }
      __syncthreads();  // chunk it handed over; chunk it - 1 consumed
    }
    return;
  }

  // ================== state warps: chunk it - 1 ============================
  const int warp = tid / 32;
  const int j0 = 16 * warp + g, j1 = j0 + 8;  // this lane's value rows
  float S[NT][4];  // Sᵀ: [nt][.] = (j0, 8nt+2q), (j0, +1), (j1, ..), (j1, +1)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    S[nt][0] = S[nt][1] = S[nt][2] = S[nt][3] = 0.0f;

  for (int it = 0; it <= nch; ++it) {
    if (it > 0) {
      const int c = it - 1, t0 = c * kC;
      const auto& hd = sm.hand[c & 1];
      if (hd.steep) {
        // ---- a steep chunk: 16 sequential rank-1 steps, plain float32
        const float* w = reinterpret_cast<const float*>(hd.ra[0]);
        const float* rt = reinterpret_cast<const float*>(hd.ra[1]);
        const float* kt = reinterpret_cast<const float*>(hd.ks[0]);
        const float* vt = reinterpret_cast<const float*>(hd.vT[0]);
        for (int t = 0; t < kC; ++t) {
          const float bonus = hd.bon[t];
          const float v0 = vt[j0 * Q + t], v1 = vt[j1 * Q + t];
          float y0 = 0.0f, y1 = 0.0f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float2 r01 =
                *reinterpret_cast<const float2*>(&rt[t * P + 8 * nt + 2 * q]);
            y0 = fmaf(r01.x, S[nt][0], y0);
            y0 = fmaf(r01.y, S[nt][1], y0);
            y1 = fmaf(r01.x, S[nt][2], y1);
            y1 = fmaf(r01.y, S[nt][3], y1);
          }
          y0 += __shfl_xor_sync(0xffffffffu, y0, 1);
          y0 += __shfl_xor_sync(0xffffffffu, y0, 2);
          y1 += __shfl_xor_sync(0xffffffffu, y1, 1);
          y1 += __shfl_xor_sync(0xffffffffu, y1, 2);
          if (q == 0 && t0 + t < s) {
            float* o = out + static_cast<int64_t>(t0 + t) * stride;
            o[j0] = fmaf(bonus, v0, y0);
            o[j1] = fmaf(bonus, v1, y1);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int i = 8 * nt + 2 * q;
            const float2 w01 = *reinterpret_cast<const float2*>(&w[t * P + i]);
            const float k0 = kt[i * Q + t], k1 = kt[(i + 1) * Q + t];
            S[nt][0] = __fadd_rn(__fmul_rn(w01.x, S[nt][0]), __fmul_rn(k0, v0));
            S[nt][1] = __fadd_rn(__fmul_rn(w01.y, S[nt][1]), __fmul_rn(k1, v0));
            S[nt][2] = __fadd_rn(__fmul_rn(w01.x, S[nt][2]), __fmul_rn(k0, v1));
            S[nt][3] = __fadd_rn(__fmul_rn(w01.y, S[nt][3]), __fmul_rn(k1, v1));
          }
        }
      } else {
        // vᵀ as the A operand (rows j, k-slots q / q+4 = steps 2q / 2q+1)
        uint32_t vh[2][4], vl[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int o0 = j0 * Q + 8 * kk + 2 * q, o1 = j1 * Q + 8 * kk + 2 * q;
          const uint2 a0 = ld2(&hd.vT[0][o0]), a1 = ld2(&hd.vT[0][o1]);
          vh[kk][0] = a0.x, vh[kk][1] = a1.x, vh[kk][2] = a0.y;
          vh[kk][3] = a1.y;
          if constexpr (!kExactV) {
            const uint2 b0 = ld2(&hd.vT[Sm::V - 1][o0]);
            const uint2 b1 = ld2(&hd.vT[Sm::V - 1][o1]);
            vl[kk][0] = b0.x, vl[kk][1] = b1.x, vl[kk][2] = b0.y;
            vl[kk][3] = b1.y;
          }
        }

        // ---- yᵀ = vᵀ Aᵀ + Sᵀ raᵀ (rows j, columns t) ----
        float Y[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            // Aᵀ's B fragment: (k-slot q = step 8kk+2q, t = 8nt+g), q+4: +1
            const int o = (8 * nt + g) * Q + 8 * kk + 2 * q;
            mma3<kExactV>(Y[nt], vh[kk], vl[kk], ld2(&hd.A[0][o]),
                          ld2(&hd.A[1][o]));
          }
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          // Sᵀ's accumulator as the A fragment: slot q = key 8kk+2q, q+4: +1
          uint32_t ah[4], al[4];
          split(S[kk][0], ah[0], al[0]);
          split(S[kk][2], ah[1], al[1]);
          split(S[kk][1], ah[2], al[2]);
          split(S[kk][3], ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int o = (8 * nt + g) * P + 8 * kk + 2 * q;
            add_tile<false>(Y[nt], ah, al, ld2(&hd.ra[0][o]),
                            ld2(&hd.ra[1][o]));
          }
        }
        // Y[nt][e] is (j = j0 or j1, t = 8 nt + 2q + e % 2)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = t0 + 8 * nt + 2 * q + e % 2;
            if (t < s)
              out[static_cast<int64_t>(t) * stride + (e < 2 ? j0 : j1)] =
                  Y[nt][e];
          }

        // ---- Sᵀ ← Sᵀ diag(e^{L_C}) + vᵀ ks (rows j, columns i) ----
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float D[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            // ks's B fragment: (k-slot q = step 8kk+2q, key 8nt+g), q+4: +1
            const int o = (8 * nt + g) * Q + 8 * kk + 2 * q;
            mma3<kExactV>(D, vh[kk], vl[kk], ld2(&hd.ks[0][o]),
                          ld2(&hd.ks[1][o]));
          }
          const float2 d =
              *reinterpret_cast<const float2*>(&hd.dec[8 * nt + 2 * q]);
          S[nt][0] = fmaf(S[nt][0], d.x, D[0]);
          S[nt][1] = fmaf(S[nt][1], d.y, D[1]);
          S[nt][2] = fmaf(S[nt][2], d.x, D[2]);
          S[nt][3] = fmaf(S[nt][3], d.y, D[3]);
        }
      }
    }
    __syncthreads();  // chunk it - 1 consumed; chunk it handed over
  }
}

template <int N, typename In>
int launch(const void* r, const void* k, const void* v, const float* log_w,
           const float* u, float* out, int b, int s, int h,
           cudaStream_t st) {
  const int bytes = static_cast<int>(sizeof(Smem<N, In>));
  auto kern = rwkv6_chunk_mma<N, In>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<b * h, 4 * N, bytes, st>>>(
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
// contiguous and 16-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launch (0 = success).
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
