// Fused local optimizer step (+ optional worker average) on the (M, P)
// f32 parameter plane, with the Eq. 4 dispersion of the updated plane.
//
// Replaces the TPU kernel repro/kernels/opt_step.py::opt_step
// (_opt_step_kernel, opt_step.py:46; pallas_call at :319) for kinds
// sgd / momentum (+- Nesterov) / adamw, modes none / mean / group / mix,
// with optional per-column bf16/f16 rounding codes. Mode mix (the TPU
// kernel's :153-161) applies the doubly-stochastic (M, M) W to the
// updated column; the dispersion stays the pre-mix one. The compressed
// `wire` path (:101-149) is this kernel in mode none followed by the
// compressed event of compressed_mix.cu on the updated plane (see the
// opt_step wrapper): the update is written once and the event reads it,
// so nothing is updated twice.
//
// Bound on an H100 (3.35 TB/s) at the main path's shape, M = 4 workers,
// P = 361,821,120 (smollm-360m): the pass is memory bound. Momentum with
// an f32 codes row reads x, g, v and the codes and writes x and v:
// 5 * M * P * 4 + P * 4 = 30.39 GB, 9.07 ms. SGD moves 18.81 GB
// (5.61 ms), AdamW 41.97 GB (12.53 ms). It does about 10 flops per
// element, far below the 295 flop/byte ridge; mode mix adds 2 M flops per
// element (8 at M = 4), still far below it, and the same bytes plus W.
//
// Design against that bound: every byte is touched once. One thread owns
// one column and loops over the M rows, so the column's updated values
// stay in registers (an M <= 64 array, fully unrolled at a compile-time
// bound MAXM, so it never goes to local memory) for the mean, the
// dispersion term sum_i (u_i - mean)^2 and the broadcast or the mix;
// nothing is re-read. In mode mix the block stages W (at most 64 x 64
// f32, 16 KB) in shared memory once, and each thread computes
// out_i = sum_j W_ij u_j in j order from its registers; every thread of
// a warp reads the same W entry, a shared-memory broadcast. Neighbouring
// threads own neighbouring columns, so each row access of a warp is one
// coalesced 128-byte line. x and the state planes are updated IN PLACE
// (the caller must hold no other reference to the old planes): at full
// width that saves 11.6 GB of transient memory against writing new
// planes. The ragged last block is masked, not padded. Offsets are
// 64-bit: M * P exceeds 2^31 at M >= 6.
//
// Dispersion: one partial per block in a fixed tree order, then a fixed
// single-block pass sums the partials (in double) and divides by M — no
// atomics, so two runs give the same bits. Built with -fmad=false so
// every product and sum rounds as PyTorch's separate eager ops do.
//
// The fault-degraded pass (the TPU wrapper's `alive` / `umask` branch,
// opt_step.py:227-258) is the same kernel, instantiated with MASKED: two
// 64-bit row masks passed by value, `update` (umask) and `alive` (the
// event's cohort). Rows outside `update` are not stepped: their g and
// state are not read, their x and state not written, and their u is the
// old x, read only for an alive row (the reference's select_rows(upd,
// plane, umask)). The dispersion is over the alive rows, divided by their
// count; modes mean / group write the exact masked (group) mean of the
// alive rows to the alive rows, mode mix the degraded W's rows; an updated
// row outside the cohort keeps its step, and a row in neither mask is
// neither read nor written. So a masked step is one pass, in place, that
// moves only the rows it needs: at full width with one dead row
// (Momentum, bf16 codes) 16 row-planes, 23.2 GB (6.9 ms), in every mode.
// The unmasked instantiation is the code above the masks unchanged.
#include "plane_common.cuh"

namespace {

enum Kind { kSgd = 0, kMomentum = 1, kAdamw = 2 };
enum Mode { kNone = 0, kMean = 1, kGroup = 2, kMix = 3 };

struct Hyper {
  float lr, c1, c2, mu, b1, omb1, b2, omb2, eps, wd;
  int nesterov;
};

// The fault-degraded pass's rows (MASKED instantiations only): `update`
// the rows that take the optimizer step, `alive` the event's cohort and
// the rows the dispersion is over, `n_alive` its row count.
struct RowMasks {
  unsigned long long alive, update;
  float n_alive;
};

template <int MAXM, int KIND, bool MASKED>
__global__ void __launch_bounds__(kPlaneThreads)
opt_step_cols(float* __restrict__ x, const float* __restrict__ g,
              float* __restrict__ s0, float* __restrict__ s1,
              const float* __restrict__ codes, const float* __restrict__ w,
              float* __restrict__ dpart, int m, int64_t p, int mode,
              int groups, Hyper h, RowMasks rm) {
  __shared__ float sw[MAXM * MAXM];
  if (mode == kMix) stage_matrix(w, m, sw);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kPlaneThreads +
                    threadIdx.x;
  float dsq = 0.0f;
  if (j < p) {
    const float code = codes != nullptr ? codes[j] : 0.0f;
    float u[MAXM];
#pragma unroll
    for (int i = 0; i < MAXM; ++i) {
      if (i < m) {
        const int64_t o = static_cast<int64_t>(i) * p + j;
        if (MASKED && !row_on(rm.update, i)) {
          // no step: g and the state are not read; the old x only where
          // the event and the dispersion need it
          if (row_on(rm.alive, i)) u[i] = x[o];
          continue;
        }
        const float xi = x[o];
        const float gi = g[o];
        float upd;
        if (KIND == kSgd) {
          upd = xi - h.lr * gi;
        } else if (KIND == kMomentum) {
          const float v = h.mu * s0[o] + gi;
          s0[o] = v;
          upd = xi - h.lr * (h.nesterov ? gi + h.mu * v : v);
        } else {
          const float m2 = h.b1 * s0[o] + h.omb1 * gi;
          const float v2 = h.b2 * s1[o] + (h.omb2 * gi) * gi;
          s0[o] = m2;
          s1[o] = v2;
          const float d = (m2 / h.c1) / (sqrtf(v2 / h.c2) + h.eps);
          upd = xi - h.lr * (d + h.wd * xi);
        }
        u[i] = round_code(upd, code);
      }
    }
    if constexpr (MASKED) {
      masked_column_mean_dsq(u, m, rm.alive, rm.n_alive, &dsq);
      // every updated row takes its step; the event then overwrites its
      // cohort, so an updated row outside it (a rejoining worker's solo
      // window) keeps the step, and a row in neither mask is not written
#pragma unroll
      for (int i = 0; i < MAXM; ++i)
        if (i < m && row_on(rm.update, i) &&
            (mode == kNone || !row_on(rm.alive, i)))
          x[static_cast<int64_t>(i) * p + j] = u[i];
      if (mode == kMix) {
#pragma unroll 1
        for (int i = 0; i < m; ++i)
          if (row_on(rm.alive, i))
            x[static_cast<int64_t>(i) * p + j] =
                round_code(masked_mix_row(u, sw, m, i, rm.alive), code);
      } else if (mode != kNone) {
        write_masked_means(u, m, mode == kGroup ? m / groups : m, rm.alive,
                           code, x, p, j);
      }
    } else {
      const float mean = column_mean_dsq(u, m, &dsq);
      if (mode == kNone) {
#pragma unroll
        for (int i = 0; i < MAXM; ++i)
          if (i < m) x[static_cast<int64_t>(i) * p + j] = u[i];
      } else if (mode == kMix) {
        // the column was read whole above, so it is overwritten in place
#pragma unroll 1
        for (int i = 0; i < m; ++i)
          x[static_cast<int64_t>(i) * p + j] =
              round_code(mix_row(u, sw, m, i), code);
      } else if (mode == kMean || groups == 1) {
        const float out = round_code(mean, code);
#pragma unroll
        for (int i = 0; i < MAXM; ++i)
          if (i < m) x[static_cast<int64_t>(i) * p + j] = out;
      } else {
        const int gs = m / groups;
        for (int k = 0; k < groups; ++k) {
          const int lo = k * gs, hi = lo + gs;
          float gsum = 0.0f;
#pragma unroll
          for (int i = 0; i < MAXM; ++i)
            if (i >= lo && i < hi) gsum += u[i];
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

template <int MAXM, bool MASKED>
void launch_kind(int kind, dim3 grid, cudaStream_t st, float* x,
                 const float* g, float* s0, float* s1, const float* codes,
                 const float* w, float* dpart, int m, int64_t p, int mode,
                 int groups, Hyper h, RowMasks rm) {
  if (kind == kSgd)
    opt_step_cols<MAXM, kSgd, MASKED><<<grid, kPlaneThreads, 0, st>>>(
        x, g, s0, s1, codes, w, dpart, m, p, mode, groups, h, rm);
  else if (kind == kMomentum)
    opt_step_cols<MAXM, kMomentum, MASKED><<<grid, kPlaneThreads, 0, st>>>(
        x, g, s0, s1, codes, w, dpart, m, p, mode, groups, h, rm);
  else
    opt_step_cols<MAXM, kAdamw, MASKED><<<grid, kPlaneThreads, 0, st>>>(
        x, g, s0, s1, codes, w, dpart, m, p, mode, groups, h, rm);
}

}  // namespace

// C entry point, bound with ctypes. Pointers are device pointers on the
// caller's stream; s1 / codes / w may be null where unused (w is the
// row-major (m, m) mixing matrix of mode mix; under masks the degraded
// one). dpart holds ceil(P / 256) floats of scratch; disp receives the
// Eq. 4 dispersion. masked != 0 runs the fault-degraded pass: bit i of
// `alive` / `update` is row i's (the event's cohort / the rows that take
// the step), and the dispersion is over the alive rows. Returns
// cudaGetLastError() after both launches (0 = success).
extern "C" int opt_step_launch(
    float* x, const float* g, float* s0, float* s1, const float* codes,
    const float* w, float* dpart, float* disp, int m, long long p,
    int kind, int mode,
    int groups, float lr, float c1, float c2, float mu, int nesterov,
    float b1, float omb1, float b2, float omb2, float eps, float wd,
    int masked, unsigned long long alive, unsigned long long update,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper h{lr, c1, c2, mu, b1, omb1, b2, omb2, eps, wd, nesterov};
  const float rows = masked ? static_cast<float>(__builtin_popcountll(alive))
                            : static_cast<float>(m);
  const RowMasks rm{alive, update, rows};
  const int64_t nblocks = (p + kPlaneThreads - 1) / kPlaneThreads;
  const dim3 grid(static_cast<unsigned>(nblocks));
  dispatch_m(m, [&](auto t) {
    constexpr int N = decltype(t)::value;
    if (masked)
      launch_kind<N, true>(kind, grid, st, x, g, s0, s1, codes, w, dpart, m,
                           p, mode, groups, h, rm);
    else
      launch_kind<N, false>(kind, grid, st, x, g, s0, s1, codes, w, dpart,
                            m, p, mode, groups, h, rm);
  });
  sum_partials<<<1, kSumThreads, 0, st>>>(dpart, nblocks, rows, disp);
  return static_cast<int>(cudaGetLastError());
}
