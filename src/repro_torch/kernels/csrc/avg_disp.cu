// Fused worker average + Eq. 4 dispersion + broadcast on the (M, P) f32
// parameter plane, in one launch.
//
// Replaces the TPU kernel repro/kernels/avg_disp.py::avg_disp
// (_avg_disp_kernel, avg_disp.py:38; pallas_call at :184) for groups >= 1
// (global mean, or the means of `groups` contiguous worker groups — the
// hierarchical schedule's inner event); the dispersion is always taken
// against the global mean. Two template flags cover what the TPU kernel
// leaves to its wrapper and its jnp twin:
//   - CODES: a (P,) f32 row of rounding codes (0 f32, 1 bf16, 2 f16); the
//     broadcast (group) mean goes through round_code, the dispersion stays
//     against the unrounded global mean (plane_average_ref's codes path,
//     the reference's engine.py:596-600);
//   - MASKED: the fault-degraded event (the wrapper's `alive` branch,
//     avg_disp.py:170-175), the alive rows a 64-bit row word by value.
//     Only alive rows are read; the (group) mean of a group's alive rows,
//     summed in row order and divided once, is written IN PLACE to those
//     rows only (a group with no alive row is left alone); the dispersion
//     is over the alive rows, divided by their count. Dead rows are
//     neither read nor written.
// The unmasked instantiations write a new plane. x and out carry no
// __restrict__: the masked ones are called with out == x, and each thread
// reads its columns whole before it writes them.
//
// Bound on an H100 (3.35 TB/s): memory. The pass reads the plane once and
// writes the output plane once, 2 * M * P * 4 bytes: 11.58 GB at M = 4,
// P = 361,821,120 (3.46 ms); the codes row adds P * 4 (13.03 GB, 3.89 ms).
// Masked, with one dead row of four, it moves 3 rows each way: 8.68 GB
// (2.59 ms), 10.13 GB coded (3.02 ms). At the §3.2 CNN's plane (M = 4,
// P = 1,663,370) a pass is 53 MB (0.0159 ms), about one launch's latency;
// at the paper's least-squares shape (M = 24, P = 1024) 196,608 B
// (0.06 us): launch latency rules both.
//
// Design, for those small planes as much as for the full width:
//   - One launch an event. The cross-block dispersion sum runs in the
//     sweep's own launch: each block writes its float64 partial, and the
//     block that takes the last ticket of a counter in persistent scratch
//     (atomicAdd after a __threadfence) sums every block's partial in
//     block order, writes disp and sets the counter back to 0 for the
//     next launch on the stream. The ticket only elects the finisher; no
//     value is summed atomically, so the bits do not depend on which
//     block ends last.
//   - A persistent grid: at most the blocks the card holds resident
//     (the occupancy API's count x SMs, found once per instantiation and
//     device), each sweeping columns grid-stride. The grid fixes which
//     columns each thread sums, so two runs on one card are bitwise; the
//     partials are a few thousand at any P.
//   - V adjacent columns a thread (float4 / float2 row accesses): V = 4
//     when P % 4 == 0, 2 when P is even (the CNN's P = 1,663,370 = 2 mod
//     4: a float4 would straddle a 16-byte line on odd rows), 1 for odd
//     P or unaligned pointers; V shrinks as MAXM grows (kMaxCols), so
//     the MAXM x V column block stays at most 64 registers. Rows are
//     read and written with streaming hints (ld.global.cs / st.global.cs),
//     which leave the bits alone and the caches to other work.
//   - Each column's mean and dispersion term are summed over the rows in
//     order, each step rounded on its own (-fmad=false, no fast math), as
//     the plain version sums: the plane is bitwise plane_average_ref. A
//     thread adds its columns' terms in float64, the block and the
//     finisher in a fixed float64 tree (warp shuffles, then the warps').
// An unmasked pass is the masked one over every row (kAllRows folds the
// row tests away). With one group the broadcast value is the
// dispersion's own mean (one sum, one division a column).
#include <atomic>

#include "plane_common.cuh"

namespace {

// The most columns a thread takes at a register-array bound MAXM.
constexpr int kMaxCols(int maxm) {
  return maxm <= 8 ? 4 : maxm <= 16 ? 2 : 1;
}

template <int V>
struct Cols {
  static constexpr int value = V;
};

// V adjacent floats from / to 4V-byte aligned addresses, with the
// streaming (evict-first) cache hint: an event reads each plane element
// once and writes each once, so no line is worth keeping in L1 or L2.
template <int V>
__device__ __forceinline__ void load_cols(const float* src, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(src));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldcs(reinterpret_cast<const float2*>(src));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __ldcs(src);
  }
}

template <int V>
__device__ __forceinline__ void store_cols(float* dst, const float (&v)[V]) {
  if constexpr (V == 4)
    __stcs(reinterpret_cast<float4*>(dst),
           make_float4(v[0], v[1], v[2], v[3]));
  else if constexpr (V == 2)
    __stcs(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  else
    __stcs(dst, v[0]);
}

// Columns j .. j+V-1 of the event: the rows set in `rows` read, the
// (group) means written to them; returns the columns' dispersion terms
// summed in float64.
template <int MAXM, int V, bool CODES>
__device__ __forceinline__ double event_cols(
    const float* x, float* out, const float* __restrict__ codes, int m,
    int64_t p, int64_t j, int groups, unsigned long long rows,
    float n_rows) {
  float u[MAXM][V];
#pragma unroll
  for (int i = 0; i < MAXM; ++i)
    if (i < m && row_on(rows, i))
      load_cols<V>(x + static_cast<int64_t>(i) * p + j, u[i]);
  float code[V];
  if constexpr (CODES) {
    load_cols<V>(codes + j, code);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) code[c] = 0.0f;
  }
  float mean[V];
  double dsq = 0.0;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXM; ++i)
      if (i < m && row_on(rows, i)) sum += u[i][c];
    mean[c] = sum / n_rows;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXM; ++i) {
      if (i < m && row_on(rows, i)) {
        const float d = u[i][c] - mean[c];
        acc += d * d;
      }
    }
    dsq += static_cast<double>(acc);
  }
  if (groups == 1) {
    // the one group's mean is the dispersion's: the same sum and count
    float v[V];
#pragma unroll
    for (int c = 0; c < V; ++c) v[c] = round_code(mean[c], code[c]);
#pragma unroll
    for (int i = 0; i < MAXM; ++i)
      if (i < m && row_on(rows, i))
        store_cols<V>(out + static_cast<int64_t>(i) * p + j, v);
    return dsq;
  }
  // each group's alive rows summed in row order, divided once
  // (write_masked_means, V columns at a time)
  const int gs = m / groups;
  for (int lo = 0; lo < m; lo += gs) {
    const int hi = lo + gs;
    float gsum[V];
#pragma unroll
    for (int c = 0; c < V; ++c) gsum[c] = 0.0f;
    int n = 0;
#pragma unroll
    for (int i = 0; i < MAXM; ++i) {
      if (i >= lo && i < hi && row_on(rows, i)) {
#pragma unroll
        for (int c = 0; c < V; ++c) gsum[c] += u[i][c];
        ++n;
      }
    }
    if (n == 0) continue;
    float v[V];
#pragma unroll
    for (int c = 0; c < V; ++c)
      v[c] = round_code(gsum[c] / static_cast<float>(n), code[c]);
#pragma unroll
    for (int i = 0; i < MAXM; ++i)
      if (i >= lo && i < hi && row_on(rows, i))
        store_cols<V>(out + static_cast<int64_t>(i) * p + j, v);
  }
  return dsq;
}

constexpr int kWarps = kPlaneThreads / 32;

// The sum of one float64 a lane over the warp, in a fixed shuffle tree
// (lane 0 gets it).
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

// The block's sum of one float64 a thread in a fixed order: each warp's
// shuffle tree, then warp 0's over the warp sums (every thread of the
// block must call it; red, kWarps doubles, is reused from call to call).
// Thread 0 gets the sum.
__device__ __forceinline__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    if (lane < kWarps) v = red[lane];
    v = warp_sum(v);
  }
  return v;
}

template <int MAXM, int V, bool MASKED, bool CODES>
__global__ void __launch_bounds__(kPlaneThreads)
avg_disp_cols(const float* x, float* out, const float* __restrict__ codes,
              double* __restrict__ dpart, unsigned* __restrict__ ticket,
              float* __restrict__ disp, int m, int64_t p, int groups,
              unsigned long long alive, float n_alive) {
  __shared__ double red[kWarps];
  __shared__ bool finisher;
  const unsigned long long rows = MASKED ? alive : kAllRows;
  const float n_rows = MASKED ? n_alive : static_cast<float>(m);
  const int64_t nvec = p / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kPlaneThreads;
  double acc = 0.0;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kPlaneThreads +
                   threadIdx.x;
       k < nvec; k += stride)
    acc += event_cols<MAXM, V, CODES>(x, out, codes, m, p, k * V, groups,
                                      rows, n_rows);
  const double part = block_sum(acc, red);
  if (threadIdx.x == 0) {
    dpart[blockIdx.x] = part;
    __threadfence();
    finisher = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!finisher) return;
  // every other block's partial is written and fenced: sum them all in
  // block order, read through L2
  __threadfence();
  double s = 0.0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kPlaneThreads)
    s += __ldcg(dpart + b);
  const double total = block_sum(s, red);
  if (threadIdx.x == 0) {
    disp[0] = static_cast<float>(total) / n_rows;
    ticket[0] = 0u;
  }
}

// The blocks of one instantiation the current device holds resident (its
// occupancy x SMs), found once per device.
template <int MAXM, int V, bool MASKED, bool CODES>
int resident_blocks() {
  constexpr int kDevices = 64;
  static std::atomic<int> cache[kDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  const int slot = dev < kDevices ? dev : -1;
  int n = slot >= 0 ? cache[slot].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, avg_disp_cols<MAXM, V, MASKED, CODES>, kPlaneThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    n = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
    if (slot >= 0) cache[slot].store(n, std::memory_order_relaxed);
  }
  return n;
}

// Call f(Cols<V>{}) with the widest V <= min(v, VMAX) in {4, 2, 1}.
template <int VMAX, class F>
void dispatch_cols(int v, F&& f) {
  if constexpr (VMAX >= 4) {
    if (v >= 4) return f(Cols<4>{});
  }
  if constexpr (VMAX >= 2) {
    if (v >= 2) return f(Cols<2>{});
  }
  f(Cols<1>{});
}

// The instantiation a launch on these arguments takes and its grid:
// calls f(kernel, grid). The widest row access every row start and
// pointer is aligned for; at most the blocks the card holds resident, the
// plane's tiles of kPlaneThreads x V columns and dpart_cap.
template <class F>
void plan(const float* x, const float* out, const float* codes,
          int dpart_cap, int m, long long p, bool masked, F&& f) {
  int v = p % 4 == 0 ? 4 : p % 2 == 0 ? 2 : 1;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(codes);
  while (v > 1 && addr % (4 * v) != 0) v /= 2;
  dispatch_m(m, [&](auto t) {
    using TM = decltype(t);
    dispatch_cols<kMaxCols(TM::value)>(v, [&](auto c) {
      using TV = decltype(c);
      dispatch_flags(masked, codes != nullptr, [&](auto mk, auto cd) {
        using TK = decltype(mk);
        using TC = decltype(cd);
        const int64_t tiles =
            (p / TV::value + kPlaneThreads - 1) / kPlaneThreads;
        int64_t grid = resident_blocks<TM::value, TV::value, TK::value,
                                       TC::value>();
        if (tiles < grid) grid = tiles;
        if (dpart_cap < grid) grid = dpart_cap;
        if (grid < 1) grid = 1;
        f(avg_disp_cols<TM::value, TV::value, TK::value, TC::value>,
          static_cast<unsigned>(grid));
      });
    });
  });
}

}  // namespace

// C entry point, bound with ctypes: out = broadcast (group) mean of x,
// rounded through `codes` (null: none), disp = Eq. 4 dispersion, in ONE
// launch. dpart (room for dpart_cap float64 partials: the grid is at most
// that) and ticket (one unsigned counter, 0 before the launch and left 0
// after it) are the scratch of the stream's launches. masked != 0 runs
// the fault-degraded event over the rows set in `alive` (bit i is row
// i), in place: out must be x. Returns cudaGetLastError() after the
// launch (0 = success); on an error the ticket is set back to 0.
extern "C" int avg_disp_launch(const float* x, float* out,
                               const float* codes, double* dpart,
                               int dpart_cap, unsigned* ticket, float* disp,
                               int m, long long p, int groups, int masked,
                               unsigned long long alive, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float rows = masked ? static_cast<float>(__builtin_popcountll(alive))
                            : static_cast<float>(m);
  plan(x, out, codes, dpart_cap, m, p, masked != 0,
       [&](auto kernel, unsigned grid) {
         kernel<<<grid, kPlaneThreads, 0, st>>>(x, out, codes, dpart, ticket,
                                                disp, m, p, groups, alive,
                                                rows);
       });
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) cudaMemsetAsync(ticket, 0, sizeof(unsigned), st);
  return static_cast<int>(err);
}

// The grid avg_disp_launch takes on these arguments (the checks of
// kernels/card_check.py size their planes by it); no launch.
extern "C" int avg_disp_grid(const float* x, const float* out,
                             const float* codes, int dpart_cap, int m,
                             long long p, int masked) {
  unsigned got = 0;
  plan(x, out, codes, dpart_cap, m, p, masked != 0,
       [&](auto, unsigned grid) { got = grid; });
  return static_cast<int>(got);
}
