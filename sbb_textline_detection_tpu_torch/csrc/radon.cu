// Rotated row projections of binary canvases for the deskew sweep.
//
// Replaces the Pallas TPU kernel sbb_textline_detection_tpu/ops/
// pallas_radon.py (radon_profiles_pallas -> _kernel), which computes, per
// (region, angle) pair k, P_k[r] = sum_{s+u = r+S/2} (A_k I_k B_k^T)[s, u]
// with two dense (S, S, S) MXU matmuls per pair (2*S^3 FLOPs).
//
// A and B are hat-resampling matrices with at most two nonzeros per column
// (pipeline/deskew.py of the JAX package): pixel (y, x) of canvas I adds
// I[y,x] * hat(s - fy) * hat(u - gx) to bin s + u - S/2 for
// s in {floor(fy), floor(fy)+1} and u in {floor(gx), floor(gx)+1}, with
//   fy = cos(a)*(y - S/2) + S/2,   gx = -sin(a)*(x - S/2) + S/2.
// So the kernel never builds A or B: it scatters the (at most 3) bin
// contributions of every set pixel. Terms with s or u outside [0, S) and
// bins outside [0, S) are dropped, exactly as the matrix form drops them.
// It computes the full region x angle product, row-major: out[r*A + a].
//
// Bound: per set (pixel, angle) pair 8 f32 operations (4 weight products,
// 1 add, 3 accumulates; 3 value products more where the pixel is not 1),
// so at 20 % fill the least time is set by operations, not by the 2 MB of
// canvas bytes. What costs is everything around them: the earlier kernel
// (one block per pair) re-read the canvas from L2 for every angle,
// recomputed the row and column terms for every pixel, diverged on
// data-dependent branches and summed with shared-memory float atomics.
// What is left is latency:
// each lane walks its strip one dependent pixel at a time. The design:
//   * Lane = angle. A block takes one region, a tile of up to 32 angles
//     and a 32-row x 64-column sub-canvas; each of its 4 warps takes a
//     16-column strip of it (4,096 blocks for 8 regions x 110 angles at
//     S = 512). A warp walks its strip and every lane scatters the same
//     pixel for its own angle, so the pixel bytes, the zero skipping and
//     the loop control are uniform across the warp; only the bins differ.
//   * Empty sub-canvases: each thread first reads one of the sub-canvas's
//     128 16-byte vectors, and a block whose sub-canvas is all zero
//     returns before it sets anything up. The main path's canvases hold a
//     few small regions (a random-weight page: ~14 set pixels a canvas),
//     so most blocks exit here; without this the set-up made the kernel
//     slower than the earlier one on such pages.
//   * Staging: the sub-canvas is brought into shared memory once per
//     block, for all of its angles, in tiles of 16 rows with cp.async,
//     double-buffered.
//   * Zero skipping: lane r holds row r of the strip as one 16-byte
//     vector; a ballot finds the nonzero rows, each is broadcast with
//     shuffles and only its nonzero bytes are visited (a warp-uniform bit
//     loop).
//   * Tables: each warp builds its column table once per block, (wb0,
//     wb1) and u0 per (x, angle) in shared memory, [x][lane] so that a
//     lookup is one conflict-free load; the row terms (s0, wa0, wa1) are
//     computed when the walk enters a row. A set pixel then costs two
//     table loads, four multiplies and an add, and three accumulates.
//   * Sums without atomics: a lane's bins over its 32 x 16 strip span at
//     most hypot(31, 15) + 4 < 39 bins, so every (warp, angle) owns a
//     private row of 41 bins in shared memory and adds with plain loads
//     and stores, three per pixel, with no branch. (Hopper runs a float
//     atomicAdd to shared memory as a compare-and-swap loop; a register
//     window that flushed only when the bins moved diverged across
//     angles.) The block sums its warps' rows per angle and adds each bin
//     to the zeroed output once, with a global atomic.
//
// Numerics: fy, gx and the hat arguments are rounded exactly like the f32
// expressions of the JAX program (explicit _rn intrinsics, no FMA
// contraction). The global atomics that combine the sub-canvases sum in an
// order that changes from run to run, so a bin agrees with the matrix form
// only to f32 summation error: callers compare with rtol 1e-4, atol 1e-2,
// as the JAX package's own Pallas-vs-einsum test does.
//
// The C entry point zeroes the output and launches on the given stream,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 32;      // angles per block, one a lane
constexpr int kBandRows = 32;     // canvas rows per block
constexpr int kStageRows = 16;    // rows per staged tile, two tiles in flight
constexpr int kStrip = 16;        // canvas columns per warp (16 bytes)
constexpr int kBandCols = kWarps * kStrip;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kBandRows * kBandCols / 16,
              "the emptiness test reads one 16-byte vector a thread");

__device__ __forceinline__ float hat(float d) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(d)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// 4-bit mask of the nonzero bytes of w (bit i = byte i).
__device__ __forceinline__ unsigned nonzero_bytes(uint32_t w) {
  const uint32_t nz = __vcmpne4(w, 0u);      // 0xff where a byte is nonzero
  return ((nz >> 7) & 1u) | ((nz >> 14) & 2u) | ((nz >> 21) & 4u)
      | ((nz >> 28) & 8u);
}

// The hat terms of one axis at position p: with f = cs * (p - c) + c,
// index i0 = floor(f) and weights hat(i0 - f), hat(i0 + 1 - f), zero
// where the index falls outside [0, S). Rows take cs = cos(a) (s0, wa0,
// wa1), columns cs = -sin(a) (u0, wb0, wb1).
struct Terms {
  int i0;
  float w0, w1;
};

__device__ __forceinline__ Terms terms(float cs, int p, float c, int s) {
  const float f = __fadd_rn(
      __fmul_rn(cs, __fsub_rn(static_cast<float>(p), c)), c);
  const int i0 = static_cast<int>(floorf(f));
  return {i0,
          (i0 >= 0 && i0 < s)
              ? hat(__fsub_rn(static_cast<float>(i0), f)) : 0.0f,
          (i0 + 1 >= 0 && i0 + 1 < s)
              ? hat(__fsub_rn(static_cast<float>(i0 + 1), f)) : 0.0f};
}

__global__ void __launch_bounds__(kThreads, 2)
radon_sweep_kernel(const uint8_t* __restrict__ canvases,
                   const float* __restrict__ cosv,
                   const float* __restrict__ sinv,
                   float* __restrict__ out, int s, int n_angles, int ta,
                   int n_tiles, int n_rbands, int n_cbands, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  int bid = blockIdx.x;
  const int cband = bid % n_cbands;
  bid /= n_cbands;
  const int rband = bid % n_rbands;
  bid /= n_rbands;
  const int tile = bid % n_tiles;
  const int region = bid / n_tiles;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // the block's sub-canvas, and this warp's strip of it
  const int bx0 = cband * kBandCols;
  const int bw = min(kBandCols, s - bx0);
  const int by0 = rband * kBandRows;
  const int bh = min(kBandRows, s - by0);
  const int xs0 = bx0 + warp * kStrip;
  const bool busy = xs0 < s;                 // S % 16 == 0: a full strip
  const uint8_t* img = canvases + static_cast<size_t>(region) * s * s;

  // kThreads = kBandRows * kBandCols / 16: one vector of the sub-canvas a
  // thread; an all-zero sub-canvas adds nothing to the zeroed output
  {
    const int per_row = bw / 16;
    const int r = threadIdx.x / per_row;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (r < bh)
      q = __ldg(reinterpret_cast<const uint4*>(
          img + static_cast<size_t>(by0 + r) * s + bx0
          + 16 * (threadIdx.x - r * per_row)));
    if (!__syncthreads_or((q.x | q.y | q.z | q.w) != 0u)) return;
  }

  // shared memory: the private bin rows [warps * 32][width], the column
  // table [warps][16 x][32 lanes] of (wb0, wb1) and of u0 - min u0, the
  // lanes' lowest bins [warps * 32], and two staged tiles of rows
  float* priv = reinterpret_cast<float*>(smem);
  float2* col_w = reinterpret_cast<float2*>(priv + kThreads * width);
  int* lo_tab = reinterpret_cast<int*>(col_w + kThreads * kStrip);
  uint8_t* col_u = reinterpret_cast<uint8_t*>(lo_tab + kThreads);
  uint8_t* stage = col_u + kThreads * kStrip;
  constexpr int kStageBytes = kStageRows * kBandCols;
  for (int i = threadIdx.x; i < kThreads * width; i += kThreads)
    priv[i] = 0.0f;

  const int a0 = tile * ta;
  const int na = min(ta, n_angles - a0);
  const bool active = lane < na;
  const int angle = a0 + (active ? lane : 0);
  const float a = cosv[angle];
  const float nb = -sinv[angle];
  const float c = static_cast<float>(s / 2);
  const int half = s / 2;

  // fy and gx are monotone in y and x, so the corners of the strip give
  // the lane's lowest row and column terms; bin t = s0 + u0 - S/2 lands
  // at (s0 - s0min) + (u0 - u0min) of the lane's private row
  const int s0min = min(terms(a, by0, c, s).i0,
                        terms(a, by0 + bh - 1, c, s).i0);
  const int u0min = min(terms(nb, xs0, c, s).i0,
                        terms(nb, xs0 + kStrip - 1, c, s).i0);
  lo_tab[threadIdx.x] = (busy && active) ? s0min + u0min - half : INT_MIN;
  float* row = priv + threadIdx.x * width;
  if (busy) {
    for (int j = 0; j < kStrip; ++j) {
      const Terms u = terms(nb, xs0 + j, c, s);
      col_w[(warp * kStrip + j) * 32 + lane] = make_float2(u.w0, u.w1);
      col_u[(warp * kStrip + j) * 32 + lane] =
          static_cast<uint8_t>(u.i0 - u0min);
    }
  }
  const float2* my_w = col_w + warp * kStrip * 32 + lane;
  const uint8_t* my_u = col_u + warp * kStrip * 32 + lane;

  const int n_stage = (bh + kStageRows - 1) / kStageRows;
  auto load = [&](int k, int buf) {
    const int y0 = by0 + k * kStageRows;
    const int rows = min(kStageRows, bh - k * kStageRows);
    const int per_row = bw / 16;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row;
      const int v = i - r * per_row;
      cp_async16(stage + buf * kStageBytes + r * kBandCols + 16 * v,
                 img + static_cast<size_t>(y0 + r) * s + bx0 + 16 * v);
    }
    cp_async_commit();
  };

  load(0, 0);
  for (int k = 0; k < n_stage; ++k) {
    const int buf = k & 1;
    if (k + 1 < n_stage) {
      load(k + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int rows = min(kStageRows, bh - k * kStageRows);
    // lane r holds row r of the strip (one 16-byte vector)
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (busy && lane < rows)
      q = *reinterpret_cast<const uint4*>(stage + buf * kStageBytes
                                          + lane * kBandCols + warp * kStrip);
    unsigned m = __ballot_sync(kFull, (q.x | q.y | q.z | q.w) != 0u);
    while (m) {                              // the same in every lane
      const int r = __ffs(m) - 1;
      m &= m - 1;
      const Terms sy = terms(a, by0 + k * kStageRows + r, c, s);
      const float wa0 = active ? sy.w0 : 0.0f;
      const float wa1 = active ? sy.w1 : 0.0f;
      const int base = sy.i0 - s0min;
      const uint32_t w0 = __shfl_sync(kFull, q.x, r);
      const uint32_t w1 = __shfl_sync(kFull, q.y, r);
      const uint32_t w2 = __shfl_sync(kFull, q.z, r);
      const uint32_t w3 = __shfl_sync(kFull, q.w, r);
      const uint64_t lo64 = w0 | (static_cast<uint64_t>(w1) << 32);
      const uint64_t hi64 = w2 | (static_cast<uint64_t>(w3) << 32);
      unsigned bm = nonzero_bytes(w0) | (nonzero_bytes(w1) << 4)
          | (nonzero_bytes(w2) << 8) | (nonzero_bytes(w3) << 12);
      while (bm) {                           // the same in every lane
        const int b = __ffs(bm) - 1;
        bm &= bm - 1;
        const uint32_t p = static_cast<uint32_t>(
            (b < 8 ? lo64 >> (8 * b) : hi64 >> (8 * (b - 8))) & 0xffu);
        const float2 wb = my_w[b * 32];
        const int i = base + my_u[b * 32];
        float c0 = wa0 * wb.x;
        float c1 = wa0 * wb.y + wa1 * wb.x;
        float c2 = wa1 * wb.y;
        if (p != 1u) {                       // the same in every lane
          const float val = static_cast<float>(p);
          c0 *= val;
          c1 *= val;
          c2 *= val;
        }
        row[i] += c0;
        row[i + 1] += c1;
        row[i + 2] += c2;
      }
    }
    __syncthreads();                         // the buffer is refilled next
  }

  // sum the warps' rows of each angle and add each bin to the output once:
  // warp v takes angles v, v + kWarps, ...; lane u < kWarps fetches warp
  // u's lowest bin
  for (int i = warp; i < na; i += kWarps) {
    const int mine = lane < kWarps ? lo_tab[lane * 32 + i] : INT_MIN;
    int tlo = mine == INT_MIN ? INT_MAX : mine;
    int thi = mine == INT_MIN ? INT_MIN : mine + width;
    for (int o = 16; o > 0; o >>= 1) {
      tlo = min(tlo, __shfl_xor_sync(kFull, tlo, o));
      thi = max(thi, __shfl_xor_sync(kFull, thi, o));
    }
    int los[kWarps];
#pragma unroll
    for (int v = 0; v < kWarps; ++v) los[v] = __shfl_sync(kFull, mine, v);
    float* dst = out + (static_cast<size_t>(region) * n_angles + a0 + i) * s;
    for (int t = max(tlo, 0) + lane; t < min(thi, s); t += 32) {
      float sum = 0.0f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const int idx = t - los[v];
        if (los[v] != INT_MIN && idx >= 0 && idx < width)
          sum += priv[(v * 32 + i) * width + idx];
      }
      if (sum != 0.0f) atomicAdd(dst + t, sum);
    }
  }
}

struct Plan {
  int ta, n_tiles, n_rbands, n_cbands, width;
  size_t smem;
};

Plan plan(int n_angles, int s) {
  Plan p;
  p.n_tiles = (n_angles + kMaxTile - 1) / kMaxTile;
  p.ta = (n_angles + p.n_tiles - 1) / p.n_tiles;
  p.n_cbands = (s + kBandCols - 1) / kBandCols;
  p.n_rbands = (s + kBandRows - 1) / kBandRows;
  // a lane's row terms over kBandRows rows span floor(31 |cos|) + 1
  // values, its column terms over kStrip columns floor(15 |sin|) + 1, and
  // a pixel adds to 3 bins: at most hypot(31, 15) + 4 < 39 bins (2 more
  // for margin). Odd, so that the 32 lanes' rows start in 32 different
  // banks.
  p.width = static_cast<int>(std::ceil(std::hypot(
      static_cast<double>(kBandRows - 1),
      static_cast<double>(kStrip - 1)))) + 6;
  p.width |= 1;
  // ~41 KB: under the 48 KB a launch may take without opting in
  p.smem = static_cast<size_t>(kThreads) * p.width * 4      // priv
      + static_cast<size_t>(kThreads) * kStrip * 8             // col_w
      + kThreads * 4                                           // lo_tab
      + static_cast<size_t>(kThreads) * kStrip                 // col_u
      + 2 * static_cast<size_t>(kStageRows) * kBandCols;       // stage
  return p;
}

}  // namespace

// canvases: (R, S, S) uint8, 16-byte aligned, S % 16 == 0
// cosv, sinv: (A,) float32; out: (R * A, S) float32, row r * A + a
extern "C" int radon_sweep_launch(const void* canvases, const void* cosv,
                                  const void* sinv, void* out, int n_regions,
                                  int n_angles, int s, void* stream) {
  if (n_regions <= 0 || n_angles <= 0) return 0;
  const Plan p = plan(n_angles, s);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(n_regions) * n_angles * s * sizeof(float),
      st);
  if (err != cudaSuccess) return static_cast<int>(err);
  radon_sweep_kernel<<<n_regions * p.n_tiles * p.n_rbands * p.n_cbands,
                       kThreads, p.smem, st>>>(
      static_cast<const uint8_t*>(canvases), static_cast<const float*>(cosv),
      static_cast<const float*>(sinv), static_cast<float*>(out), s, n_angles,
      p.ta, p.n_tiles, p.n_rbands, p.n_cbands, p.width);
  return static_cast<int>(cudaGetLastError());
}
