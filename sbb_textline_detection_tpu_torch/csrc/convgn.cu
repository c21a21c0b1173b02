// GroupNorm and tanh-approximated GELU after the conv of every ConvGN block
// (models/unet.py), on the conv's float32 sum, in two kernels.
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm and GELU to
// XLA's fusions of the compiled Flax forward. On the card the same
// epilogue ran as some 25 PyTorch kernels over the float32 sum (a bf16
// round trip, two means, s*s, sub, mul, add, GELU, the cast back), about 66
// bytes of device memory an element. ops/groupnorm.py holds that
// composition (epilogue_plain) and the wrapper of these kernels.
//
// What it computes, for y (N, C, H, W) float32 stored NHWC (channels_last),
// G = groups, and s = y rounded to the compute dtype (round to nearest
// even, as .to(torch.bfloat16) rounds; s = y in float32):
//   mean_c = sum(s) / HW and msq_c = sum(s*s) / HW per (n, c);
//   a group's mean and mean square are the means of its channels' values;
//   var = max(mean2 - mean^2, 0), mul = rsqrt(var + eps) * weight[c];
//   out = gelu_tanh((y - mean) * mul + bias[c]), rounded once to the
//   compute dtype, written NHWC.
// The statistics come from the rounded sum and the normalised values from
// the unrounded one, as the JAX package's compiled forward does (see
// ConvGN.conv_gn).
//
// Bound: bytes. A few dozen float operations an element against 4 bytes
// read and 2 written (bf16) is far below the card's ratio of operations to
// bytes, so the least time is 6 bytes an element at 3.35 TB/s. Two passes
// must read the sum twice (the statistics of a whole sample come before
// any output), 10 bytes an element; the design spends nothing beyond that:
//   * convgn_stats_kernel: a block takes one sample's slab of pixels
//     across all C channels, each thread one 16-byte vector of 4 channels
//     a pixel, neighbouring threads on neighbouring vectors (the slab is
//     contiguous in NHWC), four independent loads in flight a thread. It
//     sums s and s*s in double (s*s is rounded to float first, as the
//     plain s * s is; in bf16 it is exact), adds its threads' sums in a
//     fixed order in shared memory, and writes one partial per channel to
//     a scratch of [N, slabs, 2, C] doubles. The last block of a sample to
//     finish (a ticket counter per sample, taken after __threadfence) adds
//     the sample's partials in slab order, forms the statistics and writes
//     mean and mul per (n, c), then resets the ticket for the next launch.
//     No float atomics: every launch gives the same bits.
//   * convgn_apply_kernel: the same thread layout over the sum once more,
//     each thread holding its 4 channels' mean, mul and bias in registers;
//     (y - mean) * mul + bias as three separately rounded float operations
//     (group_norm's order, no contraction), GELU as PyTorch's kernel writes
//     it (tanhf, not an approximate tanh), one rounding to the compute
//     dtype, and an 8-byte (bf16) or 16-byte (float32) store.
// Nothing else in float32 is written: the per-(n, c) mean and mul, and the
// double partials (2 C a slab), are all the scratch.
//
// convgn_launch launches both kernels on the given stream and returns
// cudaGetLastError(); convgn_scratch_doubles sizes its scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// float4 loads a thread makes over its slab (statistics) or chunk (apply)
constexpr int kStatsIters = 32;
constexpr int kApplyIters = 16;
// grids smaller than this many blocks get thinner slabs (132 SMs)
constexpr int kMinBlocks = 264;

struct Plan {
  int v;        // 16-byte vectors a pixel (C / 4)
  int threads;  // a multiple of v, at most kThreads
  int slab_px, slabs, chunk_px, chunks;
};

int split(int hw, int px_per_step, int iters, int n) {
  // pieces of a sample: `iters` steps a thread, or more pieces where the
  // grid would be small, never thinner than one step
  int pieces = (hw + px_per_step * iters - 1) / (px_per_step * iters);
  const int want = (kMinBlocks + n - 1) / n;
  const int most = (hw + px_per_step - 1) / px_per_step;
  if (pieces < want) pieces = want < most ? want : most;
  return pieces < 1 ? 1 : pieces;
}

Plan plan(int n, int c, int hw) {
  Plan p;
  p.v = c / 4;
  const int ppi = kThreads / p.v;  // pixels a step of the whole block
  p.threads = ppi * p.v;
  int slabs = split(hw, ppi, kStatsIters, n);
  p.slab_px = (hw + slabs - 1) / slabs;
  p.slabs = (hw + p.slab_px - 1) / p.slab_px;
  int chunks = split(hw, ppi, kApplyIters, n);
  p.chunk_px = (hw + chunks - 1) / chunks;
  p.chunks = (hw + p.chunk_px - 1) / p.chunk_px;
  return p;
}

template <bool kRound>
__device__ __forceinline__ float rounded(float x) {
  return kRound ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <bool kRound>
__device__ __forceinline__ void accumulate(const float4 a, double* s,
                                           double* q) {
  const float r[4] = {rounded<kRound>(a.x), rounded<kRound>(a.y),
                      rounded<kRound>(a.z), rounded<kRound>(a.w)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] += static_cast<double>(r[j]);
    q[j] += static_cast<double>(__fmul_rn(r[j], r[j]));
  }
}

// grid (slabs, N), block Plan::threads; part: [N, slabs, 2, C] doubles;
// tickets: one zeroed counter a sample, left zeroed
template <bool kRound>
__global__ void __launch_bounds__(kThreads) convgn_stats_kernel(
    const float4* __restrict__ y, const float* __restrict__ weight,
    float* __restrict__ mean_out, float* __restrict__ mul_out,
    double* __restrict__ part, unsigned int* __restrict__ tickets, int c,
    int hw, int groups, float eps, int slab_px, int slabs) {
  __shared__ double sm[8 * kThreads];
  __shared__ bool last;
  const int v = c >> 2;
  const int ppi = blockDim.x / v;
  const int tid = threadIdx.x;
  const int lane = tid % v, row = tid / v;
  const int n = blockIdx.y, slab = blockIdx.x;
  const int px0 = slab * slab_px;
  const int px1 = min(hw, px0 + slab_px);
  const float4* src = y + static_cast<size_t>(n) * hw * v + lane;

  double s[4] = {0.0, 0.0, 0.0, 0.0}, q[4] = {0.0, 0.0, 0.0, 0.0};
  int px = px0 + row;
  for (; px + 3 * ppi < px1; px += 4 * ppi) {
    float4 a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      a[k] = __ldg(src + static_cast<size_t>(px + k * ppi) * v);
#pragma unroll
    for (int k = 0; k < 4; ++k) accumulate<kRound>(a[k], s, q);
  }
  for (; px < px1; px += ppi)
    accumulate<kRound>(__ldg(src + static_cast<size_t>(px) * v), s, q);

  // the block's sums by channel, rows added in order
  double* sm_s = sm;
  double* sm_q = sm + ppi * c;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sm_s[row * c + 4 * lane + j] = s[j];
    sm_q[row * c + 4 * lane + j] = q[j];
  }
  __syncthreads();
  double* const part_n = part + static_cast<size_t>(n) * slabs * 2 * c;
  double* const mine = part_n + static_cast<size_t>(slab) * 2 * c;
  for (int ch = tid; ch < c; ch += blockDim.x) {
    double a = 0.0, b = 0.0;
    for (int r = 0; r < ppi; ++r) {
      a += sm_s[r * c + ch];
      b += sm_q[r * c + ch];
    }
    mine[ch] = a;
    mine[c + ch] = b;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&tickets[n], 1u) == static_cast<unsigned>(slabs - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the sample's last block: its slabs in order, `lanes` contiguous runs
  // of slabs a channel where the block has threads to spare
  const int lanes = blockDim.x >= c ? blockDim.x / c : 1;
  const int per = (slabs + lanes - 1) / lanes;
  double* red_s = sm;
  double* red_q = sm + lanes * c;
  for (int t = tid; t < lanes * c; t += blockDim.x) {
    const int ch = t % c, j = t / c;
    const int lo = j * per, hi = min(slabs, lo + per);
    double a = 0.0, b = 0.0;
    int sl = lo;
    for (; sl + 4 <= hi; sl += 4) {
      double xs[4], xq[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        xs[k] = __ldcg(part_n + static_cast<size_t>(sl + k) * 2 * c + ch);
        xq[k] = __ldcg(part_n + static_cast<size_t>(sl + k) * 2 * c + c + ch);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a += xs[k];
        b += xq[k];
      }
    }
    for (; sl < hi; ++sl) {
      a += __ldcg(part_n + static_cast<size_t>(sl) * 2 * c + ch);
      b += __ldcg(part_n + static_cast<size_t>(sl) * 2 * c + c + ch);
    }
    red_s[j * c + ch] = a;
    red_q[j * c + ch] = b;
  }
  __syncthreads();
  // per-channel means (C <= 4 * blockDim.x: at most 4 channels a thread)
  double cm[4], cq[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ch = tid + k * blockDim.x;
    if (ch < c) {
      double a = 0.0, b = 0.0;
      for (int j = 0; j < lanes; ++j) {
        a += red_s[j * c + ch];
        b += red_q[j * c + ch];
      }
      cm[k] = a / hw;
      cq[k] = b / hw;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ch = tid + k * blockDim.x;
    if (ch < c) {
      sm[ch] = cm[k];
      sm[c + ch] = cq[k];
    }
  }
  __syncthreads();
  // group statistics: means of the group's channel means
  const int cg = c / groups;
  for (int ch = tid; ch < c; ch += blockDim.x) {
    const int g0 = (ch / cg) * cg;
    double m = 0.0, m2 = 0.0;
    for (int k = 0; k < cg; ++k) {
      m += sm[g0 + k];
      m2 += sm[c + g0 + k];
    }
    m /= cg;
    m2 /= cg;
    const double var = fmax(m2 - m * m, 0.0);
    const float inv =
        static_cast<float>(1.0 / sqrt(var + static_cast<double>(eps)));
    mean_out[static_cast<size_t>(n) * c + ch] = static_cast<float>(m);
    mul_out[static_cast<size_t>(n) * c + ch] = __fmul_rn(inv, weight[ch]);
  }
  if (tid == 0) tickets[n] = 0u;
}

// PyTorch's tanh GELU for float (ActivationGeluKernel.cu), written alike
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = M_SQRT2 * M_2_SQRTPI * 0.5;
  constexpr float kKappa = 0.044715;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.0f + tanhf(inner));
}

__device__ __forceinline__ float normed(float y, float m, float k, float b) {
  return gelu_tanh(__fadd_rn(__fmul_rn(__fsub_rn(y, m), k), b));
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, size_t i,
                                       float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 w;
  w.x = *reinterpret_cast<const unsigned*>(&lo);
  w.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(out + i) = w;
}

__device__ __forceinline__ void store4(float* out, size_t i, float a,
                                       float b, float c, float d) {
  *reinterpret_cast<float4*>(out + i) = make_float4(a, b, c, d);
}

// grid (chunks, N), block Plan::threads
template <typename OutT>
__global__ void __launch_bounds__(kThreads) convgn_apply_kernel(
    const float4* __restrict__ y, const float* __restrict__ mean,
    const float* __restrict__ mul, const float* __restrict__ bias,
    OutT* __restrict__ out, int c, int hw, int chunk_px) {
  const int v = c >> 2;
  const int ppi = blockDim.x / v;
  const int tid = threadIdx.x;
  const int lane = tid % v, row = tid / v;
  const int n = blockIdx.y;
  const int px0 = blockIdx.x * chunk_px;
  const int px1 = min(hw, px0 + chunk_px);
  const int c0 = 4 * lane;
  float m[4], k[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m[j] = mean[static_cast<size_t>(n) * c + c0 + j];
    k[j] = mul[static_cast<size_t>(n) * c + c0 + j];
    b[j] = bias[c0 + j];
  }
  const size_t base = static_cast<size_t>(n) * hw;
  int px = px0 + row;
  for (; px + 3 * ppi < px1; px += 4 * ppi) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = __ldcs(y + (base + px + i * ppi) * v + lane);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      store4(out, (base + px + i * ppi) * c + c0,
             normed(a[i].x, m[0], k[0], b[0]),
             normed(a[i].y, m[1], k[1], b[1]),
             normed(a[i].z, m[2], k[2], b[2]),
             normed(a[i].w, m[3], k[3], b[3]));
  }
  for (; px < px1; px += ppi) {
    const float4 a = __ldcs(y + (base + px) * v + lane);
    store4(out, (base + px) * c + c0, normed(a.x, m[0], k[0], b[0]),
           normed(a.y, m[1], k[1], b[1]), normed(a.z, m[2], k[2], b[2]),
           normed(a.w, m[3], k[3], b[3]));
  }
}

}  // namespace

// doubles of scratch that convgn_launch needs: the [N, slabs, 2, C]
// partials, then N * C floats of mean and N * C of mul
extern "C" long long convgn_scratch_doubles(int n, int c, int hw) {
  const Plan p = plan(n, c, hw);
  return static_cast<long long>(n) * p.slabs * 2 * c +
         static_cast<long long>(n) * c;
}

// y: float32 NHWC (N, H, W, C), 16-byte aligned, C % 4 == 0, C <= 1024,
// C % groups == 0; out: NHWC in bf16 (out_bf16) or float32; scratch:
// convgn_scratch_doubles(n, c, hw) doubles; tickets: n zeroed counters,
// left zeroed when the launch ends.
extern "C" int convgn_launch(const void* y, const void* weight,
                             const void* bias, void* out, void* scratch,
                             void* tickets, int n, int c, int hw, int groups,
                             float eps, int out_bf16, void* stream) {
  if (n <= 0 || hw <= 0) return 0;
  const Plan p = plan(n, c, hw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<double*>(scratch);
  auto* mean = reinterpret_cast<float*>(
      part + static_cast<size_t>(n) * p.slabs * 2 * c);
  float* mul = mean + static_cast<size_t>(n) * c;
  const auto* y4 = static_cast<const float4*>(y);
  const dim3 sgrid(p.slabs, n), agrid(p.chunks, n);
  if (out_bf16) {
    convgn_stats_kernel<true><<<sgrid, p.threads, 0, st>>>(
        y4, static_cast<const float*>(weight), mean, mul, part,
        static_cast<unsigned*>(tickets), c, hw, groups, eps, p.slab_px,
        p.slabs);
  } else {
    convgn_stats_kernel<false><<<sgrid, p.threads, 0, st>>>(
        y4, static_cast<const float*>(weight), mean, mul, part,
        static_cast<unsigned*>(tickets), c, hw, groups, eps, p.slab_px,
        p.slabs);
  }
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  if (out_bf16) {
    convgn_apply_kernel<__nv_bfloat16><<<agrid, p.threads, 0, st>>>(
        y4, mean, mul, static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(out), c, hw, p.chunk_px);
  } else {
    convgn_apply_kernel<float><<<agrid, p.threads, 0, st>>>(
        y4, mean, mul, static_cast<const float*>(bias),
        static_cast<float*>(out), c, hw, p.chunk_px);
  }
  return static_cast<int>(cudaGetLastError());
}
