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
// So this kernel never builds A or B: it reads each canvas byte once and
// scatters its (at most 4) products into a shared-memory accumulator of S
// bins. Terms with s or u outside [0, S) and bins outside [0, S) are
// dropped, exactly as the matrix form drops them.
//
// Bound: the canvas bytes (S^2 per pair, 16 bytes per thread per load) and
// the shared-memory atomics of the set pixels. Zero 16-byte vectors are
// skipped; a thread keeps the partial sums of the few neighbouring bins its
// 16 same-row pixels hit in registers and flushes them when the bins move,
// which cuts the atomics by ~16x at small angles (where all pixels of a row
// land in one bin).
//
// Numerics: fy, gx and the hat arguments are rounded exactly like the f32
// expressions of the JAX program (explicit _rn intrinsics, no FMA
// contraction). The shared-memory atomics sum in an order that changes
// from run to run, so a bin agrees with the matrix form only to f32
// summation error: callers compare with rtol 1e-4, atol 1e-2, as the JAX
// package's own Pallas-vs-einsum test does.
//
// One block per pair; the C entry point launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float hat(float d) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(d)));
}

struct Window {
  int base;
  float v[4];
};

__device__ __forceinline__ void flush(float* acc, int s, Window& w) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int bin = w.base + i;
    if (w.v[i] != 0.0f && bin >= 0 && bin < s) atomicAdd(&acc[bin], w.v[i]);
    w.v[i] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
radon_pairs_kernel(const uint8_t* __restrict__ canvases,
                   const float* __restrict__ cosv,
                   const float* __restrict__ sinv,
                   const int* __restrict__ ridx,
                   const int* __restrict__ aidx,
                   float* __restrict__ out, int s) {
  extern __shared__ float acc[];
  const int k = blockIdx.x;
  const int region = ridx[k];
  const int angle = aidx[k];
  const float a = cosv[angle];
  const float nb = -sinv[angle];
  const float c = static_cast<float>(s / 2);
  const int half = s / 2;

  for (int i = threadIdx.x; i < s; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  const uint4* img = reinterpret_cast<const uint4*>(
      canvases + static_cast<size_t>(region) * s * s);
  const int vec_per_row = s / 16;
  const int n_vec = s * vec_per_row;

  for (int v = threadIdx.x; v < n_vec; v += blockDim.x) {
    const uint4 q = img[v];
    if ((q.x | q.y | q.z | q.w) == 0u) continue;
    const int y = v / vec_per_row;
    const int x0 = (v - y * vec_per_row) * 16;

    // row factors: s in {s0, s0+1}
    const float fy = __fadd_rn(__fmul_rn(a, __fsub_rn(static_cast<float>(y), c)), c);
    const int s0 = static_cast<int>(floorf(fy));
    const float wa0 = (s0 >= 0 && s0 < s)
        ? hat(__fsub_rn(static_cast<float>(s0), fy)) : 0.0f;
    const float wa1 = (s0 + 1 >= 0 && s0 + 1 < s)
        ? hat(__fsub_rn(static_cast<float>(s0 + 1), fy)) : 0.0f;

    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    Window w;
    w.base = 0;
    w.v[0] = w.v[1] = w.v[2] = w.v[3] = 0.0f;
    bool open = false;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t p = (words[j >> 2] >> ((j & 3) * 8)) & 0xffu;
      if (p == 0u) continue;
      const float val = static_cast<float>(p);
      const int x = x0 + j;
      const float gx = __fadd_rn(__fmul_rn(nb, __fsub_rn(static_cast<float>(x), c)), c);
      const int u0 = static_cast<int>(floorf(gx));
      const float wb0 = (u0 >= 0 && u0 < s)
          ? hat(__fsub_rn(static_cast<float>(u0), gx)) : 0.0f;
      const float wb1 = (u0 + 1 >= 0 && u0 + 1 < s)
          ? hat(__fsub_rn(static_cast<float>(u0 + 1), gx)) : 0.0f;
      const int t = s0 + u0 - half;   // output bin of the (s0, u0) term
      if (!open) {
        w.base = t;
        open = true;
      } else if (t < w.base || t > w.base + 1) {
        flush(acc, s, w);
        w.base = (t < w.base) ? t - 1 : t;
      }
      const int o = t - w.base;       // 0 or 1: bins o..o+2 fit the window
      w.v[o] += val * (wa0 * wb0);
      w.v[o + 1] += val * (wa0 * wb1 + wa1 * wb0);
      w.v[o + 2] += val * (wa1 * wb1);
    }
    if (open) flush(acc, s, w);
  }
  __syncthreads();
  float* dst = out + static_cast<size_t>(k) * s;
  for (int i = threadIdx.x; i < s; i += blockDim.x) dst[i] = acc[i];
}

}  // namespace

// canvases: (R, S, S) uint8, 16-byte aligned, S % 16 == 0
// cosv, sinv: (A,) float32; ridx, aidx: (F,) int32; out: (F, S) float32
extern "C" int radon_pairs_launch(const void* canvases, const void* cosv,
                                  const void* sinv, const void* ridx,
                                  const void* aidx, void* out, int n_pairs,
                                  int s, void* stream) {
  if (n_pairs <= 0) return 0;
  const size_t smem = static_cast<size_t>(s) * sizeof(float);
  radon_pairs_kernel<<<n_pairs, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(canvases),
      static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      static_cast<const int*>(ridx), static_cast<const int*>(aidx),
      static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}
