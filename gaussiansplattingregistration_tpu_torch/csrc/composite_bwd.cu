// Backward of the front-to-back tile compositor on Hopper.
//
// Replaces `gaussiansplattingregistration_tpu/ops/raster_pallas.py::_bwd_kernel`
// (launched by `_bwd_rule`). For one tile per CTA and one pixel per thread it
// computes the VJP of `composite_fwd.cu` with respect to the tile's entries:
//
//   w_k       = alpha_k T_k  where T_k > tmin   (T_k = prod_{j<k} (1 - alpha_j))
//   dL/dw_k   = g_rgb . c_k + g_depth d_k + g_alpha
//   S_k       = sum_{j>k} (dL/dw_j) w_j
//   dL/da_k   = T_k dL/dw_k - S_k / max(1 - alpha_k, 1e-6)   (live, alpha > 0)
//   dL/draw_k = dL/da_k where raw_alpha_k < alpha_max, else 0
//   dL/dsig_k = -dL/draw_k raw_alpha_k where sigma_k > 0, else 0
//
// and per entry the sums over the tile's pixels of
//   d mx = -dL/dsig (a dx + b dy),  d my = -dL/dsig (c dy + b dx),
//   d a = dL/dsig dx^2 / 2,  d b = dL/dsig dx dy,  d c = dL/dsig dy^2 / 2,
//   d op = dL/draw exp(-sigma),  d rgb = g_rgb w,  d depth = g_depth w,
// written to d_gT [T, 10, K] in the layout of gT.
//
// The suffix S_k (option (a) of two): two front-to-back sweeps. The first
// recomputes the forward and gives each pixel's total sum_j (dL/dw_j) w_j;
// the second accumulates the inclusive prefix in the same order and uses
// S_k = total - prefix_k. Both sweeps compute w and dL/dw with the same
// code (`entry_terms`) and accumulate with explicit fmaf, so the last
// entry's S is exactly 0. On saturated pixels (alpha_max = 0.999) the
// difference loses digits relative to the total (about 1e-7 of it, then
// amplified by at most 1/(1 - alpha) = 1000); gsplat's walk back from the
// final T instead divides by (1 - alpha) once per entry and compounds.
//
// What bounds it on the card: about 73 FP32 operations of the formula above
// per (pixel, entry) pair that the forward composites (an FMA counted as
// two, the exp and the division as one each, the ten pixel sums included)
// and the 18 of the visibility test per other pair whose pixel is still
// alive, against reading gT, counts and the cotangents once and writing
// d_gT once. At the bench scene the arithmetic takes longer than the bytes:
// the kernel is operations-bound (`chip_smoke.py` computes both from the
// frame's counts; its bound counts the formula once, while the design
// below evaluates the forward terms twice and every warp steps through
// each entry of a chunk).
//
// What the design does about it:
// * the same exits as the forward: the scan stops at counts[t], a thread
//   skips the arithmetic once its T <= tmin, and at each chunk boundary of
//   the first sweep the block votes with __syncthreads_or(T > tmin) and
//   leaves once no pixel is alive (exact: later weights are zero). The
//   second sweep visits only the chunks the first one did;
// * each 128-entry chunk of the 10 channel rows is staged once in shared
//   memory and read as broadcasts;
// * the per-entry sums need no global atomics: each (tile, k) slot belongs
//   to one CTA. A warp whose lanes all contribute nothing to entry k skips
//   it (__any_sync); otherwise it reduces the ten values with xor
//   shuffles, and lane 0 writes them to the warp's row of a shared
//   [warps][10][128] partial array. After the chunk the threads add the
//   warps' rows in a fixed order (deterministic) and write the chunk's
//   d_gT slab with coalesced stores. A thread whose T has fallen to tmin
//   stays in the loop with zero contributions: the shuffles need every lane.
// * slots past the horizon are written as zeros by the kernel itself.
// No tensor-core or TMA work; a later change can cut the shuffle count with
// a transposed (reduce-scatter) warp reduction and pipeline the chunk loads.
//
// Layout: gT [T, 10, K] f32, channels (mx, my tile-local, conic a, b, c,
// opacity, r, g, b, depth); counts [T] int32; g_rgb [T, P, 3], g_alpha
// [T, P], g_depth [T, P] f32; d_gT [T, 10, K] f32, with P = ts*ts and pixel
// p = y*ts + x centred at (x + 0.5, y + 0.5). Blocks have P threads rounded
// up to whole warps; the extra lanes are pixels that never contribute.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;  // entries staged per step; the horizon's unit
constexpr int kChannels = 10;
constexpr unsigned kFullMask = 0xffffffffu;

struct Entry {
  float dx, dy, sigma, ex, raw, alpha;
};

// The forward terms of entry k for the pixel at (px, py); true iff the
// forward composites it with alpha > 0 (the JAX kernel's dL/dalpha mask).
__device__ __forceinline__ bool entry_terms(const float (*sh)[kChunk], int k,
                                            float px, float py,
                                            float alpha_clip, float alpha_max,
                                            Entry& e) {
  e.dx = px - sh[0][k];
  e.dy = py - sh[1][k];
  e.sigma = 0.5f * (sh[2][k] * e.dx * e.dx + sh[4][k] * e.dy * e.dy) +
            sh[3][k] * e.dx * e.dy;
  e.ex = expf(-fmaxf(e.sigma, 0.0f));
  e.raw = sh[5][k] * e.ex;
  e.alpha = fminf(e.raw, alpha_max);
  return e.alpha > 0.0f && !(e.alpha < alpha_clip || e.sigma < 0.0f);
}

__device__ __forceinline__ float dl_dw(const float (*sh)[kChunk], int k,
                                       float gr, float gg, float gb, float gd,
                                       float ga) {
  return fmaf(gr, sh[6][k],
              fmaf(gg, sh[7][k], fmaf(gb, sh[8][k], fmaf(gd, sh[9][k], ga))));
}

__global__ void composite_bwd_kernel(const float* __restrict__ gT,
                                     const int* __restrict__ counts, int K,
                                     int ts, float alpha_clip, float alpha_max,
                                     float tmin,
                                     const float* __restrict__ g_rgb,
                                     const float* __restrict__ g_alpha,
                                     const float* __restrict__ g_depth,
                                     float* __restrict__ d_gT) {
  extern __shared__ float smem[];
  float(*sh)[kChunk] = reinterpret_cast<float(*)[kChunk]>(smem);
  float* part = smem + kChannels * kChunk;  // [warps][10][128]

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int P = ts * ts;
  const bool pixel = tid < P;
  const float px = static_cast<float>(tid % ts) + 0.5f;
  const float py = static_cast<float>(tid / ts) + 0.5f;
  const float* g = gT + static_cast<size_t>(tile) * kChannels * K;
  float* d = d_gT + static_cast<size_t>(tile) * kChannels * K;
  const int count = min(max(counts[tile], 0), K);

  float gr = 0.0f, gg = 0.0f, gb = 0.0f, ga = 0.0f, gd = 0.0f;
  if (pixel) {
    const size_t pix = static_cast<size_t>(tile) * P + tid;
    gr = g_rgb[pix * 3 + 0];
    gg = g_rgb[pix * 3 + 1];
    gb = g_rgb[pix * 3 + 2];
    ga = g_alpha[pix];
    gd = g_depth[pix];
  }

  // Sweep 1: the forward again, for each pixel's total of dL/dw * w and the
  // number of chunks before every pixel saturated (the block's horizon).
  float T = 1.0f;
  float total = 0.0f;
  int n_chunks = 0;
  for (int base = 0; base < count; base += kChunk) {
    if (!__syncthreads_or(pixel && T > tmin)) break;
    ++n_chunks;
    const int n = min(kChunk, count - base);
    for (int i = tid; i < kChannels * kChunk; i += blockDim.x) {
      const int ch = i / kChunk;
      const int k = i % kChunk;
      sh[ch][k] = k < n ? g[static_cast<size_t>(ch) * K + base + k] : 0.0f;
    }
    __syncthreads();
    if (pixel && T > tmin) {
      for (int k = 0; k < n; ++k) {
        Entry e;
        if (!entry_terms(sh, k, px, py, alpha_clip, alpha_max, e)) continue;
        const float w = e.alpha * T;
        total = fmaf(dl_dw(sh, k, gr, gg, gb, gd, ga), w, total);
        T *= 1.0f - e.alpha;
        if (T <= tmin) break;
      }
    }
  }

  // Sweep 2: the gradients, chunk by chunk over the same horizon.
  T = 1.0f;
  float prefix = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * kChunk;
    const int n = min(kChunk, count - base);
    __syncthreads();  // the previous chunk's readers of sh and part are done
    for (int i = tid; i < kChannels * kChunk; i += blockDim.x) {
      const int ch = i / kChunk;
      const int k = i % kChunk;
      sh[ch][k] = k < n ? g[static_cast<size_t>(ch) * K + base + k] : 0.0f;
    }
    for (int i = tid; i < n_warps * kChannels * kChunk; i += blockDim.x) {
      part[i] = 0.0f;
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      float v[kChannels];
#pragma unroll
      for (int ch = 0; ch < kChannels; ++ch) v[ch] = 0.0f;
      bool contributes = false;
      Entry e;
      if (pixel && T > tmin &&
          entry_terms(sh, k, px, py, alpha_clip, alpha_max, e)) {
        contributes = true;
        const float w = e.alpha * T;
        const float dldw = dl_dw(sh, k, gr, gg, gb, gd, ga);
        prefix = fmaf(dldw, w, prefix);
        const float suffix = total - prefix;  // S_k = sum over j > k
        const float dlda = T * dldw - suffix / fmaxf(1.0f - e.alpha, 1e-6f);
        const float dldraw = e.raw < alpha_max ? dlda : 0.0f;
        const float dlds = e.sigma > 0.0f ? -dldraw * e.raw : 0.0f;
        v[0] = -dlds * (sh[2][k] * e.dx + sh[3][k] * e.dy);
        v[1] = -dlds * (sh[4][k] * e.dy + sh[3][k] * e.dx);
        v[2] = 0.5f * dlds * e.dx * e.dx;
        v[3] = dlds * e.dx * e.dy;
        v[4] = 0.5f * dlds * e.dy * e.dy;
        v[5] = dldraw * e.ex;
        v[6] = gr * w;
        v[7] = gg * w;
        v[8] = gb * w;
        v[9] = gd * w;
        T *= 1.0f - e.alpha;
      }
      if (__any_sync(kFullMask, contributes)) {
#pragma unroll
        for (int ch = 0; ch < kChannels; ++ch) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v[ch] += __shfl_xor_sync(kFullMask, v[ch], off);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int ch = 0; ch < kChannels; ++ch) {
            part[(warp * kChannels + ch) * kChunk + k] = v[ch];
          }
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < kChannels * kChunk; i += blockDim.x) {
      const int ch = i / kChunk;
      const int k = i % kChunk;
      if (base + k >= K) continue;
      float s = 0.0f;
      for (int wi = 0; wi < n_warps; ++wi) s += part[(wi * kChannels + ch) * kChunk + k];
      d[static_cast<size_t>(ch) * K + base + k] = s;
    }
  }

  // Zeros past the horizon: entries no pixel reached.
  const int written = min(n_chunks * kChunk, K);
  const int rest = K - written;
  for (int i = tid; i < kChannels * rest; i += blockDim.x) {
    const int ch = i / rest;
    d[static_cast<size_t>(ch) * K + written + i % rest] = 0.0f;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int composite_bwd(const float* gT, const int* counts, int num_tiles,
                             int K, int ts, float alpha_clip, float alpha_max,
                             float tmin, const float* g_rgb,
                             const float* g_alpha, const float* g_depth,
                             float* d_gT, void* stream) {
  if (num_tiles > 0) {
    const int threads = (ts * ts + 31) / 32 * 32;
    const size_t smem =
        sizeof(float) * kChannels * kChunk * (1 + threads / 32);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    composite_bwd_kernel<<<num_tiles, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        gT, counts, K, ts, alpha_clip, alpha_max, tmin, g_rgb, g_alpha,
        g_depth, d_gT);
  }
  return static_cast<int>(cudaGetLastError());
}
