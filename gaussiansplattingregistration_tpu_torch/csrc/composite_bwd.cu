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
// One sweep. The total sum_j (dL/dw_j) w_j of a pixel equals g_rgb . rgb +
// g_depth depth + g_alpha alpha, the cotangents dotted with the forward's
// own outputs (rgb = sum w c, depth = sum w d, alpha = sum w), and the
// block's horizon is the forward's `live` / 128. So the kernel reads both
// from the forward's saved outputs and makes one front-to-back pass that
// accumulates the inclusive prefix and uses S_k = total - prefix_k. The
// forward summed the total in another order, so the last entry's S is a
// rounding residue (~1e-7 of the total) rather than 0; 1/(1 - alpha) below
// the alpha_max clamp amplifies it by at most 1000. `chip_smoke.py` holds
// the kernel to its twin on seeded tiles whose raw alphas reach the clamp.
//
// What bounds it on the card: the least work is the formula above on the
// pairs the forward composites (visible pairs, 73 FP32 operations each,
// an FMA counted as two, the exp and the division as one, the pixel sums
// included) against reading each tile's entries before min(count, live),
// the counts and the cotangents once and writing d_gT once. At the bench
// scene a tenth of the alive pairs are visible and the bytes take longer
// than that arithmetic: the bound is bytes (`chip_smoke.py` computes both
// from the frame's counts). What costs time beyond it: visibility tests on
// invisible pairs, the per-entry warp reductions, and the fold of the
// warps' partial sums.
//
// What the design does about it:
// * per-warp footprint culling (`tile_footprint.cuh`): each warp holds an
//   8x4 pixel block and steps only through the entries whose conservative
//   box meets it, and stops stepping once none of its lanes is alive;
// * one sweep, as above, over the forward's horizon; the scan stops at
//   counts[t];
// * each contributing (warp, entry) costs 12 warp shuffles: a transposed
//   reduce-scatter halves the ten values at each butterfly step (10 -> 5
//   -> 3 -> 2 -> 1, then a last step of 1: 5 + 3 + 2 + 1 + 1 shuffles)
//   and leaves each channel's warp sum in one even lane, which writes it
//   to the warp's row of a shared [warps][10][128] partial array. A warp
//   whose lanes all contribute nothing to an entry skips it (__any_sync);
// * no atomics: each (tile, k) slot belongs to one CTA. Each warp records
//   which entries it wrote as a 128-bit mask, and after the chunk the
//   threads add the written partials in a fixed warp order (deterministic:
//   two launches give the same bits) and store the chunk's d_gT slab
//   coalesced. Slots past the horizon are written as zeros here.
// A thread whose T has fallen to tmin stays in the warp's loop with zero
// contributions: the shuffles need every lane.
//
// Layout: gT [T, 10, K] f32, channels (mx, my tile-local, conic a, b, c,
// opacity, r, g, b, depth); counts [T] int32; g_rgb and rgb [T, P, 3],
// g_alpha, g_depth, alpha and depth [T, P], live [T] f32; d_gT [T, 10, K]
// f32, with P = ts*ts and pixel p = y*ts + x centred at (x + 0.5, y + 0.5).

#include <cuda_runtime.h>

#include "tile_footprint.cuh"

namespace {

using namespace footprint;

// The warp sums of the ten values v, one channel per lane: after the five
// butterfly steps lane l holds channel (l&16 ? 5 : 0) + (l&8 ? 3 : 0) +
// (l&4 ? 2 : 0) + (l&2 ? 1 : 0) where that index exists within its group
// (of 5, then 3, then 2), and lanes l and l^1 hold the same sum. Even lanes
// write their channel to row[ch * kChunk + k]. 12 shuffles.
__device__ __forceinline__ void reduce_scatter(const float (&v)[kChannels], int lane,
                                               float* row, int k) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float a5[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {  // 10 -> 5: keep one half, send the other
    const float keep = b4 ? v[i + 5] : v[i];
    const float send = b4 ? v[i] : v[i + 5];
    a5[i] = keep + __shfl_xor_sync(kFullMask, send, 16);
  }
  float a3[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {  // 5 -> 3 (index 5 is zero padding)
    const float lo = a5[i];
    const float hi = i + 3 < 5 ? a5[i + 3] : 0.0f;
    a3[i] = (b3 ? hi : lo) + __shfl_xor_sync(kFullMask, b3 ? lo : hi, 8);
  }
  float a2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // 3 -> 2 (index 3 is zero padding)
    const float lo = a3[i];
    const float hi = i + 2 < 3 ? a3[i + 2] : 0.0f;
    a2[i] = (b2 ? hi : lo) + __shfl_xor_sync(kFullMask, b2 ? lo : hi, 4);
  }
  float a1 = (b1 ? a2[1] : a2[0]) + __shfl_xor_sync(kFullMask, b1 ? a2[0] : a2[1], 2);
  a1 += __shfl_xor_sync(kFullMask, a1, 1);
  const int in3 = (b2 ? 2 : 0) + (b1 ? 1 : 0);
  const int in5 = (b3 ? 3 : 0) + in3;
  if (!(lane & 1) && in3 < 3 && in5 < 5) row[((b4 ? 5 : 0) + in5) * kChunk + k] = a1;
}

__global__ void composite_bwd_kernel(const float* __restrict__ gT,
                                     const int* __restrict__ counts, int K,
                                     int ts, float alpha_clip, float alpha_max,
                                     float tmin,
                                     const float* __restrict__ g_rgb,
                                     const float* __restrict__ g_alpha,
                                     const float* __restrict__ g_depth,
                                     const float* __restrict__ rgb,
                                     const float* __restrict__ alpha,
                                     const float* __restrict__ depth,
                                     const float* __restrict__ live,
                                     float* __restrict__ d_gT) {
  extern __shared__ float4 smem4[];
  float4* box = smem4;                                      // [128]
  float* rows = reinterpret_cast<float*>(smem4 + kChunk);
  float(*sh)[kChunk] = reinterpret_cast<float(*)[kChunk]>(rows);  // [10][128]
  float* part = rows + kChannels * kChunk;                  // [warps][10][128]
  const int n_warps = blockDim.x >> 5;
  unsigned* wrote =
      reinterpret_cast<unsigned*>(part + n_warps * kChannels * kChunk);  // [warps][4]

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int P = ts * ts;
  const bool pixel = tid < P;
  int x, y;
  thread_pixel(tid, ts, x, y);
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const float4 wb = warp_box(pixel, x, y);
  const float* g = gT + static_cast<size_t>(tile) * kChannels * K;
  float* d = d_gT + static_cast<size_t>(tile) * kChannels * K;
  const int count = min(max(counts[tile], 0), K);
  // The forward's horizon, in chunks (never past the count's last chunk).
  const int n_chunks = min(static_cast<int>(live[tile]) / kChunk,
                           (count + kChunk - 1) / kChunk);

  float gr = 0.0f, gg = 0.0f, gb = 0.0f, ga = 0.0f, gd = 0.0f, total = 0.0f;
  if (pixel) {
    const size_t pix = static_cast<size_t>(tile) * P + y * ts + x;
    gr = g_rgb[pix * 3 + 0];
    gg = g_rgb[pix * 3 + 1];
    gb = g_rgb[pix * 3 + 2];
    ga = g_alpha[pix];
    gd = g_depth[pix];
    total = gr * rgb[pix * 3 + 0] + gg * rgb[pix * 3 + 1] + gb * rgb[pix * 3 + 2] +
            gd * depth[pix] + ga * alpha[pix];
  }

  float T = pixel ? 1.0f : 0.0f;  // lanes without a pixel are never alive
  float prefix = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * kChunk;
    const int n = min(kChunk, count - base);
    __syncthreads();  // the previous chunk's readers of sh, part, wrote are done
    stage_chunk(sh, g, K, base, n);
    __syncthreads();
    stage_boxes(box, sh, n, alpha_clip);
    __syncthreads();
    unsigned words[kWords];
    warp_list(box, wb, lane, words);
    unsigned written[kWords] = {0u, 0u, 0u, 0u};
    bool warp_alive = true;
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      unsigned bits = words[q];
      while (warp_alive && bits != 0u) {
        const int j = __ffs(bits) - 1;
        bits &= bits - 1u;
        const int k = q * 32 + j;
        warp_alive = __any_sync(kFullMask, T > tmin);
        if (!warp_alive) break;
        float v[kChannels];
#pragma unroll
        for (int ch = 0; ch < kChannels; ++ch) v[ch] = 0.0f;
        Terms e;
        const bool contributes =
            T > tmin && entry_terms(sh, k, px, py, alpha_clip, alpha_max, e);
        if (contributes) {
          const float w = e.alpha * T;
          const float dldw =
              fmaf(gr, sh[6][k], fmaf(gg, sh[7][k], fmaf(gb, sh[8][k], fmaf(gd, sh[9][k], ga))));
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
          reduce_scatter(v, lane, part + warp * kChannels * kChunk, k);
          written[q] |= 1u << j;
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kWords; ++q) wrote[warp * kWords + q] = written[q];
    }
    __syncthreads();
    for (int i = tid; i < kChannels * kChunk; i += blockDim.x) {
      const int ch = i / kChunk;
      const int k = i % kChunk;
      if (base + k >= K) continue;
      float s = 0.0f;
      for (int wi = 0; wi < n_warps; ++wi) {
        if ((wrote[wi * kWords + k / 32] >> (k % 32)) & 1u) {
          s += part[(wi * kChannels + ch) * kChunk + k];
        }
      }
      d[static_cast<size_t>(ch) * K + base + k] = s;
    }
  }

  // Zeros past the horizon: entries no pixel reached.
  const int done = min(n_chunks * kChunk, K);
  const int rest = K - done;
  for (int i = tid; i < kChannels * rest; i += blockDim.x) {
    const int ch = i / rest;
    d[static_cast<size_t>(ch) * K + done + i % rest] = 0.0f;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int composite_bwd(const float* gT, const int* counts, int num_tiles,
                             int K, int ts, float alpha_clip, float alpha_max,
                             float tmin, const float* g_rgb,
                             const float* g_alpha, const float* g_depth,
                             const float* rgb, const float* alpha,
                             const float* depth, const float* live,
                             float* d_gT, void* stream) {
  if (num_tiles > 0) {
    const int threads = (ts * ts + 31) / 32 * 32;
    const int warps = threads / 32;
    const size_t smem = sizeof(float4) * kChunk +
                        sizeof(float) * kChannels * kChunk * (1 + warps) +
                        sizeof(unsigned) * kWords * warps;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    composite_bwd_kernel<<<num_tiles, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        gT, counts, K, ts, alpha_clip, alpha_max, tmin, g_rgb, g_alpha,
        g_depth, rgb, alpha, depth, live, d_gT);
  }
  return static_cast<int>(cudaGetLastError());
}
