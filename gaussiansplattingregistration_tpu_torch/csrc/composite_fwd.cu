// Front-to-back tile compositing: the rasterizer's forward hot loop on Hopper.
//
// Replaces `gaussiansplattingregistration_tpu/ops/raster_pallas.py::_fwd_kernel`
// (launched by `_fwd_impl`). It computes what that kernel computes, for one
// tile per CTA and one pixel per thread:
//
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy        (dx, dy: pixel - mean)
//   alpha = min(op exp(-max(sigma, 0)), alpha_max),  0 if alpha < alpha_clip
//                                                   or sigma < 0
//   w_k   = alpha_k T_k  where T_k > tmin,  T_k = prod_{j<k} (1 - alpha_j)
//   out   = (sum w rgb, sum w depth, sum w)
//   live  = the tile's chunk-granular horizon: 128 for each 128-entry chunk
//           c with count > 128 c and some pixel still at T > tmin at its start.
//
// What bounds it on the card: the visibility test (about 18 FP32 operations,
// the exp on the SFU among them) per (pixel, entry) pair whose pixel is
// still alive, and 12 more per pair it composites, against reading gT
// [T,10,K] once and writing [T,P,5] once. At the bench scene the arithmetic
// takes longer than the bytes (`chip_smoke.py` computes both from the
// frame's counts), so the kernel is compute-bound: the design spends no
// arithmetic on dead pairs.
//
// What the design does about it:
// * a thread stops its own scan once its T <= tmin (later weights are zero);
// * at each chunk boundary the block votes with __syncthreads_or(T > tmin)
//   and leaves once no pixel is alive - exact, because later entries add
//   zero - and the same vote accounts the live horizon;
// * the scan stops at counts[t], so empty slots cost nothing;
// * each 128-entry chunk of the 10 channel rows is staged once in shared
//   memory (5 KB) with coalesced loads (rows of gT are contiguous along K),
//   and every thread then reads the entry's parameters as broadcasts.
// No tensor-core or TMA work: a later change can pipeline the chunk loads.
//
// Layout: gT [T, 10, K] f32, channels (mx, my tile-local, conic a, b, c,
// opacity, r, g, b, depth); counts [T] int32; outputs rgb [T, P, 3],
// alpha [T, P], depth [T, P], live [T] f32 with P = ts*ts and pixel
// p = y*ts + x centred at (x + 0.5, y + 0.5).

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;  // entries staged per step; the horizon's unit
constexpr int kChannels = 10;

__global__ void composite_fwd_kernel(const float* __restrict__ gT,
                                     const int* __restrict__ counts,
                                     int K, int ts, float alpha_clip,
                                     float alpha_max, float tmin,
                                     float* __restrict__ rgb_out,
                                     float* __restrict__ alpha_out,
                                     float* __restrict__ depth_out,
                                     float* __restrict__ live_out) {
  __shared__ float sh[kChannels][kChunk];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = ts * ts;
  const float px = static_cast<float>(tid % ts) + 0.5f;
  const float py = static_cast<float>(tid / ts) + 0.5f;
  const float* g = gT + static_cast<size_t>(tile) * kChannels * K;
  const int count = min(max(counts[tile], 0), K);

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f, acc_a = 0.0f;
  float live = 0.0f;

  for (int base = 0; base < count; base += kChunk) {
    // Barrier + vote: no thread still reads the previous chunk, and the
    // chunk counts toward the horizon iff some pixel is alive at its start.
    if (!__syncthreads_or(T > tmin)) break;
    live += static_cast<float>(kChunk);
    const int n = min(kChunk, count - base);
    for (int i = tid; i < kChannels * kChunk; i += blockDim.x) {
      const int ch = i / kChunk;
      const int k = i % kChunk;
      sh[ch][k] = k < n ? g[static_cast<size_t>(ch) * K + base + k] : 0.0f;
    }
    __syncthreads();
    if (T > tmin) {
      for (int k = 0; k < n; ++k) {
        const float dx = px - sh[0][k];
        const float dy = py - sh[1][k];
        const float sigma =
            0.5f * (sh[2][k] * dx * dx + sh[4][k] * dy * dy) + sh[3][k] * dx * dy;
        const float alpha =
            fminf(sh[5][k] * expf(-fmaxf(sigma, 0.0f)), alpha_max);
        if (alpha < alpha_clip || sigma < 0.0f) continue;
        const float w = alpha * T;
        acc_r += w * sh[6][k];
        acc_g += w * sh[7][k];
        acc_b += w * sh[8][k];
        acc_d += w * sh[9][k];
        acc_a += w;
        T *= 1.0f - alpha;
        if (T <= tmin) break;
      }
    }
  }

  const size_t pix = static_cast<size_t>(tile) * P + tid;
  rgb_out[pix * 3 + 0] = acc_r;
  rgb_out[pix * 3 + 1] = acc_g;
  rgb_out[pix * 3 + 2] = acc_b;
  alpha_out[pix] = acc_a;
  depth_out[pix] = acc_d;
  if (tid == 0) live_out[tile] = live;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int composite_fwd(const float* gT, const int* counts, int num_tiles,
                             int K, int ts, float alpha_clip, float alpha_max,
                             float tmin, float* rgb, float* alpha, float* depth,
                             float* live, void* stream) {
  if (num_tiles > 0) {
    composite_fwd_kernel<<<num_tiles, ts * ts, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        gT, counts, K, ts, alpha_clip, alpha_max, tmin, rgb, alpha, depth,
        live);
  }
  return static_cast<int>(cudaGetLastError());
}
