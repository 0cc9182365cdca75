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
// What bounds it on the card: the least work is the formula on the pairs it
// composites (visible pairs, 30 FP32 operations each with the visibility
// test) against reading each tile's entries before min(count, live) once
// and writing [T,P,5] once. At the bench scene only a tenth of the alive
// (pixel, entry) pairs are visible, and the bytes take longer than that
// arithmetic: the bound is bytes (`chip_smoke.py` computes both from the
// frame's counts). What costs time beyond it is the visibility test on
// pairs that turn out invisible.
//
// What the design does about it:
// * per-warp footprint culling (`tile_footprint.cuh`): each warp holds an
//   8x4 pixel block and steps only through the staged entries whose
//   conservative box meets it, so most invisible pairs are never tested;
// * a thread stops its own scan once its T <= tmin (later weights are zero);
// * at each chunk boundary the block votes with __syncthreads_or(T > tmin)
//   and leaves once no pixel is alive - exact, because later entries add
//   zero - and the same vote accounts the live horizon;
// * the scan stops at counts[t], so empty slots cost nothing;
// * each 128-entry chunk of the 10 channel rows is staged once in shared
//   memory (5 KB, plus 2 KB of boxes) with coalesced loads, and every
//   thread then reads the entry's parameters as broadcasts;
// * at most 40 registers a thread (`__maxnreg__`; a few bytes spill), so
//   six 256-thread blocks fit an SM instead of four: the loop is
//   latency-bound, and the cap measured faster than none (`PERF.md`).
// A pixel still composites its visible entries in entry order, so the
// outputs are those of the unculled loop.
//
// Layout: gT [T, 10, K] f32, channels (mx, my tile-local, conic a, b, c,
// opacity, r, g, b, depth); counts [T] int32; outputs rgb [T, P, 3],
// alpha [T, P], depth [T, P], live [T] f32 with P = ts*ts and pixel
// p = y*ts + x centred at (x + 0.5, y + 0.5).

#include <cuda_runtime.h>

#include "tile_footprint.cuh"

namespace {

using namespace footprint;

// __maxnreg__ rather than __launch_bounds__(256, 6), which would also cap
// the block at 256 threads (tile_size 16) where the wrapper allows 1024.
__global__ void __maxnreg__(40) composite_fwd_kernel(const float* __restrict__ gT,
                                     const int* __restrict__ counts,
                                     int K, int ts, float alpha_clip,
                                     float alpha_max, float tmin,
                                     float* __restrict__ rgb_out,
                                     float* __restrict__ alpha_out,
                                     float* __restrict__ depth_out,
                                     float* __restrict__ live_out) {
  __shared__ float sh[kChannels][kChunk];
  __shared__ float4 box[kChunk];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int P = ts * ts;
  const bool pixel = tid < P;
  int x, y;
  thread_pixel(tid, ts, x, y);
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const float4 wb = warp_box(pixel, x, y);
  const float* g = gT + static_cast<size_t>(tile) * kChannels * K;
  const int count = min(max(counts[tile], 0), K);

  float T = pixel ? 1.0f : 0.0f;  // lanes without a pixel are never alive
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f, acc_a = 0.0f;
  float live = 0.0f;

  for (int base = 0; base < count; base += kChunk) {
    // Barrier + vote: no thread still reads the previous chunk, and the
    // chunk counts toward the horizon iff some pixel is alive at its start.
    if (!__syncthreads_or(T > tmin)) break;
    live += static_cast<float>(kChunk);
    const int n = min(kChunk, count - base);
    stage_chunk(sh, g, K, base, n);
    __syncthreads();
    stage_boxes(box, sh, n, alpha_clip);
    __syncthreads();
    unsigned words[kWords];
    warp_list(box, wb, lane, words);
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      unsigned bits = words[q];
      while (bits != 0u && T > tmin) {
        const int k = q * 32 + __ffs(bits) - 1;
        bits &= bits - 1u;
        Terms e;
        if (!entry_terms(sh, k, px, py, alpha_clip, alpha_max, e)) continue;
        const float w = e.alpha * T;
        acc_r += w * sh[6][k];
        acc_g += w * sh[7][k];
        acc_b += w * sh[8][k];
        acc_d += w * sh[9][k];
        acc_a += w;
        T *= 1.0f - e.alpha;
      }
    }
  }

  if (pixel) {
    const size_t pix = static_cast<size_t>(tile) * P + y * ts + x;
    rgb_out[pix * 3 + 0] = acc_r;
    rgb_out[pix * 3 + 1] = acc_g;
    rgb_out[pix * 3 + 2] = acc_b;
    alpha_out[pix] = acc_a;
    depth_out[pix] = acc_d;
  }
  if (tid == 0) live_out[tile] = live;
}

// The culling box of every entry of gT [T, 10, K], as `entry_box` computes
// it in both kernels, into boxes [T, K] (x0, x1, y0, y1): for checks.
__global__ void entry_boxes_kernel(const float* __restrict__ gT, int num_tiles,
                                   int K, float alpha_clip,
                                   float4* __restrict__ boxes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_tiles * K) return;
  const float* g = gT + static_cast<size_t>(i / K) * kChannels * K + i % K;
  boxes[i] = entry_box(g[0], g[K], g[2 * K], g[3 * K], g[4 * K], g[5 * K],
                       alpha_clip);
}

}  // namespace

extern "C" int entry_boxes(const float* gT, int num_tiles, int K,
                           float alpha_clip, float* boxes, void* stream) {
  if (num_tiles > 0 && K > 0) {
    const int n = num_tiles * K;
    entry_boxes_kernel<<<(n + 255) / 256, 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        gT, num_tiles, K, alpha_clip, reinterpret_cast<float4*>(boxes));
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int composite_fwd(const float* gT, const int* counts, int num_tiles,
                             int K, int ts, float alpha_clip, float alpha_max,
                             float tmin, float* rgb, float* alpha, float* depth,
                             float* live, void* stream) {
  if (num_tiles > 0) {
    const int threads = (ts * ts + 31) / 32 * 32;
    composite_fwd_kernel<<<num_tiles, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        gT, counts, K, ts, alpha_clip, alpha_max, tmin, rgb, alpha, depth,
        live);
  }
  return static_cast<int>(cudaGetLastError());
}
