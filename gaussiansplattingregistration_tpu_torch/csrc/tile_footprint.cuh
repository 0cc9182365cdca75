// Per-warp footprint culling, shared by composite_fwd.cu and composite_bwd.cu.
//
// Both compositors run one CTA per tile and one thread per pixel, and stage
// the tile's depth-sorted entries 128 at a time in shared memory. Most
// (pixel, entry) pairs are invisible: an entry's footprint at alpha_clip is
// a few pixels across, a tile 16x16. So each warp holds a compact pixel
// block, each staged entry gets a conservative box of the pixel centres at
// which the kernel could find it visible, and each warp keeps the entries
// whose box meets its own block as a 128-bit list (four ballots). A warp
// then steps through the set bits only, in entry order, so front-to-back
// compositing is unchanged: a culled entry is one the warp's pixels would
// have skipped anyway.
//
// The box. Visible means alpha = min(op exp(-max(sigma, 0)), alpha_max) >=
// alpha_clip and sigma >= 0, with sigma = 0.5 (a dx^2 + c dy^2) + b dx dy.
// As exp(-sigma) <= 1, op < alpha_clip is never visible (empty box). For a
// positive-definite conic, sigma <= s_max = ln(op / alpha_clip) is an
// ellipse whose half-extents are sqrt(2 s_max c / det) in x and
// sqrt(2 s_max a / det) in y (det = ac - b^2). Any other conic, a non-finite
// parameter or alpha_clip <= 0 gets the whole plane: where sigma can be
// negative or vanish along a line, the visible set is unbounded.
//
// Why the margin suffices. The kernel evaluates sigma, the exp and the
// product in f32. (1) sigma: with |b| < sqrt(ac), |b dx dy| <= (a dx^2 +
// c dy^2) / 2, and each of the ~8 roundings (dx included, with or without
// FMA contraction) errs by at most 2^-24 of the terms it combines, so the
// computed sigma is at least sigma - 6e-7 (a dx^2 + c dy^2). Shrinking a
// and c by kShrink = 1e-5 gives the form sigma - 5e-6 (a dx^2 + c dy^2),
// which is below the computed sigma everywhere: its ellipse contains every
// pixel centre the kernel can find inside. (2) The exp (at most 2 ulp in
// CUDA) and the product make the computed alpha at most 3.1e-7 relative
// above op exp(-sigma), which moves the threshold on sigma by 3.1e-7;
// s_max is inflated by 1e-3 relative plus 1e-3. (3) The box itself is
// computed in f64 from the f32 parameters (a product of two f32 values is
// exact in f64; det is cancelled in one rounding, and a det below 1e-9 ac
// counts as degenerate, so its relative error stays under 2e-7). The
// extents get 1e-3 relative plus 1e-3 px, and the edges are rounded
// outward to f32. `raster_cuda.entry_footprints` is the plain-torch
// formula, held by tests/test_torch_footprint.py to never drop a pair the
// twin composites, on boundary, threshold, indefinite and off-tile cases.
//
// Warp layout: with tile_size a multiple of 8, warp w holds the 8x4 block
// at ((w % (ts/8)) * 8, (w / (ts/8)) * 4), lane l its pixel (l % 8, l / 8);
// otherwise the warps are row-major runs of 32 pixels. Blocks have ts*ts
// threads rounded up to whole warps; the extra lanes hold no pixel.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace footprint {

constexpr int kChunk = 128;  // entries staged per step; the horizon's unit
constexpr int kChannels = 10;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWords = kChunk / 32;  // ballot words per chunk

constexpr double kShrink = 1e-5;  // relative cut of a and c
constexpr double kRel = 1e-3;     // relative inflation of s_max and the extents
constexpr double kAbs = 1e-3;     // absolute inflation (s_max, then px)
constexpr double kMinDet = 1e-9;  // det / (a c) below this: degenerate

// Pixel (x, y) of thread `tid` (see the layout above).
__device__ __forceinline__ void thread_pixel(int tid, int ts, int& x, int& y) {
  if (ts % 8 == 0) {
    const int warp = tid >> 5;
    const int lane = tid & 31;
    x = (warp % (ts / 8)) * 8 + (lane & 7);
    y = (warp / (ts / 8)) * 4 + (lane >> 3);
  } else {
    x = tid % ts;
    y = tid / ts;
  }
}

// The box of the warp's pixel centres (x0, x1, y0, y1). All lanes call it.
__device__ __forceinline__ float4 warp_box(bool pixel, int x, int y) {
  const int x0 = __reduce_min_sync(kFullMask, pixel ? x : INT_MAX);
  const int x1 = __reduce_max_sync(kFullMask, pixel ? x : INT_MIN);
  const int y0 = __reduce_min_sync(kFullMask, pixel ? y : INT_MAX);
  const int y1 = __reduce_max_sync(kFullMask, pixel ? y : INT_MIN);
  return make_float4(x0 + 0.5f, x1 + 0.5f, y0 + 0.5f, y1 + 0.5f);
}

// The conservative box (x0, x1, y0, y1) of the pixel centres at which the
// entry can be visible.
__device__ __forceinline__ float4 entry_box(float mx, float my, float a, float b,
                                            float c, float op, float alpha_clip) {
  const float4 whole = make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
  const float4 empty = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  if (!(isfinite(mx) && isfinite(my) && isfinite(a) && isfinite(b) &&
        isfinite(c) && isfinite(op) && alpha_clip > 0.0f)) {
    return whole;
  }
  if (op < alpha_clip) return empty;
  const double ad = static_cast<double>(a) * (1.0 - kShrink);
  const double cd = static_cast<double>(c) * (1.0 - kShrink);
  const double bd = static_cast<double>(b);
  const double det = ad * cd - bd * bd;
  if (!(ad > 0.0 && cd > 0.0 && det > kMinDet * ad * cd)) return whole;
  const double s =
      log(static_cast<double>(op) / static_cast<double>(alpha_clip)) * (1.0 + kRel) + kAbs;
  const double hx = sqrt(2.0 * s * cd / det) * (1.0 + kRel) + kAbs;
  const double hy = sqrt(2.0 * s * ad / det) * (1.0 + kRel) + kAbs;
  return make_float4(__double2float_rd(mx - hx), __double2float_ru(mx + hx),
                     __double2float_rd(my - hy), __double2float_ru(my + hy));
}

// Stage chunk [base, base + n) of the tile's ten rows into sh (zeros past
// n), with coalesced loads: rows of gT are contiguous along K.
__device__ __forceinline__ void stage_chunk(float (*sh)[kChunk], const float* g,
                                            int K, int base, int n) {
  for (int i = threadIdx.x; i < kChannels * kChunk; i += blockDim.x) {
    const int ch = i / kChunk;
    const int k = i % kChunk;
    sh[ch][k] = k < n ? g[static_cast<size_t>(ch) * K + base + k] : 0.0f;
  }
}

// The staged entries' boxes (empty past n). Call after sh is staged and
// synchronised.
__device__ __forceinline__ void stage_boxes(float4* box, const float (*sh)[kChunk],
                                            int n, float alpha_clip) {
  for (int k = threadIdx.x; k < kChunk; k += blockDim.x) {
    box[k] = k < n ? entry_box(sh[0][k], sh[1][k], sh[2][k], sh[3][k], sh[4][k],
                               sh[5][k], alpha_clip)
                   : make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  }
}

// The warp's list: bit j of word q is set iff entry 32 q + j's box meets
// the warp's. All lanes call it and get the same words.
__device__ __forceinline__ void warp_list(const float4* box, float4 wb, int lane,
                                          unsigned (&words)[kWords]) {
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const float4 e = box[q * 32 + lane];
    words[q] = __ballot_sync(kFullMask, e.x <= wb.y && e.y >= wb.x &&
                                            e.z <= wb.w && e.w >= wb.z);
  }
}

struct Terms {
  float dx, dy, sigma, ex, raw, alpha;
};

// The forward terms of staged entry k at pixel centre (px, py); true iff
// the compositor composites it with alpha > 0 (the JAX kernel's mask).
__device__ __forceinline__ bool entry_terms(const float (*sh)[kChunk], int k,
                                            float px, float py, float alpha_clip,
                                            float alpha_max, Terms& e) {
  e.dx = px - sh[0][k];
  e.dy = py - sh[1][k];
  e.sigma = 0.5f * (sh[2][k] * e.dx * e.dx + sh[4][k] * e.dy * e.dy) +
            sh[3][k] * e.dx * e.dy;
  e.ex = expf(-fmaxf(e.sigma, 0.0f));
  e.raw = sh[5][k] * e.ex;
  e.alpha = fminf(e.raw, alpha_max);
  return e.alpha > 0.0f && !(e.alpha < alpha_clip || e.sigma < 0.0f);
}

}  // namespace footprint
