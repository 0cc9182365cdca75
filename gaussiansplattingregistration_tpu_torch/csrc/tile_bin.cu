// Tile binning on Hopper: the rasterizer's tile table built from the entries
// that exist, with no [N, C] slot array and no 64-bit key.
//
// Replaces no TPU kernel: the JAX package bins in XLA
// (`gaussiansplattingregistration_tpu/ops/rasterize.py::_build_tile_table`),
// not in Pallas. It was added because the port's plain form of that build
// (`gaussiansplattingregistration_tpu_torch/ops/rasterize.py::
// _build_tile_table_plain`) keys every one of the N x C slots a splat may
// emit, as int64, and sorts them all: at 2.2M splats and C = 36 that is 79M
// keys a view, of which about 4% are entries (`photo_pair_step`), and some
// 25 passes of 634 MB besides the sort.
//
// What it computes is the plain form's table, integer for integer. Each
// valid splat n keeps the tiles of its clamped rectangle, clipped to the
// window of C tiles centred on its mean's tile, within the slab
// [ty_offset, ty_offset + tiles_y_window); slot c of that window is entry
// n * C + c, in tile (ty0 + dy - ty_offset) * tiles_x + tx0 + dx with
// dx = c % w + ox, dy = c / w + oy. Its key, as a u32, is
// (tile << depth_bits) | (depth's float bits >> (32 - depth_bits)), the
// JAX package's key. The steps:
//   1. count (`count_kernel`, a thread a splat): n_i, the entries of splat i;
//   2. cub::DeviceScan::ExclusiveSum over n_i: each splat's first entry; the
//      wrapper reads the total, 4 bytes, to size what follows;
//   3. emit (`emit_kernel`, a thread a splat): the n_i (key, entry) pairs in
//      c order, so the array is in entry-id order;
//   4. cub::DeviceRadixSort::SortPairs over key bits [0, 32): stable, so
//      equal keys keep entry-id order, the plain form's tie order;
//   5. runs (`runs_kernel`, a thread a tile): each tile's run by two binary
//      searches of the sorted keys; counts = min(run, K);
//   6. fill (`fill_kernel`, a block a table row, rows in the order the
//      wrapper gives): the row's first min(run, K) entry ids, -1 past them.
// Every float operation is the plain form's, rounded on its own: v - r and
// v + r by __fsub_rn / __fadd_rn, v / tile_size by __fdiv_rn, floor, then
// the clamp to [0, hi] in float before the conversion.
//
// What bounds it on the card: bytes. The least a call must move is each
// splat's flag (1 B), a valid splat's mean, radius and depth (16 B), and
// the [T, K] int32 table with its counts and order (8 B a tile): at the
// photometric cell's view (2.2M splats of which ~0.61M valid, T = 6370,
// K = 3072) about 90 MB, 27 us at 3.35 TB/s. The sorted entry ids it also
// returns (4 B an entry) are counted apart. The scan, the radix sort's four
// passes over 8-byte pairs and the two splat passes add some 0.3 GB of
// traffic on top of that least. What the design does about it: only
// entries are keyed, sorted and read back (the plain form moves ~25 x
// 634 MB and sorts 79M 16-byte pairs in 8 passes); the key is 32 bits;
// no tensor of the slot count and no int64 tensor of the entry count is
// allocated; the run bounds come from binary searches, not a pass over
// the entries; the table rows are written whole and coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/device/device_radix_sort.cuh>
#include <cub/device/device_scan.cuh>

namespace {

constexpr int kThreads = 256;

struct Bins {
  int tiles_x, tiles_y, ty_offset, window, C, s_eff, depth_bits;
  float ts;
};

// floor(v / ts) clamped to [0, hi], as the plain form's `tile_of`.
__device__ __forceinline__ int tile_of(float v, float ts, int hi) {
  float f = floorf(__fdiv_rn(v, ts));
  f = fminf(fmaxf(f, 0.0f), static_cast<float>(hi));
  return static_cast<int>(f);
}

// A valid splat's clipped window: its top-left tile, its used width and
// height and the offsets of the centred sub-window.
struct Window {
  int tx0, ty0, w, h, ox, oy;
  bool clipped;
};

__device__ __forceinline__ Window window_of(float mx, float my, float r, const Bins& b) {
  Window win;
  win.tx0 = tile_of(__fsub_rn(mx, r), b.ts, b.tiles_x - 1);
  win.ty0 = tile_of(__fsub_rn(my, r), b.ts, b.tiles_y - 1);
  const int w = tile_of(__fadd_rn(mx, r), b.ts, b.tiles_x - 1) - win.tx0 + 1;
  const int h = tile_of(__fadd_rn(my, r), b.ts, b.tiles_y - 1) - win.ty0 + 1;
  const int w_eff = min(w, b.s_eff);
  const int h_eff = min(h, b.C / max(w_eff, 1));
  win.clipped = w * h > b.C;
  if (win.clipped) {
    const int mtx = tile_of(mx, b.ts, b.tiles_x - 1);
    const int mty = tile_of(my, b.ts, b.tiles_y - 1);
    win.w = w_eff;
    win.h = h_eff;
    win.ox = min(max(mtx - win.tx0 - (w_eff - 1) / 2, 0), w - w_eff);
    win.oy = min(max(mty - win.ty0 - (h_eff - 1) / 2, 0), h - h_eff);
  } else {
    win.w = w;
    win.h = h;
    win.ox = 0;
    win.oy = 0;
  }
  return win;
}

// The slots c < min(C, w h) whose row lies in the slab are entries; rows
// grow with c, so they are one run of c.
__device__ __forceinline__ bool in_slab(const Window& win, int c, const Bins& b, int* tile) {
  const int local_ty = win.ty0 + c / win.w + win.oy - b.ty_offset;
  *tile = local_ty * b.tiles_x + win.tx0 + c % win.w + win.ox;
  return local_ty >= 0 && local_ty < b.window;
}

// Thread i < N writes n_i to counts[i]; thread N writes counts[N] = 0, so
// the exclusive scan's last value is the total. Valid splats that keep
// fewer tiles than they cover add one to *clipped (when given).
__global__ void count_kernel(const float* __restrict__ means2d, const float* __restrict__ radius,
                             const unsigned char* __restrict__ valid, int N, Bins b,
                             int* __restrict__ counts, int* __restrict__ clipped) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > N) return;
  int n = 0;
  if (i < N && valid[i]) {
    const Window win = window_of(means2d[2 * i], means2d[2 * i + 1], radius[i], b);
    const int slots = min(b.C, win.w * win.h);
    for (int c = 0; c < slots; ++c) {
      int tile;
      n += in_slab(win, c, b, &tile);
    }
    if (clipped != nullptr && win.clipped) atomicAdd(clipped, 1);
  }
  counts[i] = n;
}

__global__ void emit_kernel(const float* __restrict__ means2d, const float* __restrict__ radius,
                            const float* __restrict__ depth, int depth_stride,
                            const unsigned char* __restrict__ valid, int N, Bins b,
                            const int* __restrict__ offsets, unsigned* __restrict__ keys,
                            int* __restrict__ ids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N || !valid[i]) return;
  const Window win = window_of(means2d[2 * i], means2d[2 * i + 1], radius[i], b);
  const unsigned dbits =
      __float_as_uint(fmaxf(depth[static_cast<size_t>(i) * depth_stride], 0.0f)) >>
      (32 - b.depth_bits);
  const int slots = min(b.C, win.w * win.h);
  int at = offsets[i];
  for (int c = 0; c < slots; ++c) {
    int tile;
    if (in_slab(win, c, b, &tile)) {
      keys[at] = (static_cast<unsigned>(tile) << b.depth_bits) | dbits;
      ids[at] = i * b.C + c;
      ++at;
    }
  }
}

// The first index of sorted[0, n) whose value is >= target.
__device__ __forceinline__ int lower_bound(const unsigned* __restrict__ sorted, int n,
                                           unsigned long long target) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<unsigned long long>(sorted[mid]) < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void runs_kernel(const unsigned* __restrict__ sorted_keys, int E, int T,
                            int depth_bits, int K, int* __restrict__ starts,
                            int* __restrict__ runs, int* __restrict__ counts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const unsigned long long tile = static_cast<unsigned long long>(t);
  const int s = lower_bound(sorted_keys, E, tile << depth_bits);
  const int e = lower_bound(sorted_keys, E, (tile + 1) << depth_bits);
  starts[t] = s;
  runs[t] = e - s;
  counts[t] = min(e - s, K);
}

// Row r holds tile order[r] (tile r without an order).
__global__ void fill_kernel(const int* __restrict__ sorted_ids, const int* __restrict__ starts,
                            const int* __restrict__ runs, const int* __restrict__ order, int K,
                            int* __restrict__ table) {
  const int r = blockIdx.x;
  const int t = order != nullptr ? order[r] : r;
  const int s = starts[t];
  const int n = min(runs[t], K);
  int* row = table + static_cast<size_t>(r) * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) row[k] = k < n ? sorted_ids[s + k] : -1;
}

int blocks(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

}  // namespace

// Scratch bytes of step 2 over n + 1 counts (< 0: a cudaError).
extern "C" long long tile_bin_scan_bytes(int n) {
  size_t bytes = 0;
  const cudaError_t err = cub::DeviceScan::ExclusiveSum(
      nullptr, bytes, static_cast<const int*>(nullptr), static_cast<int*>(nullptr), n + 1);
  return err == cudaSuccess ? static_cast<long long>(bytes) : -static_cast<long long>(err);
}

// Scratch bytes of step 4 over E pairs (< 0: a cudaError).
extern "C" long long tile_bin_sort_bytes(int E) {
  size_t bytes = 0;
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, bytes, static_cast<const unsigned*>(nullptr), static_cast<unsigned*>(nullptr),
      static_cast<const int*>(nullptr), static_cast<int*>(nullptr), E, 0, 32);
  return err == cudaSuccess ? static_cast<long long>(bytes) : -static_cast<long long>(err);
}

// Steps 1-2 on `stream`; returns a cudaError (0 = launched). means2d [N, 2]
// and radius [N] float32, valid [N] bool, all contiguous; counts and
// offsets [N + 1] int32 are written (offsets[N] = the entries); clipped, a
// zeroed int32 or null, counts the valid splats clipped at C.
extern "C" int tile_bin_count(const float* means2d, const float* radius, const void* valid, int N,
                              int tiles_x, int tiles_y, int ty_offset, int window, int C,
                              int s_eff, int depth_bits, float ts, int* counts, int* offsets,
                              int* clipped, void* scratch, long long scratch_bytes,
                              void* stream) {
  if (N < 0 || C < 1 || tiles_x < 1 || tiles_y < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Bins b{tiles_x, tiles_y, ty_offset, window, C, s_eff, depth_bits, ts};
  count_kernel<<<blocks(static_cast<long long>(N) + 1), kThreads, 0, st>>>(
      means2d, radius, static_cast<const unsigned char*>(valid), N, b, counts, clipped);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  size_t bytes = static_cast<size_t>(scratch_bytes);
  err = cub::DeviceScan::ExclusiveSum(scratch, bytes, counts, offsets, N + 1, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Steps 3-4 on `stream`. keys and ids hold 2 E values each: the emitted
// pairs go to the first E, the sorted pairs to the last E.
extern "C" int tile_bin_emit_sort(const float* means2d, const float* radius, const float* depth,
                                  int depth_stride, const void* valid, int N, int tiles_x,
                                  int tiles_y, int ty_offset, int window, int C, int s_eff,
                                  int depth_bits, float ts, const int* offsets, int E,
                                  unsigned* keys, int* ids, void* scratch,
                                  long long scratch_bytes, void* stream) {
  if (E <= 0) return cudaGetLastError();
  if (N < 1 || depth_bits < 8 || depth_bits > 31) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Bins b{tiles_x, tiles_y, ty_offset, window, C, s_eff, depth_bits, ts};
  emit_kernel<<<blocks(N), kThreads, 0, st>>>(means2d, radius, depth, depth_stride,
                                              static_cast<const unsigned char*>(valid), N, b,
                                              offsets, keys, ids);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  size_t bytes = static_cast<size_t>(scratch_bytes);
  err = cub::DeviceRadixSort::SortPairs(scratch, bytes, keys, keys + E, ids, ids + E, E, 0, 32,
                                        st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Step 5 on `stream`: starts, runs and counts [T] int32 of each tile.
extern "C" int tile_bin_runs(const unsigned* sorted_keys, int E, int T, int depth_bits, int K,
                             int* starts, int* runs, int* counts, void* stream) {
  if (T <= 0) return cudaGetLastError();
  if (E < 0 || K < 1 || depth_bits < 8 || depth_bits > 31) return cudaErrorInvalidValue;
  runs_kernel<<<blocks(T), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sorted_keys, E, T, depth_bits, K, starts, runs, counts);
  return cudaGetLastError();
}

// Step 6 on `stream`: table [T, K] int32 (row r holds tile order[r], or
// tile r where order is null).
extern "C" int tile_bin_fill(const int* sorted_ids, const int* starts, const int* runs,
                             const int* order, int T, int K, int* table, void* stream) {
  if (T <= 0) return cudaGetLastError();
  if (K < 1) return cudaErrorInvalidValue;
  fill_kernel<<<T, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sorted_ids, starts, runs, order, K, table);
  return cudaGetLastError();
}
