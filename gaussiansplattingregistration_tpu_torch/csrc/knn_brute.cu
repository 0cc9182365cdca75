// Brute-force k nearest neighbours on Hopper: each query's squared distances
// to every data point and the exact selection of its k nearest, in one pass,
// with no [Q, N] tensor in device memory.
//
// Replaces no TPU kernel: the JAX package computes its brute sweeps
// (`ops/knn.py::_pairwise_sqdist` with `lax.top_k` / `argmin`) in XLA, not
// in Pallas. It was added because the port's plain form of that sweep
// (`gaussiansplattingregistration_tpu_torch/ops/knn.py::_knn_blocked` and
// `_nearest_blocked`) writes and reads each pair's distance through device
// memory some five times (sub, square, two adds, then top-k or min): about
// 60 bytes a pair, so at 3.35 TB/s no more than ~55 Gpairs/s. HEM's
// candidate search, the levels' normals and ICP's correspondences all sweep
// that way, and they hold most of a registration job's device time.
//
// What it computes, for query rows q [Q, D] and data rows d [N, D] (float32,
// D <= 4, row-major):
//   d2(i, j) = ((dx^2 + dy^2) + dz^2) (+ dw^2),  dx = q_i.x - d_j.x, ...
// each operation rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn, never
// contracted into an FMA), in the plain form's order, so every distance has
// the plain form's bits; fewer than four coordinates are padded with zeros,
// which add +0 exactly. Output: the k smallest by (d2, index) as one key,
// ascending: d2 [Q, k] float32 and indices [Q, k] int64. Distances are
// non-negative, so their bit patterns, read as unsigned integers, sort as the
// values do: every comparison here is on (bits, index).
//
// What bounds it on the card: arithmetic, not bytes. A pair costs 8 FP32
// operations (3 sub, 3 mul, 2 add) and a compare and a select, about 10
// instructions, at 33.5e12 lane-instructions a second (67 TFLOP/s counts an
// FMA as two): ~3.3 Tpairs/s. The bytes are the data read once per block of
// queries, far below that. What the design does about it:
// * shared-memory staging: a block stages kChunk data points at a time as
//   float4 rows (zero-padded), and every thread reads each point as a
//   broadcast, so a data point costs one shared load per thread and not one
//   global load per pair;
// * register blocking (k = 1): a thread holds kRows queries and reuses each
//   staged point for all of them, with its best (bits, index) in registers;
//   scanning in index order with a strict `<` keeps the lowest index of a
//   tie, torch.min's and argmin's rule;
// * the k-list (k > 1): each thread holds its query's sorted list of k
//   (bits, index) in shared memory, stored column-wise (entry j of thread t
//   at j * kThreads + t, so a warp's lanes always hit distinct banks), and a
//   register copy of the k-th bits as the threshold. Four candidates cost
//   one compare of their least bits against it; the rare survivors are
//   inserted one by one, by shifting the larger entries down. Candidates
//   arrive in index order, so a strict `<` and insertion after equal keys
//   order exact ties by index;
// * the split over N: where the queries alone would leave SMs idle (a few
//   thousand queries fill a fraction of 132 SMs), blocks also split the data
//   into ranges. For k = 1 each block merges into a 64-bit key
//   (bits << 32 | index) with atomicMin, which is exact and deterministic;
//   for k > 1 each range writes its partial list and `merge_kernel` takes
//   the k smallest keys of the partial lists.
// The splits are planned from the card's occupancy (`knn_brute_blocks_per_sm`,
// queried once per device and k).
// WarpSelect's warp-wide queues (Johnson, Douze and Jegou, arXiv:1702.08734)
// would amortise the insertions over a warp; at the k <= 32 and the random
// point order of the registration path the per-thread list's survivors are
// few (about k (1 + ln(N / k)) a query).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // threads a block, both sweep kernels
constexpr int kRows = 4;          // queries a thread holds in the k = 1 kernel
constexpr int kChunk = 512;       // data points staged a step (8 KB)
constexpr int kMaxK = 128;
constexpr int kMaxSplits = 64;
constexpr uint32_t kEmpty = 0xffffffffu;   // an empty slot's bits and index

__device__ __forceinline__ float4 load_point(const float* __restrict__ x, int i, int dim) {
  const float* r = x + static_cast<size_t>(i) * dim;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  v.x = r[0];
  if (dim > 1) v.y = r[1];
  if (dim > 2) v.z = r[2];
  if (dim > 3) v.w = r[3];
  return v;
}

// The bits of the squared distance, summed as the plain form sums it.
template <bool kFour>
__device__ __forceinline__ uint32_t sqdist_bits(const float4 q, const float4 p) {
  const float dx = __fsub_rn(q.x, p.x);
  const float dy = __fsub_rn(q.y, p.y);
  const float dz = __fsub_rn(q.z, p.z);
  float acc = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  acc = __fadd_rn(acc, __fmul_rn(dz, dz));
  if (kFour) {
    const float dw = __fsub_rn(q.w, p.w);
    acc = __fadd_rn(acc, __fmul_rn(dw, dw));
  }
  return __float_as_uint(acc);
}

// Stages data rows [c0, c0 + n) into s.
__device__ __forceinline__ void stage(float4* s, const float* __restrict__ data, int c0,
                                      int n, int dim) {
  for (int j = threadIdx.x; j < n; j += kThreads) s[j] = load_point(data, c0 + j, dim);
}

// Visits every data row of this block's split in index order, staged at
// s[j]: visit(j, index) takes rows j .. j + kStep - 1, and tail(j, index)
// takes one row of a chunk's ragged end.
template <int kStep, typename Visit, typename Tail>
__device__ __forceinline__ void sweep(float4* s, const float* __restrict__ data, int N,
                                      int dim, int per_split, Visit visit, Tail tail) {
  const int begin = blockIdx.y * per_split;
  const int end = min(N, begin + per_split);
  for (int c0 = begin; c0 < end; c0 += kChunk) {
    const int n = min(kChunk, end - c0);
    __syncthreads();  // no thread still reads the previous chunk
    stage(s, data, c0, n, dim);
    __syncthreads();
    if (n == kChunk) {
#pragma unroll 4
      for (int j = 0; j < kChunk; j += kStep) visit(j, c0 + j);
    } else {
      int j = 0;
      for (; j + kStep <= n; j += kStep) visit(j, c0 + j);
      for (; j < n; ++j) tail(j, c0 + j);
    }
  }
}

// k = 1: kRows queries a thread (rows base + r * kThreads), merged across
// splits into keys [Q] (bits << 32 | index, all ones before the sweep).
template <bool kFour>
__global__ void __launch_bounds__(kThreads) nearest_kernel(
    const float* __restrict__ query, const float* __restrict__ data, int Q, int N, int dim,
    int per_split, unsigned long long* __restrict__ keys) {
  __shared__ float4 s[kChunk];
  const int base = blockIdx.x * (kThreads * kRows) + threadIdx.x;
  float4 q[kRows];
  uint32_t best[kRows];
  uint32_t arg[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = base + r * kThreads;
    q[r] = row < Q ? load_point(query, row, dim) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    best[r] = kEmpty;
    arg[r] = kEmpty;
  }
  auto visit = [&](int j, int index) {
    const float4 p = s[j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint32_t b = sqdist_bits<kFour>(q[r], p);
      if (b < best[r]) {
        best[r] = b;
        arg[r] = static_cast<uint32_t>(index);
      }
    }
  };
  sweep<1>(s, data, N, dim, per_split, visit, visit);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = base + r * kThreads;
    if (row < Q && arg[r] != kEmpty)
      atomicMin(keys + row, (static_cast<unsigned long long>(best[r]) << 32) | arg[r]);
  }
}

// keys [Q] -> d2 [Q] and, in place, indices [Q] int64.
__global__ void unpack_kernel(int Q, unsigned long long* keys, float* __restrict__ d2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const unsigned long long key = keys[i];
  d2[i] = __uint_as_float(static_cast<uint32_t>(key >> 32));
  reinterpret_cast<long long*>(keys)[i] = static_cast<long long>(static_cast<uint32_t>(key));
}

// Inserts (b, index) into the sorted list (lb, li; stride kThreads, k
// entries), after the entries of equal bits (they came earlier, so their
// indices are lower), dropping the last. Returns the new k-th bits.
__device__ __forceinline__ uint32_t insert(uint32_t* lb, uint32_t* li, int k, uint32_t b,
                                           uint32_t index) {
  int j = k - 1;
  while (j > 0) {
    const uint32_t prev = lb[(j - 1) * kThreads];
    if (prev <= b) break;
    lb[j * kThreads] = prev;
    li[j * kThreads] = li[(j - 1) * kThreads];
    --j;
  }
  lb[j * kThreads] = b;
  li[j * kThreads] = index;
  return lb[(k - 1) * kThreads];
}

// Dynamic shared memory of topk_kernel: the lists (its staged rows are static).
__host__ __device__ constexpr size_t topk_smem(int k) {
  return 2u * k * kThreads * sizeof(uint32_t);
}

// k > 1: one query a thread. With one split the list goes to the outputs;
// with several, to the partial lists [splits, Q, k] that merge_kernel reads.
// The staged rows and the lists are separate shared arrays, so the loads of
// the next rows need not wait for an insertion's stores; four rows are
// tested against the threshold at once, the rare survivors then one by one
// in index order.
template <bool kFour>
__global__ void __launch_bounds__(kThreads) topk_kernel(
    const float* __restrict__ query, const float* __restrict__ data, int Q, int N, int dim,
    int k, int per_split, float* __restrict__ d2, long long* __restrict__ idx,
    uint32_t* __restrict__ part_bits, uint32_t* __restrict__ part_idx) {
  __shared__ float4 s[kChunk];
  extern __shared__ uint32_t lists[];
  uint32_t* lb = lists + threadIdx.x;
  uint32_t* li = lb + k * kThreads;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const float4 q = row < Q ? load_point(query, row, dim) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j = 0; j < k; ++j) {
    lb[j * kThreads] = kEmpty;
    li[j * kThreads] = kEmpty;
  }
  uint32_t threshold = kEmpty;
  auto one = [&](int j, int index) {
    const uint32_t b = sqdist_bits<kFour>(q, s[j]);
    if (b < threshold) threshold = insert(lb, li, k, b, static_cast<uint32_t>(index));
  };
  auto four = [&](int j, int index) {
    uint32_t b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) b[u] = sqdist_bits<kFour>(q, s[j + u]);
    if (min(min(b[0], b[1]), min(b[2], b[3])) < threshold) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (b[u] < threshold)
          threshold = insert(lb, li, k, b[u], static_cast<uint32_t>(index + u));
    }
  };
  sweep<4>(s, data, N, dim, per_split, four, one);
  if (row >= Q) return;
  if (gridDim.y == 1) {
    const size_t out = static_cast<size_t>(row) * k;
    for (int j = 0; j < k; ++j) {
      d2[out + j] = __uint_as_float(lb[j * kThreads]);
      idx[out + j] = static_cast<long long>(li[j * kThreads]);
    }
  } else {
    const size_t out = (static_cast<size_t>(blockIdx.y) * Q + row) * k;
    for (int j = 0; j < k; ++j) {
      part_bits[out + j] = lb[j * kThreads];
      part_idx[out + j] = li[j * kThreads];
    }
  }
}

// The k smallest (bits, index) keys of each row's partial lists, ascending.
// The data hold at least k rows, so every output is a real row.
__global__ void merge_kernel(int Q, int k, int splits, const uint32_t* __restrict__ part_bits,
                             const uint32_t* __restrict__ part_idx, float* __restrict__ d2,
                             long long* __restrict__ idx) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= Q) return;
  int head[kMaxSplits];
  for (int s = 0; s < splits; ++s) head[s] = 0;
  const size_t out = static_cast<size_t>(row) * k;
  for (int j = 0; j < k; ++j) {
    unsigned long long best = ~0ull;
    int from = 0;
    for (int s = 0; s < splits; ++s) {
      if (head[s] >= k) continue;
      const size_t at = (static_cast<size_t>(s) * Q + row) * k + head[s];
      const unsigned long long key =
          (static_cast<unsigned long long>(part_bits[at]) << 32) | part_idx[at];
      if (key < best) {
        best = key;
        from = s;
      }
    }
    ++head[from];
    d2[out + j] = __uint_as_float(static_cast<uint32_t>(best >> 32));
    idx[out + j] = static_cast<long long>(static_cast<uint32_t>(best));
  }
}

}  // namespace

// The blocks of the sweep kernel for k that fit on one SM at once, on the
// current device; first allows topk_kernel the dynamic shared memory of the
// largest k-list there. Returns -cudaError on a failed call. One call per
// device and k suffices (the wrapper caches it): the split count it feeds
// is planned on the host, so a search makes no query of the card.
extern "C" int knn_brute_blocks_per_sm(int k) {
  if (k < 1 || k > kMaxK) return -static_cast<int>(cudaErrorInvalidValue);
  const int most = static_cast<int>(topk_smem(kMaxK));
  cudaError_t err = cudaFuncSetAttribute(topk_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(topk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = k == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nearest_kernel<false>,
                                                                 kThreads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_kernel<false>,
                                                                 kThreads, topk_smem(k));
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm;
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched). query
// [Q, dim] and data [N, dim] float32 row-major, 1 <= dim <= 4,
// 1 <= k <= min(N, 128), 1 <= splits <= 64 (planned from
// knn_brute_blocks_per_sm, called first on this device); d2 [Q, k]
// float32 and idx [Q, k] int64 are written; part_bits and part_idx, each
// [splits, Q, k] of 32 bits, are scratch for k > 1 with splits > 1.
extern "C" int knn_brute(const float* query, const float* data, int Q, int N, int dim, int k,
                         int splits, float* d2, long long* idx, unsigned* part_bits,
                         unsigned* part_idx, void* stream) {
  if (Q <= 0) return static_cast<int>(cudaGetLastError());
  if (N <= 0 || dim < 1 || dim > 4 || k < 1 || k > kMaxK || k > N || splits < 1 ||
      splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool four = dim == 4;
  int per_split = (N + splits - 1) / splits;
  per_split = (per_split + kChunk - 1) / kChunk * kChunk;
  if (k == 1) {
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(idx);
    cudaError_t err = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * Q, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((Q + kThreads * kRows - 1) / (kThreads * kRows), splits);
    if (four)
      nearest_kernel<true><<<grid, kThreads, 0, st>>>(query, data, Q, N, dim, per_split, keys);
    else
      nearest_kernel<false><<<grid, kThreads, 0, st>>>(query, data, Q, N, dim, per_split, keys);
    unpack_kernel<<<(Q + 255) / 256, 256, 0, st>>>(Q, keys, d2);
    return static_cast<int>(cudaGetLastError());
  }
  // Above 48 KB of dynamic shared memory only as knn_brute_blocks_per_sm
  // allowed it on this device.
  const size_t smem = topk_smem(k);
  const dim3 grid((Q + kThreads - 1) / kThreads, splits);
  if (four)
    topk_kernel<true><<<grid, kThreads, smem, st>>>(query, data, Q, N, dim, k, per_split, d2, idx,
                                                    part_bits, part_idx);
  else
    topk_kernel<false><<<grid, kThreads, smem, st>>>(query, data, Q, N, dim, k, per_split, d2,
                                                     idx, part_bits, part_idx);
  if (splits > 1)
    merge_kernel<<<(Q + 127) / 128, 128, 0, st>>>(Q, k, splits, part_bits, part_idx, d2, idx);
  return static_cast<int>(cudaGetLastError());
}
