// The k largest scores of each row, with their column indices, in the order
// of a stable descending sort (torch.sort's): values descending, equal
// values by the lower index first, -0.0 equal to +0.0, NaN above +inf. That
// is lax.top_k's order but at signed zeros, which XLA ranks +0.0 first.
//
// Replaces no TPU kernel: the JAX package leaves `lax.top_k` to XLA, and the
// port called torch's stable sort (models/retrieval_pipeline.py
// `top_k_stable_plain`), which radix-sorts every row in full (cub's onesweep
// passes over a clone of the scores and their int64 indices) to keep k of
// them.
//
// What bounds it on the H100: bytes. The scores are read once, R G 4 bytes
// (the serving query's 50 x 1,000,000 f32 scores: 200 MB, 0.060 ms at 3.35
// TB/s); what it writes is R k values and indices. What the design does
// about it:
// - A candidate is one 64-bit word, the score's order key above the
//   complement of its column, so that "better" is one unsigned compare: the
//   key maps the float's bits to an unsigned order (negatives' bits
//   flipped, positives' sign bit set), with -0.0 taken as +0.0 and every NaN
//   as the largest key; the complemented column puts the lower index first
//   among equal keys. The key gives the value's bits back, but for the
//   sign of a zero and the payload of a NaN, which are read back from the
//   scores at the end, so the values are the input's bits.
// - Stage 1, a grid of S slices x R rows: each thread streams its CTA's
//   slice of one row with 16-byte loads, four a pass, the next pass's in
//   flight while this one's are read (scalar loads for the row's head
//   before the first 16-byte boundary and its ragged tail), and
//   keeps a sorted list of its K best candidates in registers. A score has
//   to pass a bar: the larger of the list's last entry and the K-th largest
//   of the warp's lanes' best entries, which the warp refreshes between
//   passes where a list changed. Most scores fall below it, so the common
//   path is one f32 compare; a better candidate is inserted by a chain of
//   compare-exchanges. (Against the thread's own list alone, some lane of
//   a warp would insert at almost every score, and the warp with it.) The
//   warp's top K is then drawn by K rounds of a warp max (two 32-bit
//   reductions), each popping the winner's head, and warp 0 draws the CTA's top K from the warps'
//   lists in shared memory into a scratch of (R, S, K) words.
// - Stage 2, one warp a row, merges the row's S K candidates the same way
//   and writes the first k values and indices. It exists because a row's
//   slices run in different CTAs, on different SMs: one CTA a row would
//   leave most of the card idle at 50 rows (and all but one SM at one row),
//   and a single pass would need the CTAs of a row to meet in device memory.
//   The split S is the caller's, from the shape (ops/topk.py), so that R S
//   CTAs fill the card and no slice is too short to amortise its merge.
// - K is a template argument (1, 2, 4, 5, 8, 12, 16, 24 or 32; k rounds up
//   to the next), so the lists stay in registers and every loop unrolls.
// - No sort, no copy of the scores, no allocation; both stages launch on the
//   caller's stream, so a CUDA graph can capture them.
#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace vv {
namespace topk {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;

// The order key of a score: larger key, better score. -0.0 keys as +0.0;
// every NaN keys above +inf.
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned b = __float_as_uint(v);
  b = v == 0.f ? 0u : b;
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return v != v ? 0xffffffffu : b;
}

// A candidate: the key above the complemented column. 0 is below every
// real candidate (no float keys to 0), so it marks an empty place.
__device__ __forceinline__ u64 candidate(float v, unsigned col) {
  return (static_cast<u64>(order_key(v)) << 32) | static_cast<u64>(~col);
}

__device__ __forceinline__ unsigned column_of(u64 c) {
  return ~static_cast<unsigned>(c);
}

// The score whose key a candidate holds (-0.0 as +0.0, every NaN as one
// NaN); -inf for an empty place.
__device__ __forceinline__ float score_of(u64 c) {
  const unsigned key = static_cast<unsigned>(c >> 32);
  if (key == 0u) return -INFINITY;
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ u64 larger(u64 a, u64 b) { return a > b ? a : b; }

// Inserts c into the descending list, dropping its smallest entry.
template <int K>
__device__ __forceinline__ void insert(u64 (&list)[K], u64 c) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const u64 hi = larger(list[j], c);
    c = list[j] > c ? c : list[j];
    list[j] = hi;
  }
}

// The warp's largest `c`, in every lane: the largest key, then the largest
// low word among the lanes that hold it (two warp reductions).
__device__ __forceinline__ u64 warp_max(u64 c) {
  const unsigned hi = static_cast<unsigned>(c >> 32);
  const unsigned top = __reduce_max_sync(0xffffffffu, hi);
  const unsigned lo = __reduce_max_sync(0xffffffffu, hi == top ? static_cast<unsigned>(c) : 0u);
  return (static_cast<u64>(top) << 32) | lo;
}

// A thread's K best candidates so far, and the bar a candidate has to pass
// to enter them: the larger of the list's last entry and the warp's bar,
// the K-th largest distinct key of the warp's lanes' best entries when it
// was last refreshed (low word 0). K lanes hold an entry at or above the
// warp's bar, so a candidate below it is not among the row's K best. A
// score is first held against the bar's score in f32 (not below it: NaN
// and a signed zero of the bar's value pass, to be decided by their keys),
// so that most scores cost one compare.
template <int K>
struct Keeper {
  u64 list[K];
  u64 warp_bar, bar;
  float bar_score;
  bool changed;

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < K; ++j) list[j] = 0ull;
    warp_bar = bar = 0ull;
    bar_score = -INFINITY;
    changed = false;
  }

  __device__ __forceinline__ void offer(float v, unsigned col) {
    if (v < bar_score) return;
    const u64 c = candidate(v, col);
    if (c <= bar) return;
    insert(list, c);
    changed = true;
    bar = larger(warp_bar, list[K - 1]);
    bar_score = score_of(bar);
  }

  __device__ __forceinline__ void offer4(const float4& q, unsigned col) {
    offer(q.x, col);
    offer(q.y, col + 1);
    offer(q.z, col + 2);
    offer(q.w, col + 3);
  }

  // Every lane of the warp calls it together.
  __device__ __forceinline__ void refresh() {
    if (!__any_sync(0xffffffffu, changed)) return;
    changed = false;
    const unsigned head = static_cast<unsigned>(list[0] >> 32);
    unsigned kth = ~0u;
#pragma unroll
    for (int r = 0; r < K; ++r) kth = __reduce_max_sync(0xffffffffu, head < kth ? head : 0u);
    warp_bar = static_cast<u64>(kth) << 32;
    bar = larger(warp_bar, list[K - 1]);
    bar_score = score_of(bar);
  }
};

// The warp's K best of its lanes' lists, in every lane, in order; the lists
// are consumed.
template <int K>
__device__ __forceinline__ void warp_top(u64 (&list)[K], u64 (&top)[K]) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const u64 best = warp_max(list[0]);
    top[r] = best;
    // candidates are distinct but for empty places, where popping any
    // number of them changes nothing
    const bool won = list[0] == best;
#pragma unroll
    for (int j = 0; j < K - 1; ++j) list[j] = won ? list[j + 1] : list[j];
    list[K - 1] = won ? 0ull : list[K - 1];
  }
}

// Stage 1: CTA b takes slice b % S of row b / S. The row's 16-byte words
// after its head (h scalars up to the first 16-byte boundary) are split
// into S runs of `per`; slice 0 also takes the head and slice S - 1 the
// tail (the last (G - h) % 4 scalars). The CTA's passes of four words a
// thread are whole for every lane, so its warps refresh their bars
// between passes; the words after the last whole pass go one a thread.
// Each warp's K best go to shared memory, warp 0 draws the CTA's K best
// from them into the scratch.
template <int K>
__global__ void __launch_bounds__(kThreads)
    select_slices(const float* __restrict__ scores, long long ld, int G, int S, int per,
                  u64* __restrict__ scratch) {
  __shared__ u64 warps[kWarps * K];
  const int row = blockIdx.x / S, s = blockIdx.x - row * S;
  const float* x = scores + row * ld;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
  const int h = min(G, (4 - mis) & 3);
  const int words = (G - h) >> 2;
  const float4* x4 = reinterpret_cast<const float4*>(x + h);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  Keeper<K> keep;
  keep.clear();
  if (s == 0 && t < h) keep.offer(__ldg(x + t), t);
  const int tail = h + 4 * words;
  if (s == S - 1 && t < G - tail) keep.offer(__ldg(x + tail + t), tail + t);
  const int v0 = min(words, s * per), v1 = min(words, (s + 1) * per);
  const int passes = (v1 - v0) / (4 * kThreads);
  int v = v0 + t;
  float4 q[4], next[4];
  if (passes > 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) q[u] = __ldg(x4 + v + u * kThreads);
  }
  for (int p = 0; p < passes; ++p, v += 4 * kThreads) {
    // the next pass's loads are in flight while this pass's scores are
    // held against the bar
    if (p + 1 < passes) {
#pragma unroll
      for (int u = 0; u < 4; ++u) next[u] = __ldg(x4 + v + (4 + u) * kThreads);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) keep.offer4(q[u], h + 4 * (v + u * kThreads));
    keep.refresh();
#pragma unroll
    for (int u = 0; u < 4; ++u) q[u] = next[u];
  }
  for (; v < v1; v += kThreads) keep.offer4(__ldg(x4 + v), h + 4 * v);
  u64 top[K];
  warp_top(keep.list, top);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) warps[warp * K + j] = top[j];
  }
  __syncthreads();
  if (warp != 0) return;
  u64 mine[K];
#pragma unroll
  for (int j = 0; j < K; ++j) mine[j] = 0ull;
  for (int i = lane; i < kWarps * K; i += 32) insert(mine, warps[i]);
  warp_top(mine, top);
  u64* out = scratch + (static_cast<long long>(row) * S + s) * K;
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (lane == j) out[j] = top[j];
}

// Stage 2: one warp a row merges the row's S K candidates and writes its
// first k values (read back from the scores) and columns.
template <int K>
__global__ void __launch_bounds__(32)
    merge_slices(const float* __restrict__ scores, long long ld, int S,
                 const u64* __restrict__ scratch, int k, float* __restrict__ values,
                 long long* __restrict__ indices) {
  const int row = blockIdx.x, lane = threadIdx.x;
  const u64* in = scratch + static_cast<long long>(row) * S * K;
  u64 list[K];
#pragma unroll
  for (int j = 0; j < K; ++j) list[j] = 0ull;
  for (int i = lane; i < S * K; i += 32) {
    const u64 c = in[i];
    if (c > list[K - 1]) insert(list, c);
  }
  u64 top[K];
  warp_top(list, top);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (lane == j && j < k) {
      const unsigned col = column_of(top[j]);
      // the key gives the score's bits back but for a signed zero's sign
      // and a NaN's payload, which are read from the scores
      float v = score_of(top[j]);
      if (v == 0.f || v != v) v = scores[row * ld + col];
      values[static_cast<long long>(row) * k + j] = v;
      indices[static_cast<long long>(row) * k + j] = col;
    }
  }
}

template <int K>
cudaError_t launch(const float* scores, long long ld, int R, int G, int S, int k,
                   void* scratch, float* values, long long* indices, cudaStream_t st) {
  const long long words = G / 4;
  const int per = static_cast<int>((words + S - 1) / S);
  u64* buf = static_cast<u64*>(scratch);
  select_slices<K><<<static_cast<unsigned>(R) * S, kThreads, 0, st>>>(scores, ld, G, S, per, buf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_slices<K><<<R, 32, 0, st>>>(scores, ld, S, buf, k, values, indices);
  return cudaGetLastError();
}

}  // namespace topk
}  // namespace vv

namespace {

// The list size the kernels keep for k: k rounded up to the next size they
// are built for; 0 for a k they do not take.
int list_size(int k) {
  const int sizes[] = {1, 2, 4, 5, 8, 12, 16, 24, vv::topk::kMaxK};
  if (k <= 0) return 0;
  for (int size : sizes)
    if (k <= size) return size;
  return 0;
}

}  // namespace

// scores (R, G) f32, columns contiguous, rows `ld` elements apart (4-byte
// aligned; a row may start anywhere). values (R, k) f32 and indices (R, k)
// int64 contiguous, 1 <= k <= min(G, 32); scratch R x S x 32 8-byte words.
// S slices a row, 1 <= S, and R S < 2^31. Returns a CUDA error code as an
// int.
extern "C" int vv_top_k_rows(const void* scores, long long ld, int R, int G, int k, int S,
                             void* scratch, void* values, void* indices, int device,
                             void* stream) {
  using namespace vv::topk;
  const int K = list_size(k);
  if (R <= 0 || G <= 0 || k > G || K == 0 || S <= 0 ||
      static_cast<long long>(R) * S > INT_MAX || reinterpret_cast<uintptr_t>(scores) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* x = static_cast<const float*>(scores);
  float* v = static_cast<float*>(values);
  long long* i = static_cast<long long*>(indices);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return static_cast<int>(launch<1>(x, ld, R, G, S, k, scratch, v, i, st));
    case 2: return static_cast<int>(launch<2>(x, ld, R, G, S, k, scratch, v, i, st));
    case 4: return static_cast<int>(launch<4>(x, ld, R, G, S, k, scratch, v, i, st));
    case 5: return static_cast<int>(launch<5>(x, ld, R, G, S, k, scratch, v, i, st));
    case 8: return static_cast<int>(launch<8>(x, ld, R, G, S, k, scratch, v, i, st));
    case 12: return static_cast<int>(launch<12>(x, ld, R, G, S, k, scratch, v, i, st));
    case 16: return static_cast<int>(launch<16>(x, ld, R, G, S, k, scratch, v, i, st));
    case 24: return static_cast<int>(launch<24>(x, ld, R, G, S, k, scratch, v, i, st));
    default: return static_cast<int>(launch<32>(x, ld, R, G, S, k, scratch, v, i, st));
  }
}
