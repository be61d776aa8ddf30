// Scaled dot-product attention over sequences read in place from a qkv
// projection's output (bf16, sm_90a): TimeSformer's temporal and spatial
// heads (ops/attention.py, models/timesformer.py).
//
// Replaces no TPU kernel: the JAX package has no attention. It was added
// because TimeSformer's divided blocks run two kinds of head over the same
// tokens in opposite orders, and a library attention would need each kind's
// q, k and v copied into (sequence, head, token, 64) first.
//
// One CTA computes one head of one sequence: the sequence's (and the extra
// token's) q, k and v rows of 64 bf16 are gathered by cp.async straight from
// their rows of qkv (rows of 3 D, token i of sequence (o, j) at row base +
// o so + j si + i st, the ops module's geometry) into shared memory, zero
// past the sequence. Four warps take 16 query rows at a time: S = Q K^T by
// mma.sync m16n8k16 (bf16 in, f32 sums) over the whole row of keys at once,
// the softmax in f32 registers (scale and log2 e in one multiply, exp2, the
// row's max and sum by quad shuffles), then O = P V with P rounded to bf16
// as the MMA's A operand straight from the score registers and V through
// ldmatrix.trans. O is divided by the f32 row sum, rounded once to bf16 and
// staged in the warp's own Q rows so that each row leaves as 16-byte
// stores; the extra token's query output is written in f32.
//
// What bounds it on the H100. At TimeSformer-L's shapes (head 64; temporal
// sequences of 96 tokens, spatial ones of 196 plus the class token) a
// sequence's K and V fit whole in shared memory (197 rows: 57 KB with Q), so
// one pass over the scores needs no online softmax. Each kind reads q, k and
// v and writes its output once: 115.6 MB a block a clip, 34.5 us at 3.35
// TB/s, against 5.6 GFLOP (temporal) and 11.5 (spatial) of MMAs, 6-12 us at
// the bf16 peak: the kernel is bound by bytes, and by how many of them are
// in flight. Rows of 128 bytes are gathered a 4,608-byte (temporal) or
// 442 KB (spatial) stride apart, whole 128-byte lines, so no byte fetched
// is wasted; several CTAs an SM (41 KB or 90 KB of shared memory each)
// overlap one CTA's gathers with another's MMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace vv {
namespace attn {

constexpr int HD = 64;             // head size
constexpr int ROW = HD + 8;        // a shared-memory row: 144 bytes, so that
                                   // ldmatrix's 8 rows hit 8 bank groups
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_TOKENS = 256;

struct Args {
  const __nv_bfloat16* qkv;
  __nv_bfloat16* out;
  float* extra_out;                // (sequences, dim) f32, or null
  long long ld_in, ld_out;         // row strides in elements
  int dim;                         // D = heads x 64
  int length, n_inner;
  long long base, so, si, st, extra_base;  // extra_base < 0: no extra token
  float scale_log2;                // scale x log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, the bytes past `bytes` zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row-major fragments) . b (16 x 8, column fragments b0, b1)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One CTA: head blockIdx.y of sequence blockIdx.x. KC: 16-token chunks held
// of Q, K and V (the sequence with its extra token has at most 16 KC).
template <int KC>
__global__ void __launch_bounds__(THREADS) attention_kernel(const Args g) {
  constexpr int R = 16 * KC;
  constexpr int NT = 2 * KC;  // 8-key tiles of a score row
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  __nv_bfloat16* sq = sm;
  __nv_bfloat16* sk = sq + R * ROW;
  __nv_bfloat16* sv = sk + R * ROW;

  const int seq = blockIdx.x, head = blockIdx.y;
  const long long outer = seq / g.n_inner, inner = seq % g.n_inner;
  const long long first = g.base + outer * g.so + inner * g.si;
  const int ex = g.extra_base >= 0 ? 1 : 0;
  const int n = g.length + ex;  // query and key rows
  const long long extra_row = g.extra_base + outer * g.so;

  // gather: 3 x R rows of 8 16-byte chunks, zero past n
  for (int c = threadIdx.x; c < 3 * R * 8; c += THREADS) {
    const int which = c / (R * 8), r = (c / 8) % R, ch = c % 8;
    const bool valid = r < n;
    const long long row = (ex && r == 0) ? extra_row : first + (r - ex) * g.st;
    const __nv_bfloat16* src =
        valid ? g.qkv + row * g.ld_in + which * g.dim + head * HD + ch * 8 : g.qkv;
    cp_async16(smem_u32(sm + (which * R + r) * ROW + ch * 8), src, valid ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rb = warp; rb < KC && rb * 16 < n; rb += WARPS) {
    uint32_t qa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      ldsm_x4(smem_u32(sq + (rb * 16 + lane % 16) * ROW + kc * 16 + (lane / 16) * 8),
              qa[kc]);

    // S = Q K^T over every key
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t b[4];
        ldsm_x4(smem_u32(sk + (nt * 8 + lane % 8) * ROW + half * 32 + (lane / 8) * 8), b);
        mma(s[nt], qa[2 * half], b[0], b[1]);
        mma(s[nt], qa[2 * half + 1], b[2], b[3]);
      }
    }

    // softmax over each row in f32: rows lane/4 (c 0, 1) and lane/4 + 8
    // (c 2, 3) of the block, spread over the quad's four lanes
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = nt * 8 + 2 * (lane % 4) + (c & 1);
        const float v = key < n ? s[nt][c] * g.scale_log2 : -INFINITY;
        s[nt][c] = v;
        mx[c / 2] = fmaxf(mx[c / 2], v);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[nt][c] - mx[c / 2]);
        s[nt][c] = p;
        sum[c / 2] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    }

    // O = P V: P's accumulator layout is the A fragment of a 16-key chunk
    float o[8][4];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[dt][c] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const uint32_t pa[4] = {pack(s[2 * kc][0], s[2 * kc][1]),
                              pack(s[2 * kc][2], s[2 * kc][3]),
                              pack(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(smem_u32(sv + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * ROW +
                           dp * 16 + (lane / 16) * 8),
                  b);
        mma(o[2 * dp], pa, b[0], b[1]);
        mma(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }

    // out: divided by the row sum, rounded once; staged in this warp's Q rows
    const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
    const int r0 = rb * 16 + lane / 4;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const int d = dt * 8 + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float lo = o[dt][2 * h] * inv[h], hi = o[dt][2 * h + 1] * inv[h];
        const int r = r0 + 8 * h;
        if (ex && r == 0) {
          float* e = g.extra_out + static_cast<long long>(seq) * g.dim + head * HD + d;
          e[0] = lo;
          e[1] = hi;
        }
        *reinterpret_cast<uint32_t*>(sq + r * ROW + d) = pack(lo, hi);
      }
    }
    __syncwarp();
    for (int c = lane; c < 16 * 8; c += 32) {
      const int r = rb * 16 + c / 8, ch = c % 8;
      if (r >= n || (ex && r == 0)) continue;
      const long long row = first + (r - ex) * g.st;
      *reinterpret_cast<uint4*>(g.out + row * g.ld_out + head * HD + ch * 8) =
          *reinterpret_cast<const uint4*>(sq + r * ROW + ch * 8);
    }
  }
}

template <int KC>
int launch(const Args& g, int seqs, int heads, cudaStream_t s) {
  const int smem = 3 * 16 * KC * ROW * static_cast<int>(sizeof(__nv_bfloat16));
  const cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_kernel<KC><<<dim3(seqs, heads), THREADS, smem, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn
}  // namespace vv

// qkv: rows of 3 dim bf16 (q, k, v; heads of 64 each), row stride ld_in;
// out: rows of dim bf16, stride ld_out (the same rows as qkv's tokens);
// extra_out: f32 (n_outer n_inner, dim) when extra_base >= 0. Token i of
// sequence (o, j) is row base + o outer_stride + j inner_stride + i
// token_stride; the extra token of sequence (o, j) row extra_base + o
// outer_stride. Returns a CUDA error code as an int.
extern "C" int vv_attention(const void* qkv, void* out, void* extra_out, int heads,
                            int dim, long long ld_in, long long ld_out, int length,
                            int n_outer, int n_inner, long long base,
                            long long outer_stride, long long inner_stride,
                            long long token_stride, long long extra_base, float scale,
                            int device, void* stream) {
  using namespace vv::attn;
  const int ex = extra_base >= 0 ? 1 : 0;
  const long long seqs = static_cast<long long>(n_outer) * n_inner;
  const bool aligned = reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 && ld_in % 8 == 0 &&
                       ld_out % 8 == 0;
  if (heads < 1 || dim != heads * HD || length < 1 || n_outer < 1 || n_inner < 1 ||
      length + ex > MAX_TOKENS || seqs > INT_MAX || heads > 65535 || !aligned ||
      (ex && extra_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args g;
  g.qkv = static_cast<const __nv_bfloat16*>(qkv);
  g.out = static_cast<__nv_bfloat16*>(out);
  g.extra_out = static_cast<float*>(extra_out);
  g.ld_in = ld_in;
  g.ld_out = ld_out;
  g.dim = dim;
  g.length = length;
  g.n_inner = n_inner;
  g.base = base;
  g.so = outer_stride;
  g.si = inner_stride;
  g.st = token_stride;
  g.extra_base = extra_base;
  g.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (length + ex + 15) / 16;
  const int n = static_cast<int>(seqs);
  if (chunks <= 1) return launch<1>(g, n, heads, s);
  if (chunks <= 2) return launch<2>(g, n, heads, s);
  if (chunks <= 4) return launch<4>(g, n, heads, s);
  if (chunks <= 6) return launch<6>(g, n, heads, s);   // TimeSformer's temporal
  if (chunks <= 8) return launch<8>(g, n, heads, s);
  if (chunks <= 13) return launch<13>(g, n, heads, s);  // and spatial heads
  return launch<16>(g, n, heads, s);
}
