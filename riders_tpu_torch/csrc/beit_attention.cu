// BEiT attention with its relative position bias, in one kernel: from the
// qkv projection's output to the input of the output projection,
//
//   out[b, i, h d] = sum_j softmax_j(q_i . k_j / sqrt(d) + T[h, idx(i, j)])
//                    v_j
//
// with q, k, v read by strides from the (B, N, 3C) bf16 qkv rows and T the
// block's relative position table resized to the window, (H, R) float32.
// idx(i, j) is models/dpt.py:beit_rel_pos_index's layout for a (gh, gw)
// window plus the cls token (N = gh gw + 1, R = (2gh-1)(2gw-1) + 3):
// for i, j >= 1, with p = i - 1 = y gw + x,
//   idx = (y_i - y_j + gh - 1)(2gw - 1) + (x_i - x_j + gw - 1)
//       = a_i - b_j,  b_j = y_j (2gw - 1) + x_j,  a_i = b_i + c,
//   c = (gh - 1)(2gw - 1) + gw - 1;
// (0, 0) -> R - 3, row 0 -> R - 2, column 0 -> R - 1.
//
// Replaces: no TPU kernel.  The JAX package's BEiT attention is plain jnp
// (riders_tpu/models/dpt.py), which XLA fuses on the TPU; the port's plain
// form (ops/kernels/attention.py:beit_attention_plain) writes and reads a
// (B, H, N, N) float32 logit tensor several times a block, 86% of the
// BEiT-L/16-512 SML's call at 512x640 (1281 tokens, B=16).
//
// Bound on the H100: 4 B H N^2 d operations (q k^T and P v), 107.5 GFLOP
// a block at the cell's shape (B=16, H=16, N=1281, d=64), 0.109 ms at
// 989 TFLOP/s; its bytes (q, k, v read, the output written, 42 MB a
// direction) take 0.05 ms.  At d = 64 each logit's 256 operations meet
// one exponential, one bias lookup and the online softmax's bookkeeping,
// so the shared-memory reads and the exponentials, not the tensor cores,
// hold an mma.sync kernel well under the bound.
//
// Design (flash attention on mma.sync; no logit or bias tensor is ever
// written to device memory):
//  * A block owns BM = 128 query rows of one (batch, head): four warps of
//    two m16 tiles each, so every K / V fragment read from shared memory
//    serves 32 rows.  Grid (ceil(N / 128), H, B).
//  * Q (once) and the K / V tiles of BN = 64 rows (two stages) arrive by
//    16-byte cp.async into rows of 128 bytes whose 16-byte chunks are
//    swizzled by the row (chunk ^ row & 7), so ldmatrix reads hit 32
//    banks.  Rows past N are zero-filled.
//  * At its start a block stages its head's table row, times log2(e), and
//    4 b_j for every key in shared memory; each thread keeps the shared
//    address of T[a_i] for its four rows, so a logit's bias is one
//    subtraction and one 4-byte shared load.  A logit is fma(acc, scale
//    log2(e), T[a_i - b_j]) on the f32 accumulator of q k^T; the first key
//    tile and the warp holding row 0 swap in the cls entries.  Keys past N
//    read -inf.
//  * Online softmax in f32 registers, in base 2 (ex2.approx); P is
//    rounded to bf16 and fed from the accumulator registers as the A
//    operand of P v; O accumulates in f32 and is divided by the row sum
//    once, rounded to bf16 and stored at (b, i, h d): the layout that the
//    output projection reads.
//  * Four warps and at most 255 registers a thread, two blocks an SM
//    (74 KB of shared memory a block at the cell's shape).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (back to back): ~0.50 ms
// a block at the cell's shape, ~22% of its bound (SDPA with the bias in
// bf16 1.09, the plain version 8.6); ~0.125 ms for BEiT-L/16-384 at
// 384x384 (N = 577), 18%.  Eight warps of one m16 tile, or three blocks
// an SM, ran slower, and so did moving the max in use only when a row's
// grew by 2^8: the instruction stream around each logit (bias lookup,
// exponential, online softmax), not occupancy, holds it.  Within 0.004 of
// float32 attention on the same bf16 inputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 64;                   // head width
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MT = 2;                   // m16 tiles a warp
constexpr int BM = 16 * MT * WARPS;     // query rows a block
constexpr int BN = 64;                  // key / value rows a stage
constexpr int SMEM_LIMIT = 232448;      // 227 KB of dynamic shared memory
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Shared memory: Q (BM rows), K and V (two stages of BN rows each), the
// table (R floats, padded to 16 bytes), b_j (one int a key, padded to
// whole tiles).
__host__ __device__ inline int table_offset() {
  return (BM + 4 * BN) * D * (int)sizeof(bf16);
}
__host__ __device__ inline int cols_offset(int R) {
  return table_offset() + ((R * 4 + 15) & ~15);
}
__host__ __device__ inline int smem_bytes(int R, int N) {
  return cols_offset(R) + ceil_div(N, BN) * BN * 4;
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool full) {
  const int n = full ? 16 : 0;          // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lds_f32(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of 16-byte chunk `c` of row `r` in a swizzled tile.
__device__ __forceinline__ unsigned swz(int r, int c) {
  return (unsigned)(r * (D * 2) + ((c ^ (r & 7)) << 4));
}

// ROWS rows of one head's q, k or v from token `row0` on into a swizzled
// tile at shared address `dst`; rows at or past N are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_rows(unsigned dst, const bf16* src,
                                          size_t stride, int row0, int N) {
  #pragma unroll
  for (int k = 0; k < ROWS * 8 / THREADS; ++k) {
    const int chunk = threadIdx.x + k * THREADS;
    const int r = chunk >> 3, c = chunk & 7;
    const bool in = row0 + r < N;
    const bf16* from = src + (in ? (size_t)(row0 + r) * stride + c * 8 : 0);
    cp_async16(dst + swz(r, c), from, in);
  }
}

// A tile's logits in base 2, in place of its products q k^T: fma(acc,
// scale log2(e), T[a_i - b_j]); with EDGE the cls entries for row 0 and
// key 0, with TAIL -inf for keys at or past N.  The common tile takes
// neither, so its loop has no per-logit branch.
template <bool EDGE, bool TAIL>
__device__ __forceinline__ void biased_logits(
    float (&s)[MT][8][4], unsigned stab, const int* scol,
    const unsigned (&arow)[MT][2], float scale_log2, int j0, int row_base,
    int N, int nrel) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  #pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int2 bj = *reinterpret_cast<const int2*>(scol + j0 + 8 * n + 2 * t);
    #pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      #pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + 8 * n + 2 * t + (r & 1);
        unsigned at = arow[mt][r >> 1] - (unsigned)((r & 1) ? bj.y : bj.x);
        if (EDGE) {
          const int i = row_base + mt * 16 + (r >> 1) * 8 + g;
          if (i == 0) at = stab + 4 * (j == 0 ? nrel : nrel + 1);
          else if (j == 0) at = stab + 4 * (nrel + 2);
        }
        float x = fmaf(s[mt][n][r], scale_log2, lds_f32(at));
        if (TAIL && j >= N) x = -INFINITY;
        s[mt][n][r] = x;
      }
  }
}

struct Args {
  const bf16* qkv;      // (B, N, 3C)
  const float* table;   // (H, R)
  bf16* out;            // (B, N, C)
  int N, H, gh, gw, R;
  float scale_log2;     // log2(e) / sqrt(d)
};

__global__ void __launch_bounds__(THREADS, 2)
beit_attention_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned s_base = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned sq = s_base;
  const unsigned sk = sq + BM * D * 2;
  const unsigned sv = sk + 2 * BN * D * 2;
  float* stab = reinterpret_cast<float*>(smem + table_offset());
  int* scol = reinterpret_cast<int*>(smem + cols_offset(a.R));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BM;
  const int N = a.N, C = a.H * D;
  const size_t stride = 3 * (size_t)C;
  const bf16* q_src = a.qkv + (size_t)b * N * stride + h * D;
  const bf16* k_src = q_src + C;
  const bf16* v_src = q_src + 2 * C;
  const int nkv = ceil_div(N, BN);

  load_rows<BM>(sq, q_src, stride, q0, N);
  load_rows<BN>(sk, k_src, stride, 0, N);
  load_rows<BN>(sv, v_src, stride, 0, N);
  cp_async_commit();

  // the head's table in base 2, and b_j of every key in bytes (0 for the
  // cls key and the padding, which the cls entries and the mask replace)
  const float* tab = a.table + (size_t)h * a.R;
  for (int i = tid; i < a.R; i += THREADS) stab[i] = tab[i] * LOG2E;
  const int w2 = 2 * a.gw - 1;
  for (int j = tid; j < nkv * BN; j += THREADS) {
    int bj = 0;
    if (j >= 1 && j < N) bj = ((j - 1) / a.gw) * w2 + (j - 1) % a.gw;
    scol[j] = 4 * bj;
  }
  // the shared address of T[a_i] for this thread's rows (a_i = the
  // centre c for row 0 and the padding: an entry inside the table)
  const int centre = (a.gh - 1) * w2 + a.gw - 1;
  const int nrel = a.R - 3;
  const int row_base = q0 + warp * 16 * MT;
  const unsigned stab_at = (unsigned)__cvta_generic_to_shared(stab);
  unsigned arow[MT][2];
  #pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    #pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = row_base + mt * 16 + hh * 8 + g;
      arow[mt][hh] = stab_at + 4 * ((i >= 1 && i < N)
          ? ((i - 1) / a.gw) * w2 + (i - 1) % a.gw + centre : centre);
    }
  const bool row0_warp = row_base == 0;

  float o[MT][8][4];
  float m[MT][2], l[MT][2];
  #pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    #pragma unroll
    for (int n = 0; n < 8; ++n)
      #pragma unroll
      for (int r = 0; r < 4; ++r) o[mt][n][r] = 0.f;
    #pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[mt][hh] = -INFINITY;
      l[mt][hh] = 0.f;
    }
  }
  uint32_t qf[MT][4][4];

  for (int kt = 0; kt < nkv; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nkv) {
      load_rows<BN>(sk + (st ^ 1) * BN * D * 2, k_src, stride,
                    (kt + 1) * BN, N);
      load_rows<BN>(sv + (st ^ 1) * BN * D * 2, v_src, stride,
                    (kt + 1) * BN, N);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    if (kt == 0) {
      #pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        #pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldsm_x4(qf[mt][kk],
                  sq + swz(warp * 16 * MT + mt * 16 + (lane & 15),
                           2 * kk + (lane >> 4)));
    }

    // S = Q K^T
    const unsigned skt = sk + st * BN * D * 2;
    float s[MT][8][4];
    #pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      #pragma unroll
      for (int n = 0; n < 8; ++n)
        #pragma unroll
        for (int r = 0; r < 4; ++r) s[mt][n][r] = 0.f;
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      #pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, skt + swz(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                              2 * kk + ((lane >> 3) & 1)));
        #pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * np], qf[mt][kk], kb[0], kb[1]);
          mma(s[mt][2 * np + 1], qf[mt][kk], kb[2], kb[3]);
        }
      }

    // logits in base 2: scaled products plus the gathered bias
    const int j0 = kt * BN;
    const bool edge = kt == 0 || row0_warp;
    const bool tail = j0 + BN > N;
#define RIDERS_BEIT_LOGITS(E, T)                                          \
  biased_logits<E, T>(s, stab_at, scol, arow, a.scale_log2, j0, row_base, N, \
                      nrel)
    if (edge) {
      if (tail) RIDERS_BEIT_LOGITS(true, true);
      else RIDERS_BEIT_LOGITS(true, false);
    } else {
      if (tail) RIDERS_BEIT_LOGITS(false, true);
      else RIDERS_BEIT_LOGITS(false, false);
    }
#undef RIDERS_BEIT_LOGITS

    // online softmax over this tile's keys
    #pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      #pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
        #pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(s[mt][n][2 * hh], s[mt][n][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][hh], mx);
        const float corr = exp2_approx(m[mt][hh] - m_new);
        m[mt][hh] = m_new;
        float sum = 0.f;
        #pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[mt][n][2 * hh] *= corr;
          o[mt][n][2 * hh + 1] *= corr;
          const float p0 = exp2_approx(s[mt][n][2 * hh] - m_new);
          const float p1 = exp2_approx(s[mt][n][2 * hh + 1] - m_new);
          s[mt][n][2 * hh] = p0;
          s[mt][n][2 * hh + 1] = p1;
          sum += p0 + p1;
        }
        l[mt][hh] = l[mt][hh] * corr + sum;
      }

    // O += P V, P rounded to bf16 from the accumulators
    const unsigned svt = sv + st * BN * D * 2;
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[MT][4];
      #pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
      #pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, svt + swz(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                2 * dp + (lane >> 4)));
        #pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(o[mt][2 * dp], pa[mt], vb[0], vb[1]);
          mma(o[mt][2 * dp + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();     // this stage is refilled by the next iteration
  }

  // divide by the row sums, round to bf16, store at (b, i, h d)
  #pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    #pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = l[mt][hh];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / sum;
      const int i = row_base + mt * 16 + hh * 8 + g;
      if (i >= N) continue;
      bf16* row = a.out + ((size_t)b * N + i) * C + h * D + 2 * t;
      #pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
            __floats2bfloat162_rn(o[mt][n][2 * hh] * inv,
                                  o[mt][n][2 * hh + 1] * inv);
    }
}

}  // namespace

// qkv: (B, N, 3 H 64) bf16, 16-byte aligned; table: (H, R) f32 with
// R = (2gh-1)(2gw-1) + 3; out: (B, N, H 64) bf16; N = gh gw + 1.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int riders_beit_attention(const void* qkv, const void* table,
                                     void* out, int B, int N, int H, int gh,
                                     int gw, float scale, void* stream) {
  if (gh < 1 || gw < 1 || N != gh * gw + 1 || H < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
  const int R = (2 * gh - 1) * (2 * gw - 1) + 3;
  const int smem = smem_bytes(R, N);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      beit_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.qkv = static_cast<const bf16*>(qkv);
  a.table = static_cast<const float*>(table);
  a.out = static_cast<bf16*>(out);
  a.N = N;
  a.H = H;
  a.gh = gh;
  a.gw = gw;
  a.R = R;
  a.scale_log2 = scale * LOG2E;
  dim3 grid(ceil_div(N, BM), H, B);
  beit_attention_kernel<<<grid, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
