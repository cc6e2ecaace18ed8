// Swin V2 window attention in one kernel: from the qkv projection's output
// to the input of the output projection,
//
//   out[w, i, h d] = sum_j softmax_j(s_h q^_i . k^_j
//                                    + 16 sigmoid(T[h, idx(i, j)])
//                                    + M_w(i, j)) v_j
//
// with q, k, v read by strides from the (Bw, N, 3C) bf16 qkv rows of Bw
// windows of N = w^2 tokens, q^ = q / max(|q|, 1e-12) and k^ likewise (per
// head, in float32, rounded to bf16), s_h = exp(min(logit_scale_h,
// log 100)) read from the (H,) float32 scale, T the block's (H, (2w-1)^2)
// float32 position-bias MLP output and M_w the shifted window's region
// mask (-100 across regions).  idx(i, j) is models/swin2.py's
// `_rel_pos_index`: for token p = y w + x,
//   idx = (y_i - y_j + w - 1)(2w - 1) + (x_i - x_j + w - 1) = a_i - b_j,
//   b_j = y_j (2w - 1) + x_j,  a_i = b_i + (w - 1)(2w - 1) + w - 1.
// M_w is `_shift_mask`'s: the windows tile the rolled (gh, gw) grid row
// major, a frame after another; a token's region is (row band, column
// band), band 0 for every window but the last of its axis, where the
// in-window coordinate c is band 1 below w - shift and band 2 from there.
//
// Replaces: no TPU kernel.  The JAX package's Swin attention is plain jnp
// (riders_tpu/models/swin2.py), which XLA fuses on the TPU; the port's plain
// form (ops/kernels/swin2_attention.py:swin2_attention_plain) writes and
// reads (Bw, H, N, N) float32 logits several times a block: 101 of the
// Swin2-L SML's ~124 device ms a call at 384x384, B=16.
//
// Bound on the H100: 4 Bw H N^2 d operations (q k^T and P v), 0.525 ms a
// Swin2-L forward at B=16 (3.85 G logits), at 989 TFLOP/s.  At d = 32 each
// logit's 128 operations meet one exponential (MUFU: 16 a clock an SM,
// ~0.92 ms a forward), one bias lookup in shared memory and the online
// softmax's bookkeeping (~8 instructions a logit in all), so the
// instruction stream around each logit, not the tensor cores, sets the
// pace.
//
// Design (flash attention on mma.sync; no logit, bias or mask tensor is
// ever written to device memory):
//  * A block owns BM = 192 query rows of one (window, head), twelve warps
//    of one m16 tile each.  Grid (ceil(N / 192), H, Bw).  Keys are taken
//    32 at a time; rows past N (never stored) and keys past N (-inf) pad
//    any w^2 <= 576 (Swin2-L's N = 144: the last step's 16 keys).
//  * The whole window's K and V (72 KB at N = 576) and the block's Q
//    arrive once by 16-byte cp.async into rows of 64 bytes whose 16-byte
//    chunks are swizzled (chunk ^ (row >> 1) & 3), so ldmatrix reads hit
//    32 banks; no barrier inside the key loop.  Q and K are L2-normalised
//    in place in shared memory (a thread a row, f32, t (1 / |t|), rounded
//    to bf16) while V is still arriving.
//  * The head's table is staged once as 16 sigmoid(T) log2(e); each thread
//    keeps the shared address of T[a_i] for its rows, so a logit's bias is
//    one subtraction and one 4-byte shared load: fma(q^.k^, s_h log2(e),
//    T[a_i - b_j]).  Windows on the last row or column of a shifted grid
//    add -100 log2(e) where the row's region and the key's differ (regions
//    staged per key beside b_j); the others take a loop without the test.
//  * Online softmax in f32 registers, base 2 (ex2.approx); P rounded to
//    bf16 for P v from the accumulator registers; O divided by the row
//    sum once, rounded to bf16 and stored at (w, i, h d).
//  * Two blocks an SM (99 KB of shared memory each at N = 576), 24 warps:
//    the loop is bound by latency, not issue, so occupancy sets the pace.
//    Of the (m16 tiles a warp, warps a block) tried at the Swin2 cell's
//    shapes, a forward's 24 attentions took (ms, NVIDIA H100 80GB HBM3 at
//    700 W, back to back): 1x12 3.56, 2x6 3.79, 1x9 3.86, 3x4 4.44, 2x8
//    4.80, 3x6 4.96 (spilling at its 168 registers), 3x3 5.56.
//  * Two blocks of 384 threads leave a thread 80 registers.  With 48 keys a
//    step (which divides both 576 and 144) the logits' 24 registers made
//    the warp spill 36-48 bytes; 32 keys a step, Q's fragments read from
//    shared memory each step and one ldmatrix offset a lane hold it at 79
//    with no spill, and a forward's 24 attentions took 3.39 ms against
//    3.48-3.53 at 48 (one call, same card).
// Measured: PERF.md's kernel table, row BW.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 32;                   // head width
constexpr int ROW = D * 2;              // bytes a row of q, k or v
constexpr int WARPS = 12;               // one m16 tile of rows a warp
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;          // query rows a block
constexpr int BN = 32;                  // keys a step
constexpr int NT = BN / 8;              // n8 tiles of logits a step
constexpr int KC = BN / 16;             // k16 slices of P v a step
constexpr int MAX_TOKENS = 576;
constexpr int SMEM_LIMIT = 232448;      // 227 KB of dynamic shared memory
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Shared memory: Q (BM rows), K and V (NP = N rounded up to BN rows
// each), the table (R floats, padded to 16 bytes), then b_j in bytes and
// the region of every key (NP ints each).
struct Layout {
  int k, v, tab, col, reg, bytes;
};
__host__ __device__ inline Layout layout(int N, int R) {
  const int np = ceil_div(N, BN) * BN;
  Layout s;
  s.k = BM * ROW;
  s.v = s.k + np * ROW;
  s.tab = s.v + np * ROW;
  s.col = s.tab + ((R * 4 + 15) & ~15);
  s.reg = s.col + np * 4;
  s.bytes = s.reg + np * 4;
  return s;
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Byte offset of 16-byte chunk `c` (of 4) of row `r` in a swizzled tile.
__device__ __forceinline__ unsigned swz(int r, int c) {
  return (unsigned)(r * ROW + ((c ^ ((r >> 1) & 3)) << 4));
}

// `rows` rows of one head's q, k or v from token `row0` on into a swizzled
// tile at shared address `dst`; rows at or past N are zero-filled.
__device__ __forceinline__ void load_rows(unsigned dst, const bf16* src,
                                          size_t stride, int row0, int rows,
                                          int N) {
  for (int chunk = threadIdx.x; chunk < rows * 4; chunk += THREADS) {
    const int r = chunk >> 2, c = chunk & 3;
    const bool in = row0 + r < N;
    const bf16* from = src + (in ? (size_t)(row0 + r) * stride + c * 8 : 0);
    cp_async16(dst + swz(r, c), from, in);
  }
}

// Rows [0, rows) of a swizzled tile L2-normalised in place: in float32,
// t / max(|t|, 1e-12) as t (1 / max(|t|, 1e-12)), rounded to bf16.  Zero
// rows stay zero.
__device__ __forceinline__ void normalize_rows(unsigned char* tile,
                                               int rows) {
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    uint4 chunk[4];
    #pragma unroll
    for (int c = 0; c < 4; ++c)
      chunk[c] = *reinterpret_cast<const uint4*>(tile + swz(r, c));
    const uint32_t* w = reinterpret_cast<const uint32_t*>(chunk);
    float ss = 0.f;
    #pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float lo = __uint_as_float(w[e] << 16);
      const float hi = __uint_as_float(w[e] & 0xffff0000u);
      ss = fmaf(lo, lo, ss);
      ss = fmaf(hi, hi, ss);
    }
    const float inv = 1.f / fmaxf(sqrtf(ss), 1e-12f);
    uint32_t* o = reinterpret_cast<uint32_t*>(chunk);
    #pragma unroll
    for (int e = 0; e < 16; ++e)
      o[e] = pack_bf16(__uint_as_float(w[e] << 16) * inv,
                       __uint_as_float(w[e] & 0xffff0000u) * inv);
    #pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint4*>(tile + swz(r, c)) = chunk[c];
  }
}

// The region of in-window coordinate c on an axis whose window is `last`
// of its row or column in a grid shifted by `shift`: band 0 off the last
// window, else 1 below w - shift and 2 from there.
__device__ __forceinline__ int band(int c, bool last, int w, int shift) {
  return last ? (c < w - shift ? 1 : 2) : 0;
}

// A step's logits in base 2, in place of its products q^ k^T:
// fma(acc, s log2(e), T[a_i - b_j]); with MASK -100 log2(e) where the row's
// region and the key's differ; with TAIL -inf for keys at or past N.  The
// common step takes neither, so its loop has no per-logit branch.
template <bool MASK, bool TAIL>
__device__ __forceinline__ void biased_logits(
    float (&s)[NT][4], const int* scol, const int* sreg,
    const unsigned (&arow)[2], const int (&rrow)[2], float scale_log2,
    int j0, int N) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const float mask = -100.f * LOG2E;
  #pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int j = j0 + 8 * n + 2 * t;
    const int2 bj = *reinterpret_cast<const int2*>(scol + j);
    int2 rj = make_int2(0, 0);
    if (MASK) rj = *reinterpret_cast<const int2*>(sreg + j);
    #pragma unroll
    for (int r = 0; r < 4; ++r) {
      const unsigned at = arow[r >> 1] - (unsigned)((r & 1) ? bj.y : bj.x);
      float x = fmaf(s[n][r], scale_log2, lds_f32(at));
      if (MASK && rrow[r >> 1] != ((r & 1) ? rj.y : rj.x)) x += mask;
      if (TAIL && j + (r & 1) >= N) x = -INFINITY;
      s[n][r] = x;
    }
  }
}

struct Args {
  const bf16* qkv;      // (Bw, N, 3C)
  const float* table;   // (H, R): the position-bias MLP, before the sigmoid
  const float* scale;   // (H,): exp(min(logit_scale, log 100))
  bf16* out;            // (Bw, N, C)
  int N, H, w, R, shift, nwy, nwx;
};

__global__ void __launch_bounds__(THREADS, 2)
swin2_attention_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, w = a.w;
  const Layout L = layout(N, a.R);
  const unsigned s_base = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned sq = s_base, sk = s_base + L.k, sv = s_base + L.v;
  float* stab = reinterpret_cast<float*>(smem + L.tab);
  int* scol = reinterpret_cast<int*>(smem + L.col);
  int* sreg = reinterpret_cast<int*>(smem + L.reg);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, win = blockIdx.z, q0 = blockIdx.x * BM;
  const int C = a.H * D;
  const int nkv = ceil_div(N, BN), np = nkv * BN;
  const size_t stride = 3 * (size_t)C;
  const bf16* q_src = a.qkv + (size_t)win * N * stride + h * D;
  const bf16* k_src = q_src + C;
  const bf16* v_src = q_src + 2 * C;

  // Q and K first, V behind them: Q and K are normalised while V arrives
  load_rows(sq, q_src, stride, q0, BM, N);
  load_rows(sk, k_src, stride, 0, np, N);
  cp_async_commit();
  load_rows(sv, v_src, stride, 0, np, N);
  cp_async_commit();

  // the head's table as 16 sigmoid(T) in base 2; b_j in bytes and the
  // region of every key (0 for the padding, which the tail masks)
  const float* tab = a.table + (size_t)h * a.R;
  for (int i = tid; i < a.R; i += THREADS)
    stab[i] = 16.f * LOG2E / (1.f + __expf(-tab[i]));
  const int w2 = 2 * w - 1;
  const int wy = (win % (a.nwy * a.nwx)) / a.nwx, wx = win % a.nwx;
  const bool last_y = a.shift > 0 && wy == a.nwy - 1;
  const bool last_x = a.shift > 0 && wx == a.nwx - 1;
  for (int j = tid; j < np; j += THREADS) {
    const int y = j < N ? j / w : 0, x = j < N ? j % w : 0;
    scol[j] = 4 * (y * w2 + x);
    sreg[j] = 3 * band(y, last_y, w, a.shift) + band(x, last_x, w, a.shift);
  }
  cp_async_wait<1>();
  __syncthreads();
  normalize_rows(smem, BM);
  normalize_rows(smem + L.k, np);
  cp_async_wait<0>();
  __syncthreads();

  const int row_base = q0 + warp * 16;
  if (row_base >= N) return;            // a warp of padding rows only

  // this thread's rows g and g + 8: the shared address of T[a_i] (a_i of
  // the centre for padding rows: an entry inside the table) and the region
  const int centre = (w - 1) * w2 + w - 1;
  const unsigned stab_at = (unsigned)__cvta_generic_to_shared(stab);
  unsigned arow[2];
  int rrow[2];
  #pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = row_base + hh * 8 + g;
    const int y = i < N ? i / w : 0, x = i < N ? i % w : 0;
    arow[hh] = stab_at + 4 * (y * w2 + x + centre);
    rrow[hh] = 3 * band(y, last_y, w, a.shift) + band(x, last_x, w, a.shift);
  }
  const bool masked = last_y || last_x;
  const float scale_log2 = a.scale[h] * LOG2E;

  // this lane's ldmatrix offsets into 16 rows of a swizzled tile: rows 16
  // apart share their swizzle, and chunks 2 and 3 are chunks 0 and 1 with
  // bit 5 of the offset flipped, so one offset serves every fragment
  const unsigned q_at = sq + warp * 16 * ROW;
  const unsigned q_lane = swz(lane & 15, lane >> 4);
  const unsigned k_lane = swz((lane & 7) + ((lane >> 4) << 3),
                              (lane >> 3) & 1);
  const unsigned v_lane = swz((lane & 7) + (((lane >> 3) & 1) << 3),
                              lane >> 4);

  float o[4][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  #pragma unroll
  for (int n = 0; n < 4; ++n)
    #pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = 0.f;

  for (int kt = 0; kt < nkv; ++kt) {
    const int j0 = kt * BN;
    const unsigned k_at = sk + j0 * ROW, v_at = sv + j0 * ROW;

    // S = Q^ K^^T, Q's fragments read again each step (registers, not
    // shared memory, bound the block's occupancy)
    float s[NT][4];
    #pragma unroll
    for (int n = 0; n < NT; ++n)
      #pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = 0.f;
    #pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t qf[4];
      ldsm_x4(qf, q_at + (q_lane ^ (32 * kk)));
      #pragma unroll
      for (int np2 = 0; np2 < KC; ++np2) {
        uint32_t kb[4];
        ldsm_x4(kb, k_at + np2 * 16 * ROW + (k_lane ^ (32 * kk)));
        mma(s[2 * np2], qf, kb[0], kb[1]);
        mma(s[2 * np2 + 1], qf, kb[2], kb[3]);
      }
    }

    // logits in base 2: scaled products plus the gathered bias and mask
    const bool tail = j0 + BN > N;
#define RIDERS_SWIN2_LOGITS(M, T)                                         \
  biased_logits<M, T>(s, scol, sreg, arow, rrow, scale_log2, j0, N)
    if (masked) {
      if (tail) RIDERS_SWIN2_LOGITS(true, true);
      else RIDERS_SWIN2_LOGITS(true, false);
    } else {
      if (tail) RIDERS_SWIN2_LOGITS(false, true);
      else RIDERS_SWIN2_LOGITS(false, false);
    }
#undef RIDERS_SWIN2_LOGITS

    // online softmax over this step's keys
    #pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
      #pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * hh], s[n][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float corr = exp2_approx(m[hh] - m_new);
      m[hh] = m_new;
      float sum = 0.f;
      #pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float p0 = exp2_approx(s[n][2 * hh] - m_new);
        const float p1 = exp2_approx(s[n][2 * hh + 1] - m_new);
        s[n][2 * hh] = p0;
        s[n][2 * hh + 1] = p1;
        sum += p0 + p1;
      }
      #pragma unroll
      for (int n = 0; n < 4; ++n) {
        o[n][2 * hh] *= corr;
        o[n][2 * hh + 1] *= corr;
      }
      l[hh] = l[hh] * corr + sum;
    }

    // O += P V, P rounded to bf16 from the accumulators
    #pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      #pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, v_at + kc * 16 * ROW + (v_lane ^ (32 * dp)));
        mma(o[2 * dp], pa, vb[0], vb[1]);
        mma(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // divide by the row sums, round to bf16, store at (w, i, h d)
  #pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / sum;
    const int i = row_base + hh * 8 + g;
    if (i >= N) continue;
    bf16* row = a.out + ((size_t)win * N + i) * C + h * D + 2 * t;
    #pragma unroll
    for (int n = 0; n < 4; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
  }
}

}  // namespace

// qkv: (Bw, N, 3 H 32) bf16, 16-byte aligned; table: (H, (2w-1)^2) f32;
// scale: (H,) f32; out: (Bw, N, H 32) bf16; N = w^2 <= 576.  With shift
// > 0 the windows tile a (gh, gw) grid (multiples of w) a frame after
// another, Bw a multiple of their count.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int riders_swin2_attention(const void* qkv, const void* table,
                                      const void* scale, void* out, int Bw,
                                      int N, int H, int w, int shift, int gh,
                                      int gw, void* stream) {
  if (w < 1 || N != w * w || N > MAX_TOKENS || H < 1 || Bw < 0)
    return (int)cudaErrorInvalidValue;
  int nwy = 1, nwx = 1;
  if (shift != 0) {
    if (shift < 0 || shift >= w || gh < w || gw < w || gh % w || gw % w)
      return (int)cudaErrorInvalidValue;
    nwy = gh / w;
    nwx = gw / w;
    if (Bw % (nwy * nwx)) return (int)cudaErrorInvalidValue;
  }
  const int R = (2 * w - 1) * (2 * w - 1);
  const int smem = layout(N, R).bytes;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (Bw == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      swin2_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.qkv = static_cast<const bf16*>(qkv);
  a.table = static_cast<const float*>(table);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<bf16*>(out);
  a.N = N;
  a.H = H;
  a.w = w;
  a.R = R;
  a.shift = shift;
  a.nwy = nwy;
  a.nwx = nwx;
  dim3 grid(ceil_div(N, BM), H, Bw);
  swin2_attention_kernel<<<grid, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
