// Fused RC-Net stem: 7x7 stride-2 conv (Cin 3 -> Cout 32) with the
// BatchNorm folded into the weights, + bias, max(y, slope * y) (slope 0.2
// leaky-relu, 0 relu, 1 linear, as the Pallas kernel's negative_slope),
// bf16 out, and MaxPool2d(3, 2, 1) of that output, in one kernel.
//
// Replaces: riders_tpu/ops/pallas/stem.py:stem_conv_pallas (pool=True),
// the Pallas im2col-matmul stem of the JAX package.
//
// Bound on the H100: at the NTU bench shape (B=16, 662x690x3 in) the
// kernel must move ~190 MB (input 44 MB, conv out 117 MB, pooled 29 MB),
// ~57 us at 3.35 TB/s, and do 17.2 GFLOP, ~17 us at the bf16 tensor rate:
// it is bound by its bytes.  What keeps it off that bound is the shared-
// memory traffic of gathering A, so the design spends shared loads, not
// tensor-core work.
//
// Design: the contraction is an implicit GEMM on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate): M = the conv pixels of a
// block's tile, N = 32 channels, K = the 7 kernel rows of 21 (kx, ci)
// taps, each row padded to 24, then to 176 (29 zero rows).  One block of
// 9 warps owns an 8 x 16 tile of pooled outputs, i.e. 16 x 32 conv
// outputs plus the one conv row and column above and to the left that the
// 3x3/s2 pool window also reads (17 x 33 = 561 pixels, 9.6% of them
// recomputed halo), so no conv value leaves the block before it is pooled
// and each is written once.
//  * Staging: the block moves its 39 x 71 x 3 input tile (with the conv's
//    zero padding) from device memory in 16-byte loads into a raw buffer
//    that keeps each row's 16-byte alignment (conflict-free 16-byte
//    stores), then realigns every row so that staged element j of each
//    row sits at the same column (one 32-bit load and store per word,
//    consecutive lanes on consecutive words).
//  * A: a conv pixel's 21 taps of kernel row ky are 21 consecutive staged
//    elements, so the GEMM rows k = 8 G + i of group G (kernel row G / 3,
//    taps 8 (G % 3) + i) sit at offset ky * SP + 8 (G % 3) + i from the
//    pixel's window corner (koffset, mirrored by ops/kernels/stem.py:
//    k_offsets).  Lane t's A register (k, k + 1) is one 32-bit shared load
//    at its pixel's base + 2 t plus that compile-time offset: no im2col
//    buffer and no table loads.  An M tile's eight rows g are the conv
//    columns 4 g (+ 2, + 1) of one conv row, 12 g words apart, so the 32
//    lanes of a load hit 32 banks.  Taps past 21 are masked to zero.
//  * B, the 176 x 32 weights, arrives packed on the host in fragment order
//    (ops/kernels/stem.py:pack_weights, once per call) and sits in shared
//    memory: two 16-byte loads give a lane its fragments of one k-step.
//    Each warp runs four 16-pixel M tiles, two at a time.
//  * Epilogue: bias and max(y, slope * y) in f32, rounded to bf16 into a
//    shared conv tile (the pool's -inf outside the conv extent; a pixel's four
//    16-byte channel groups swizzled by its column, so the stores from the
//    accumulators are conflict-free); then the owned conv pixels and the
//    3x3/s2 maxima leave in 16-byte stores.
// Weights arrive pre-multiplied by the BN scale in f32 and rounded to
// bf16, as the TPU kernel does, so bf16 x bf16 products are exact in f32.
// On the H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md) this ran faster
// than gathering A with 16-bit loads, than K = 160 with a per-step offset
// table in shared memory, than four M tiles at a time, and than a
// persistent grid that prefetches the next tile's input with cp.async
// (its extra raw buffer leaves two blocks per SM, not three).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int KS = 7;                    // kernel size
constexpr int PAD = 3;                   // symmetric SAME padding
constexpr int CIN = 3;
constexpr int COUT = 32;
constexpr int TPH = 8, TPW = 16;         // pooled tile
constexpr int TCH = 2 * TPH + 1;         // conv tile incl. halo: 17 x 33
constexpr int TCW = 2 * TPW + 1;
constexpr int NPIX = TCH * TCW;          // 561
constexpr int WARPS = 9;
constexpr int THREADS = 32 * WARPS;
constexpr int MTILES = 2 * TCH + 2;      // 36: two per conv row, two for
                                         // the last column; four per warp
constexpr int TIH = 2 * (TCH - 1) + KS;  // input tile: 39 x 71
constexpr int TIW = 2 * (TCW - 1) + KS;
constexpr int ROW_ELEMS = TIW * CIN;     // 213 bf16 per staged row
constexpr int SP = 216;                  // shared pitch of a staged row
constexpr int CHUNKS = 28;               // 16-byte chunks a raw row keeps:
                                         // 7 of misalignment + SP elements
constexpr int RAW_PITCH = CHUNKS * 8;
constexpr int GROUPS = 3 * KS;           // groups of 8 GEMM rows: 21
constexpr int KSTEPS = (GROUPS + 1) / 2; // 11: K = 176
constexpr int CP = 40;                   // conv tile pitch per pixel (bf16)
constexpr int B_BYTES = KSTEPS * 2 * 32 * 16;
constexpr int CONV_BYTES = NPIX * CP * 2;
constexpr int IN_BYTES = TIH * SP * 2;
constexpr size_t SMEM_BYTES = B_BYTES + CONV_BYTES + IN_BYTES;
static_assert(MTILES == 4 * WARPS, "four M tiles per warp");
static_assert(CONV_BYTES % 16 == 0 && IN_BYTES % 16 == 0, "alignment");
static_assert(TIH * RAW_PITCH * 2 <= CONV_BYTES, "raw rows fit the conv tile");
static_assert(CHUNKS * 8 >= 7 + SP, "a raw row covers a staged row");
static_assert(2 * (TCW - 1) * CIN + 24 <= SP && ROW_ELEMS <= SP,
              "the last pixel's 24 padded taps stay in its staged row");

// The offset of GEMM row 8 G from a pixel's input window corner.
__host__ __device__ constexpr int koffset(int G) {
  return (G / 3) * SP + 8 * (G % 3);
}

constexpr int STAGE_CHUNKS = (TIH * CHUNKS + THREADS - 1) / THREADS;  // 4

// Raw chunk i: row r = i / CHUNKS holds image row ir0 + r from the 16-byte
// boundary at or before its element ic0 * 3 (which sits `a` elements in);
// the chunk is the ch-th run of 8 from there.  `fast`: it lies wholly
// inside the image row, so one 16-byte load reads it.
struct Chunk {
  long long lo, e0;     // the image row's first element, the chunk's
  int r;
  bool row_ok, fast;
};

__device__ __forceinline__ Chunk chunk(int i, int b, int H,
                                       long long row_len, int ir0, int ic0) {
  Chunk k;
  k.r = i / CHUNKS;
  const int ch = i - k.r * CHUNKS;
  const int gr = ir0 + k.r;
  k.lo = ((long long)b * H + gr) * row_len;
  k.e0 = ((k.lo + (long long)ic0 * CIN) & ~7LL) + 8LL * ch;
  k.row_ok = gr >= 0 && gr < H;
  k.fast = i < TIH * CHUNKS && k.row_ok && k.e0 >= k.lo &&
           k.e0 + 8 <= k.lo + row_len;
  return k;
}

// The conv tile pixel of row g (+ 8 for half 1) of M tile `tile`: tiles
// 0..33 take conv row tile / 2, columns 4 g + 2 half + tile % 2; tiles 34
// and 35 the last column, rows 16 (tile - 34) + 8 half + g (17 of them).
// Returns false for the 15 rows past the tile.
__device__ __forceinline__ bool tile_pixel(int tile, int half, int g,
                                           int* lr, int* lc) {
  if (tile < 2 * TCH) {
    *lr = tile >> 1;
    *lc = 4 * g + 2 * half + (tile & 1);
    return true;
  }
  *lr = 16 * (tile - 2 * TCH) + 8 * half + g;
  *lc = TCW - 1;
  return *lr < TCH;
}

// A pixel's channels 8 n .. 8 n + 7 sit in 16-byte group n ^ swizzle.
__device__ __forceinline__ int swizzle(int lc) { return (lc >> 3) & 3; }

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bmax2(unsigned a, unsigned b) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
  __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
  __nv_bfloat162 m = __hmax2(x, y);
  return *reinterpret_cast<unsigned*>(&m);
}

__device__ __forceinline__ uint4 bmax8(uint4 a, uint4 b) {
  return make_uint4(bmax2(a.x, b.x), bmax2(a.y, b.y), bmax2(a.z, b.z),
                    bmax2(a.w, b.w));
}

__global__ void __launch_bounds__(THREADS)
stem_conv_pool_kernel(const __nv_bfloat16* __restrict__ x,
                      const uint4* __restrict__ wpk,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out,
                      __nv_bfloat16* __restrict__ pooled,
                      int H, int W, int Ho, int Wo, int Hp, int Wp,
                      float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* s_b = reinterpret_cast<uint4*>(smem);         // [s][half][lane]
  __nv_bfloat16* conv_s =
      reinterpret_cast<__nv_bfloat16*>(smem + B_BYTES); // [pixel][CP]
  uint4* s_raw = reinterpret_cast<uint4*>(smem + B_BYTES);  // [row][chunk]
  unsigned short* s_in = reinterpret_cast<unsigned short*>(
      smem + B_BYTES + CONV_BYTES);                     // [row][SP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int pr0 = blockIdx.y * TPH, pc0 = blockIdx.x * TPW;
  const int cr0 = 2 * pr0 - 1, cc0 = 2 * pc0 - 1;      // conv tile origin
  const int ir0 = 2 * cr0 - PAD, ic0 = 2 * cc0 - PAD;  // input tile origin

  for (int i = tid; i < B_BYTES / 16; i += THREADS) s_b[i] = __ldg(wpk + i);

  // The raw rows (in the conv tile's space, free until the epilogue).  A
  // thread's chunks are i = tid + c * THREADS; all their 16-byte loads are
  // issued before any is stored.
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const long long row_len = (long long)W * CIN;
  uint4 q[STAGE_CHUNKS];
#pragma unroll
  for (int c = 0; c < STAGE_CHUNKS; ++c) {
    const Chunk k = chunk(tid + c * THREADS, b, H, row_len, ir0, ic0);
    if (k.fast) q[c] = __ldg(reinterpret_cast<const uint4*>(xs + k.e0));
  }
#pragma unroll
  for (int c = 0; c < STAGE_CHUNKS; ++c) {
    const int i = tid + c * THREADS;
    if (i >= TIH * CHUNKS) break;
    const Chunk k = chunk(i, b, H, row_len, ir0, ic0);
    if (!k.fast) {                 // the chunk crosses the image's edge
      unsigned w4[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const long long g0 = k.e0 + e, g1 = g0 + 1;
        const bool in0 = k.row_ok && g0 >= k.lo && g0 < k.lo + row_len;
        const bool in1 = k.row_ok && g1 >= k.lo && g1 < k.lo + row_len;
        w4[e / 2] = (in0 ? xs[g0] : 0u) | ((in1 ? xs[g1] : 0u) << 16);
      }
      q[c] = make_uint4(w4[0], w4[1], w4[2], w4[3]);
    }
    s_raw[i] = q[c];
  }
  __syncthreads();

  // Realign: staged word w of row r is raw elements a + 2 w and a + 2 w + 1
  // of that row, a = the row's misalignment.
  {
    const unsigned* raw = reinterpret_cast<const unsigned*>(s_raw);
    unsigned* in32 = reinterpret_cast<unsigned*>(s_in);
    const unsigned row_step = 3u * (unsigned)W;
    const unsigned a0 = ((unsigned)b * (unsigned)H + (unsigned)ir0) *
                            row_step + 3u * (unsigned)ic0;
    for (int i = tid; i < TIH * (SP / 2); i += THREADS) {
      const int r = i / (SP / 2), w = i - r * (SP / 2);
      const int a = (int)((a0 + (unsigned)r * row_step) & 7u);
      const unsigned* rr = raw + r * (RAW_PITCH / 2) + (a >> 1) + w;
      in32[i] = (a & 1) ? __byte_perm(rr[0], rr[1], 0x5432) : rr[0];
    }
  }
  __syncthreads();

  // The GEMM: warp w runs M tiles (w, w + 9) and then (w + 18, w + 27).
  // Lane (g, t) holds A rows g and g + 8 of each tile: the pixel's shared
  // base (its input window's corner) + 2 t, plus the group's offset.
  const int g = lane >> 2, t = lane & 3;
  // group 3 ky + 2 holds taps 16..23 of a kernel row: lane t's pair 16 +
  // 2 t is whole for t < 2, half for t = 2, padding for t = 3
  const unsigned tail = t < 2 ? 0xffffffffu : t == 2 ? 0xffffu : 0u;
#pragma unroll 1
  for (int pair = 0; pair < 2; ++pair) {
    int base[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int lr, lc;
      tile_pixel(warp + WARPS * (2 * pair + (i >> 1)), i & 1, g, &lr, &lc);
      base[i] = min(lr, TCH - 1) * 2 * SP + lc * 2 * CIN + 2 * t;
    }
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const uint4 bq0 = s_b[(s * 2 + 0) * 32 + lane];
      const uint4 bq1 = s_b[(s * 2 + 1) * 32 + lane];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        unsigned a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {          // rows 8 G .. 8 G + 7
          const int G = 2 * s + h;
          if (G >= GROUPS) {
            a[2 * h] = a[2 * h + 1] = 0u;
            continue;
          }
          const unsigned m = G % 3 == 2 ? tail : 0xffffffffu;
          a[2 * h] = m & *reinterpret_cast<const unsigned*>(
                             s_in + base[2 * i] + koffset(G));
          a[2 * h + 1] = m & *reinterpret_cast<const unsigned*>(
                                 s_in + base[2 * i + 1] + koffset(G));
        }
        mma_bf16(acc[i][0], a, bq0.x, bq0.y);
        mma_bf16(acc[i][1], a, bq0.z, bq0.w);
        mma_bf16(acc[i][2], a, bq1.x, bq1.y);
        mma_bf16(acc[i][3], a, bq1.z, bq1.w);
      }
    }
    // Epilogue: rows g (c0, c1) and g + 8 (c2, c3) of each tile, channels
    // 8n + 2t and + 1: bias, max(y, slope y), bf16, into the conv tile.
    // Every warp is past its reads of the raw rows (the barrier above).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int lr, lc;
      if (!tile_pixel(warp + WARPS * (2 * pair + (i >> 1)), i & 1, g, &lr,
                      &lc))
        continue;
      const int gr = cr0 + lr, gc = cc0 + lc;
      const bool inside = gr >= 0 && gr < Ho && gc >= 0 && gc < Wo;
      __nv_bfloat16* px = conv_s + (lr * TCW + lc) * CP + 2 * t;
      const int sw = swizzle(lc);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        unsigned v = 0xff80ff80u;                      // the pool's -inf
        if (inside) {
          const float* c = acc[i >> 1][n] + 2 * (i & 1);
          const float2 bb = __ldg(
              reinterpret_cast<const float2*>(bias + 8 * n + 2 * t));
          const float y0 = c[0] + bb.x, y1 = c[1] + bb.y;
          __nv_bfloat162 r = __floats2bfloat162_rn(fmaxf(y0, slope * y0),
                                                   fmaxf(y1, slope * y1));
          v = *reinterpret_cast<unsigned*>(&r);
        }
        *reinterpret_cast<unsigned*>(px + 8 * (n ^ sw)) = v;
      }
    }
  }
  __syncthreads();

  // The owned conv pixels (tile rows 1..16, columns 1..32), a quarter of
  // a pixel's channels per 16-byte store.
  for (int i = tid; i < 2 * TPH * 2 * TPW * 4; i += THREADS) {
    const int lr = 1 + (i >> 7), lc = 1 + ((i >> 2) & 31), q4 = i & 3;
    const int gr = cr0 + lr, gc = cc0 + lc;
    if (gr < Ho && gc < Wo)
      *reinterpret_cast<uint4*>(out + (((size_t)b * Ho + gr) * Wo + gc) *
                                          COUT + 8 * q4) =
          *reinterpret_cast<const uint4*>(
              conv_s + (lr * TCW + lc) * CP + 8 * (q4 ^ swizzle(lc)));
  }
  // MaxPool2d(3, 2, 1): pooled (pr0 + i, pc0 + j) reads conv tile rows
  // 2i..2i+2 and columns 2j..2j+2 (tile row 0 is conv row 2 pr0 - 1).
  for (int e = tid; e < TPH * TPW * 4; e += THREADS) {
    const int i = e >> 6, j = (e >> 2) & 15, q4 = e & 3;
    const int pr = pr0 + i, pc = pc0 + j;
    if (pr >= Hp || pc >= Wp) continue;
    uint4 m = make_uint4(0xff80ff80u, 0xff80ff80u, 0xff80ff80u, 0xff80ff80u);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int lc = 2 * j + dx;
        m = bmax8(m, *reinterpret_cast<const uint4*>(
                         conv_s + ((2 * i + dy) * TCW + lc) * CP +
                         8 * (q4 ^ swizzle(lc))));
      }
    *reinterpret_cast<uint4*>(pooled + (((size_t)b * Hp + pr) * Wp + pc) *
                                           COUT + 8 * q4) = m;
  }
}

}  // namespace

// x: (B, H, W, 3) bf16 NHWC, 16-byte aligned; w: the (176, 32) folded bf16
// weights in fragment order (ops/kernels/stem.py:pack_weights); bias:
// (32,) f32; slope: the activation max(y, slope * y); out: (B,
// ceil(H/2), ceil(W/2), 32) bf16; pooled: (B, ceil(Ho/2), ceil(Wo/2), 32)
// bf16.  Returns cudaGetLastError().
extern "C" int riders_stem_conv_pool(const void* x, const void* w,
                                     const void* bias, void* out,
                                     void* pooled, int B, int H, int W,
                                     float slope, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        stem_conv_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int Hp = (Ho + 1) / 2, Wp = (Wo + 1) / 2;
  if (B == 0 || Hp == 0 || Wp == 0) return 0;
  dim3 grid((Wp + TPW - 1) / TPW, (Hp + TPH - 1) / TPH, B);
  stem_conv_pool_kernel<<<grid, THREADS, SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
      static_cast<__nv_bfloat16*>(pooled), H, W, Ho, Wo, Hp, Wp, slope);
  return (int)cudaGetLastError();
}
