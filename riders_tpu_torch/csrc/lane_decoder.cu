// The lane-major RC-Net decoder's two convolutions, on NHWC bf16 maps of
// N = B*K patches:
//
//  * riders_lane_conv3x3 (B7): SAME 3x3 conv over the channel concat of
//    one or two inputs (the concat is never written: each input has its
//    own weight slice), f32 accumulation, then acc * scale + bias (folded
//    BN; none = linear), leaky-relu(slope) or none, one rounding to bf16.
//    Replaces riders_tpu/ops/pallas/lane_decoder.py:lane_conv3x3.
//  * riders_lane_upconv2x (B8): nearest x2 upsample + 3x3 conv + BN +
//    leaky in one pass.  The weights are the phase-composed (4F, 3, 3, Ci)
//    kernel bf16(nearest2x_phase_kernel(k)): each coarse cell computes its
//    four output phases from its 3x3 coarse window, and each phase has only
//    2x2 nonzero coarse taps, which the kernel skips.  The upsampled map is
//    never written.  Replaces lane_decoder.py:lane_upconv2x.
//
// The TPU kernels' (H, W, C, N) layout with its zero border, lane blocks,
// VMEM tiling and double-buffered DMA, and the output conv's Co padding
// to 8, served the MXU and Mosaic; none of it is kept.  Here a map is the
// port's own NHWC tensor.
//
// Bound on the H100: the calls with Ci, Co >= 128 by operations (one NTU
// decode_full, N = 768, does ~0.5 TFLOP, ~0.5 ms at the bf16 tensor
// rate); the 75x25 calls with Ci, Co <= 64 by bytes (a 64-channel input
// there is 184 MB, ~55 us at 3.35 TB/s), so reading each input byte once
// is what counts for them.
//
// B7 design: an implicit GEMM on the tensor cores (wgmma.mma_async,
// m64nBNk16, bf16 -> f32) that reads each input once.  The N maps are
// seen as one stack of (H+2) x (W+2) zero-bordered frames, flattened:
// padded position P needs, for tap (dy, dx), the padded position P +
// (dy-1)(W+2) + (dx-1), so every tap is one uniform shift.  A block
// stages the padded positions of its tile plus the (W+3) halo on either
// side, one chunk of BK input channels at a time, with 16-byte cp.async
// (zero-filled where a position falls on the border: the maps carry
// none), and all nine taps read that one staged tile.  BN, the output
// channels per block, fits Co: 8 for the Co = 4 output conv, then 16, 32
// or 64.  The host's plan (ops/kernels/lane_decoder.py:conv_plan) picks
// one of two kernels:
//  * resident weights (conv_res_kernel), where the inputs come in whole
//    16-byte channel runs and the weights are small (at decode_full's
//    shapes, the 75x25 and 120x50 calls with Ci * Co <= 4096): a
//    persistent grid whose blocks load their column tile's weights once
//    and walk tiles of 256 consecutive padded positions, the border ones
//    computed and dropped (a tenth of the work at 75x25).  The rows are
//    staged part-major (each 16-byte part of 8 channels in its own run of
//    rows), so any 8 consecutive rows form one core matrix and each tap's
//    A is a shared-memory descriptor from a shifted start; a chunk's
//    wgmma issue back to back.
//  * streamed weights (conv_kernel), everything else: one block per 256
//    consecutive output pixels (fewer for tiny maps whose halo would not
//    fit), so no border position is computed; each chunk's rows and 9 x
//    BN x BK weights go through a two-stage ring.  A comes from registers,
//    by ldmatrix at each pixel's shifted row (pixels' padded positions
//    are not evenly spaced), two register sets alternating so the next
//    tap's loads overlap this tap's wgmma.  Channels not a multiple of 8
//    take a scalar load path.
// B comes by descriptor from the weights in 8 x 8 core matrices.  The
// epilogue applies the folded BN and leaky in f32, rounds once, stages the
// tile in shared memory and writes whole 16-byte channel runs.  On the
// H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md) these ran slower: the
// resident kernel with 3-4 stages of rows, with 32-column tiles for Co =
// 64, or with its epilogue stored straight from registers; resident
// weights beyond 160 KB of shared memory ran no faster than streamed ones
// (those of 113-160 KB, one block per SM, ran faster at 4096-6144
// patches).  For the streamed kernel, tiles of 128 pixels,
// 128-column tiles, 512-pixel tiles, more A register sets in flight and an
// mma.sync.m16n8k16 version all ran no faster.
//
// B8 design: B7's machinery with the phase-composed weights.  Its bound:
// the operations where Ci, F >= 128 (decode calls at 9x3 and 15x6), the
// bytes at ZJU's 60x25 call (64 -> 32: 98 MB in, 197 MB out).  Rows and
// halo are staged as for B7 and each phase multiplies only its four
// nonzero taps.  Where F <= 32, the inputs come in 16-byte runs and the
// 16 phase taps' weights fit, one block takes all four phases of its
// pixels (4F columns) with the weights resident (upconv_res_kernel, B7's
// persistent walk, A by descriptor), so each input byte is staged once
// and each staged tap serves every phase that reads it.  Otherwise the
// weights stream with 64-column tiles of one phase (upconv_kernel).  The
// epilogue sends coarse pixel (y, x), phase (r, s) to fine pixel (2y + r,
// 2x + s) as whole 16-byte channel runs; the resident form writes them
// straight from registers after a transpose within each lane quad, since
// at ZJU's 60x25 call (four phases of 32 channels a pixel) the staged
// epilogue's passes and barriers took about half the time (an ablation
// on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = full ? 16 : 0;    // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// ---------------------------------------------------------------- B7

namespace halo {

constexpr int THREADS = 256;      // two warpgroups

struct Src {
  const bf16* x;    // (N, H, W, ci)
  const bf16* w;    // (Co, 3, 3, ci)
  int ci;
};

struct Args {
  Src in[2];
  int n_inputs;
  const float* scale;   // (Co) or NULL
  const float* bias;
  bf16* out;            // (N, H, W, Co)
  int N, H, W, Co;
  int bm;               // output pixels per block, a multiple of 16
  int rows;             // staged padded positions per chunk
  float slope;
  int act;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// A shared-memory matrix descriptor without swizzle: start address, the
// byte offsets between core matrices along K (lbo) and along M or N
// (sbo).
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lbo,
                                           unsigned sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// shared memory written by threads, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (m64 x N, f32) += A (m64 x k16, bf16, by descriptor or in registers)
// x B (k16 x N, bf16, by descriptor)
template <int N>
struct Wgmma;
template <> struct Wgmma<8> {
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// A block: BM output pixels (two warpgroups of BM / 2 rows, each in m64
// tiles) x BN output channels; chunks of BK input channels, TAPS taps of
// BN columns each per chunk.
template <int BN, int BM, int BK, int TAPS = 9>
struct Tile {
  static constexpr int MT = BM / 128;         // m64 tiles per warpgroup
  static constexpr int PITCH = BK + 8;        // bf16 per staged row of A
  static constexpr int CPITCH = BN + 8;       // bf16 per epilogue row
  // one chunk's TAPS x BN x BK weights in 8 x 8 core matrices (8 output
  // channels x 16 bytes), K-major
  static constexpr int WCHUNK = TAPS * BN * BK;
  static __host__ __device__ size_t a_stage(int rows) {
    return (size_t)rows * PITCH;
  }
  // Streamed weights: two stages of (staged rows of A, one chunk's
  // weights), the epilogue tile overlapping them, then the rows' source
  // table.
  static __host__ __device__ size_t region(int rows) {
    const size_t ring = 2 * (a_stage(rows) + WCHUNK), c = (size_t)BM * CPITCH;
    return ring > c ? ring : c;
  }
  static size_t smem_bytes(int rows) {
    return region(rows) * sizeof(bf16) + 4 * (size_t)rows;
  }
};

// The padded position of output pixel m: frame n of the (H+2) x (W+2)
// stack, row y + 1, column x + 1.
__device__ __forceinline__ int padpos(const Args& a, int m) {
  const int HW = a.H * a.W, Wp = a.W + 2;
  const int n = m / HW, r = m - n * HW, y = r / a.W, x = r - y * a.W;
  return n * (a.H + 2) * Wp + (y + 1) * Wp + x + 1;
}

// The source pixel of each of the a.rows padded positions from p0, -1 on
// the border.
__device__ __forceinline__ void source_rows(const Args& a, int p0,
                                            int* src_row) {
  const int Wp = a.W + 2, HWp = (a.H + 2) * Wp;
  for (int r = threadIdx.x; r < a.rows; r += THREADS) {
    const int P = p0 + r;
    const int n = P / HWp, rem = P - n * HWp;
    const int y = rem / Wp - 1, x = rem - (rem / Wp) * Wp - 1;
    src_row[r] = (n < a.N && y >= 0 && y < a.H && x >= 0 && x < a.W)
                     ? (n * a.H + y) * a.W + x
                     : -1;
  }
}

// This lane's ldmatrix row of A in each m64 tile of the block at m0,
// relative to p0 (a pixel past the block or the map reads the first
// pixel's row): warp wq of a warpgroup holds rows 16 wq .. 16 wq + 15 of
// each tile.
template <int BM, int MT>
__device__ __forceinline__ void pixel_rows(const Args& a, int m0, int p0,
                                           int (&arow)[MT]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wq = warp & 3, M = a.N * a.H * a.W;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int i = wg * (BM / 2) + mt * 64 + wq * 16 + (lane & 15);
    arow[mt] = (i < a.bm && m0 + i < M) ? padpos(a, m0 + i) - p0 : a.W + 3;
  }
}

// Chunk q of the inputs' channels (nc0 chunks of the first input, then
// the second's).
struct Chunk {
  const bf16* x;
  const bf16* w;
  int ci, c0;
};
template <int BK>
__device__ __forceinline__ Chunk chunk(const Args& a, int q, int nc0) {
  const Src& s = a.in[q < nc0 ? 0 : 1];
  return Chunk{s.x, s.w, s.ci, (q < nc0 ? q : q - nc0) * BK};
}
template <int BK>
__host__ __device__ __forceinline__ int chunks(const Args& a, int* nc0) {
  *nc0 = (a.in[0].ci + BK - 1) / BK;
  return *nc0 + (a.n_inputs > 1 ? (a.in[1].ci + BK - 1) / BK : 0);
}

// The chunk's channels of the staged rows into sa (rows of BK + 8 bf16).
template <int BK, bool VEC>
__device__ __forceinline__ void load_a(const Args& a, const Chunk& c,
                                       const int* src_row, bf16* sa) {
  constexpr int PARTS = BK / 8;
  for (int e = threadIdx.x; e < a.rows * PARTS; e += THREADS) {
    const int r = e / PARTS, part = e % PARTS;
    const int ch = c.c0 + part * 8;
    const int src = src_row[r];
    bf16* dst = sa + r * (BK + 8) + part * 8;
    const size_t at = (size_t)(src < 0 ? 0 : src) * c.ci + ch;
    if (VEC) {
      const bool full = src >= 0 && ch < c.ci;
      cp_async16(dst, full ? (const void*)(c.x + at) : (const void*)c.x,
                 full);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = src >= 0 && ch + j < c.ci ? c.x[at + j]
                                           : __float2bfloat16(0.f);
    }
  }
}

// The chunk's 9 x BN x BK weights of output channels co0.. into sb.
template <int BN, int BK, bool VEC>
__device__ __forceinline__ void load_w(const Args& a, const Chunk& c,
                                       int co0, bf16* sb) {
  constexpr int PARTS = BK / 8;
  for (int e = threadIdx.x; e < 9 * BN * PARTS; e += THREADS) {
    const int row = e / PARTS, part = e % PARTS;
    const int t = row / BN, n = row % BN, co = co0 + n;
    const int ch = c.c0 + part * 8;
    bf16* dst = sb + t * (BN * BK) + ((n >> 3) * PARTS + part) * 64 +
                (n & 7) * 8;
    const size_t at = ((size_t)co * 9 + t) * c.ci + ch;
    if (VEC) {
      const bool full = co < a.Co && ch < c.ci;
      cp_async16(dst, full ? (const void*)(c.w + at) : (const void*)c.w,
                 full);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = co < a.Co && ch + j < c.ci ? c.w[at + j]
                                            : __float2bfloat16(0.f);
    }
  }
}

// The row shift of tap (dy, dx) in the staged padded rows.
__device__ __forceinline__ int tap_shift(int dy, int dx, int Wp) {
  return (dy - 1) * Wp + (dx - 1);
}

// acc += the TAPS taps of the chunk staged at shared addresses sa (rows
// of A) and sb (weights, tap t's at t * BN * BK), tap t reading the rows
// shifted by shift(t).  Each tap's A fragments alternate between two
// register sets, so the next tap's ldmatrix overlaps this tap's wgmma.
template <int BN, int BK, int MT, int TAPS, typename Shift>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][BN / 2],
                                          unsigned sa, unsigned sb,
                                          const int (&arow)[MT],
                                          Shift shift_of) {
  constexpr int ASETS = 2;                  // A register sets in flight
  const int a_k = ((threadIdx.x & 31) >> 4) * 8;   // ldmatrix lane: k
  uint32_t af[ASETS][MT][4];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    const int shift = shift_of(t);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int s = (t * (BK / 16) + kk / 16) % ASETS;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[s][mt], sa + (unsigned)(((arow[mt] + shift) * (BK + 8) +
                                            kk + a_k) * 2));
      wg_fence();
      const uint64_t desc = smem_desc(
          sb + (unsigned)((t * BN * BK + (kk / 8) * 64) * 2), 128,
          (BK / 8) * 128);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        Wgmma<BN>::run(acc[mt], af[s][mt], desc);
      wg_commit();
      wg_wait<ASETS - 1>();
    }
  }
  wg_wait<0>();
}

// BN fold and leaky in f32, one rounding, into the shared tile ct, then
// whole 16-byte channel runs of rows 0 .. n_rows - 1 to their output
// pixels, pixel(r) (-1: not an output).  Accumulator j of an m64 tile is
// row g + 8 ((j / 2) % 2), column 8 (j / 4) + 2 tg + j % 2.
template <int BN, int BM, int MT, typename Pixel>
__device__ __forceinline__ void epilogue(const Args& a,
                                         const float (&acc)[MT][BN / 2],
                                         bf16* ct, int co0, int n_rows,
                                         Pixel pixel) {
  constexpr int CPITCH = BN + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) {
    const int col = nb * 8 + 2 * tg;
    float sc[2] = {1.f, 1.f}, bi[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (a.scale != nullptr && co0 + col + j < a.Co) {
        sc[j] = a.scale[co0 + col + j];
        bi[j] = a.bias[co0 + col + j];
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[j] = acc[mt][4 * nb + 2 * h + j];
          if (a.scale != nullptr)
            v[j] = __fadd_rn(__fmul_rn(v[j], sc[j]), bi[j]);
          if (a.act && !(v[j] > 0.f)) v[j] = __fmul_rn(a.slope, v[j]);
        }
        const int row = wg * (BM / 2) + mt * 64 + wq * 16 + g + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(&ct[row * CPITCH + col]) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
  }
  __syncthreads();

  constexpr int RUNS = BN / 8;
  const bool vec_out = a.Co % 8 == 0;
  for (int e = tid; e < n_rows * RUNS; e += THREADS) {
    const int r = e / RUNS, j = e % RUNS;
    const int co = co0 + j * 8, m = pixel(r);
    if (co >= a.Co || m < 0) continue;
    const bf16* src = &ct[r * CPITCH + j * 8];
    bf16* d = a.out + (size_t)m * a.Co + co;
    if (vec_out) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < 8 && co + i < a.Co; ++i) d[i] = src[i];
    }
  }
}

// Streamed weights: one block per (pixel tile, column tile); each chunk's
// rows of A and weights go through a two-stage ring, chunk q + 1 loading
// while chunk q multiplies (the one barrier per chunk also frees the slot
// chunk q - 1 used).
template <int BN, int BM, int BK, bool VEC>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const Args a) {
  using T = Tile<BN, BM, BK>;
  constexpr int MT = T::MT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const size_t st_elems = T::a_stage(a.rows) + T::WCHUNK;
  int* src_row = reinterpret_cast<int*>(smem + T::region(a.rows));

  const int m0 = blockIdx.x * a.bm;
  const int co0 = blockIdx.y * BN;
  const int p0 = padpos(a, m0) - (a.W + 3);  // >= 0: the first pixel's halo
  source_rows(a, p0, src_row);
  int arow[MT];
  pixel_rows<BM>(a, m0, p0, arow);
  const bool busy = (threadIdx.x >> 7) * (BM / 2) < a.bm;  // has pixels
  int nc0;
  const int nq = chunks<BK>(a, &nc0);
  __syncthreads();                        // src_row ready

  auto load = [&](int q, int st) {
    const Chunk c = chunk<BK>(a, q, nc0);
    bf16* sa = smem + st * st_elems;
    load_a<BK, VEC>(a, c, src_row, sa);
    load_w<BN, BK, VEC>(a, c, co0, sa + T::a_stage(a.rows));
  };

  float acc[MT][BN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[mt][j] = 0.f;

  const unsigned smem_base = (unsigned)__cvta_generic_to_shared(smem);
  load(0, 0);
  cp_async_commit();
  for (int q = 0; q < nq; ++q) {
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();
    if (q + 1 < nq) load(q + 1, (q + 1) & 1);
    cp_async_commit();
    if (busy) {
      const unsigned sa = smem_base + (unsigned)((q & 1) * st_elems * 2);
      const int Wp = a.W + 2;
      mma_chunk<BN, BK, MT, 9>(
          acc, sa, sa + (unsigned)(T::a_stage(a.rows) * 2), arow,
          [Wp](int t) { return tap_shift(t / 3, t % 3, Wp); });
    }
  }
  cp_async_wait_all();
  fence_async_shared();
  __syncthreads();                        // the epilogue tile overlaps
  epilogue<BN, BM, MT>(a, acc, smem, co0, min(a.bm, a.N * a.H * a.W - m0),
                       [&](int r) { return m0 + r; });
}

// The chunk's channels of the staged rows into sa, part-major: 16-byte
// part p of row r at (p * rows + r) * 8, so that every run of 8 rows of
// one part is one 128-byte core matrix, whatever row it starts at.
template <int BK>
__device__ __forceinline__ void load_a_parts(const Args& a, const Chunk& c,
                                             const int* src_row, bf16* sa) {
  constexpr int PARTS = BK / 8;
  for (int e = threadIdx.x; e < a.rows * PARTS; e += THREADS) {
    const int r = e / PARTS, part = e % PARTS;
    const int ch = c.c0 + part * 8;
    const int src = src_row[r];
    const bool full = src >= 0 && ch < c.ci;
    const size_t at = (size_t)(src < 0 ? 0 : src) * c.ci + ch;
    cp_async16(sa + ((size_t)part * a.rows + r) * 8,
               full ? (const void*)(c.x + at) : (const void*)c.x, full);
  }
}

// Shared memory of the resident kernel: nq chunks' weights, two stages of
// part-major rows, the epilogue tile, the rows' source table.
template <int BN, int BK>
size_t res_smem_bytes(int rows, int nq) {
  return ((size_t)nq * 9 * BN * BK + 2 * (size_t)rows * BK +
          256 * (size_t)(BN + 8)) * sizeof(bf16) + 4 * (size_t)rows;
}

// Resident weights, a persistent grid, A by descriptor.  A tile is a run
// of 256 consecutive padded positions (the border ones are computed and
// dropped), so each tap's A is the staged rows from one shifted start,
// which the tensor cores read from shared memory; each chunk's 9 x BK / 16
// x 2 wgmma are issued back to back.  A block loads its column tile's
// weights for every chunk once, then walks the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...; the (tile, chunk) units' rows go through a
// two-stage ring, the next unit loading while this one multiplies.
template <int BN, int BK>
__global__ void __launch_bounds__(THREADS)
conv_res_kernel(const Args a) {
  constexpr int BM = 256, MT = 2, WCHUNK = 9 * BN * BK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int nc0;
  const int nq = chunks<BK>(a, &nc0);
  const int Wp = a.W + 2, HWp = (a.H + 2) * Wp;
  bf16* sw = reinterpret_cast<bf16*>(smem_raw);
  bf16* sa0 = sw + (size_t)nq * WCHUNK;
  const size_t a_st = (size_t)a.rows * BK;
  bf16* ct = sa0 + 2 * a_st;
  int* src_row = reinterpret_cast<int*>(ct + BM * (BN + 8));

  const int co0 = blockIdx.y * BN;
  // the padded positions from the first map pixel to the last
  const int first = Wp + 1, last = (a.N - 1) * HWp + a.H * Wp + a.W;
  const int tiles = (last - first) / BM + 1;
  if ((int)blockIdx.x >= tiles) return;
  const int units = ((tiles - 1 - blockIdx.x) / gridDim.x + 1) * nq;
  auto tile_p0 = [&](int j) {
    return first + (blockIdx.x + j * gridDim.x) * BM;
  };

  for (int q = 0; q < nq; ++q)
    load_w<BN, BK, true>(a, chunk<BK>(a, q, nc0), co0, sw + q * WCHUNK);
  source_rows(a, tile_p0(0) - first, src_row);
  __syncthreads();
  load_a_parts<BK>(a, chunk<BK>(a, 0, nc0), src_row, sa0);
  cp_async_commit();

  const int wg = threadIdx.x >> 7;
  const unsigned sw_base = (unsigned)__cvta_generic_to_shared(sw);
  const unsigned sa_base = (unsigned)__cvta_generic_to_shared(sa0);
  float acc[MT][BN / 2];
  for (int u = 0; u < units; ++u) {
    const int j = u / nq, q = u - j * nq;
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();        // unit u landed; its slot's old reads are done
    if (u + 1 < units) {
      const int j1 = (u + 1) / nq, q1 = u + 1 - j1 * nq;
      if (q1 == 0) {        // a new tile: its rows' sources first
        source_rows(a, tile_p0(j1) - first, src_row);
        __syncthreads();
      }
      load_a_parts<BK>(a, chunk<BK>(a, q1, nc0), src_row,
                       sa0 + ((u + 1) & 1) * a_st);
    }
    cp_async_commit();
    if (q == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
    }
    // position i of the tile reads staged row i + first + shift
    const unsigned sa = sa_base + (unsigned)((u & 1) * a_st * 2);
    const unsigned sb = sw_base + (unsigned)(q * WCHUNK * 2);
    wg_fence();
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int shift = tap_shift(t / 3, t % 3, Wp);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        const uint64_t bd = smem_desc(
            sb + (unsigned)((t * BN * BK + (kk / 8) * 64) * 2), 128,
            (BK / 8) * 128);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int row = wg * 128 + mt * 64 + first + shift;
          const uint64_t ad = smem_desc(
              sa + (unsigned)(((kk / 8) * a.rows + row) * 16),
              (unsigned)a.rows * 16, 128);
          Wgmma<BN>::run(acc[mt], ad, bd);
        }
      }
    }
    wg_commit();
    wg_wait<0>();
    if (q == nq - 1) {
      const int P0 = tile_p0(j);
      epilogue<BN, BM, MT>(
          a, acc, ct, co0, min(BM, last - P0 + 1), [&](int r) {
            const int P = P0 + r, n = P / HWp;
            const int rem = P - n * HWp, y = rem / Wp - 1;
            const int x = rem - (y + 1) * Wp - 1;
            return (y >= 0 && y < a.H && x >= 0 && x < a.W)
                       ? (n * a.H + y) * a.W + x
                       : -1;
          });
    }
  }
  cp_async_wait_all();
}

template <int BN, int BM, int BK>
int launch(const Args& a, bool vec, cudaStream_t stream) {
  const size_t smem = Tile<BN, BM, BK>::smem_bytes(a.rows);
  if (smem > 232448 || a.bm > BM) return (int)cudaErrorInvalidValue;
  const int M = a.N * a.H * a.W;
  dim3 grid((M + a.bm - 1) / a.bm, (a.Co + BN - 1) / BN);
  auto kernel = vec ? conv_kernel<BN, BM, BK, true>
                    : conv_kernel<BN, BM, BK, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The persistent grid: as many blocks as fit on the card at once, split
// over the column tiles, at most one per tile.  rows must be 256 + 2 (W +
// 3).
template <int BN, int BK>
int launch_res(const Args& a, cudaStream_t stream) {
  int nc0;
  const size_t smem = res_smem_bytes<BN, BK>(a.rows, chunks<BK>(a, &nc0));
  if (smem > 232448 || a.rows != 256 + 2 * (a.W + 3))
    return (int)cudaErrorInvalidValue;
  auto kernel = conv_res_kernel<BN, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const int Wp = a.W + 2, HWp = (a.H + 2) * Wp;
  const int tiles = ((a.N - 1) * HWp + a.H * Wp + a.W - (Wp + 1)) / 256 + 1;
  const int cols = (a.Co + BN - 1) / BN;
  const int x = max(1, min(tiles, sms * max(per_sm, 1) / cols));
  kernel<<<dim3(x, cols), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- B8

// Phase p = (r, s) = (p / 2, p % 2) of the upconv reads the coarse taps
// (r + i / 2, s + i % 2), i = 0..3: the 2x2 taps where its phase-composed
// weights are nonzero (the other five are zero).
__device__ __forceinline__ int phase_tap(int p, int i) {
  return ((p >> 1) + (i >> 1)) * 3 + (p & 1) + (i & 1);
}

// The chunk's weights of phases p0 .. p0 + PH - 1, each phase's four taps
// and its columns f0 .. f0 + BN - 1 (row p F + f of the packed (4F, 3, 3,
// ci) weights; a.Co = F), into sb: phase tap (p - p0) * 4 + i at that
// multiple of BN * BK, in load_w's 8 x 8 core matrices.
template <int BN, int BK, int PH, bool VEC>
__device__ __forceinline__ void load_w_up(const Args& a, const Chunk& c,
                                          int p0, int f0, bf16* sb) {
  constexpr int PARTS = BK / 8;
  for (int e = threadIdx.x; e < PH * 4 * BN * PARTS; e += THREADS) {
    const int row = e / PARTS, part = e % PARTS;
    const int pt = row / BN, n = row % BN, f = f0 + n, p = p0 + pt / 4;
    const int ch = c.c0 + part * 8;
    bf16* dst = sb + pt * (BN * BK) + ((n >> 3) * PARTS + part) * 64 +
                (n & 7) * 8;
    const size_t at =
        ((size_t)(p * a.Co + f) * 9 + phase_tap(p, pt % 4)) * c.ci + ch;
    if (VEC) {
      const bool full = f < a.Co && ch < c.ci;
      cp_async16(dst, full ? (const void*)(c.w + at) : (const void*)c.w,
                 full);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = f < a.Co && ch + j < c.ci ? c.w[at + j]
                                           : __float2bfloat16(0.f);
    }
  }
}

// B8 with streamed weights: nearest x2 + 3x3 conv + BN + leaky as a GEMM
// over the coarse map (N, H, W, ci) (a.H, a.W coarse; a.Co = F) against
// the phase-composed weights, streamed as conv_kernel does.  A block owns
// bm coarse pixels and BN columns of one phase (gridDim.y = 4 phases x
// the column tiles of F) and sums that phase's four nonzero taps only.
// Coarse pixel (y, x), phase (r, s) goes to fine pixel (2 y + r, 2 x + s)
// in whole 16-byte channel runs; the BN fold is indexed by the column
// within F.
template <int BN, int BM, int BK, bool VEC>
__global__ void __launch_bounds__(THREADS)
upconv_kernel(const Args a) {
  using T = Tile<BN, BM, BK, 4>;
  constexpr int MT = T::MT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const size_t st_elems = T::a_stage(a.rows) + T::WCHUNK;
  int* src_row = reinterpret_cast<int*>(smem + T::region(a.rows));

  const int ftiles = (a.Co + BN - 1) / BN;      // column tiles per phase
  const int p0 = blockIdx.y / ftiles, r = p0 >> 1, s = p0 & 1;
  const int f0 = (blockIdx.y % ftiles) * BN;
  const int m0 = blockIdx.x * a.bm;
  const int q0 = padpos(a, m0) - (a.W + 3);
  source_rows(a, q0, src_row);
  int arow[MT];
  pixel_rows<BM>(a, m0, q0, arow);
  const bool busy = (threadIdx.x >> 7) * (BM / 2) < a.bm;
  const int nq = (a.in[0].ci + BK - 1) / BK;
  const int Wp = a.W + 2;
  __syncthreads();                        // src_row ready

  auto load = [&](int q, int st) {
    const Chunk c{a.in[0].x, a.in[0].w, a.in[0].ci, q * BK};
    bf16* sa = smem + st * st_elems;
    load_a<BK, VEC>(a, c, src_row, sa);
    load_w_up<BN, BK, 1, VEC>(a, c, p0, f0, sa + T::a_stage(a.rows));
  };

  float acc[MT][BN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[mt][j] = 0.f;

  const unsigned smem_base = (unsigned)__cvta_generic_to_shared(smem);
  load(0, 0);
  cp_async_commit();
  for (int q = 0; q < nq; ++q) {
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();
    if (q + 1 < nq) load(q + 1, (q + 1) & 1);
    cp_async_commit();
    if (busy) {
      const unsigned sa = smem_base + (unsigned)((q & 1) * st_elems * 2);
      mma_chunk<BN, BK, MT, 4>(
          acc, sa, sa + (unsigned)(T::a_stage(a.rows) * 2), arow,
          [=](int i) { return tap_shift(r + (i >> 1), s + (i & 1), Wp); });
    }
  }
  cp_async_wait_all();
  fence_async_shared();
  __syncthreads();                        // the epilogue tile overlaps

  const int HW = a.H * a.W;
  epilogue<BN, BM, MT>(a, acc, smem, f0, min(a.bm, a.N * HW - m0),
                       [&](int i) {
    const int m = m0 + i, n = m / HW, rem = m - n * HW, y = rem / a.W;
    return (n * 2 * a.H + 2 * y + r) * (2 * a.W) + 2 * (rem - y * a.W) + s;
  });
}

template <int BN, int BM, int BK>
int launch_up(const Args& a, bool vec, cudaStream_t stream) {
  const size_t smem = Tile<BN, BM, BK, 4>::smem_bytes(a.rows);
  if (smem > 232448 || a.bm > BM) return (int)cudaErrorInvalidValue;
  const int M = a.N * a.H * a.W, ftiles = (a.Co + BN - 1) / BN;
  dim3 grid((M + a.bm - 1) / a.bm, 4 * ftiles);
  auto kernel = vec ? upconv_kernel<BN, BM, BK, true>
                    : upconv_kernel<BN, BM, BK, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Shared memory of the resident upconv: nq chunks' 16 phase taps of
// weights, two stages of part-major rows, the rows' source table.
template <int BN, int BK>
size_t up_res_smem_bytes(int rows, int nq) {
  return ((size_t)nq * 16 * BN * BK + 2 * (size_t)rows * BK) * sizeof(bf16) +
         4 * (size_t)rows;
}

// The resident upconv's epilogue for one phase, straight from the
// accumulators of an m64 tile (BN = 32 columns, accumulator j at row g +
// 8 ((j / 2) % 2), column 8 (j / 4) + 2 tg + j % 2): the BN fold (sc, bi:
// this lane's eight columns) and leaky in f32, one rounding to bf16, then
// a 4 x 4 transpose of 32-bit words among the four lanes of a row quad
// (three shuffles), so lane tg holds columns 8 tg .. 8 tg + 7 of both its
// rows and writes each as one 16-byte run to out + fine[h] * F, fine[h]
// the phase's fine pixel of row g + 8 h (-1: none).  No shared staging,
// no barrier.
__device__ __forceinline__ void store_phase(const Args& a,
                                            const float (&acc)[16],
                                            const float (&sc)[8],
                                            const float (&bi)[8],
                                            const int (&fine)[2]) {
  const int lane = threadIdx.x & 31, tg = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[4];                        // n-block nb's two columns
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = acc[4 * nb + 2 * h + e];
        if (a.scale != nullptr)
          v[e] = __fadd_rn(__fmul_rn(v[e], sc[2 * nb + e]), bi[2 * nb + e]);
        if (a.act && !(v[e] > 0.f)) v[e] = __fmul_rn(a.slope, v[e]);
      }
      __nv_bfloat162 b2 = __floats2bfloat162_rn(v[0], v[1]);
      w[nb] = *reinterpret_cast<uint32_t*>(&b2);
    }
    // lane tg gathers word tg (its own n-block) of each quad lane t:
    // from lane (tg - k) & 3 in round k, which sends its word tg
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int send = (tg + k) & 3, from = (tg - k) & 3;
      const uint32_t x = send == 0 ? w[0] : send == 1 ? w[1]
                       : send == 2 ? w[2] : w[3];
      const uint32_t y =
          k == 0 ? x : __shfl_sync(0xffffffffu, x, (lane & ~3) | from);
#pragma unroll
      for (int t = 0; t < 4; ++t) o[t] = from == t ? y : o[t];
    }
    const int c0 = 8 * tg;
    if (fine[h] < 0 || c0 >= a.Co) continue;
    bf16* d = a.out + (size_t)fine[h] * a.Co + c0;
    if (a.Co % 8 == 0) {
      *reinterpret_cast<uint4*>(d) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      unsigned short* ds = reinterpret_cast<unsigned short*>(d);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (c0 + i < a.Co)
          ds[i] = (unsigned short)(o[i / 2] >> (16 * (i % 2)));
    }
  }
}

// B8 with resident weights and all four phases per block (F <= BN = 32,
// the inputs in whole 16-byte channel runs): conv_res_kernel's walk (a
// persistent grid over tiles of BM consecutive padded positions of the
// coarse stack, the border ones computed and dropped, A by descriptor
// from part-major rows, the next unit's rows loading while this one
// multiplies) with each phase's four taps, every wgmma of a chunk issued
// back to back, and store_phase's epilogue from registers for each phase.
template <int BN, int BK, int BM>
__global__ void __launch_bounds__(THREADS)
upconv_res_kernel(const Args a) {
  static_assert(BN == 32, "store_phase transposes four n-blocks");
  constexpr int MT = BM / 128, WCHUNK = 16 * BN * BK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nq = (a.in[0].ci + BK - 1) / BK;
  const int Wp = a.W + 2, HWp = (a.H + 2) * Wp;
  bf16* sw = reinterpret_cast<bf16*>(smem_raw);
  bf16* sa0 = sw + (size_t)nq * WCHUNK;
  const size_t a_st = (size_t)a.rows * BK;
  int* src_row = reinterpret_cast<int*>(sa0 + 2 * a_st);

  // the padded positions from the first map pixel to the last
  const int first = Wp + 1, last = (a.N - 1) * HWp + a.H * Wp + a.W;
  const int tiles = (last - first) / BM + 1;
  if ((int)blockIdx.x >= tiles) return;
  const int units = ((tiles - 1 - blockIdx.x) / gridDim.x + 1) * nq;
  auto tile_p0 = [&](int j) {
    return first + (blockIdx.x + j * gridDim.x) * BM;
  };
  auto chunk_q = [&](int q) {
    return Chunk{a.in[0].x, a.in[0].w, a.in[0].ci, q * BK};
  };

  for (int q = 0; q < nq; ++q)
    load_w_up<BN, BK, 4, true>(a, chunk_q(q), 0, 0, sw + q * WCHUNK);
  source_rows(a, tile_p0(0) - first, src_row);
  __syncthreads();
  load_a_parts<BK>(a, chunk_q(0), src_row, sa0);
  cp_async_commit();

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const unsigned sw_base = (unsigned)__cvta_generic_to_shared(sw);
  const unsigned sa_base = (unsigned)__cvta_generic_to_shared(sa0);
  // this lane's eight columns' BN fold, the same for every tile
  float sc[8], bi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = 8 * (i / 2) + 2 * (lane & 3) + i % 2;
    const bool on = a.scale != nullptr && f < a.Co;
    sc[i] = on ? a.scale[f] : 1.f;
    bi[i] = on ? a.bias[f] : 0.f;
  }
  float acc[4][MT][BN / 2];
  for (int u = 0; u < units; ++u) {
    const int j = u / nq, q = u - j * nq;
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();        // unit u landed; its slot's old reads are done
    if (u + 1 < units) {
      const int j1 = (u + 1) / nq, q1 = u + 1 - j1 * nq;
      if (q1 == 0) {        // a new tile: its rows' sources first
        source_rows(a, tile_p0(j1) - first, src_row);
        __syncthreads();
      }
      load_a_parts<BK>(a, chunk_q(q1), src_row, sa0 + ((u + 1) & 1) * a_st);
    }
    cp_async_commit();
    if (q == 0) {
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[p][mt][i] = 0.f;
    }
    // position i of the tile reads staged row i + first + shift
    const unsigned sa = sa_base + (unsigned)((u & 1) * a_st * 2);
    const unsigned sb = sw_base + (unsigned)(q * WCHUNK * 2);
    wg_fence();
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t % 3, shift = tap_shift(dy, dx, Wp);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int iy = dy - (p >> 1), ix = dx - (p & 1);
          if (iy < 0 || iy > 1 || ix < 0 || ix > 1) continue;
          const uint64_t bd = smem_desc(
              sb + (unsigned)(((p * 4 + iy * 2 + ix) * BN * BK +
                               (kk / 8) * 64) * 2),
              128, (BK / 8) * 128);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int row = wg * (BM / 2) + mt * 64 + first + shift;
            const uint64_t ad = smem_desc(
                sa + (unsigned)(((kk / 8) * a.rows + row) * 16),
                (unsigned)a.rows * 16, 128);
            Wgmma<BN>::run(acc[p][mt], ad, bd);
          }
        }
      }
    }
    wg_commit();
    wg_wait<0>();
    if (q == nq - 1) {
      const int P0 = tile_p0(j);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // phase (0, 0)'s fine pixel of this lane's rows g and g + 8
        int fine[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int P = P0 + wg * (BM / 2) + mt * 64 +
                        ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2) + 8 * h;
          const int n = P / HWp, rem = P - n * HWp, y = rem / Wp - 1;
          const int x = rem - (y + 1) * Wp - 1;
          fine[h] = P <= last && y >= 0 && y < a.H && x >= 0 && x < a.W
                        ? (n * 2 * a.H + 2 * y) * (2 * a.W) + 2 * x
                        : -1;
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int step = (p >> 1) * 2 * a.W + (p & 1);
          const int at[2] = {fine[0] < 0 ? -1 : fine[0] + step,
                             fine[1] < 0 ? -1 : fine[1] + step};
          store_phase(a, acc[p][mt], sc, bi, at);
        }
      }
    }
  }
  cp_async_wait_all();
}

// The persistent grid, as launch_res: as many blocks as fit on the card
// at once, at most one per tile.  rows must be BM + 2 (W + 3).
template <int BN, int BK, int BM>
int launch_up_res(const Args& a, cudaStream_t stream) {
  const size_t smem =
      up_res_smem_bytes<BN, BK>(a.rows, (a.in[0].ci + BK - 1) / BK);
  if (smem > 232448 || a.rows != BM + 2 * (a.W + 3) || a.Co > BN)
    return (int)cudaErrorInvalidValue;
  auto kernel = upconv_res_kernel<BN, BK, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const int Wp = a.W + 2, HWp = (a.H + 2) * Wp;
  const int tiles = ((a.N - 1) * HWp + a.H * Wp + a.W - (Wp + 1)) / BM + 1;
  const int x = max(1, min(tiles, sms * max(per_sm, 1)));
  kernel<<<x, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace halo

}  // namespace

// x0 (N, H, W, ci0), w0 (Co, 3, 3, ci0), and optionally x1 (N, H, W, ci1),
// w1 (Co, 3, 3, ci1) (x1 == NULL: one input), all bf16; scale, bias (Co)
// f32, both NULL for a linear conv; act != 0 applies leaky-relu(slope).
// out (N, H, W, Co) bf16.  vec != 0 requires every ci % 8 == 0 and
// 16-byte aligned pointers.  The plan: the tile (bn output channels,
// tile_m pixels at most, bk channels per chunk: one of the compiled
// tiles below); resident != 0 for the resident-weights kernel (vec
// only; its tiles are 256 padded positions and rows = 256 + 2 (W + 3));
// else bm, output pixels per block (a multiple of 16, at most tile_m),
// and rows, the staged padded positions per block, at least the span of
// any block's pixels plus 2 (W + 3) + 1.
// Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan it does not take.
extern "C" int riders_lane_conv3x3(const void* x0, const void* w0, int ci0,
                                   const void* x1, const void* w1, int ci1,
                                   const void* scale, const void* bias,
                                   void* out, int N, int H, int W, int Co,
                                   float slope, int act, int vec, int bn,
                                   int tile_m, int bk, int resident, int bm,
                                   int rows, void* stream) {
  halo::Args a;
  a.in[0] = halo::Src{static_cast<const bf16*>(x0),
                      static_cast<const bf16*>(w0), ci0};
  a.in[1] = x1 ? halo::Src{static_cast<const bf16*>(x1),
                           static_cast<const bf16*>(w1), ci1}
               : a.in[0];
  a.n_inputs = x1 ? 2 : 1;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.N = N;
  a.H = H;
  a.W = W;
  a.Co = Co;
  a.bm = bm;
  a.rows = rows;
  a.slope = slope;
  a.act = act;
  if (bm <= 0 || bm % 16 || rows <= 0 || (resident && !vec))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
#define CONV_TILE(BN, BM, BK)                                     \
  if (!resident && bn == BN && tile_m == BM && bk == BK)          \
    return halo::launch<BN, BM, BK>(a, v, s);
  CONV_TILE(8, 256, 32)
  CONV_TILE(16, 256, 32)
  CONV_TILE(32, 256, 32)
  CONV_TILE(64, 256, 16)
#undef CONV_TILE
#define RES_TILE(BN, BK)                                          \
  if (resident && bn == BN && tile_m == 256 && bk == BK)          \
    return halo::launch_res<BN, BK>(a, s);
  RES_TILE(8, 32)
  RES_TILE(16, 32)
  RES_TILE(32, 32)
  RES_TILE(64, 32)
#undef RES_TILE
  return (int)cudaErrorInvalidValue;
}

// x (N, h, w, ci) bf16; w (4F, 3, 3, ci) bf16, the phase-composed
// weights (ops/kernels/lane_decoder.py:pack_upconv); scale, bias (F) f32,
// both NULL for a linear conv; out (N, 2h, 2w, F) bf16.  vec as above.
// The plan (ops/kernels/lane_decoder.py:upconv_plan): bn columns of F per
// block and phase, tile_m and bk naming one of the compiled tiles below;
// resident != 0 for the resident-weights kernel (all four phases a block;
// vec only; its tiles are tile_m padded positions and rows = tile_m + 2
// (w + 3)); else one phase a block, bm coarse pixels per block (a
// multiple of 16, at most tile_m) and rows staged per block, as for the
// conv.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan
// it does not take.
extern "C" int riders_lane_upconv2x(const void* x, const void* w, int ci,
                                    const void* scale, const void* bias,
                                    void* out, int N, int h, int w_, int F,
                                    float slope, int act, int vec, int bn,
                                    int tile_m, int bk, int resident, int bm,
                                    int rows, void* stream) {
  halo::Args a;
  a.in[0] = halo::Src{static_cast<const bf16*>(x),
                      static_cast<const bf16*>(w), ci};
  a.in[1] = a.in[0];
  a.n_inputs = 1;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.N = N;
  a.H = h;
  a.W = w_;
  a.Co = F;
  a.bm = bm;
  a.rows = rows;
  a.slope = slope;
  a.act = act;
  if (bm <= 0 || bm % 16 || rows <= 0 || (resident && !vec))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UP_TILE(BN, BM, BK)                                                \
  if (!resident && bn == BN && tile_m == BM && bk == BK)                   \
    return halo::launch_up<BN, BM, BK>(a, vec != 0, s);
  UP_TILE(64, 256, 16)
#undef UP_TILE
#define UP_RES_TILE(BN, BM, BK)                                            \
  if (resident && bn == BN && tile_m == BM && bk == BK)                    \
    return halo::launch_up_res<BN, BK, BM>(a, s);
  UP_RES_TILE(32, 128, 32)
#undef UP_RES_TILE
  return (int)cudaErrorInvalidValue;
}
