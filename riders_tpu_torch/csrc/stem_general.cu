// Fused stem, general form: a k x k stride-2 conv (any odd k, any Cin ->
// any Cout, top/left padding `lead`) with the BatchNorm folded into the
// weights, + bias, max(y, slope * y), optionally min(y, clip), bf16 out,
// and optionally MaxPool2d(3, 2, 1) of that bf16 map, in one kernel.  The
// tuned kernel of csrc/stem.cu serves (k, Cin, Cout) = (7, 3, 32) with
// the pool, no clip and the symmetric padding; this one serves every
// other shape and form.
//
// Replaces: riders_tpu/ops/pallas/stem.py:stem_conv_pallas in all its
// forms but the tuned one: another stem width, input channel count or
// kernel size, pool=False (the conv map alone), clip_max (relu6 is slope 0
// with a clip at 6) and lead (0 is TF-SAME).
//
// Bound on the H100: at the NTU bench shape (B=16, 662x690 bf16 in) with
// Cin 3 -> Cout 64, k 7 and the pool the kernel must move ~336 MB (input
// 44 MB, conv out 234 MB, pooled 58 MB), ~100 us at 3.35 TB/s, against
// 34 GFLOP, ~35 us at the bf16 tensor rate: it is bound by its bytes, and
// what keeps it off that bound is the shared-memory traffic of gathering
// A and the epilogue, as in csrc/stem.cu.
//
// Design: an implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulate), csrc/stem.cu's scheme generalised over Cin, Cout
// and k.
//  * M is the conv pixels of a block's tile: `tile` conv rows x 32
//    columns, or with the pool `tile` pooled rows x 16 columns, i.e.
//    2 tile + 1 conv rows x 33 columns with the row and column above and
//    to the left that the 3x3/s2 pool window also reads.  An M tile is 16
//    pixels of one conv row (two per row), plus, with the pool, tiles of
//    16 rows of the extra column.  N is Cout in n-tiles of 8: all of it
//    up to 64 channels in one block (NT n-tiles, a template parameter),
//    so the staged A serves every n-tile; wider Cout takes more blocks.
//  * K runs over (ky, kx, ci).  The input is staged as bf16 NHWC rows
//    whose input columns are CPS elements apart (CPS = Cin, or Cin + 4 for
//    a multiple of 8, so that CPS has at most two factors of 2): a conv
//    pixel's k * CPS taps of kernel row ky are consecutive elements of
//    staged row 2 lr + ky.  Each kernel row's taps are padded to GR
//    groups of 8 GEMM rows; lane t's A register of group G is one 32-bit
//    shared load at its pixel's base + 2 t + offset(G), from a table in
//    shared memory (offset, and whether the group is a row's tail, whose
//    taps past k * CPS are masked to zero, or padding).  The rows g of an
//    M tile are conv columns s g apart with s CPS = 4 x odd words, so a
//    load's 32 lanes hit 32 banks.  Padding taps of the CPS pitch read
//    staged zeros; every padding row of the weights is zero.
//  * K is streamed in chunks of `kyc` kernel rows and `cs` input channels
//    where the whole of K does not fit: the accumulators stay in
//    registers while each chunk's input and weights are staged in turn.
//    Stems of few channels take all of K in one chunk.
//  * Staging: where a chunk holds all of Cin in its own pitch, the input
//    rows come from device memory in 16-byte copies (cp.async, all in
//    flight at once) into a raw buffer that keeps each row's 16-byte
//    alignment, and are realigned by 32-bit words (csrc/stem.cu's
//    scheme); otherwise by 8-byte cp.async copies of 4 channels where
//    Cin and the slice are multiples of 4, else element by element.  The
//    weights come by cp.async too.
//  * B, the folded weights, arrive packed on the host in the order in
//    which lanes read their fragments (ops/kernels/stem.py:
//    pack_general): 16-byte loads, consecutive lanes on consecutive 16
//    bytes.
//  * Epilogue: bias, max(y, slope * y), min(y, clip) (clip = +inf without
//    one), rounded to bf16 into a shared conv tile held in M order, each
//    slot's 16-byte channel groups swizzled by its row in the M tile, so
//    the stores from the accumulators are conflict-free (the pool's -inf
//    outside the conv extent); then the owned conv pixels and, with the
//    pool, the 3x3/s2 maxima leave in 16-byte stores (2-byte stores where
//    Cout is not a multiple of 8).
// Warps run two pairs of M tiles each where K is one chunk, else one pair;
// a block has at most 9 warps, and is compiled for 2-4 blocks an SM by
// its n-tiles: eight instantiations, one for each n-tile count.
// The plan (ops/kernels/stem.py:general_plan) weighs each tile and K
// chunking by a cost model of its staging and chunks, fitted to every
// plan's time on the card (chip_smoke.py --stem-plans): two blocks an SM
// first, blocks of 8 warps first, then the least staging and chunks.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase
// 12a, NTU B=16, 662x690, the kernel alone in a CUDA graph): (Cin, Cout,
// k) = (3, 64, 7) 0.354 ms, 28% of its bound (cuDNN's conv + leaky + pool
// 2.02); (1, 32, 7) 0.146, 33%; (3, 8, 7) 0.142, 17%; (3, 16, 3) 0.111,
// 31%; (3, 32, 11) 0.381, 15%; (8, 64, 7) 0.738, 17% (cuDNN 2.56);
// (4, 32, 5) 0.198, 31%; (64, 64, 3) 1.77, 21%, slower than cuDNN's 1.37;
// pool=False at (3, 64, 7) 0.291, 29%; relu6 / lead=0 at (3, 16, 3)
// without the pool 0.095, 32%; at (3, 32, 7) 0.215 beside the tuned
// kernel's 0.150 (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int SMEM_LIMIT = 232448;        // 227 KB of dynamic shared memory
constexpr int MAX_THREADS = 288;          // 9 warps: 36 M tiles, two pairs
                                          // each

// Blocks of 288 threads an SM is compiled for: the accumulators of fewer
// n-tiles leave registers for more blocks (a warp's registers come from
// one of the SM's four 16K-register quarters).
template <int NT>
constexpr int min_blocks() { return NT <= 2 ? 4 : NT <= 4 ? 3 : 2; }

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) & ~15;
}

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline int pow2_at_least(int n) {
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : 8;
}

// The staged row pitch (bf16) of a k x k kernel over columns cps apart:
// 64 + k input columns (what a 33-column conv tile reads; the 32 columns
// of a tile without the pool read two fewer), plus the 8 gr - k cps
// elements that a pixel's last tap group reads past its window, in
// whole 16-byte chunks.
__host__ __device__ constexpr int staged_pitch(int k, int cps) {
  return ((64 + k) * cps + 8 * ((k * cps + 7) / 8) - k * cps + 7) & ~7;
}

// The geometry of a plan (tile, kyc, cs, nt) and its shared memory: the
// offset table, a chunk's weights, its staged input, then the conv tile,
// whose space also holds the raw rows while a chunk is staged.  Mirrored
// by ops/kernels/stem.py:general_geometry.
struct Layout {
  int tch, tcw;        // conv tile rows and columns (the pool's halo in)
  int nm;              // M tiles
  int tiw, tih;        // staged input columns, rows of a chunk
  int cps, sp;         // staged column pitch, row pitch (bf16)
  int gr, ng, ksc;     // groups of 8 a kernel row, groups, k-steps a chunk
  int nchunks, ncs;    // K chunks, Cin slices
  int rawc;            // 16-byte raw chunks a row (0: staged by 8 bytes
                       // or by elements)
  int warps, ppw;      // warps of a block, tile pairs a warp
  int tab, w, in, conv, total;
};

__host__ __device__ inline Layout layout(int k, int cin, int pool, int tile,
                                         int kyc, int cs, int nt) {
  Layout l;
  l.tch = pool ? 2 * tile + 1 : tile;
  l.tcw = pool ? 33 : 32;
  l.nm = 2 * l.tch + (pool ? ceil_div(l.tch, 16) : 0);
  l.tiw = 64 + k;
  l.tih = 2 * (l.tch - 1) + kyc;
  l.cps = cs % 8 == 0 ? cs + 4 : cs;
  l.gr = ceil_div(k * l.cps, 8);
  l.ng = kyc * l.gr;
  l.ksc = ceil_div(l.ng, 2);
  l.sp = staged_pitch(k, l.cps);
  l.ncs = ceil_div(cin, cs);
  l.nchunks = ceil_div(k, kyc) * l.ncs;
  l.rawc = (cs == cin && l.cps == cin) ? (7 + l.sp + 7) / 8 : 0;
  const int pairs = ceil_div(l.nm, 2);
  l.ppw = l.nchunks == 1 ? 2 : 1;
  l.warps = ceil_div(pairs, l.ppw);
  const int nq = (nt + 1) / 2, ntp = pow2_at_least(nt);
  l.tab = 0;
  l.w = l.tab + align16(2 * l.ksc * 4);
  l.in = l.w + l.ksc * nq * 32 * 16;
  l.conv = l.in + align16(l.tih * l.sp * 2);
  const int conv_bytes = l.nm * 16 * ntp * 16;
  const int raw_bytes = l.tih * l.rawc * 16;
  l.total = l.conv + (conv_bytes > raw_bytes ? conv_bytes : raw_bytes);
  return l;
}

// The conv tile pixel (lr, lc) of row g + 8 h of M tile `tile`: tiles
// 0 .. 2 tch - 1 take conv row tile / 2, columns s g + ... (32 of them,
// conv columns s CPS words apart); the rest the last column (pool only),
// rows 16 (tile - 2 tch) + 8 h + g.  False for rows past the tile.
__device__ __forceinline__ bool tile_pixel(int tile, int h, int g, int tch,
                                           int s, int* lr, int* lc) {
  if (tile < 2 * tch) {
    const int p = tile & 1;
    *lr = tile >> 1;
    *lc = s == 4 ? 4 * g + 2 * h + p
                 : s == 2 ? 2 * g + 16 * h + p : g + 8 * h + 16 * p;
    return true;
  }
  *lr = 16 * (tile - 2 * tch) + 8 * h + g;
  *lc = 32;
  return *lr < tch;
}

// The M-order slot of conv tile pixel (lr, lc): the inverse of tile_pixel.
__device__ __forceinline__ int pixel_slot(int lr, int lc, int tch, int s) {
  if (lc == 32) return (2 * tch + (lr >> 4)) * 16 + (lr & 15);
  int p, h, g;
  if (s == 4) {
    p = lc & 1; h = (lc >> 1) & 1; g = lc >> 2;
  } else if (s == 2) {
    p = lc & 1; g = (lc >> 1) & 7; h = lc >> 4;
  } else {
    g = lc & 7; h = (lc >> 3) & 1; p = lc >> 4;
  }
  return (2 * lr + p) * 16 + 8 * h + g;
}

// Slot m's 16-byte channel group n sits at group n ^ swizzle(m): the
// eight rows g of a store land on eight distinct 16-byte bank groups.
template <int NTP>
__device__ __forceinline__ int swizzle(int m) {
  constexpr int SHIFT = NTP == 8 ? 0 : NTP == 4 ? 1 : NTP == 2 ? 2 : 3;
  return ((m & 7) >> SHIFT) & (NTP - 1);
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from device to shared memory without a register round trip.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
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

__device__ __forceinline__ unsigned word_of(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

__device__ __forceinline__ float act(float y, float slope, float clip) {
  y = fmaxf(y, slope * y);
  return y > clip ? clip : y;                 // NaN stays NaN
}

// The GEMM of one K chunk into the accumulators of a pair of M tiles:
// lane (g, t)'s A rows g and g + 8 of each tile sit at `base` (its
// pixels' staged corners + 2 t); each group's offset and mask come from
// the offset table.
template <int NT>
__device__ __forceinline__ void gemm_chunk(float (&acc)[2][NT][4],
                                           const unsigned short* s_in,
                                           const uint4* s_w,
                                           const int* s_tab,
                                           const int (&base)[4], int ksc,
                                           unsigned tail_mask, int lane) {
  constexpr int NQ = (NT + 1) / 2;
  const int2* tab2 = reinterpret_cast<const int2*>(s_tab);
#pragma unroll 2
  for (int st = 0; st < ksc; ++st) {
    const int2 e = tab2[st];
    uint4 bq[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) bq[q] = s_w[(st * NQ + q) * 32 + lane];
    const int ek[2] = {e.x, e.y};
    unsigned m[2];
    int o[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kind = ek[hh] & 3;
      m[hh] = kind == 0 ? 0xffffffffu : kind == 1 ? tail_mask : 0u;
      o[hh] = ek[hh] >> 2;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      unsigned a[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        a[2 * hh] = m[hh] & *reinterpret_cast<const unsigned*>(
                                s_in + base[2 * i] + o[hh]);
        a[2 * hh + 1] = m[hh] & *reinterpret_cast<const unsigned*>(
                                    s_in + base[2 * i + 1] + o[hh]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma_bf16(acc[i][n], a, word_of(bq[n >> 1], 2 * (n & 1)),
                 word_of(bq[n >> 1], 2 * (n & 1) + 1));
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(MAX_THREADS, min_blocks<NT>())
stem_general_kernel(const unsigned short* __restrict__ x,
                    const uint4* __restrict__ wpk,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out,
                    __nv_bfloat16* __restrict__ pooled, int H, int W,
                    int cin, int cout, int k, int lead, int pool, int tile,
                    int kyc, int cs, int nco, int Ho, int Wo, int Hp,
                    int Wp, float slope, float clip) {
  constexpr int NQ = (NT + 1) / 2;            // 16-byte B words a k-step
  constexpr int NTP = NT <= 1 ? 1 : NT <= 2 ? 2 : NT <= 4 ? 4 : 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(k, cin, pool, tile, kyc, cs, NT);
  int* s_tab = reinterpret_cast<int*>(smem + l.tab);
  const uint4* s_w = reinterpret_cast<const uint4*>(smem + l.w);
  unsigned short* s_in = reinterpret_cast<unsigned short*>(smem + l.in);
  unsigned char* s_conv = smem + l.conv;      // also the raw rows

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z / nco, cchunk = blockIdx.z - b * nco;
  const int co0 = cchunk * 8 * NT;
  int cr0, cc0, pr0 = 0, pc0 = 0;             // conv tile origin
  if (pool) {
    pr0 = blockIdx.y * tile;
    pc0 = blockIdx.x * 16;
    cr0 = 2 * pr0 - 1;
    cc0 = 2 * pc0 - 1;
  } else {
    cr0 = blockIdx.y * tile;
    cc0 = blockIdx.x * 32;
  }
  const int ir0 = 2 * cr0 - lead, ic0 = 2 * cc0 - lead;  // input origin
  const int cps = l.cps, sp = l.sp, tch = l.tch;
  const int s = 4 >> (cps & 1 ? 0 : cps & 2 ? 1 : 2);   // column stride

  // The offset table: group G of a chunk is kernel row G / gr (staged
  // row offset), taps 8 (G % gr) .. + 7; kind 1 marks a row's tail, 2 a
  // padding group of an odd count.
  const int row_taps = k * cps;
  for (int G = tid; G < 2 * l.ksc; G += nthr) {
    int e = 2;
    if (G < l.ng) {
      const int kyl = G / l.gr, gi = G - kyl * l.gr;
      const bool tail = gi == l.gr - 1 && row_taps % 8 != 0;
      e = (kyl * sp + 8 * gi) * 4 + (tail ? 1 : 0);
    }
    s_tab[G] = e;
  }
  const int g = lane >> 2, t = lane & 3;
  const int valid = row_taps - 8 * (l.gr - 1);  // taps of a tail group
  const unsigned tail_mask = (2 * t < valid ? 0xffffu : 0u) |
                             (2 * t + 1 < valid ? 0xffff0000u : 0u);

  const long long row_len = (long long)W * cin;
  const uint4* w_block = wpk + (size_t)cchunk * l.nchunks * l.ksc * NQ * 32;

  for (int pp = 0; pp < l.ppw; ++pp) {
    // this warp's pair: M tiles 2 P and 2 P + 1 (conv row P, both
    // parities, or the last column's tiles)
    const int P = warp + l.warps * pp;
    int base[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int lr, lc;
      const int tl = min(2 * P + (i >> 1), l.nm - 1);
      tile_pixel(tl, i & 1, g, tch, s, &lr, &lc);
      base[i] = 2 * min(lr, tch - 1) * sp + 2 * lc * cps + 2 * t;
    }
    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;

    for (int c = 0; c < l.nchunks; ++c) {
      if (pp == 0 || l.nchunks > 1) {
        __syncthreads();        // the table, or the last chunk's reads
        const int kc = c / l.ncs, csi = c - kc * l.ncs;
        const int ry0 = ir0 + kc * kyc;        // staged row 0's image row
        {
          const uint4* src = w_block + (size_t)c * l.ksc * NQ * 32;
          uint4* dst = reinterpret_cast<uint4*>(smem + l.w);
          for (int i = tid; i < l.ksc * NQ * 32; i += nthr)
            cp_async16(dst + i, src + i);
        }
        if (l.rawc) {
          // raw chunk i: row r = i / rawc from the 16-byte boundary at or
          // before its element ic0 * cin; zero outside the image
          uint4* s_raw = reinterpret_cast<uint4*>(s_conv);
          for (int i = tid; i < l.tih * l.rawc; i += nthr) {
            const int r = i / l.rawc, ch = i - r * l.rawc;
            const int gr = ry0 + r;
            const long long lo = ((long long)b * H + gr) * row_len;
            const long long e0 = ((lo + (long long)ic0 * cin) & ~7LL) +
                                 8LL * ch;
            const bool row_ok = gr >= 0 && gr < H;
            if (row_ok && e0 >= lo && e0 + 8 <= lo + row_len) {
              cp_async16(s_raw + i, x + e0);
            } else {             // the chunk crosses the image's edge
              unsigned w4[4];
#pragma unroll
              for (int e = 0; e < 8; e += 2) {
                const long long g0 = e0 + e, g1 = g0 + 1;
                const bool in0 = row_ok && g0 >= lo && g0 < lo + row_len;
                const bool in1 = row_ok && g1 >= lo && g1 < lo + row_len;
                w4[e / 2] = (in0 ? x[g0] : 0u) | ((in1 ? x[g1] : 0u) << 16);
              }
              s_raw[i] = make_uint4(w4[0], w4[1], w4[2], w4[3]);
            }
          }
          cp_async_wait_all();
          __syncthreads();
          // realign: staged word w of row r is raw elements a + 2 w and
          // a + 2 w + 1 of that row, a = the row's misalignment
          const unsigned* raw = reinterpret_cast<const unsigned*>(s_conv);
          unsigned* in32 = reinterpret_cast<unsigned*>(s_in);
          const int words = sp / 2;
          for (int r = warp; r < l.tih; r += nthr >> 5) {
            const int a = (int)((((long long)b * H + ry0 + r) * row_len +
                                 (long long)ic0 * cin) & 7LL);
            const unsigned* rr = raw + r * l.rawc * 4 + (a >> 1);
            for (int w = lane; w < words; w += 32)
              in32[r * words + w] =
                  (a & 1) ? __byte_perm(rr[w], rr[w + 1], 0x5432) : rr[w];
          }
        } else if (cin % 4 == 0 && cs % 4 == 0) {
          // by 8 bytes: staged word pair u of row r is channels
          // csi cs + 4 j .. + 3 (j = u % (cps / 4)) of image pixel
          // (ry0 + r, ic0 + u / (cps / 4)), zero where that lies outside
          // the image, the slice or Cin
          const int c0 = csi * cs, q4 = cps / 4, upr = sp / 4;
          uint2* dst = reinterpret_cast<uint2*>(s_in);
          for (int i = tid; i < l.tih * upr; i += nthr) {
            const int r = i / upr, u = i - r * upr;
            const int col = u / q4, j = u - col * q4;
            const int gr = ry0 + r, gc = ic0 + col, ci = c0 + 4 * j;
            if (gr >= 0 && gr < H && col < l.tiw && gc >= 0 && gc < W &&
                4 * j < cs && ci < cin)
              cp_async8(dst + i,
                        x + (((long long)b * H + gr) * W + gc) * cin + ci);
            else
              dst[i] = make_uint2(0u, 0u);
          }
          cp_async_wait_all();                 // the rows and weights
        } else {
          // element by element: staged (r, col * cps + cc) is channel
          // csi cs + cc of image pixel (ry0 + r, ic0 + col), zero where
          // that lies outside the image, the slice or Cin
          const int c0 = csi * cs;
          for (int i = tid; i < l.tih * sp; i += nthr) {
            const int r = i / sp, e = i - r * sp;
            const int col = e / cps, cc = e - col * cps;
            const int gr = ry0 + r, gc = ic0 + col, ci = c0 + cc;
            unsigned short v = 0;
            if (gr >= 0 && gr < H && col < l.tiw && gc >= 0 && gc < W &&
                cc < cs && ci < cin)
              v = x[(((long long)b * H + gr) * W + gc) * cin + ci];
            s_in[i] = v;
          }
          cp_async_wait_all();                 // the weights
        }
        __syncthreads();
      }

      gemm_chunk<NT>(acc, s_in, s_w, s_tab, base, l.ksc, tail_mask,
                      lane);
    }

    // Epilogue of the pair: rows g (c0, c1) and g + 8 (c2, c3) of each
    // tile, channels 8 n + 2 t and + 1, into the conv tile.  The raw rows
    // that share its space were last read before the staging barrier.
    float2 bb[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      bb[n] = __ldg(reinterpret_cast<const float2*>(bias + co0 + 8 * n +
                                                    2 * t));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tl = 2 * P + i;
      if (tl >= l.nm) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int lr, lc;
        if (!tile_pixel(tl, h, g, tch, s, &lr, &lc)) continue;
        const int gr = cr0 + lr, gc = cc0 + lc;
        const bool inside = gr >= 0 && gr < Ho && gc >= 0 && gc < Wo;
        const int m = tl * 16 + 8 * h + g, sw = swizzle<NTP>(m);
        unsigned char* px = s_conv + (size_t)m * NTP * 16 + 4 * t;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          unsigned v = 0xff80ff80u;                    // the pool's -inf
          if (inside) {
            __nv_bfloat162 r = __floats2bfloat162_rn(
                act(acc[i][n][2 * h] + bb[n].x, slope, clip),
                act(acc[i][n][2 * h + 1] + bb[n].y, slope, clip));
            v = *reinterpret_cast<unsigned*>(&r);
          }
          *reinterpret_cast<unsigned*>(px + 16 * (n ^ sw)) = v;
        }
      }
    }
  }
  __syncthreads();

  // The owned conv pixels: with the pool tile rows 1 .. 2 tile and
  // columns 1 .. 32, else all of the tile; then the MaxPool2d(3, 2, 1):
  // pooled (pr0 + i, pc0 + j) reads tile rows 2 i .. 2 i + 2 and columns
  // 2 j .. 2 j + 2.
  const int cw = min(8 * NT, cout - co0);
  const int rows = pool ? 2 * tile : tile, d = pool ? 1 : 0;
  if (cout % 8 == 0) {
    const int nq = cw / 8;
    for (int i = tid; i < rows * 32 * NT; i += nthr) {
      const int q = i % NT, pix = i / NT;
      if (q >= nq) continue;
      const int lr = d + (pix >> 5), lc = d + (pix & 31);
      const int gr = cr0 + lr, gc = cc0 + lc;
      if (gr >= Ho || gc >= Wo) continue;
      const int m = pixel_slot(lr, lc, tch, s);
      *reinterpret_cast<uint4*>(out + (((size_t)b * Ho + gr) * Wo + gc) *
                                          cout + co0 + 8 * q) =
          *reinterpret_cast<const uint4*>(
              s_conv + ((size_t)m * NTP + (q ^ swizzle<NTP>(m))) * 16);
    }
    if (!pool) return;
    for (int i = tid; i < tile * 16 * NT; i += nthr) {
      const int q = i % NT, pix = i / NT;
      if (q >= nq) continue;
      const int pi = pix >> 4, pj = pix & 15;
      const int pr = pr0 + pi, pc = pc0 + pj;
      if (pr >= Hp || pc >= Wp) continue;
      uint4 mx = make_uint4(0xff80ff80u, 0xff80ff80u, 0xff80ff80u,
                            0xff80ff80u);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int m = pixel_slot(2 * pi + dy, 2 * pj + dx, tch, s);
          mx = bmax8(mx, *reinterpret_cast<const uint4*>(
                             s_conv + ((size_t)m * NTP +
                                       (q ^ swizzle<NTP>(m))) * 16));
        }
      *reinterpret_cast<uint4*>(pooled + (((size_t)b * Hp + pr) * Wp + pc) *
                                             cout + co0 + 8 * q) = mx;
    }
  } else {
    const __nv_bfloat16* conv = reinterpret_cast<const __nv_bfloat16*>(
        s_conv);
    for (int i = tid; i < rows * 32 * cw; i += nthr) {
      const int c = i % cw, pix = i / cw;
      const int lr = d + (pix >> 5), lc = d + (pix & 31);
      const int gr = cr0 + lr, gc = cc0 + lc;
      if (gr >= Ho || gc >= Wo) continue;
      const int m = pixel_slot(lr, lc, tch, s);
      out[(((size_t)b * Ho + gr) * Wo + gc) * cout + co0 + c] =
          conv[((size_t)m * NTP + ((c >> 3) ^ swizzle<NTP>(m))) * 8 +
               (c & 7)];
    }
    if (!pool) return;
    for (int i = tid; i < tile * 16 * cw; i += nthr) {
      const int c = i % cw, pix = i / cw;
      const int pi = pix >> 4, pj = pix & 15;
      const int pr = pr0 + pi, pc = pc0 + pj;
      if (pr >= Hp || pc >= Wp) continue;
      float mx = -INFINITY;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int m = pixel_slot(2 * pi + dy, 2 * pj + dx, tch, s);
          mx = fmaxf(mx, __bfloat162float(
                             conv[((size_t)m * NTP +
                                   ((c >> 3) ^ swizzle<NTP>(m))) * 8 +
                                  (c & 7)]));
        }
      pooled[(((size_t)b * Hp + pr) * Wp + pc) * cout + co0 + c] =
          __float2bfloat16_rn(mx);
    }
  }
}

template <int NT>
int launch(const void* x, const void* w, const void* bias, void* out,
           void* pooled, int B, int H, int W, int cin, int cout, int k,
           int lead, int pool, int tile, int kyc, int cs, int threads,
           int smem_bytes, float slope, float clip, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        stem_general_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int Hp = (Ho + 1) / 2, Wp = (Wo + 1) / 2;
  const int nco = ceil_div(cout, 8 * NT);
  const dim3 grid(pool ? ceil_div(Wp, 16) : ceil_div(Wo, 32),
                  pool ? ceil_div(Hp, tile) : ceil_div(Ho, tile), B * nco);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidValue;
  stem_general_kernel<NT><<<grid, threads, smem_bytes, stream>>>(
      static_cast<const unsigned short*>(x), static_cast<const uint4*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
      static_cast<__nv_bfloat16*>(pooled), H, W, cin, cout, k, lead, pool,
      tile, kyc, cs, nco, Ho, Wo, Hp, Wp, slope, clip);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, cin) bf16 NHWC, 16-byte aligned; w: the folded weights
// packed by ops/kernels/stem.py:pack_general for this plan; bias: f32,
// zero-padded to whole blocks of 8 nt channels; out: (B, ceil(H/2),
// ceil(W/2), cout) bf16; pooled (with pool): (B, ceil(Ho/2), ceil(Wo/2),
// cout) bf16; lead: the top/left padding; the plan (tile, kyc, cs, nt,
// threads, smem_bytes) of ops/kernels/stem.py:general_plan; slope, clip:
// the activation min(max(y, slope y), clip).  Returns
// cudaErrorInvalidValue for a plan that disagrees with this file's
// layout, else cudaGetLastError().
extern "C" int riders_stem_general(const void* x, const void* w,
                                   const void* bias, void* out, void* pooled,
                                   int B, int H, int W, int cin, int cout,
                                   int k, int lead, int pool, int tile,
                                   int kyc, int cs, int nt, int threads,
                                   int smem_bytes, float slope, float clip,
                                   void* stream) {
  if (k % 2 != 1 || k < 1 || lead < 0 || lead >= k || cin < 1 ||
      cout < 1 || nt != min(8, ceil_div(cout, 8)) || tile < 1 ||
      kyc < 1 || kyc > k || cs < 1 || cs > cin)
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(k, cin, pool, tile, kyc, cs, nt);
  if (l.total != smem_bytes || smem_bytes > SMEM_LIMIT ||
      threads != 32 * l.warps || threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  if (B == 0 || Ho == 0 || Wo == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RIDERS_STEM_GENERAL_CASE(N)                                      \
  case N:                                                                \
    return launch<N>(x, w, bias, out, pooled, B, H, W, cin, cout, k,     \
                     lead, pool, tile, kyc, cs, threads, smem_bytes, slope, \
                     clip, st);
  switch (nt) {
    RIDERS_STEM_GENERAL_CASE(1)
    RIDERS_STEM_GENERAL_CASE(2)
    RIDERS_STEM_GENERAL_CASE(3)
    RIDERS_STEM_GENERAL_CASE(4)
    RIDERS_STEM_GENERAL_CASE(5)
    RIDERS_STEM_GENERAL_CASE(6)
    RIDERS_STEM_GENERAL_CASE(7)
    RIDERS_STEM_GENERAL_CASE(8)
  }
#undef RIDERS_STEM_GENERAL_CASE
  return (int)cudaErrorInvalidValue;
}
