// The lane-major RC-Net decoder's two convolutions, on NHWC bf16 maps of
// N = B*K patches:
//
//  * riders_lane_conv3x3: SAME 3x3 conv over the channel concat of one or
//    two inputs (the concat is never written: each input has its own
//    weight slice), f32 accumulation, then acc * scale + bias (folded BN;
//    none = linear), leaky-relu(slope) or none, one rounding to bf16.
//    Replaces riders_tpu/ops/pallas/lane_decoder.py:lane_conv3x3.
//  * riders_lane_upconv2x: nearest x2 upsample + 3x3 conv + BN + leaky in
//    one pass.  The weights are the phase-composed (4F, 3, 3, Ci) kernel
//    bf16(nearest2x_phase_kernel(k)): each coarse cell computes its four
//    output phases from its 3x3 coarse window, and each phase has only
//    2x2 nonzero coarse taps, which the kernel skips.  The upsampled map is
//    never written.  Replaces lane_decoder.py:lane_upconv2x.
//
// The TPU kernels' (H, W, C, N) layout with its zero border, lane blocks,
// VMEM tiling and double-buffered DMA, and the output conv's Co padding
// to 8, served the MXU and Mosaic; none of it is kept.  Here a map is the
// port's own NHWC tensor and SAME padding is a bounds check.
//
// Bound on the H100: operations.  One NTU bench decode (N = 768) does
// ~0.5 TFLOP of products, ~0.5 ms at the bf16 tensor rate; its largest
// map, the tail's 75x25x64 phase tensor, is 184 MB, ~55 us at 3.35 TB/s.
//
// Design: an implicit GEMM on the tensor cores (WMMA 16x16x16 bf16, f32
// accumulators).  GEMM rows are output pixels (n, h, w) in NHWC order,
// columns output channels, depth taps x input channels.  A block owns 64
// pixels x BN channels (BN = 16..128 from Co), four warps of 16 pixel
// rows each.  It walks chunks of 32 channels of one tap of one input:
// the 64 shifted input rows (zero where the tap falls outside the map)
// and the BN weight rows go to shared memory with 16-byte cp.async in a
// two-stage ring, so the next chunk loads while this one multiplies.
// Channels not a multiple of 8 take a scalar load path.  The epilogue
// stages the accumulators in shared memory and writes whole channel runs
// per pixel.  Later work: stage each tile's input halo once for all nine
// taps, wgmma with TMA, fuse the decoder's nearest resizes into the loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int BM = 64;            // output pixels per block
constexpr int BK = 32;            // input channels per chunk
constexpr int LDS = BK + 8;       // shared row pitch (bf16), 16-byte rows
constexpr int THREADS = 128;      // four warps, 16 pixel rows each

template <int BN>
struct Tiles {
  union {
    struct {
      bf16 a[2][BM][LDS];
      bf16 b[2][BN][LDS];
    } in;
    float c[BM][BN + 4];
  };
};

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
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

struct Input {
  const bf16* x;    // (N, H, W, ci)
  const bf16* w;    // (Cg, 3, 3, ci): Cg = Co (conv) or 4F (upconv)
  int ci;
  int nc;           // chunks of BK channels
};

// One conv or upconv.  up == false: out (N, H, W, Cg).  up == true: the
// input is the coarse map, Cg = 4F, and GEMM column co = p * F + f goes to
// phase p = (py, px) of the (N, 2H, 2W, F) output.
template <int BN, bool VEC, bool UP>
__global__ void __launch_bounds__(THREADS)
lane_conv_kernel(Input in0, Input in1, int n_inputs,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 int M, int H, int W, int Cg, int F, float slope, int act) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char raw[sizeof(Tiles<BN>)];
  Tiles<BN>& t = *reinterpret_cast<Tiles<BN>*>(raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;

  // Taps: all nine, or the 2x2 coarse taps of one output phase when the
  // block's columns lie in one phase (upconv with F a multiple of BN).
  int py = -1, px = -1;
  if (UP) {
    const int p0 = co0 / F;
    const int p1 = (min(co0 + BN, Cg) - 1) / F;
    if (p0 == p1) {
      py = p0 >> 1;
      px = p0 & 1;
    }
  }
  const int ntaps = py >= 0 ? 4 : 9;

  // The two A slots of this thread: rows tid / 4 and 32 + tid / 4, part
  // tid % 4 (8 channels each).  Their pixels stay fixed over the chunks.
  const int part = tid & 3;
  int pix[2], ph[2], pw[2];
  bool mok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = m0 + (tid >> 2) + 32 * j;
    mok[j] = m < M;
    const int mm = mok[j] ? m : 0;
    const int hw = mm % (H * W);
    pix[j] = mm;
    ph[j] = hw / W;
    pw[j] = hw - ph[j] * W;
  }

  const int nq0 = ntaps * in0.nc;
  const int nq = nq0 + (n_inputs > 1 ? ntaps * in1.nc : 0);

  auto load = [&](int q, int stage) {
    const Input& s = q < nq0 ? in0 : in1;
    const int r = q < nq0 ? q : q - nq0;
    const int ti = r / s.nc;
    const int c0 = (r - ti * s.nc) * BK;
    const int dy = py >= 0 ? py + (ti >> 1) : ti / 3;
    const int dx = px >= 0 ? px + (ti & 1) : ti % 3;
    const int tap = dy * 3 + dx;
    const int ch = c0 + part * 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int hs = ph[j] + dy - 1, ws = pw[j] + dx - 1;
      const bool ok = mok[j] && hs >= 0 && hs < H && ws >= 0 && ws < W;
      const size_t at =
          (size_t)(pix[j] + (dy - 1) * W + (dx - 1)) * s.ci + ch;
      bf16* dst = &t.in.a[stage][(tid >> 2) + 32 * j][part * 8];
      if (VEC) {
        const bool full = ok && ch < s.ci;
        cp_async16(dst, full ? (const void*)(s.x + at) : (const void*)s.x,
                   full);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = ok && ch + e < s.ci ? s.x[at + e] : __float2bfloat16(0.f);
      }
    }
    for (int slot = tid; slot < BN * 4; slot += THREADS) {
      const int row = slot >> 2;
      const int c = c0 + (slot & 3) * 8;
      const int co = co0 + row;
      const bool ok = co < Cg;
      const size_t at = ((size_t)co * 9 + tap) * s.ci + c;
      bf16* dst = &t.in.b[stage][row][(slot & 3) * 8];
      if (VEC) {
        const bool full = ok && c < s.ci;
        cp_async16(dst, full ? (const void*)(s.w + at) : (const void*)s.w,
                   full);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = ok && c + e < s.ci ? s.w[at + e] : __float2bfloat16(0.f);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int i = 0; i < BN / 16; ++i) wmma::fill_fragment(acc[i], 0.f);

  load(0, 0);
  cp_async_commit();
  for (int q = 0; q < nq; ++q) {
    if (q + 1 < nq) load(q + 1, (q + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int st = q & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, &t.in.a[st][warp * 16][kk], LDS);
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, &t.in.b[st][i * 16][kk], LDS);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
    __syncthreads();
  }
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BN / 16; ++i)
    wmma::store_matrix_sync(&t.c[warp * 16][i * 16], acc[i], BN + 4,
                            wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < BM * BN; e += THREADS) {
    const int row = e / BN, col = e - (e / BN) * BN;
    const int m = m0 + row, co = co0 + col;
    if (m >= M || co >= Cg) continue;
    float v = t.c[row][col];
    if (scale != nullptr) v = __fadd_rn(__fmul_rn(v, scale[co]), bias[co]);
    if (act && !(v > 0.f)) v = __fmul_rn(slope, v);
    size_t at;
    if (UP) {
      const int n = m / (H * W);
      const int hw = m - n * (H * W);
      const int i = hw / W, j = hw - (hw / W) * W;
      const int p = co / F, f = co - p * F;
      at = (((size_t)n * 2 * H + 2 * i + (p >> 1)) * (2 * W) + 2 * j +
            (p & 1)) * F + f;
    } else {
      at = (size_t)m * Cg + co;
    }
    out[at] = __float2bfloat16_rn(v);
  }
}

template <int BN, bool UP>
int launch_bn(bool vec, const Input& a, const Input& b, int n_inputs,
              const float* scale, const float* bias, bf16* out, int M, int H,
              int W, int Cg, int F, float slope, int act,
              cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (Cg + BN - 1) / BN);
  if (vec)
    lane_conv_kernel<BN, true, UP><<<grid, THREADS, 0, stream>>>(
        a, b, n_inputs, scale, bias, out, M, H, W, Cg, F, slope, act);
  else
    lane_conv_kernel<BN, false, UP><<<grid, THREADS, 0, stream>>>(
        a, b, n_inputs, scale, bias, out, M, H, W, Cg, F, slope, act);
  return (int)cudaGetLastError();
}

// BN: the column tile.  For a conv the smallest of 16..128 covering Co
// (128 beyond); for an upconv the largest of 128..16 dividing F, so each
// block's columns lie in one phase (F not a multiple of 16: by 4F, all
// nine taps).
template <bool UP>
int launch(int bn, bool vec, const Input& a, const Input& b, int n_inputs,
           const float* scale, const float* bias, bf16* out, int M, int H,
           int W, int Cg, int F, float slope, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16:
      return launch_bn<16, UP>(vec, a, b, n_inputs, scale, bias, out, M, H,
                               W, Cg, F, slope, act, s);
    case 32:
      return launch_bn<32, UP>(vec, a, b, n_inputs, scale, bias, out, M, H,
                               W, Cg, F, slope, act, s);
    case 64:
      return launch_bn<64, UP>(vec, a, b, n_inputs, scale, bias, out, M, H,
                               W, Cg, F, slope, act, s);
    default:
      return launch_bn<128, UP>(vec, a, b, n_inputs, scale, bias, out, M, H,
                                W, Cg, F, slope, act, s);
  }
}

int conv_tile(int co) {
  return co <= 16 ? 16 : co <= 32 ? 32 : co <= 64 ? 64 : 128;
}

int upconv_tile(int f) {
  for (int bn = 128; bn >= 16; bn /= 2)
    if (f % bn == 0) return bn;
  return conv_tile(4 * f);
}

Input make_input(const void* x, const void* w, int ci) {
  return Input{static_cast<const bf16*>(x), static_cast<const bf16*>(w), ci,
               (ci + BK - 1) / BK};
}

}  // namespace

// x0 (N, H, W, ci0), w0 (Co, 3, 3, ci0), and optionally x1 (N, H, W, ci1),
// w1 (Co, 3, 3, ci1) (x1 == NULL: one input), all bf16; scale, bias (Co)
// f32, both NULL for a linear conv; act != 0 applies leaky-relu(slope).
// out (N, H, W, Co) bf16.  vec != 0 requires every ci % 8 == 0 and
// 16-byte aligned pointers.  Returns cudaGetLastError().
extern "C" int riders_lane_conv3x3(const void* x0, const void* w0, int ci0,
                                   const void* x1, const void* w1, int ci1,
                                   const void* scale, const void* bias,
                                   void* out, int N, int H, int W, int Co,
                                   float slope, int act, int vec,
                                   void* stream) {
  const Input a = make_input(x0, w0, ci0);
  const Input b = x1 ? make_input(x1, w1, ci1) : a;
  return launch<false>(conv_tile(Co), vec != 0, a, b, x1 ? 2 : 1,
                       static_cast<const float*>(scale),
                       static_cast<const float*>(bias),
                       static_cast<bf16*>(out), N * H * W, H, W, Co, Co,
                       slope, act, stream);
}

// x (N, h, w, ci) bf16; w (4F, 3, 3, ci) bf16, the phase-composed kernel;
// scale, bias (4F) f32 (the BN fold tiled over the four phases); out
// (N, 2h, 2w, F) bf16.  vec as above.  Returns cudaGetLastError().
extern "C" int riders_lane_upconv2x(const void* x, const void* w, int ci,
                                    const void* scale, const void* bias,
                                    void* out, int N, int h, int w_, int F,
                                    float slope, int act, int vec,
                                    void* stream) {
  const Input a = make_input(x, w, ci);
  return launch<true>(upconv_tile(F), vec != 0, a, a, 1,
                      static_cast<const float*>(scale),
                      static_cast<const float*>(bias),
                      static_cast<bf16*>(out), N * h * w_, h, w_, 4 * F, F,
                      slope, act, stream);
}
