// Fused RC-Net stem: 7x7 stride-2 conv (Cin 3 -> Cout 32) with the
// BatchNorm folded into the weights, + bias, leaky-relu, bf16 out, and
// MaxPool2d(3, 2, 1) of that output, in one kernel.
//
// Replaces: riders_tpu/ops/pallas/stem.py:stem_conv_pallas (pool=True),
// the Pallas im2col-matmul stem of the JAX package.
//
// Bound on the H100: at the NTU bench shape (B=16, 662x690x3 in) the
// kernel must move ~190 MB (input 44 MB, conv out 117 MB, pooled 29 MB),
// ~57 us at 3.35 TB/s, and do 17.2 GFLOP, ~17 us at the bf16 tensor rate.
// It is memory-bound in principle.  This first version computes on the
// CUDA cores in f32 (~0.26 ms at the f32 FMA peak), so it is bounded by
// its FMAs, not by the bytes.
//
// Design: one block owns an 8x8 tile of pooled outputs, i.e. a 16x16
// tile of conv outputs, and recomputes the one conv row/column above and
// to the left that the 3x3/s2 pool window also reads (13% extra FMAs), so
// no conv value ever leaves the block before it is pooled and the conv
// output is written exactly once.  The 39x39x3 input tile (with the
// conv's zero padding) and the 7x7x3x32 weights sit in shared memory as
// f32; every thread computes one conv pixel's 32 channels, reading each
// input value once and the weights as warp-wide broadcasts.  Weights
// arrive pre-multiplied by the BN scale in f32 and rounded to bf16, as
// the TPU kernel does, so bf16 x bf16 products are exact in f32.  Later
// work: move the 147-deep contraction onto the tensor cores (wgmma).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int KS = 7;                    // kernel size
constexpr int PAD = 3;                   // symmetric SAME padding
constexpr int CIN = 3;
constexpr int COUT = 32;
constexpr int TP = 8;                    // pooled tile edge
constexpr int TC = 2 * TP + 1;           // conv tile edge incl. halo: 17
constexpr int TI = 2 * (TC - 1) + KS;    // input tile edge: 39
constexpr int THREADS = 320;             // >= TC * TC = 289
constexpr float SLOPE = 0.2f;            // leaky-relu negative slope
constexpr int W_ELEMS = KS * KS * CIN * COUT;
constexpr int IN_ELEMS = TI * TI * CIN;
// padded to 4 floats so the bf16 conv tile after it is 16-byte aligned
constexpr int IN_PAD = (IN_ELEMS + 3) / 4 * 4;
constexpr int CONV_ELEMS = TC * TC * COUT;
constexpr size_t SMEM_BYTES = (W_ELEMS + IN_PAD + COUT) * sizeof(float)
                              + CONV_ELEMS * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(THREADS)
stem_conv_pool_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out,
                      __nv_bfloat16* __restrict__ pooled,
                      int H, int W, int Ho, int Wo, int Hp, int Wp) {
  extern __shared__ float smem[];
  float* w_s = smem;                                  // [ky][kx][ci][co]
  float* in_s = w_s + W_ELEMS;                        // [r][c][ci]
  float* b_s = in_s + IN_PAD;                         // [co]
  __nv_bfloat16* conv_s =
      reinterpret_cast<__nv_bfloat16*>(b_s + COUT);   // [r][c][co]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int pr0 = blockIdx.y * TP;                    // pooled tile origin
  const int pc0 = blockIdx.x * TP;
  const int cr0 = 2 * pr0 - 1;                        // conv tile origin
  const int cc0 = 2 * pc0 - 1;
  const int ir0 = 2 * cr0 - PAD;                      // input tile origin
  const int ic0 = 2 * cc0 - PAD;

  for (int i = tid; i < W_ELEMS; i += THREADS)
    w_s[i] = __bfloat162float(w[i]);
  if (tid < COUT) b_s[tid] = bias[tid];
  const __nv_bfloat16* xb = x + (size_t)b * H * W * CIN;
  for (int i = tid; i < IN_ELEMS; i += THREADS) {
    const int r = i / (TI * CIN);
    const int rem = i - r * (TI * CIN);
    const int gr = ir0 + r;
    const int gc = ic0 + rem / CIN;
    float v = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      v = __bfloat162float(xb[((size_t)gr * W + gc) * CIN + rem % CIN]);
    in_s[i] = v;
  }
  __syncthreads();

  if (tid < TC * TC) {
    const int lr = tid / TC;
    const int lc = tid - lr * TC;
    const int gr = cr0 + lr;
    const int gc = cc0 + lc;
    __nv_bfloat16* cs = conv_s + tid * COUT;
    if (gr < 0 || gr >= Ho || gc < 0 || gc >= Wo) {
      // outside the conv extent: the pool's -inf padding
      for (int co = 0; co < COUT; ++co)
        cs[co] = __float2bfloat16_rn(-INFINITY);
    } else {
      float acc[COUT];
#pragma unroll
      for (int co = 0; co < COUT; ++co) acc[co] = 0.f;
      for (int ky = 0; ky < KS; ++ky) {
        const float* row = in_s + ((2 * lr + ky) * TI + 2 * lc) * CIN;
#pragma unroll
        for (int kx = 0; kx < KS; ++kx) {
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci) {
            const float v = row[kx * CIN + ci];
            const float4* wv = reinterpret_cast<const float4*>(
                w_s + ((ky * KS + kx) * CIN + ci) * COUT);
#pragma unroll
            for (int q = 0; q < COUT / 4; ++q) {
              const float4 ww = wv[q];
              acc[4 * q + 0] += v * ww.x;
              acc[4 * q + 1] += v * ww.y;
              acc[4 * q + 2] += v * ww.z;
              acc[4 * q + 3] += v * ww.w;
            }
          }
        }
      }
      __align__(16) __nv_bfloat16 res[COUT];
#pragma unroll
      for (int co = 0; co < COUT; ++co) {
        const float y = acc[co] + b_s[co];
        res[co] = __float2bfloat16_rn(fmaxf(y, SLOPE * y));
      }
      const uint4* rv = reinterpret_cast<const uint4*>(res);
      uint4* cv = reinterpret_cast<uint4*>(cs);
#pragma unroll
      for (int q = 0; q < COUT / 8; ++q) cv[q] = rv[q];
      if (lr >= 1 && lc >= 1) {   // owned by this block: write it out
        uint4* ov = reinterpret_cast<uint4*>(
            out + (((size_t)b * Ho + gr) * Wo + gc) * COUT);
#pragma unroll
        for (int q = 0; q < COUT / 8; ++q) ov[q] = rv[q];
      }
    }
  }
  __syncthreads();

  // MaxPool2d(3, 2, 1): pooled (pr0 + i, pc0 + j) reads conv tile rows
  // 2i..2i+2 and cols 2j..2j+2 (tile row 0 is conv row 2*pr0 - 1).
  for (int e = tid; e < TP * TP * COUT; e += THREADS) {
    const int co = e % COUT;
    const int pix = e / COUT;
    const int i = pix / TP;
    const int j = pix - i * TP;
    const int pr = pr0 + i;
    const int pc = pc0 + j;
    if (pr >= Hp || pc >= Wp) continue;
    float m = -INFINITY;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        m = fmaxf(m, __bfloat162float(
                         conv_s[((2 * i + dy) * TC + 2 * j + dx) * COUT + co]));
    pooled[(((size_t)b * Hp + pr) * Wp + pc) * COUT + co] =
        __float2bfloat16_rn(m);
  }
}

}  // namespace

// x: (B, H, W, 3) bf16 NHWC; w: (7, 7, 3, 32) bf16 folded weights;
// bias: (32,) f32; out: (B, ceil(H/2), ceil(W/2), 32) bf16;
// pooled: (B, ceil(Ho/2), ceil(Wo/2), 32) bf16.  Returns cudaGetLastError().
extern "C" int riders_stem_conv_pool(const void* x, const void* w,
                                     const void* bias, void* out,
                                     void* pooled, int B, int H, int W,
                                     void* stream) {
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
  dim3 grid((Wp + TP - 1) / TP, (Hp + TP - 1) / TP, B);
  stem_conv_pool_kernel<<<grid, THREADS, SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(pooled),
      H, W, Ho, Wo, Hp, Wp);
  return (int)cudaGetLastError();
}
