// Fused stem, general form: a k x k stride-2 conv (any odd k, any Cin ->
// any Cout, symmetric padding (k - 1) / 2) with the BatchNorm folded into
// the weights, + bias, max(y, slope * y), bf16 out, and MaxPool2d(3, 2, 1)
// of that bf16 map, in one kernel.  The tuned kernel of csrc/stem.cu
// serves (k, Cin, Cout) = (7, 3, 32); this one serves every other shape.
//
// Replaces: riders_tpu/ops/pallas/stem.py:stem_conv_pallas (pool=True) at
// the shapes the tuned kernel lacks (a stem width other than 32, a
// one-channel image, k = 3 or 11).
//
// Bound on the H100: at the NTU bench shape (B=16, 662x690 bf16 in) with
// Cin 3 -> Cout 64, k 7 the kernel must move ~336 MB (input 44 MB, conv
// out 234 MB, pooled 58 MB), ~100 us at 3.35 TB/s, against 34 GFLOP,
// ~35 us at the bf16 tensor rate: it is bound by its bytes.  This first
// form is a simple one and does not reach that bound: its products run as
// f32 FMAs on the CUDA cores (17 G FMAs at that shape, ~0.5 ms at the
// 67 TFLOP/s f32 rate), not on the tensor cores.
//
// Design: one block per TP x TP tile of pooled outputs.
//  * It stages its input tile, (4 TP + k) rows and columns x Cin with the
//    conv's zero padding, into shared memory once, as f32, in a layout
//    split by column parity (row r, parity c & 1, column c >> 1, channel),
//    so that neighbouring conv pixels (input columns 2 apart) read
//    neighbouring words; and a table of each tap's (ky, kx, ci) offset.
//  * It walks Cout in chunks of CO channels: the chunk's folded weights
//    (packed on the host, ops/kernels/stem.py:general_weights) come into
//    shared memory, and each thread accumulates four conv pixels x eight
//    channels in f32 over the k * k * Cin taps (one offset, four inputs
//    and two 16-byte weight loads, all lanes of a warp on one weight
//    row, for 32 FMAs).  The conv tile covers the block's 2 TP x 2 TP
//    owned conv pixels plus the row and column above and to the left that
//    the 3x3/s2 pool window also reads.
//  * Epilogue: bias, max(y, slope * y), rounded to bf16 into a shared conv
//    tile (the pool's -inf outside the conv extent); then the owned conv
//    pixels and the pooled maxima of the chunk leave for device memory.
// Shapes whose smallest plan (ops/kernels/stem.py:general_plan) exceeds
// 227 KB of shared memory are refused by the wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int PPT = 4;                    // conv pixels per thread
constexpr int CG = 8;                     // output channels per thread
constexpr int SMEM_LIMIT = 232448;        // 227 KB of dynamic shared memory

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// Shared memory of a plan, byte offsets of its four regions: the chunk's
// weights (taps x co f32), the staged input (f32), the tap offsets (int)
// and the conv tile (pixels x co bf16).  Mirrored by
// ops/kernels/stem.py:general_smem_bytes.
struct Layout {
  int w, in, off, conv, total;
};

__host__ __device__ inline Layout layout(int tp, int co, int cin, int k) {
  const int ti = 4 * tp + k, halfw = (ti + 1) / 2, taps = k * k * cin;
  const int tch = 2 * tp + 1;
  Layout l;
  l.w = 0;
  l.in = l.w + align16(taps * co * 4);
  l.off = l.in + align16(ti * 2 * halfw * cin * 4);
  l.conv = l.off + align16(taps * 4);
  l.total = l.conv + align16(tch * tch * co * 2);
  return l;
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned short u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

__global__ void stem_general_kernel(
    const unsigned short* __restrict__ x, const float* __restrict__ wpk,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    __nv_bfloat16* __restrict__ pooled, int H, int W, int cin, int cout,
    int k, int tp, int co, int Ho, int Wo, int Hp, int Wp, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(tp, co, cin, k);
  float* s_w = reinterpret_cast<float*>(smem + l.w);
  float* s_in = reinterpret_cast<float*>(smem + l.in);
  int* s_off = reinterpret_cast<int*>(smem + l.off);
  __nv_bfloat16* s_conv = reinterpret_cast<__nv_bfloat16*>(smem + l.conv);

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int tch = 2 * tp + 1, npix = tch * tch;
  const int ti = 4 * tp + k, halfw = (ti + 1) / 2, pad = (k - 1) / 2;
  const int taps = k * k * cin;
  const int b = blockIdx.z;
  const int pr0 = blockIdx.y * tp, pc0 = blockIdx.x * tp;
  const int cr0 = 2 * pr0 - 1, cc0 = 2 * pc0 - 1;      // conv tile origin
  const int ir0 = 2 * cr0 - pad, ic0 = 2 * cc0 - pad;  // input tile origin

  // The input tile, zero outside the image, in the parity layout.
  const int row_elems = ti * cin;
  for (int i = tid; i < ti * row_elems; i += nthr) {
    const int r = i / row_elems, rem = i - r * row_elems;
    const int c = rem / cin, ci = rem - c * cin;
    const int gr = ir0 + r, gc = ic0 + c;
    float v = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      v = bf16_bits_to_float(
          x[(((long long)b * H + gr) * W + gc) * cin + ci]);
    s_in[((r * 2 + (c & 1)) * halfw + (c >> 1)) * cin + ci] = v;
  }
  // Tap (ky, kx, ci) of conv pixel (lr, lc) reads input row 2 lr + ky,
  // column 2 lc + kx: the pixel's base 4 lr halfw + lc, plus this offset.
  for (int t = tid; t < taps; t += nthr) {
    const int ky = t / (k * cin), rem = t - ky * k * cin;
    const int kx = rem / cin, ci = rem - kx * cin;
    s_off[t] = ((2 * ky + (kx & 1)) * halfw + (kx >> 1)) * cin + ci;
  }

  const int ng = co / CG, nslot = (npix + PPT - 1) / PPT;
  const int nchunks = (cout + co - 1) / co;
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    __syncthreads();          // the staging, or the last chunk's reads
    {
      const float4* src =
          reinterpret_cast<const float4*>(wpk + (size_t)chunk * taps * co);
      float4* dst = reinterpret_cast<float4*>(s_w);
      for (int i = tid; i < taps * co / 4; i += nthr) dst[i] = __ldg(src + i);
    }
    __syncthreads();

    // Item = (slot, channel group): pixels slot + i nslot, i < 4, and
    // channels 8 cg .. 8 cg + 7 of the chunk.
    for (int item = tid; item < nslot * ng; item += nthr) {
      const int slot = item % nslot, cg = item / nslot;
      int base[PPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int p = min(slot + i * nslot, npix - 1);
        const int lr = p / tch, lc = p - lr * tch;
        base[i] = (4 * lr * halfw + lc) * cin;
      }
      float acc[PPT][CG];
#pragma unroll
      for (int i = 0; i < PPT; ++i)
#pragma unroll
        for (int j = 0; j < CG; ++j) acc[i][j] = 0.f;
      const float* wrow = s_w + CG * cg;
#pragma unroll 4
      for (int t = 0; t < taps; ++t) {
        const int o = s_off[t];
        const float4 w0 = *reinterpret_cast<const float4*>(wrow + t * co);
        const float4 w1 =
            *reinterpret_cast<const float4*>(wrow + t * co + 4);
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const float a = s_in[base[i] + o];
          acc[i][0] = fmaf(a, w0.x, acc[i][0]);
          acc[i][1] = fmaf(a, w0.y, acc[i][1]);
          acc[i][2] = fmaf(a, w0.z, acc[i][2]);
          acc[i][3] = fmaf(a, w0.w, acc[i][3]);
          acc[i][4] = fmaf(a, w1.x, acc[i][4]);
          acc[i][5] = fmaf(a, w1.y, acc[i][5]);
          acc[i][6] = fmaf(a, w1.z, acc[i][6]);
          acc[i][7] = fmaf(a, w1.w, acc[i][7]);
        }
      }
      const float* bb = bias + chunk * co + CG * cg;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int p = slot + i * nslot;
        if (p >= npix) break;
        const int lr = p / tch, lc = p - lr * tch;
        const int gr = cr0 + lr, gc = cc0 + lc;
        const bool inside = gr >= 0 && gr < Ho && gc >= 0 && gc < Wo;
        unsigned v[CG / 2];
#pragma unroll
        for (int j = 0; j < CG; j += 2) {
          const float y0 = acc[i][j] + __ldg(bb + j);
          const float y1 = acc[i][j + 1] + __ldg(bb + j + 1);
          __nv_bfloat162 r = __floats2bfloat162_rn(fmaxf(y0, slope * y0),
                                                   fmaxf(y1, slope * y1));
          v[j / 2] = inside ? *reinterpret_cast<unsigned*>(&r)
                            : 0xff80ff80u;            // the pool's -inf
        }
        *reinterpret_cast<uint4*>(s_conv + p * co + CG * cg) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();

    // The owned conv pixels (tile rows and columns 1 .. 2 tp) and the
    // MaxPool2d(3, 2, 1) of the tile: pooled (pr0 + i, pc0 + j) reads tile
    // rows 2 i .. 2 i + 2 and columns 2 j .. 2 j + 2.
    const int c0 = chunk * co, cw = min(co, cout - c0), side = 2 * tp;
    for (int e = tid; e < side * side * cw; e += nthr) {
      const int c = e % cw, pix = e / cw;
      const int lr = 1 + pix / side, lc = 1 + pix % side;
      const int gr = cr0 + lr, gc = cc0 + lc;
      if (gr < Ho && gc < Wo)
        out[(((size_t)b * Ho + gr) * Wo + gc) * cout + c0 + c] =
            s_conv[(lr * tch + lc) * co + c];
    }
    for (int e = tid; e < tp * tp * cw; e += nthr) {
      const int c = e % cw, pix = e / cw;
      const int i = pix / tp, j = pix % tp;
      const int pr = pr0 + i, pc = pc0 + j;
      if (pr >= Hp || pc >= Wp) continue;
      float m = -INFINITY;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          m = fmaxf(m, __bfloat162float(
                           s_conv[((2 * i + dy) * tch + 2 * j + dx) * co +
                                  c]));
      pooled[(((size_t)b * Hp + pr) * Wp + pc) * cout + c0 + c] =
          __float2bfloat16_rn(m);
    }
  }
}

}  // namespace

// x: (B, H, W, cin) bf16 NHWC; w: the folded weights, f32 (chunks, k, k,
// cin, co) with Cout zero-padded to a whole number of co-channel chunks
// (ops/kernels/stem.py:general_weights); bias: f32, padded the same way;
// out: (B, ceil(H/2), ceil(W/2), cout) bf16; pooled: (B, ceil(Ho/2),
// ceil(Wo/2), cout) bf16; the plan (tp, co, threads, smem_bytes) of
// ops/kernels/stem.py:general_plan.  Returns cudaErrorInvalidValue for a
// plan that disagrees with this file's layout, else cudaGetLastError().
extern "C" int riders_stem_general(const void* x, const void* w,
                                   const void* bias, void* out, void* pooled,
                                   int B, int H, int W, int cin, int cout,
                                   int k, int tp, int co, int threads,
                                   int smem_bytes, float slope,
                                   void* stream) {
  if (k % 2 != 1 || co % CG != 0 || tp < 1 || threads < 32 ||
      threads > 1024 || threads % 32 != 0 ||
      layout(tp, co, cin, k).total != smem_bytes || smem_bytes > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        stem_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int Hp = (Ho + 1) / 2, Wp = (Wo + 1) / 2;
  if (B == 0 || Hp == 0 || Wp == 0 || cout == 0) return 0;
  dim3 grid((Wp + tp - 1) / tp, (Hp + tp - 1) / tp, B);
  stem_general_kernel<<<grid, threads, smem_bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
      static_cast<__nv_bfloat16*>(pooled), H, W, cin, cout, k, tp, co, Ho,
      Wo, Hp, Wp, slope);
  return (int)cudaGetLastError();
}
