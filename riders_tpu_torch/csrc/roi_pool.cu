// Fixed-size RoI max pool (torchvision roi_pool semantics, as the JAX
// package computes them) of K boxes per frame from one NHWC bf16 map.
//
// Replaces: riders_tpu/ops/pallas/roi_pool.py:roi_max_pool_pallas (every
// scale of roi_pool_pyramid_pallas) and roi_max_pool_pallas_foldw (the
// stride-2 skip read from the stem's W-folded canvas).  The port's stem
// writes a plain NHWC map, so this one kernel serves every scale.
//
// Bound on the H100: pure data movement.  At the NTU bench shape (B=16,
// K=48) the pyramid writes ~163 MB of pooled patches and reads the union
// of the boxes' windows, ~105 MB: ~0.08 ms at 3.35 TB/s.  No arithmetic
// to speak of.
//
// Design: one block per (output row, point, frame), threads over the
// (output column, channel) pairs, so neighbouring threads read
// neighbouring channels of one pixel (coalesced) and write one
// contiguous output row.  Each thread derives its bin from the box with
// exact integer arithmetic: edges round half away from zero,
// floor(x * s + 0.5) with no fused multiply-add; roi = end - start + 1;
// the window starts at the start clamped to [0, H]; bin p spans
// [floor(p * roi / out), ceil((p + 1) * roi / out)) from there, clamped
// to the map; an empty bin writes 0.  Bins span at most a few rows and
// columns, so the max is a short loop over L2-resident windows.  Later
// work: vectorised 16-byte channel loads and one block per patch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

__device__ __forceinline__ int round_edge(float v, float scale) {
  return (int)floorf(__fadd_rn(__fmul_rn(v, scale), 0.5f));
}

__global__ void roi_max_pool_kernel(const __nv_bfloat16* __restrict__ feat,
                                    const float* __restrict__ boxes,
                                    __nv_bfloat16* __restrict__ out,
                                    int H, int W, int C, int K, int out_h,
                                    int out_w, float scale) {
  const int p = blockIdx.x;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const float* box = boxes + ((size_t)b * K + k) * 4;
  const int rs_w = round_edge(box[0], scale);
  const int rs_h = round_edge(box[1], scale);
  const int roi_w = max(round_edge(box[2], scale) - rs_w + 1, 1);
  const int roi_h = max(round_edge(box[3], scale) - rs_h + 1, 1);
  const int sh = min(max(rs_h, 0), H);
  const int sw = min(max(rs_w, 0), W);
  const int h0 = min(sh + (p * roi_h) / out_h, H);
  const int h1 = min(sh + ((p + 1) * roi_h + out_h - 1) / out_h, H);

  const __nv_bfloat16* fb = feat + (size_t)b * H * W * C;
  __nv_bfloat16* orow =
      out + ((((size_t)b * K + k) * out_h + p) * out_w) * C;
  const int n = out_w * C;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int q = e / C;
    const int c = e - q * C;
    const int w0 = min(sw + (q * roi_w) / out_w, W);
    const int w1 = min(sw + ((q + 1) * roi_w + out_w - 1) / out_w, W);
    float m = 0.f;
    if (h0 < h1 && w0 < w1) {
      m = -INFINITY;
      for (int h = h0; h < h1; ++h)
        for (int w = w0; w < w1; ++w)
          m = fmaxf(m, __bfloat162float(fb[((size_t)h * W + w) * C + c]));
    }
    orow[e] = __float2bfloat16_rn(m);
  }
}

}  // namespace

// feat: (B, H, W, C) bf16 NHWC; boxes: (B, K, 4) f32 [x1, y1, x2, y2];
// out: (B, K, out_h, out_w, C) bf16.  Returns cudaGetLastError().
extern "C" int riders_roi_max_pool(const void* feat, const void* boxes,
                                   void* out, int B, int H, int W, int C,
                                   int K, int out_h, int out_w, float scale,
                                   void* stream) {
  const int threads = min(256, ((out_w * C + 31) / 32) * 32);
  dim3 grid(out_h, K, B);
  roi_max_pool_kernel<<<grid, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(feat),
      static_cast<const float*>(boxes), static_cast<__nv_bfloat16*>(out), H,
      W, C, K, out_h, out_w, scale);
  return (int)cudaGetLastError();
}
