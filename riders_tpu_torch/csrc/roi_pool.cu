// Fixed-size RoI max pool (torchvision roi_pool semantics, as the JAX
// package computes them) of K boxes per frame from one NHWC map, bf16 or
// f32, and its backward (d feature) in f32.
//
// Forward replaces: riders_tpu/ops/pallas/roi_pool.py:roi_max_pool_pallas
// (every scale of roi_pool_pyramid_pallas) and roi_max_pool_pallas_foldw
// (the stride-2 skip read from the stem's W-folded canvas).  The port's
// stem writes a plain NHWC map, so this one kernel serves every scale.
// bf16 serves inference, f32 the training forward.  Given a canvas's
// pitches apart from its true extent, it also replaces
// roi_pool.py:roi_max_pool_pallas4d (B6, with true_hw: a _NEG-padded
// canvas read in place, its padding never read); the 4D kernel's C % 128
// routing was a Mosaic DMA rule, and this kernel serves every C.
//
// Forward bound on the H100: pure data movement.  At the NTU bench shape
// (B=16, K=48) the pyramid writes ~163 MB of pooled patches and reads the
// union of the boxes' windows, ~105 MB: ~0.08 ms at 3.35 TB/s.
//
// Forward design: one block per (output row, point, frame), threads over
// the (output column, channel) pairs, so neighbouring threads read
// neighbouring channels of one pixel (coalesced) and write one
// contiguous output row.  Each thread derives its bin from the box with
// exact integer arithmetic: edges round half away from zero,
// floor(x * s + 0.5) with no fused multiply-add; roi = end - start + 1;
// the window starts at the start clamped to [0, H]; bin p spans
// [floor(p * roi / out), ceil((p + 1) * roi / out)) from there, clamped
// to the map; an empty bin writes 0.  Bins span at most a few rows and
// columns, so the max is a short loop over L2-resident windows.
//
// Backward replaces: riders_tpu/ops/pallas/roi_pool.py:_roi_pool_bwd_pallas
// (the custom VJP of roi_max_pool_pallas_diff / roi_pool_pyramid_pallas_diff).
// Rule: every bin (b, k, p, q, c) sends its cotangent to every element of
// its window that equals the bin's max (all tied elements receive it in
// full); empty bins send nothing; overlapping bins and boxes sum.
//
// Backward bound: data movement.  It writes all of d(feature) and reads
// the pooled cotangents, the saved forward and the boxes' windows: at the
// NTU training shape (B=24, K=40, f32) ~1.7 GB, ~0.5 ms at 3.35 TB/s.
//
// Backward design: a deterministic gather with no atomics.  One thread
// per feature element; a block covers a run of (column, channel) pairs of
// one row of one frame.  The block first stages, for each of the frame's
// K boxes, the range of row bins that contain its row (or none) and the
// box's column start and roi width, in shared memory.  Each thread then
// walks k in ascending order, finds the 1-3 column bins holding its
// column, and adds grad[b, k, p, q, c] wherever the feature equals the
// saved pooled value: with an f32 forward that max is exact, so equality
// is the JAX rule.  Each element's sum runs in (k, p, q) order in f64
// and is rounded to f32 once: two launches agree bitwise, and the result
// is the exact sum rounded to f32, up to f64's own rounding (an f32
// accumulator loses a few ulps of the partial sums where contributions
// cancel).  An element takes a handful of contributions at the training
// shapes, so the f64 adds cost little next to the loads.  Later work:
// one block per row tile with the
// covering boxes compacted, vectorised loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

__device__ __forceinline__ int round_edge(float v, float scale) {
  return (int)floorf(__fadd_rn(__fmul_rn(v, scale), 0.5f));
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float from_f32(float v) { return v; }

template <typename T>
__global__ void roi_max_pool_kernel(const T* __restrict__ feat,
                                    const float* __restrict__ boxes,
                                    T* __restrict__ out, int H, int W, int C,
                                    int K, int out_h, int out_w, float scale,
                                    int pitch_w, size_t pitch_b) {
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

  const T* fb = feat + (size_t)b * pitch_b;
  T* orow = out + ((((size_t)b * K + k) * out_h + p) * out_w) * C;
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
          m = fmaxf(m, to_f32(fb[((size_t)h * pitch_w + w) * C + c]));
    }
    orow[e] = from_f32<T>(m);
  }
}

// The bins [floor(i * roi / out), ceil((i + 1) * roi / out)) that hold
// offset r (0 <= r < roi) of the window form one run [lo, hi]; returns
// false when there is none.  The formula's run is checked bin by bin, so
// the result is exactly the forward's rule.
__device__ __forceinline__ bool bins_holding(int r, int roi, int out,
                                             int* lo, int* hi) {
  int a = (r * out) / roi;
  int z = min(((r + 1) * out + roi - 1) / roi - 1, out - 1);
  while (a <= z && !(r < ((a + 1) * roi + out - 1) / out)) ++a;
  while (z >= a && !((z * roi) / out <= r)) --z;
  *lo = a;
  *hi = z;
  return a <= z;
}

__global__ void roi_max_pool_bwd_kernel(const float* __restrict__ feat,
                                        const float* __restrict__ boxes,
                                        const float* __restrict__ pooled,
                                        const float* __restrict__ grad,
                                        float* __restrict__ dfeat, int H,
                                        int W, int C, int K, int out_h,
                                        int out_w, float scale) {
  extern __shared__ int smem[];
  int* s_plo = smem;          // first row bin holding this row, or -1
  int* s_phi = smem + K;      // last row bin holding this row
  int* s_sw = smem + 2 * K;   // clamped column start of the window
  int* s_roiw = smem + 3 * K; // roi width

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float* box = boxes + ((size_t)b * K + k) * 4;
    const int rs_w = round_edge(box[0], scale);
    const int rs_h = round_edge(box[1], scale);
    const int roi_w = max(round_edge(box[2], scale) - rs_w + 1, 1);
    const int roi_h = max(round_edge(box[3], scale) - rs_h + 1, 1);
    const int sh = min(max(rs_h, 0), H);
    const int r = h - sh;
    int lo = -1, hi = -1;
    if (r < 0 || r >= roi_h || !bins_holding(r, roi_h, out_h, &lo, &hi))
      lo = -1;
    s_plo[k] = lo;
    s_phi[k] = hi;
    s_sw[k] = min(max(rs_w, 0), W);
    s_roiw[k] = roi_w;
  }
  __syncthreads();

  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // (w, c) of row h
  if (e >= W * C) return;
  const int w = e / C;
  const int c = e - w * C;
  const size_t at = (((size_t)b * H + h) * W) * C + e;
  const float v = feat[at];
  double acc = 0.0;
  for (int k = 0; k < K; ++k) {
    const int plo = s_plo[k];
    if (plo < 0) continue;
    const int r = w - s_sw[k];
    int qlo, qhi;
    if (r < 0 || r >= s_roiw[k] || !bins_holding(r, s_roiw[k], out_w, &qlo,
                                                 &qhi))
      continue;
    const size_t base = ((size_t)b * K + k) * out_h;
    for (int p = plo; p <= s_phi[k]; ++p) {
      for (int q = qlo; q <= qhi; ++q) {
        const size_t i = ((base + p) * out_w + q) * C + c;
        const float g = grad[i];  // loaded with pooled[i], not after it
        if (pooled[i] == v) acc += (double)g;
      }
    }
  }
  dfeat[at] = (float)acc;
}

// pitch_w: pixels per row of the stored map; pitch_h: its rows per
// frame.  A plain map has pitch_w = W, pitch_h = H; a canvas is larger
// and only its leading H x W is read.
template <typename T>
int launch_forward(const void* feat, const void* boxes, void* out, int B,
                   int H, int W, int C, int K, int out_h, int out_w,
                   float scale, int pitch_h, int pitch_w, void* stream) {
  const int threads = min(256, ((out_w * C + 31) / 32) * 32);
  dim3 grid(out_h, K, B);
  roi_max_pool_kernel<T><<<grid, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const float*>(boxes),
      static_cast<T*>(out), H, W, C, K, out_h, out_w, scale, pitch_w,
      (size_t)pitch_h * pitch_w * C);
  return (int)cudaGetLastError();
}

}  // namespace

// feat: a (B, pitch_h, pitch_w, C) NHWC map or canvas, of which the
// leading (H, W) is pooled (pitch_h >= H, pitch_w >= W; a plain map has
// pitch_h = H, pitch_w = W), bf16, or f32 when f32 != 0; boxes: (B, K, 4)
// f32 [x1, y1, x2, y2]; out: (B, K, out_h, out_w, C) in feat's type.
// Returns cudaGetLastError().
extern "C" int riders_roi_max_pool(const void* feat, const void* boxes,
                                   void* out, int B, int H, int W, int C,
                                   int K, int out_h, int out_w, float scale,
                                   int pitch_h, int pitch_w, int f32,
                                   void* stream) {
  if (f32)
    return launch_forward<float>(feat, boxes, out, B, H, W, C, K, out_h,
                                 out_w, scale, pitch_h, pitch_w, stream);
  return launch_forward<__nv_bfloat16>(feat, boxes, out, B, H, W, C, K,
                                       out_h, out_w, scale, pitch_h,
                                       pitch_w, stream);
}

// feat: (B, H, W, C) f32; boxes: (B, K, 4) f32; pooled, grad:
// (B, K, out_h, out_w, C) f32 (the forward's output and its cotangent);
// dfeat: (B, H, W, C) f32, every element written.  K <= 2048.
extern "C" int riders_roi_max_pool_bwd_f32(
    const void* feat, const void* boxes, const void* pooled,
    const void* grad, void* dfeat, int B, int H, int W, int C, int K,
    int out_h, int out_w, float scale, void* stream) {
  const int threads = 256;
  dim3 grid((W * C + threads - 1) / threads, H, B);
  const size_t smem = 4 * sizeof(int) * (size_t)K;
  roi_max_pool_bwd_kernel<<<grid, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feat), static_cast<const float*>(boxes),
      static_cast<const float*>(pooled), static_cast<const float*>(grad),
      static_cast<float*>(dfeat), H, W, C, K, out_h, out_w, scale);
  return (int)cudaGetLastError();
}
