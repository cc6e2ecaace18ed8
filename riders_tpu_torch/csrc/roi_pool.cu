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
// Backward design (B5): a deterministic gather with no atomics, tiled.
// One block of 256 threads per (frame, tile of tile_h rows x tile_w
// columns); the host's plan (ops/kernels/roi_pool.py:bwd_tiles) gives 8
// rows and ~512 thread slots, 8 x 8 pixels at C = 32 (on the H100 80GB
// HBM3 at 700 W, narrower and wider tiles ran slower).  The block first
// lists, in shared memory, the boxes whose clamped window meets the tile,
// in ascending k (a warp ballot and a prefix count over the warps), each
// with its window start and roi size.  A tile that no box meets writes
// zeros and is done: much of each map lies under no box.  Otherwise each
// thread owns 4 consecutive channels of a pixel (one float4; 1 channel
// where C % 4 != 0), walks only the listed boxes and, for each box
// holding its pixel, finds the runs of row and column bins holding it.
// Where both runs are 1-2 bins long (a roi at least the pooled size, as
// at the training shapes) it issues the loads of all their `pooled` and
// `grad` values before the compares.  It adds grad wherever the feature
// equals the saved max: with an f32 forward that max is exact, so
// equality is the JAX rule.  Each element's sum runs in (k, p, q) order
// in f64 and is rounded to f32 once: two launches agree bitwise, and the
// result is the exact sum rounded to f32, up to f64's own rounding (an
// f32 accumulator loses a few ulps of the partial sums where
// contributions cancel).

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

template <int V> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float at(const T& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ T make(const double* a) {
    return make_float4((float)a[0], (float)a[1], (float)a[2], (float)a[3]);
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ float at(const T& v, int) { return v; }
  static __device__ __forceinline__ T make(const double* a) {
    return (float)a[0];
  }
};

constexpr int BWD_THREADS = 256;

// V channels per thread (4: C % 4 == 0, else 1).  Dynamic shared memory:
// K int4 (row start, roi h, column start, roi w) and K int (box index).
template <int V>
__global__ void __launch_bounds__(BWD_THREADS)
roi_max_pool_bwd_kernel(const float* __restrict__ feat,
                        const float* __restrict__ boxes,
                        const float* __restrict__ pooled,
                        const float* __restrict__ grad,
                        float* __restrict__ dfeat, int H, int W, int C,
                        int K, int out_h, int out_w, float scale,
                        int tile_h, int tile_w) {
  using VT = typename Vec<V>::T;
  extern __shared__ int4 s_box[];
  int* s_k = reinterpret_cast<int*>(s_box + K);
  __shared__ int s_warp[BWD_THREADS / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * tile_h, c0 = blockIdx.x * tile_w;
  const int r1 = min(r0 + tile_h, H), c1 = min(c0 + tile_w, W);

  // The boxes whose clamped window [sh, sh + roi_h) x [sw, sw + roi_w)
  // (clamped to the map) meets the tile, in ascending k.
  int count = 0;
  for (int base = 0; base < K; base += BWD_THREADS) {
    const int k = base + tid;
    bool meets = false;
    int4 bx = make_int4(0, 0, 0, 0);
    if (k < K) {
      const float* box = boxes + ((size_t)b * K + k) * 4;
      const int rs_w = round_edge(box[0], scale);
      const int rs_h = round_edge(box[1], scale);
      const int roi_w = max(round_edge(box[2], scale) - rs_w + 1, 1);
      const int roi_h = max(round_edge(box[3], scale) - rs_h + 1, 1);
      const int sh = min(max(rs_h, 0), H);
      const int sw = min(max(rs_w, 0), W);
      meets = sh < r1 && min(sh + roi_h, H) > r0 && sw < c1 &&
              min(sw + roi_w, W) > c0;
      bx = make_int4(sh, roi_h, sw, roi_w);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, meets);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = count;
    for (int i = 0; i < warp; ++i) before += s_warp[i];
    if (meets) {
      const int j = before + __popc(ballot & ((1u << lane) - 1u));
      s_box[j] = bx;
      s_k[j] = k;
    }
    for (int i = 0; i < BWD_THREADS / 32; ++i) count += s_warp[i];
    __syncthreads();
  }

  const int cpp = C / V;                       // thread slots per pixel
  const int tw = c1 - c0;
  const int n = (r1 - r0) * tw * cpp;
  for (int e = tid; e < n; e += BWD_THREADS) {
    const int pix = e / cpp, g = e - pix * cpp;
    const int h = r0 + pix / tw, w = c0 + pix % tw;
    const size_t at = (((size_t)b * H + h) * W + w) * C + g * V;
    VT* dst = reinterpret_cast<VT*>(dfeat + at);
    if (count == 0) {                          // no box meets the tile
      *dst = Vec<V>::zero();
      continue;
    }
    const VT v = *reinterpret_cast<const VT*>(feat + at);
    double acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0;
    for (int j = 0; j < count; ++j) {
      const int4 bx = s_box[j];
      const int r = h - bx.x, rq = w - bx.z;
      if (r < 0 || r >= bx.y || rq < 0 || rq >= bx.w) continue;
      int plo, phi, qlo, qhi;
      if (!bins_holding(r, bx.y, out_h, &plo, &phi) ||
          !bins_holding(rq, bx.w, out_w, &qlo, &qhi))
        continue;
      const size_t base =
          (((size_t)b * K + s_k[j]) * out_h) * out_w * C + g * V;
      const int np = phi - plo + 1, nq = qhi - qlo + 1;
      if (np <= 2 && nq <= 2) {
        // every covering bin's loads in flight before the compares
        VT pv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i / 2 < np && i % 2 < nq) {
            const size_t o =
                base + ((size_t)(plo + i / 2) * out_w + qlo + i % 2) * C;
            pv[i] = __ldg(reinterpret_cast<const VT*>(pooled + o));
            gv[i] = __ldg(reinterpret_cast<const VT*>(grad + o));
          }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i / 2 < np && i % 2 < nq) {
#pragma unroll
            for (int c = 0; c < V; ++c)
              if (Vec<V>::at(pv[i], c) == Vec<V>::at(v, c))
                acc[c] += (double)Vec<V>::at(gv[i], c);
          }
      } else {
        for (int p = plo; p <= phi; ++p)
          for (int q = qlo; q <= qhi; ++q) {
            const size_t o = base + ((size_t)p * out_w + q) * C;
            const VT pq = __ldg(reinterpret_cast<const VT*>(pooled + o));
            const VT gq = __ldg(reinterpret_cast<const VT*>(grad + o));
#pragma unroll
            for (int c = 0; c < V; ++c)
              if (Vec<V>::at(pq, c) == Vec<V>::at(v, c))
                acc[c] += (double)Vec<V>::at(gq, c);
          }
      }
    }
    *dst = Vec<V>::make(acc);
  }
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
// dfeat: (B, H, W, C) f32, every element written.  The tiles: tile_h rows
// x tile_w columns.  vec4 != 0 requires C % 4 == 0 and 16-byte aligned
// pointers.  Dynamic shared memory: 20 bytes per box (K <= 2048 keeps it
// within the default 48 KB).  Returns cudaGetLastError().
extern "C" int riders_roi_max_pool_bwd_f32(
    const void* feat, const void* boxes, const void* pooled,
    const void* grad, void* dfeat, int B, int H, int W, int C, int K,
    int out_h, int out_w, float scale, int tile_h, int tile_w, int vec4,
    void* stream) {
  dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h, B);
  const size_t smem = (sizeof(int4) + sizeof(int)) * (size_t)K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(feat);
  const float* bx = static_cast<const float*>(boxes);
  const float* p = static_cast<const float*>(pooled);
  const float* g = static_cast<const float*>(grad);
  float* d = static_cast<float*>(dfeat);
  if (vec4)
    roi_max_pool_bwd_kernel<4><<<grid, BWD_THREADS, smem, s>>>(
        f, bx, p, g, d, H, W, C, K, out_h, out_w, scale, tile_h, tile_w);
  else
    roi_max_pool_bwd_kernel<1><<<grid, BWD_THREADS, smem, s>>>(
        f, bx, p, g, d, H, W, C, K, out_h, out_w, scale, tile_h, tile_w);
  return (int)cudaGetLastError();
}
