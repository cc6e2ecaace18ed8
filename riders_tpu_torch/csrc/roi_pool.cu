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
// Forward rule, in exact integer arithmetic: edges round half away from
// zero, floor(x * s + 0.5) with no fused multiply-add; roi = end - start
// + 1, at least 1; the window starts at the start clamped to [0, H]; bin
// p spans [floor(p * roi / out), ceil((p + 1) * roi / out)) from there,
// clamped to the map; an empty bin writes 0; the max has fmaxf's
// semantics.
//
// Forward design: one launch pools up to five maps (a whole pyramid),
// each described by a row of a table in the kernel's parameters (map and
// output pointers, extent, pitches, channels, output size, scale, and
// the host's work split, ops/kernels/roi_pool.py:fwd_plan).  The grid
// enumerates (scale, frame, box, strip of output rows), so the small
// scales ride in the same launch as skip1.  A block decodes the box
// once and puts the strip's row bins and each thread slot's column bin
// and channel offset in shared memory; the threads then run only max
// loops, with no integer division.  A thread slot is 8 bf16 or 4 f32
// channels of one output pixel, read and written as 16-byte vectors
// (where C allows; 1 channel otherwise), so a warp reads a run of
// neighbouring pixels' channels and writes a contiguous run of one
// output row.  Bins of at most 2 x 2 elements (nearly all, at the
// pyramid's shapes) issue their four loads before the compares.
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

constexpr int FWD_THREADS = 256;
constexpr int FWD_MAX_SCALES = 5;
constexpr int FWD_DIMS = 10;        // ints per scale in the host's table
constexpr int FWD_MAX_ROWS = 2048;  // output rows of one strip
constexpr int FWD_MAX_SLOTS = 2048; // thread slots of one output row held
                                    // in shared memory at a time

struct FwdScale {
  const void* feat;
  void* out;
  long long pitch_b;                // elements per frame of the stored map
  int H, W, C, pitch_w, out_h, out_w;
  int vec;                          // channels per thread slot
  int strip_rows, strips, block0;   // the host's work split
  float scale;
};

struct FwdPyramid {
  FwdScale s[FWD_MAX_SCALES];
  const float* boxes;
  int n, K;
};

// VEC channels of one pixel as one value: 8 bf16 as a uint4, 4 f32 as a
// float4, or one channel as a float.
template <typename T, int VEC> struct Lanes;
template <> struct Lanes<__nv_bfloat16, 8> {
  using V = uint4;
  static __device__ __forceinline__ V load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ unsigned max2(unsigned a, unsigned b) {
    __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
    __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
    __nv_bfloat162 m = __hmax2(x, y);
    return *reinterpret_cast<unsigned*>(&m);
  }
  static __device__ __forceinline__ V max(V a, V b) {
    return make_uint4(max2(a.x, b.x), max2(a.y, b.y), max2(a.z, b.z),
                      max2(a.w, b.w));
  }
  static __device__ __forceinline__ V zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ V neg_inf() {
    const unsigned n = 0xff80ff80u;              // two bf16 -inf
    return make_uint4(n, n, n, n);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, V v) {
    *reinterpret_cast<uint4*>(p) = v;
  }
};
template <> struct Lanes<float, 4> {
  using V = float4;
  static __device__ __forceinline__ V load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ V max(V a, V b) {
    return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                       fmaxf(a.w, b.w));
  }
  static __device__ __forceinline__ V zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ V neg_inf() {
    return make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  }
  static __device__ __forceinline__ void store(float* p, V v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};
template <typename T> struct Lanes<T, 1> {
  using V = float;
  static __device__ __forceinline__ V load(const T* p) {
    return to_f32(p[0]);
  }
  static __device__ __forceinline__ V max(V a, V b) { return fmaxf(a, b); }
  static __device__ __forceinline__ V zero() { return 0.f; }
  static __device__ __forceinline__ V neg_inf() { return -INFINITY; }
  static __device__ __forceinline__ void store(T* p, V v) {
    p[0] = from_f32<T>(v);
  }
};

// The max of every (row, slot) element of rows [0, rows) x slots
// [0, n_slots) of the strip.  s_row[p]: the row bin [h0, h1) of strip row
// p as h0 | h1 << 16; s_col[j]: slot j's column bin [w0, w1) as
// w0 | w1 << 16, and its channel offset.  `fb` is the frame's map, `ob`
// the output at the strip's first row and the chunk's first slot.
template <typename T, int VEC>
__device__ __forceinline__ void pool_strip(const T* __restrict__ fb,
                                           T* __restrict__ ob, int pitch_w,
                                           int C, int rows, int row_elems,
                                           int n_slots, const int* s_row,
                                           const int2* s_col) {
  using L = Lanes<T, VEC>;
  // (p, j) walks the elements tid, tid + FWD_THREADS, ... in row-major
  // order without a division per step
  int p = threadIdx.x / n_slots;
  int j = threadIdx.x - p * n_slots;
  const int dp = FWD_THREADS / n_slots;
  const int dj = FWD_THREADS - dp * n_slots;
  const size_t pix = (size_t)pitch_w * C;
  while (p < rows) {
    const int hr = s_row[p];
    const int2 cs = s_col[j];
    const int h0 = hr & 0xffff, h1 = hr >> 16;
    const int w0 = cs.x & 0xffff, w1 = cs.x >> 16;
    typename L::V m;
    if (h0 >= h1 || w0 >= w1) {
      m = L::zero();
    } else {
      const T* r0 = fb + h0 * pix + (size_t)w0 * C + cs.y;
      if (h1 - h0 <= 2 && w1 - w0 <= 2) {
        // a 1-2 x 1-2 bin: four loads in flight (repeats of one element
        // where the bin is one row or column wide), then the compares
        const T* r1 = h1 - h0 == 2 ? r0 + pix : r0;
        const int dw = w1 - w0 == 2 ? C : 0;
        const typename L::V a = L::load(r0), b = L::load(r0 + dw),
                            c = L::load(r1), d = L::load(r1 + dw);
        m = L::max(L::max(L::neg_inf(), L::max(a, b)), L::max(c, d));
      } else {
        m = L::neg_inf();
        for (int h = h0; h < h1; ++h, r0 += pix)
          for (int w = 0; w < w1 - w0; ++w)
            m = L::max(m, L::load(r0 + (size_t)w * C));
      }
    }
    L::store(ob + (size_t)p * row_elems + (size_t)j * VEC, m);
    j += dj;
    p += dp;
    if (j >= n_slots) {
      j -= n_slots;
      ++p;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(FWD_THREADS)
roi_pool_pyramid_kernel(const FwdPyramid pyr) {
  constexpr int VW = 16 / sizeof(T);        // channels per 16-byte vector
  __shared__ int s_row[FWD_MAX_ROWS];
  __shared__ int2 s_col[FWD_MAX_SLOTS];

  // this block's scale: the last whose first block is at or before it
  // (constant indices only, so the table stays in the parameter bank)
  const int blk = blockIdx.x;
  FwdScale sc = pyr.s[0];
#pragma unroll
  for (int i = 1; i < FWD_MAX_SCALES; ++i)
    if (i < pyr.n && blk >= pyr.s[i].block0) sc = pyr.s[i];
  const int r = blk - sc.block0;
  const int bk = r / sc.strips;
  const int strip = r - bk * sc.strips;
  const int b = bk / pyr.K;
  const int p0 = strip * sc.strip_rows;
  const int rows = min(sc.strip_rows, sc.out_h - p0);

  const float* box = pyr.boxes + (size_t)bk * 4;
  const int rs_w = round_edge(box[0], sc.scale);
  const int rs_h = round_edge(box[1], sc.scale);
  const int roi_w = max(round_edge(box[2], sc.scale) - rs_w + 1, 1);
  const int roi_h = max(round_edge(box[3], sc.scale) - rs_h + 1, 1);
  const int sh = min(max(rs_h, 0), sc.H);
  const int sw = min(max(rs_w, 0), sc.W);
  for (int i = threadIdx.x; i < rows; i += FWD_THREADS) {
    const int p = p0 + i;
    const int h0 = min(sh + (p * roi_h) / sc.out_h, sc.H);
    const int h1 = min(sh + ((p + 1) * roi_h + sc.out_h - 1) / sc.out_h,
                       sc.H);
    s_row[i] = h0 | (h1 << 16);
  }

  const T* fb = static_cast<const T*>(sc.feat) + (size_t)b * sc.pitch_b;
  const int row_elems = sc.out_w * sc.C;
  T* ob = static_cast<T*>(sc.out) + ((size_t)bk * sc.out_h + p0) * row_elems;
  const int per_pixel = sc.C / sc.vec;
  const int slots = sc.out_w * per_pixel;
  for (int j0 = 0; j0 < slots; j0 += FWD_MAX_SLOTS) {
    const int n_slots = min(FWD_MAX_SLOTS, slots - j0);
    for (int i = threadIdx.x; i < n_slots; i += FWD_THREADS) {
      const int q = (j0 + i) / per_pixel;
      const int c0 = (j0 + i - q * per_pixel) * sc.vec;
      const int w0 = min(sw + (q * roi_w) / sc.out_w, sc.W);
      const int w1 = min(sw + ((q + 1) * roi_w + sc.out_w - 1) / sc.out_w,
                         sc.W);
      s_col[i] = make_int2(w0 | (w1 << 16), c0);
    }
    __syncthreads();
    T* oc = ob + (size_t)j0 * sc.vec;
    if (sc.vec == VW)
      pool_strip<T, VW>(fb, oc, sc.pitch_w, sc.C, rows, row_elems, n_slots,
                        s_row, s_col);
    else
      pool_strip<T, 1>(fb, oc, sc.pitch_w, sc.C, rows, row_elems, n_slots,
                       s_row, s_col);
    __syncthreads();
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

}  // namespace

// Pools n <= 5 maps in one launch.  feats[i]: a (B, pitch_h, pitch_w, C)
// NHWC map or canvas of which the leading (H, W) is pooled (a plain map
// has pitch_h = H, pitch_w = W), bf16, or f32 when f32 != 0; outs[i]:
// (B, K, out_h, out_w, C) in the same type; boxes: (B, K, 4) f32
// [x1, y1, x2, y2], every scale's; scales[i]: the map's scale.  dims[10 i
// ...]: H, W, C, pitch_h, pitch_w, out_h, out_w, vec, strip_rows, strips
// (ops/kernels/roi_pool.py:fwd_plan).  vec, the channels per thread, is 1
// or a 16-byte vector (8 bf16, 4 f32), which needs C % vec == 0 and
// 16-byte aligned pointers.  A table the kernel was not built for
// returns cudaErrorInvalidValue and launches nothing; otherwise returns
// cudaGetLastError().
extern "C" int riders_roi_pool_pyramid(const void* const* feats,
                                       void* const* outs, const int* dims,
                                       const float* scales, int n,
                                       const void* boxes, int B, int K,
                                       int f32, void* stream) {
  if (n < 1 || n > FWD_MAX_SCALES || B < 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  const int wide = f32 ? 4 : 8;
  FwdPyramid pyr{};
  pyr.boxes = static_cast<const float*>(boxes);
  pyr.n = n;
  pyr.K = K;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    const int* d = dims + FWD_DIMS * i;
    FwdScale& s = pyr.s[i];
    s.feat = feats[i];
    s.out = outs[i];
    s.H = d[0]; s.W = d[1]; s.C = d[2];
    s.pitch_w = d[4]; s.out_h = d[5]; s.out_w = d[6]; s.vec = d[7];
    s.strip_rows = d[8]; s.strips = d[9];
    s.pitch_b = (long long)d[3] * d[4] * d[2];
    s.scale = scales[i];
    s.block0 = (int)blocks;
    const bool work = s.out_h > 0 && s.out_w > 0 && s.C > 0;
    if (s.H < 0 || s.W < 0 || s.H >= 32768 || s.W >= 32768 || d[3] < s.H ||
        s.pitch_w < s.W || s.out_h < 0 || s.out_w < 0 ||
        (s.vec != 1 && s.vec != wide) || s.C % s.vec != 0 ||
        (work && (s.strip_rows < 1 || s.strip_rows > FWD_MAX_ROWS ||
                  (long long)s.strips * s.strip_rows < s.out_h ||
                  (long long)(s.strips - 1) * s.strip_rows >= s.out_h)) ||
        (!work && s.strips != 0))
      return (int)cudaErrorInvalidValue;
    blocks += (long long)B * K * s.strips;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    roi_pool_pyramid_kernel<float><<<(unsigned)blocks, FWD_THREADS, 0, st>>>(
        pyr);
  else
    roi_pool_pyramid_kernel<__nv_bfloat16>
        <<<(unsigned)blocks, FWD_THREADS, 0, st>>>(pyr);
  return (int)cudaGetLastError();
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
