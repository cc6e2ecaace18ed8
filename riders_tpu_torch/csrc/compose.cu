// Quasi-dense patch composition: per frame, threshold the K response
// patches and paste each at its point, keeping max r, sum r and sum r*z
// per pixel in ascending k; depth = sum r*z / sum r where max r > 0.
//
// Replaces: riders_tpu/ops/pallas/compose.py:compose_patches_pallas, the
// VMEM-canvas Pallas kernel of the JAX package.
//
// Bound on the H100: data movement.  At the NTU bench shape (B=16, K=48,
// 40 real points, 150x50 patches, 512x640 frames) it must read the real
// points' in-frame responses, ~17 MB, and write two 21 MB maps: ~59 MB,
// ~18 us at 3.35 TB/s.  A gather that tests every pixel against all K
// points is bound by instructions instead (252 M point tests per call at
// NTU), though a patch covers ~2% of a frame.
//
// Design: a gather over a culled point list.  A block owns a tile of TH
// rows x TW columns of one frame.  First its threads test the frame's
// points, THREADS at a time, for whether the point's patch window [y0,
// y0 + ph) x [x0, x0 + pw) (padded coordinates) meets the tile; a warp
// ballot and a popcount prefix, chained over the warps and the rounds,
// write the k that do into shared memory in ascending order, with each
// one's origin, depth and mask (about 3.6 points a tile at NTU, not 48).
// A masked point stays listed: the plain version adds its +-0 (or NaN).
// Then each thread owns RUN consecutive pixels of one row, walks the
// list, reads the response elements that land on its pixels, keeps max r,
// sum r and sum r*z in registers and writes depth and max r as 16-byte
// stores.  Each pixel sees its points in ascending k and the f32 sums
// have no fused multiply-add, as in the JAX scan, so the result equals the
// plain version bit for bit.  Patch origins round u, v half to even
// (rintf), as jnp.round does; the threshold may be negative.  The TPU
// kernel's H-banding was a VMEM workaround and has no counterpart here.
// ops/kernels/compose.py:tile_points mirrors the culling.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int RUN = 4;                 // consecutive pixels per thread
constexpr int TW = 32 * RUN;           // tile columns: a warp per row
constexpr int TH = 8;                  // tile rows: a warp each
constexpr int THREADS = 32 * TH;

// The tile's listed points: k, patch origin (y0, x0), depth, mask.
struct List {
  int* k;
  int* y0;
  int* x0;
  float* z;
  float* m;
};

__global__ void __launch_bounds__(THREADS)
compose_kernel(const float* __restrict__ resp,
               const float* __restrict__ points,
               const float* __restrict__ mask,
               const float* __restrict__ thr, float* __restrict__ depth,
               float* __restrict__ max_resp, int K, int H, int W, int ph,
               int pw) {
  extern __shared__ int smem[];
  __shared__ int warp_n[TH];
  const List list{smem, smem + K, smem + 2 * K,
                  reinterpret_cast<float*>(smem + 3 * K),
                  reinterpret_cast<float*>(smem + 4 * K)};

  const int b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int pad_y = ph / 2, pad_x = pw / 2;
  const int Hp = H + 2 * pad_y, Wp = W + 2 * pad_x;
  // the tile's pixels within the frame, in padded coordinates
  const int cy0 = ty0 + pad_y, cy1 = min(ty0 + TH, H) + pad_y;
  const int cx0 = tx0 + pad_x, cx1 = min(tx0 + TW, W) + pad_x;

  int n = 0;                            // points listed so far
  for (int base = 0; base < K; base += THREADS) {
    const int k = base + tid;
    bool meets = false;
    int y0 = 0, x0 = 0;
    if (k < K) {
      const float* pt = points + ((size_t)b * K + k) * 3;
      const int u = (int)rintf(pt[0]);
      const int v = (int)rintf(pt[1]);
      y0 = min(max(v - pad_y, 0), Hp - ph);
      x0 = min(max(u - pad_x, 0), Wp - pw);
      meets = y0 < cy1 && y0 + ph > cy0 && x0 < cx1 && x0 + pw > cx0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, meets);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int slot = n, total = 0;
#pragma unroll
    for (int w = 0; w < TH; ++w) {
      slot += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
    if (meets) {
      slot += __popc(ballot & ((1u << lane) - 1u));
      list.k[slot] = k;
      list.y0[slot] = y0;
      list.x0[slot] = x0;
      list.z[slot] = points[((size_t)b * K + k) * 3 + 2];
      list.m[slot] = mask[(size_t)b * K + k];
    }
    n += total;
    __syncthreads();                    // the list and warp_n are settled
  }

  const int y = ty0 + warp, x = tx0 + lane * RUN;
  if (y >= H || x >= W) return;
  const int cy = y + pad_y, cx = x + pad_x;
  const float t = thr[b];
  const float* rb = resp + (size_t)b * K * ph * pw;
  float mx[RUN], sr[RUN], srz[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) mx[j] = sr[j] = srz[j] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int dy = cy - list.y0[i], dx0 = cx - list.x0[i];
    if (dy < 0 || dy >= ph || dx0 + RUN <= 0 || dx0 >= pw) continue;
    const float* row = rb + ((size_t)list.k[i] * ph + dy) * pw;
    const float m = list.m[i], z = list.z[i];
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const int dx = dx0 + j;
      if (dx < 0 || dx >= pw) continue;
      float r = row[dx];
      r = r < t ? 0.f : r;
      r = __fmul_rn(r, m);
      mx[j] = fmaxf(mx[j], r);
      sr[j] = __fadd_rn(sr[j], r);
      srz[j] = __fadd_rn(srz[j], __fmul_rn(r, z));
    }
  }
  float d[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j)
    d[j] = mx[j] > 0.f ? __fdiv_rn(srz[j], sr[j] > 0.f ? sr[j] : 1.f) : 0.f;
  const size_t o = ((size_t)b * H + y) * W + x;
  if (W % RUN == 0) {                   // x + RUN <= W, 16-byte aligned
    *reinterpret_cast<float4*>(depth + o) = make_float4(d[0], d[1], d[2],
                                                        d[3]);
    *reinterpret_cast<float4*>(max_resp + o) =
        make_float4(mx[0], mx[1], mx[2], mx[3]);
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      if (x + j < W) {
        depth[o + j] = d[j];
        max_resp[o + j] = mx[j];
      }
  }
}

}  // namespace

// resp: (B, K, ph, pw) f32; points: (B, K, 3) f32 (u, v, z) in padded
// coordinates; mask: (B, K) f32; thr: (B,) f32; depth, max_resp:
// (B, H, W) f32, 16-byte aligned.  Returns cudaGetLastError().
extern "C" int riders_compose_patches(const void* resp, const void* points,
                                      const void* mask, const void* thr,
                                      void* depth, void* max_resp, int B,
                                      int K, int H, int W, int ph, int pw,
                                      void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const size_t smem = (size_t)K * 5 * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        compose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  compose_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(resp), static_cast<const float*>(points),
      static_cast<const float*>(mask), static_cast<const float*>(thr),
      static_cast<float*>(depth), static_cast<float*>(max_resp), K, H, W, ph,
      pw);
  return (int)cudaGetLastError();
}
