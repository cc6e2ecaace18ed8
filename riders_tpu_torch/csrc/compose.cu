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
// ~18 us at 3.35 TB/s.
//
// Design: a gather, not a scatter.  One thread per output pixel loops
// over its frame's K points in ascending order, with each point's patch
// origin, depth and mask staged in shared memory, and reads the one
// response element (if any) that lands on its pixel.  The accumulators
// live in registers, nothing is written twice, no atomics are needed,
// and the f32 sums happen in the same order as the JAX scan, with no
// fused multiply-add, so the result equals the plain version bit for
// bit.  Patch origins round u, v half to even (rintf), as jnp.round
// does; the threshold may be negative.  The TPU kernel's H-banding was a
// VMEM workaround and has no counterpart here.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BX = 32, BY = 8;

__global__ void compose_kernel(const float* __restrict__ resp,
                               const float* __restrict__ points,
                               const float* __restrict__ mask,
                               const float* __restrict__ thr,
                               float* __restrict__ depth,
                               float* __restrict__ max_resp, int K, int H,
                               int W, int ph, int pw) {
  extern __shared__ int smem[];
  int* y0_s = smem;
  int* x0_s = y0_s + K;
  float* z_s = reinterpret_cast<float*>(x0_s + K);
  float* m_s = z_s + K;

  const int b = blockIdx.z;
  const int pad_y = ph / 2, pad_x = pw / 2;
  const int Hp = H + 2 * pad_y, Wp = W + 2 * pad_x;
  const int tid = threadIdx.y * BX + threadIdx.x;
  for (int k = tid; k < K; k += BX * BY) {
    const float* pt = points + ((size_t)b * K + k) * 3;
    const int u = (int)rintf(pt[0]);
    const int v = (int)rintf(pt[1]);
    y0_s[k] = min(max(v - pad_y, 0), Hp - ph);
    x0_s[k] = min(max(u - pad_x, 0), Wp - pw);
    z_s[k] = pt[2];
    m_s[k] = mask[(size_t)b * K + k];
  }
  __syncthreads();

  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int cy = y + pad_y, cx = x + pad_x;   // padded-canvas coordinates
  const float t = thr[b];
  const float* rb = resp + (size_t)b * K * ph * pw;
  float mx = 0.f, sr = 0.f, srz = 0.f;
  for (int k = 0; k < K; ++k) {
    const int dy = cy - y0_s[k];
    const int dx = cx - x0_s[k];
    if (dy < 0 || dy >= ph || dx < 0 || dx >= pw) continue;
    float r = rb[((size_t)k * ph + dy) * pw + dx];
    r = r < t ? 0.f : r;
    r = __fmul_rn(r, m_s[k]);
    mx = fmaxf(mx, r);
    sr = __fadd_rn(sr, r);
    srz = __fadd_rn(srz, __fmul_rn(r, z_s[k]));
  }
  const size_t o = ((size_t)b * H + y) * W + x;
  depth[o] = mx > 0.f ? __fdiv_rn(srz, sr > 0.f ? sr : 1.f) : 0.f;
  max_resp[o] = mx;
}

}  // namespace

// resp: (B, K, ph, pw) f32; points: (B, K, 3) f32 (u, v, z) in padded
// coordinates; mask: (B, K) f32; thr: (B,) f32; depth, max_resp:
// (B, H, W) f32.  Returns cudaGetLastError().
extern "C" int riders_compose_patches(const void* resp, const void* points,
                                      const void* mask, const void* thr,
                                      void* depth, void* max_resp, int B,
                                      int K, int H, int W, int ph, int pw,
                                      void* stream) {
  dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY, B);
  dim3 block(BX, BY);
  const size_t smem = (size_t)K * 4 * sizeof(int);
  compose_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(resp), static_cast<const float*>(points),
      static_cast<const float*>(mask), static_cast<const float*>(thr),
      static_cast<float*>(depth), static_cast<float*>(max_resp), K, H, W, ph,
      pw);
  return (int)cudaGetLastError();
}
