// Stage 1's bounded scale-only L1 solve: per frame b, a golden-section
// search of `iterations` steps for the scale s in [lo, hi] that minimises
//
//   f_b(s) = sum_i m[b, i] |s p[b, i] - t[b, i]|,
//
// returning 0.5 (lo + hi) of the last interval, (B,) float32.
//
// Replaces: no `pallas_call`.  The JAX package runs the search as one
// `lax.fori_loop` (riders_tpu/ops/alignment.py:_golden_section), a single
// XLA while loop on the TPU; the port's plain version
// (ops/kernels/golden_section.py:golden_section_plain) issues ~25 eager
// ops on (B, N) tensors an iteration, ~1650 launches a call at 64
// iterations, most of stage 1's host time and ~5 ms of its device time.
//
// Bound on the H100: latency.  At the cells' shape (B = 64 frames, N = 512
// gathered pixels, 64 iterations) the work is 66 objectives of N terms a
// frame (~2.2 M operations, 393 KB read once): nanoseconds at the card's
// rates.  What remains is the chain of 66 dependent objectives, each a
// few dozen cycles of arithmetic and a reduction.
//
// Design:
//  * A block owns one frame.  Up to 32 * REG = 512 pixels it is one warp,
//    which keeps the frame's (p, t, m) in registers (REG triples a lane);
//    up to RESIDENT_WARPS * 512 pixels W = ceil(N / 512) warps do; longer
//    rows take MAX_WARPS warps that stream their pixels from global memory,
//    thread i taking pixels i, i + 32 W, ... as a resident row does (any
//    N, the un-gathered maps included).
//  * lo, hi, c, d, f(c), f(d) live in registers of every thread, which all
//    hold the same values.  Each step evaluates only the objective the
//    update rule keeps: the plain loop computes both probes and discards
//    one by `torch.where`, so skipping it changes no output.
//  * An objective is a register pass (resident rows: the REG terms summed
//    pairwise; streamed rows: in index order), a fixed-order xor-shuffle
//    reduction across the warp, after which every lane holds the same
//    bits, and with several warps a sum of the warp totals in warp order
//    through a double-buffered shared array, one __syncthreads each.  The
//    single-warp case has no shared memory and no barrier.
//  * The arithmetic is the plain version's: float32 throughout, the same
//    constants rounded from the same doubles, the same `fc < fd` rule and
//    carried point, the interval and each term written with __fmul_rn /
//    __fsub_rn / __fadd_rn so that nothing is contracted into an FMA.  Only
//    the order of each objective's sum differs from `torch.sum`;
//    tests/test_torch_golden_section.py mirrors it on the CPU.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W: ~14 us of device time at
// (16-64, 512) (CUDA-graph replay; back to back the wrapper's host time,
// 25-43 us, sets the pace), against 12-22 ms synchronised for the plain
// loop; one launch takes ~27-52 host ms off a B=64 fused call.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int REG = 16;                 // resident triples a thread
constexpr int RESIDENT_WARPS = 8;       // 255 registers a thread at most
constexpr int MAX_WARPS = 32;
// 1/phi and 1/phi^2, rounded from the plain version's doubles
constexpr float INVPHI = (float)0.6180339887498949;
constexpr float INVPHI2 = (float)0.3819660112501051;

__device__ __forceinline__ float term(float s, float p, float t, float m) {
  return __fmul_rn(m, fabsf(__fsub_rn(__fmul_rn(s, p), t)));
}

// lo + k (hi - lo)
__device__ __forceinline__ float probe(float lo, float hi, float k) {
  return __fadd_rn(lo, __fmul_rn(k, __fsub_rn(hi, lo)));
}

template <bool RESIDENT>
__global__ void __launch_bounds__(32 * (RESIDENT ? RESIDENT_WARPS
                                                 : MAX_WARPS))
golden_section_kernel(const float* __restrict__ p,
                      const float* __restrict__ t,
                      const float* __restrict__ m, float* __restrict__ out,
                      int N, float lo, float hi, int iterations) {
  __shared__ float warp_sums[2][MAX_WARPS];
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int warps = threads / 32;
  const size_t row = (size_t)blockIdx.x * N;
  const float* __restrict__ pr = p + row;
  const float* __restrict__ tr = t + row;
  const float* __restrict__ mr = m + row;

  float rp[REG], rt[REG], rm[REG];
  if constexpr (RESIDENT) {
    #pragma unroll
    for (int k = 0; k < REG; ++k) {
      const int i = tid + k * threads;
      const bool in = i < N;
      rp[k] = in ? pr[i] : 0.f;
      rt[k] = in ? tr[i] : 0.f;
      rm[k] = in ? mr[i] : 0.f;
    }
  }
  int buf = 0;

  auto objective = [&](float s) {
    float v;
    if constexpr (RESIDENT) {
      float x[REG];
      #pragma unroll
      for (int k = 0; k < REG; ++k) x[k] = term(s, rp[k], rt[k], rm[k]);
      #pragma unroll
      for (int w = REG / 2; w >= 1; w >>= 1)       // x[k] += x[k + w]
        #pragma unroll
        for (int k = 0; k < REG / 2; ++k)
          if (k < w) x[k] = __fadd_rn(x[k], x[k + w]);
      v = x[0];
    } else {
      v = 0.f;
      for (int i = tid; i < N; i += threads)
        v = __fadd_rn(v, term(s, pr[i], tr[i], mr[i]));
    }
    #pragma unroll
    for (int o = 16; o >= 1; o /= 2)
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (warps > 1) {
      if ((tid & 31) == 0) warp_sums[buf][tid >> 5] = v;
      __syncthreads();
      v = warp_sums[buf][0];
      for (int w = 1; w < warps; ++w) v = __fadd_rn(v, warp_sums[buf][w]);
      buf ^= 1;
    }
    return v;
  };

  float c = probe(lo, hi, INVPHI2);
  float d = probe(lo, hi, INVPHI);
  float fc = objective(c);
  float fd = objective(d);
  for (int it = 0; it < iterations; ++it) {
    const bool left = fc < fd;
    float s;
    if (left) {              // [lo, d]: c carries over as the new d
      hi = d;
      d = c;
      fd = fc;
      s = probe(lo, hi, INVPHI2);
    } else {                 // [c, hi]: d carries over as the new c
      lo = c;
      c = d;
      fc = fd;
      s = probe(lo, hi, INVPHI);
    }
    const float f = objective(s);
    if (left) {
      c = s;
      fc = f;
    } else {
      d = s;
      fd = f;
    }
  }
  if (tid == 0) out[blockIdx.x] = __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

}  // namespace

// p, t, m: (B, N) float32, contiguous; out: (B,) float32.  The warps a
// block takes, and whether the row stays in registers, follow from N
// alone.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// negative size or iteration count.
extern "C" int riders_golden_section(const void* p, const void* t,
                                     const void* m, void* out, int B, int N,
                                     float lo, float hi, int iterations,
                                     void* stream) {
  if (B < 0 || N < 0 || iterations < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const long long per_warp = 32 * REG;
  const bool resident = N <= RESIDENT_WARPS * per_warp;
  const int warps =
      resident ? (int)(N > 0 ? (N + per_warp - 1) / per_warp : 1)
               : MAX_WARPS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fp = static_cast<const float*>(p);
  const float* ft = static_cast<const float*>(t);
  const float* fm = static_cast<const float*>(m);
  float* fo = static_cast<float*>(out);
  if (resident)
    golden_section_kernel<true><<<B, 32 * warps, 0, s>>>(
        fp, ft, fm, fo, N, lo, hi, iterations);
  else
    golden_section_kernel<false><<<B, 32 * warps, 0, s>>>(
        fp, ft, fm, fo, N, lo, hi, iterations);
  return (int)cudaGetLastError();
}
