// Tall-apply C = A B for a tall A (M x K) and a small B (K x N), reading A
// once: complex64 (A, B and C as interleaved (re, im) f32 pairs) and f32.
//
// Replaces: src/repro/kernels/matvec.py, _tall_apply_kernel / tall_apply
// and planar_matmul (Pallas, TPU; there a complex product is one doubled
// real GEMM, [Re A | Im A] [[Re B, Im B], [-Im B, Re B]]).  The complex
// and the real product are two instantiations of one kernel.
//
// What bounds it on the H100: the complex product needs 8 M K N flops (4
// FMAs an entry and k) against 8 (M K + K N + M N) bytes; at the main
// path's (82,944 x 72) . (72 x 72) that is 3.44e9 f32 flops, 0.0513 ms at
// 67 TFLOP/s, against 0.0285 ms for the bytes: the FMA rate bounds it.  The
// real product, 2 M K N flops on 4 (M K + K N + M N) bytes, is bound the
// same way at (82,944 x 144) . (144 x 144).  f32 operands are never rounded
// (no TF32, no tensor cores): plain FFMA.
//
// Design, against the four faults of the planar form it replaces:
// 1. A copied and read many times.  The complex instantiation reads A's
//    interleaved storage in place, with any row stride; a conjugated A or B
//    is a sign in the FMAs (conj(A) B = conj(A conj(B)): the CONJ_B
//    instantiations and the conj_out flag), B is read through its strides,
//    and C is written as complex64.  One block covers 144 floats of C's row
//    (72 complex or 144 real columns, the main path's width), so each row of
//    A is read from device memory once; wider N runs over grid.y.
// 2. Wasted FMAs.  A thread owns R rows x 12 floats of C (6 complex or 12
//    real columns): 12 column groups fit N = 72 complex exactly (the planar
//    form's 64-wide tiles computed 192 columns for 144).  Narrower N leaves
//    column groups idle: 1.125x the FMAs at the projections' N = 64, 2x at
//    N = 36.
// 3. Shared-memory bound inner loop.  A full pass gives a thread R = 6
//    rows, 72 accumulators; two complex k cost six 16-byte loads of A (one
//    a row) and six of B for 288 FMAs, 24 FMAs a load (the planar form: 2
//    a load).  Thread t owns column group t % 12 and row group t / 12; its
//    three 16-byte pieces of a row of B and C are 12 pieces apart, so a
//    warp's loads of B and its 16-byte stores of C cover whole runs of a
//    row, and its A loads touch at most 2 rows a quarter warp (row pitch 28
//    floats).  K is staged in slabs of 24 floats of each A row (12 complex
//    or 24 real k; K = 72 is 6 whole slabs) together with the matching 12
//    or 24 rows of B, through a 3-stage cp.async ring: 16-byte copies where
//    rows and pointers allow (B with unit column stride), else one element
//    a copy (B's strides read as they are).  Zeros fill past K, M and N.
//    B staged over K lifts the planar form's shared-memory limit on K: the
//    accumulators stay in registers across slabs, and there is no split-K.
// 4. Host ops.  One call is one launch and one torch.empty (the planar
//    form: cat x 3, neg, kernel, complex).
//
// Balance.  One block of 384 threads runs on every SM (12 warps, at most
// 168 registers a thread; the ring is 85,248 bytes complex, 105,984
// real), and the grid is exactly that many blocks.  M is cut into units of
// 32 rows and each block takes an equal share of units, as passes of 6
// units (6 rows a thread), then of 2, then of 1: a block's time follows
// its rows, so no last wave of blocks runs with the card half idle.  Its
// passes run as one stream of (pass, slab) stages through the ring, so the
// next pass's first slabs land while the current one finishes.  A small M
// (2,304 rows: 72 units) gives each block one 1-row pass, 1,728 FMAs a
// thread at K = 72.
//
// What holds it under half of the bound (tools/tall_apply_variants.py;
// ncu does not run on the chip machine): the FMA stream alone, with the
// loads after the ring's first fill removed, reaches only about 55% of
// the FFMA rate, though its SASS is 95% FFMA and the SM clock holds 1,980
// MHz; neither fewer shared loads nor the accumulators' register pairing
// moved it.
//
// Deterministic: each entry of C is summed by one thread, in k order, with
// a fixed FMA order; no atomics, so a second call repeats bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace repro {
namespace tall_apply {
namespace {   // internal linkage: nothing here is shared with another library

constexpr int MAX_DEVICES = 64; // devices whose shared-memory limit is kept
constexpr int CW = 12;          // floats of a C row per thread
constexpr int CG = 12;          // column groups per block
constexpr int NBF = CW * CG;    // floats of a C row per block: 144
constexpr int SK = 24;          // floats of an A row per stage
constexpr int PA = SK + 4;      // A row pitch in a stage (floats)
constexpr int STAGES = 3;       // ring depth
constexpr int RG = 32;          // row groups: a unit of M is RG rows
constexpr int THREADS = CG * RG;
constexpr int MIN_BLOCKS = 1;   // blocks per SM
constexpr int RMAX = 6;         // rows a thread in a full pass
constexpr int BM = RMAX * RG;   // rows of a full pass: 192

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES bytes global -> shared, asynchronously; zeros when !valid (src-size
// 0: nothing is read).  16-byte copies bypass L1 (.cg); smaller ones must
// use .ca.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES),
                    "r"(valid ? BYTES : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// acc[0, R) += A B over one staged slab, complex: `as` is the thread's
// first row (its R rows are RG apart), `bs` the slab's first row of B, of
// which the thread's 6 complex columns are the 16-byte pieces cg, cg + CG,
// cg + 2 CG.  Two k a step: one 16-byte load of A a row, three of B a k.
template <int R, bool CONJ_B>
__device__ __forceinline__ void slab_fma_complex(const float* as,
                                                 const float* bs, int cg,
                                                 float (&acc)[RMAX][CW]) {
#pragma unroll
  for (int p = 0; p < SK / 4; ++p) {
    float4 av[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      av[r] = *reinterpret_cast<const float4*>(as + r * RG * PA + 4 * p);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float br[CW / 2], bi[CW / 2];
#pragma unroll
      for (int q = 0; q < CW / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(
            bs + (2 * p + h) * NBF)[cg + CG * q];
        br[2 * q] = v.x;
        bi[2 * q] = v.y;
        br[2 * q + 1] = v.z;
        bi[2 * q + 1] = v.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float ar = h ? av[r].z : av[r].x;
        const float ai = h ? av[r].w : av[r].y;
#pragma unroll
        for (int j = 0; j < CW / 2; ++j) {
          float& re = acc[r][2 * j];
          float& im = acc[r][2 * j + 1];
          re = fmaf(ar, br[j], re);
          if constexpr (CONJ_B) {   // B's imaginary part negated
            re = fmaf(ai, bi[j], re);
            im = fmaf(-ar, bi[j], im);
          } else {
            re = fmaf(-ai, bi[j], re);
            im = fmaf(ar, bi[j], im);
          }
          im = fmaf(ai, br[j], im);
        }
      }
    }
  }
}

// acc[0, R) += A B over one staged slab, real: four k a step, one 16-byte
// load of A a row, three of B a k.
template <int R>
__device__ __forceinline__ void slab_fma_real(const float* as,
                                              const float* bs, int cg,
                                              float (&acc)[RMAX][CW]) {
#pragma unroll
  for (int p = 0; p < SK / 4; ++p) {
    float4 av[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      av[r] = *reinterpret_cast<const float4*>(as + r * RG * PA + 4 * p);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float bv[CW];
#pragma unroll
      for (int q = 0; q < CW / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(
            bs + (4 * p + h) * NBF)[cg + CG * q];
        bv[4 * q] = v.x;
        bv[4 * q + 1] = v.y;
        bv[4 * q + 2] = v.z;
        bv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = h == 0 ? av[r].x : h == 1 ? av[r].y
                      : h == 2 ? av[r].z : av[r].w;
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[r][j] = fmaf(x, bv[j], acc[r][j]);
      }
    }
  }
}

// A pass: R rows a thread over its RG row groups, from row `row`.
struct Pass {
  int row, r;
};

// Pass p of a block over the `units` units of M from row lo: full passes
// of RMAX units, then passes of 2 units, then one of 1.
__device__ __forceinline__ Pass pass_of(int p, int lo, int units) {
  const int nfull = units / RMAX, n2 = (units - nfull * RMAX) / 2;
  if (p < nfull) return {lo + p * BM, RMAX};
  if (p < nfull + n2) return {lo + (nfull * RMAX + 2 * (p - nfull)) * RG, 2};
  return {lo + (nfull * RMAX + 2 * n2) * RG, 1};
}

// Block (i, j): floats [NBF j, NBF j + NBF) of the rows of C in the i-th
// of gridDim.x equal shares of M's units; its passes run as one stream of
// (pass, slab) stages through the ring.  a: row stride lda elements, unit
// column stride; b: element strides sbk (over k) and sbn (over n); c:
// (m, n) row-major.  vec16: bit 0 (1) when A's (B's) rows and pointer
// allow 16-byte copies.  conj_out negates Im C.
template <bool CPLX, bool BF16, bool CONJ_B>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
tall_apply_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int m, int k, int n, long long lda,
                  long long sbk, long long sbn, int vec16, int conj_out) {
  constexpr int E = CPLX ? 2 : 1;           // floats an element
  constexpr int KS = SK / E;                // k a slab
  constexpr int NBE = NBF / E;              // columns a block
  constexpr int A_FLOATS = BM * PA;
  constexpr int STAGE_FLOATS = A_FLOATS + KS * NBF;
  extern __shared__ __align__(16) float ring[];

  const int t = threadIdx.x;
  // consecutive threads own consecutive 16-byte pieces of C's rows
  const int cg = t % CG, rg = t / CG;
  const long long all_units = (m + RG - 1) / RG;
  const int u0 = static_cast<int>(all_units * blockIdx.x / gridDim.x);
  const int units =
      static_cast<int>(all_units * (blockIdx.x + 1) / gridDim.x) - u0;
  const int lo = u0 * RG, hi = min(m, lo + units * RG);
  const int nfull = units / RMAX, rem = units - nfull * RMAX;
  const int nst = (k + KS - 1) / KS;
  const int nstage = (nfull + rem / 2 + rem % 2) * nst;
  const int col0 = blockIdx.y * NBE;

  auto fetch = [&](int s) {
    float* as = ring + (s % STAGES) * STAGE_FLOATS;
    float* bs = as + A_FLOATS;
    const int p = s / nst;
    const int k0 = (s - p * nst) * KS;
    const Pass ps = pass_of(p, lo, units);
    const int nrows = ps.r * RG;
    if (vec16 & 1) {   // A's rows are whole 16-byte pieces
      constexpr int CPR = SK / 4;
      for (int idx = t; idx < nrows * CPR; idx += THREADS) {
        const int rr = idx / CPR, q = idx - rr * CPR;
        const int row = ps.row + rr, kk = k0 + q * (4 / E);
        const bool ok = row < hi && kk < k;
        const float* src =
            ok ? a + (static_cast<long long>(row) * lda + kk) * E : a;
        cp_async<16>(as + rr * PA + 4 * q, src, ok);
      }
    } else {
      for (int idx = t; idx < nrows * KS; idx += THREADS) {
        const int rr = idx / KS, q = idx - rr * KS;
        const int row = ps.row + rr, kk = k0 + q;
        const bool ok = row < hi && kk < k;
        const float* src =
            ok ? a + (static_cast<long long>(row) * lda + kk) * E : a;
        cp_async<4 * E>(as + rr * PA + q * E, src, ok);
      }
    }
    if (vec16 & 2) {   // B's rows are contiguous whole 16-byte pieces
      constexpr int CPR = NBF / 4;
      for (int idx = t; idx < KS * CPR; idx += THREADS) {
        const int kk = idx / CPR, q = idx - kk * CPR;
        const int col = col0 + q * (4 / E);
        const bool ok = k0 + kk < k && col < n;
        const float* src = ok ? b + ((k0 + kk) * sbk + col) * E : b;
        cp_async<16>(bs + kk * NBF + 4 * q, src, ok);
      }
    } else {
      for (int idx = t; idx < KS * NBE; idx += THREADS) {
        const int kk = idx / NBE, j = idx - kk * NBE;
        const bool ok = k0 + kk < k && col0 + j < n;
        const float* src =
            ok ? b + ((k0 + kk) * sbk + (col0 + j) * sbn) * E : b;
        cp_async<4 * E>(bs + kk * NBF + j * E, src, ok);
      }
    }
  };

  float acc[RMAX][CW];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[r][j] = 0.f;

  const int nf = n * E;                       // floats of a C row
  const int f0 = blockIdx.y * NBF + 4 * cg;   // the thread's first float
  const bool vec_out = nf % 4 == 0;
  // C's rows of pass ps from the accumulators, which restart from zero
  auto store = [&](const Pass& ps) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      const int row = ps.row + r * RG + rg;
      if (r < ps.r && row < hi) {
        if (CPLX && conj_out) {
#pragma unroll
          for (int j = 1; j < CW; j += 2) acc[r][j] = -acc[r][j];
        }
        float* dst = c + static_cast<long long>(row) * nf;
#pragma unroll
        for (int q = 0; q < CW / 4; ++q) {   // the thread's pieces, CG apart
          const int f = f0 + 4 * CG * q;
          const float* v = acc[r] + 4 * q;
          if (vec_out && f < nf) {
            *reinterpret_cast<float4*>(dst + f) =
                make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (f + e < nf) dst[f + e] = v[e];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[r][j] = 0.f;
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nstage) fetch(s);
    cp_async_commit();
  }
  for (int s = 0; s < nstage; ++s) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of stage s landed
    __syncthreads();               // everyone's; slot of stage s-1 is free
    if (s + STAGES - 1 < nstage) fetch(s + STAGES - 1);
    cp_async_commit();             // empty groups keep the count in step
    float* slot = ring + (s % STAGES) * STAGE_FLOATS;
    if (BF16) {   // the mixed policy's bf16 multiplicands (re and im
                  // separately), rounded once
      for (int idx = t; idx < STAGE_FLOATS; idx += THREADS)
        slot[idx] = __bfloat162float(__float2bfloat16_rn(slot[idx]));
      __syncthreads();
    }
    const int p = s / nst;
    const Pass ps = pass_of(p, lo, units);
    const float* as = slot + rg * PA;
    const float* bs = slot + A_FLOATS;
    if constexpr (CPLX) {
      if (ps.r == RMAX)
        slab_fma_complex<RMAX, CONJ_B>(as, bs, cg, acc);
      else if (ps.r == 2)
        slab_fma_complex<2, CONJ_B>(as, bs, cg, acc);
      else
        slab_fma_complex<1, CONJ_B>(as, bs, cg, acc);
    } else {
      if (ps.r == RMAX)
        slab_fma_real<RMAX>(as, bs, cg, acc);
      else if (ps.r == 2)
        slab_fma_real<2>(as, bs, cg, acc);
      else
        slab_fma_real<1>(as, bs, cg, acc);
    }
    if (s - p * nst == nst - 1) store(ps);
  }
  cp_async_wait<0>();
}

inline int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

template <bool CPLX, bool BF16, bool CONJ_B>
int launch(const void* a, const void* b, void* c, int m, int k, int n,
           long long lda, long long sbk, long long sbn, int sms, int conj_out,
           cudaStream_t st) {
  constexpr int E = CPLX ? 2 : 1;
  constexpr int smem =
      STAGES * (BM * PA + (SK / E) * NBF) * static_cast<int>(sizeof(float));
  // the attribute is set once per device: it belongs to the kernel in
  // each device's context
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return static_cast<int>(derr);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        tall_apply_kernel<CPLX, BF16, CONJ_B>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  // 16-byte copies need rows of whole 16-byte pieces at aligned addresses
  const bool vec_a = (static_cast<long long>(k) * E) % 4 == 0 &&
                     (lda * E) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vec_b = sbn == 1 && (static_cast<long long>(n) * E) % 4 == 0 &&
                     (sbk * E) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int vec16 = (vec_a ? 1 : 0) | (vec_b ? 2 : 0);
  // MIN_BLOCKS blocks on every SM, each with at least one unit of M
  const int gy = ceil_div(static_cast<long long>(n) * E, NBF);
  const int gx = std::max(1, std::min(ceil_div(m, RG),
                                      ceil_div(MIN_BLOCKS * sms, gy)));
  tall_apply_kernel<CPLX, BF16, CONJ_B><<<dim3(gx, gy), THREADS, smem, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), m, k, n, lda, sbk, sbn, vec16, conj_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tall_apply
}  // namespace repro

// a: (m, k) with row stride lda elements and unit column stride; b: (k, n)
// with element strides sbk, sbn; c: (m, n) row-major; f32
// (repro_tall_apply_f32) or complex64 as interleaved (re, im) f32 pairs
// (repro_tall_apply_c64).  sms: the card's SM count, which sizes the grid.
// bf16 != 0 rounds the multiplicands (re and im parts) to bf16.  conj_b !=
// 0 reads conj(B), conj_out != 0 writes conj(C).  Returns
// cudaGetLastError.
extern "C" int repro_tall_apply_f32(const void* a, const void* b, void* c,
                                    int m, int k, int n, long long lda,
                                    long long sbk, long long sbn, int sms,
                                    int bf16, void* stream) {
  using namespace repro::tall_apply;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<false, true, false>(a, b, c, m, k, n, lda, sbk, sbn,
                                           sms, 0, st)
              : launch<false, false, false>(a, b, c, m, k, n, lda, sbk, sbn,
                                            sms, 0, st);
}

extern "C" int repro_tall_apply_c64(const void* a, const void* b, void* c,
                                    int m, int k, int n, long long lda,
                                    long long sbk, long long sbn, int sms,
                                    int bf16, int conj_b, int conj_out,
                                    void* stream) {
  using namespace repro::tall_apply;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return conj_b ? launch<true, true, true>(a, b, c, m, k, n, lda, sbk, sbn,
                                             sms, conj_out, st)
                  : launch<true, true, false>(a, b, c, m, k, n, lda, sbk,
                                              sbn, sms, conj_out, st);
  return conj_b ? launch<true, false, true>(a, b, c, m, k, n, lda, sbk, sbn,
                                            sms, conj_out, st)
                : launch<true, false, false>(a, b, c, m, k, n, lda, sbk, sbn,
                                             sms, conj_out, st);
}
