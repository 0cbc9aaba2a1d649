// Mamba2 SSD chunked scan (state-space duality, arXiv:2405.21060).
//
// Replaces: src/repro/kernels/ssd_scan.py, _ssd_kernel / ssd_scan (Pallas,
// TPU).
//
// Recurrence per series: h_t = exp(a_t) h_{t-1} + B_t (x) x_t, y_t = C_t h_t,
// with h an (N x P) state.  Per chunk of T steps, with cum the inclusive
// prefix sum of a over the chunk and total = cum[T-1]:
//   y     = ((C B^T) * L) x + diag(exp(cum)) C h,   L[i][j] = exp(cum_i - cum_j), i >= j
//   h_new = exp(total) h + (diag(exp(total - cum)) B)^T x
//
// What bounds it on the H100: per chunk, counting the causal half of the
// score tile, T (T + 1) N flops for C B^T, T (T + 1) P for (C B^T * L) x,
// 2 T N P for C h and 2 T N P for the state update, against 2 T (2 P + 2 N)
// bytes of bf16 operands: about 64 flops per byte at T = 128, N = P = 64.
// Each product counts at the peak for its operands: C B^T has bf16
// operands, which bf16 tensor cores with f32 accumulation multiply exactly
// (989 TFLOP/s); the other three pair an f32 operand (the decayed scores,
// the state, the decay-weighted B) with a bf16 input, which the tensor
// cores can do exactly as three bf16 products (the f32 operand split into
// three bf16 pieces, as the bf16 flash kernel does).  At the served Zamba2
// shape (320 series, L = 2048, N = P = 64) that is 5.4e9 flops in
// 0.0055 ms and 3 x 1.6e10 in 0.049 ms, 0.054 ms in all, under the
// 0.1025 ms the 3.4e8 bytes take: bytes bound it.  This kernel does all
// four products in f32 FMA.
//
// Design: the TPU grid's sequential chunk axis becomes a loop inside the
// block; one block of 256 threads (16 x 16) owns one series, and its f32
// (N x P) state stays in shared memory for the whole scan (the TPU kernel's
// VMEM scratch).  Each chunk stages B and C transposed (n-major, odd row
// stride so the transposing stores are conflict-free), x, and the decay
// prefix sums (a warp scan in f32) in shared memory; the (T x T) masked
// score tile C B^T * L goes to shared memory (64 KB at T = 128, hence the
// dynamic shared-memory attribute), then y and the state update are
// register-tiled products over it.  exp(cum_i - cum_j) is evaluated only
// where i >= j: the upper triangle would overflow.  A ragged last chunk is
// masked here (rows past L read as zero, which leaves the state unchanged:
// a = 0, B = 0), with no host-side padding.  y is written in x's dtype; the
// final state, which prefill needs for decode, is written in f32 when asked.
// Plain FMA in f32: no tensor cores yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {
namespace ssd {

constexpr int THREADS = 256;  // 16 x 16
constexpr int MAX_T = 128;    // chunk length
constexpr int MAX_P = 64;     // head dimension
constexpr int MAX_N = 128;    // state size
constexpr int RT = MAX_T / 16;  // chunk rows per thread (stride 16)
constexpr int RN = MAX_N / 16;  // state rows per thread (stride 16)
constexpr int CP = MAX_P / 16;  // head-dim columns per thread (stride 16)

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Strides {   // element strides of a (BH, L, *) operand; the last is unit
  long long bh, l;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ b,
           const T* __restrict__ c, const float* __restrict__ a,
           T* __restrict__ y, float* __restrict__ state, int len, int p,
           int n, int chunk, Strides xs, Strides bs, Strides cs, Strides as) {
  extern __shared__ float smem[];
  const int ldt = chunk + 1;
  float* Bt = smem;               // [n][ldt]:     Bt[nn*ldt + j] = B[t0+j][nn]
  float* Ct = Bt + n * ldt;       // [n][ldt]:     Ct[nn*ldt + i] = C[t0+i][nn]
  float* St = Ct + n * ldt;       // [chunk][ldt]: St[j*ldt + i] = S[i][j]
  float* Xs = St + chunk * ldt;   // [chunk][p]
  float* H = Xs + chunk * p;      // [n][p], the carried state
  float* cum = H + n * p;         // [chunk] inclusive prefix sums of a
  float* ecum = cum + chunk;      // [chunk] exp(cum_i)
  float* w = ecum + chunk;        // [chunk] exp(total - cum_j)

  const int s = blockIdx.x;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const T* xb = x + s * xs.bh;
  const T* bb = b + s * bs.bh;
  const T* cb = c + s * cs.bh;
  const float* ab = a + s * as.bh;
  T* yb = y + static_cast<long long>(s) * len * p;

  for (int idx = threadIdx.x; idx < n * p; idx += THREADS) H[idx] = 0.f;

  for (int t0 = 0; t0 < len; t0 += chunk) {
    __syncthreads();   // the previous chunk's readers are done
    for (int idx = threadIdx.x; idx < chunk * n; idx += THREADS) {
      const int j = idx / n, nn = idx % n;
      const bool ok = t0 + j < len;
      Bt[nn * ldt + j] = ok ? load(bb + (t0 + j) * bs.l + nn) : 0.f;
      Ct[nn * ldt + j] = ok ? load(cb + (t0 + j) * cs.l + nn) : 0.f;
    }
    for (int idx = threadIdx.x; idx < chunk * p; idx += THREADS) {
      const int j = idx / p, pp = idx % p;
      Xs[idx] = t0 + j < len ? load(xb + (t0 + j) * xs.l + pp) : 0.f;
    }
    if (warp == 0) {   // inclusive prefix sum of a over the chunk, in f32:
      // each lane sums `per` consecutive steps, then the lanes scan
      const int per = (chunk + 31) / 32;
      float loc[MAX_T / 32];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < MAX_T / 32; ++e) {
        const int t = lane * per + e;
        if (e < per && t < chunk && t0 + t < len) run += ab[(t0 + t) * as.l];
        loc[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float before = incl - run;
#pragma unroll
      for (int e = 0; e < MAX_T / 32; ++e) {
        const int t = lane * per + e;
        if (e < per && t < chunk) cum[t] = before + loc[e];
      }
    }
    __syncthreads();
    const float total = cum[chunk - 1];
    for (int t = threadIdx.x; t < chunk; t += THREADS) {
      ecum[t] = expf(cum[t]);
      w[t] = expf(total - cum[t]);
    }

    // S = (C B^T) * L, rows i = ty + 16 r, columns j = tx + 16 q
    {
      float acc[RT][RT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < RT; ++q) acc[r][q] = 0.f;
      for (int nn = 0; nn < n; ++nn) {
        float cv[RT], bv[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
          cv[r] = 16 * r < chunk ? Ct[nn * ldt + ty + 16 * r] : 0.f;
#pragma unroll
        for (int q = 0; q < RT; ++q)
          bv[q] = 16 * q < chunk ? Bt[nn * ldt + tx + 16 * q] : 0.f;
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < RT; ++q) acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int q = 0; q < RT; ++q) {
          const int j = tx + 16 * q;
          if (i < chunk && j < chunk)
            St[j * ldt + i] = i >= j ? acc[r][q] * expf(cum[i] - cum[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y = S x + diag(exp(cum)) C h, rows i = ty + 16 r, columns tx + 16 q
    {
      float yi[RT][CP], yh[RT][CP];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q) yi[r][q] = yh[r][q] = 0.f;
      for (int j = 0; j < chunk; ++j) {
        float sv[RT], xv[CP];
#pragma unroll
        for (int r = 0; r < RT; ++r)
          sv[r] = 16 * r < chunk ? St[j * ldt + ty + 16 * r] : 0.f;
#pragma unroll
        for (int q = 0; q < CP; ++q)
          xv[q] = tx + 16 * q < p ? Xs[j * p + tx + 16 * q] : 0.f;
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < CP; ++q) yi[r][q] = fmaf(sv[r], xv[q], yi[r][q]);
      }
      for (int nn = 0; nn < n; ++nn) {
        float cv[RT], hv[CP];
#pragma unroll
        for (int r = 0; r < RT; ++r)
          cv[r] = 16 * r < chunk ? Ct[nn * ldt + ty + 16 * r] : 0.f;
#pragma unroll
        for (int q = 0; q < CP; ++q)
          hv[q] = tx + 16 * q < p ? H[nn * p + tx + 16 * q] : 0.f;
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < CP; ++q) yh[r][q] = fmaf(cv[r], hv[q], yh[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = ty + 16 * r;
        if (i >= chunk || t0 + i >= len) continue;
#pragma unroll
        for (int q = 0; q < CP; ++q) {
          const int pp = tx + 16 * q;
          if (pp < p)
            store(yb + static_cast<long long>(t0 + i) * p + pp,
                  yi[r][q] + ecum[i] * yh[r][q]);
        }
      }
    }
    __syncthreads();   // every read of H for this chunk is done

    // h = exp(total) h + (diag(w) B)^T x, rows nn = ty + 16 r, columns tx + 16 q
    {
      float hacc[RN][CP];
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q) hacc[r][q] = 0.f;
      for (int j = 0; j < chunk; ++j) {
        const float wj = w[j];
        float bw[RN], xv[CP];
#pragma unroll
        for (int r = 0; r < RN; ++r)
          bw[r] = ty + 16 * r < n ? Bt[(ty + 16 * r) * ldt + j] * wj : 0.f;
#pragma unroll
        for (int q = 0; q < CP; ++q)
          xv[q] = tx + 16 * q < p ? Xs[j * p + tx + 16 * q] : 0.f;
#pragma unroll
        for (int r = 0; r < RN; ++r)
#pragma unroll
          for (int q = 0; q < CP; ++q) hacc[r][q] = fmaf(bw[r], xv[q], hacc[r][q]);
      }
      const float decay = expf(total);
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const int nn = ty + 16 * r;
#pragma unroll
        for (int q = 0; q < CP; ++q) {
          const int pp = tx + 16 * q;
          if (nn < n && pp < p) H[nn * p + pp] = decay * H[nn * p + pp] + hacc[r][q];
        }
      }
    }
  }

  if (state != nullptr) {
    __syncthreads();
    float* sb = state + static_cast<long long>(s) * n * p;
    for (int idx = threadIdx.x; idx < n * p; idx += THREADS) sb[idx] = H[idx];
  }
}

template <typename T>
int launch(const void* x, const void* b, const void* c, const void* a,
           void* y, void* state, int bh, int len, int p, int n, int chunk,
           Strides xs, Strides bs, Strides cs, Strides as, int smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_kernel<T><<<bh, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(a),
      static_cast<T*>(y), static_cast<float*>(state), len, p, n, chunk, xs, bs,
      cs, as);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd
}  // namespace repro

// Shared memory one block needs (bytes).
extern "C" int repro_ssd_scan_smem_bytes(int p, int n, int chunk) {
  const int ldt = chunk + 1;
  return (2 * n * ldt + chunk * ldt + chunk * p + n * p + 3 * chunk) *
         static_cast<int>(sizeof(float));
}

// x: (bh, len, p), b/c: (bh, len, n), all f32 (bf16 = 0) or all bf16
// (bf16 = 1), unit stride over the last axis and the given element strides
// over (series, step); a: (bh, len) f32 log-decay; y: (bh, len, p)
// contiguous, in x's dtype; state: (bh, n, p) f32 contiguous, or null.
// p <= 64, n <= 128, chunk a multiple of 16 up to 128 and the shared-memory
// size are checked by the Python wrapper.  Returns cudaGetLastError.
extern "C" int repro_ssd_scan(const void* x, const void* b, const void* c,
                              const void* a, void* y, void* state, int bh,
                              int len, int p, int n, int chunk, int bf16,
                              long long xsb, long long xsl, long long bsb,
                              long long bsl, long long csb, long long csl,
                              long long asb, long long asl, void* stream) {
  using namespace repro::ssd;
  const Strides xs{xsb, xsl}, bs{bsb, bsl}, cs{csb, csl}, as{asb, asl};
  const int smem = repro_ssd_scan_smem_bytes(p, n, chunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, b, c, a, y, state, bh, len, p, n, chunk,
                                 xs, bs, cs, as, smem, st);
  return launch<float>(x, b, c, a, y, state, bh, len, p, n, chunk, xs, bs, cs,
                       as, smem, st);
}
