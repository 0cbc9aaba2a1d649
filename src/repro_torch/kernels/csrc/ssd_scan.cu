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
// cores multiply exactly as three bf16 products (the f32 operand split into
// three bf16 pieces).  At the served Zamba2 shape (320 series, L = 2048,
// N = P = 64) that is 5.4e9 flops in 0.0055 ms and 3 x 1.6e10 in 0.049 ms,
// 0.054 ms in all, under the 0.1025 ms the 3.4e8 bytes take: bytes bound
// it.
//
// bf16 operands: ssd_chunk_kernel, one block of 8 warps per chunk of each
// series (5,120 blocks at the served shape where the TPU grid walks 16
// chunks in order), the chunk-to-chunk state carried by an ordered
// look-back instead of a loop.  Each block takes a ticket from a counter
// (chunk-major), so the block that publishes its incoming state holds an
// earlier ticket and is running or done: no block waits on one that has
// not started, and with more series than blocks in flight the state is
// already there.  The f32 states between chunks go through a (BH, NC - 1,
// N, P) scratch (about 79 MB at the served shape, mostly read back from
// L2), each handed over by a flag (release store, acquire load).
// - B, x and C are staged with 16-byte cp.async (zeros past L and in the
//   pad columns; rows padded by 8 bf16 so ldmatrix has no bank conflicts),
//   and the incoming state is fetched while they are in flight; cum is a
//   warp scan in f32.
// - Hc = (diag(w) B)^T x, w = exp(total - cum): the A fragments of (w B)^T
//   come from ldmatrix.trans of B, are scaled by w in f32 and split
//   exactly into three bf16 pieces, three mma.sync m16n8k16 against the
//   bf16 x fragments into one f32 accumulator.  exp(total) h_in + Hc goes
//   to the scratch for the next chunk (or to the final state); its flag is
//   set when the block ends.
// - y, flash's structure with a decay mask in place of the softmax: each
//   warp owns 16 chunk rows and holds its C rows as A fragments (the row
//   tiles dealt so that the SM's four sub-partitions get the same number
//   of causal steps).  C h_in: h_in split once into three bf16 tiles in
//   shared memory, three products against the bf16 C, exp(cum_i) applied
//   to the f32 rows afterwards.  (C B^T * L) x, 16 keys a step, only the
//   steps on or below the diagonal: S = C B^T on mma.sync, exp(cum_i -
//   cum_j) applied in f32 where i >= j (the upper triangle would overflow)
//   and 0 above; the two n8 accumulator tiles of S are the A fragment of
//   the next k16 step, split three ways against x (ldmatrix.trans),
//   smallest piece first, so S never touches shared memory.  y is rounded
//   to bf16; rows past L are not written.
// - P and N are padded to 16, 32 or 64 and 16 to 128 (template
//   parameters, so every fragment loop has fixed bounds).
// A ragged last chunk needs no host-side padding: rows past L read as zero
// (a = 0, B = C = x = 0), which leaves the state unchanged.  No atomics in
// any sum (the ticket counter is the only atomic): every sum has a fixed
// order and runs repeat bit for bit.
//
// f32 operands (the checking path): ssd_kernel, plain FMA in f32.  The TPU
// grid's sequential chunk axis is a loop inside the block; one block of 256
// threads (16 x 16) owns one series, and its f32 (N x P) state stays in
// shared memory for the whole scan.  Each chunk stages B and C transposed
// (odd row stride), x and cum; the (T x T) masked score tile goes to shared
// memory, then y and the state update are register-tiled products over it.
#include "mma_bf16.cuh"

namespace repro {
namespace ssd {

constexpr int MAX_T = 128;    // chunk length
constexpr int MAX_P = 64;     // head dimension
constexpr int MAX_N = 128;    // state size

struct Strides {   // element strides of a (BH, L, *) operand; the last is unit
  long long bh, l;
};

// cum[t] = a[t0] + ... + a[t0 + t] for t < chunk, in f32, steps past len
// read as 0; called by one whole warp (each lane sums `per` consecutive
// steps, then the lanes scan).  The caller synchronises before reading it.
__device__ __forceinline__ void chunk_cumsum(float* cum, const float* ab,
                                             long long stride, int t0,
                                             int len, int chunk) {
  const int lane = threadIdx.x % 32;
  const int per = (chunk + 31) / 32;
  float loc[MAX_T / 32];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < MAX_T / 32; ++e) {
    const int t = lane * per + e;
    if (e < per && t < chunk && t0 + t < len) run += ab[(t0 + t) * stride];
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

// ---------------------------------------------------------------- f32 ----
constexpr int THREADS = 256;  // 16 x 16
constexpr int RT = MAX_T / 16;  // chunk rows per thread (stride 16)
constexpr int RN = MAX_N / 16;  // state rows per thread (stride 16)
constexpr int CP = MAX_P / 16;  // head-dim columns per thread (stride 16)

__global__ void __launch_bounds__(THREADS)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ b,
           const float* __restrict__ c, const float* __restrict__ a,
           float* __restrict__ y, float* __restrict__ state, int len, int p,
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
  const int warp = threadIdx.x / 32;
  const float* xb = x + s * xs.bh;
  const float* bb = b + s * bs.bh;
  const float* cb = c + s * cs.bh;
  const float* ab = a + s * as.bh;
  float* yb = y + static_cast<long long>(s) * len * p;

  for (int idx = threadIdx.x; idx < n * p; idx += THREADS) H[idx] = 0.f;

  for (int t0 = 0; t0 < len; t0 += chunk) {
    __syncthreads();   // the previous chunk's readers are done
    for (int idx = threadIdx.x; idx < chunk * n; idx += THREADS) {
      const int j = idx / n, nn = idx % n;
      const bool ok = t0 + j < len;
      Bt[nn * ldt + j] = ok ? bb[(t0 + j) * bs.l + nn] : 0.f;
      Ct[nn * ldt + j] = ok ? cb[(t0 + j) * cs.l + nn] : 0.f;
    }
    for (int idx = threadIdx.x; idx < chunk * p; idx += THREADS) {
      const int j = idx / p, pp = idx % p;
      Xs[idx] = t0 + j < len ? xb[(t0 + j) * xs.l + pp] : 0.f;
    }
    if (warp == 0) chunk_cumsum(cum, ab, as.l, t0, len, chunk);
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
            yb[static_cast<long long>(t0 + i) * p + pp] =
                yi[r][q] + ecum[i] * yh[r][q];
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

int smem_bytes_f32(int p, int n, int chunk) {
  const int ldt = chunk + 1;
  return (2 * n * ldt + chunk * ldt + chunk * p + n * p + 3 * chunk) *
         static_cast<int>(sizeof(float));
}

// --------------------------------------------------------------- bf16 ----
// The kernel is compiled for P padded to PT 16-column tiles and N to NK
// 16-row tiles, PT in {1, 2, 4} and NK in {1, 2, 4, 8} (the next power of
// two; the pad is zero-filled), so every fragment loop has fixed bounds.
constexpr int MAX_THREADS = 32 * (MAX_N / 16);   // = 32 * (MAX_T / 16)

__host__ __device__ __forceinline__ int tiles16(int v) {
  int t = 1;
  while (16 * t < v) t *= 2;
  return t;
}

// Rows [t0, t0 + rows) of a (len x d) operand into a [rows][LD] tile of
// DP columns: 16-byte cp.async copies (d a multiple of 8), zeros past len
// and in the columns [d, DP).
template <int DP, int LD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long stride, int t0, int rows,
                                           int len, int d) {
  constexpr int CH = DP / 8;
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
    const int r = idx / CH, col = 8 * (idx % CH);
    const bool ok = t0 + r < len && col < d;
    cp_async16(dst + r * LD + col, ok ? src + (t0 + r) * stride + col : src,
               ok);
  }
}

// ldmatrix row addresses: lane l supplies row l % 8 of matrix l / 8.  The
// "a" pattern gives an A fragment from a row-major tile (and, transposed,
// the B fragments of two n8 tiles from a [k][n] tile); the "b" pattern the
// B fragments of two n8 tiles from an [n][k] tile (and, transposed, an A
// fragment from a [k][m] tile).
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + 8 * ((lane >> 3) & 1); }
__device__ __forceinline__ int a_col(int lane) { return 8 * (lane >> 4); }
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + 8 * (lane >> 4); }
__device__ __forceinline__ int b_col(int lane) { return 8 * ((lane >> 3) & 1); }

// acc[nt] += (lo + mid + hi) B for the 2 PT n8 tiles, the B fragments of
// tile pair dp in bf[dp].  The pieces go smallest first, each over every
// tile before the next, so neighbouring mma.sync write different
// accumulators.
template <int PT>
__device__ __forceinline__ void mma_pieces(float (&acc)[2 * PT][4],
                                           const uint32_t (&lo)[4],
                                           const uint32_t (&mid)[4],
                                           const uint32_t (&hi)[4],
                                           const uint32_t (&bf)[PT][4]) {
#pragma unroll
  for (int piece = 0; piece < 3; ++piece) {
    const uint32_t(&a)[4] = piece == 0 ? lo : piece == 1 ? mid : hi;
#pragma unroll
    for (int dp = 0; dp < PT; ++dp) {
      mma_bf16(acc[2 * dp], a, bf[dp][0], bf[dp][1]);
      mma_bf16(acc[2 * dp + 1], a, bf[dp][2], bf[dp][3]);
    }
  }
}

// Flags between the blocks of one series: the state after a chunk is
// published with a release store and read after an acquire load.
__device__ __forceinline__ void flag_release(int* f) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(f), "r"(1)
               : "memory");
}
__device__ __forceinline__ int flag_acquire(const int* f) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v) : "l"(f) : "memory");
  return v;
}

// Spins until *f is set.  The block that sets it holds an earlier ticket,
// so it is running or done; after about 2^32 cycles (seconds) the kernel
// traps rather than hang the card.
__device__ __forceinline__ void wait_flag(const int* f) {
  const long long start = clock64();
  while (flag_acquire(f) == 0) {
    if (clock64() - start > (1LL << 32)) __trap();
    __nanosleep(64);
  }
}

// y += (C B^T * L) x over the keys [j0, j0 + 16) for the warp's 16 rows from
// i0; `diag` masks the upper triangle (the step j0 = i0).
template <int PT, int NK>
__device__ __forceinline__ void causal_step(float (&acc)[2 * PT][4],
                                             const uint32_t (&cf)[NK][4],
                                             const bf16* Bs, const bf16* Xs,
                                             const float* cum,
                                             const float (&cum_i)[2], int i0,
                                             int j0, bool diag, int lane) {
  constexpr int LDB = 16 * NK + 8, LDX = 16 * PT + 8;
  const int g = lane / 4, t = lane % 4;
  float sc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t kf[4];
    ldmatrix_x4(kf, Bs + (j0 + b_row(lane)) * LDB + 16 * kk + b_col(lane));
    mma_bf16(sc[0], cf[kk], kf[0], kf[1]);
    mma_bf16(sc[1], cf[kk], kf[2], kf[3]);
  }
  // decay, rows i0 + g (e = 0, 1) and i0 + g + 8 (e = 2, 3)
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1), j = j0 + 8 * nt + 2 * t + (e & 1);
      const float v = sc[nt][e] * expf(cum_i[e >> 1] - cum[j]);
      sc[nt][e] = diag && i < j ? 0.f : v;
    }
  uint32_t hi[4], mid[4], lo[4];
  split3(sc[0][0], sc[0][1], hi[0], mid[0], lo[0]);
  split3(sc[0][2], sc[0][3], hi[1], mid[1], lo[1]);
  split3(sc[1][0], sc[1][1], hi[2], mid[2], lo[2]);
  split3(sc[1][2], sc[1][3], hi[3], mid[3], lo[3]);
  uint32_t xf[PT][4];
#pragma unroll
  for (int dp = 0; dp < PT; ++dp)
    ldmatrix_x4_trans(xf[dp], Xs + (j0 + a_row(lane)) * LDX + 16 * dp + a_col(lane));
  mma_pieces<PT>(acc, lo, mid, hi, xf);
}

// y of the 16 chunk rows from i0 of series s (y already offset to it):
// diag(exp(cum)) C h_in, then (C B^T * L) x.
template <int PT, int NK>
__device__ __forceinline__ void chunk_rows(const bf16* Cs, const bf16* Bs,
                                           const bf16* Xs, const bf16* Hs,
                                           const float* cum, bf16* yb, int i0,
                                           int ci, int t0, int len, int p,
                                           int lane) {
  constexpr int NP = 16 * NK, LDB = NP + 8, LDX = 16 * PT + 8;
  const int g = lane / 4, t = lane % 4;
  uint32_t cf[NK][4];   // this warp's C rows as A fragments
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    ldmatrix_x4(cf[kk], Cs + (i0 + a_row(lane)) * LDB + 16 * kk + a_col(lane));
  float acc[2 * PT][4];
#pragma unroll
  for (int nt = 0; nt < 2 * PT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const float cum_i[2] = {cum[i0 + g], cum[i0 + g + 8]};

  // y = diag(exp(cum)) C h_in, h_in exact as three bf16 pieces
  if (ci > 0) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int piece = 2; piece >= 0; --piece) {   // lo, mid, hi
        uint32_t hf[PT][4];
#pragma unroll
        for (int dp = 0; dp < PT; ++dp)
          ldmatrix_x4_trans(hf[dp], Hs + (piece * NP + 16 * kk + a_row(lane)) * LDX +
                                        16 * dp + a_col(lane));
#pragma unroll
        for (int dp = 0; dp < PT; ++dp) {
          mma_bf16(acc[2 * dp], cf[kk], hf[dp][0], hf[dp][1]);
          mma_bf16(acc[2 * dp + 1], cf[kk], hf[dp][2], hf[dp][3]);
        }
      }
    }
    const float e0 = expf(cum_i[0]), e1 = expf(cum_i[1]);
#pragma unroll
    for (int nt = 0; nt < 2 * PT; ++nt) {
      acc[nt][0] *= e0;
      acc[nt][1] *= e0;
      acc[nt][2] *= e1;
      acc[nt][3] *= e1;
    }
  }

  // y += (C B^T * L) x: the key steps below the diagonal, then the
  // diagonal step, masked
  for (int j0 = 0; j0 < i0; j0 += 16)
    causal_step<PT, NK>(acc, cf, Bs, Xs, cum, cum_i, i0, j0, false, lane);
  causal_step<PT, NK>(acc, cf, Bs, Xs, cum, cum_i, i0, i0, true, lane);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t0 + i0 + g + 8 * r;
    if (row >= len) continue;
#pragma unroll
    for (int nt = 0; nt < 2 * PT; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col < p)
        *reinterpret_cast<__nv_bfloat162*>(yb + static_cast<long long>(row) * p + col) =
            __floats2bfloat162_rn(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
}

// One block per (series, chunk), in ticket order (chunk-major).  Shared
// memory: C, B and x tiles, h_in as three bf16 tiles and in f32, cum and w.
template <int PT, int NK>
__global__ void __launch_bounds__(MAX_THREADS)
ssd_chunk_kernel(const bf16* __restrict__ x, const bf16* __restrict__ b,
                 const bf16* __restrict__ c, const float* __restrict__ a,
                 bf16* __restrict__ y, float* __restrict__ state,
                 float* __restrict__ hs, int* __restrict__ flags, int bh,
                 int len, int p, int n, int chunk, Strides xs, Strides bs,
                 Strides cs, Strides as) {
  constexpr int PP = 16 * PT, NP = 16 * NK, LDB = NP + 8, LDX = PP + 8;
  constexpr int LDH = PP + 8;                       // f32 h_in row pitch
  constexpr int WARPS = MAX_THREADS / 32;
  constexpr int ITEMS = (NK * PT + WARPS - 1) / WARPS;   // Hc tiles a warp
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  bf16* Cs = reinterpret_cast<bf16*>(ssd_smem);   // [chunk][LDB]
  bf16* Bs = Cs + chunk * LDB;                    // [chunk][LDB]
  bf16* Xs = Bs + chunk * LDB;                    // [chunk][LDX]
  bf16* Hs = Xs + chunk * LDX;                    // [3][NP][LDX]: hi, mid, lo
  float* Hf = reinterpret_cast<float*>(Hs + 3 * NP * LDX);   // [NP][LDH]
  float* cum = Hf + NP * LDH;                                // [chunk]
  float* w = cum + chunk;                                    // [chunk]
  __shared__ int ticket;

  const int nc = (len + chunk - 1) / chunk;
  if (threadIdx.x == 0) ticket = atomicAdd(flags + bh * nc, 1);
  __syncthreads();
  const int s = ticket % bh, ci = ticket / bh;
  const int t0 = ci * chunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // fragment row, column pair
  stage_rows<NP, LDB>(Bs, b + s * bs.bh, bs.l, t0, chunk, len, n);
  stage_rows<PP, LDX>(Xs, x + s * xs.bh, xs.l, t0, chunk, len, p);
  stage_rows<NP, LDB>(Cs, c + s * cs.bh, cs.l, t0, chunk, len, n);
  // h_in, the state after chunk ci - 1, which that chunk's block published
  // (it holds an earlier ticket, and with more series than blocks in
  // flight it is done): fetched while the inputs are in flight
  const long long np = static_cast<long long>(n) * p;
  float* hseries = hs + static_cast<long long>(s) * (nc - 1) * np;
  if (ci > 0) {
    if (threadIdx.x == 0) wait_flag(flags + s * nc + ci - 1);
    __syncthreads();
    const float* hb = hseries + (ci - 1) * np;
    constexpr int CH = PP / 4;
    for (int idx = threadIdx.x; idx < NP * CH; idx += blockDim.x) {
      const int r = idx / CH, col = 4 * (idx % CH);
      const bool ok = r < n && col < p;
      cp_async16(Hf + r * LDH + col, ok ? hb + r * p + col : hb, ok);
    }
  }
  cp_async_commit();
  if (warp == 0) chunk_cumsum(cum, a + s * as.bh, as.l, t0, len, chunk);
  __syncthreads();
  const float total = cum[chunk - 1];
  for (int j = threadIdx.x; j < chunk; j += blockDim.x)
    w[j] = expf(total - cum[j]);
  cp_async_wait_all();
  __syncthreads();

  // Hc = (diag(w) B)^T x.  Warp `warp` owns the 16 x 16 tiles idx = warp +
  // WARPS it of the (NP x PP) state: rows m0 = 16 (idx % NK), the same for
  // all its tiles as NK divides WARPS, columns 16 (idx / NK).
  const int m0 = 16 * (warp % NK);
  float hacc[ITEMS][2][4];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[it][h][e] = 0.f;
  for (int k0 = 0; k0 < chunk; k0 += 16) {
    // A[m][k] = w_k B[k][m]: ldmatrix.trans of the [k][n] tile; a0, a1
    // hold steps k0 + 2t, k0 + 2t + 1, a2, a3 the same plus 8
    uint32_t bf[4], hi[4], mid[4], lo[4];
    ldmatrix_x4_trans(bf, Bs + (k0 + b_row(lane)) * LDB + m0 + b_col(lane));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + 2 * t + 8 * (e >> 1);
      const float2 v = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&bf[e]));
      split3(v.x * w[k], v.y * w[k + 1], hi[e], mid[e], lo[e]);
    }
    uint32_t xf[ITEMS][4];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int idx = warp + WARPS * it;
      if (idx < NK * PT)
        ldmatrix_x4_trans(xf[it], Xs + (k0 + a_row(lane)) * LDX + 16 * (idx / NK) +
                                      a_col(lane));
    }
#pragma unroll
    for (int piece = 0; piece < 3; ++piece) {
      const uint32_t(&pa)[4] = piece == 0 ? lo : piece == 1 ? mid : hi;
#pragma unroll
      for (int it = 0; it < ITEMS; ++it)
        if (warp + WARPS * it < NK * PT) {
          mma_bf16(hacc[it][0], pa, xf[it][0], xf[it][1]);
          mma_bf16(hacc[it][1], pa, xf[it][2], xf[it][3]);
        }
    }
  }

  // the state after this chunk, exp(total) h_in + Hc: into the scratch for
  // the next chunk's block (the flag that hands it over is set at the end),
  // or the final state
  float* hout = ci < nc - 1 ? hseries + ci * np
                            : state == nullptr ? nullptr : state + s * np;
  if (hout != nullptr) {
    const float decay = expf(total);
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int idx = warp + WARPS * it;
      if (idx >= NK * PT) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = m0 + g + 8 * r, col = 16 * (idx / NK) + 8 * h + 2 * t;
          if (row >= n || col >= p) continue;
          const float2 hin = ci > 0 ? *reinterpret_cast<const float2*>(Hf + row * LDH + col)
                                    : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(hout + row * p + col) = make_float2(
              __fadd_rn(__fmul_rn(decay, hin.x), hacc[it][h][2 * r]),
              __fadd_rn(__fmul_rn(decay, hin.y), hacc[it][h][2 * r + 1]));
        }
    }
  }
  if (ci > 0) {   // h_in as three bf16 tiles
    for (int idx = threadIdx.x; idx < NP * PP / 2; idx += blockDim.x) {
      const int r = idx / (PP / 2), col = 2 * (idx % (PP / 2));
      const float2 v = *reinterpret_cast<const float2*>(Hf + r * LDH + col);
      uint32_t hi, mid, lo;
      split3(v.x, v.y, hi, mid, lo);
      *reinterpret_cast<uint32_t*>(Hs + r * LDX + col) = hi;
      *reinterpret_cast<uint32_t*>(Hs + (NP + r) * LDX + col) = mid;
      *reinterpret_cast<uint32_t*>(Hs + (2 * NP + r) * LDX + col) = lo;
    }
    __syncthreads();
  }

  // y: warps below chunk / 16 own 16 chunk rows each, dealt so that warps
  // w and w + 4, which share a sub-partition of the SM, together take as
  // many causal steps (tile + 1 each) as any other pair
  const int nw = chunk / 16, half = nw / 2;
  if (warp < nw) {
    const int i0 = 16 * (warp < half ? warp : nw - 1 - (warp - half));
    chunk_rows<PT, NK>(Cs, Bs, Xs, Hs, cum, y + static_cast<long long>(s) * len * p,
                       i0, ci, t0, len, p, lane);
  }
  if (ci < nc - 1) {   // hand the state over: every store of it is visible
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) flag_release(flags + s * nc + ci);
  }
}

int smem_bytes_bf16(int p, int n, int chunk) {
  const int pp = 16 * tiles16(p), np = 16 * tiles16(n);
  const int ldb = np + 8, ldx = pp + 8;
  return (2 * chunk * ldb + chunk * ldx + 3 * np * ldx) *
             static_cast<int>(sizeof(bf16)) +
         (np * (pp + 8) + 2 * chunk) * static_cast<int>(sizeof(float));
}

// Lets `kernel` take `smem` bytes of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

struct Bf16Args {
  const bf16 *x, *b, *c;
  const float* a;
  bf16* y;
  float *state, *hs;
  int* flags;
  int bh, len, p, n, chunk;
  Strides xs, bs, cs, as;
};

// Clears the flags and the ticket counter, then launches the kernel;
// returns the first cudaError.
template <int PT, int NK>
cudaError_t launch_bf16(const Bf16Args& g, cudaStream_t stream) {
  const int nc = (g.len + g.chunk - 1) / g.chunk;
  const int smem = smem_bytes_bf16(g.p, g.n, g.chunk);
  cudaError_t err = allow_smem(ssd_chunk_kernel<PT, NK>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(g.bh) * nc;
  err = cudaMemsetAsync(g.flags, 0, (blocks + 1) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<PT, NK><<<static_cast<unsigned>(blocks), MAX_THREADS, smem,
                             stream>>>(
      g.x, g.b, g.c, g.a, g.y, g.state, g.hs, g.flags, g.bh, g.len, g.p, g.n,
      g.chunk, g.xs, g.bs, g.cs, g.as);
  return cudaGetLastError();
}

template <int PT>
cudaError_t launch_bf16_n(const Bf16Args& g, cudaStream_t stream) {
  switch (tiles16(g.n)) {
    case 1: return launch_bf16<PT, 1>(g, stream);
    case 2: return launch_bf16<PT, 2>(g, stream);
    case 4: return launch_bf16<PT, 4>(g, stream);
    case 8: return launch_bf16<PT, 8>(g, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ssd
}  // namespace repro

// Shared memory one block of the f32 kernel needs (bytes).
extern "C" int repro_ssd_scan_smem_bytes(int p, int n, int chunk) {
  return repro::ssd::smem_bytes_f32(p, n, chunk);
}

// Shared memory one block of the bf16 kernel needs (bytes).
extern "C" int repro_ssd_chunked_smem_bytes(int p, int n, int chunk) {
  return repro::ssd::smem_bytes_bf16(p, n, chunk);
}

// f32: x (bh, len, p), b/c (bh, len, n), unit stride over the last axis and
// the given element strides over (series, step); a: (bh, len) f32
// log-decay; y: (bh, len, p) contiguous; state: (bh, n, p) f32 contiguous,
// or null.  p <= 64, n <= 128, chunk a multiple of 16 up to 128 and the
// shared-memory size are checked by the Python wrapper.  Returns
// cudaGetLastError.
extern "C" int repro_ssd_scan(const void* x, const void* b, const void* c,
                              const void* a, void* y, void* state, int bh,
                              int len, int p, int n, int chunk,
                              long long xsb, long long xsl, long long bsb,
                              long long bsl, long long csb, long long csl,
                              long long asb, long long asl, void* stream) {
  using namespace repro::ssd;
  const Strides xs{xsb, xsl}, bs{bsb, bsl}, cs{csb, csl}, as{asb, asl};
  const int smem = smem_bytes_f32(p, n, chunk);
  cudaError_t err = allow_smem(ssd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<<<bh, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(a),
      static_cast<float*>(y), static_cast<float*>(state), len, p, n, chunk, xs,
      bs, cs, as);
  return static_cast<int>(cudaGetLastError());
}

// bf16: the same operands in bf16 (a and state f32), plus the scratch the
// wrapper allocates: hs (bh, nc - 1, n, p) f32, the state after each chunk
// but the last, and flags (bh nc + 1) int32, nc the number of chunks.  p,
// n and the (series, step) strides multiples of 8, 16-byte aligned
// pointers, p <= 64, n <= 128, chunk a multiple of 16 up to 128 and the
// shared-memory size are checked by the Python wrapper.  Returns the first
// cudaError.
extern "C" int repro_ssd_scan_bf16(const void* x, const void* b, const void* c,
                                   const void* a, void* y, void* state,
                                   void* hs, void* flags, int bh, int len,
                                   int p, int n, int chunk, long long xsb,
                                   long long xsl, long long bsb, long long bsl,
                                   long long csb, long long csl, long long asb,
                                   long long asl, void* stream) {
  using namespace repro::ssd;
  using repro::bf16;
  const Bf16Args args{static_cast<const bf16*>(x), static_cast<const bf16*>(b),
                      static_cast<const bf16*>(c), static_cast<const float*>(a),
                      static_cast<bf16*>(y), static_cast<float*>(state),
                      static_cast<float*>(hs), static_cast<int*>(flags),
                      bh, len, p, n, chunk, Strides{xsb, xsl}, Strides{bsb, bsl},
                      Strides{csb, csl}, Strides{asb, asl}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tiles16(p)) {
    case 1: return static_cast<int>(launch_bf16_n<1>(args, st));
    case 2: return static_cast<int>(launch_bf16_n<2>(args, st));
    case 4: return static_cast<int>(launch_bf16_n<4>(args, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
