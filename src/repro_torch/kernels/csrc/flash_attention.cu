// Flash attention: O = softmax(Q K^T / sqrt(D)) V with an online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel /
// flash_attention (Pallas, TPU).  That kernel computes P V with P in f32
// and V widened exactly to f32; both kernels here keep P exact.
//
// What bounds it on the H100: causal attention does S (S + 1) D flops per
// (batch, head) in each of its two products (the causal half) against
// 2 (S + 2 Sk) D bytes of bf16 operands, hundreds of flops per byte, so
// arithmetic bounds it.  Q K^T has two bf16 operands, which the bf16 tensor
// cores multiply exactly into an f32 accumulator (989 TFLOP/s).  P V has the
// f32 operand P; split exactly into three bf16 pieces (below) it is three
// bf16 tensor-core products.  At the served Zamba2 shape (4, 32, 2048, 80)
// each product is 4.3e10 flops: 0.0434 ms + 3 x 0.0434 ms = 0.174 ms, bound
// by operations (the bytes take 0.050 ms).
//
// bf16 operands: flash_mma_kernel.  One block of 4 warps owns one 64-row
// query tile of one (batch, query head); each warp owns 16 query rows, and
// the key axis (the TPU grid's sequential axis) is a loop inside the block,
// 64 keys a step, stopping at the causal limit (the TPU kernel's pl.when
// guard).  Query tiles launch in reverse order, so the longest causal rows
// start first.  The head dimension is padded with zeros to DP, the next
// multiple of 16 (a template parameter, so the fragment arrays are static);
// zero columns add nothing to either product.
// - Q is scaled by 1/sqrt(D) in f32 and rounded to bf16 (the TPU wrapper's
//   q * scale in q's dtype), then held in registers as mma A fragments,
//   loaded once with ldmatrix from a staging tile.
// - K and V tiles go through a two-stage ring in shared memory, filled by
//   16-byte cp.async copies (zero-fill for keys past Sk and for the pad
//   columns, no host-side padding): tile j + 1 is in flight while tile j is
//   multiplied.  Rows are padded to DP + 8 bf16 so ldmatrix has no bank
//   conflicts.  Operands are read through (batch, head, row) strides, so
//   the model's (B, S, H, D) storage needs no transpose; GQA reads KV head
//   h / (Hq / Hkv) in place.
// - S = Q K^T: mma.sync m16n8k16 (bf16 in, f32 accumulate), K fragments
//   from ldmatrix; a warp's 16 x 64 S tile is 8 n8 tiles in registers.
// - The online softmax stays in registers: row max reduced over the 4
//   threads of a quad with shuffles, masked keys set to -1e30 (as the TPU
//   kernel does) on the diagonal and ragged last tiles only, exponentials
//   in f32 (exp2 with log2(e) applied to the f32 scores).
// - P V: the C fragments of two neighbouring n8 tiles of S are the A
//   fragment of one k16 step, so P never touches shared memory.  Each f32
//   p is split as hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid),
//   with hi + mid + lo = p exactly (for p above about 1e-30); each piece
//   times a bf16 v is exact in f32, so three mma.sync against the same V
//   fragment (ldmatrix.trans from the [key][d] tile), smallest piece first,
//   into one f32 accumulator compute P V with P exact.
// - The epilogue divides by max(l, 1e-30), rounds to bf16 and stores
//   through the output strides; query rows past S are not written.
//
// f32 operands (the checking path): flash_kernel, plain FMA in f32.  One
// block of 256 threads (16 x 16) owns one 64-row query tile; K and V tiles
// are staged in shared memory (K transposed, odd row stride), S = Q K^T is
// held in registers (4 x 4 per thread), the running max and denominator in
// registers (reduced over the 16 threads of a half-warp), the f32 output
// tile (4 x D/16 per thread) in registers until the end, and P goes through
// shared memory in f32.  Masking, the causal stop, GQA and strides are as
// above.
#include "mma_bf16.cuh"

namespace repro {
namespace flash {

constexpr int BKV = 64;        // keys per step
constexpr float NEG_INF = -1e30f;

struct Strides {   // element strides of a (B, H, S, D) operand; D is unit
  long long b, h, s;
};

// ---------------------------------------------------------------- f32 ----
constexpr int BQ = 64;         // query rows per block
constexpr int MAX_D = 128;
constexpr int THREADS = 256;   // 16 x 16
constexpr int LD = 65;         // odd row stride of the transposed tiles
constexpr int DC = MAX_D / 16; // output columns per thread (stride 16)

__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int hq,
             int group, int s, int sk, int d, int causal, float scale,
             Strides qs, Strides ks, Strides vs, Strides os) {
  extern __shared__ float smem[];
  const int dpad = (d + 15) / 16 * 16;
  float* Qs = smem;              // [d][LD]:    Qs[dd*LD + i] = scaled q[q0+i][dd]
  float* Ks = Qs + d * LD;       // [d][LD]:    Ks[dd*LD + j] = k[k0+j][dd]
  float* Vs = Ks + d * LD;       // [BKV][dpad]: Vs[j*dpad + dd] = v[k0+j][dd]
  float* Ps = Vs + BKV * dpad;   // [BKV][LD]:  Ps[j*LD + i] = p[i][j]

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq, hk = h / group;
  const int q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  for (int idx = threadIdx.x; idx < BQ * d; idx += THREADS) {
    const int i = idx / d, dd = idx % d;
    float val = 0.f;
    if (q0 + i < s) val = qb[(q0 + i) * qs.s + dd] * scale;
    Qs[dd * LD + i] = val;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  const int k_end = causal ? min(sk, q0 + BQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += BKV) {
    __syncthreads();   // the previous step's readers of Ks, Vs, Ps are done
    for (int idx = threadIdx.x; idx < BKV * d; idx += THREADS) {
      const int j = idx / d, dd = idx % d;
      Ks[dd * LD + j] = k0 + j < sk ? kb[(k0 + j) * ks.s + dd] : 0.f;
    }
    for (int idx = threadIdx.x; idx < BKV * dpad; idx += THREADS) {
      const int j = idx / dpad, dd = idx % dpad;
      Vs[idx] = (k0 + j < sk && dd < d) ? vb[(k0 + j) * vs.s + dd] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float qa[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = Qs[dd * LD + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[dd * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(qa[r], kv[c], sc[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        const bool valid = j < sk && (!causal || i >= j);
        if (!valid) sc[r][c] = NEG_INF;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float rescale = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[r][c] = expf(sc[r][c] - m_new);
        psum += sc[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[r] = rescale * l[r] + psum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= rescale;
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[(tx + 16 * c) * LD + ty + 16 * r] = sc[r][c];
    }
    __syncthreads();

    for (int j = 0; j < BKV; ++j) {
      float pa[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[r] = Ps[j * LD + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        if (16 * c < dpad) {
          const float vv = Vs[j * dpad + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pa[r], vv, acc[r][c]);
        }
      }
    }
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= s) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dd = tx + 16 * c;
      if (dd < d) ob[i * os.s + dd] = acc[r][c] / den;
    }
  }
}

int smem_bytes_f32(int d) {
  const int dpad = (d + 15) / 16 * 16;
  return (2 * d * LD + BKV * dpad + BKV * LD) * static_cast<int>(sizeof(float));
}

// --------------------------------------------------------------- bf16 ----
constexpr int MMA_WARPS = 4;
constexpr int MMA_BQ = 16 * MMA_WARPS;      // query rows per block, 16 a warp
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr float LOG2E = 1.4426950408889634f;

// (x, y) rounded to bf16 once more after an f32 product with `scale`.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t r, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
  return bits(__floats2bfloat162_rn(f.x * scale, f.y * scale));
}

// Rows [row0, row0 + ROWS) of a (rows x d) operand into a [ROWS][DP + 8]
// tile: 16-byte cp.async copies, zeros past `rows` and in the pad columns.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0, int rows,
                                          int d) {
  constexpr int CH = DP / 8, LDS = DP + 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += MMA_THREADS) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = row0 + r < rows && 8 * c < d;
    cp_async16(dst + r * LDS + 8 * c,
               ok ? src + (row0 + r) * stride + 8 * c : src, ok);
  }
}

template <int DP>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int hq,
                 int group, int s, int sk, int d, int causal, float scale,
                 Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int LDS = DP + 8;          // row pitch (bf16): 16 B rows, odd
  constexpr int TILE = BKV * LDS;      // one K or V tile
  constexpr int KSTEPS = DP / 16;      // k16 steps of Q K^T
  constexpr int NT = DP / 8;           // n8 tiles of P V
  static_assert(MMA_BQ <= 2 * BKV, "the Q tile is staged in stage 1");
  // two stages of [K tile][V tile]; Q is staged in stage 1, which is free
  // until tile 1 is issued
  extern __shared__ __align__(16) unsigned char flash_smem[];
  bf16* const ring = reinterpret_cast<bf16*>(flash_smem);
  bf16* const Qs = ring + 2 * TILE;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;           // fragment row, column pair
  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MMA_BQ;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  load_tile<DP, MMA_BQ>(Qs, qb, qs.s, q0, s, d);
  load_tile<DP, BKV>(ring, kb, ks.s, 0, sk, d);
  load_tile<DP, BKV>(ring + TILE, vb, vs.s, 0, sk, d);
  cp_async_commit();

  // ldmatrix row addresses: lane l supplies row l % 8 of matrix l / 8.
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);

  uint32_t qf[KSTEPS][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // rows g, g + 8

  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    ldmatrix_x4(qf[kk], Qs + (16 * warp + a_row) * LDS + 16 * kk + a_col);
#pragma unroll
    for (int e = 0; e < 4; ++e) qf[kk][e] = scale_bf16x2(qf[kk][e], scale);
  }

  const int k_end = causal ? min(sk, q0 + MMA_BQ) : sk;
  const int steps = (k_end + BKV - 1) / BKV;
  for (int j = 0; j < steps; ++j) {
    cp_async_wait_all();
    // tile j has landed, and every warp is done with stage (j + 1) % 2
    // (with the Q staging tile, at j = 0)
    __syncthreads();
    if (j + 1 < steps) {
      bf16* next = ring + ((j + 1) % 2) * 2 * TILE;
      load_tile<DP, BKV>(next, kb, ks.s, (j + 1) * BKV, sk, d);
      load_tile<DP, BKV>(next + TILE, vb, vs.s, (j + 1) * BKV, sk, d);
      cp_async_commit();
    }
    const bf16* Kt = ring + (j % 2) * 2 * TILE;
    const bf16* Vt = Kt + TILE;

    // S = Q K^T: 8 n8 tiles of 16 x 8 per warp
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (16 * np + b_row) * LDS + 16 * kk + b_col);
        mma_bf16(sc[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // mask the diagonal tile and the ragged last tile
    const int k0 = j * BKV;
    if (k0 + BKV > sk || (causal && k0 + BKV > q0 + 1)) {
      const int row = q0 + 16 * warp + g;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          if (key >= sk || (causal && key > row + 8 * (e >> 1)))
            sc[n][e] = NEG_INF;
        }
    }

    // online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float alpha[2], ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = exp2f((m[r] - m_new) * LOG2E);
      ml[r] = m_new * LOG2E;
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = exp2f(fmaf(sc[n][e], LOG2E, -ml[e >> 1]));
        psum[e >> 1] += sc[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + psum[r];  // quad-partial
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V, P exact as three bf16 pieces
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t hi[4], mid[4], lo[4];
      split3(sc[2 * kk][0], sc[2 * kk][1], hi[0], mid[0], lo[0]);
      split3(sc[2 * kk][2], sc[2 * kk][3], hi[1], mid[1], lo[1]);
      split3(sc[2 * kk + 1][0], sc[2 * kk + 1][1], hi[2], mid[2], lo[2]);
      split3(sc[2 * kk + 1][2], sc[2 * kk + 1][3], hi[3], mid[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (16 * kk + a_row) * LDS + 16 * dp + a_col);
        mma_bf16(acc[2 * dp], lo, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], lo, vf[2], vf[3]);
        mma_bf16(acc[2 * dp], mid, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], mid, vf[2], vf[3]);
        mma_bf16(acc[2 * dp], hi, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], hi, vf[2], vf[3]);
      }
    }
  }

  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    den = fmaxf(den, 1e-30f);
    const int i = q0 + 16 * warp + g + 8 * r;
    if (i >= s) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (8 * n < d)
        *reinterpret_cast<__nv_bfloat162*>(ob + i * os.s + 8 * n + 2 * t) =
            __floats2bfloat162_rn(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
    }
  }
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* o, int batch,
               int hq, int hkv, int s, int sk, int d, int causal, Strides qs,
               Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  constexpr int smem = 4 * BKV * (DP + 8) * static_cast<int>(sizeof(bf16));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(batch * hq, (s + MMA_BQ - 1) / MMA_BQ);
  flash_mma_kernel<DP><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), hq, hq / hkv, s, sk,
      d, causal, 1.0f / sqrtf(static_cast<float>(d)), qs, ks, vs, os);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
}  // namespace repro

// q: (batch, hq, s, d), k/v: (batch, hkv, sk, d), o: (batch, hq, s, d), all
// f32 (is_bf16 = 0, flash_kernel) or all bf16 (is_bf16 = 1,
// flash_mma_kernel),
// unit stride over d and the given element strides over (batch, head, row).
// Checked by the Python wrapper: d <= 128, hq % hkv == 0, and for bf16 a
// d and (batch, head, row) strides that are multiples of 8 elements and
// 16-byte-aligned pointers.  Returns cudaGetLastError.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int batch, int hq,
    int hkv, int s, int sk, int d, int causal, int is_bf16, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh,
    long long oss, void* stream) {
  using namespace repro::flash;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch ((d + 15) / 16) {
#define REPRO_FLASH_DP(n)                                                    \
  case n:                                                                    \
    return launch_mma<16 * n>(q, k, v, o, batch, hq, hkv, s, sk, d, causal,  \
                              qs, ks, vs, os, st);
      REPRO_FLASH_DP(1) REPRO_FLASH_DP(2) REPRO_FLASH_DP(3) REPRO_FLASH_DP(4)
      REPRO_FLASH_DP(5) REPRO_FLASH_DP(6) REPRO_FLASH_DP(7) REPRO_FLASH_DP(8)
#undef REPRO_FLASH_DP
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int smem = smem_bytes_f32(d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(batch * hq, (s + BQ - 1) / BQ);
  flash_kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hq / hkv, s,
      sk, d, causal, 1.0f / sqrtf(static_cast<float>(d)), qs, ks, vs, os);
  return static_cast<int>(cudaGetLastError());
}
