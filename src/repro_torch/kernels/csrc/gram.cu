// Gram matrices of a tall operand A (M x N, M >> N) in one read of A:
// the Hermitian G = A^H A of complex64 A, and G = A^T A of f32 A.
//
// Replaces: src/repro/kernels/gram.py, gram_complex (planar form: two real
// Grams plus the tiled_matmul cross term, 3 Pallas calls) and
// _gram_kernel / gram (Pallas, TPU).  The complex and the real Gram are two
// instantiations of one kernel; the real one drops the imaginary
// accumulators.
//
// What bounds it on the H100: the Hermitian upper triangle needs 4 M N^2
// flops (Re G_ij = sum ar_i ar_j + ai_i ai_j for the N (N + 1) / 2 entries
// i <= j, Im G_ij = sum ar_i ai_j - ai_i ar_j for the N (N - 1) / 2 entries
// i < j, 4 flops a row each) against 8 (M N + N^2) bytes; at the main
// path's (82,944 x 72) that is 1.72e9 f32 flops, 0.0257 ms at 67 TFLOP/s,
// against 0.0143 ms for the bytes: the FMA rate bounds it.
// f32 operands are never rounded (no TF32, no tensor cores): plain FFMA.
// The real Gram, M N (N + 1) flops on 4 (M N + N^2) bytes, sits at the
// ridge; its bytes bound it by a small margin.
//
// Design, against the three faults of the planar form it replaces:
// 1. Wasted FMAs.  Tiles are fitted to N = 72, not to 64: a thread owns a
//    6 x 6 tile of G, a block tile is 72 x 72 (12 x 12 thread tiles), and a
//    block runs only the 78 thread tiles on or above the diagonal (thread
//    tiles wholly past N are not enumerated).  At N = 72 that is
//    78 x 36 x 4 = 11,232 FMAs a row of A for the 10,368 the Hermitian upper
//    triangle needs (1.08x; the planar form ran 40,960, 3.95x); at N = 36,
//    21 tiles, 3,024 FMAs for 2,592 (1.17x).  Larger N runs the upper
//    triangle of 72 x 72 block tiles: a diagonal block tile as above, an
//    off-diagonal one as two blocks of 6 x 12 thread tiles.
// 2. A read four times.  Each block streams its rows of the c64 storage
//    once, in place, as interleaved (re, im) f32 pairs: no .real/.imag
//    copies, no second pass over A.  Rows go global -> shared memory by
//    cp.async (16 bytes when the row length and the pointer allow, else one
//    element; only the columns its thread tiles read) in a 3-stage ring of
//    64 rows (36 KB a stage at N = 72), so the next rows land while the
//    current ones are multiplied.
// 3. Host ops.  One call is two launches (this kernel and its reduce) and
//    two torch.empty; G comes out as c64 directly.
//
// Per row and thread: the j side is three 16-byte shared loads (6 complex),
// the i side three more; 144 FMAs on 12 loaded floats a side, 24 FMAs per
// 16-byte load (real: 36 FMAs on six 8-byte loads).  The j loads of a
// warp's consecutive thread tiles are 48 bytes apart (8 lanes of a quarter
// warp on 32 distinct banks); the i loads are mostly broadcasts.  A block
// is 256 threads in groups of one thread per active tile, each group over
// its own rows of a stage (rows g, g + G, ...): at N = 72, 3 groups of 78
// (234 threads busy); at N = 36, 12 groups of 21; at N = 1, 64 of 1.
// Registers: the thread tile is 72 accumulators; the compiler takes 168
// registers without spilling, so one block per SM (capped at 128 for two
// blocks per SM it spills, 204 bytes).  Shared memory: the ring, 110,592
// bytes at N <= 72 complex (221,184 with two column ranges, N > 72); it
// also holds the groups' sums at the end.
//
// Split over M and determinism: M is cut into fixed row ranges of whole
// 64-row stages, up to one block per SM (plan(): the caller passes the SM
// count, the splits follow from M and N here).  Inside a block the groups' sums
// are added as a tree in a fixed order through shared memory; each block
// writes a private partial of the packed upper triangle.  The reduce pass
// sums the partials in a fixed order (8 lanes of strided splits, then the
// lanes in order) and writes G with Re mirrored, Im mirrored negated and
// the diagonal's Im exactly 0: G is exactly Hermitian (symmetric), and a
// run repeats bit for bit.  No atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace repro {
namespace gram {
namespace {   // internal linkage: nothing here is shared with another library

constexpr int MAX_DEVICES = 64;  // devices whose shared-memory limit is kept
constexpr int TT = 6;          // a thread tile is TT x TT entries of G
constexpr int NT = 12;         // thread tiles along a block tile side
constexpr int BT = TT * NT;    // block tile side: 72 columns of A
constexpr int THREADS = 256;   // 8 warps, one block per SM
constexpr int ROWS = 64;       // rows of A per ring stage
constexpr int STAGES = 3;      // ring depth
constexpr int MAX_GROUPS = ROWS;
constexpr int RED_LANES = 8;   // reduce pass: split lanes per entry
constexpr int RED_COLS = 32;   // reduce pass: entries per block row

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

// Position of G[i][j], i <= j, in the packed upper triangle of an n x n G.
__device__ __forceinline__ size_t packed(int i, int j, int n) {
  return static_cast<size_t>(i) * n - static_cast<size_t>(i) * (i - 1) / 2 +
         (j - i);
}

// The block's work item.  Items 0 .. ntile-1 are the diagonal block tiles;
// then each pair bi < bj (row-major) as two halves of 6 thread-tile rows.
struct Item {
  int bi, bj, half;   // half = -1 on a diagonal block tile
  int nt;             // active thread tiles along the j side (and i side
                      // on the diagonal)
  int tiles;          // active thread tiles in the block
};

__device__ __forceinline__ Item decode_item(int x, int n) {
  const int ntile = (n + BT - 1) / BT;
  Item it;
  if (x < ntile) {
    it.bi = it.bj = x;
    it.half = -1;
    it.nt = min(NT, (n - BT * x + TT - 1) / TT);
    it.tiles = it.nt * (it.nt + 1) / 2;
  } else {
    int p = (x - ntile) >> 1, bi = 0;
    it.half = (x - ntile) & 1;
    while (p >= ntile - 1 - bi) {
      p -= ntile - 1 - bi;
      ++bi;
    }
    it.bi = bi;
    it.bj = bi + 1 + p;
    it.nt = min(NT, (n - BT * it.bj + TT - 1) / TT);
    it.tiles = (NT / 2) * it.nt;
  }
  return it;
}

// Stage rows [row0, row0 + ROWS) into `dst` (row pitch `pitch` floats):
// the first w0 elements from column c0 and, on an off-diagonal item, w1
// from column c1 at offset BT (w0 and w1 multiples of CE; cpr = (w0 + w1)
// / CE copies a row).  Elements past n and rows past r1 are zeros.  E
// floats an element; CE elements a copy.
template <int E, int CE>
__device__ __forceinline__ void load_stage(float* dst, const float* a, int n,
                                           int row0, int r1, int c0, int c1,
                                           int w0, int cpr, int pitch) {
  constexpr int BYTES = 4 * E * CE;
  const int k0 = w0 / CE;
  const int drr = THREADS / cpr, dcc = THREADS - drr * cpr;
  int rr = threadIdx.x / cpr, cc = threadIdx.x - rr * cpr;
  while (rr < ROWS) {
    const bool second = cc >= k0;
    const int e = (second ? cc - k0 : cc) * CE;
    const int col = (second ? c1 : c0) + e;
    const int row = row0 + rr;
    const bool valid = row < r1 && col < n;
    const float* src = valid ? a + (static_cast<size_t>(row) * n + col) * E
                             : a;
    cp_async<BYTES>(dst + rr * pitch + (second ? BT * E : 0) + e * E, src,
                    valid);
    rr += drr;
    cc += dcc;
    if (cc >= cpr) {
      cc -= cpr;
      ++rr;
    }
  }
}

// acc += x_i^H x_j over one staged row (complex: (re, im) pairs), or
// x_i^T x_j (real), for the thread's 6 x 6 tile.
template <bool CPLX>
__device__ __forceinline__ void row_fma(const float* xi, const float* xj,
                                        float (&acc)[TT][TT][CPLX ? 2 : 1]) {
  if constexpr (CPLX) {
    float br[TT], bi[TT];
#pragma unroll
    for (int c = 0; c < TT / 2; ++c) {
      const float4 v = reinterpret_cast<const float4*>(xj)[c];
      br[2 * c] = v.x;
      bi[2 * c] = v.y;
      br[2 * c + 1] = v.z;
      bi[2 * c + 1] = v.w;
    }
#pragma unroll
    for (int rr = 0; rr < TT / 2; ++rr) {
      const float4 v = reinterpret_cast<const float4*>(xi)[rr];
      const float ar[2] = {v.x, v.z}, ai[2] = {v.y, v.w};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < TT; ++c) {
          float& re = acc[2 * rr + h][c][0];
          float& im = acc[2 * rr + h][c][1];
          re = fmaf(ar[h], br[c], re);
          re = fmaf(ai[h], bi[c], re);
          im = fmaf(ar[h], bi[c], im);
          im = fmaf(-ai[h], br[c], im);
        }
    }
  } else {
    float b[TT];
#pragma unroll
    for (int c = 0; c < TT / 2; ++c) {
      const float2 v = reinterpret_cast<const float2*>(xj)[c];
      b[2 * c] = v.x;
      b[2 * c + 1] = v.y;
    }
#pragma unroll
    for (int rr = 0; rr < TT / 2; ++rr) {
      const float2 v = reinterpret_cast<const float2*>(xi)[rr];
#pragma unroll
      for (int c = 0; c < TT; ++c) {
        acc[2 * rr][c][0] = fmaf(v.x, b[c], acc[2 * rr][c][0]);
        acc[2 * rr + 1][c][0] = fmaf(v.y, b[c], acc[2 * rr + 1][c][0]);
      }
    }
  }
}

// Pass 1: block (item, split) sums its rows' contribution to its item's
// upper-triangular entries and writes them, packed, to work[split].
template <bool CPLX, bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
gram_tile_kernel(const float* __restrict__ a, float* __restrict__ work, int m,
                 int n, int chunk, int vec16) {
  constexpr int E = CPLX ? 2 : 1;
  extern __shared__ __align__(16) float ring[];
  const Item it = decode_item(blockIdx.x, n);
  const int ntile = (n + BT - 1) / BT;
  const int nrange = ntile > 1 ? 2 : 1;
  const int pitch = nrange * BT * E;
  const int c0 = BT * it.bi, c1 = BT * it.bj;

  const int groups = min(MAX_GROUPS, THREADS / it.tiles);
  const int t = threadIdx.x;
  const bool active = t < groups * it.tiles;
  const int g = t / it.tiles, q = t - g * it.tiles;
  int ti, tj;
  if (it.half < 0) {   // upper triangle of the nt x nt thread-tile grid
    int rem = q;
    ti = 0;
    while (rem >= it.nt - ti) {
      rem -= it.nt - ti;
      ++ti;
    }
    tj = ti + rem;
  } else {
    ti = (NT / 2) * it.half + q / it.nt;
    tj = q % it.nt;
  }
  const int ioff = ti * TT * E;
  const int joff = (it.half < 0 ? 0 : BT * E) + tj * TT * E;
  // staged widths: the thread tiles' columns, in whole copies
  const int ce = vec16 ? 4 / E : 1;
  const int wj = min(BT, (it.nt * TT + ce - 1) / ce * ce);
  const int w0 = it.half < 0 ? wj : BT;
  const int cpr = (w0 + (it.half < 0 ? 0 : wj)) / ce;

  float acc[TT][TT][E];
#pragma unroll
  for (int r = 0; r < TT; ++r)
#pragma unroll
    for (int c = 0; c < TT; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][c][e] = 0.f;

  const int r0 = blockIdx.y * chunk;
  const int r1 = min(m, r0 + chunk);
  const int nst = (r1 - r0 + ROWS - 1) / ROWS;
  auto fetch = [&](int s) {
    float* dst = ring + (s % STAGES) * ROWS * pitch;
    if (vec16)
      load_stage<E, 4 / E>(dst, a, n, r0 + s * ROWS, r1, c0, c1, w0, cpr,
                           pitch);
    else
      load_stage<E, 1>(dst, a, n, r0 + s * ROWS, r1, c0, c1, w0, cpr, pitch);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) fetch(s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of stage s landed
    __syncthreads();               // everyone's; slot of stage s-1 is free
    if (s + STAGES - 1 < nst) fetch(s + STAGES - 1);
    cp_async_commit();             // empty groups keep the count in step
    float* slot = ring + (s % STAGES) * ROWS * pitch;
    if (BF16) {   // the mixed policy's bf16 multiplicands, rounded once
      for (int idx = t; idx < ROWS * pitch; idx += THREADS)
        slot[idx] = __bfloat162float(__float2bfloat16_rn(slot[idx]));
      __syncthreads();
    }
    if (active)
      for (int r = g; r < ROWS; r += groups)
        row_fma<CPLX>(slot + r * pitch + ioff, slot + r * pitch + joff, acc);
  }
  cp_async_wait<0>();
  __syncthreads();

  // The groups' sums, as a tree in a fixed order, through the (now idle)
  // ring: at each step group g + step stores its sum and group g adds it.
  // A slot holds one group's tiles, word v of tile q at v * tiles + q
  // (consecutive threads on consecutive words).
  constexpr int V = TT * TT * E;
  for (int step = 1; step < groups; step *= 2) {
    float* slot = ring + (g / (2 * step)) * V * it.tiles + q;
    if (active && g % (2 * step) == step) {
#pragma unroll
      for (int r = 0; r < TT; ++r)
#pragma unroll
        for (int c = 0; c < TT; ++c)
#pragma unroll
          for (int e = 0; e < E; ++e)
            slot[((r * TT + c) * E + e) * it.tiles] = acc[r][c][e];
    }
    __syncthreads();
    if (active && g % (2 * step) == 0 && g + step < groups) {
#pragma unroll
      for (int r = 0; r < TT; ++r)
#pragma unroll
        for (int c = 0; c < TT; ++c)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[r][c][e] += slot[((r * TT + c) * E + e) * it.tiles];
    }
    __syncthreads();
  }
  if (!active || g != 0) return;
  float* out = work + static_cast<size_t>(blockIdx.y) * (n * (n + 1) / 2) * E;
#pragma unroll
  for (int r = 0; r < TT; ++r) {
    const int i = c0 + ti * TT + r;
#pragma unroll
    for (int c = 0; c < TT; ++c) {
      const int j = c1 + tj * TT + c;
      if (i <= j && j < n) {
        const size_t p = packed(i, j, n) * E;
#pragma unroll
        for (int e = 0; e < E; ++e) out[p + e] = acc[r][c][e];
      }
    }
  }
}

// Pass 2: G[i][j] = sum over splits, in a fixed order, of work[s][(i, j)]
// for i <= j; written mirrored (complex: Im negated below the diagonal,
// exactly 0 on it).  Block (j-chunk, i): 32 entries x 8 split lanes.
template <bool CPLX>
__global__ void __launch_bounds__(RED_COLS * RED_LANES)
gram_reduce_kernel(const float* __restrict__ work, float* __restrict__ g,
                   int n, int splits) {
  constexpr int E = CPLX ? 2 : 1;
  const int i = blockIdx.y;
  const int j = blockIdx.x * RED_COLS + threadIdx.x;
  if (blockIdx.x * RED_COLS + RED_COLS - 1 < i) return;   // all below
  const bool ok = j >= i && j < n;
  const size_t npack = static_cast<size_t>(n) * (n + 1) / 2;
  float sum[E];
#pragma unroll
  for (int e = 0; e < E; ++e) sum[e] = 0.f;
  if (ok) {
    const float* src = work + packed(i, j, n) * E;
#pragma unroll 8
    for (int s = threadIdx.y; s < splits; s += RED_LANES)
#pragma unroll
      for (int e = 0; e < E; ++e) sum[e] += src[s * npack * E + e];
  }
  __shared__ float lanes[E][RED_LANES][RED_COLS];
#pragma unroll
  for (int e = 0; e < E; ++e) lanes[e][threadIdx.y][threadIdx.x] = sum[e];
  __syncthreads();
  if (threadIdx.y != 0 || !ok) return;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    sum[e] = lanes[e][0][threadIdx.x];
    for (int l = 1; l < RED_LANES; ++l) sum[e] += lanes[e][l][threadIdx.x];
  }
  const size_t ij = static_cast<size_t>(i) * n + j;
  const size_t ji = static_cast<size_t>(j) * n + i;
  if constexpr (CPLX) {
    g[2 * ij] = sum[0];
    g[2 * ij + 1] = i == j ? 0.f : sum[1];
    if (i != j) {
      g[2 * ji] = sum[0];
      g[2 * ji + 1] = -sum[1];
    }
  } else {
    g[ij] = sum[0];
    g[ji] = sum[0];
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The split over M: row ranges of whole stages, at least one stage each,
// and about one block (item, split) per SM.
struct Plan {
  int splits, chunk;
};
inline Plan plan(int m, int n, int sms) {
  const int items = ceil_div(n, BT) * ceil_div(n, BT);
  const int want =
      std::max(1, std::min(ceil_div(m, ROWS), ceil_div(sms, items)));
  const int chunk = ceil_div(ceil_div(m, want), ROWS) * ROWS;
  return {ceil_div(m, chunk), chunk};
}

// Ring bytes of one block: STAGES x ROWS rows of one or two column ranges.
inline int ring_bytes(int n, int e) {
  const int nrange = n > BT ? 2 : 1;
  return STAGES * ROWS * nrange * BT * e * static_cast<int>(sizeof(float));
}

template <bool CPLX, bool BF16>
int launch(const void* a, void* g, void* work, int m, int n, int sms,
           cudaStream_t st) {
  constexpr int E = CPLX ? 2 : 1;
  const Plan p = plan(m, n, sms);
  const int smem = ring_bytes(n, E);
  // raised only when a ring outgrows it; the limit is an attribute of the
  // kernel in each device's context, so it is kept per device
  static int smem_allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return static_cast<int>(derr);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > std::max(48 * 1024, smem_allowed[dev])) {
    cudaError_t err = cudaFuncSetAttribute(
        gram_tile_kernel<CPLX, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed[dev] = smem;
  }
  // 16-byte copies need 16-byte rows and a 16-byte aligned A
  const int vec16 = (n * E) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int ntile = (n + BT - 1) / BT;
  dim3 grid(ntile * ntile, p.splits);
  gram_tile_kernel<CPLX, BF16><<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(a), static_cast<float*>(work), m, n, p.chunk,
      vec16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 rgrid((n + RED_COLS - 1) / RED_COLS, n);
  gram_reduce_kernel<CPLX><<<rgrid, dim3(RED_COLS, RED_LANES), 0, st>>>(
      static_cast<const float*>(work), static_cast<float*>(g), n, p.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gram
}  // namespace repro

// a: (m, n) row-major, f32 (repro_gram_f32) or complex64 as interleaved
// (re, im) f32 pairs (repro_gram_c64); g: (n, n) of the same type; work:
// (repro_gram_splits(m, n, sms), n (n + 1) / 2) f32 (x 2 for c64) scratch,
// the packed upper triangle of each split's partial.  sms: the card's SM
// count.  bf16 != 0 rounds the multiplicands (re and im parts) to bf16.
// Returns cudaGetLastError.
extern "C" int repro_gram_splits(int m, int n, int sms) {
  return repro::gram::plan(m, n, sms).splits;
}

extern "C" int repro_gram_f32(const void* a, void* g, void* work, int m,
                              int n, int sms, int bf16, void* stream) {
  using namespace repro::gram;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<false, true>(a, g, work, m, n, sms, st)
              : launch<false, false>(a, g, work, m, n, sms, st);
}

extern "C" int repro_gram_c64(const void* a, void* g, void* work, int m,
                              int n, int sms, int bf16, void* stream) {
  using namespace repro::gram;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true, true>(a, g, work, m, n, sms, st)
              : launch<true, false>(a, g, work, m, n, sms, st);
}
