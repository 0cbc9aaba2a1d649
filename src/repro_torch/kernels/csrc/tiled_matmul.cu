// General GEMM C = op(A) B in f32 (op(A) = A or A^T, read in place), with
// a deterministic split over K.
//
// Replaces: src/repro/kernels/tiled_matmul.py, _matmul_kernel /
// tiled_matmul (Pallas, TPU).
//
// What bounds it on the H100: its reference caller (ops.matmul, and the
// complex Gram's cross term (Re A)^T (Im A) in the reference) takes a
// 72 x 72 output over K = 82,944 with op(A) = x^T of a row-major x.  That
// is 2 * 72 * 72 * K flops against 4 * (2 * 72 * K + 72^2) bytes, 18 flops
// a byte, just under the f32 ridge of 20 (67 TFLOP/s over 3.35 TB/s): the
// bytes bound it, 0.0143 ms against 0.0128 ms for the FMAs.
//
// Plain FFMA, no TF32 and no tensor cores for f32 operands: an exact f32 x
// f32 product on the tensor cores needs nine bf16 products of the exact
// three-piece split, at most 989 / 9 = 110 TFLOP/s at wgmma's peak (less on
// mma.sync), no better than 67 TFLOP/s of FFMA at a shape the bytes bind.
// Under compute="bfloat16" the multiplicands are rounded to bf16 in shared
// memory; products of two bf16 values are exact in f32.
//
// Design, against the four faults of the 64 x 64 split-K kernel it replaces
// (numbers: H100 80GB HBM3 at 700 W, tools/tiled_matmul_variants.py):
// 1. Wasted FMAs.  Tiles are fitted to 72, not to 64: a block tile covers
//    72 x 72 of C, as 12 x 12 thread tiles of 6 x 6 (36 accumulators).  At
//    72 x 72 every FMA is needed (the 64 x 64 tiles ran 2 x 2 blocks, 3.16x
//    the FMAs); larger M or N run a grid of block tiles, and a ragged block
//    tile enumerates only the thread tiles that overlap C.
// 2. Operands read twice.  A block owns all 72 x 72 outputs of its tile,
//    so at the main shape each block streams its K range of op(A) and B
//    once, through a ring of STAGES stages of 64 K-rows: the next stages
//    land while the current one is multiplied.  Where op(A) = A^T and both
//    operands are 72 wide (the main shape), a stage's K-rows are contiguous
//    and each operand's stage is one cp.async.bulk copy (the copy engine),
//    completed on an mbarrier; elsewhere every thread copies by cp.async
//    (16 bytes where the row length and the pointer allow it, else 4).  Only
//    the K-rows in range are copied and multiplied; past C's edges stale
//    values feed only entries that are not stored.  The bulk copies took
//    the kernel from 0.0357 to 0.0308 ms at the main shape: the threads'
//    own copies barely overlapped the FMAs.  A stage of op(A) = A^T (A
//    stored (K, M)) is 64 contiguous K-rows; of a row-major A (M, K) it is
//    72 rows of 64 K-values in padded shared memory, read transposed.
// 3. No overlap, 2 FMAs a shared-memory word.  Per K-row a thread loads 6
//    values of op(A) and 6 of B (three 8-byte loads each) for 36 FMAs: 3
//    FMAs a word.  Consecutive threads walk the 12 column tiles, so a half
//    warp's B loads fall on 24 distinct banks and its op(A) loads are
//    broadcasts.  A row-major A's thread tile takes the rows ti + 12 r, so
//    a warp's scalar loads of one K-column fall on distinct banks of the
//    68-float pitch.  36 accumulators let 576 threads (18 warps) share the
//    registers; 6 x 12 tiles (72 accumulators, 4 FMAs a word) in 9 warps
//    ran slower.
// 4. Partials.  K is split into fixed ranges of whole stages, about one
//    block per SM (plan(), from the SM count the caller passes).  Inside a
//    block 4 groups of 144 threads take their own K-rows of each stage
//    (rows g, g + 4, ...).  At the end the groups' sums go through shared
//    memory, and every thread adds them in a fixed order for entries of
//    the tile in row-major order and stores them coalesced: one partial per
//    block (each thread storing its own tile, 4 bytes at a time, took 10
//    µs).  The reduce pass sums the partials of each entry in a fixed order
//    (8 lanes of strided splits, then the lanes in order).  With one split
//    the block writes C itself.  No atomics: a run repeats bit for bit.
// One block per SM: 576 threads and a 152,064-byte ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace repro {
namespace tmm {
namespace {   // internal linkage: nothing here is shared with another library

constexpr int MAX_DEVICES = 64;     // devices whose shared-memory limit is kept
constexpr int TM = 6;              // thread tile: TM rows of C
constexpr int TN = 6;              // ... by TN columns
constexpr int BT = 72;             // block tile side
constexpr int NTI = BT / TM;       // 12 thread-tile rows
constexpr int NTJ = BT / TN;       // 12 thread-tile columns
constexpr int TILES = NTI * NTJ;   // 144 thread tiles
constexpr int GROUPS = 4;          // thread groups over the K-rows of a stage
constexpr int THREADS = GROUPS * TILES;   // 576 (18 warps)
constexpr int ROWS = 64;           // K-rows per ring stage
constexpr int STAGES = 4;          // ring depth
constexpr int APITCH = ROWS + 4;   // a row-major A stage: BT rows of ROWS
constexpr int A_FLOATS = BT * APITCH;        // >= ROWS * BT (A^T stage)
constexpr int STAGE_FLOATS = A_FLOATS + ROWS * BT;
constexpr int RING_FLOATS = STAGES * STAGE_FLOATS;
constexpr int RING_BYTES = RING_FLOATS * 4;
constexpr int MAX_GROUPS = ROWS;
constexpr int UNROLL = 4;          // K-rows of a group's loop unrolled
constexpr int RED_LANES = 8;       // reduce pass: split lanes per entry
constexpr int RED_COLS = 32;       // reduce pass: entries per block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES bytes global -> shared, asynchronously.  16-byte copies bypass L1
// (.cg); 4-byte ones must use .ca.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The bulk path: a whole stage of an operand in one copy (cp.async.bulk,
// the copy engine), completion counted in bytes on an mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                  "r"(smem_addr(bar)) : "memory");
}
// Wait until the phase of parity `parity` of *bar has completed; trap
// after about 2^32 cycles rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 32)) __trap();
  }
}

// Copy a rows x w block of a row-major matrix (row stride ld floats),
// starting at src, into dst (row pitch `pitch` floats), CE floats a copy
// (w a multiple of CE).
template <int CE>
__device__ __forceinline__ void load_block(float* dst, int pitch,
                                           const float* src, size_t ld,
                                           int rows, int w) {
  const int cpr = w / CE;
  const int drr = THREADS / cpr, dcc = THREADS - drr * cpr;
  int rr = threadIdx.x / cpr, cc = threadIdx.x - rr * cpr;
  while (rr < rows) {
    cp_async<4 * CE>(dst + rr * pitch + cc * CE, src + rr * ld + cc * CE);
    rr += drr;
    cc += dcc;
    if (cc >= cpr) {
      cc -= cpr;
      ++rr;
    }
  }
}

// Row r of thread tile ti within the block tile: for op(A) = A^T TM
// contiguous rows (vector loads), for a row-major A rows ti + NTI r
// (scalar loads on distinct banks).
template <bool TRANS>
__device__ __forceinline__ int tile_row(int ti, int r) {
  return TRANS ? ti * TM + r : ti + NTI * r;
}

// v[0, W) = p[0, W): 16-byte shared-memory loads, or 8-byte ones.
template <int W>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int x = 0; x < W / 4; ++x) {
      const float4 u = reinterpret_cast<const float4*>(p)[x];
      v[4 * x] = u.x;
      v[4 * x + 1] = u.y;
      v[4 * x + 2] = u.z;
      v[4 * x + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int x = 0; x < W / 2; ++x) {
      const float2 u = reinterpret_cast<const float2*>(p)[x];
      v[2 * x] = u.x;
      v[2 * x + 1] = u.y;
    }
  }
}

// acc += op(A)[tile rows, r] B[r, tile columns] for one staged K-row r.
template <bool TRANS>
__device__ __forceinline__ void row_fma(const float* as, const float* bs,
                                        int r, int ti, int tj,
                                        float (&acc)[TM][TN]) {
  float av[TM], bv[TN];
  if (TRANS) {
    lds<TM>(as + r * BT + ti * TM, av);
  } else {
#pragma unroll
    for (int x = 0; x < TM; ++x)
      av[x] = as[tile_row<false>(ti, x) * APITCH + r];
  }
  lds<TN>(bs + r * BT + tj * TN, bv);
#pragma unroll
  for (int x = 0; x < TM; ++x)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[x][c] = fmaf(av[x], bv[c], acc[x][c]);
}

// Pass 1: block (item, split) sums op(A)[i0.., k] B[k, j0..] over its K
// range [split * chunk, ...) into its tile of work[split] (or of C when
// there is one split).  vec_a / vec_b: 16-byte copies allowed.
template <bool TRANS, bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
tiled_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int m, int k, int n, int chunk,
                    int vec_a, int vec_b, int bulk) {
  extern __shared__ __align__(16) float ring[];
  __shared__ uint64_t full[STAGES];   // the bulk path: stage landed
  const int tiles_n = (n + BT - 1) / BT;
  const int i0 = BT * (blockIdx.x / tiles_n), j0 = BT * (blockIdx.x % tiles_n);
  const int mrem = min(BT, m - i0), nrem = min(BT, n - j0);
  // thread tiles that overlap C
  const int nti = TRANS ? (mrem + TM - 1) / TM : min(NTI, mrem);
  const int ntj = (nrem + TN - 1) / TN;
  const int tiles = nti * ntj;
  const int groups = min(MAX_GROUPS, THREADS / tiles);
  const int t = threadIdx.x;
  const bool active = t < groups * tiles;
  const int g = t / tiles, q = t - g * tiles;
  const int ti = q / ntj, tj = q - ti * ntj;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  const int r0 = blockIdx.y * chunk;
  const int r1 = min(k, r0 + chunk);
  const int nst = (r1 - r0 + ROWS - 1) / ROWS;
  // staged widths, in whole copies (vec_* implies a row length and so
  // mrem, nrem that are multiples of 4: a 16-byte copy never crosses C's
  // edge)
  const int wa = TRANS ? (vec_a ? (mrem + 3) / 4 * 4 : mrem) : ROWS;
  const int wb = vec_b ? (nrem + 3) / 4 * 4 : nrem;
  if (bulk && t == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto fetch = [&](int s) {
    float* as = ring + (s % STAGES) * STAGE_FLOATS;
    float* bs = as + A_FLOATS;
    const int kr = r0 + s * ROWS;
    const int live = min(ROWS, r1 - kr);
    if (bulk) {   // op(A) = A^T and B 72 wide: a stage is two blocks of
      if (t == 0) {   // live K-rows, one bulk copy each
        uint64_t* bar = &full[s % STAGES];
        const uint32_t bytes = 4 * live * BT;
        mbar_expect_tx(bar, 2 * bytes);
        bulk_copy(as, a + static_cast<size_t>(kr) * BT, bytes, bar);
        bulk_copy(bs, b + static_cast<size_t>(kr) * BT, bytes, bar);
      }
      return;
    }
    // live K-rows: what lies past them is not read, and what lies past
    // C's edges only into entries that are not stored
    if (TRANS) {   // K-rows of A stored (k, m): live rows of wa columns
      const float* src = a + static_cast<size_t>(kr) * m + i0;
      if (vec_a) load_block<4>(as, BT, src, m, live, wa);
      else load_block<1>(as, BT, src, m, live, wa);
    } else {       // rows of A stored (m, k): mrem rows of live K-values
      const float* src = a + static_cast<size_t>(i0) * k + kr;
      // (with vec_a, K and so the range ends are multiples of 4)
      if (vec_a) load_block<4>(as, APITCH, src, k, mrem, live);
      else load_block<1>(as, APITCH, src, k, mrem, live);
    }
    const float* src = b + static_cast<size_t>(kr) * n + j0;
    if (vec_b) load_block<4>(bs, BT, src, n, live, wb);
    else load_block<1>(bs, BT, src, n, live, wb);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) fetch(s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    if (bulk)                      // stage s landed
      mbar_wait(&full[s % STAGES], (s / STAGES) & 1);
    else                           // this thread's copies of stage s landed
      cp_async_wait<STAGES - 2>();
    __syncthreads();               // everyone's; slot of stage s-1 is free
    if (s + STAGES - 1 < nst) fetch(s + STAGES - 1);
    cp_async_commit();             // empty groups keep the count in step
    float* as = ring + (s % STAGES) * STAGE_FLOATS;
    const float* bs = as + A_FLOATS;
    const int live = min(ROWS, r1 - r0 - s * ROWS);   // K-rows staged
    if (BF16) {   // the mixed policy's bf16 multiplicands, rounded once
      for (int idx = t; idx < STAGE_FLOATS; idx += THREADS)
        as[idx] = __bfloat162float(__float2bfloat16_rn(as[idx]));
      // these generic-proxy writes precede the bulk copies into the slot
      if (bulk) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    if (active) {
#pragma unroll UNROLL   // the next rows' loads overlap this row's FMAs
      for (int r = g; r < live; r += groups)
        row_fma<TRANS>(as, bs, r, ti, tj, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The groups' sums, through the idle ring: word v of group g's tile q at
  // (g * TM * TN + v) * pitch + q, consecutive threads on consecutive
  // words.  A pitch of TN mod 32 (where the ring holds it) spreads the
  // reads of consecutive columns below over the banks.
  int pitch = tiles + (TN + 32 - tiles % 32) % 32;
  if (groups * TM * TN * pitch > RING_FLOATS) pitch = tiles;
  if (active) {
    float* slot = ring + g * TM * TN * pitch + q;
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) slot[(r * TN + c) * pitch] = acc[r][c];
  }
  __syncthreads();
  // Every thread: entries of the block tile in row-major order, the groups'
  // sums added in a fixed order, stored with consecutive threads on
  // consecutive columns.
  float* dst = out + static_cast<size_t>(blockIdx.y) * m * n +
               static_cast<size_t>(i0) * n + j0;
  const int drow = THREADS / nrem, dcol = THREADS - drow * nrem;
  int row = t / nrem, col = t - row * nrem;
  while (row < mrem) {
    const int tr = TRANS ? row / TM : row % NTI;
    const int r = TRANS ? row - tr * TM : row / NTI;
    const int tc = col / TN, c = col - tc * TN;
    const float* src = ring + (r * TN + c) * pitch + tr * ntj + tc;
    float sum = src[0];
    for (int gg = 1; gg < groups; ++gg) sum += src[gg * TM * TN * pitch];
    dst[static_cast<size_t>(row) * n + col] = sum;
    row += drow;
    col += dcol;
    if (col >= nrem) {
      col -= nrem;
      ++row;
    }
  }
}

// Pass 2: C[e] = sum over splits, in a fixed order, of work[s][e]: lane l
// of an entry sums the splits l, l + 8, ..., then lane 0 adds the lanes in
// order.
__global__ void __launch_bounds__(RED_COLS * RED_LANES)
tiled_matmul_reduce_kernel(const float* __restrict__ work,
                           float* __restrict__ c, size_t total, int splits) {
  const size_t e = static_cast<size_t>(blockIdx.x) * RED_COLS + threadIdx.x;
  float sum = 0.f;
  if (e < total) {
#pragma unroll 8
    for (int s = threadIdx.y; s < splits; s += RED_LANES)
      sum += work[s * total + e];
  }
  __shared__ float lanes[RED_LANES][RED_COLS];
  lanes[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y != 0 || e >= total) return;
  sum = lanes[0][threadIdx.x];
  for (int l = 1; l < RED_LANES; ++l) sum += lanes[l][threadIdx.x];
  c[e] = sum;
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The split over K: ranges of whole stages, at least one stage each, and
// about one block (item, split) per SM.
struct Plan {
  int splits, chunk;
};
inline Plan plan(int m, int k, int n, int sms) {
  const int items = ceil_div(m, BT) * ceil_div(n, BT);
  const int want =
      std::max(1, std::min(ceil_div(k, ROWS), ceil_div(sms, items)));
  const int chunk = ceil_div(ceil_div(k, want), ROWS) * ROWS;
  return {ceil_div(k, chunk), chunk};
}

template <bool TRANS, bool BF16>
int launch(const float* a, const float* b, float* c, float* work, int m,
           int k, int n, int sms, cudaStream_t st) {
  const Plan p = plan(m, k, n, sms);
  // the ring outgrows the 48 KB default; the attribute belongs to the
  // kernel in each device's context, so it is set once per device
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return static_cast<int>(derr);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        tiled_matmul_kernel<TRANS, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  // 16-byte copies need 16-byte rows and a 16-byte aligned base; the
  // row-major A's copies run along K
  const int vec_a = (TRANS ? m : k) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int vec_b = n % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  // op(A) = A^T and B 72 wide, aligned: a stage's K-rows are contiguous
  const int bulk = TRANS && m == BT && n == BT && vec_a && vec_b;
  dim3 grid(ceil_div(m, BT) * ceil_div(n, BT), p.splits);
  tiled_matmul_kernel<TRANS, BF16><<<grid, THREADS, RING_BYTES, st>>>(
      a, b, p.splits > 1 ? work : c, m, k, n, p.chunk, vec_a, vec_b, bulk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(m) * n;
  tiled_matmul_reduce_kernel<<<static_cast<unsigned>(
                                   (total + RED_COLS - 1) / RED_COLS),
                               dim3(RED_COLS, RED_LANES), 0, st>>>(
      work, c, total, p.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tmm
}  // namespace repro

// c = op(a) b with op(a) of shape (m, k): a stored (m, k) row-major, or
// (k, m) row-major when a_trans.  b: (k, n) row-major; c: (m, n).  work:
// (repro_tiled_matmul_splits(m, k, n, sms), m, n) f32 scratch for the
// splits' partials, unused (may be c) with one split.  sms: the card's SM
// count.  bf16 != 0 rounds the multiplicands to bf16.  Returns
// cudaGetLastError.
extern "C" int repro_tiled_matmul_splits(int m, int k, int n, int sms) {
  return repro::tmm::plan(m, k, n, sms).splits;
}

extern "C" int repro_tiled_matmul_f32(const void* a, const void* b, void* c,
                                      void* work, int m, int k, int n,
                                      int a_trans, int sms, int bf16,
                                      void* stream) {
  using namespace repro::tmm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* pc = static_cast<float*>(c);
  float* pw = static_cast<float*>(work);
  if (a_trans)
    return bf16 ? launch<true, true>(pa, pb, pc, pw, m, k, n, sms, st)
                : launch<true, false>(pa, pb, pc, pw, m, k, n, sms, st);
  return bf16 ? launch<false, true>(pa, pb, pc, pw, m, k, n, sms, st)
              : launch<false, false>(pa, pb, pc, pw, m, k, n, sms, st);
}
