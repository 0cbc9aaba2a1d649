// The three zip-up site contractions, each one launch that reads its
// operands in place and writes its output contiguous in its final axis
// order: f32 and complex64 (interleaved (re, im) f32 pairs).
//
// Replaces: src/repro/kernels/zipup_block.py, _first_onelayer_pallas,
// _pair_merge_pallas (zipup_pair_kernel) and _first_twolayer_pallas
// (zipup_chain_kernel) (Pallas, TPU; there each site is a transpose copy
// of its operands, one planar tall-apply GEMM -- two for the two-layer
// site, with a transpose copy between them -- and a transposed output).
//
// What bounds them on the H100: neither bytes nor flops.  The operands
// hold 36 to 1,296 complex entries and the largest output, the two-layer
// carry at D = 6, 46,656: at most 0.75 MB moved (0.22 us at 3.35 TB/s) and
// 4 M complex multiply-adds (0.24 us at 67 TFLOP/s).  What a call costs is
// its launches and the host work around them: the composition this
// replaces took 2 to 5 kernels a site (permute copies, the GEMMs, the
// engine's reshape copy of a permuted output) and one checked ctypes call
// and one allocation a GEMM.
//
// Design, against that:
// 1. One launch a call, and the only host work is one torch.empty and one
//    ctypes call of six or seven arguments: the shapes and strides go in
//    one int64 host array, which the launcher below copies into a struct
//    passed to the kernel by value.
// 2. Operands read in place.  Every output axis has one stride into each
//    operand, 0 where the operand lacks the axis, and so has every
//    contracted axis: a permuted or sliced view costs nothing, and a conj
//    view is a sign in the multiply-adds (flag bits), never a copy.
// 3. The output written contiguous, in its final axis order: thread o
//    owns entry o, so neighbouring threads write neighbouring addresses and
//    the engine's reshape after the site is a view.  The grid follows the
//    output count (grid-stride beyond 65,536 blocks), and the contraction
//    loops have no cap: no shape is refused.
// 4. The two-layer chain keeps its intermediate out of device memory.
//    t1[b,F,g,p,c,h,k] = sum_f s0[b,f,F,g] tb0[p,f,c,h,k] is staged in
//    shared memory, slabs of CHUNK (p, F) pairs at a time: the threads of
//    one output run over the ket's K (the trailing output axes s0 and tb0
//    lack) compute each entry once and share it, p F f / K + p F
//    multiply-adds an output (24 at D = 6).  Recomputing t1 in every
//    thread instead (p F (f + 1) = 84) took 15.7 us of device time on the
//    H100 at the main shape, against 7.0 for this design
//    (tools/zipup_variants.py, variant recompute_t1).
//
// The f32 contract: sums in f32, no TF32.  bf16 != 0 rounds the real and
// imaginary parts of every multiplicand to bf16 separately, as the
// reference's planar GEMM does, and in the chain also t1, the stage-1
// result the reference hands to its second GEMM as a multiplicand
// (round_t1 rounds t1 alone: the reference's stage-1 result is bf16 when
// s0 and tb0 both are).  Deterministic: each entry is summed by one thread
// in a fixed order, so a second call repeats bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {
namespace zipup {
namespace {   // internal linkage: nothing here is shared with another library

constexpr int MAX_AXES = 8;     // output axes
constexpr int PAIR_K = 3;       // contracted axes of the pair kernel
constexpr int THREADS = 128;
constexpr long long MAX_BLOCKS = 65536;
constexpr int CHUNK = 32;       // (i0, i1) pairs of t1 staged at a time

// Flag bits of the C entry points; operand i is read conjugated under
// F_CONJ0 << i.
constexpr int F_COMPLEX = 1, F_BF16 = 2, F_CONJ0 = 4, F_ROUND_T1 = 32;

// Output axes: each one's size and its element stride into each of NOP
// operands (0 where the operand lacks the axis).
template <int NOP>
struct Axes {
  int nd;
  long long size[MAX_AXES];
  long long stride[NOP][MAX_AXES];
};

// out[o] = sum_k A[offA(o, k)] B[offB(o, k)] over three contracted axes,
// each with a stride into A and one into B.
struct PairArgs {
  long long n_out;
  Axes<2> out;
  long long ksize[PAIR_K];
  long long kstride[2][PAIR_K];
};

// out[o] = sum_{i0, i1} round(sum_j X[.] Y[.]) Z[.]: two outer contracted
// axes with strides into X, Y and Z; one inner axis into X and Y.
struct ChainArgs {
  long long n_out;
  Axes<3> out;
  long long osize[2];
  long long ostride[3][2];
  long long isize;
  long long istride[2];
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Entry `off` of an operand as (re, im): im = 0 for a real operand, negated
// for a conj view; each part rounded to bf16 when BF16.
template <bool CPLX, bool BF16>
__device__ __forceinline__ float2 load(const float* __restrict__ p,
                                       long long off, bool conj) {
  float2 v;
  if constexpr (CPLX) {
    v = __ldg(reinterpret_cast<const float2*>(p) + off);
    if (conj) v.y = -v.y;
  } else {
    v = make_float2(__ldg(p + off), 0.f);
  }
  if constexpr (BF16) v = make_float2(bf16_round(v.x), bf16_round(v.y));
  return v;
}

// acc += x y, in f32 (a real instantiation keeps only the real part).
template <bool CPLX>
__device__ __forceinline__ void mac(float2& acc, float2 x, float2 y) {
  acc.x = fmaf(x.x, y.x, acc.x);
  if constexpr (CPLX) {
    acc.x = fmaf(-x.y, y.y, acc.x);
    acc.y = fmaf(x.x, y.y, acc.y);
    acc.y = fmaf(x.y, y.x, acc.y);
  }
}

template <bool CPLX>
__device__ __forceinline__ void store(float* __restrict__ out, long long o,
                                      float2 v) {
  if constexpr (CPLX)
    reinterpret_cast<float2*>(out)[o] = v;
  else
    out[o] = v.x;
}

// The offsets of output entry o (row-major over the axes) into the NOP
// operands, the axes taken from the last in I arithmetic; every index into
// `ax` is a constant after unrolling, so the arguments stay in the
// parameter bank.
template <typename I, int NOP>
__device__ __forceinline__ void offsets_as(const Axes<NOP>& ax, I o,
                                           long long (&off)[NOP]) {
#pragma unroll
  for (int op = 0; op < NOP; ++op) off[op] = 0;
#pragma unroll
  for (int i = MAX_AXES - 1; i >= 0; --i) {
    if (i < ax.nd) {
      const I n = static_cast<I>(ax.size[i]);
      const I q = o / n;
      const long long r = static_cast<long long>(o - q * n);
#pragma unroll
      for (int op = 0; op < NOP; ++op) off[op] += r * ax.stride[op][i];
      o = q;
    }
  }
}

// 32-bit index arithmetic where the output count allows it.
template <int NOP>
__device__ __forceinline__ void offsets(const Axes<NOP>& ax, long long o,
                                        long long n_out,
                                        long long (&off)[NOP]) {
  if (n_out <= 0xffffffffLL)
    offsets_as<unsigned, NOP>(ax, static_cast<unsigned>(o), off);
  else
    offsets_as<unsigned long long, NOP>(
        ax, static_cast<unsigned long long>(o), off);
}

template <bool CPLX, bool BF16>
__global__ void __launch_bounds__(THREADS)
zipup_pair_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, const PairArgs p, int flags) {
  const bool conj_a = flags & F_CONJ0, conj_b = flags & (F_CONJ0 << 1);
  for (long long o = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       o < p.n_out; o += static_cast<long long>(gridDim.x) * THREADS) {
    long long off[2];
    offsets<2>(p.out, o, p.n_out, off);
    float2 acc = make_float2(0.f, 0.f);
    for (long long k0 = 0; k0 < p.ksize[0]; ++k0) {
      for (long long k1 = 0; k1 < p.ksize[1]; ++k1) {
        long long oa = off[0] + k0 * p.kstride[0][0] + k1 * p.kstride[0][1];
        long long ob = off[1] + k0 * p.kstride[1][0] + k1 * p.kstride[1][1];
        for (long long k2 = 0; k2 < p.ksize[2]; ++k2) {
          mac<CPLX>(acc, load<CPLX, BF16>(a, oa, conj_a),
                    load<CPLX, BF16>(b, ob, conj_b));
          oa += p.kstride[0][2];
          ob += p.kstride[1][2];
        }
      }
    }
    store<CPLX>(out, o, acc);
  }
}

// Threads [g run, (g + 1) run) of a block differ only in the trailing
// output axes that x and y lack (the ket's K in the two-layer site), so
// they share t1: for each slab of CHUNK (i0, i1) pairs the run computes
// its t1 entries once, each thread a share, into shared memory, and every
// thread of the run sums its output over them.
template <bool CPLX, bool BF16>
__global__ void __launch_bounds__(THREADS)
zipup_chain_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ z, float* __restrict__ out,
                   const ChainArgs p, int flags, int run) {
  extern __shared__ float2 t1s[];   // [blockDim.x / run][CHUNK]
  const bool conj_x = flags & F_CONJ0, conj_y = flags & (F_CONJ0 << 1),
             conj_z = flags & (F_CONJ0 << 2);
  const bool round_t1 = BF16 || (flags & F_ROUND_T1);
  const int group = threadIdx.x / run, lane = threadIdx.x - group * run;
  float2* shared_t1 = t1s + group * CHUNK;
  const long long n_outer = p.osize[0] * p.osize[1];
  // block-uniform trip counts: every thread reaches every barrier
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < p.n_out;
       base += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long o = base + threadIdx.x;
    const bool valid = o < p.n_out;   // uniform over a run
    long long off[3] = {0, 0, 0};
    if (valid) offsets<3>(p.out, o, p.n_out, off);
    float2 acc = make_float2(0.f, 0.f);
    for (long long c0 = 0; c0 < n_outer; c0 += CHUNK) {
      const int nq = static_cast<int>(
          n_outer - c0 < CHUNK ? n_outer - c0 : CHUNK);
      if (valid) {
        // stage 1: this thread's share of the slab's t1, summed in f32 ...
        for (int q = lane; q < nq; q += run) {
          const long long i0 = (c0 + q) / p.osize[1];
          const long long i1 = c0 + q - i0 * p.osize[1];
          long long offx = off[0] + i0 * p.ostride[0][0] + i1 * p.ostride[0][1];
          long long offy = off[1] + i0 * p.ostride[1][0] + i1 * p.ostride[1][1];
          float2 t1 = make_float2(0.f, 0.f);
          for (long long j = 0; j < p.isize; ++j) {
            mac<CPLX>(t1, load<CPLX, BF16>(x, offx, conj_x),
                      load<CPLX, BF16>(y, offy, conj_y));
            offx += p.istride[0];
            offy += p.istride[1];
          }
          // ... rounded where the reference's second GEMM rounds it
          if (round_t1)
            t1 = make_float2(bf16_round(t1.x), bf16_round(t1.y));
          shared_t1[q] = t1;
        }
      }
      __syncthreads();
      if (valid) {   // stage 2 over the slab
        long long i0 = c0 / p.osize[1], i1 = c0 - i0 * p.osize[1];
        for (int q = 0; q < nq; ++q) {
          mac<CPLX>(acc, shared_t1[q],
                    load<CPLX, BF16>(z, off[2] + i0 * p.ostride[2][0] +
                                            i1 * p.ostride[2][1], conj_z));
          if (++i1 == p.osize[1]) {
            i1 = 0;
            ++i0;
          }
        }
      }
      __syncthreads();   // the slab is read before the next is written
    }
    if (valid) store<CPLX>(out, o, acc);
  }
}

int grid_of(long long n_out) {
  const long long blocks = (n_out + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

// Copies `n` int64 values of the host array into dst, advancing it.
void take(const long long*& src, long long* dst, int n) {
  for (int i = 0; i < n; ++i) dst[i] = *src++;
}

// nd, size[nd], then stride[op][nd] for each operand; false for more than
// MAX_AXES axes.  n_out: the output count.
template <int NOP>
bool take_axes(const long long*& src, Axes<NOP>& ax, long long& n_out) {
  const long long nd = *src++;
  if (nd < 0 || nd > MAX_AXES) return false;
  ax.nd = static_cast<int>(nd);
  take(src, ax.size, ax.nd);
  for (int op = 0; op < NOP; ++op) take(src, ax.stride[op], ax.nd);
  n_out = 1;
  for (int i = 0; i < ax.nd; ++i) n_out *= ax.size[i];
  return true;
}

}  // namespace
}  // namespace zipup
}  // namespace repro

// a, b: the operands' storage (f32, or complex64 as interleaved (re, im)
// f32 pairs); out: the contiguous output.  args, an int64 host array:
// nd, size[nd], sa[nd], sb[nd] (element strides of each output axis into
// a and b, 0 where the operand lacks it), then three contracted axes as
// ksize[3], ka[3], kb[3] (size 1 and strides 0 for an unused one).  flags:
// bit 0 complex, bit 1 bf16 multiplicands, bits 2 and 3 read a and b
// conjugated.  Returns cudaGetLastError (cudaErrorInvalidValue for more
// than 8 output axes).
extern "C" int repro_zipup_pair(const void* a, const void* b, void* out,
                                const long long* args, int flags,
                                void* stream) {
  using namespace repro::zipup;
  PairArgs p;
  if (!take_axes(args, p.out, p.n_out))
    return static_cast<int>(cudaErrorInvalidValue);
  take(args, p.ksize, PAIR_K);
  for (int op = 0; op < 2; ++op) take(args, p.kstride[op], PAIR_K);
  if (p.n_out == 0) return 0;
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fo = static_cast<float*>(out);
  const dim3 grid(grid_of(p.n_out));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flags & F_COMPLEX) {
    if (flags & F_BF16)
      zipup_pair_kernel<true, true><<<grid, THREADS, 0, st>>>(fa, fb, fo, p,
                                                             flags);
    else
      zipup_pair_kernel<true, false><<<grid, THREADS, 0, st>>>(fa, fb, fo, p,
                                                              flags);
  } else {
    if (flags & F_BF16)
      zipup_pair_kernel<false, true><<<grid, THREADS, 0, st>>>(fa, fb, fo, p,
                                                              flags);
    else
      zipup_pair_kernel<false, false><<<grid, THREADS, 0, st>>>(fa, fb, fo,
                                                               p, flags);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y, z: the operands' storage (s0, tb0, tk0 of the two-layer site);
// out: the contiguous output.  args, an int64 host array: nd, size[nd],
// sx[nd], sy[nd], sz[nd] (element strides of each output axis into x, y
// and z), then the two outer contracted axes as osize[2], ox[2], oy[2],
// oz[2], then the inner one as isize, ix, iy.  flags: bit 0 complex, bit 1
// bf16 multiplicands (t1 included), bits 2, 3 and 4 read x, y and z
// conjugated, bit 5 rounds t1 alone to bf16.  Returns cudaGetLastError
// (cudaErrorInvalidValue for more than 8 output axes).
extern "C" int repro_zipup_chain(const void* x, const void* y, const void* z,
                                 void* out, const long long* args, int flags,
                                 void* stream) {
  using namespace repro::zipup;
  ChainArgs p;
  if (!take_axes(args, p.out, p.n_out))
    return static_cast<int>(cudaErrorInvalidValue);
  take(args, p.osize, 2);
  for (int op = 0; op < 3; ++op) take(args, p.ostride[op], 2);
  take(args, &p.isize, 1);
  take(args, p.istride, 2);
  if (p.n_out == 0) return 0;
  const float* fx = static_cast<const float*>(x);
  const float* fy = static_cast<const float*>(y);
  const float* fz = static_cast<const float*>(z);
  float* fo = static_cast<float*>(out);
  // the run of trailing output axes x and y lack, within one block
  int run = 1;
  for (int i = p.out.nd - 1; i >= 0; --i) {
    if (p.out.stride[0][i] || p.out.stride[1][i] ||
        run * p.out.size[i] > THREADS)
      break;
    run *= static_cast<int>(p.out.size[i]);
  }
  const int threads = THREADS / run * run;
  const size_t smem = THREADS / run * CHUNK * sizeof(float2);
  const long long blocks = (p.n_out + threads - 1) / threads;
  const dim3 grid(static_cast<int>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flags & F_COMPLEX) {
    if (flags & F_BF16)
      zipup_chain_kernel<true, true><<<grid, threads, smem, st>>>(
          fx, fy, fz, fo, p, flags, run);
    else
      zipup_chain_kernel<true, false><<<grid, threads, smem, st>>>(
          fx, fy, fz, fo, p, flags, run);
  } else {
    if (flags & F_BF16)
      zipup_chain_kernel<false, true><<<grid, threads, smem, st>>>(
          fx, fy, fz, fo, p, flags, run);
    else
      zipup_chain_kernel<false, false><<<grid, threads, smem, st>>>(
          fx, fy, fz, fo, p, flags, run);
  }
  return static_cast<int>(cudaGetLastError());
}
