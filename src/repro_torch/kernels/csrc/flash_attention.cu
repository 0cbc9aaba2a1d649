// Flash attention: O = softmax(Q K^T / sqrt(D)) V with an online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel /
// flash_attention (Pallas, TPU).
//
// What bounds it on the H100: causal attention does S (S + 1) D flops per
// (batch, head) in each of its two products (the causal half) against
// 2 (S + 2 Sk) D bytes of bf16 operands, hundreds of flops per byte, so
// arithmetic bounds it.  Each product counts at the peak for its operands:
// Q K^T has bf16 operands, which bf16 tensor cores with f32 accumulation
// multiply exactly (989 TFLOP/s); P V has the f32 operand P (67 TFLOP/s).
// At the served Zamba2 shape (4, 32, 2048, 80) that is 4.3e10 flops each,
// 0.043 ms + 0.641 ms = 0.685 ms.  This kernel does both in f32 FMA.
//
// Design: the TPU grid's sequential key axis becomes a loop inside the
// block.  One block of 256 threads (16 x 16) owns one 64-row query tile of
// one (batch, query head); it stages the scaled query tile once, then walks
// the key axis 64 keys at a time: the K and V tiles go to shared memory,
// S = Q K^T is held in registers (4 x 4 per thread), the running max and
// denominator of each row stay in registers (replicated over the 16
// threads of a half-warp that share the row, reduced with shuffles), and
// the f32 output tile (64 x D, 4 x D/16 per thread) stays in registers
// until the end.  P goes through shared memory for P V, in f32.  GQA reads
// KV head h / (Hq / Hkv) in place; nothing is repeated.  Causal blocks stop
// at the last key their last query row can see (the TPU kernel's pl.when
// guard); ragged edges are masked here, with no host-side padding: query
// rows past S are not written and keys past Sk are masked to -1e30 (their
// K and V rows are zero).  Q is scaled by 1/sqrt(D) and rounded to Q's
// dtype before the product, as the TPU wrapper does.  Operands are read
// through (batch, head, row) strides, so the (B, S, H, D) layout of the
// model needs no transpose.  Plain FMA in f32: no tensor cores yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {
namespace flash {

constexpr int BQ = 64;         // query rows per block
constexpr int BKV = 64;        // keys per step
constexpr int THREADS = 256;   // 16 x 16
constexpr int LD = 65;         // odd row stride of the transposed tiles
constexpr int MAX_D = 128;
constexpr int DC = MAX_D / 16; // output columns per thread (stride 16)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// v rounded to the operand type T and widened back.
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Strides {   // element strides of a (B, H, S, D) operand; D is unit
  long long b, h, s;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int hq, int group,
             int s, int sk, int d, int causal, float scale, Strides qs,
             Strides ks, Strides vs, Strides os) {
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
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int idx = threadIdx.x; idx < BQ * d; idx += THREADS) {
    const int i = idx / d, dd = idx % d;
    float val = 0.f;
    if (q0 + i < s) val = round_as(load(qb + (q0 + i) * qs.s + dd) * scale, q);
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
      Ks[dd * LD + j] = k0 + j < sk ? load(kb + (k0 + j) * ks.s + dd) : 0.f;
    }
    for (int idx = threadIdx.x; idx < BKV * dpad; idx += THREADS) {
      const int j = idx / dpad, dd = idx % dpad;
      Vs[idx] = (k0 + j < sk && dd < d) ? load(vb + (k0 + j) * vs.s + dd)
                                         : 0.f;
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

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= s) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dd = tx + 16 * c;
      if (dd < d) store(ob + i * os.s + dd, acc[r][c] / den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int hq, int hkv, int s, int sk, int d, int causal, Strides qs,
           Strides ks, Strides vs, Strides os, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(batch * hq, (s + BQ - 1) / BQ);
  flash_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hq / hkv, s, sk, d,
      causal, 1.0f / sqrtf(static_cast<float>(d)), qs, ks, vs, os);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
}  // namespace repro

// Shared memory one block needs for head dimension d (bytes).
extern "C" int repro_flash_attention_smem_bytes(int d) {
  using namespace repro::flash;
  const int dpad = (d + 15) / 16 * 16;
  return (2 * d * LD + BKV * dpad + BKV * LD) * static_cast<int>(sizeof(float));
}

// q: (batch, hq, s, d), k/v: (batch, hkv, sk, d), o: (batch, hq, s, d), all
// f32 (bf16 = 0) or all bf16 (bf16 = 1), unit stride over d and the given
// element strides over (batch, head, row).  d <= 128 and hq % hkv == 0 are
// checked by the Python wrapper.  Returns cudaGetLastError.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int batch, int hq,
    int hkv, int s, int sk, int d, int causal, int bf16, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh,
    long long oss, void* stream) {
  using namespace repro::flash;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  const int smem = repro_flash_attention_smem_bytes(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, batch, hq, hkv, s, sk, d, causal,
                                 qs, ks, vs, os, smem, st);
  return launch<float>(q, k, v, o, batch, hq, hkv, s, sk, d, causal, qs, ks,
                       vs, os, smem, st);
}
