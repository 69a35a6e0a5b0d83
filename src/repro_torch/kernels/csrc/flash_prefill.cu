// Dense causal / sliding-window attention for prefill, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package,
// repro/kernels/flash_prefill.py: `flash_prefill` (`_kernel`).
//
// What it computes (exactly the Pallas function): q [B, Hq, Sq, D],
// k/v [B, Hkv, Skv, D] -> out [B, Hq, Sq, D]. Query row t of head hq sits
// at position q_offset + t and attends to key positions kp of KV head
// hq / G (G = Hq / Hkv) with kp <= q_offset + t when causal and
// q_offset + t - kp < window when a window is given. Scores and the online
// softmax are f32 whatever the input type; masked scores take the finite
// sentinel NEG_INF = -0.7 * FLT_MAX; the denominator is clamped at 1e-30;
// the output is rounded to the input type. Unlike the TPU kernel, Sq and
// Skv are arbitrary: the kernel bounds-checks its tiles (keys past Skv get
// weight 0, query rows past Sq are neither read nor written).
//
// What bounds it on an H100: at prompt lengths the engine serves (hundreds
// to thousands of tokens) the causal QK^T and PV products, 2 * 2 * D
// operations per (query row, valid key) pair; the bytes (q, k, v read and
// out written once) are a few MB. The design against the TPU kernel's:
// - The TPU grid walked KV tiles in order on one core with the accumulator
//   carried in VMEM across grid steps. Here one block owns (b, KV head,
//   tile of 64 query rows) and loops over its KV tiles itself, from the
//   first tile its window reaches to the last its causal limit reaches
//   (the TPU kernel's `relevant` test, so fully masked tiles cost nothing).
// - The G query heads of a KV head share the block's K/V tiles: query rows
//   are (t, g) pairs, g minor, so a tile of 64 rows covers 64 / G tokens of
//   every head and each K/V tile is read once for all of them.
// - Products run on CUDA cores in f32 as register tiles (each thread holds
//   4 x 2 scores and 4 x D/16 outputs), with Q, K, V and the scores in
//   shared memory (73 KB at D = 128, three blocks per SM).
// Not yet done (later work): tensor-core MMA for bf16, TMA and pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kRows = 64;      // query rows (token, head) per block
constexpr int kKeys = 32;      // keys per KV tile
constexpr float kNegInf = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)kRows * (D + 1) + (size_t)kKeys * (D + 1) +
         (size_t)kKeys * D + (size_t)kRows * (kKeys + 1) + 3 * kRows;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Hq,
                     int Hkv, int Sq, int Skv, int causal, int window,
                     int q_offset, float scale) {
  constexpr int QS = D + 1;      // padded row stride of the Q and K tiles
  constexpr int SS = kKeys + 1;  // padded row stride of the score tile
  constexpr int CPT = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // [kRows][QS]
  float* ks = qs + kRows * QS;       // [kKeys][QS]
  float* vs = ks + kKeys * QS;       // [kKeys][D]
  float* ss = vs + kKeys * D;        // [kRows][SS] scores, then weights
  float* m_s = ss + kRows * SS;      // [kRows] running max
  float* l_s = m_s + kRows;          // [kRows] running denominator
  float* a_s = l_s + kRows;          // [kRows] this tile's rescale

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = Hq / Hkv;
  const int rows = G * Sq;
  const int r0 = blockIdx.z * kRows;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t kv_base = ((size_t)b * Hkv + h) * Skv * D;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int rr = i / D, d = i % D, r = r0 + rr;
    float x = 0.f;
    if (r < rows) {
      const int t = r / G, g = r % G;
      x = to_f32(q[(((size_t)b * Hq + h * G + g) * Sq + t) * D + d]);
    }
    qs[rr * QS + d] = x;
  }
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // the KV tiles any row of this block can see
  const int r_last = min(r0 + kRows, rows) - 1;
  const int q_first = r0 / G + q_offset;
  const int q_last = r_last / G + q_offset;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin -= k_begin % kKeys;

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the previous tile's K, V and weights are consumed
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int kk = i / D, d = i % D, key = k0 + kk;
      float kx = 0.f, vx = 0.f;
      if (key < Skv) {
        kx = to_f32(k[kv_base + (size_t)key * D + d]);
        vx = to_f32(v[kv_base + (size_t)key * D + d]);
      }
      ks[kk * QS + d] = kx;
      vs[kk * D + d] = vx;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
      const float k0v = ks[tx * QS + d];
      const float k1v = ks[(tx + 16) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] += qv[i] * k0v;
        s[i][1] += qv[i] * k1v;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty + 16 * i, r = r0 + rr;
      const int qpos = r / G + q_offset;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + tx + 16 * j;
        float val;
        if (key >= Skv || r >= rows) {
          val = -INFINITY;  // no such key or row: weight exactly 0
        } else {
          const bool ok = (!causal || key <= qpos) &&
                          (window <= 0 || qpos - key < window);
          val = ok ? s[i][j] * scale : kNegInf;
        }
        ss[rr * SS + tx + 16 * j] = val;
      }
    }
    __syncthreads();

    // online softmax: four threads per row, eight keys each
    {
      const int rr = tid / 4, part = tid % 4;
      float* srow = ss + rr * SS + part * 8;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[rr];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[rr] = alpha;
        l_s[rr] = l_s[rr] * alpha + sum;
        m_s[rr] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty + 16 * i) * SS + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = vs[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
      }
    }
  }
  __syncthreads();  // l_s is final (and initialised when no tile ran)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty + 16 * i, r = r0 + rr;
    if (r >= rows) continue;
    const int t = r / G, g = r % G;
    const float denom = fmaxf(l_s[rr], 1e-30f);
    T* op = out + (((size_t)b * Hq + h * G + g) * Sq + t) * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      op[tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Hq, int Hkv, int Sq, int Skv, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  const int rows = (Hq / Hkv) * Sq;
  const dim3 grid(B, Hkv, (rows + kRows - 1) / kRows);
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_prefill_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Sq, Skv,
      causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int D, const void* q, const void* k, const void* v,
                   void* out, int B, int Hq, int Hkv, int Sq, int Skv,
                   int causal, int window, int q_offset, float scale,
                   cudaStream_t s) {
  // the head dims a caller launches: qwen2-1.5b's 128, and 64 for the
  // small card test; add others with the configs that need them
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, window,
                           q_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal,
                            window, q_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means none. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_prefill_launch(int dtype, const void* q, const void* k,
                                    const void* v, void* out, int B, int Hq,
                                    int Hkv, int Sq, int Skv, int D,
                                    int causal, int window, int q_offset,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)by_dim<float>(D, q, k, v, out, B, Hq, Hkv, Sq, Skv, causal,
                              window, q_offset, scale, s);
  if (dtype == 1)
    return (int)by_dim<__nv_bfloat16>(D, q, k, v, out, B, Hq, Hkv, Sq, Skv,
                                      causal, window, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
