// Mamba2 SSD chunked scan from a zero state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package,
// repro/kernels/ssd_scan.py: `ssd_scan` (`_kernel`).
//
// What it computes (exactly the Pallas function): X [B, L, H, P]
// (dt-scaled), dA [B, L, H] (log decay), Bm/Cm [B, L, H, N], chunk cs with
// L % cs == 0. Per (b, h), chunk by chunk with the state [P, N] starting
// at zero:
//   cum   = cumsum(dA_c)                                   [cs]
//   Y_c   = ((C_c B_c^T) o L) X_c + (C_c o exp(cum)) state^T,
//           L[i, j] = exp(cum_i - cum_j) for j <= i, else 0
//   state = exp(cum_last) state + (B_c o exp(cum_last - cum))^T X_c
// Inputs are f32 or bf16; the state and every sum are f32; Y is written in
// X's type and the final state [B, H, P, N] in f32. exp(cum) underflows to
// 0 over long chunks exactly as it does on the TPU: the formula is kept.
//
// What bounds it on an H100: the C B^T products, 2 * N operations per
// (i, j <= i) pair of each chunk, head and P split, on CUDA cores in f32;
// the bytes (X, dA, B, C read and Y, state written once) are a few
// hundred KB per head. The design against the TPU kernel's:
// - The TPU grid walked the chunks of one (b, h) in order with the state
//   in VMEM. Here one block owns (b, h, 16 columns of P) and loops over the
//   chunks itself, the state's 16 x N slice staying in shared memory.
// - Y's column p and the state's row p depend only on X's column p, so
//   splitting P over grid.z is exact; it turns 64 blocks at B = 1 into 256
//   (two per SM) at the price of recomputing C B^T per split.
// - One chunk of X, B and C in f32 at mamba2-1.3b (256 x 64 + 2 x 256 x
//   128 floats, 320 KB) does not fit in a block's 227 KB of shared memory.
//   The kernel tiles inside a chunk: 64-row sub-tiles of C against 64-key
//   sub-tiles of B with j <= i, so C, B and the scores hold 64 rows each.
// - The chunk's cumsum of dA is a block scan (warp shuffles, then warp
//   totals).
// Not yet done (later work): tensor-core MMA, sharing B/C across the heads
// of a group (the model repeats them over its 64 heads), pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, 8 warps
constexpr int kSub = 64;       // rows / keys of a sub-tile inside a chunk
constexpr int kPT = 16;        // columns of P per block
constexpr int kMaxChunk = 256;
constexpr int kMaxN = 128;

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

size_t smem_bytes(int N) {
  const size_t ns = N + 1;
  return sizeof(float) *
         (2 * kSub * ns + kPT * ns + (size_t)kMaxChunk * kPT +
          (size_t)kSub * (kSub + 1) + 3 * kMaxChunk);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ X, const T* __restrict__ dA,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                T* __restrict__ Y, float* __restrict__ state_out, int L,
                int H, int P, int N, int cs) {
  const int NS = N + 1;          // padded row stride of C, B and the state
  constexpr int SS = kSub + 1;   // padded row stride of the score tile
  extern __shared__ float smem[];
  float* c_s = smem;                  // C sub-tile [kSub][NS]
  float* b_s = c_s + kSub * NS;       // B sub-tile [kSub][NS]
  float* st = b_s + kSub * NS;        // state slice [kPT][NS]
  float* xs = st + kPT * NS;          // X chunk [kMaxChunk][kPT]
  float* sc = xs + kMaxChunk * kPT;   // masked, decayed scores [kSub][SS]
  float* cum = sc + kSub * SS;        // [kMaxChunk] cumsum of dA
  float* dend = cum + kMaxChunk;      // [kMaxChunk] exp(cum_last - cum_j)
  float* ecum = dend + kMaxChunk;     // [kMaxChunk] exp(cum_i)
  __shared__ float warp_tot[kThreads / 32];

  const int b = blockIdx.x, h = blockIdx.y, p0 = blockIdx.z * kPT;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int nsub = (cs + kSub - 1) / kSub;
  const int nc = L / cs;
  const int NC = N / 16;  // state columns per thread

  for (int i = tid; i < kPT * NS; i += kThreads) st[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int l0 = c * cs;
    __syncthreads();  // the previous chunk is done with xs, cum and st

    // inclusive cumsum of the chunk's dA: one element per thread
    float a = 0.f;
    if (tid < cs) a = to_f32(dA[((size_t)b * L + l0 + tid) * H + h]);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, a, o);
      if (lane >= o) a += y;
    }
    if (lane == 31) warp_tot[warp] = a;
    for (int i = tid; i < cs * kPT; i += kThreads) {
      const int j = i / kPT, p = i % kPT;
      xs[j * kPT + p] =
          to_f32(X[(((size_t)b * L + l0 + j) * H + h) * P + p0 + p]);
    }
    __syncthreads();
    for (int w = 0; w < warp; ++w) a += warp_tot[w];
    if (tid < cs) cum[tid] = a;
    __syncthreads();
    const float total = cum[cs - 1];
    if (tid < cs) {
      dend[tid] = expf(total - a);
      ecum[tid] = expf(a);
    }

    float supd[kMaxN / 16];  // state update: row p = ty, cols tx + 16 cc
#pragma unroll
    for (int cc = 0; cc < kMaxN / 16; ++cc) supd[cc] = 0.f;

    for (int qi = 0; qi < nsub; ++qi) {
      const int i0 = qi * kSub;
      __syncthreads();  // c_s is free; dend and ecum are visible
      for (int i = tid; i < kSub * N; i += kThreads) {
        const int r = i / N, n = i % N, row = i0 + r;
        c_s[r * NS + n] =
            row < cs ? to_f32(Cm[(((size_t)b * L + l0 + row) * H + h) * N + n])
                     : 0.f;
      }
      __syncthreads();

      // the carried state's part: exp(cum_i) * C_i . state[p]
      float y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc += c_s[r * NS + n] * st[tx * NS + n];
        y[i] = i0 + r < cs ? acc * ecum[i0 + r] : 0.f;
      }

      for (int kj = 0; kj <= qi; ++kj) {
        const int j0 = kj * kSub;
        __syncthreads();  // b_s and sc are free
        for (int i = tid; i < kSub * N; i += kThreads) {
          const int r = i / N, n = i % N, row = j0 + r;
          b_s[r * NS + n] =
              row < cs
                  ? to_f32(Bm[(((size_t)b * L + l0 + row) * H + h) * N + n])
                  : 0.f;
        }
        __syncthreads();

        // scores of rows ty + 16 i against keys tx + 16 j, masked j <= i
        // and decayed by exp(cum_i - cum_j)
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * NS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * NS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ri = i0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kj_ = j0 + tx + 16 * j;
            sc[(ty + 16 * i) * SS + tx + 16 * j] =
                (kj_ <= ri && ri < cs) ? s[i][j] * expf(cum[ri] - cum[kj_])
                                       : 0.f;
          }
        }
        __syncthreads();

        // Y rows ty + 16 i, column tx: the chunk's own part
        const int nk = min(kSub, cs - j0);
        for (int jj = 0; jj < nk; ++jj) {
          const float xv = xs[(j0 + jj) * kPT + tx];
#pragma unroll
          for (int i = 0; i < 4; ++i) y[i] += sc[(ty + 16 * i) * SS + jj] * xv;
        }
        if (qi == nsub - 1) {
          // the last row sub-tile walks every key sub-tile once: fold the
          // state update in while B's sub-tile is in shared memory
          for (int jj = 0; jj < nk; ++jj) {
            const float w = xs[(j0 + jj) * kPT + ty] * dend[j0 + jj];
#pragma unroll
            for (int cc = 0; cc < kMaxN / 16; ++cc)
              if (cc < NC) supd[cc] += w * b_s[jj * NS + tx + 16 * cc];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i0 + ty + 16 * i;
        if (row < cs)
          Y[(((size_t)b * L + l0 + row) * H + h) * P + p0 + tx] =
              from_f32<T>(y[i]);
      }
    }

    __syncthreads();  // every thread is done reading the old state
    const float decay = expf(total);
#pragma unroll
    for (int cc = 0; cc < kMaxN / 16; ++cc) {
      if (cc < NC) {
        float* e = st + ty * NS + tx + 16 * cc;
        *e = *e * decay + supd[cc];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kPT * N; i += kThreads) {
    const int p = i / N, n = i % N;
    state_out[(((size_t)b * H + h) * P + p0 + p) * N + n] = st[p * NS + n];
  }
}

template <typename T>
cudaError_t launch(const void* X, const void* dA, const void* Bm,
                   const void* Cm, void* Y, void* state, int B, int L, int H,
                   int P, int N, int cs, cudaStream_t stream) {
  if (cs < 1 || cs > kMaxChunk || L % cs || P % kPT || N % 16 || N > kMaxN)
    return cudaErrorInvalidValue;
  const dim3 grid(B, H, P / kPT);
  const size_t smem = smem_bytes(N);
  auto kernel = ssd_scan_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(dA),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<T*>(Y), static_cast<float*>(state), L, H, P, N, cs);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (X, dA, Bm, Cm and Y); the state is
// float32. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssd_scan_launch(int dtype, const void* X, const void* dA,
                               const void* Bm, const void* Cm, void* Y,
                               void* state, int B, int L, int H, int P, int N,
                               int cs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(X, dA, Bm, Cm, Y, state, B, L, H, P, N, cs, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(X, dA, Bm, Cm, Y, state, B, L, H, P, N,
                                      cs, s);
  return (int)cudaErrorInvalidValue;
}
