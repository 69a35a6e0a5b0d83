// Paged attention over a block-tabled KV page store, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package,
// repro/kernels/paged_attention.py: `paged_prefill_attention`
// (`_fused_kernel`) and `paged_attention` (`_kernel`). One templated body
// serves both: the decode kernel is the Q = 1 case with
// q_start = seq_len - 1 and q_lens = 1, so at Q = 1 the two agree bit for
// bit.
//
// What it computes (exactly the Pallas function): query token t of row b
// sits at position q_start[b] + t and attends to positions
// <= q_start[b] + t of its sequence, whose pages block_tables[b] lists.
// Tokens t >= q_lens[b] are padding (written as zeros here). Scores and
// the online softmax are f32 whatever the input type, masked scores take
// the finite sentinel NEG_INF = -0.7 * FLT_MAX, the denominator is
// clamped at 1e-30, and the output is rounded to the input type.
//
// Layout: q/out [B, Q, Hq, D]; pages [P, page, Hkv, D] with D contiguous;
// block_tables [B, pps] int32. The G = Hq / Hkv query heads of one KV
// head share its pages: query rows are (g, t) pairs, t minor.
//
// What bounds it on an H100: the K/V bytes it must read (each valid page
// of each (row, KV head) once) at 3.35 TB/s; its arithmetic is tiny. The
// design against the TPU kernel's:
// - The TPU grid walked a row's pages in order on one core with the
//   accumulator carried in VMEM across grid steps. Here one block owns
//   (b, KV head, tile of 16 query rows) and loops over the row's pages
//   itself. It reads its block-table entries from device memory and stops
//   at the last page the tile's longest causal limit reaches, so it never
//   reads a table entry or a page past seq_len.
// - The TPU kept the whole [G*Q, D] f32 accumulator in VMEM. At full
//   width a 64-token prefill chunk has G*Q = 384 rows (192 KB of f32
//   accumulator), so the rows are split over grid.z; each row's softmax is
//   independent, so the split is exact.
// - Each page's [page, D] K and V tiles are loaded once per block with
//   16-byte loads, neighbouring threads on neighbouring addresses, into
//   shared memory as f32; each warp then serves 4 query rows from there
//   (a lane holds D/32 elements of q and of the accumulator).
// Not yet done (later work): a split along the sequence for small decode
// batches, tensor-core MMA, TMA and pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kSlotsPerStep = 8;  // key slots folded per softmax update
constexpr float kNegInf = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float warp_sum(float x) {
  // butterfly: every lane ends with the same (bitwise) sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 a = __bfloat1622float2(h[2 * i]);
    const float2 b = __bfloat1622float2(h[2 * i + 1]);
    *reinterpret_cast<float4*>(dst + 4 * i) = make_float4(a.x, a.y, b.x, b.y);
  }
}

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

// DECODE: `starts` holds seq_lens (q_start = seq_len - 1, q_lens = 1);
// otherwise it holds q_start and `q_lens` the valid tokens per row.
template <typename T, int D, bool DECODE>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ starts,
                       const int* __restrict__ q_lens, T* __restrict__ out,
                       int Q, int Hq, int Hkv, int page, int pps,
                       float scale) {
  constexpr int EPL = D / 32;  // elements of a row held by each lane
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  float* ks = smem;             // [page][D] f32
  float* vs = smem + page * D;  // [page][D] f32

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = Hq / Hkv;
  const int rows = G * Q;
  const int r0 = blockIdx.z * kRowsPerBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  int start, nq;
  if (DECODE) {
    start = starts[b] - 1;
    nq = 1;
  } else {
    start = starts[b];
    nq = q_lens[b];
  }

  // the tile's longest causal limit bounds the pages it must read
  int max_limit = -1;
  for (int r = r0; r < r0 + kRowsPerBlock && r < rows; ++r) {
    if (r % Q < nq) max_limit = max(max_limit, start + r % Q);
  }
  const int n_pages = max_limit < 0 ? 0 : min(max_limit / page + 1, pps);

  float qr[kRowsPerWarp][EPL];
  float acc[kRowsPerWarp][EPL];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  int limit[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + warp + kWarps * i;
    const int t = r % Q, g = r / Q;
    live[i] = r < rows && t < nq;
    limit[i] = start + t;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[i][e] = 0.f;
      qr[i][e] = 0.f;
    }
    if (live[i]) {
      const T* qp = q + (((size_t)b * Q + t) * Hq + h * G + g) * D + lane * EPL;
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[i][e] = to_f32(qp[e]);
    }
  }

  const int vecs_per_slot = D / VEC;
  for (int p = 0; p < n_pages; ++p) {
    const size_t phys = (size_t)block_tables[(size_t)b * pps + p];
    __syncthreads();  // every warp is done with the previous page
    for (int i = threadIdx.x; i < page * vecs_per_slot; i += blockDim.x) {
      const int j = i / vecs_per_slot;
      const int c = (i % vecs_per_slot) * VEC;
      const size_t off = ((phys * page + j) * Hkv + h) * D + c;
      load16(kp + off, ks + j * D + c);
      load16(vp + off, vs + j * D + c);
    }
    __syncthreads();
    const int base = p * page;
    for (int j0 = 0; j0 < page && base + j0 <= max_limit;
         j0 += kSlotsPerStep) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (!live[i]) continue;  // uniform across the warp
        float s[kSlotsPerStep];
        bool ok[kSlotsPerStep];
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < kSlotsPerStep; ++j) {
          const int jj = j0 + j;
          float dot = 0.f;
          if (jj < page) {
            const float* kr = ks + jj * D + lane * EPL;
#pragma unroll
            for (int e = 0; e < EPL; ++e) dot += qr[i][e] * kr[e];
          }
          dot = warp_sum(dot);
          ok[j] = jj < page && base + jj <= limit[i];
          s[j] = ok[j] ? dot * scale : kNegInf;
          mx = fmaxf(mx, s[j]);
        }
        const float alpha = expf(m[i] - mx);
        float psum = 0.f;
        float pv[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) pv[e] = 0.f;
#pragma unroll
        for (int j = 0; j < kSlotsPerStep; ++j) {
          if (!ok[j]) continue;
          const float pj = expf(s[j] - mx);
          psum += pj;
          const float* vr = vs + (j0 + j) * D + lane * EPL;
#pragma unroll
          for (int e = 0; e < EPL; ++e) pv[e] += pj * vr[e];
        }
        l[i] = l[i] * alpha + psum;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[i][e] = acc[i][e] * alpha + pv[e];
        m[i] = mx;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + warp + kWarps * i;
    if (r >= rows) continue;
    const int t = r % Q, g = r / Q;
    T* op = out + (((size_t)b * Q + t) * Hq + h * G + g) * D + lane * EPL;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      op[e] = from_f32<T>(live[i] ? acc[i][e] / denom : 0.f);
  }
}

template <typename T, int D, bool DECODE>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bt, const void* starts, const void* q_lens,
                   void* out, int B, int Q, int Hq, int Hkv, int page,
                   int pps, float scale, cudaStream_t stream) {
  const int rows = (Hq / Hkv) * Q;
  const dim3 grid(B, Hkv, (rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t smem = 2 * (size_t)page * D * sizeof(float);
  auto kernel = paged_attention_kernel<T, D, DECODE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(starts), static_cast<const int*>(q_lens),
      static_cast<T*>(out), Q, Hq, Hkv, page, pps, scale);
  return cudaGetLastError();
}

template <typename T, bool DECODE>
cudaError_t by_dim(int D, const void* q, const void* k, const void* v,
                   const void* bt, const void* starts, const void* q_lens,
                   void* out, int B, int Q, int Hq, int Hkv, int page,
                   int pps, float scale, cudaStream_t s) {
  // the head dims a caller launches: qwen2-1.5b's 128, and 32 for the
  // small card test; add others with the configs that need them
  switch (D) {
    case 32:
      return launch<T, 32, DECODE>(q, k, v, bt, starts, q_lens, out, B, Q,
                                   Hq, Hkv, page, pps, scale, s);
    case 128:
      return launch<T, 128, DECODE>(q, k, v, bt, starts, q_lens, out, B, Q,
                                    Hq, Hkv, page, pps, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool DECODE>
int by_type(int dtype, int D, const void* q, const void* k, const void* v,
            const void* bt, const void* starts, const void* q_lens,
            void* out, int B, int Q, int Hq, int Hkv, int page, int pps,
            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)by_dim<float, DECODE>(D, q, k, v, bt, starts, q_lens, out, B,
                                      Q, Hq, Hkv, page, pps, scale, s);
  if (dtype == 1)
    return (int)by_dim<__nv_bfloat16, DECODE>(D, q, k, v, bt, starts, q_lens,
                                              out, B, Q, Hq, Hkv, page, pps,
                                              scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int paged_prefill_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* q_start, const void* q_lens,
    void* out, int B, int Q, int Hq, int Hkv, int D, int page, int pps,
    float scale, void* stream) {
  return by_type<false>(dtype, D, q, k_pages, v_pages, block_tables, q_start,
                        q_lens, out, B, Q, Hq, Hkv, page, pps, scale, stream);
}

extern "C" int paged_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* seq_lens, void* out, int B, int Hq,
    int Hkv, int D, int page, int pps, float scale, void* stream) {
  return by_type<true>(dtype, D, q, k_pages, v_pages, block_tables, seq_lens,
                       nullptr, out, B, 1, Hq, Hkv, page, pps, scale, stream);
}
