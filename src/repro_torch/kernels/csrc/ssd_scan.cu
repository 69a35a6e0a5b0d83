// Mamba2 SSD chunked scan from a zero state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package,
// repro/kernels/ssd_scan.py: `ssd_scan` (`_kernel`).
//
// What it computes (exactly the Pallas function): X [B, L, H, P]
// (dt-scaled), dA [B, L, H] (log decay), Bm/Cm [B, L, G, N] with G | H
// (head h reads group h / (H / G), the order of the reference's
// jnp.repeat over the heads; G = H is the Pallas contract), chunk cs with
// L % cs == 0. Per (b, h), chunk by chunk with the state [P, N] starting
// at zero:
//   cum   = cumsum(dA_c)                                   [cs]
//   Y_c   = ((C_c B_c^T) o L) X_c + (C_c o exp(cum)) state^T,
//           L[i, j] = exp(cum_i - cum_j) for j <= i, else 0
//   state = exp(cum_last) state + (B_c o exp(cum_last - cum))^T X_c
// X and dA are f32 or bf16, Bm and Cm f32 or bf16 (each type on its own:
// the reference casts every input to f32 independently); the state and
// every sum are f32; Y is written in X's type and the final state
// [B, H, P, N] in f32. exp(cum), exp(cum_last - cum) and exp(cum_i - cum_j)
// keep the reference's formulas, so they underflow as they do there.
//
// What bounds it on an H100: the f32 products with X and with the state,
// on CUDA cores (at mamba2-1.3b, L 2048: ~6 GFLOP, ~0.09 ms at 67 TFLOP/s;
// the bytes, X and Y in f32, are ~70 MB, ~0.02 ms). C B^T is computed once
// per (b, chunk, group), on the tensor cores when B and C are bf16.
//
// The TPU kernel walked the chunks of one (b, h) in order on one core,
// with the state in VMEM and C B^T recomputed per head. Here the scan is
// the GPU form of SSD (arXiv:2405.21060 sections 6-7), four launches on
// the caller's stream, with f32 scratch the wrapper allocates:
// 1. `ssd_cb_mma` / `ssd_cb_fma`: C_c B_c^T, once per (b, chunk, group),
//    only the 64 x 64 tiles on or below the diagonal, into scratch. bf16
//    B/C: mma.sync m16n8k16 with f32 accumulators (a product of two bf16
//    values is exact in f32, so this is f32-exact up to the order of the
//    sums); f32 B/C: f32 FMAs (no rounding to bf16 or TF32).
// 2. `ssd_state_kernel`: every chunk's own state
//    (B_c o exp(cum_last - cum))^T X_c, in parallel over (b, chunk, h), and
//    the chunk's cumsum of dA into scratch.
// 3. `ssd_recur_kernel`: the only serial part, the [P, N] recurrence
//    state_{c+1} = exp(cum_last,c) state_c + S_c per (b, h), elementwise;
//    it leaves the state entering each chunk in the scratch of step 2
//    ([B, nc, H, N, P], 16.8 MB at mamba2-1.3b, L 2048) and writes the
//    final state.
// 4. `ssd_out_kernel`: Y = ((C B^T) o L) X + exp(cum) (C state_in^T), in
//    parallel over (b, chunk, h, 64-row tile), heaviest row tiles first.
// How that answers what held the first port at 13.8x its bound:
// - C B^T was computed 256 times over (64 heads sharing one group, four P
//   splits), and the model repeated B and C over the heads (67 MB each in
//   f32): now it is one causal half-product per (b, chunk, group), and B/C
//   are read per group in their own type.
// - f32 FMAs fed 8 shared loads per 16: the products of steps 2 and 4 are
//   register tiles fed by 16-byte shared loads along the reduction
//   (8 per 64 FMAs in step 4; 3, and one scalar, per 32 in step 2).
// - No copy was in flight during compute: each block streams its tiles
//   through a three-stage cp.async ring, each tile loaded once per block.
// - The chunks were a serial chain over 256 blocks: steps 2 and 4 run
//   512+ blocks at mamba2-1.3b, L 2048 (step 4: 2048), and only the
//   elementwise step 3 walks the chunks in order.
// Not yet done (later work): wgmma/TMA, 3xTF32 for the f32 products,
// folding step 3 into step 2 with a look-back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // steps 2 and 4 (16 x 16 threads)
constexpr int kTile = 64;      // rows, keys and columns of a tile
constexpr int kKeysS = 32;     // keys per ring stage in step 2
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kMaxChunk = 256;
constexpr int kMaxN = 128;
constexpr int kTileElems = kTile * kTile;

// padded row stride (elements) of a shared tile of `cols` elements of T:
// 16 bytes more than the row, so rows r and r + 1 read at one column fall
// in different banks and every row stays 16-byte aligned for cp.async
template <typename T, int cols>
constexpr int ld_pad() {
  return cols + 16 / (int)sizeof(T);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// four consecutive elements as f32 (bf16 widens exactly: its bits << 16)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(bf16* p, const float (&v)[4]) {
  // round to nearest even, as astype does
  uint2 u;
  u.x = mma::pack_bf16(v[0], v[1]);
  u.y = mma::pack_bf16(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

// Copy a [ROWS][COLS] tile of T (global row stride ld_g elements) into
// shared memory (row stride ld_s) with 16-byte cp.async; rows at or past
// rows_ok and columns at or past cols_ok (a multiple of 16 bytes) are
// written as zeros and not read.
template <typename T, int ROWS, int COLS, int NT>
__device__ __forceinline__ void tile_async(T* dst, int ld_s, const T* src,
                                           size_t ld_g, int rows_ok,
                                           int cols_ok) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CPR = COLS / E;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * E;
    const bool ok = r < rows_ok && c < cols_ok;
    mma::cp_async16(mma::smem_addr(dst + r * ld_s + c),
                    ok ? src + r * ld_g + c : src, ok);
  }
}

// acc[r][s] += sum_k A[ty + 16 r][k] * Bt[k][4 tx + s] over KT values of
// k: A row-major along k, Bt row-major along the output columns; each
// thread reads 16-byte rows of both (8 shared loads per 64 FMAs)
template <int KT, typename TA, typename TB>
__device__ __forceinline__ void fma_tile(const TA* A, int lda, const TB* Bt,
                                         int ldb, float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const TA* a_row = A + ty * lda;
  const TB* b_col = Bt + 4 * tx;
#pragma unroll 4
  for (int k = 0; k < KT; k += 4) {
    float a[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 v = ld4(a_row + 16 * r * lda + k);
      a[r][0] = v.x, a[r][1] = v.y, a[r][2] = v.z, a[r][3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 bv = ld4(b_col + (k + q) * ldb);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] += a[r][q] * bv.x;
        acc[r][1] += a[r][q] * bv.y;
        acc[r][2] += a[r][q] * bv.z;
        acc[r][3] += a[r][q] * bv.w;
      }
    }
  }
}

// (qi, kj), kj <= qi, of lower-triangular tile t = qi (qi + 1) / 2 + kj
__device__ __forceinline__ void tri_tile(int t, int& qi, int& kj) {
  qi = 0;
  while ((qi + 1) * (qi + 2) / 2 <= t) ++qi;
  kj = t - qi * (qi + 1) / 2;
}

// ---------------------------------------------------------------- step 1
// C B^T tile (qi, kj) of one (b, chunk, group) on the tensor cores: four
// warps of 16 rows x 64 keys, ldmatrix from XOR-swizzled [64][128] tiles
// (chunks past N are neither loaded nor read).
constexpr int kCbMmaThreads = 128;

__global__ void __launch_bounds__(kCbMmaThreads)
ssd_cb_mma(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
           float* __restrict__ cb, int L, int G, int N, int cs, int nc,
           int ntiles) {
  __shared__ __align__(128) bf16 c_s[kTile * kMaxN];
  __shared__ __align__(128) bf16 b_s[kTile * kMaxN];
  const int t = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / G, g = blockIdx.z % G;
  int qi, kj;
  tri_tile(t, qi, kj);
  const int i0 = qi * kTile, j0 = kj * kTile, l0 = c * cs;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t ld = (size_t)G * N;
  const bf16* csrc = Cm + ((size_t)b * L + l0 + i0) * ld + (size_t)g * N;
  const bf16* bsrc = Bm + ((size_t)b * L + l0 + j0) * ld + (size_t)g * N;
  const int cpr = N / 8;
  for (int i = tid; i < kTile * cpr; i += kCbMmaThreads) {
    const int r = i / cpr, ch = i % cpr;
    const bool okc = i0 + r < cs, okb = j0 + r < cs;
    mma::cp_async16(mma::smem_addr(c_s + mma::swz<kMaxN>(r, ch)),
                    okc ? csrc + r * ld + ch * 8 : Cm, okc);
    mma::cp_async16(mma::smem_addr(b_s + mma::swz<kMaxN>(r, ch)),
                    okb ? bsrc + r * ld + ch * 8 : Bm, okb);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  float s[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t af[4];
    const int row = warp * 16 + (lane % 8) + ((lane / 8) & 1) * 8;
    mma::ldsm_x4(af, mma::smem_addr(
                         c_s + mma::swz<kMaxN>(row, 2 * kk + lane / 16)));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      const int key = np * 16 + (lane % 8) + (lane / 16) * 8;
      mma::ldsm_x4(bf, mma::smem_addr(b_s + mma::swz<kMaxN>(
                                                key, 2 * kk + ((lane / 8) & 1))));
      mma::bf16_16816(s[2 * np], af, bf[0], bf[1]);
      mma::bf16_16816(s[2 * np + 1], af, bf[2], bf[3]);
    }
  }
  float* out = cb + ((((size_t)b * nc + c) * G + g) * ntiles + t) * kTileElems;
  const int qr = warp * 16 + lane / 4, qc = 2 * (lane % 4);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<float2*>(out + qr * kTile + nt * 8 + qc) =
        make_float2(s[nt][0], s[nt][1]);
    *reinterpret_cast<float2*>(out + (qr + 8) * kTile + nt * 8 + qc) =
        make_float2(s[nt][2], s[nt][3]);
  }
}

// The same tile from f32 B/C, in f32 on CUDA cores: rows ty + 16 r, keys
// tx + 16 s, both operands read along N.
constexpr int kCbLd = ld_pad<float, kMaxN>();

size_t cb_fma_smem() { return sizeof(float) * 2 * kTile * kCbLd; }

__global__ void __launch_bounds__(kThreads)
ssd_cb_fma(const float* __restrict__ Bm, const float* __restrict__ Cm,
           float* __restrict__ cb, int L, int G, int N, int cs, int nc,
           int ntiles) {
  extern __shared__ __align__(16) float smf[];
  float* c_s = smf;                 // [64][kCbLd]
  float* b_s = c_s + kTile * kCbLd;  // [64][kCbLd]
  const int t = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / G, g = blockIdx.z % G;
  int qi, kj;
  tri_tile(t, qi, kj);
  const int i0 = qi * kTile, j0 = kj * kTile, l0 = c * cs;
  const size_t ld = (size_t)G * N;
  tile_async<float, kTile, kMaxN, kThreads>(
      c_s, kCbLd, Cm + ((size_t)b * L + l0 + i0) * ld + (size_t)g * N, ld,
      cs - i0, N);
  tile_async<float, kTile, kMaxN, kThreads>(
      b_s, kCbLd, Bm + ((size_t)b * L + l0 + j0) * ld + (size_t)g * N, ld,
      cs - j0, N);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int n = 0; n < N; n += 4) {
    float4 a[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = ld4(c_s + (ty + 16 * r) * kCbLd + n);
#pragma unroll
    for (int s = 0; s < 4; ++s) bv[s] = ld4(b_s + (tx + 16 * s) * kCbLd + n);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float v = acc[r][s];
        v += a[r].x * bv[s].x;
        v += a[r].y * bv[s].y;
        v += a[r].z * bv[s].z;
        v += a[r].w * bv[s].w;
        acc[r][s] = v;
      }
  }
  float* out = cb + ((((size_t)b * nc + c) * G + g) * ntiles + t) * kTileElems;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s)
      out[(ty + 16 * r) * kTile + tx + 16 * s] = acc[r][s];
}

// ---------------------------------------------------------------- step 2
// One chunk's own state S_c^T [N][P-tile] = sum_j B[j][n] dend_j X[j][p]
// (dend_j = exp(cum_last - cum_j)) for (b, chunk, h, 64 columns of P);
// thread (ty, tx) holds rows n = 4 ty + r and 64 + 4 ty + r, columns
// 4 tx + s. The chunk's cumsum of dA is a block scan (warp shuffles, then
// warp totals); P tile 0 writes it to scratch for steps 3 and 4.
template <typename TX, typename TB>
struct StateSmem {
  static constexpr int LDA = ld_pad<TB, kMaxN>();
  static constexpr int LDB = ld_pad<TX, kTile>();
  static constexpr size_t A_BYTES = sizeof(TB) * kKeysS * LDA;
  static constexpr size_t STAGE = A_BYTES + sizeof(TX) * kKeysS * LDB;
  static constexpr size_t BYTES = kStages * STAGE + sizeof(float) * 2 * kMaxChunk;
};

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const TX* __restrict__ X, const TX* __restrict__ dA,
                 const TB* __restrict__ Bm, float* __restrict__ states,
                 float* __restrict__ cum_out, int L, int H, int G, int P,
                 int N, int cs, int nc) {
  using S = StateSmem<TX, TB>;
  extern __shared__ __align__(16) unsigned char sm[];
  float* cum = reinterpret_cast<float*>(sm + kStages * S::STAGE);
  float* dend = cum + kMaxChunk;
  __shared__ float warp_tot[kThreads / 32];

  const int pt = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int g = h / (H / G), p0 = pt * kTile, l0 = c * cs;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const size_t ldb = (size_t)G * N, ldx = (size_t)H * P;
  const TB* bsrc = Bm + ((size_t)b * L + l0) * ldb + (size_t)g * N;
  const TX* xsrc = X + ((size_t)b * L + l0) * ldx + (size_t)h * P + p0;
  const int nsteps = (cs + kKeysS - 1) / kKeysS;

  auto a_st = [&](int st) { return reinterpret_cast<TB*>(sm + st * S::STAGE); };
  auto b_st = [&](int st) {
    return reinterpret_cast<TX*>(sm + st * S::STAGE + S::A_BYTES);
  };
  auto issue = [&](int t) {
    if (t < nsteps) {
      const int st = t % kStages, j0 = t * kKeysS;
      tile_async<TB, kKeysS, kMaxN, kThreads>(a_st(st), S::LDA,
                                              bsrc + j0 * ldb, ldb, cs - j0, N);
      tile_async<TX, kKeysS, kTile, kThreads>(b_st(st), S::LDB,
                                              xsrc + j0 * ldx, ldx, cs - j0,
                                              P - p0);
    }
    mma::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  // inclusive cumsum of the chunk's dA (overlaps the copies)
  float a = 0.f;
  if (tid < cs) a = to_f32(dA[((size_t)b * L + l0 + tid) * H + h]);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, a, o);
    if (lane >= o) a += y;
  }
  if (lane == 31) warp_tot[warp] = a;
  __syncthreads();
  for (int w = 0; w < warp; ++w) a += warp_tot[w];
  cum[tid] = a;
  if (pt == 0 && tid < cs) cum_out[((size_t)b * H + h) * L + l0 + tid] = a;
  __syncthreads();
  dend[tid] = tid < cs ? expf(cum[cs - 1] - a) : 0.f;  // visible below

  float acc[8][4] = {};
  for (int t = 0; t < nsteps; ++t) {
    mma::cp_async_wait<kStages - 2>();  // tile t has landed ...
    __syncthreads();  // ... for every thread, and tile t - 1 is consumed
    issue(t + kStages - 1);
    const TB* A = a_st(t % kStages);
    const TX* Bx = b_st(t % kStages);
    const float* dj = dend + t * kKeysS;
#pragma unroll 4
    for (int jj = 0; jj < kKeysS; ++jj) {
      const float w = dj[jj];
      const float4 a0 = ld4(A + jj * S::LDA + 4 * ty);
      const float4 a1 = ld4(A + jj * S::LDA + kTile + 4 * ty);
      float4 x = ld4(Bx + jj * S::LDB + 4 * tx);
      x.x *= w, x.y *= w, x.z *= w, x.w *= w;
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        acc[r][0] += av[r] * x.x;
        acc[r][1] += av[r] * x.y;
        acc[r][2] += av[r] * x.z;
        acc[r][3] += av[r] * x.w;
      }
    }
  }
  mma::cp_async_wait<0>();  // no copy outlives the block

  float* out = states + (((size_t)b * nc + c) * H + h) * N * P;  // [N][P]
  if (p0 + 4 * tx < P) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int n = (r < 4 ? 0 : kTile) + 4 * ty + (r & 3);
      if (n < N) st4(out + (size_t)n * P + p0 + 4 * tx, acc[r]);
    }
  }
}

// ---------------------------------------------------------------- step 3
// The recurrence over the chunks, one thread per state element (n, p) of
// one (b, h): the chunk's own state in `states` is replaced by the state
// entering the chunk, and the final state goes out as [B, H, P, N]. The
// loads of kAhead chunks are issued before their updates, so the walk
// waits on memory once per kAhead chunks, not once per chunk.
constexpr int kAhead = 8;

__global__ void __launch_bounds__(kThreads)
ssd_recur_kernel(float* __restrict__ states, const float* __restrict__ cum,
                 float* __restrict__ state_out, int L, int H, int P, int N,
                 int cs, int nc) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= N * P) return;
  const int n = e / P, p = e % P;
  const size_t NP = (size_t)N * P, step = (size_t)H * NP;
  const float* last = cum + ((size_t)b * H + h) * L + cs - 1;
  float* s = states + ((size_t)b * nc * H + h) * NP + e;
  float st = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float own[kAhead], decay[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (c0 + u < nc) {
        own[u] = s[(c0 + u) * step];
        decay[u] = expf(last[(size_t)(c0 + u) * cs]);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (c0 + u < nc) {
        s[(c0 + u) * step] = st;
        st = st * decay[u] + own[u];
      }
    }
  }
  state_out[(((size_t)b * H + h) * P + p) * N + n] = st;
}

// ---------------------------------------------------------------- step 4
// Y rows [i0, i0 + 64) x 64 columns of P of one (b, chunk, h). The steps
// through the ring: first the carried state's part over N in tiles of 64
// (A = C rows, B = state_in^T; none for chunk 0, whose state is zero),
// scaled by exp(cum_i); then the chunk's own part over the key tiles
// kj <= qi (A = the C B^T tile, decayed and masked in place into
// exp(cum_i - cum_j) C_i.B_j for j <= i, B = X rows). Thread (ty, tx)
// holds rows ty + 16 r and columns 4 tx + s.
template <typename TX, typename TB>
struct OutSmem {
  static constexpr int LDF = ld_pad<float, kTile>();  // f32 tiles
  static constexpr int LDC = ld_pad<TB, kTile>();     // C tiles
  static constexpr int LDX = ld_pad<TX, kTile>();     // X tiles
  static constexpr size_t HALF = sizeof(float) * kTile * LDF;
  static constexpr size_t STAGE = 2 * HALF;
  static constexpr size_t BYTES =
      kStages * STAGE + sizeof(float) * (kMaxChunk + kTile);
  static_assert(sizeof(TB) * kTile * LDC <= HALF, "C tile");
  static_assert(sizeof(TX) * kTile * LDX <= HALF, "X tile");
};

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads)
ssd_out_kernel(const TX* __restrict__ X, const TB* __restrict__ Cm,
               const float* __restrict__ cb, const float* __restrict__ states,
               const float* __restrict__ cum_in, TX* __restrict__ Y, int L,
               int H, int G, int P, int N, int cs, int nc, int ntiles) {
  using S = OutSmem<TX, TB>;
  extern __shared__ __align__(16) unsigned char sm[];
  float* cum = reinterpret_cast<float*>(sm + kStages * S::STAGE);
  float* ecum = cum + kMaxChunk;

  const int T = (cs + kTile - 1) / kTile;
  const int qi = T - 1 - (int)(blockIdx.x % T);  // longest walk first
  const int pt = blockIdx.x / T, h = blockIdx.y;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int g = h / (H / G), p0 = pt * kTile, l0 = c * cs, i0 = qi * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t ldc = (size_t)G * N, ldx = (size_t)H * P;
  const TB* csrc = Cm + ((size_t)b * L + l0 + i0) * ldc + (size_t)g * N;
  const TX* xsrc = X + ((size_t)b * L + l0) * ldx + (size_t)h * P + p0;
  const float* ssrc = states + (((size_t)b * nc + c) * H + h) * N * P + p0;
  const float* cbsrc =
      cb + (((size_t)b * nc + c) * G + g) * ntiles * kTileElems;
  const int nko = c > 0 ? (N + kTile - 1) / kTile : 0;
  const int nsteps = nko + qi + 1;

  auto a_st = [&](int st) { return sm + st * S::STAGE; };
  auto b_st = [&](int st) { return sm + st * S::STAGE + S::HALF; };
  auto issue = [&](int t) {
    if (t < nsteps) {
      const int st = t % kStages;
      if (t < nko) {
        const int n0 = t * kTile;
        tile_async<TB, kTile, kTile, kThreads>(
            reinterpret_cast<TB*>(a_st(st)), S::LDC, csrc + n0, ldc, cs - i0,
            N - n0);
        tile_async<float, kTile, kTile, kThreads>(
            reinterpret_cast<float*>(b_st(st)), S::LDF,
            ssrc + (size_t)n0 * P, P, N - n0, P - p0);
      } else {
        const int kj = t - nko, j0 = kj * kTile;
        tile_async<float, kTile, kTile, kThreads>(
            reinterpret_cast<float*>(a_st(st)), S::LDF,
            cbsrc + (size_t)(qi * (qi + 1) / 2 + kj) * kTileElems, kTile,
            kTile, kTile);
        tile_async<TX, kTile, kTile, kThreads>(
            reinterpret_cast<TX*>(b_st(st)), S::LDX, xsrc + j0 * ldx, ldx,
            cs - j0, P - p0);
      }
    }
    mma::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  // the chunk's cumsum (step 2) and exp(cum_i) of this block's rows
  const float* cin = cum_in + ((size_t)b * H + h) * L + l0;
  cum[tid] = tid < cs ? cin[tid] : 0.f;
  if (tid < kTile) ecum[tid] = i0 + tid < cs ? expf(cin[i0 + tid]) : 0.f;
  // (visible after the ring's first barrier)

  float acc[4][4] = {};
  for (int t = 0; t < nsteps; ++t) {
    mma::cp_async_wait<kStages - 2>();  // tile t has landed ...
    __syncthreads();  // ... for every thread, and tile t - 1 is consumed
    issue(t + kStages - 1);
    const int st = t % kStages;
    if (t < nko) {
      fma_tile<kTile>(reinterpret_cast<const TB*>(a_st(st)), S::LDC,
                      reinterpret_cast<const float*>(b_st(st)), S::LDF, acc);
      if (t == nko - 1) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float e = ecum[ty + 16 * r];
          acc[r][0] *= e, acc[r][1] *= e, acc[r][2] *= e, acc[r][3] *= e;
        }
      }
    } else {
      const int j0 = (t - nko) * kTile;
      float* A = reinterpret_cast<float*>(a_st(st));
#pragma unroll 4
      for (int i = tid; i < kTileElems; i += kThreads) {
        const int r = i / kTile, k = i % kTile;
        const int row = i0 + r, key = j0 + k;
        float* v = A + r * S::LDF + k;
        *v = (key <= row && row < cs) ? *v * expf(cum[row] - cum[key]) : 0.f;
      }
      __syncthreads();
      fma_tile<kTile>(static_cast<const float*>(A), S::LDF,
                      reinterpret_cast<const TX*>(b_st(st)), S::LDX, acc);
    }
  }
  mma::cp_async_wait<0>();  // no copy outlives the block

  if (p0 + 4 * tx < P) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = i0 + ty + 16 * r;
      if (row < cs)
        st4(Y + ((size_t)b * L + l0 + row) * ldx + (size_t)h * P + p0 + 4 * tx,
            acc[r]);
    }
  }
}

// ---------------------------------------------------------------- launch
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct Work {  // f32 scratch, in this order (each region 16-byte aligned)
  size_t states, cb, cum;
  size_t total() const { return states + cb + cum; }
};

Work work_floats(int B, int L, int H, int G, int P, int N, int cs) {
  const int nc = L / cs, T = (cs + kTile - 1) / kTile;
  return Work{(size_t)B * nc * H * N * P,
              (size_t)B * nc * G * (T * (T + 1) / 2) * kTileElems,
              (size_t)B * H * L};
}

template <typename TX, typename TB>
cudaError_t launch(const void* X, const void* dA, const void* Bm,
                   const void* Cm, void* Y, void* state, float* work, int B,
                   int L, int H, int G, int P, int N, int cs,
                   cudaStream_t stream) {
  const int nc = L / cs, T = (cs + kTile - 1) / kTile;
  const int ntiles = T * (T + 1) / 2, PT = (P + kTile - 1) / kTile;
  const Work w = work_floats(B, L, H, G, P, N, cs);
  float* states = work;
  float* cb = states + w.states;
  float* cum = cb + w.cb;
  const TB* bm = static_cast<const TB*>(Bm);
  const TB* cm = static_cast<const TB*>(Cm);
  cudaError_t e;

  // 1. C B^T per (b, chunk, group)
  const dim3 g1(ntiles, nc, B * G);
  if constexpr (sizeof(TB) == 2) {
    ssd_cb_mma<<<g1, kCbMmaThreads, 0, stream>>>(bm, cm, cb, L, G, N, cs, nc,
                                                 ntiles);
  } else {
    static bool ready = false;
    if (!ready) {
      if ((e = allow_smem(ssd_cb_fma, cb_fma_smem())) != cudaSuccess) return e;
      ready = true;
    }
    ssd_cb_fma<<<g1, kThreads, cb_fma_smem(), stream>>>(bm, cm, cb, L, G, N,
                                                        cs, nc, ntiles);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  // 2. every chunk's own state and the cumsums
  {
    auto k = ssd_state_kernel<TX, TB>;
    const size_t smem = StateSmem<TX, TB>::BYTES;
    static bool ready = false;
    if (!ready) {
      if ((e = allow_smem(k, smem)) != cudaSuccess) return e;
      ready = true;
    }
    k<<<dim3(PT, H, B * nc), kThreads, smem, stream>>>(
        static_cast<const TX*>(X), static_cast<const TX*>(dA), bm, states,
        cum, L, H, G, P, N, cs, nc);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }

  // 3. the recurrence over the chunks
  ssd_recur_kernel<<<dim3((N * P + kThreads - 1) / kThreads, H, B), kThreads,
                     0, stream>>>(states, cum, static_cast<float*>(state), L,
                                  H, P, N, cs, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  // 4. Y
  {
    auto k = ssd_out_kernel<TX, TB>;
    const size_t smem = OutSmem<TX, TB>::BYTES;
    static bool ready = false;
    if (!ready) {
      if ((e = allow_smem(k, smem)) != cudaSuccess) return e;
      ready = true;
    }
    k<<<dim3(T * PT, H, B * nc), kThreads, smem, stream>>>(
        static_cast<const TX*>(X), cm, cb, states, cum,
        static_cast<TX*>(Y), L, H, G, P, N, cs, nc, ntiles);
  }
  return cudaGetLastError();
}

bool shape_ok(int B, int L, int H, int G, int P, int N, int cs) {
  return B >= 1 && cs >= 1 && cs <= kMaxChunk && L >= cs && L % cs == 0 &&
         G >= 1 && H % G == 0 && P >= 16 && P % 16 == 0 && N >= 16 &&
         N % 16 == 0 && N <= kMaxN;
}

}  // namespace

// f32 scratch (elements) that ssd_scan_launch needs for these shapes, or
// -1 if the kernel does not take them.
extern "C" long long ssd_scan_work_floats(int B, int L, int H, int G, int P,
                                          int N, int cs) {
  if (!shape_ok(B, L, H, G, P, N, cs)) return -1;
  return (long long)work_floats(B, L, H, G, P, N, cs).total();
}

// x_dtype (X, dA and Y) and bc_dtype (Bm and Cm): 0 = float32,
// 1 = bfloat16; the state is float32. `work` holds at least
// ssd_scan_work_floats(...) floats, 16-byte aligned. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int ssd_scan_launch(int x_dtype, int bc_dtype, const void* X,
                               const void* dA, const void* Bm, const void* Cm,
                               void* Y, void* state, void* work,
                               long long work_floats_given, int B, int L,
                               int H, int G, int P, int N, int cs,
                               void* stream) {
  if (!shape_ok(B, L, H, G, P, N, cs) ||
      work_floats_given < ssd_scan_work_floats(B, L, H, G, P, N, cs) ||
      reinterpret_cast<uintptr_t>(work) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  if (x_dtype == 0 && bc_dtype == 0)
    return (int)launch<float, float>(X, dA, Bm, Cm, Y, state, w, B, L, H, G,
                                     P, N, cs, s);
  if (x_dtype == 0 && bc_dtype == 1)
    return (int)launch<float, bf16>(X, dA, Bm, Cm, Y, state, w, B, L, H, G, P,
                                    N, cs, s);
  if (x_dtype == 1 && bc_dtype == 0)
    return (int)launch<bf16, float>(X, dA, Bm, Cm, Y, state, w, B, L, H, G, P,
                                    N, cs, s);
  if (x_dtype == 1 && bc_dtype == 1)
    return (int)launch<bf16, bf16>(X, dA, Bm, Cm, Y, state, w, B, L, H, G, P,
                                   N, cs, s);
  return (int)cudaErrorInvalidValue;
}
