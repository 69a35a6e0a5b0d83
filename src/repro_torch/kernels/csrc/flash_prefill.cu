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
// out written once) are a few MB. The design against the TPU kernel's,
// common to both types:
// - The TPU grid walked KV tiles in order on one core with the accumulator
//   carried in VMEM across grid steps. Here one block owns (b, KV head,
//   tile of 64 query rows) and loops over its KV tiles itself, from the
//   first tile its window reaches to the last its causal limit reaches
//   (the TPU kernel's `relevant` test, so fully masked tiles cost nothing).
// - The G query heads of a KV head share the block's K/V tiles: query rows
//   are (t, g) pairs, g minor, so a tile of 64 rows covers 64 / G tokens of
//   every head and each K/V tile is read once for all of them.
//
// The type picks the arithmetic (a dispatch on the type, not a fallback):
// - float32 (`flash_prefill_f32`): products on CUDA cores in f32 as
//   register tiles (each thread holds 4 x 2 scores and 4 x D/16 outputs),
//   with Q, K, V and the scores in shared memory (73 KB at D = 128). TF32
//   would not hold the f32 path's 2e-5 agreement with the reference.
// - bfloat16 (`flash_prefill_bf16`): FlashAttention-2 on the tensor cores.
//   Four warps each own 16 of the block's 64 rows; QK^T and PV are
//   mma.sync m16n8k16 (bf16 in, f32 accumulators) fed by ldmatrix (.trans
//   for V) from XOR-swizzled shared tiles. Q's fragments stay in registers
//   for the whole walk; the scores, the online-softmax statistics (m, l)
//   and the output accumulator stay in f32 registers. P is rounded to bf16
//   in registers to become the A operand of PV: the one rounding the f32
//   plain version does not have (relative 2^-9 on each weight, averaged
//   over the keys; well inside the bf16 tolerance of 2e-2). K/V tiles of
//   64 keys go through a two-stage cp.async ring: tile j+1 loads while
//   tile j computes; keys past Skv load as zeros (src-size 0) and score
//   -inf. The element mask runs only on tiles that straddle a mask edge
//   (the causal diagonal, the window's start or Skv), decided per warp.
//   Blocks are launched longest causal walk first, so the grid's tail is
//   short. On the H100 this kernel is bound by instruction issue more
//   than by the tensor cores, so the loop is kept lean: each thread's
//   copy addresses are computed once, scores are kept in log2 units (one
//   ex2 per weight), the accumulator is rescaled only when a row's max
//   moves, and the output leaves through shared memory in 16-byte rows.
// Not yet done (later work): wgmma, TMA and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kRows = 64;      // query rows (token, head) per block
constexpr int kKeys = 32;      // keys per KV tile
constexpr float kNegInf = -0.7f * 3.402823466e38f;

template <int D>
constexpr size_t smem_floats() {
  return (size_t)kRows * (D + 1) + (size_t)kKeys * (D + 1) +
         (size_t)kKeys * D + (size_t)kRows * (kKeys + 1) + 3 * kRows;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int Hq,
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
      x = q[(((size_t)b * Hq + h * G + g) * Sq + t) * D + d];
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
        kx = k[kv_base + (size_t)key * D + d];
        vx = v[kv_base + (size_t)key * D + d];
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
    float* op = out + (((size_t)b * Hq + h * G + g) * Sq + t) * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      op[tx + 16 * j] = acc[i][j] / denom;
  }
}


// ---------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows per block
constexpr int kMmaKeys = 64;              // keys per K/V tile
constexpr int kStages = 2;                // K/V tiles in the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t bf16_smem_bytes() {
  return ((size_t)kMmaRows * D + 2 * (size_t)kStages * kMmaKeys * D) *
         sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_prefill_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int Sq,
                   int Skv, int causal, int window, int q_offset,
                   float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int kThreadsMma = kMmaWarps * 32;
  constexpr int CH = D / 8;         // 16-byte chunks of a row
  constexpr int KS = D / 16;        // k-steps of QK^T
  constexpr int NT = kMmaKeys / 8;  // n8 tiles of a score tile
  constexpr int DT = D / 8;         // n8 tiles of the output
  constexpr int RPL = kThreadsMma / CH;           // rows per load pass
  constexpr int KV_PASSES = kMmaKeys / RPL;       // of a K/V tile
  static_assert(RPL % 8 == 0, "a pass keeps the row's swizzle phase");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kMmaRows][D]
  bf16* ks = qs + kMmaRows * D;                  // [kStages][kMmaKeys][D]
  bf16* vs = ks + kStages * kMmaKeys * D;        // [kStages][kMmaKeys][D]

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = Hq / Hkv;
  const int rows = G * Sq;
  // the last row tile has the longest causal walk: launch it first
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kMmaRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // each thread copies chunk `lc` of rows lr, lr + RPL, ...: the row's
  // swizzle phase (row & 7) is the same in every pass
  const int lr = tid / CH, lc = tid % CH;
  for (int p = 0; p < kMmaRows / RPL; ++p) {
    const int rr = lr + p * RPL, r = r0 + rr;
    const bool ok = r < rows;
    const int t = ok ? r / G : 0, g = ok ? r % G : 0;
    const bf16* src = q + (((size_t)b * Hq + h * G + g) * Sq + t) * D + lc * 8;
    mma::cp_async16(mma::smem_addr(qs + mma::swz<D>(rr, lc)), src, ok);
  }

  // the KV tiles any row of this block can see
  const int r_last = min(r0 + kMmaRows, rows) - 1;
  const int q_first = r0 / G + q_offset;
  const int q_last = r_last / G + q_offset;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin -= k_begin % kMmaKeys;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kMmaKeys - 1) / kMmaKeys : 0;

  const size_t kv_base = ((size_t)b * Hkv + h) * Skv * D + lc * 8;
  const uint32_t ks_lane = mma::smem_addr(ks + mma::swz<D>(lr, lc));
  const uint32_t vs_lane = mma::smem_addr(vs + mma::swz<D>(lr, lc));
  auto load_kv = [&](int tile, int stage) {
    const int key0 = k_begin + tile * kMmaKeys + lr;
    const uint32_t so = stage * kMmaKeys * D * sizeof(bf16);
#pragma unroll
    for (int p = 0; p < KV_PASSES; ++p) {
      const int key = key0 + p * RPL;
      const bool ok = key < Skv;
      const size_t off = kv_base + (size_t)(ok ? key : 0) * D;
      const uint32_t o = so + p * RPL * D * sizeof(bf16);
      mma::cp_async16(ks_lane + o, k + off, ok);
      mma::cp_async16(vs_lane + o, v + off, ok);
    }
  };
  // the first group also carries Q
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_kv(st, st);
    mma::cp_async_commit();
  }

  // this thread's two rows (fragment rows lane/4 and lane/4 + 8) and the
  // warp's bounds for the per-warp mask test
  const int wr0 = r0 + warp * 16;
  const int row_a = wr0 + lane / 4, row_b = row_a + 8;
  const int qpos[2] = {row_a / G + q_offset, row_b / G + q_offset};
  const int wq_first = wr0 / G + q_offset;
  const int wq_last = (min(wr0 + 15, rows - 1)) / G + q_offset;
  const int qc = 2 * (lane % 4);
  // scores are kept in log2 units (scale * log2 e folded in), so each
  // weight is one ex2 of a difference; masked scores take the same
  // finite NEG_INF sentinel and give the same weights (0, or uniform
  // over a row with no visible key)
  const float scale2 = scale * kLog2e;

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t qf[KS][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    mma::cp_async_wait<kStages - 2>();  // tile j (and Q) has landed ...
    __syncthreads();  // ... for every thread, and tile j-1 is consumed
    // refill the stage tile j-1 used
    if (j + kStages - 1 < n_tiles)
      load_kv(j + kStages - 1, (j + kStages - 1) % kStages);
    mma::cp_async_commit();
    if (j == 0) {  // Q's fragments stay in registers for the whole walk
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int row = warp * 16 + (lane % 8) + ((lane / 8) & 1) * 8;
        mma::ldsm_x4(qf[kk], mma::smem_addr(
                                 qs + mma::swz<D>(row, 2 * kk + lane / 16)));
      }
    }
    const int k0 = k_begin + j * kMmaKeys;
    const bf16* kt = ks + stage * kMmaKeys * D;
    const bf16* vt = vs + stage * kMmaKeys * D;

    // S = Q K^T: ldmatrix x4 gives the B fragments of two n8 tiles
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        const int key = np * 16 + (lane % 8) + (lane / 16) * 8;
        mma::ldsm_x4(bf, mma::smem_addr(
                             kt + mma::swz<D>(key, 2 * kk + ((lane / 8) & 1))));
        mma::bf16_16816(s[2 * np], qf[kk], bf[0], bf[1]);
        mma::bf16_16816(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale; the element mask only where the tile crosses an edge
    const bool edge = k0 + kMmaKeys > Skv ||
                      (causal && k0 + kMmaKeys - 1 > wq_first) ||
                      (window > 0 && wq_last - k0 >= window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[nt][e] * scale2;
        if (edge) {
          const int key = k0 + nt * 8 + qc + (e & 1);
          const int qp = qpos[e / 2];
          const bool masked =
              (causal && key > qp) || (window > 0 && qp - key >= window);
          val = key >= Skv ? -INFINITY : (masked ? kNegInf : val);
        }
        s[nt][e] = val;
      }
    }

    // online softmax over the tile; a row lives on 4 lanes of a quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = mx[i] == m[i] ? 1.f : mma::ex2(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = mma::ex2(s[nt][e] - m[e / 2]);
        s[nt][e] = p;
        l[e / 2] += p;  // this lane's part; the quad is summed at the end
      }
    }
    // rescale the accumulator only when a row's max moved
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][0] *= alpha[0];
        o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1];
        o[dt][3] *= alpha[1];
      }
    }

    // O += P V: P's C fragments, rounded to bf16, are PV's A fragments
#pragma unroll
    for (int ks2 = 0; ks2 < kMmaKeys / 16; ++ks2) {
      const uint32_t a[4] = {
          mma::pack_bf16(s[2 * ks2][0], s[2 * ks2][1]),
          mma::pack_bf16(s[2 * ks2][2], s[2 * ks2][3]),
          mma::pack_bf16(s[2 * ks2 + 1][0], s[2 * ks2 + 1][1]),
          mma::pack_bf16(s[2 * ks2 + 1][2], s[2 * ks2 + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bf[4];
        const int key = ks2 * 16 + (lane % 8) + ((lane / 8) & 1) * 8;
        mma::ldsm_x4_trans(
            bf, mma::smem_addr(vt + mma::swz<D>(key, 2 * dp + lane / 16)));
        mma::bf16_16816(o[2 * dp], a, bf[0], bf[1]);
        mma::bf16_16816(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
  }
  mma::cp_async_wait<0>();  // no copy outlives the block
  __syncthreads();          // every warp is done reading shared memory

  // the normalised tile goes through the Q tile's shared memory, so the
  // rows leave in 16-byte pieces, a row's 2 D bytes contiguous
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const int rr = warp * 16 + lane / 4 + 8 * i;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(qs + mma::swz<D>(rr, dt) + qc) =
          __floats2bfloat162_rn(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
  }
  __syncthreads();
  for (int p = 0; p < kMmaRows / RPL; ++p) {
    const int rr = lr + p * RPL, r = r0 + rr;
    if (r >= rows) break;
    const int t = r / G, g = r % G;
    *reinterpret_cast<uint4*>(
        out + (((size_t)b * Hq + h * G + g) * Sq + t) * D + lc * 8) =
        *reinterpret_cast<const uint4*>(qs + mma::swz<D>(rr, lc));
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int B, int Hq, int Hkv, int Sq, int Skv,
                       int causal, int window, int q_offset, float scale,
                       cudaStream_t stream) {
  const int rows = (Hq / Hkv) * Sq;
  const dim3 grid(B, Hkv, (rows + kRows - 1) / kRows);
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_prefill_f32<D>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Hq, Hkv, Sq,
      Skv, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int Hq, int Hkv, int Sq, int Skv,
                        int causal, int window, int q_offset, float scale,
                        cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int rows = (Hq / Hkv) * Sq;
  const dim3 grid(B, Hkv, (rows + kMmaRows - 1) / kMmaRows);
  const size_t smem = bf16_smem_bytes<D>();
  auto kernel = flash_prefill_bf16<D>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kMmaWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Hq, Hkv, Sq, Skv,
      causal, window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means none. Returns
// cudaGetLastError() after the launch (0 on success). The head dims a
// caller launches: qwen2-1.5b's 128, and 64 for the small card test; add
// others with the configs that need them.
extern "C" int flash_prefill_launch(int dtype, const void* q, const void* k,
                                    const void* v, void* out, int B, int Hq,
                                    int Hkv, int Sq, int Skv, int D,
                                    int causal, int window, int q_offset,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FP_ARGS q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, \
                scale, s
  if (dtype == 0 && D == 64) return (int)launch_f32<64>(FP_ARGS);
  if (dtype == 0 && D == 128) return (int)launch_f32<128>(FP_ARGS);
  if (dtype == 1 && D == 64) return (int)launch_bf16<64>(FP_ARGS);
  if (dtype == 1 && D == 128) return (int)launch_bf16<128>(FP_ARGS);
#undef FP_ARGS
  return (int)cudaErrorInvalidValue;
}
