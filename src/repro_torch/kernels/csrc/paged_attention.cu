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
// head share its pages.
//
// The Pallas kernels' sharding options, for one shard of a page store
// whose pages are split by slot (distributed/paged.py): local slot j of
// table column p sits at position p * pos_stride + pos_offset + j
// (pos_stride >= page; the default pos_stride = page, pos_offset = 0 is
// the identity), and with stats the merge also writes each row's (m, l)
// [B, Q, Hq] f32 in natural-log units, m = NEG_INF and l = 0 for a row
// that sees no key. The walk runs over local keys: a row's causal limit
// is mapped once to the count of local keys at or before it
// (`visible_keys`), and every bound below compares key indices with such
// counts, so a shard walks, reads and masks only its own keys. A limit
// below the shard's first position (the slot layout shifts seq_lens and
// q_start by the shard's offset, which can make them zero or negative)
// gives a count of 0: no key is read and the row's output is zeros.
//
// What bounds it on an H100: the K/V bytes it must read (each valid page
// of each (row, KV head) once) at 3.35 TB/s; its arithmetic is small. The
// TPU grid walked a row's pages in order on one core with the accumulator
// carried in VMEM across grid steps; here a block walks its keys itself,
// reads its own block-table entries and stops at its rows' longest causal
// limit, so it never reads a table entry or a page past seq_len.
//
// One walk for both types (`paged_attention_kernel` + `paged_merge`):
// - Rows are (t, g) pairs, g minor, so the live rows of row b are the
//   first G * q_lens[b]. A block owns 64 of them (4 warps x 16-row
//   tiles); a warp with no live row skips the products and a block with
//   none exits, so a decode row costs one block per KV head.
// - Keys come in tiles of 16 through a four-stage cp.async ring (the next
//   three tiles' K/V in flight while one computes) into XOR-swizzled
//   shared tiles (padded rows at D 80, mma::Tile), the block's threads
//   walking a tile's 16-byte chunks in order whatever the row's count;
//   the span's block-table entries are read into shared
//   memory once, before the first load. Any page size works: each key row
//   is addressed through its own page.
// - Each warp holds its scores, the online softmax (m, l) and the output
//   accumulator in f32 registers in the m16n8k16 fragment layout
//   (mma_sm90.cuh). Only the two tile products depend on the type
//   (`TileMath`, a dispatch on the type, not a fallback):
//   bfloat16, the engine's type: QK^T and PV are mma.sync m16n8k16 on the
//   tensor cores, fed by ldmatrix; P is rounded to bf16 in registers as
//   PV's A operand (the one rounding the f32 plain version lacks;
//   relative 2^-9 per weight, inside the bf16 tolerance of 2e-2).
//   float32, the path the 2e-5 checks hold (TF32 would not): the same
//   fragments computed with f32 FMAs on the CUDA cores, P gathered from
//   the lane quad by shuffles.
// - Sequence split: a row's walk is cut into fixed spans of kSpanKeys
//   keys counted from position 0, on grid.z beside the row groups, so a
//   small batch still fills the SMs. Each block writes its span's
//   unnormalised (o, m, l) to f32 scratch (m in log2 units: scores carry
//   scale * log2 e, one ex2 per weight); a span past a row's limit writes
//   m = NEG_INF, l = 0. `paged_merge` then combines the spans of each row
//   in span order, skipping l = 0 (weight exactly 0), and writes padding
//   rows as zeros.
// - Row independence: a row's result depends only on its own q, pages and
//   q_start + t, never on Q, B, the table width or its neighbours.
//   Fixed span boundaries give it; keys a block walks past a row's limit
//   score NEG_INF and add exact zeros (p = 0, and the rescale is skipped
//   when the running max does not move). So the decode kernel equals the
//   fused kernel's Q = 1 case, and the decode rows of a mixed launch,
//   bit for bit.
// Not yet done (later work): TMA and wgmma (a 64-row tile is one wgmma M).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kTileKeys = 16;       // keys per tile
constexpr int kStages = 4;          // tiles in the cp.async ring
constexpr int kSpanKeys = 128;      // keys per span (ref.SPAN_KEYS)
constexpr float kNegInf = -0.7f * 3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The local keys at or before position `limit` (capped at the table's
// `seq_end` keys): key k, slot k % page of table column k / page, sits
// at (k / page) * stride + offset + k % page, which grows with k. With
// the identity mapping it is limit + 1 (0 for a negative limit).
__device__ __forceinline__ int visible_keys(int limit, int page,
                                            int stride, int offset,
                                            int seq_end) {
  const int x = limit - offset;
  if (x < 0) return 0;
  const int p = x / stride;
  if (p >= seq_end / page) return seq_end;
  return p * page + min(x - p * stride + 1, page);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element offset of 16-byte chunk c of row `row` in a swizzled [rows][D]
// shared tile of T.
template <typename T, int D>
__device__ __forceinline__ int tile_off(int row, int c) {
  return mma::swz<D, 16 / sizeof(T)>(row, c);
}

// A warp's two products on one tile of 16 keys, for its 16 query rows
// (warp * 16 + [0, 16) of the block's Q tile), in the m16n8k16 fragment
// layout: s[nt][e] is the score of row qr + 8 (e / 2) with key
// nt * 8 + qc + (e & 1), o[dt][e] the output of that row at column
// dt * 8 + qc + (e & 1) (qr = lane / 4, qc = 2 (lane % 4)).
template <typename T, int D>
struct TileMath;

template <int D>
struct TileMath<__nv_bfloat16, D> {  // tensor cores
  using T = __nv_bfloat16;
  uint32_t qf[D / 16][4];  // the warp's Q fragments, kept for the walk

  __device__ void load_q(const T* qs, int warp, int lane) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int row = warp * 16 + (lane % 8) + ((lane / 8) & 1) * 8;
      mma::ldsm_x4(qf[kk], mma::smem_addr(
                               qs + tile_off<T, D>(row, 2 * kk + lane / 16)));
    }
  }

  __device__ void qk(float (&s)[2][4], const T* kt, int lane) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bf[4];
      const int key = (lane % 8) + (lane / 16) * 8;
      mma::ldsm_x4(bf, mma::smem_addr(kt + tile_off<T, D>(
                                               key, 2 * kk + ((lane / 8) & 1))));
      mma::bf16_16816(s[0], qf[kk], bf[0], bf[1]);
      mma::bf16_16816(s[1], qf[kk], bf[2], bf[3]);
    }
  }

  __device__ void pv(float (&o)[D / 8][4], const float (&p)[2][4],
                     const T* vt, int lane) const {
    const uint32_t a[4] = {mma::pack_bf16(p[0][0], p[0][1]),
                           mma::pack_bf16(p[0][2], p[0][3]),
                           mma::pack_bf16(p[1][0], p[1][1]),
                           mma::pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      const int key = (lane % 8) + ((lane / 8) & 1) * 8;
      mma::ldsm_x4_trans(bf, mma::smem_addr(vt + tile_off<T, D>(
                                                     key, 2 * dp + lane / 16)));
      mma::bf16_16816(o[2 * dp], a, bf[0], bf[1]);
      mma::bf16_16816(o[2 * dp + 1], a, bf[2], bf[3]);
    }
  }
};

template <int D>
struct TileMath<float, D> {  // CUDA cores, f32 FMAs in a fixed order
  const float* qs;  // the block's Q tile, read at the lane's two rows
  int ra, rb;

  __device__ void load_q(const float* q_tile, int warp, int lane) {
    qs = q_tile;
    ra = warp * 16 + lane / 4;
    rb = ra + 8;
  }

  __device__ void qk(float (&s)[2][4], const float* kt, int lane) const {
    const int qc = 2 * (lane % 4);
    const int key[4] = {qc, qc + 1, 8 + qc, 9 + qc};
#pragma unroll
    for (int i = 0; i < 2; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D / 4; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(
          qs + tile_off<float, D>(ra, c));
      const float4 b = *reinterpret_cast<const float4*>(
          qs + tile_off<float, D>(rb, c));
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float4 k = *reinterpret_cast<const float4*>(
            kt + tile_off<float, D>(key[n], c));
        float& sa = s[n / 2][n % 2];
        float& sb = s[n / 2][2 + n % 2];
        sa = fmaf(a.x, k.x, sa); sa = fmaf(a.y, k.y, sa);
        sa = fmaf(a.z, k.z, sa); sa = fmaf(a.w, k.w, sa);
        sb = fmaf(b.x, k.x, sb); sb = fmaf(b.y, k.y, sb);
        sb = fmaf(b.z, k.z, sb); sb = fmaf(b.w, k.w, sb);
      }
    }
  }

  __device__ void pv(float (&o)[D / 8][4], const float (&p)[2][4],
                     const float* vt, int lane) const {
    const int qc = 2 * (lane % 4);
#pragma unroll
    for (int kk = 0; kk < kTileKeys; ++kk) {
      // key kk's weights for rows qr and qr + 8 sit in lane
      // 4 qr + (kk % 8) / 2 of the quad
      const int src = (lane & ~3) | ((kk & 7) >> 1);
      const float pa = __shfl_sync(0xffffffffu, p[kk >> 3][kk & 1], src);
      const float pb = __shfl_sync(0xffffffffu, p[kk >> 3][2 + (kk & 1)], src);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const float2 v = *reinterpret_cast<const float2*>(
            vt + tile_off<float, D>(kk, 2 * dt + qc / 4) + (qc & 3));
        o[dt][0] = fmaf(pa, v.x, o[dt][0]);
        o[dt][1] = fmaf(pa, v.y, o[dt][1]);
        o[dt][2] = fmaf(pb, v.x, o[dt][2]);
        o[dt][3] = fmaf(pb, v.y, o[dt][3]);
      }
    }
  }
};

// A shared row of T at head dim D: D elements, or padded (mma::Tile)
template <typename T, int D>
__host__ __device__ constexpr int row_stride() {
  return mma::Tile<D, 16 / sizeof(T)>::STRIDE;
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  return ((size_t)kRows + 2 * (size_t)kStages * kTileKeys) *
         row_stride<T, D>() * sizeof(T);
}

// DECODE: `starts` holds seq_lens (q_start = seq_len - 1, q_lens = 1);
// otherwise it holds q_start and `q_lens` the valid tokens per row.
// Block (b, h, z) with z = group * nspan + span: rows [64 group,
// 64 group + 64) of (b, h), keys [span * kSpanKeys, (span + 1) *
// kSpanKeys). Writes o_part [B, Hkv, nspan, G*Q, D] and ml_part
// [B, Hkv, nspan, G*Q, 2] for the live rows.
template <typename T, int D, bool DECODE>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ starts,
                       const int* __restrict__ q_lens,
                       float* __restrict__ o_part,
                       float* __restrict__ ml_part, int Q, int Hq, int Hkv,
                       int page, int pps, int nspan, float scale,
                       int stride, int offset) {
  constexpr int EPC = 16 / sizeof(T);  // elements of a 16-byte chunk
  constexpr int CH = D / EPC;          // chunks of a row
  constexpr int DT = D / 8;            // n8 tiles of the output
  constexpr int RS = row_stride<T, D>();  // elements of a shared row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // table entries a span reaches: at most kSpanKeys / page + 1
  __shared__ int tbl[kSpanKeys + 1];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kRows][RS]
  T* ks = qs + kRows * RS;                 // [kStages][16][RS]
  T* vs = ks + kStages * kTileKeys * RS;   // [kStages][16][RS]

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int sp = blockIdx.z % nspan;
  const int r0 = (blockIdx.z / nspan) * kRows;
  const int G = Hq / Hkv;
  const int rows = G * Q;
  const int start = DECODE ? starts[b] - 1 : starts[b];
  const int live = G * (DECODE ? 1 : q_lens[b]);
  if (r0 >= live) return;  // no live row: the merge writes the zeros
  const int r_hi = min(r0 + kRows, live);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int seq_end = pps * page;
  const int key0 = sp * kSpanKeys;
  auto visible = [&](int row) {  // local keys query row `row` attends
    return visible_keys(start + row / G, page, stride, offset, seq_end);
  };
  // the block's last live row sees the most keys
  const int key_end = min(key0 + kSpanKeys, visible(r_hi - 1));
  const size_t part = ((size_t)(b * Hkv + h) * nspan + sp) * rows;

  if (key_end <= key0) {  // the span lies past every row's limit
    for (int r = r0 + tid; r < r_hi; r += kWarps * 32) {
      ml_part[(part + r) * 2] = kNegInf;
      ml_part[(part + r) * 2 + 1] = 0.f;
    }
    return;
  }
  const int p0 = key0 / page;
  for (int i = tid; i <= (key_end - 1) / page - p0; i += kWarps * 32)
    tbl[i] = block_tables[(size_t)b * pps + p0 + i];
  for (int i = tid; i < kRows * CH; i += kWarps * 32) {
    const int rr = i / CH, c = i % CH, r = r0 + rr;
    const bool ok = r < r_hi;
    const int t = ok ? r / G : 0, g = ok ? r % G : 0;
    const T* src = q + (((size_t)b * Q + t) * Hq + h * G + g) * D + c * EPC;
    mma::cp_async16(mma::smem_addr(qs + tile_off<T, D>(rr, c)), src, ok);
  }
  __syncthreads();  // the table entries are visible

  const int n_tiles = (key_end - key0 + kTileKeys - 1) / kTileKeys;
  // the block walks a tile's chunks in order: on pass p thread tid
  // copies chunk i = tid + 128 p (key row i / CH, chunk i % CH of it)
  // while i is inside the tile, whether or not CH divides 128
  constexpr int CHUNKS = kTileKeys * CH;
  constexpr int PASSES = (CHUNKS + kWarps * 32 - 1) / (kWarps * 32);
  uint32_t so[PASSES];  // the thread's byte offsets in a stage
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int i = tid + p * kWarps * 32;
    so[p] = tile_off<T, D>(i / CH, i % CH) * sizeof(T);
  }
  const uint32_t ks0 = mma::smem_addr(ks), vs0 = mma::smem_addr(vs);
  auto load_kv = [&](int tile, int stage) {
    const int kb = key0 + tile * kTileKeys;
    const uint32_t st = stage * kTileKeys * RS * sizeof(T);
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int i = tid + p * kWarps * 32;
      if (i >= CHUNKS) break;
      const int pos = kb + i / CH;
      const bool ok = pos < key_end;
      size_t off = 0;
      if (ok) {
        const size_t phys = (size_t)tbl[pos / page - p0];
        off = ((phys * page + pos % page) * Hkv + h) * D + i % CH * EPC;
      }
      mma::cp_async16(ks0 + st + so[p], kp + off, ok);
      mma::cp_async16(vs0 + st + so[p], vp + off, ok);
    }
  };
  // the first group also carries Q
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_kv(st, st);
    mma::cp_async_commit();
  }

  const int wr0 = r0 + warp * 16;
  const bool warp_live = wr0 < r_hi;
  const int row_a = wr0 + lane / 4, row_b = row_a + 8;
  const int n_vis[2] = {visible(row_a), visible(row_b)};
  const int w_min_vis = visible(wr0);  // the warp's first row sees least
  const int qc = 2 * (lane % 4);
  // scores in log2 units (scale * log2 e folded in): one ex2 per weight;
  // m is kept in these units, also in ml_part
  const float scale2 = scale * kLog2e;

  TileMath<T, D> math;
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    mma::cp_async_wait<kStages - 2>();  // tile j (and Q) has landed
    __syncthreads();  // ... for every thread, and tile j-1 is consumed
    if (j + kStages - 1 < n_tiles)
      load_kv(j + kStages - 1, (j + kStages - 1) % kStages);
    mma::cp_async_commit();
    if (!warp_live) continue;  // uniform across the warp
    if (j == 0) math.load_q(qs, warp, lane);
    const T* kt = ks + (j % kStages) * kTileKeys * RS;
    const T* vt = vs + (j % kStages) * kTileKeys * RS;

    float s[2][4];
    math.qk(s, kt, lane);

    // scale into log2 units; the element mask only where the tile
    // crosses a row's limit or the end of the table
    const int kb = key0 + j * kTileKeys;
    const bool edge = kb + kTileKeys > w_min_vis || kb + kTileKeys > seq_end;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[nt][e] * scale2;
        if (edge) {
          const int key = kb + nt * 8 + qc + (e & 1);
          // no such key: weight exactly 0; past the row's limit: NEG_INF
          val = key >= seq_end ? -INFINITY
                               : (key >= n_vis[e / 2] ? kNegInf : val);
        }
        s[nt][e] = val;
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
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
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = mma::ex2(s[nt][e] - m[e / 2]);
        s[nt][e] = p;
        l[e / 2] += p;  // this lane's part; the quad is summed at the end
      }
    }
    // rescale the accumulator only when a row's max moved (an exact
    // no-op otherwise, so skipping it keeps rows independent)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][0] *= alpha[0];
        o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1];
        o[dt][3] *= alpha[1];
      }
    }
    math.pv(o, s, vt, lane);
  }
  mma::cp_async_wait<0>();  // no copy outlives the block
  if (!warp_live) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? row_b : row_a;
    if (r >= r_hi) continue;
    const size_t idx = part + r;
    if (n_vis[i] <= key0) {  // this row's limit ends before the span
      ml_part[idx * 2] = kNegInf;
      ml_part[idx * 2 + 1] = 0.f;
      continue;
    }
    float* op = o_part + idx * D + qc;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(op + dt * 8) =
          make_float2(o[dt][2 * i], o[dt][2 * i + 1]);
    ml_part[idx * 2] = m[i];
    ml_part[idx * 2 + 1] = l[i];
  }
}

// One warp per (b, KV head, row): the spans' partials combined in span
// order; padding rows (t >= q_lens[b]) written as zeros. With m_out
// (l_out beside it; both null without stats) it also writes the row's
// (m, l) over all its spans, m in natural-log units.
template <typename T, int D, bool DECODE>
__global__ void __launch_bounds__(128)
paged_merge(const float* __restrict__ o_part,
            const float* __restrict__ ml_part,
            const int* __restrict__ q_lens, T* __restrict__ out,
            float* __restrict__ m_out, float* __restrict__ l_out, int B,
            int Q, int Hq, int Hkv, int nspan) {
  // lane l holds columns l, l + 32, ... of a row (D 80 leaves lanes
  // 16-31 one column fewer)
  constexpr int EPL = (D + 31) / 32;
  const int G = Hq / Hkv;
  const int rows = G * Q;
  const int w = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= B * Hkv * rows) return;
  const int r = w % rows, bh = w / rows;
  const int h = bh % Hkv, b = bh / Hkv;
  const int t = r / G, g = r % G;
  const size_t row_out = ((size_t)b * Q + t) * Hq + h * G + g;
  T* op = out + row_out * D + lane;
  auto in_row = [&](int e) { return D % 32 == 0 || lane + 32 * e < D; };
  if (r >= G * (DECODE ? 1 : q_lens[b])) {
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (in_row(e)) op[32 * e] = from_f32<T>(0.f);
    if (m_out != nullptr && lane == 0) {
      m_out[row_out] = kNegInf;
      l_out[row_out] = 0.f;
    }
    return;
  }
  const size_t first = (size_t)bh * nspan * rows + r;
  float M = kNegInf;
  for (int s = 0; s < nspan; ++s)
    M = fmaxf(M, ml_part[(first + (size_t)s * rows) * 2]);
  float L = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  for (int s = 0; s < nspan; ++s) {
    const size_t idx = first + (size_t)s * rows;
    const float ls = ml_part[idx * 2 + 1];
    if (ls == 0.f) continue;  // an empty span: weight exactly 0
    const float wgt = exp2f(ml_part[idx * 2] - M);  // m in log2 units
    L += ls * wgt;
    const float* src = o_part + idx * D + lane;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (in_row(e)) acc[e] += wgt * src[32 * e];
  }
  const float denom = fmaxf(L, 1e-30f);
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    if (in_row(e)) op[32 * e] = from_f32<T>(acc[e] / denom);
  if (m_out != nullptr && lane == 0) {
    m_out[row_out] = L > 0.f ? M * kLn2 : kNegInf;
    l_out[row_out] = L;
  }
}

struct Args {
  const void *q, *k, *v, *bt, *starts, *q_lens;
  void *out, *o_part, *ml_part, *m_out, *l_out;
  int B, Q, Hq, Hkv, page, pps, nspan, stride, offset;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool DECODE>
cudaError_t launch(const Args& a) {
  // the scratch must hold a span for every key of the table
  if ((long long)a.nspan * kSpanKeys < (long long)a.pps * a.page ||
      a.stride < a.page || (a.m_out == nullptr) != (a.l_out == nullptr))
    return cudaErrorInvalidValue;
  const int rows = (a.Hq / a.Hkv) * a.Q;
  const int groups = (rows + kRows - 1) / kRows;
  const size_t smem = smem_bytes<T, D>();
  auto kernel = paged_attention_kernel<T, D, DECODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.B, a.Hkv, groups * a.nspan), kWarps * 32, smem,
           a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.starts), static_cast<const int*>(a.q_lens),
      static_cast<float*>(a.o_part), static_cast<float*>(a.ml_part), a.Q,
      a.Hq, a.Hkv, a.page, a.pps, a.nspan, a.scale, a.stride, a.offset);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int warps = a.B * a.Hkv * rows;
  paged_merge<T, D, DECODE><<<(warps + 3) / 4, 128, 0, a.stream>>>(
      static_cast<const float*>(a.o_part),
      static_cast<const float*>(a.ml_part),
      static_cast<const int*>(a.q_lens), static_cast<T*>(a.out),
      static_cast<float*>(a.m_out), static_cast<float*>(a.l_out), a.B, a.Q,
      a.Hq, a.Hkv, a.nspan);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. The head dims a caller launches:
// 128 (qwen2-1.5b, qwen3-4b, phi3.5-moe), 256 (paligemma-3b), 192
// (nemotron-4-340b), 80 (h2o-danube-1.8b) and 32 for the small card
// test; add others with the configs that need them. The same body takes
// 192 KB of shared memory in f32 at D 256 and 144 KB at D 192 (96 and 72
// KB in bf16), under the 227 KB a block may opt into.
template <bool DECODE>
int dispatch(int dtype, int D, const Args& a) {
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && D == 32) return (int)launch<float, 32, DECODE>(a);
  if (dtype == 0 && D == 80) return (int)launch<float, 80, DECODE>(a);
  if (dtype == 0 && D == 128) return (int)launch<float, 128, DECODE>(a);
  if (dtype == 0 && D == 192) return (int)launch<float, 192, DECODE>(a);
  if (dtype == 0 && D == 256) return (int)launch<float, 256, DECODE>(a);
  if (dtype == 1 && D == 32) return (int)launch<bf16, 32, DECODE>(a);
  if (dtype == 1 && D == 80) return (int)launch<bf16, 80, DECODE>(a);
  if (dtype == 1 && D == 128) return (int)launch<bf16, 128, DECODE>(a);
  if (dtype == 1 && D == 192) return (int)launch<bf16, 192, DECODE>(a);
  if (dtype == 1 && D == 256) return (int)launch<bf16, 256, DECODE>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The span length the kernels are built with; the wrapper sizes the
// scratch from it and checks it against ref.SPAN_KEYS.
extern "C" int paged_span_keys() { return kSpanKeys; }

// Returns cudaGetLastError() after the launches (0 on success). o_part
// [B, Hkv, nspan, Hq/Hkv * Q, D] and ml_part [..., 2] are f32 scratch for
// the span partials, nspan >= ceil(pps * page / paged_span_keys()).
// pos_stride >= page and pos_offset place the local slots (page, 0 for
// the identity); m_out/l_out are the [B, Q, Hq] f32 stats, or both null.
extern "C" int paged_prefill_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* q_start, const void* q_lens,
    void* out, void* o_part, void* ml_part, void* m_out, void* l_out, int B,
    int Q, int Hq, int Hkv, int D, int page, int pps, int nspan,
    int pos_stride, int pos_offset, float scale, void* stream) {
  const Args a{q, k_pages, v_pages, block_tables, q_start, q_lens, out,
               o_part, ml_part, m_out, l_out, B, Q, Hq, Hkv, page, pps,
               nspan, pos_stride, pos_offset, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, D, a);
}

extern "C" int paged_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* seq_lens, void* out, void* o_part,
    void* ml_part, void* m_out, void* l_out, int B, int Hq, int Hkv, int D,
    int page, int pps, int nspan, int pos_stride, int pos_offset,
    float scale, void* stream) {
  const Args a{q, k_pages, v_pages, block_tables, seq_lens, nullptr, out,
               o_part, ml_part, m_out, l_out, B, 1, Hq, Hkv, page, pps,
               nspan, pos_stride, pos_offset, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, D, a);
}
