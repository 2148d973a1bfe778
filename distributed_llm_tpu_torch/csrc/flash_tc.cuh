// Tensor-core flash attention of many query rows against K/V, for Hopper:
// the kernel behind flash_causal.cu (the cold causal prefill, K2),
// flash_chunk_q8.cu (a chunk over the sequential engines' int8 cache,
// K12), flash_chunk.cu's wide chunks (the same over their bf16 cache,
// K11) and paged_chunk.cu (a suffix chunk over the paged pool, K3).  They
// replace the Pallas TPU kernels `_flash_kernel`, `_chunk_kernel_native_q8`
// / `_chunk_kernel_q8`, `_chunk_kernel_native` / `_chunk_kernel` and
// `_paged_chunk_kernel` (distributed_llm_tpu/ops/pallas_attention.py).  All
// of them compute "a chunk of query rows at known positions against K/V,
// row i attending keys 0 .. pos_i"; a template flag (`Source`) says where
// the tiles and the positions come from.  One arithmetic serves all three, so a row scored
// by the prefill and the same row scored on a prefix hit's suffix (K3 over
// the K/V the prefill wrote) give the same bits.
//
// Layout: q [B, S_q, Nq, D] bf16, o the same; query head h reads kv head
// h / (Nq / Nkv); keys t < W.
// - kFresh (K2): k/v the fresh [B, S, Nkv, D] bf16, W = S, row i at i.
// - kWindow (K12 int8, K11 bf16): K/V element (b, t, h, d) at
//   b * kv_bstride + (t * Nkv + h) * D + d, and for int8 float32 row scales
//   (b, t, h) at b * sc_bstride + t * Nkv + h: a window of a longer cache
//   read in place.
//   q_pos [B, S_q] int32 is read row by row on the device, frontier
//   min(q_pos, W - 1); reading each row's position (not start + r) keeps
//   padded chunk rows equal to the plain version's.
// - kPaged (K3): one layer's pool [Nkv, NB, bs, D] bf16, key t at
//   (table[t / bs], t % bs), B = 1, W = window; row i at start[0] + i
//   (start read on the device), frontier clamped to W - 1.
//
// Bound: a 64-row tile over N keys does 4 * 64 * D * N operations on
// 2 * D * N K/V elements (64 / group query positions times the group), so
// bf16 is about 16 operations a byte at nano's group of 4: bytes bound at
// short walks, and the product rate matters as walks lengthen (the
// 2048-row chunks).  The design is FlashAttention-2's, on this card's
// `mma.sync`:
//
// 1. Rows: the GQA group packed, 64 a block.  A block owns one kv head and
//    64 rows: 64 / group query positions times the group's heads, row
//    r = position r / group, head hk * group + r % group, in four 16-row
//    slabs.  Each K/V tile is staged once for the whole group (the CUDA-core
//    kernels this replaces staged it once per query head).  Grid
//    (ceil(S_q * group / 64), Nkv, B), the query-tile index reversed so the
//    longest causal walks start first.
// 2. Warps: two a slab over 128-key tiles, each scoring every other 16-key
//    chunk (64 keys a tile) with its own flash state; the two states of a
//    slab merge in shared memory at the end (M = max m_k, weights
//    2^(m_k - M)).  At the serving shapes a grid is about one block per SM
//    (128 blocks for a 256-row prefill or chunk at 8 kv heads), so the
//    longest walk sets the time: two warps a slab halve its tiles and double
//    the warps on it.  One warp a slab over 64-key tiles would fill the SMs
//    better on large grids (the 2048-row chunks), but it rounds P against
//    another running max, and K2 and K3 must round alike.
// 3. Tensor cores, P in registers.  A warp's Q fragments (its slab's 16
//    rows) are loaded once by ldmatrix (unscaled bf16: exact).  Per tile,
//    QK is mma.sync m16n8k16 bf16 -> f32 into 8 n-tiles of scores (the even
//    and odd k-steps in separate accumulators, half the dependent chain);
//    the softmax scale multiplies the float32 scores (at D = 64 it is 1/8,
//    so this equals the Pallas "q * scale first" exactly).  The online
//    softmax is float32 with m in log2 units (one exp2 each), row max and
//    sum by quad shuffles.  P is packed to bf16 straight from the score
//    accumulators into PV's A fragments (the C layout of a chunk's two
//    n-tiles is the A layout of one k-step), so P never touches shared
//    memory; PV reads V by ldmatrix.trans, acc stays in registers.  P is
//    rounded to bf16 for PV, as the Pallas bf16 kernel casts it (l sums it
//    unrounded).
//    mma.sync and not wgmma: the timed shapes are 64-row tiles at D <= 128
//    with 64-1024 keys a row on about one block per SM, where a block's walk
//    is a few tiles and latency, not the product rate, sets the time.  A wgmma + TMA
//    warp-specialised version is for when the kernel table shows this
//    design short of its bound (the 2048-row chunks).
// 4. Masks only where a tile straddles a frontier.  A tile wholly at or
//    below every real row's frontier in a slab runs with no mask; a tile
//    past every row's frontier in a slab is skipped by its warps (the rows
//    keep their flash state); the block stops at its furthest frontier.
//    On a straddling tile only the 16-key chunks up to the slab's furthest
//    frontier are multiplied.  Padded rows (past the chunk) mask nothing
//    and are never stored.
// 5. Asynchronous loads.  A ring of K/V tiles filled by 16-byte cp.async.cg
//    (through the row stride Nkv * D, or the table), one commit group a
//    tile, so tile
//    j + stages - 1 is in flight while tile j is scored.  Rows past the
//    block's frontier (the window's end included) are zero-filled by
//    src-size 0, never read; int8 row scales go by 4-byte cp.async.ca in the
//    same group; K3 reads a key's table entry when it issues its copy.  A
//    block's registers leave no room for a second on its SM, so the ring
//    takes 3-4 stages.
// 6. int8 (K12).  Each staged int8 tile pair is widened into one bf16 tile
//    pair in shared memory (integers in -127..127 are exact in bf16;
//    `widen_rows`).  The K row scale multiplies the float32 score columns
//    with the softmax scale; the V row scale is folded into P's columns
//    before P is rounded to bf16.  The Pallas q8 kernels keep P in float32:
//    this rounds it, as the int8 verify and decode kernels do, within the
//    same 1e-2 row bound.  The dequantized window never reaches device
//    memory.
#pragma once

#include "ragged_verify.cuh"

namespace dllm {
namespace tc {

using verify::cmax;
using verify::cmin;
using verify::cp_async16_zfill;
using verify::cp_async4_zfill;
using verify::cp_async_commit;
using verify::cp_async_wait;
using verify::kLog2e;
using verify::kNegInf;
using verify::ldmatrix_x4;
using verify::ldmatrix_x4_trans;
using verify::mma_bf16;
using verify::pack_bf16;
using verify::quad_max;
using verify::quad_sum;

constexpr int kRows = 64;         // query rows per block: four 16-row slabs
constexpr int kSlabs = kRows / 16;
constexpr int kWarpKeys = 64;     // keys of a tile each warp scores
constexpr int kMaxGroup = kRows;  // query heads per kv head
constexpr int kPadFront = 1 << 30;  // padded rows' frontier: they mask nothing
constexpr int kKW = 2;            // warps a slab

// Where the tiles and the positions come from.
enum Source : int {
  kFresh = 0,   // K2: k/v [B, S, Nkv, D], row i at position i
  kWindow = 1,  // K12, K11: a cache window through its batch stride, q_pos [B, S_q]
  kPaged = 2,   // K3: a slot's pool blocks through its table, row i at start + i
};

struct Args {
  const __nv_bfloat16* q;
  const void* k;  // kPaged: the pools [Nkv, NB, bs, D]
  const void* v;
  const float* k_scale;  // int8 only
  const float* v_scale;
  const int* q_pos;  // kWindow only
  const int* table;  // kPaged only: [>= W / bs] block ids
  const int* start;  // kPaged only: [1], the first row's position
  __nv_bfloat16* o;
  int S_q, Nq, Nkv, W;
  long long kv_bstride;  // elements (kFresh, kWindow)
  long long sc_bstride;
  int NB, bs_shift;  // kPaged: pool blocks, log2 of the block size
  float scale;
};

// Two warps share a slab, each taking every other 16-key chunk of a
// 128-key tile.
template <int D, bool Q8>
struct Cfg {
  static constexpr int kTile = kWarpKeys * kKW;  // keys per staged tile
  static constexpr int kWarps = kSlabs * kKW;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLd = D + 8;    // bf16 per padded shared row
  static constexpr int kLd8 = D + 16;  // bytes per padded int8 row
  static constexpr int kQBytes = kRows * kLd * 2;
  static constexpr int kTileBytes = kTile * kLd * 2;  // one bf16 K or V tile
  static constexpr int kStageBytes = Q8 ? 2 * kTile * kLd8 + 2 * kTile * 4 : 2 * kTileBytes;
  static constexpr int kWideBytes = Q8 ? 2 * kTileBytes : 0;
  static constexpr int kFrontBytes = (kRows + kWarps) * 4;
  // A block's registers (140-250 a thread) leave no room for a second on
  // its SM, so the ring takes what shared memory a block can have: 3-4
  // stages.
  static constexpr int kBudget = 227 * 1024;
  static constexpr int kStages =
      cmin(4, cmax(2, (kBudget - kQBytes - kWideBytes - kFrontBytes) / kStageBytes));
  static constexpr int kSmem = kQBytes + kStages * kStageBytes + kWideBytes + kFrontBytes;
  // The merge of a slab's two states reuses the ring: per slab, the
  // second warp's (m, l) of two rows and D / 2 accumulators a lane.
  static constexpr int kMergeBytes = kSlabs * (D / 2 + 4) * 32 * 4;
  static_assert(kMergeBytes <= kStages * kStageBytes, "the merge must fit in the ring");
};

// Start the copies of keys t0 .. t0 + kTile - 1 of kv head hk of sequence
// b (K and V, and for int8 their row scales) into a ring stage: K rows
// then V rows, then the int8 K and V scales.  Rows past `last` (the
// block's frontier, at most W - 1) are zero-filled, not read.  Every
// thread takes part.
template <int D, bool Q8, int Src>
__device__ __forceinline__ void load_tile(unsigned char* stage, const Args& a, int b, int hk,
                                          int t0, int last) {
  using C = Cfg<D, Q8>;
  const long row_stride = (long)a.Nkv * D;  // elements from one key to the next
  const long base = (long)b * a.kv_bstride + (long)t0 * row_stride + (long)hk * D;
  const int valid = last - t0 + 1;
  if constexpr (Q8) {
    constexpr int kRowChunks = D / 16;
    const int8_t* src[2] = {static_cast<const int8_t*>(a.k) + base,
                            static_cast<const int8_t*>(a.v) + base};
    for (int c = threadIdx.x; c < 2 * C::kTile * kRowChunks; c += C::kThreads) {
      const int which = c / (C::kTile * kRowChunks);
      const int r = (c / kRowChunks) % C::kTile;
      const int cc = c % kRowChunks;
      const bool full = r < valid;
      cp_async16_zfill(stage + (which * C::kTile + r) * C::kLd8 + cc * 16,
                       src[which] + (full ? r * row_stride + cc * 16 : 0), full);
    }
    float* sc = reinterpret_cast<float*>(stage + 2 * C::kTile * C::kLd8);
    const long sbase = (long)b * a.sc_bstride + (long)t0 * a.Nkv + hk;
    for (int c = threadIdx.x; c < 2 * C::kTile; c += C::kThreads) {
      const int r = c % C::kTile;
      const bool full = r < valid;
      const float* src_sc = (c < C::kTile ? a.k_scale : a.v_scale) + sbase;
      cp_async4_zfill(sc + c, src_sc + (full ? r * a.Nkv : 0), full);
    }
  } else {
    constexpr int kRowChunks = D / 8;
    const __nv_bfloat16* src[2] = {static_cast<const __nv_bfloat16*>(a.k),
                                   static_cast<const __nv_bfloat16*>(a.v)};
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(stage);
    for (int c = threadIdx.x; c < 2 * C::kTile * kRowChunks; c += C::kThreads) {
      const int which = c / (C::kTile * kRowChunks);
      const int r = (c / kRowChunks) % C::kTile;
      const int cc = c % kRowChunks;
      const bool full = r < valid;
      long off = 0;  // the key's row, in elements
      if (full) {
        if constexpr (Src == kPaged) {
          const int t = t0 + r;
          const int bs = 1 << a.bs_shift;
          off = (((long)hk * a.NB + a.table[t >> a.bs_shift]) * bs + (t & (bs - 1))) * D;
        } else {
          off = base + r * row_stride;
        }
      }
      cp_async16_zfill(dst + (which * C::kTile + r) * C::kLd + cc * 8, src[which] + off + cc * 8,
                       full);
    }
  }
}

// One warp's share of a tile for its 16-row slab, 64 keys: the 16-key
// chunks kw, kw + kKW, ... of the tile, QK, the online softmax and PV.
// Masked: the tile straddles a row's frontier, so keys past it are masked
// and only the chunks up to the slab's furthest frontier run.  Element
// [nt][e] of the scores is row (lane / 4) + 8 * (e / 2) of the slab, key
// (kw + kKW * (nt / 2)) * 16 + (nt % 2) * 8 + 2 * (lane % 4) + e % 2 of the
// tile.
template <int D, bool Q8, bool Masked>
__device__ __forceinline__ void tile_step(const uint32_t (&qf)[D / 16][4], float (&acc)[D / 8][4],
                                          float (&m)[2], float (&l)[2],
                                          const __nv_bfloat16* k_t, const __nv_bfloat16* v_t,
                                          const float* ks_s, const float* vs_s,
                                          const int (&front)[2], int t0, int slab_max,
                                          float qk_scale, int kw, int lane) {
  using C = Cfg<D, Q8>;
  constexpr int kMine = kWarpKeys / 16;  // chunks of this warp
  constexpr int kChunks = C::kTile / 16;
  const int n_chunks = Masked ? min(kChunks, (slab_max - t0) / 16 + 1) : kChunks;
  float s[2 * kMine][4];
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const int kc = kw + kKW * i;
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * i][e] = s[2 * i + 1][e] = 0.f;
    if (kc < n_chunks) {
      // The even and odd k-steps in separate accumulators: half the chain.
      float odd[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t kb[4];
        ldmatrix_x4(kb, k_t + (kc * 16 + (lane >> 4) * 8 + (lane & 7)) * C::kLd + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(ks & 1 ? odd[0] : s[2 * i], qf[ks], kb[0], kb[1]);
        mma_bf16(ks & 1 ? odd[1] : s[2 * i + 1], qf[ks], kb[2], kb[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[2 * i][e] += odd[0][e];
        s[2 * i + 1][e] += odd[1][e];
      }
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < 2 * kMine; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = (kw + kKW * (nt / 2)) * 16 + (nt % 2) * 8 + 2 * (lane & 3) + (e & 1);
      float x = s[nt][e] * qk_scale;
      if constexpr (Q8) x *= ks_s[key];
      if constexpr (Masked) x = t0 + key <= front[e >> 1] ? x : kNegInf;
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]));
    alpha[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int nt = 0; nt < 2 * kMine; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = (kw + kKW * (nt / 2)) * 16 + (nt % 2) * 8 + 2 * (lane & 3) + (e & 1);
      float p = exp2f(s[nt][e] - m[e >> 1]);
      if constexpr (Masked) p = t0 + key <= front[e >> 1] ? p : 0.f;
      l[e >> 1] += p;
      if constexpr (Q8) p *= vs_s[key];  // V's row scale, folded into P
      s[nt][e] = p;
    }
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] *= alpha[0];
    acc[dn][1] *= alpha[0];
    acc[dn][2] *= alpha[1];
    acc[dn][3] *= alpha[1];
  }
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const int kc = kw + kKW * i;
    if (kc < n_chunks) {
      // P (bf16) as PV's A fragment: the chunk's two n-tiles of scores are
      // one k-step's A layout.
      const uint32_t pa[4] = {pack_bf16(s[2 * i][0], s[2 * i][1]),
                              pack_bf16(s[2 * i][2], s[2 * i][3]),
                              pack_bf16(s[2 * i + 1][0], s[2 * i + 1][1]),
                              pack_bf16(s[2 * i + 1][2], s[2 * i + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_t + (kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * C::kLd +
                                  dn * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dn], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dn + 1], pa, vb[2], vb[3]);
      }
    }
  }
}

template <int D, bool Q8, int Src>
__global__ void __launch_bounds__(Cfg<D, Q8>::kThreads) flash_tc_kernel(const Args a) {
  using C = Cfg<D, Q8>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + C::kQBytes;
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(ring + C::kStages * C::kStageBytes);
  int* front_s = reinterpret_cast<int*>(ring + C::kStages * C::kStageBytes + C::kWideBytes);

  const int group = a.Nq / a.Nkv;
  const int per_block = kRows / group;            // query positions per block
  const int i0 = (gridDim.x - 1 - blockIdx.x) * per_block;  // longest walks first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_pos = min(per_block, a.S_q - i0);
  const int rows = n_pos * group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slab = warp / kKW;
  const int kw = warp % kKW;

  // The frontier of each of the block's positions, and the furthest: row
  // i's position is i (kFresh), start + i (kPaged) or q_pos[b, i]
  // (kWindow), clamped to the window.
  const int p0 = Src == kPaged ? a.start[0] : 0;
  int last;
  if constexpr (Src != kWindow) {
    last = min(p0 + i0 + n_pos - 1, a.W - 1);
  } else {
    const int t = threadIdx.x;
    int f = -1;
    if (t < n_pos) f = min(a.q_pos[(long)b * a.S_q + i0 + t], a.W - 1);
    if (t < kRows) front_s[t] = f;
    const int f_max = __reduce_max_sync(0xffffffffu, f);
    if (lane == 0) front_s[kRows + warp] = f_max;
    __syncthreads();
    last = -1;
#pragma unroll
    for (int w = 0; w < C::kWarps; ++w) last = max(last, front_s[kRows + w]);
  }
  const int n_tiles = last / C::kTile + 1;
  const auto issue = [&](int j) {
    load_tile<D, Q8, Src>(ring + (j % C::kStages) * C::kStageBytes, a, b, hk, j * C::kTile, last);
  };

  // Prologue: the first kStages - 1 tiles in flight (one group each; empty
  // groups past the walk keep the count uniform).
#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  // Q rows (unscaled bf16), padded rows zero.
  for (int c = threadIdx.x; c < kRows * (D / 8); c += C::kThreads) {
    const int r = c / (D / 8);
    const int cc = c % (D / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const long q_row = ((long)b * a.S_q + i0 + r / group) * a.Nq + (long)hk * group + r % group;
      val = *reinterpret_cast<const uint4*>(a.q + q_row * D + cc * 8);
    }
    *reinterpret_cast<uint4*>(q_s + r * C::kLd + cc * 8) = val;
  }
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    ldmatrix_x4(qf[ks], q_s + (slab * 16 + (lane & 15)) * C::kLd + ks * 16 + (lane >> 4) * 8);
  }

  // This thread's two rows (slab * 16 + lane / 4, and 8 below) and the
  // slab's nearest and furthest frontiers over its real rows.
  int front[2];
  int lo = kPadFront;
  int hi = -1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = slab * 16 + (lane >> 2) + 8 * h;
    if (r < rows) {
      front[h] = Src == kWindow ? front_s[r / group] : min(p0 + i0 + r / group, a.W - 1);
      lo = min(lo, front[h]);
      hi = max(hi, front[h]);
    } else {
      front[h] = kPadFront;
    }
  }
  const int slab_min = __reduce_min_sync(0xffffffffu, lo);
  const int slab_max = __reduce_max_sync(0xffffffffu, hi);

  const float qk_scale = a.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    if (j + C::kStages - 1 < n_tiles) issue(j + C::kStages - 1);
    cp_async_commit();
    const unsigned char* stage = ring + (j % C::kStages) * C::kStageBytes;
    const __nv_bfloat16* k_t;
    const float* ks_s = nullptr;
    const float* vs_s = nullptr;
    if constexpr (Q8) {
      verify::widen_rows<D, 2 * C::kTile, C::kThreads, C::kLd, C::kLd8>(wide, stage);
      ks_s = reinterpret_cast<const float*>(stage + 2 * C::kTile * C::kLd8);
      vs_s = ks_s + C::kTile;
      k_t = wide;
      __syncthreads();
    } else {
      k_t = reinterpret_cast<const __nv_bfloat16*>(stage);
    }
    const __nv_bfloat16* v_t = k_t + C::kTile * C::kLd;
    const int t0 = j * C::kTile;
    if (t0 > slab_max) continue;  // warp-uniform: past every row of the slab
    if (t0 + C::kTile - 1 <= slab_min) {
      tile_step<D, Q8, false>(qf, acc, m, l, k_t, v_t, ks_s, vs_s, front, t0, slab_max, qk_scale,
                              kw, lane);
    } else {
      tile_step<D, Q8, true>(qf, acc, m, l, k_t, v_t, ks_s, vs_s, front, t0, slab_max, qk_scale,
                             kw, lane);
    }
  }
  cp_async_wait<0>();

  // Row sums over the quad; then the slab's second warp leaves its state in
  // the ring (element-major, lane-minor: no bank conflicts) and the first
  // merges it: M = max(m0, m1), weights 2^(m_k - M), l and acc summed.
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
  __syncthreads();  // every warp is done with the ring
  constexpr int kPer = D / 2 + 4;  // floats a lane leaves: acc, m, l
  float* part = reinterpret_cast<float*>(ring) + slab * kPer * 32 + lane;
  if (kw == 1) {
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[(4 * dn + e) * 32] = acc[dn][e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      part[(D / 2 + h) * 32] = m[h];
      part[(D / 2 + 2 + h) * 32] = l[h];
    }
  }
  __syncthreads();
  if (kw == 1) return;
  float w_self[2], w_other[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_o = part[(D / 2 + h) * 32];
    const float m_new = fmaxf(m[h], m_o);
    w_self[h] = exp2f(m[h] - m_new);
    w_other[h] = exp2f(m_o - m_new);
    l[h] = l[h] * w_self[h] + part[(D / 2 + 2 + h) * 32] * w_other[h];
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[dn][e] = acc[dn][e] * w_self[e >> 1] + part[(4 * dn + e) * 32] * w_other[e >> 1];
    }
  }

  // Epilogue: the slab's rows as bf16 into its own Q rows (no other warp
  // reads them now), then 16-byte stores of the real rows.
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  __nv_bfloat16* o_s = q_s + slab * 16 * C::kLd;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int d = dn * 8 + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(o_s + (lane >> 2) * C::kLd + d) =
        pack_bf16(acc[dn][0] * inv[0], acc[dn][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(o_s + ((lane >> 2) + 8) * C::kLd + d) =
        pack_bf16(acc[dn][2] * inv[1], acc[dn][3] * inv[1]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * (D / 8); c += 32) {
    const int rr = c / (D / 8);
    const int cc = c % (D / 8);
    const int r = slab * 16 + rr;
    if (r < rows) {
      const long o_row = ((long)b * a.S_q + i0 + r / group) * a.Nq + (long)hk * group + r % group;
      *reinterpret_cast<uint4*>(a.o + o_row * D + cc * 8) =
          *reinterpret_cast<const uint4*>(o_s + rr * C::kLd + cc * 8);
    }
  }
}

template <int D, bool Q8, int Src>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<D, Q8>;
  auto kernel = flash_tc_kernel<D, Q8, Src>;
  if (C::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
  }
  const int per_block = kRows / (a.Nq / a.Nkv);
  const dim3 grid((a.S_q + per_block - 1) / per_block, a.Nkv, B);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// Returns the launch's cudaError_t (0 = launched).  D must be 64 or 128,
// Nq a multiple of Nkv with a group of at most 64, B, S_q and W >= 1.  The
// scale pointers are read only when Q8, q_pos only for kWindow, table and
// start only for kPaged.
template <bool Q8, int Src>
int flash_tc_attention(const Args& a, int B, int D, void* stream) {
  if (a.Nkv <= 0 || a.Nq % a.Nkv != 0 || a.Nq / a.Nkv > kMaxGroup || a.S_q < 1 || B < 1 ||
      a.W < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64, Q8, Src>(a, B, s);
    case 128:
      return (int)launch<128, Q8, Src>(a, B, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace dllm
