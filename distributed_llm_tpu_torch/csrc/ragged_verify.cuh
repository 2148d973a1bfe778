// Split-K attention for Hopper over a bf16 or an int8 cache: the kernels
// behind ragged_verify.cu and ragged_verify_q8.cu (speculative verify over
// the paged pool), ragged_decode.cu and ragged_decode_q8.cu (one-token
// decode over the bf16 and the int8 pool, G = 1), paged_decode.cu and
// paged_decode_q8.cu (the dense windowed tick's decode over a window of the
// table, bf16 and int8, G = 1),
// flash_decode.cu and flash_decode_q8.cu (one-token decode over the
// sequential engines' contiguous cache) and flash_chunk.cu's split route
// (a chunk of a few rows over the same cache: the sequential speculative
// verify).  One split kernel serves them all; a tile-source policy
// (`Contig`) says where a tile's rows, and each row's frontier, come from.
//
// Contract over the pool (the Pallas `_ragged_verify_kernel` /
// `_ragged_verify_kernel_q8`, and at G = 1 `_ragged_decode_kernel` /
// `_ragged_decode_kernel_q8` and `_paged_decode_kernel` /
// `_paged_decode_kernel_q8`): q
// [B, G, Nq, D] bf16; one layer's pool [Nkv, NB, bs, D], bf16 or int8, and
// for int8 the float32 row scales [Nkv, NB, bs]; tables [B, MB] int32 and
// pos [B] int32 the FIRST query's position, both read on the device.  Row b
// of the table starts b * TS elements in (TS >= MB): the ragged kernels
// pass each slot's FULL row, TS = MB; the dense tick passes a window
// [B, wb] of its full [B, MB_full] table, a column slice read in place,
// so MB = wb and TS = MB_full, with every pos < wb * bs.  Query g of slot b
// attends positions 0 .. pos[b] + g, position p living at
// (tables[b, p / bs], p % bs); idle slots point their row at the trash
// block 0 with pos 0.  Output [B, G, Nq, D] bf16.
//
// Contract over a contiguous window (the Pallas `_decode_kernel` /
// `_decode_kernel_q8` at G = 1, `_chunk_kernel_native` / `_chunk_kernel`
// at G = S_c): q [B, G, Nq, D] bf16 (the decode's [B, Nq, D] is G = 1);
// one layer's cache window of W positions, element (b, t, h, d) at
// b * kv_bstride + (t * Nkv + h) * D + d, bf16 or int8, and for int8 the
// float32 row scales, (b, t, h) at b * sc_bstride + t * Nkv + h.  The
// batch strides are the caller's, so a window [:, :W] of a longer cache
// is read in place.  pos [B, G] int32 holds each query's own position,
// read on the device row by row (not rebuilt as a first position + g, so
// a chunk's padded rows, clamped to its true length, match the plain
// version); query (g, h) attends kv head h / (Nq / Nkv) at positions
// 0 .. min(pos[b, g], W - 1).  The window is cut into tiles of
// kDecodeTile = 64 positions (MB = ceil(W / 64) tiles, the last one
// partial), read through the row stride Nkv * D; no key at or past W is
// read or scored (a zero-filled key would score 0, not -inf).
//
// Bound: bytes.  A verify reads each slot's n_tiles = min(MB, (pos + G -
// 1) / bs + 1) blocks of K and V once and does about group * G
// multiply-adds per element read (20 at orin's 4 x 5 rows: about 20
// operations per bf16 byte, 40 per int8 byte, against the card's ~295); a
// decode does group = 4 per element.  So the design is about keeping
// enough bytes in flight on every SM.  With MB = wb the frontier clamp
// min(MB, pos / bs + 1) is the Pallas windowed index map's
// min(j, pos // bs): the dense tick's window never reads past column
// wb - 1.
//
// 1. Split-K (flash-decoding).  Grid (Nkv, B, S); block (hk, b, s) walks
//    the sequence's tiles [s * T, min((s + 1) * T, n_tiles)).  T and S come
//    from the wrapper, chosen from shapes alone (no host sync; the plans
//    are in ops/ragged_attention.py):
//    - verify (`split_plan`): at orin's MB = 128, T = 8 tiles, so the timed
//      verify's long slot alone is 16 splits and the batch 192 live blocks
//      on 132 SMs, where one block per (kv head, slot) was 32;
//    - decode, over the pool or a window of the table
//      (`ragged_decode_split_plan`) or a contiguous window
//      (`decode_split_plan`): a decode block holds only the group's 4 rows,
//      whose partials (4 x D floats, 2 KB at D = 128) are small beside one
//      tile pair (32 KB bf16, 17 KB int8 with its scales), so splits are as
//      short as 528 blocks over the whole table or window ask:
//      T = ceil(B * Nkv * MB / 528).  At nano's bf16 pool (B = 8, Nkv = 8,
//      MB = 128) T = 16 and S = 8: the timed batch's 22 live splits are 176
//      live blocks, where one block per (kv head, slot) was 64; the nano
//      draft's 4 slots get T = 8, S = 16, as orin's int8 pool (B = 4); the
//      dense tick's bf16 window at nano (B = 8, wb = 32) T = 4, S = 8, 33
//      live splits at the timed positions, 264 live blocks where there
//      were 64; its int8 window at orin (B = 4, wb = 32) T = 2, S = 16, 23
//      live splits, 184 live blocks where there were 32.  Orin's sequential decode (B = 1, W = 8192) gets T = 2
//      tiles (128 positions) and S = 64, and at the served position 2255
//      the 36 live tiles are 18 splits, 144 live blocks on 132 SMs (one
//      block per kv head and sequence was 8);
//    - a chunk of a few rows over a window (`chunk_split_plan`): the decode
//      plan, but never so short that a split's partials (written once, read
//      once: 2 x rows x (D + 2) floats) outweigh the K/V it reads.  At
//      orin's 5-row verify (20 rows, D = 128, W = 8192) that is T = 2, the
//      partials a third of a split's 64 KB of K/V; at position 3000 the 47
//      live tiles are 24 splits, 192 live blocks, two an SM in one wave.
//    A block whose first tile lies past its sequence's frontier marks its
//    partial empty and exits.  Each live block writes a float32 partial
//    (m, l, acc[D]) per query row; a merge kernel combines a row's
//    partials over the splits its sequence's furthest frontier reaches
//    (worked out from pos on the device): M = max m_s, L = sum l_s
//    2^(m_s - M), O = sum acc_s 2^(m_s - M) / max(L, 1e-30).  A row whose
//    own frontier ends before a live split's first tile leaves l = 0 and m
//    at the -1e30 sentinel there, and weighs 0.  m is kept in units of log2
//    (scores times log2 e), so every exponential is one exp2.  Over the
//    pool a row merges in one warp (`split_merge_kernel`: at most 16
//    splits a row at the timed shapes and at every window rung of orin's
//    dense tick); over a contiguous window, with up to 64, in one block
//    whose warps sum a share of the splits each (`split_merge_row_kernel`).
// 2. Tensor cores.  The block's rows are the group's heads x G positions,
//    row r = head_in_group * G + g (20 at orin's verify, 4 at its decode, at
//    most 48: kMaxRows), padded to MT tiles of 16.  QK and PV are mma.sync m16n8k16
//    bf16 -> f32, fragments loaded by ldmatrix from padded shared tiles
//    (rows of D + 8 bf16: the 8 rows of an 8x8 matrix start 4 banks apart).
//    Q is used unscaled in bf16 (exact); the softmax scale multiplies the
//    float32 scores.  P is rounded to bf16 for PV, as the Pallas bf16
//    kernels cast it (l sums it unrounded).  Warp w owns row tile w / KW
//    and the 16-key chunks kw, kw + KW, ... of every tile (kw = w % KW),
//    with its own flash state; the KW warps of a row tile merge in shared
//    memory at the end.  QK sums its even and odd k-steps in separate
//    accumulators, which halves its dependent chain of products.
//    mma.sync and not wgmma: at 4-20 rows the products are far below the
//    byte bound, and wgmma's 64-row minimum would pad them to 64.  The
//    decode pads its 4 rows to 16 and wastes 3/4 of the products, which
//    costs nothing the bytes do not already: what keeps bytes in flight is
//    the ring below and the count of live blocks, not the scoring, and the
//    tensor cores score a 64-key tile in 32 instructions a warp where a
//    D-deep fmaf chain per key took thousands.
// 3. Asynchronous loads.  A ring of kStages (2-4, sized per D, tile and
//    cache type to keep two blocks on an SM) K/V stages filled by
//    cp.async.cg, 16 bytes a thread, one commit group per tile: the copy of
//    tile j + kStages - 1 is in flight while the products of tile j run (at
//    orin's decode, 3 stages: both tiles of a split are issued before the
//    first is scored).  Over the pool a tile's table entry, at
//    tables[b * TS + j], is read when its copy is issued.  A window's rows
//    are strided by Nkv * D elements and its int8 row scales by Nkv
//    floats, so its scales go by 4-byte cp.async.ca, one a thread; rows
//    past the block's furthest frontier (the window's ragged end included)
//    are zero-filled by the copy (src-size 0), never read.
// 4. int8.  The ring stages int8 tiles (rows of D + 16 bytes) and both
//    row-scale vectors through the same cp.async path; each tile is then
//    widened into one bf16 K/V tile pair in shared memory (integers in
//    -127..127 are exact in bf16) that the bf16 path's ldmatrix reads.  The
//    K row scale multiplies the float32 scores with the softmax scale; the
//    V row scale is folded into P before P is rounded to bf16.  This rounds
//    P where the Pallas q8 kernels keep it float32; chip_smoke holds every
//    output row to the same 1e-2 of the float32 plain version as the bf16
//    kernels.  The dequantized window never reaches device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dllm {
namespace verify {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// Shared memory the ring (plus the int8 widening tile) may take: about
// half an SM's, so two blocks fit on one at the timed shape.
constexpr int kRingBudget = 102 * 1024;
constexpr int kDecodeTile = 64;  // positions per tile of a contiguous window
constexpr int kMaxRows = 48;     // rows a block takes: three 16-row tiles

struct Args {
  const __nv_bfloat16* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;  // int8 pools only
  const float* v_scale;
  const int* tables;
  const int* pos;  // pool: [B], the first query's; window: [B, G], each query's
  __nv_bfloat16* o;
  float* part_acc;  // [B, Nkv, S, R, D]
  float* part_ml;   // [B, Nkv, S, R, 2]: (m in log2 units, l)
  int B, G, Nq, Nkv, NB, bs, D, MB, T, S;
  float scale;
  // Pool only: elements between two table rows, at least MB (a window of a
  // wider table keeps that table's row stride).
  long long TS = 0;
  // Contiguous windows only: W positions, batch strides in elements of the
  // cache and of the scales.
  int W = 0;
  long long kv_bstride = 0;
  long long sc_bstride = 0;
};

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int D, int BS, int MT, bool Q8>
struct Cfg {
  static constexpr int kKW = cmin(MT == 1 ? 4 : 2, BS / 16);  // key warps
  static constexpr int kWarps = MT * kKW;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLd = D + 8;     // bf16 elements per shared row
  static constexpr int kLd8 = D + 16;   // bytes per int8 ring row
  static constexpr int kQBytes = 16 * MT * kLd * 2;
  static constexpr int kTileBytes = BS * kLd * 2;  // one bf16 K or V tile
  static constexpr int kStageBytes =
      Q8 ? 2 * BS * kLd8 + 2 * BS * 4 : 2 * kTileBytes;
  static constexpr int kWideBytes = Q8 ? 2 * kTileBytes : 0;
  static constexpr int kStages =
      cmin(4, cmax(2, (kRingBudget - kWideBytes) / kStageBytes));
  static constexpr int kRingBytes = kStages * kStageBytes + kWideBytes;
  static constexpr int kEpiBytes = kWarps * 16 * (D + 2) * 4;
  static constexpr int kSmem = kQBytes + cmax(kRingBytes, kEpiBytes);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// The same copies with zero fill: when `full` is false nothing is read and
// the destination is zeroed (src-size 0).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The furthest position any query of sequence b attends: pos[b] + G - 1
// over the pool; over a window the largest min(pos[b, g], W - 1).
template <bool Contig>
__device__ __forceinline__ int last_position(const Args& a, int b) {
  if constexpr (Contig) {
    int last = -1;
    for (int g = 0; g < a.G; ++g) last = max(last, min(a.pos[(long)b * a.G + g], a.W - 1));
    return last;
  } else {
    return a.pos[b] + a.G - 1;
  }
}

// The tiles that reach sequence b's furthest frontier.
template <bool Contig>
__device__ __forceinline__ int frontier_tiles(const Args& a, int b) {
  return min(a.MB, last_position<Contig>(a, b) / a.bs + 1);
}

// Start the cp.async copies of one pool block (K and V rows row0 ..
// row0 + BS - 1 of this kv head, plus their scales for int8) into a ring
// stage.  Every thread of the block takes part.
template <int D, int BS, int MT, bool Q8>
__device__ __forceinline__ void load_stage(unsigned char* stage, const Args& a, long row0) {
  using C = Cfg<D, BS, MT, Q8>;
  if constexpr (Q8) {
    constexpr int kChunks = D / 16;
    const int8_t* src[2] = {static_cast<const int8_t*>(a.k_pool) + row0 * D,
                            static_cast<const int8_t*>(a.v_pool) + row0 * D};
    for (int c = threadIdx.x; c < 2 * BS * kChunks; c += C::kThreads) {
      const int which = c / (BS * kChunks);
      const int r = (c / kChunks) % BS;
      const int cc = c % kChunks;
      cp_async16(stage + (which * BS + r) * C::kLd8 + cc * 16, src[which] + r * D + cc * 16);
    }
    float* sc = reinterpret_cast<float*>(stage + 2 * BS * C::kLd8);
    for (int c = threadIdx.x; c < BS / 2; c += C::kThreads) {
      const int which = c / (BS / 4);
      const int i = c % (BS / 4);
      cp_async16(sc + which * BS + 4 * i, (which ? a.v_scale : a.k_scale) + row0 + 4 * i);
    }
  } else {
    constexpr int kChunks = D / 8;
    const __nv_bfloat16* src[2] = {static_cast<const __nv_bfloat16*>(a.k_pool) + row0 * D,
                                   static_cast<const __nv_bfloat16*>(a.v_pool) + row0 * D};
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(stage);
    for (int c = threadIdx.x; c < 2 * BS * kChunks; c += C::kThreads) {
      const int which = c / (BS * kChunks);
      const int r = (c / kChunks) % BS;
      const int cc = c % kChunks;
      cp_async16(dst + (which * BS + r) * C::kLd + cc * 8, src[which] + r * D + cc * 8);
    }
  }
}

// Start the cp.async copies of one tile of a contiguous window (K and V
// positions t0 .. t0 + BS - 1 of sequence b and kv head hk, plus their
// scales for int8) into a ring stage, in the layout `load_stage` gives a
// pool block.  Rows past `last` (the block's frontier, at most W - 1) are
// zero-filled, not read.  Every thread of the block takes part.
template <int D, int BS, int MT, bool Q8>
__device__ __forceinline__ void load_stage_contig(unsigned char* stage, const Args& a, int b,
                                                  int hk, int t0, int last) {
  using C = Cfg<D, BS, MT, Q8>;
  const long row_stride = (long)a.Nkv * D;  // elements from one position to the next
  const long base = (long)b * a.kv_bstride + (long)t0 * row_stride + (long)hk * D;
  const int valid = last - t0 + 1;
  if constexpr (Q8) {
    constexpr int kChunks = D / 16;
    const int8_t* src[2] = {static_cast<const int8_t*>(a.k_pool) + base,
                            static_cast<const int8_t*>(a.v_pool) + base};
    for (int c = threadIdx.x; c < 2 * BS * kChunks; c += C::kThreads) {
      const int which = c / (BS * kChunks);
      const int r = (c / kChunks) % BS;
      const int cc = c % kChunks;
      const bool full = r < valid;
      cp_async16_zfill(stage + (which * BS + r) * C::kLd8 + cc * 16,
                       src[which] + (full ? r * row_stride + cc * 16 : 0), full);
    }
    float* sc = reinterpret_cast<float*>(stage + 2 * BS * C::kLd8);
    const long sbase = (long)b * a.sc_bstride + (long)t0 * a.Nkv + hk;
    for (int c = threadIdx.x; c < 2 * BS; c += C::kThreads) {
      const int r = c % BS;
      const bool full = r < valid;
      cp_async4_zfill(sc + c, (c < BS ? a.k_scale : a.v_scale) + sbase + (full ? r * a.Nkv : 0),
                      full);
    }
  } else {
    constexpr int kChunks = D / 8;
    const __nv_bfloat16* src[2] = {static_cast<const __nv_bfloat16*>(a.k_pool) + base,
                                   static_cast<const __nv_bfloat16*>(a.v_pool) + base};
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(stage);
    for (int c = threadIdx.x; c < 2 * BS * kChunks; c += C::kThreads) {
      const int which = c / (BS * kChunks);
      const int r = (c / kChunks) % BS;
      const int cc = c % kChunks;
      const bool full = r < valid;
      cp_async16_zfill(dst + (which * BS + r) * C::kLd + cc * 8,
                       src[which] + (full ? r * row_stride + cc * 8 : 0), full);
    }
  }
}

// Widen Rows staged int8 rows (Ld8 bytes apart) into bf16 rows (Ld
// elements apart) of `wide`, Threads threads taking part.  No int-to-float
// or float-to-bf16 conversion (both quarter-rate): byte x + 128 is placed
// under the float exponent of 2^23, 2^23 + 128 subtracted (exact), and the
// float's upper half is x in bf16 (an integer of at most 8 significant
// bits leaves the lower half zero).
template <int D, int Rows, int Threads, int Ld, int Ld8>
__device__ __forceinline__ void widen_rows(__nv_bfloat16* wide, const unsigned char* src) {
  constexpr int kChunks = D / 16;
  for (int c = threadIdx.x; c < Rows * kChunks; c += Threads) {
    const int row = c / kChunks;
    const int cc = c % kChunks;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + row * Ld8 + cc * 16);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = words[i] ^ 0x80808080u;  // bytes x + 128
      float f[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | k)) - 8388736.f;
      }
      w[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
      w[2 * i + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
    }
    uint4* dst = reinterpret_cast<uint4*>(wide + row * Ld + cc * 16);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// Widen a staged int8 K/V tile pair (K rows then V rows) into the bf16
// tile pair `wide`.
template <int D, int BS, int MT>
__device__ __forceinline__ void widen_stage(__nv_bfloat16* wide, const unsigned char* stage) {
  using C = Cfg<D, BS, MT, true>;
  widen_rows<D, 2 * BS, C::kThreads, C::kLd, C::kLd8>(wide, stage);
}

// Contig selects the tile source: false reads a slot's pool blocks
// through its table row (row g's frontier pos[b] + g), true a sequence's
// contiguous window through its strides (row g's frontier
// min(pos[b, g], W - 1)).
template <int D, int BS, int MT, bool Q8, bool Contig>
__global__ void __launch_bounds__(Cfg<D, BS, MT, Q8>::kThreads)
split_verify_kernel(const Args a) {
  using C = Cfg<D, BS, MT, Q8>;
  constexpr int KW = C::kKW;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + C::kQBytes;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int G = a.G;
  const int group = a.Nq / a.Nkv;
  const int R = group * G;
  const int last = last_position<Contig>(a, b);  // the furthest frontier
  const int n_tiles = min(a.MB, last / BS + 1);
  const int j0 = s * a.T;
  const int j1 = min(j0 + a.T, n_tiles);
  const long part = ((long)b * a.Nkv + hk) * a.S + s;
  float* ml_out = a.part_ml + part * R * 2;
  float* acc_out = a.part_acc + part * R * D;
  if (j0 >= j1) {  // past the slot's frontier: an empty partial
    for (int r = threadIdx.x; r < R; r += C::kThreads) {
      ml_out[2 * r] = kNegInf;
      ml_out[2 * r + 1] = 0.f;
    }
    return;
  }

  // Start the copy of tile j into ring stage i.
  const auto issue = [&](int i, int j) {
    unsigned char* stage = ring + i * C::kStageBytes;
    if constexpr (Contig) {
      load_stage_contig<D, BS, MT, Q8>(stage, a, b, hk, j * BS, last);
    } else {
      const long head_row0 = (long)hk * a.NB * BS;  // first pool row of this kv head
      load_stage<D, BS, MT, Q8>(stage, a, head_row0 + (long)a.tables[b * a.TS + j] * BS);
    }
  };
  // Prologue: the first kStages - 1 tiles in flight (one group each,
  // empty groups past the range keep the count uniform).
#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) {
    if (j0 + i < j1) issue(i, j0 + i);
    cp_async_commit();
  }

  // Q rows (unscaled bf16), padded rows zero.
  for (int c = threadIdx.x; c < 16 * MT * (D / 8); c += C::kThreads) {
    const int r = c / (D / 8);
    const int cc = c % (D / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < R) {
      const long q_row = ((long)b * G + r % G) * a.Nq + (long)hk * group + r / G;
      val = *reinterpret_cast<const uint4*>(a.q + q_row * D + cc * 8);
    }
    *reinterpret_cast<uint4*>(q_s + r * C::kLd + cc * 8) = val;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rt = warp / KW;  // row tile
  const int kw = warp % KW;  // key chunks kw, kw + KW, ...
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    ldmatrix_x4(qf[ks], q_s + (rt * 16 + (lane & 15)) * C::kLd + ks * 16 + (lane >> 4) * 8);
  }

  // This thread's two rows: rt * 16 + lane / 4 and that + 8.
  int front[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rt * 16 + (lane >> 2) + 8 * h;
    if (r >= R) {
      front[h] = -1;  // padded rows see nothing
    } else if constexpr (Contig) {
      front[h] = min(a.pos[(long)b * G + r % G], a.W - 1);
    } else {
      front[h] = a.pos[b] + r % G;
    }
  }
  const float qk_scale = a.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int it = 0; j0 + it < j1; ++it) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    {
      const int jn = j0 + it + C::kStages - 1;
      if (jn < j1) issue((it + C::kStages - 1) % C::kStages, jn);
      cp_async_commit();
    }
    const unsigned char* stage = ring + (it % C::kStages) * C::kStageBytes;
    const __nv_bfloat16* k_t;
    const float* ks_s = nullptr;
    const float* vs_s = nullptr;
    if constexpr (Q8) {
      __nv_bfloat16* wide =
          reinterpret_cast<__nv_bfloat16*>(ring + C::kStages * C::kStageBytes);
      widen_stage<D, BS, MT>(wide, stage);
      ks_s = reinterpret_cast<const float*>(stage + 2 * BS * C::kLd8);
      vs_s = ks_s + BS;
      k_t = wide;
      __syncthreads();
    } else {
      k_t = reinterpret_cast<const __nv_bfloat16*>(stage);
    }
    const __nv_bfloat16* v_t = k_t + BS * C::kLd;
    const int col0 = (j0 + it) * BS;

    for (int c = kw; c < BS / 16; c += KW) {
      if (col0 + c * 16 > last) break;  // warp-uniform: past every row's frontier
      // S = Q K^T for 16 rows x 16 keys (two n8 tiles), the even and odd
      // k-steps in separate accumulators.
      float part[2][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t kb[4];
        ldmatrix_x4(kb, k_t + (c * 16 + (lane >> 4) * 8 + (lane & 7)) * C::kLd + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(part[ks & 1][0], qf[ks], kb[0], kb[1]);
        mma_bf16(part[ks & 1][1], qf[ks], kb[2], kb[3]);
      }
      // Scale, mask, online softmax.  Element [nt][e] is row h = e / 2,
      // key c * 16 + nt * 8 + 2 * (lane % 4) + e % 2.
      float sc[2][4];
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c * 16 + nt * 8 + 2 * (lane & 3) + (e & 1);
          float x = (part[0][nt][e] + part[1][nt][e]) * qk_scale;
          if constexpr (Q8) x *= ks_s[key];
          sc[nt][e] = (col0 + key <= front[e >> 1]) ? x : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
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
      float p[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c * 16 + nt * 8 + 2 * (lane & 3) + (e & 1);
          const bool valid = col0 + key <= front[e >> 1];
          p[nt][e] = valid ? exp2f(sc[nt][e] - m[e >> 1]) : 0.f;
          l[e >> 1] += p[nt][e];
          if constexpr (Q8) p[nt][e] *= vs_s[key];  // V's row scale, folded into P
        }
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][0] *= alpha[0];
        acc[dn][1] *= alpha[0];
        acc[dn][2] *= alpha[1];
        acc[dn][3] *= alpha[1];
      }
      // P (bf16) as the A operand of PV: the S accumulator layout is the
      // A fragment's.
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_t + (c * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * C::kLd +
                                  dn * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dn], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dn + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the warps' merge

  float* e_acc = reinterpret_cast<float*>(ring);  // [warps][16][D]
  float* e_m = e_acc + C::kWarps * 16 * D;        // [warps][16]
  float* e_l = e_m + C::kWarps * 16;              // [warps][16]
  {
    const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int d = dn * 8 + 2 * (lane & 3);
      e_acc[r0 * D + d] = acc[dn][0];
      e_acc[r0 * D + d + 1] = acc[dn][1];
      e_acc[(r0 + 8) * D + d] = acc[dn][2];
      e_acc[(r0 + 8) * D + d + 1] = acc[dn][3];
    }
    const float l0 = quad_sum(l[0]);
    const float l1 = quad_sum(l[1]);
    if ((lane & 3) == 0) {
      e_m[r0] = m[0];
      e_m[r0 + 8] = m[1];
      e_l[r0] = l0;
      e_l[r0 + 8] = l1;
    }
  }
  __syncthreads();
  // Row r's state lives in warps r / 16 * KW + k, at row r % 16 of each:
  // its weights 2^(m_k - M) once per row (in place of m), then the sums.
  for (int r = threadIdx.x; r < R; r += C::kThreads) {
    const int at = r / 16 * KW * 16 + r % 16;
    float mm = kNegInf;
#pragma unroll
    for (int k = 0; k < KW; ++k) mm = fmaxf(mm, e_m[at + 16 * k]);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      e_m[at + 16 * k] = exp2f(e_m[at + 16 * k] - mm);
      sum += e_l[at + 16 * k] * e_m[at + 16 * k];
    }
    ml_out[2 * r] = mm;
    ml_out[2 * r + 1] = sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * D; i += C::kThreads) {
    const int at = i / D / 16 * KW * 16 + i / D % 16;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < KW; ++k) sum += e_acc[(at + 16 * k) * D + i % D] * e_m[at + 16 * k];
    acc_out[i] = sum;
  }
}

// One warp per output row (b, kv head, row): combine the partials of the
// splits the slot's frontier reaches and write the row as bf16.
constexpr int kMergeWarps = 4;

template <int D, bool Contig>
__global__ void __launch_bounds__(kMergeWarps * 32)
split_merge_kernel(const Args a) {
  // Output dims per lane, at least a bf16 pair: at D = 16 eight lanes
  // hold the row and the rest of the warp only finds the split weights.
  constexpr int kDims = D / 32 > 2 ? D / 32 : 2;
  constexpr int kLanes = D / kDims;
  const bool holds = (threadIdx.x % 32) < kLanes;
  const int group = a.Nq / a.Nkv;
  const int R = group * a.G;
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= a.B * a.Nkv * R) return;
  const int r = row % R;
  const int hk = (row / R) % a.Nkv;
  const int b = row / (R * a.Nkv);
  const int n_splits = (frontier_tiles<Contig>(a, b) + a.T - 1) / a.T;
  const long first = ((long)b * a.Nkv + hk) * a.S * R + r;  // partial of split 0

  float mm = kNegInf;
  for (int s = 0; s < n_splits; ++s) mm = fmaxf(mm, a.part_ml[2 * (first + (long)s * R)]);
  float out[kDims];
#pragma unroll
  for (int e = 0; e < kDims; ++e) out[e] = 0.f;
  float sum = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const long idx = first + (long)s * R;
    const float l_s = a.part_ml[2 * idx + 1];
    const float w = l_s > 0.f ? exp2f(a.part_ml[2 * idx] - mm) : 0.f;  // empty: weight 0
    sum += l_s * w;
    if (holds) {
      const float* src = a.part_acc + idx * D + lane * kDims;
#pragma unroll
      for (int e = 0; e < kDims; ++e) out[e] += w * src[e];
    }
  }
  if (!holds) return;
  const float inv = 1.f / fmaxf(sum, 1e-30f);
  const long o_row = ((long)b * a.G + r % a.G) * a.Nq + (long)hk * group + r / a.G;
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(a.o + o_row * D + lane * kDims);
#pragma unroll
  for (int e = 0; e < kDims; e += 2) dst[e / 2] = __floats2bfloat162_rn(out[e] * inv, out[e + 1] * inv);
}

// One block per output row (b, kv head, row), for rows with many splits
// (a window: 64 at orin's 8192 positions): warp w sums the partials of
// splits w, w + kRowMergeWarps, ... (four loads in flight a lane), the
// warps' sums meet in shared memory, and warp 0 writes the row as bf16.
// The same arithmetic as `split_merge_kernel`, summed in another order.
constexpr int kRowMergeWarps = 4;

template <int D, bool Contig>
__global__ void __launch_bounds__(kRowMergeWarps * 32)
split_merge_row_kernel(const Args a) {
  constexpr int kDims = D / 32;  // output dims per lane
  __shared__ float red_acc[kRowMergeWarps][D];
  __shared__ float red_m[kRowMergeWarps];
  __shared__ float red_l[kRowMergeWarps];
  const int group = a.Nq / a.Nkv;
  const int R = group * a.G;
  const int row = blockIdx.x;
  const int r = row % R;
  const int hk = (row / R) % a.Nkv;
  const int b = row / (R * a.Nkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_splits = (frontier_tiles<Contig>(a, b) + a.T - 1) / a.T;
  const long first = ((long)b * a.Nkv + hk) * a.S * R + r;  // partial of split 0
  const float2* ml = reinterpret_cast<const float2*>(a.part_ml);

  float mm = kNegInf;
  for (int s = threadIdx.x; s < n_splits; s += kRowMergeWarps * 32) {
    mm = fmaxf(mm, ml[first + (long)s * R].x);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, o));
  if (lane == 0) red_m[warp] = mm;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRowMergeWarps; ++k) mm = fmaxf(mm, red_m[k]);

  float out[kDims];
#pragma unroll
  for (int e = 0; e < kDims; ++e) out[e] = 0.f;
  float sum = 0.f;
#pragma unroll 4
  for (int s = warp; s < n_splits; s += kRowMergeWarps) {
    const long idx = first + (long)s * R;
    const float2 p = ml[idx];
    const float w = p.y > 0.f ? exp2f(p.x - mm) : 0.f;  // empty: weight 0
    sum += p.y * w;
    const float* src = a.part_acc + idx * D + lane * kDims;
#pragma unroll
    for (int e = 0; e < kDims; ++e) out[e] += w * src[e];
  }
#pragma unroll
  for (int e = 0; e < kDims; ++e) red_acc[warp][lane * kDims + e] = out[e];
  if (lane == 0) red_l[warp] = sum;
  __syncthreads();
  if (warp != 0) return;
  sum = 0.f;
#pragma unroll
  for (int k = 0; k < kRowMergeWarps; ++k) sum += red_l[k];
#pragma unroll
  for (int e = 0; e < kDims; ++e) {
    out[e] = 0.f;
#pragma unroll
    for (int k = 0; k < kRowMergeWarps; ++k) out[e] += red_acc[k][lane * kDims + e];
  }
  const float inv = 1.f / fmaxf(sum, 1e-30f);
  const long o_row = ((long)b * a.G + r % a.G) * a.Nq + (long)hk * group + r / a.G;
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(a.o + o_row * D + lane * kDims);
#pragma unroll
  for (int e = 0; e < kDims; e += 2) dst[e / 2] = __floats2bfloat162_rn(out[e] * inv, out[e + 1] * inv);
}

template <int D, int BS, int MT, bool Q8, bool Contig>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<D, BS, MT, Q8>;
  auto kernel = split_verify_kernel<D, BS, MT, Q8, Contig>;
  if (C::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.Nkv, a.B, a.S), C::kThreads, C::kSmem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = a.B * a.Nkv * (a.Nq / a.Nkv) * a.G;
  if constexpr (Contig) {
    split_merge_row_kernel<D, true><<<rows, kRowMergeWarps * 32, 0, stream>>>(a);
  } else {
    split_merge_kernel<D, false><<<(rows + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <bool Q8, bool Contig, int D, int BS>
cudaError_t dispatch_rows(const Args& a, cudaStream_t stream) {
  switch ((a.Nq / a.Nkv * a.G + 15) / 16) {
    case 1:
      return launch<D, BS, 1, Q8, Contig>(a, stream);
    case 2:
      return launch<D, BS, 2, Q8, Contig>(a, stream);
    case 3:
      return launch<D, BS, 3, Q8, Contig>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool Q8, int D>
cudaError_t dispatch_bs(const Args& a, cudaStream_t stream) {
  switch (a.bs) {
    case 16:
      return dispatch_rows<Q8, false, D, 16>(a, stream);
    case 32:
      return dispatch_rows<Q8, false, D, 32>(a, stream);
    case 64:
      return dispatch_rows<Q8, false, D, 64>(a, stream);
    case 128:
      return dispatch_rows<Q8, false, D, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The split route over the pool: returns the first failing launch's
// cudaError_t (0 = both launched).  D must be 16, 64 or 128 (16: the tiny
// test presets), bs 16, 32, 64 or 128,
// Nq a multiple of Nkv, (Nq / Nkv) * G at most kMaxRows, S * T at least
// MB, and the table's row stride TS at least MB.
template <bool Q8>
int split_verify_attention(const Args& a, void* stream) {
  if (a.Nkv <= 0 || a.Nq % a.Nkv != 0 || a.G < 1 || a.Nq / a.Nkv * a.G > kMaxRows || a.B < 1 ||
      a.TS < a.MB || a.T < 1 || a.S < 1 || (long)a.S * a.T < a.MB) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.D) {
    case 16:
      return (int)dispatch_bs<Q8, 16>(a, s);
    case 64:
      return (int)dispatch_bs<Q8, 64>(a, s);
    case 128:
      return (int)dispatch_bs<Q8, 128>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The split route over a contiguous window (flash_decode.cu and
// flash_decode_q8.cu at S_q = 1, flash_chunk.cu's few-row chunks at
// S_q = G): returns the first failing launch's cudaError_t (0 = both
// launched).  q [B, S_q, Nq, D], q_pos [B, S_q].  D must be 64 or 128, Nq
// a multiple of Nkv with (Nq / Nkv) * S_q at most kMaxRows, W >= 1 and
// S * T at least ceil(W / 64).  The scale pointers are read only when Q8.
template <bool Q8>
int split_window_attention(const void* q, const void* k, const void* v, const void* k_scale,
                           const void* v_scale, const void* q_pos, void* o, void* part_acc,
                           void* part_ml, int B, int S_q, int Nq, int Nkv, int D, int W, int T,
                           int S, long long kv_bstride, long long sc_bstride, float scale,
                           void* stream) {
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_pool = k;
  a.v_pool = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.pos = static_cast<const int*>(q_pos);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.B = B;
  a.G = S_q;
  a.Nq = Nq;
  a.Nkv = Nkv;
  a.bs = kDecodeTile;
  a.D = D;
  a.MB = (W + kDecodeTile - 1) / kDecodeTile;
  a.T = T;
  a.S = S;
  a.scale = scale;
  a.W = W;
  a.kv_bstride = kv_bstride;
  a.sc_bstride = sc_bstride;
  if (S_q < 1 || Nkv <= 0 || Nq % Nkv != 0 || Nq / Nkv * S_q > kMaxRows || B < 1 || W < 1 ||
      T < 1 || S < 1 || (long)S * T < a.MB) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)dispatch_rows<Q8, true, 64, kDecodeTile>(a, s);
    case 128:
      return (int)dispatch_rows<Q8, true, 128, kDecodeTile>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace verify
}  // namespace dllm
