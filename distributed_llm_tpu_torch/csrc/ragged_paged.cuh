// Ragged paged attention for Hopper over a bf16 or an int8 pool, for
// decode (G = 1 query per slot) and speculative verify (G = gamma + 1
// queries per slot): the kernel behind ragged_decode.cu,
// ragged_verify.cu, ragged_decode_q8.cu and ragged_verify_q8.cu.
//
// Layout: q [B, G, Nq, D] bf16 (decode: G = 1, i.e. [B, Nq, D]); one
// layer's pool [Nkv, NB, bs, D], bf16 or int8, and for int8 the float32
// per-row scales [Nkv, NB, bs]; tables [B, MB] int32 hold each slot's
// FULL block row and pos [B] int32 the FIRST query's position, both read
// on the device.  The dense windowed decode (paged_decode.cu,
// paged_decode_q8.cu) passes a window [B, wb] of the table instead, MB =
// wb, with every position below wb * bs; such a window may be a column
// slice of the full table, so rows are read through their own stride TS
// (TS = MB for a contiguous table).  Query g of slot b sits at position pos[b] + g and
// attends positions 0 .. pos[b] + g, position p living at
// (tables[b, p / bs], p % bs).  Its K/V are already written
// (write-before-attend); idle slots point their whole row at the trash
// block 0 with pos 0, and rows a slot does not speculate on may reach
// trash entries of its row: both read the trash block like any other.
//
// Work split: one block of 4 warps per (kv head, slot).  The block's
// query rows are the group's Nq / Nkv heads times the G positions, row
// r = head_in_group * G + g; warp w owns rows w, w + 4, ..., w + 4 (R - 1)
// (R = 2, 5 or 10: up to 8, 20 or 40 rows).  The block walks
// min(MB, (pos + G - 1) / bs + 1) tiles, the frontier of its last query:
// each [bs, D] K/V tile is staged in shared memory once and read there
// by every row, and a row skips the tiles that start past its own
// frontier pos + g (an all-masked tile leaves the flash state as it is).
//
// Numerics follow the Pallas kernels: q scaled in float32 before QK,
// float32 max/sum/accumulator, output over max(l, 1e-30).  bf16: the
// probabilities are rounded to bf16 before PV (attn_common.cuh's
// attend_tile).  int8: K and V are dequantized as float(int8) *
// scale[row] while they are read from shared memory (the scale is
// applied to the dot product and to the probability, which is the same
// product in another order), and the probabilities stay float32 for PV;
// the dequantized values never reach device memory.
#pragma once

#include "attn_common.cuh"

namespace dllm {

// 32-bit words per padded shared-memory row of D int8 values: an odd
// stride, so the 32 lanes of a warp reading 32 key rows hit 32 banks.
template <int D>
struct Tile8 {
  static constexpr int kWords = D / 4 + 1;
};

struct RaggedArgs {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;  // int8 pools only
  const float* v_scale;
  const int* tables;
  const int* pos;
  void* o;
  int B, G, Nq, Nkv, NB, bs, D, MB;
  long TS;  // elements between two table rows (>= MB)
  float scale;
};

// Stage BS rows of D int8 values (row r at src + r * D bytes) into a
// padded tile.  16-byte global loads: D is 64 or 128 and every pool row
// starts on a multiple of D bytes.
template <int D, int BS>
__device__ __forceinline__ void load_tile_q8(uint32_t* __restrict__ tile,
                                             const int8_t* __restrict__ src) {
  constexpr int kChunks = D / 16;  // uint4 per row
  for (int c = threadIdx.x; c < BS * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int cc = c % kChunks;
    const uint4 val = *reinterpret_cast<const uint4*>(src + (long)r * D + cc * 16);
    uint32_t* dst = tile + r * Tile8<D>::kWords + cc * 4;
    dst[0] = val.x;
    dst[1] = val.y;
    dst[2] = val.z;
    dst[3] = val.w;
  }
}

// int8 twin of attend_tile: one online-softmax step of one query row
// against one staged int8 key tile (scales ks_s / vs_s per key row).
// Keys col0 .. col0 + BS - 1 with col > frontier are masked; the caller
// only passes tiles whose first key is <= frontier.  All 32 lanes of the
// row's warp call it.
template <int D, int BS>
__device__ __forceinline__ void attend_tile_q8(const float* __restrict__ q_s,
                                               const uint32_t* __restrict__ k_s,
                                               const uint32_t* __restrict__ v_s,
                                               const float* __restrict__ ks_s,
                                               const float* __restrict__ vs_s,
                                               int col0, int frontier, int lane,
                                               RowState<D>& st) {
  constexpr int kKeys = BS / 32;  // keys per lane
  constexpr int kW = Tile8<D>::kWords;
  constexpr int kDims = RowState<D>::kDims;

  float s[kKeys];
  float tile_max = kNegInf;
#pragma unroll
  for (int i = 0; i < kKeys; ++i) {
    const int t = lane + 32 * i;
    const uint32_t* krow = k_s + t * kW;
    float dot = 0.f;
#pragma unroll 8
    for (int w = 0; w < D / 4; ++w) {
      const uint32_t word = krow[w];
      const char4 c = *reinterpret_cast<const char4*>(&word);
      dot = fmaf(q_s[4 * w], (float)c.x, dot);
      dot = fmaf(q_s[4 * w + 1], (float)c.y, dot);
      dot = fmaf(q_s[4 * w + 2], (float)c.z, dot);
      dot = fmaf(q_s[4 * w + 3], (float)c.w, dot);
    }
    s[i] = (col0 + t <= frontier) ? dot * ks_s[t] : kNegInf;
    tile_max = fmaxf(tile_max, s[i]);
  }
  tile_max = warp_max(tile_max);
  const float m_new = fmaxf(st.m, tile_max);
  const float alpha = expf(st.m - m_new);

  float p[kKeys];
  float psum = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys; ++i) {
    p[i] = expf(s[i] - m_new);
    psum += p[i];
  }
  psum = warp_sum(psum);

  float pv[kDims];
#pragma unroll
  for (int e = 0; e < kDims; ++e) pv[e] = 0.f;
  const int8_t* v_bytes = reinterpret_cast<const int8_t*>(v_s);
#pragma unroll
  for (int i = 0; i < kKeys; ++i) {
#pragma unroll 4
    for (int src = 0; src < 32; ++src) {
      const int t = src + 32 * i;
      const float pb = __shfl_sync(kFullMask, p[i], src) * vs_s[t];
      const int8_t* vrow = v_bytes + t * kW * 4 + lane * kDims;
#pragma unroll
      for (int e = 0; e < kDims; ++e) pv[e] = fmaf(pb, (float)vrow[e], pv[e]);
    }
  }

  st.l = st.l * alpha + psum;
#pragma unroll
  for (int e = 0; e < kDims; ++e) st.acc[e] = st.acc[e] * alpha + pv[e];
  st.m = m_new;
}

template <int D, int BS, bool Q8>
constexpr size_t ragged_smem_bytes(int rows) {
  return (size_t)rows * D * sizeof(float) +
         2 * (size_t)BS * (Q8 ? Tile8<D>::kWords : Tile<D>::kWords) * sizeof(uint32_t) +
         (Q8 ? 2 * (size_t)BS * sizeof(float) : 0);
}

template <int D, int BS, int R, bool Q8>
__global__ void __launch_bounds__(kThreads)
ragged_paged_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pool,
                    const void* __restrict__ v_pool, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ tables,
                    const int* __restrict__ pos, __nv_bfloat16* __restrict__ o, int G,
                    int Nq, int Nkv, int NB, int MB, long table_stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRows = kWarps * R;
  constexpr int kTileWords = Q8 ? Tile8<D>::kWords : Tile<D>::kWords;
  float* q_s = reinterpret_cast<float*>(smem_raw);
  uint32_t* k_s = reinterpret_cast<uint32_t*>(q_s + kRows * D);
  uint32_t* v_s = k_s + BS * kTileWords;
  float* ks_s = reinterpret_cast<float*>(v_s + BS * kTileWords);  // int8 only
  float* vs_s = ks_s + BS;

  const int group = Nq / Nkv;
  const int rows = group * G;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p0 = pos[b];
  const int* row_table = tables + (long)b * table_stride;

  // Query head of row r: hk * group + r / G, at position p0 + r % G.
  RowState<D> st[R];
#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    st[ri].init();
    const int r = warp + ri * kWarps;
    if (r < rows) {
      const long q_row = ((long)b * G + r % G) * Nq + (long)hk * group + r / G;
      load_query_row<D>(q_s + r * D, q + q_row * D, scale, lane);
    }
  }

  const int n_tiles = min(MB, (p0 + G - 1) / BS + 1);
  const long head_row0 = (long)hk * NB * BS;  // first pool row of this kv head
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();
    const long row0 = head_row0 + (long)row_table[j] * BS;
    if constexpr (Q8) {
      load_tile_q8<D, BS>(k_s, static_cast<const int8_t*>(k_pool) + row0 * D);
      load_tile_q8<D, BS>(v_s, static_cast<const int8_t*>(v_pool) + row0 * D);
      for (int t = threadIdx.x; t < BS; t += kThreads) {
        ks_s[t] = k_scale[row0 + t];
        vs_s[t] = v_scale[row0 + t];
      }
    } else {
      load_tile<D, BS>(k_s, static_cast<const __nv_bfloat16*>(k_pool) + row0 * D, D, BS);
      load_tile<D, BS>(v_s, static_cast<const __nv_bfloat16*>(v_pool) + row0 * D, D, BS);
    }
    __syncthreads();
#pragma unroll
    for (int ri = 0; ri < R; ++ri) {
      const int r = warp + ri * kWarps;  // warp-uniform: the shuffles stay full
      if (r >= rows) continue;
      const int frontier = p0 + r % G;
      if (j * BS > frontier) continue;
      if constexpr (Q8) {
        attend_tile_q8<D, BS>(q_s + r * D, k_s, v_s, ks_s, vs_s, j * BS, frontier, lane,
                              st[ri]);
      } else {
        attend_tile<D, BS>(q_s + r * D, k_s, v_s, j * BS, frontier, lane, st[ri]);
      }
    }
  }

#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    const int r = warp + ri * kWarps;
    if (r < rows) {
      const long o_row = ((long)b * G + r % G) * Nq + (long)hk * group + r / G;
      store_row<D>(o + o_row * D, st[ri], lane);
    }
  }
}

template <int D, int BS, int R, bool Q8>
cudaError_t ragged_launch(const RaggedArgs& a, cudaStream_t stream) {
  auto kernel = ragged_paged_kernel<D, BS, R, Q8>;
  const size_t smem = ragged_smem_bytes<D, BS, Q8>(kWarps * R);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(a.Nkv, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.k_pool, a.v_pool, a.k_scale, a.v_scale,
      a.tables, a.pos, static_cast<__nv_bfloat16*>(a.o), a.G, a.Nq, a.Nkv, a.NB, a.MB,
      a.TS, a.scale);
  return cudaGetLastError();
}

// Rows per warp for (group x G) rows; MaxR bounds the instantiations a
// source carries (decode: group <= 8 rows, R = 2 only).
template <bool Q8, int MaxR, int D, int BS>
cudaError_t ragged_dispatch_rows(const RaggedArgs& a, cudaStream_t stream) {
  const int rows = (a.Nq / a.Nkv) * a.G;
  if (rows <= kWarps * 2) return ragged_launch<D, BS, 2, Q8>(a, stream);
  if constexpr (MaxR >= 10) {
    if (rows <= kWarps * 5) return ragged_launch<D, BS, 5, Q8>(a, stream);
    if (rows <= kWarps * 10) return ragged_launch<D, BS, 10, Q8>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <bool Q8, int MaxR, int D>
cudaError_t ragged_dispatch_bs(const RaggedArgs& a, cudaStream_t stream) {
  switch (a.bs) {
    case 32:
      return ragged_dispatch_rows<Q8, MaxR, D, 32>(a, stream);
    case 64:
      return ragged_dispatch_rows<Q8, MaxR, D, 64>(a, stream);
    case 128:
      return ragged_dispatch_rows<Q8, MaxR, D, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Returns the launch's cudaError_t (0 = launched).  D must be 64 or 128,
// bs 32, 64 or 128, Nq a multiple of Nkv, and (Nq / Nkv) * G at most
// 4 * MaxR.
template <bool Q8, int MaxR>
int ragged_paged_attention(const RaggedArgs& a, void* stream) {
  if (a.Nkv <= 0 || a.Nq % a.Nkv != 0 || a.G < 1 || a.B < 1 || a.TS < a.MB) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.D) {
    case 64:
      return (int)ragged_dispatch_bs<Q8, MaxR, 64>(a, s);
    case 128:
      return (int)ragged_dispatch_bs<Q8, MaxR, 128>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dllm
