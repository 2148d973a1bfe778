// Flash attention of a chunk of queries over the sequential engines'
// contiguous bf16 KV cache, for Hopper: the kernel behind flash_chunk.cu,
// which replaces the Pallas TPU kernels `_chunk_kernel_native` /
// `_chunk_kernel` (distributed_llm_tpu/ops/pallas_attention.py).  It has
// no split plan: one block per (query tile, kv head, sequence), below.
// (The one-token decode over the same cache, flash_decode.cu and
// flash_decode_q8.cu, is ragged_verify.cuh's split-K kernel reading
// contiguous tiles; the int8 chunk, flash_chunk_q8.cu, is flash_tc.cuh's
// tensor-core kernel.)
//
// Layout: q [B, S_q, Nq, D] bf16; one layer's cache window of W positions,
// element (b, t, h, d) at b * kv_bstride + (t * Nkv + h) * D + d.  The
// batch stride is the caller's: a window [:, :W] of a longer cache is read
// in place, never copied.  q_pos
// [B, S_q] int32 holds each query's absolute position; query i of
// sequence b attends cache positions 0 .. min(q_pos[b, i], W - 1).  Each
// row's position is read from q_pos by the block itself (the Pallas chunk
// kernels rebuild it as start + r from a scalar, TPU SMEM allowing only
// scalar loads), so padded chunk rows match the plain version too.
//
// Work split: one block of 4 warps per (query tile, kv head, sequence).
// The block's rows are the group's Nq / Nkv heads times the tile's
// query positions, row r = position (r / group) and head
// hk * group + r % group; warp w owns rows w, w + 4, ..., w + 4 (R - 1)
// (R = 2 or 16: 8 or 64 rows).  The block walks the cache in 64-position
// tiles up to its furthest row's frontier: each [64, D] K/V tile is staged
// in shared memory once and read there by every row, and a row skips the
// tiles that start past its own frontier (an all-masked tile leaves the
// flash state as it is).  What bounds it and what that costs is in
// flash_chunk.cu.
//
// Numerics follow the Pallas kernels (attn_common.cuh): q scaled in
// float32 before QK, float32 max/sum/accumulator, output over
// max(l, 1e-30); probabilities rounded to bf16 before PV.
#pragma once

#include "ragged_paged.cuh"

namespace dllm {

constexpr int kContigTile = 64;  // cache positions per staged tile

struct ContigArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  void* o;
  int B, S_q, Nq, Nkv, D, W;
  long long kv_bstride;
  float scale;
};

template <int D, int R>
constexpr size_t contig_smem_bytes() {
  return ragged_smem_bytes<D, kContigTile, false>(kWarps * R) + kWarps * R * sizeof(int);
}

template <int D, int R>
__global__ void __launch_bounds__(kThreads)
contiguous_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
                  __nv_bfloat16* __restrict__ o, int S_q, int Nq, int Nkv, int W,
                  long long kv_bstride, float scale) {
  constexpr int BK = kContigTile;
  constexpr int kRows = kWarps * R;
  constexpr int kTileWords = Tile<D>::kWords;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  uint32_t* k_s = reinterpret_cast<uint32_t*>(q_s + kRows * D);
  uint32_t* v_s = k_s + BK * kTileWords;
  int* f_s = reinterpret_cast<int*>(v_s + BK * kTileWords);  // row frontiers

  const int group = Nq / Nkv;
  const int per_block = kRows / group;  // query positions per block
  const int i0 = blockIdx.x * per_block;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_pos = min(per_block, S_q - i0);
  const int rows = n_pos * group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int* pos_b = q_pos + (long)b * S_q + i0;

  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    f_s[r] = r < rows ? min(pos_b[r / group], W - 1) : -1;
  }
  RowState<D> st[R];
#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    st[ri].init();
    const int r = warp + ri * kWarps;
    if (r < rows) {
      const long q_row = ((long)b * S_q + i0 + r / group) * Nq + (long)hk * group + r % group;
      load_query_row<D>(q_s + r * D, q + q_row * D, scale, lane);
    }
  }
  __syncthreads();
  int last = 0;  // the block's furthest frontier
  for (int r = 0; r < rows; r += group) last = max(last, f_s[r]);

  const long row_stride = (long)Nkv * D;
  const long base = (long)b * kv_bstride + (long)hk * D;
  const int n_tiles = last / BK + 1;
  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = j * BK;
    const int valid = min(BK, W - t0);
    __syncthreads();
    load_tile<D, BK>(k_s, k + base + t0 * row_stride, row_stride, valid);
    load_tile<D, BK>(v_s, v + base + t0 * row_stride, row_stride, valid);
    __syncthreads();
#pragma unroll
    for (int ri = 0; ri < R; ++ri) {
      const int r = warp + ri * kWarps;  // warp-uniform: the shuffles stay full
      if (r >= rows) continue;
      const int frontier = f_s[r];
      if (t0 > frontier) continue;
      attend_tile<D, BK>(q_s + r * D, k_s, v_s, t0, frontier, lane, st[ri]);
    }
  }

#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    const int r = warp + ri * kWarps;
    if (r < rows) {
      const long o_row = ((long)b * S_q + i0 + r / group) * Nq + (long)hk * group + r % group;
      store_row<D>(o + o_row * D, st[ri], lane);
    }
  }
}

template <int D, int R>
cudaError_t contiguous_launch(const ContigArgs& a, cudaStream_t stream) {
  auto kernel = contiguous_kernel<D, R>;
  constexpr size_t smem = contig_smem_bytes<D, R>();
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int per_block = kWarps * R / (a.Nq / a.Nkv);
  dim3 grid((a.S_q + per_block - 1) / per_block, a.Nkv, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.q_pos, static_cast<__nv_bfloat16*>(a.o), a.S_q,
      a.Nq, a.Nkv, a.W, a.kv_bstride, a.scale);
  return cudaGetLastError();
}

// Rows per warp: the 8-row tile for a chunk of at most 8 rows in all
// (positions times the group), else the 64-row tile.
template <int D>
cudaError_t contiguous_dispatch_rows(const ContigArgs& a, cudaStream_t stream) {
  const int group = a.Nq / a.Nkv;
  const int rows = group * a.S_q;
  if (rows <= kWarps * 2) return contiguous_launch<D, 2>(a, stream);
  if (group <= kWarps * 16) return contiguous_launch<D, 16>(a, stream);
  return cudaErrorInvalidValue;
}

// The C entry of the bf16 chunk kernel (flash_chunk.cu): returns the
// launch's cudaError_t (0 = launched).  D must be 64 or 128, Nq a multiple
// of Nkv with a group of at most 64, S_q >= 1 and W >= 1.
inline int contiguous_entry(const void* q, const void* k, const void* v, const void* q_pos,
                            void* o, int B, int S_q, int Nq, int Nkv, int D, int W,
                            long long kv_bstride, float scale, void* stream) {
  const ContigArgs a{q, k, v, static_cast<const int*>(q_pos), o, B, S_q, Nq, Nkv, D, W,
                     kv_bstride, scale};
  if (a.Nkv <= 0 || a.Nq % a.Nkv != 0 || a.S_q < 1 || a.B < 1 || a.W < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.D) {
    case 64:
      return (int)contiguous_dispatch_rows<64>(a, s);
    case 128:
      return (int)contiguous_dispatch_rows<128>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dllm
