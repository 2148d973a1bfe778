// Paged decode attention for Hopper over a bf16 pool through a window of
// the block table, one query per slot: the CUDA-core kernel behind
// paged_decode.cu (K7), the port's first decode design.  Every other
// decode and verify kernel over the pool (K1, K4, K5, K6, K8) runs
// ragged_verify.cuh's split-K kernel.
//
// Layout: q [B, Nq, D] bf16; one layer's pool [Nkv, NB, bs, D] bf16;
// tables [B, wb] int32, a window of each slot's row that may be a column
// slice of the full table, so row b is read at tables + b * TS (TS >= wb,
// the full table's row stride); pos [B] int32 with every pos < wb * bs.
// Both are read on the device.  Slot b attends positions 0 .. pos[b],
// position p living at (tables[b, p / bs], p % bs).  Its K/V are already
// written (write-before-attend); idle slots point their whole row at the
// trash block 0 with pos 0 and read it like any other.
//
// Work split: one block of 4 warps per (kv head, slot).  The block's
// query rows are the group's Nq / Nkv heads; warp w owns rows w and w + 4
// (up to 8 rows).  The block walks min(wb, pos / bs + 1) tiles, the
// Pallas index map's clamp min(j, pos // bs): each [bs, D] K/V tile is
// staged in shared memory once and read there by every row.
//
// Numerics follow the Pallas kernel: q scaled in float32 before QK,
// float32 max/sum/accumulator, the probabilities rounded to bf16 before PV
// (attn_common.cuh's attend_tile), output over max(l, 1e-30).
#pragma once

#include "attn_common.cuh"

namespace dllm {

struct PagedArgs {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* pos;
  void* o;
  int B, Nq, Nkv, NB, bs, D, wb;
  long TS;  // elements between two table rows (>= wb)
  float scale;
};

template <int D, int BS>
constexpr size_t paged_smem_bytes(int rows) {
  return (size_t)rows * D * sizeof(float) + 2 * (size_t)BS * Tile<D>::kWords * sizeof(uint32_t);
}

template <int D, int BS, int R>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pool,
                    const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ pos, __nv_bfloat16* __restrict__ o, int Nq, int Nkv,
                    int NB, int wb, long table_stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRows = kWarps * R;
  float* q_s = reinterpret_cast<float*>(smem_raw);
  uint32_t* k_s = reinterpret_cast<uint32_t*>(q_s + kRows * D);
  uint32_t* v_s = k_s + BS * Tile<D>::kWords;

  const int group = Nq / Nkv;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p0 = pos[b];
  const int* row_table = tables + (long)b * table_stride;

  // Row r is query head hk * group + r.
  RowState<D> st[R];
#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    st[ri].init();
    const int r = warp + ri * kWarps;
    if (r < group) {
      load_query_row<D>(q_s + r * D, q + ((long)b * Nq + (long)hk * group + r) * D, scale, lane);
    }
  }

  const int n_tiles = min(wb, p0 / BS + 1);
  const long head_row0 = (long)hk * NB * BS;  // first pool row of this kv head
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();
    const long row0 = head_row0 + (long)row_table[j] * BS;
    load_tile<D, BS>(k_s, k_pool + row0 * D, D, BS);
    load_tile<D, BS>(v_s, v_pool + row0 * D, D, BS);
    __syncthreads();
#pragma unroll
    for (int ri = 0; ri < R; ++ri) {
      const int r = warp + ri * kWarps;  // warp-uniform: the shuffles stay full
      if (r < group) attend_tile<D, BS>(q_s + r * D, k_s, v_s, j * BS, p0, lane, st[ri]);
    }
  }

#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    const int r = warp + ri * kWarps;
    if (r < group) {
      store_row<D>(o + ((long)b * Nq + (long)hk * group + r) * D, st[ri], lane);
    }
  }
}

// Two rows per warp: a group of at most 8.
template <int D, int BS>
cudaError_t paged_launch(const PagedArgs& a, cudaStream_t stream) {
  constexpr int kR = 2;
  if (a.Nq / a.Nkv > kWarps * kR) return cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<D, BS, kR>;
  const size_t smem = paged_smem_bytes<D, BS>(kWarps * kR);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(a.Nkv, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k_pool),
      static_cast<const __nv_bfloat16*>(a.v_pool), a.tables, a.pos,
      static_cast<__nv_bfloat16*>(a.o), a.Nq, a.Nkv, a.NB, a.wb, a.TS, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t paged_dispatch_bs(const PagedArgs& a, cudaStream_t stream) {
  switch (a.bs) {
    case 32:
      return paged_launch<D, 32>(a, stream);
    case 64:
      return paged_launch<D, 64>(a, stream);
    case 128:
      return paged_launch<D, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Returns the launch's cudaError_t (0 = launched).  D must be 64 or 128,
// bs 32, 64 or 128, Nq a multiple of Nkv with Nq / Nkv at most 8, and the
// table's row stride TS at least wb.
inline int paged_decode_attention_bf16(const PagedArgs& a, void* stream) {
  if (a.Nkv <= 0 || a.Nq % a.Nkv != 0 || a.B < 1 || a.TS < a.wb) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.D) {
    case 64:
      return (int)paged_dispatch_bs<64>(a, s);
    case 128:
      return (int)paged_dispatch_bs<128>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dllm
