// Suffix-chunk attention straight out of the paged KV pool, for Hopper.
//
// Replaces the Pallas TPU kernel `_paged_chunk_kernel` behind
// `paged_chunk_attention` (distributed_llm_tpu/ops/pallas_attention.py).
// q [1, S_c, Nq, D] bf16 are a chunk's queries at absolute positions
// start + r; the pool is one layer [Nkv, NB, bs, D] bf16 and table [MB]
// int32 is the slot's block row, so position p lives at
// (table[p / bs], p % bs).  Row r attends positions 0 .. start + r of the
// first window / bs table blocks (the chunk's own K/V are already
// written).  start [1] int32 is read on the device.
//
// Bound on the card: a chunk of S_c rows over P cached positions does
// about 4 Nq D S_c P operations on about 4 Nkv D P bytes of K/V, so the
// serving chunks (S_c = 256) sit near the balance of bytes and bf16
// operations, and a prefix hit (few real rows) is bound by bytes.  This
// first design runs the products on the CUDA cores in float32, far
// above that bound.  What it does about it: one block per (64-row q
// tile, q head) walks the table inside the block (the Pallas kernel's
// sequential table axis), stages each pool block's [bs, D] K/V tile in
// shared memory once for all 64 rows, and stops at the tile holding the
// chunk's last row's frontier instead of walking the whole window.
// wgmma and TMA come with a later change.
#include "attn_common.cuh"

namespace {

using dllm::kThreads;
using dllm::kWarps;

template <int D, int BQ, int BS>
__global__ void __launch_bounds__(dllm::kThreads)
paged_chunk_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k_pool,
                   const __nv_bfloat16* __restrict__ v_pool,
                   const int* __restrict__ table, const int* __restrict__ start_ptr,
                   __nv_bfloat16* __restrict__ o, int S_c, int Nq, int Nkv, int NB,
                   int window_blocks, float scale) {
  constexpr int kRowsPerWarp = BQ / kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  uint32_t* k_s = reinterpret_cast<uint32_t*>(q_s + BQ * D);
  uint32_t* v_s = k_s + BS * dllm::Tile<D>::kWords;

  const int r0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int hk = h / (Nq / Nkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int start = start_ptr[0];

  const long q_row_stride = (long)Nq * D;
  const __nv_bfloat16* q_h = q + (long)h * D;
  const long head_off = (long)hk * NB * BS * D;

  dllm::RowState<D> st[kRowsPerWarp];
#pragma unroll
  for (int ri = 0; ri < kRowsPerWarp; ++ri) {
    st[ri].init();
    const int i = warp + ri * kWarps;
    const int row = r0 + i;
    if (row < S_c) dllm::load_query_row<D>(q_s + i * D, q_h + row * q_row_stride, scale, lane);
  }

  const int last_pos = start + min(r0 + BQ, S_c) - 1;
  const int n_tiles = min(window_blocks, last_pos / BS + 1);
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();
    const long blk_off = head_off + (long)table[j] * BS * D;
    dllm::load_tile<D, BS>(k_s, k_pool + blk_off, D, BS);
    dllm::load_tile<D, BS>(v_s, v_pool + blk_off, D, BS);
    __syncthreads();
    const int col0 = j * BS;
#pragma unroll
    for (int ri = 0; ri < kRowsPerWarp; ++ri) {
      const int i = warp + ri * kWarps;
      const int row = r0 + i;
      const int frontier = start + row;
      if (row < S_c && col0 <= frontier) {
        dllm::attend_tile<D, BS>(q_s + i * D, k_s, v_s, col0, frontier, lane, st[ri]);
      }
    }
  }

#pragma unroll
  for (int ri = 0; ri < kRowsPerWarp; ++ri) {
    const int row = r0 + warp + ri * kWarps;
    if (row < S_c) {
      dllm::store_row<D>(o + (long)row * q_row_stride + (long)h * D, st[ri], lane);
    }
  }
}

template <int D, int BS>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* start, void* o, int S_c, int Nq,
                   int Nkv, int NB, int window_blocks, float scale,
                   cudaStream_t stream) {
  constexpr int BQ = 64;
  auto kernel = paged_chunk_kernel<D, BQ, BS>;
  const size_t smem = dllm::smem_bytes<D, BS>(BQ);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((S_c + BQ - 1) / BQ, Nq, 1);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(start), static_cast<__nv_bfloat16*>(o), S_c, Nq, Nkv,
      NB, window_blocks, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bs(int bs, const void* q, const void* k_pool, const void* v_pool,
                      const void* table, const void* start, void* o, int S_c, int Nq,
                      int Nkv, int NB, int window_blocks, float scale,
                      cudaStream_t stream) {
  switch (bs) {
    case 32:
      return launch<D, 32>(q, k_pool, v_pool, table, start, o, S_c, Nq, Nkv, NB,
                           window_blocks, scale, stream);
    case 64:
      return launch<D, 64>(q, k_pool, v_pool, table, start, o, S_c, Nq, Nkv, NB,
                           window_blocks, scale, stream);
    case 128:
      return launch<D, 128>(q, k_pool, v_pool, table, start, o, S_c, Nq, Nkv, NB,
                            window_blocks, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched).  D must be 64 or 128
// and bs 32, 64 or 128.
extern "C" int paged_chunk_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const void* table,
                                     const void* start, void* o, int S_c, int Nq,
                                     int Nkv, int NB, int bs, int D,
                                     int window_blocks, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_bs<64>(bs, q, k_pool, v_pool, table, start, o, S_c, Nq, Nkv,
                                NB, window_blocks, scale, s);
    case 128:
      return (int)launch_bs<128>(bs, q, k_pool, v_pool, table, start, o, S_c, Nq,
                                 Nkv, NB, window_blocks, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
