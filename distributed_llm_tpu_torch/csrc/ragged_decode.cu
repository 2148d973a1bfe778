// Ragged paged decode attention for Hopper: one launch serves every
// batch slot at its own length.
//
// Replaces the Pallas TPU kernel `_ragged_decode_kernel` behind
// `ragged_paged_decode_attention`
// (distributed_llm_tpu/ops/ragged_attention.py).  q [B, Nq, D] bf16 is
// one new token per slot; the pool is one layer [Nkv, NB, bs, D] bf16;
// tables [B, MB] int32 hold each slot's FULL block row and pos [B] int32
// its TRUE position, both read on the device.  Slot b's query attends
// positions 0 .. pos[b], position p living at (tables[b, p / bs], p % bs).
// Idle slots point their whole row at the trash block 0 with pos 0.
//
// Bound on the card: decode reads every live KV byte once per step and
// does about one multiply-add per byte per query head of the group, so
// it is bound by bytes (device memory bandwidth).  What the design does
// about it: each slot streams only its own ceil((pos + 1) / bs) blocks
// (the Pallas frontier clamp), each K/V tile is staged in shared memory
// once and read by all G = Nq / Nkv query heads of its kv head (one
// block per (kv head, slot)), and loads are 16 bytes wide.  Known limit:
// B * Nkv blocks (64 at the nano tier's 8 slots x 8 kv heads) cannot fill
// the 132 SMs, and a long slot's block walks its table alone; splitting
// the table walk across blocks (split-K) comes with a later change.
#include "attn_common.cuh"

namespace {

using dllm::kThreads;
using dllm::kWarps;

// Query rows per warp: G <= kWarps * kRowsPerWarp = 8.
constexpr int kRowsPerWarp = 2;

template <int D, int BS>
__global__ void __launch_bounds__(dllm::kThreads)
ragged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k_pool,
                     const __nv_bfloat16* __restrict__ v_pool,
                     const int* __restrict__ tables, const int* __restrict__ pos,
                     __nv_bfloat16* __restrict__ o, int Nq, int Nkv, int NB, int MB,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = Nq / Nkv;
  float* q_s = reinterpret_cast<float*>(smem_raw);
  uint32_t* k_s = reinterpret_cast<uint32_t*>(q_s + kWarps * kRowsPerWarp * D);
  uint32_t* v_s = k_s + BS * dllm::Tile<D>::kWords;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p = pos[b];
  const int* row_table = tables + (long)b * MB;

  // Query head of group row g: hk * G + g (GQA groups are contiguous).
  const __nv_bfloat16* q_b = q + ((long)b * Nq + (long)hk * G) * D;
  const long head_off = (long)hk * NB * BS * D;

  dllm::RowState<D> st[kRowsPerWarp];
#pragma unroll
  for (int ri = 0; ri < kRowsPerWarp; ++ri) {
    st[ri].init();
    const int g = warp + ri * kWarps;
    if (g < G) dllm::load_query_row<D>(q_s + g * D, q_b + (long)g * D, scale, lane);
  }

  const int n_tiles = min(MB, p / BS + 1);
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();
    const long blk_off = head_off + (long)row_table[j] * BS * D;
    dllm::load_tile<D, BS>(k_s, k_pool + blk_off, D, BS);
    dllm::load_tile<D, BS>(v_s, v_pool + blk_off, D, BS);
    __syncthreads();
#pragma unroll
    for (int ri = 0; ri < kRowsPerWarp; ++ri) {
      const int g = warp + ri * kWarps;
      if (g < G) dllm::attend_tile<D, BS>(q_s + g * D, k_s, v_s, j * BS, p, lane, st[ri]);
    }
  }

#pragma unroll
  for (int ri = 0; ri < kRowsPerWarp; ++ri) {
    const int g = warp + ri * kWarps;
    if (g < G) dllm::store_row<D>(o + ((long)b * Nq + (long)hk * G + g) * D, st[ri], lane);
  }
}

template <int D, int BS>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* pos, void* o, int B, int Nq,
                   int Nkv, int NB, int MB, float scale, cudaStream_t stream) {
  auto kernel = ragged_decode_kernel<D, BS>;
  const size_t smem = dllm::smem_bytes<D, BS>(kWarps * kRowsPerWarp);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(Nkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(o), Nq, Nkv, NB, MB,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bs(int bs, const void* q, const void* k_pool, const void* v_pool,
                      const void* tables, const void* pos, void* o, int B, int Nq,
                      int Nkv, int NB, int MB, float scale, cudaStream_t stream) {
  switch (bs) {
    case 32:
      return launch<D, 32>(q, k_pool, v_pool, tables, pos, o, B, Nq, Nkv, NB, MB,
                           scale, stream);
    case 64:
      return launch<D, 64>(q, k_pool, v_pool, tables, pos, o, B, Nq, Nkv, NB, MB,
                           scale, stream);
    case 128:
      return launch<D, 128>(q, k_pool, v_pool, tables, pos, o, B, Nq, Nkv, NB, MB,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched).  D must be 64 or 128,
// bs 32, 64 or 128, and Nq / Nkv at most 8.
extern "C" int ragged_decode_attention(const void* q, const void* k_pool,
                                       const void* v_pool, const void* tables,
                                       const void* pos, void* o, int B, int Nq,
                                       int Nkv, int NB, int bs, int D, int MB,
                                       float scale, void* stream) {
  if (Nq / Nkv > kWarps * kRowsPerWarp) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_bs<64>(bs, q, k_pool, v_pool, tables, pos, o, B, Nq, Nkv, NB,
                                MB, scale, s);
    case 128:
      return (int)launch_bs<128>(bs, q, k_pool, v_pool, tables, pos, o, B, Nq, Nkv,
                                 NB, MB, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
