// Blocked causal prefill attention (flash) for Hopper.
//
// Replaces the Pallas TPU kernel `_flash_kernel` behind
// `flash_causal_attention` (distributed_llm_tpu/ops/pallas_attention.py).
// q [B, S, Nq, D], k/v [B, S, Nkv, D] bf16 -> o [B, S, Nq, D] bf16, row r
// attends keys 0..r; query head h reads kv head h / (Nq / Nkv).
//
// Bound on the card: the work is about 0.4 S bf16 operations per byte
// moved (Nq = 4 Nkv), so below S of about 700 the bound is bytes and
// above it operations; either bound is under 0.01 ms at the serving
// buckets (S = 64..2048).  This first design runs the products on the
// CUDA cores in float32 (no tensor cores), far above that bound; what
// it does about the bound is the flash structure itself: one block per
// (64-row q tile, q head, batch), K/V streamed through shared memory in
// 64-key tiles up to the diagonal only (tiles past a row's diagonal are
// skipped, as the Pallas kernel skips them), so the [S, S] scores never
// reach device memory and K/V are read once per q tile.  wgmma and TMA
// come with a later change.
#include "attn_common.cuh"

namespace {

using dllm::kThreads;
using dllm::kWarps;

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(dllm::kThreads)
flash_causal_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int S, int Nq, int Nkv,
                    float scale) {
  constexpr int kRowsPerWarp = BQ / kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  uint32_t* k_s = reinterpret_cast<uint32_t*>(q_s + BQ * D);
  uint32_t* v_s = k_s + BK * dllm::Tile<D>::kWords;

  const int r0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Nq / Nkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const long q_row_stride = (long)Nq * D;
  const long kv_row_stride = (long)Nkv * D;
  const __nv_bfloat16* q_b = q + (long)b * S * q_row_stride + (long)h * D;
  const __nv_bfloat16* k_b = k + (long)b * S * kv_row_stride + (long)hk * D;
  const __nv_bfloat16* v_b = v + (long)b * S * kv_row_stride + (long)hk * D;

  dllm::RowState<D> st[kRowsPerWarp];
#pragma unroll
  for (int ri = 0; ri < kRowsPerWarp; ++ri) {
    st[ri].init();
    const int i = warp + ri * kWarps;
    const int row = r0 + i;
    if (row < S) dllm::load_query_row<D>(q_s + i * D, q_b + row * q_row_stride, scale, lane);
  }

  const int last_row = min(r0 + BQ, S) - 1;
  const int n_tiles = last_row / BK + 1;
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // the previous tile (and the query rows) are ready
    const int col0 = j * BK;
    dllm::load_tile<D, BK>(k_s, k_b + col0 * kv_row_stride, kv_row_stride, S - col0);
    dllm::load_tile<D, BK>(v_s, v_b + col0 * kv_row_stride, kv_row_stride, S - col0);
    __syncthreads();
#pragma unroll
    for (int ri = 0; ri < kRowsPerWarp; ++ri) {
      const int i = warp + ri * kWarps;
      const int row = r0 + i;
      if (row < S && col0 <= row) {
        dllm::attend_tile<D, BK>(q_s + i * D, k_s, v_s, col0, row, lane, st[ri]);
      }
    }
  }

#pragma unroll
  for (int ri = 0; ri < kRowsPerWarp; ++ri) {
    const int row = r0 + warp + ri * kWarps;
    if (row < S) {
      dllm::store_row<D>(o + ((long)b * S + row) * q_row_stride + (long)h * D, st[ri], lane);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int Nq, int Nkv, float scale, cudaStream_t stream) {
  constexpr int BQ = 64;
  constexpr int BK = 64;
  auto kernel = flash_causal_kernel<D, BQ, BK>;
  const size_t smem = dllm::smem_bytes<D, BK>(BQ);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((S + BQ - 1) / BQ, Nq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, Nq,
      Nkv, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched).  D must be 64 or 128.
extern "C" int flash_causal_attention(const void* q, const void* k, const void* v,
                                      void* o, int B, int S, int Nq, int Nkv,
                                      int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64>(q, k, v, o, B, S, Nq, Nkv, scale, s);
    case 128:
      return (int)launch<128>(q, k, v, o, B, S, Nq, Nkv, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
