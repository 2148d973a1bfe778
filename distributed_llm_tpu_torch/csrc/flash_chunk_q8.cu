// A chunk of queries against the sequential engines' contiguous int8 KV
// cache, for Hopper: the int8 tier's prefix-hit suffixes and long-prompt
// chunks.
//
// Replaces the Pallas TPU kernels `_chunk_kernel_native_q8` and
// `_chunk_kernel_q8` behind `flash_chunk_attention_q8`
// (distributed_llm_tpu/ops/pallas_attention.py); one kernel serves both
// regimes and any chunk length.  The kernel is contiguous.cuh's,
// instantiated for int8 tiles: q [B, S_c, Nq, D] bf16, one layer's cache
// window [B, W, Nkv, D] int8 with float32 scales [B, W, Nkv], both read
// in place, q_pos [B, S_c] int32 read row by row (as flash_chunk.cu).
// Layout, work split and numerics are described there.
//
// Bound on the card: as flash_chunk.cu, bytes for short chunks and
// operations for the 2048-row chunk, on CUDA-core float32 products.
// What the design does about it: K/V tiles are staged as int8 with
// their row scales (D + 4 bytes per position and kv head, against 2 D
// for bf16) and dequantized while read from shared memory, so the
// dequantized window never reaches device memory; each staged tile
// serves the block's 64 rows; the walk stops at the block's last
// frontier.
#include "contiguous.cuh"

extern "C" int flash_chunk_attention_q8(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale, const void* q_pos,
                                        void* o, int B, int S_q, int Nq, int Nkv, int D, int W,
                                        long long kv_bstride, long long sc_bstride, float scale,
                                        void* stream) {
  return dllm::contiguous_entry<true>(q, k, v, k_scale, v_scale, q_pos, o, B, S_q, Nq,
                                      Nkv, D, W, kv_bstride, sc_bstride, scale, stream);
}
