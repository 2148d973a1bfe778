// One-token decode attention over the sequential engines' contiguous int8
// KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel `_decode_kernel_q8` behind
// `flash_decode_attention_q8` (distributed_llm_tpu/ops/pallas_attention.py).
// The kernel is contiguous.cuh's, instantiated for int8 tiles with one
// query position per sequence: q [B, Nq, D] bf16, one layer's cache
// [B, S, Nkv, D] int8 with float32 scales [B, S, Nkv] (both read in
// place; the JAX wrapper's transpose of the scales to [B, Nkv, S] was for
// TPU tiling), pos [B] int32.  Layout, work split and numerics are
// described there.
//
// Bound on the card: bytes, as the bf16 kernel.  What the design does
// about it: the cache is int8 plus one float32 scale per row, so a
// sequence streams D + 4 bytes per position and kv head for K and for V
// where the bf16 kernel streams 2 D; tiles are staged as int8 and
// dequantized while read from shared memory, so the dequantized cache
// never reaches device memory; the walk stops at each sequence's
// frontier.  Known limit: as flash_decode.cu, Nkv blocks at B = 1.
#include "contiguous.cuh"

extern "C" int flash_decode_attention_q8(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale, const void* q_pos,
                                         void* o, int B, int S_q, int Nq, int Nkv, int D, int W,
                                         long long kv_bstride, long long sc_bstride, float scale,
                                         void* stream) {
  return dllm::contiguous_entry<true, false>(q, k, v, k_scale, v_scale, q_pos, o, B, S_q, Nq,
                                             Nkv, D, W, kv_bstride, sc_bstride, scale, stream);
}
