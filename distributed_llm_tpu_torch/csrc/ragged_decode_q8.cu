// Ragged paged decode attention for Hopper over an int8 pool: one launch
// serves every batch slot at its own length.
//
// Replaces the Pallas TPU kernel `_ragged_decode_kernel_q8` behind
// `ragged_paged_decode_attention_q8`
// (distributed_llm_tpu/ops/ragged_attention.py).  The kernel itself is
// ragged_paged.cuh's, instantiated for int8 tiles with G = 1 (q
// [B, Nq, D] is [B, 1, Nq, D]); layout, work split and numerics are
// described there.
//
// Bound on the card: decode reads every live KV byte once per step and
// does a few operations per byte, so it is bound by bytes.  What the
// design does about it: the pool is int8 plus one float32 scale per
// row, so a slot streams D + 4 bytes per position and kv head where the
// bf16 kernel streams 2 D (about half at D = 64 or 128); the tiles are
// staged as int8 and dequantized while they are read from shared
// memory, so the dequantized window is never written to device memory;
// each slot walks only its own ceil((pos + 1) / bs) blocks and each tile
// serves the G = Nq / Nkv query heads of its kv head.  Known limit: as
// the bf16 kernel, B * Nkv blocks cannot fill the 132 SMs.
#include "ragged_paged.cuh"

extern "C" int ragged_decode_attention_q8(const void* q, const void* k_pool,
                                          const void* v_pool, const void* k_scale,
                                          const void* v_scale, const void* tables,
                                          const void* pos, void* o, int B, int Nq, int Nkv,
                                          int NB, int bs, int D, int MB, float scale,
                                          void* stream) {
  const dllm::RaggedArgs a{q,
                           k_pool,
                           v_pool,
                           static_cast<const float*>(k_scale),
                           static_cast<const float*>(v_scale),
                           static_cast<const int*>(tables),
                           static_cast<const int*>(pos),
                           o,
                           B,
                           1,
                           Nq,
                           Nkv,
                           NB,
                           bs,
                           D,
                           MB,
                           MB,
                           scale};
  return dllm::ragged_paged_attention<true, 2>(a, stream);
}
