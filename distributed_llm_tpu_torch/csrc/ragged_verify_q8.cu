// Ragged paged speculative-verify attention for Hopper over an int8 pool.
//
// Replaces the Pallas TPU kernel `_ragged_verify_kernel_q8` behind
// `ragged_paged_verify_attention_q8`
// (distributed_llm_tpu/ops/ragged_attention.py).  The kernel itself is
// ragged_paged.cuh's, instantiated for int8 tiles (layout, work split and
// numerics are described there).
//
// Bound on the card: bytes, as the bf16 verify (ragged_verify.cu): each
// slot's ceil((pos + G) / bs) live blocks are read once.  What the design
// does about it: the blocks are int8 plus one float32 scale per row
// (about half the bf16 bytes), dequantized while they are read from
// shared memory and never written back dequantized; each staged tile
// serves all group * G rows of its kv head.  Known limit: B * Nkv blocks
// leave most SMs idle (split-K comes later).
#include "ragged_paged.cuh"

extern "C" int ragged_verify_attention_q8(const void* q, const void* k_pool,
                                          const void* v_pool, const void* k_scale,
                                          const void* v_scale, const void* tables,
                                          const void* pos, void* o, int B, int G, int Nq,
                                          int Nkv, int NB, int bs, int D, int MB,
                                          float scale, void* stream) {
  const dllm::RaggedArgs a{q,
                           k_pool,
                           v_pool,
                           static_cast<const float*>(k_scale),
                           static_cast<const float*>(v_scale),
                           static_cast<const int*>(tables),
                           static_cast<const int*>(pos),
                           o,
                           B,
                           G,
                           Nq,
                           Nkv,
                           NB,
                           bs,
                           D,
                           MB,
                           scale};
  return dllm::ragged_paged_attention<true, 10>(a, stream);
}
