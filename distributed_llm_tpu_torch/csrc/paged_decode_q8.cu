// Paged decode attention for Hopper over an int8 pool through a
// window-truncated block table: the dense windowed tick of an int8 tier.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel_q8` behind
// `paged_decode_attention_q8`
// (distributed_llm_tpu/ops/pallas_attention.py).  Inputs as
// paged_decode.cu, with int8 pools [Nkv, NB, bs, D] and float32 per-row
// scales [Nkv, NB, bs].
//
// The kernel is ragged_paged.cuh's, instantiated for int8 tiles with
// G = 1 and MB = wb: each [bs, D] int8 tile is staged in shared memory
// with its row scales and dequantized while it is read (float(int8) *
// scale), the probabilities stay float32 for PV, and the dequantized
// window never reaches device memory.  The walk stops at each slot's
// frontier block.
//
// Bound on the card: bytes.  A slot streams D + 4 bytes per position and
// kv head where the bf16 kernel streams 2 D (about half).  Known limit:
// as the bf16 kernel, B * Nkv blocks cannot fill the 132 SMs.
#include "ragged_paged.cuh"

extern "C" int paged_decode_attention_q8(const void* q, const void* k_pool, const void* v_pool,
                                         const void* k_scale, const void* v_scale,
                                         const void* tables, const void* pos, void* o, int B,
                                         int Nq, int Nkv, int NB, int bs, int D, int wb,
                                         long long table_stride, float scale, void* stream) {
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
                           wb,
                           (long)table_stride,
                           scale};
  return dllm::ragged_paged_attention<true, 2>(a, stream);
}
