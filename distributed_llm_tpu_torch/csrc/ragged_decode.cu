// Ragged paged decode attention for Hopper: one launch serves every
// batch slot at its own length.
//
// Replaces the Pallas TPU kernel `_ragged_decode_kernel` behind
// `ragged_paged_decode_attention`
// (distributed_llm_tpu/ops/ragged_attention.py).  The kernel itself is
// ragged_paged.cuh's, instantiated for bf16 tiles with G = 1 (q
// [B, Nq, D] is [B, 1, Nq, D]: one new token per slot); layout, work
// split and numerics are described there.
//
// Bound on the card: decode reads every live KV byte once per step and
// does about one multiply-add per byte per query head of the group, so
// it is bound by bytes (device memory bandwidth).  What the design does
// about it: each slot streams only its own ceil((pos + 1) / bs) blocks
// (the Pallas frontier clamp), each K/V tile is staged in shared memory
// once and read by all Nq / Nkv query heads of its kv head (one block
// per (kv head, slot)), and loads are 16 bytes wide.  Known limit:
// B * Nkv blocks (64 at the nano tier's 8 slots x 8 kv heads) cannot fill
// the 132 SMs, and a long slot's block walks its table alone; splitting
// the table walk across blocks (split-K) comes with a later change.
#include "ragged_paged.cuh"

extern "C" int ragged_decode_attention(const void* q, const void* k_pool,
                                       const void* v_pool, const void* tables,
                                       const void* pos, void* o, int B, int Nq,
                                       int Nkv, int NB, int bs, int D, int MB,
                                       float scale, void* stream) {
  const dllm::RaggedArgs a{q,
                           k_pool,
                           v_pool,
                           nullptr,
                           nullptr,
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
  return dllm::ragged_paged_attention<false, 2>(a, stream);
}
