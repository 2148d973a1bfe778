// Paged decode attention for Hopper through a window-truncated block
// table: the dense windowed decode tick's attention.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel` behind
// `paged_decode_attention` (distributed_llm_tpu/ops/pallas_attention.py).
// The batched engine's dense tick (TierConfig.attention_ragged=False)
// slices each slot's table to a bucketed high-water window of wb blocks
// covering every active position and passes q [B, Nq, D] bf16, one
// layer's pools [Nkv, NB, bs, D] bf16, tables [B, wb] int32 (rows may be
// a column slice of the full [B, MB] table: read through their stride)
// and pos [B] int32 with every pos < wb * bs.  Slot b attends positions
// 0 .. pos[b]; idle slots point their row at the trash block 0.
//
// The kernel is ragged_paged.cuh's, instantiated for bf16 tiles with
// G = 1 and MB = wb: one block of 4 warps per (kv head, slot), each
// [bs, D] tile staged once in shared memory and read by the group's
// Nq / Nkv query heads, float32 online softmax, and the walk stops at the
// slot's frontier block pos / bs (the Pallas index map's clamp
// min(j, pos // bs), which never passes column wb - 1).
//
// Bound on the card: bytes (each slot streams its own ceil((pos + 1) /
// bs) blocks once; about one multiply-add per byte per query head).
// Known limit, as the ragged decode: B * Nkv blocks cannot fill the 132
// SMs and a long slot walks its window alone.
#include "ragged_paged.cuh"

extern "C" int paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                      const void* tables, const void* pos, void* o, int B,
                                      int Nq, int Nkv, int NB, int bs, int D, int wb,
                                      long long table_stride, float scale, void* stream) {
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
                           wb,
                           (long)table_stride,
                           scale};
  return dllm::ragged_paged_attention<false>(a, stream);
}
