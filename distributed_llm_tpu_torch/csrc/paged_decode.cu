// Paged decode attention for Hopper through a window-truncated block
// table: the dense windowed decode tick's attention over a bf16 pool.
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
// The kernel is ragged_paged.cuh's: one block of 4 warps per (kv head,
// slot), each [bs, D] tile staged once in shared memory and read by the
// group's Nq / Nkv query heads, float32 online softmax, and the walk stops
// at the slot's frontier block pos / bs (the Pallas index map's clamp
// min(j, pos // bs), which never passes column wb - 1).
//
// Bound on the card: bytes (each slot streams its own ceil((pos + 1) /
// bs) blocks once; about one multiply-add per byte per query head).
// Known limit: B * Nkv blocks (64 at nano's 8 slots) cannot fill the 132
// SMs, a long slot walks its window alone, tiles load synchronously and
// the products run on the CUDA cores.  The int8 twin (paged_decode_q8.cu)
// and the ragged decode kernels run ragged_verify.cuh's split-K kernel
// instead; this kernel is next to follow them.
#include "ragged_paged.cuh"

extern "C" int paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                      const void* tables, const void* pos, void* o, int B,
                                      int Nq, int Nkv, int NB, int bs, int D, int wb,
                                      long long table_stride, float scale, void* stream) {
  const dllm::PagedArgs a{q,
                          k_pool,
                          v_pool,
                          static_cast<const int*>(tables),
                          static_cast<const int*>(pos),
                          o,
                          B,
                          Nq,
                          Nkv,
                          NB,
                          bs,
                          D,
                          wb,
                          (long)table_stride,
                          scale};
  return dllm::paged_decode_attention_bf16(a, stream);
}
