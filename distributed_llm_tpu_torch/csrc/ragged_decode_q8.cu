// Ragged paged decode attention for Hopper over an int8 pool: one launch
// serves every batch slot at its own length.
//
// Replaces the Pallas TPU kernel `_ragged_decode_kernel_q8` behind
// `ragged_paged_decode_attention_q8`
// (distributed_llm_tpu/ops/ragged_attention.py).  The kernels are
// ragged_verify.cuh's split pass over the pool and its merge, at G = 1
// (q [B, Nq, D] is [B, 1, Nq, D]; slot b attends positions 0 .. pos[b]):
// the int8 verify's arithmetic with one query per slot.  Layout, work
// split and numerics are described there.
//
// Bound on the card: bytes.  A step reads each slot's ceil((pos + 1) / bs)
// blocks once, int8 plus one float32 scale per row (D + 4 bytes per
// position and kv head, about half the bf16 bytes), and does Nq / Nkv = 4
// multiply-adds per element read at orin.  What the design does about it:
// - split-K over each slot's blocks (`ragged_decode_split_plan`, from
//   shapes only): T = ceil(B * Nkv * MB / 528) blocks a split, 8 at orin's
//   4 slots and 128-block tables, so a slot at the end of its context
//   streams from 16 x 8 = 128 blocks where one block per (kv head, slot)
//   was 8 (32 for the batch);
// - a ring of cp.async stages carrying the int8 tiles and their row
//   scales, widened exactly to bf16 in shared memory;
// - QK and PV on mma.sync, the group's 4 rows padded to one 16-row tile;
//   the K scale on the float32 scores and the V scale folded into P before
//   P is rounded to bf16 (the Pallas q8 kernel keeps P float32; chip_smoke
//   holds the output to the same bound as the bf16 kernels);
// - a live block's partials (2 KB at D = 128), written once and read
//   once, move 3% of the 135 KB of int8 K/V its split reads.
#include "ragged_verify.cuh"

extern "C" int ragged_decode_attention_q8(const void* q, const void* k_pool,
                                          const void* v_pool, const void* k_scale,
                                          const void* v_scale, const void* tables,
                                          const void* pos, void* o, void* part_acc,
                                          void* part_ml, int B, int Nq, int Nkv, int NB, int bs,
                                          int D, int MB, int T, int S, float scale,
                                          void* stream) {
  const dllm::verify::Args a{static_cast<const __nv_bfloat16*>(q),
                             k_pool,
                             v_pool,
                             static_cast<const float*>(k_scale),
                             static_cast<const float*>(v_scale),
                             static_cast<const int*>(tables),
                             static_cast<const int*>(pos),
                             static_cast<__nv_bfloat16*>(o),
                             static_cast<float*>(part_acc),
                             static_cast<float*>(part_ml),
                             B,
                             1,
                             Nq,
                             Nkv,
                             NB,
                             bs,
                             D,
                             MB,
                             T,
                             S,
                             scale,
                             MB};  // a full row per slot: the row stride is MB
  return dllm::verify::split_verify_attention<true>(a, stream);
}
