// Paged decode attention for Hopper over a bf16 pool through a
// window-truncated block table: the dense windowed decode tick.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel` behind
// `paged_decode_attention` (distributed_llm_tpu/ops/pallas_attention.py).
// The batched engine's dense tick (TierConfig.attention_ragged=False)
// slices each slot's table to a bucketed high-water window of wb blocks
// covering every active position and passes q [B, Nq, D] bf16, one
// layer's pools [Nkv, NB, bs, D] bf16, tables [B, wb] int32 and pos [B]
// int32 with every pos < wb * bs.  The table is a column slice of the full
// [B, MB] table, read in place through its row stride (table_stride = MB,
// not wb).  Slot b attends positions 0 .. pos[b]; idle slots point their
// row at the trash block 0.
//
// The kernels are ragged_verify.cuh's split pass over the pool and its
// merge, as paged_decode_q8.cu runs them over an int8 pool, at G = 1 with
// MB = wb and TS = table_stride: the frontier clamp min(wb, pos / bs + 1)
// is the Pallas index map's min(j, pos // bs).  Layout, work split and
// numerics are described there.
//
// Bound on the card: bytes.  A slot streams 2 D bytes per position and kv
// head for K and for V, and does Nq / Nkv = 4 multiply-adds per element
// read at nano.  What the design does about it:
// - split-K over each slot's window (`ragged_decode_split_plan(wb, B,
//   Nkv)`, from shapes only): at nano's 8 slots in a 2048 window (wb = 32)
//   T = 4 blocks a split and S = 8, so the timed positions 0, 40, 200,
//   700, 1500, 1900, 1100 and 2047 are 33 live splits, 264 live blocks,
//   where one block per (kv head, slot) was 64 and the longest slot walked
//   32 blocks alone; a live block reads at most 64 KB of K/V.  In the whole
//   table (wb = MB = 128) the plan is the ragged decode's, T = 16, S = 8;
// - a ring of cp.async stages keeps the next tiles' bytes in flight while
//   the current tile is scored;
// - QK and PV on mma.sync, the group's 4 rows padded to one 16-row tile;
//   P rounded to bf16 before PV, as the Pallas kernel casts it.
#include "ragged_verify.cuh"

extern "C" int paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                      const void* tables, const void* pos, void* o,
                                      void* part_acc, void* part_ml, int B, int Nq, int Nkv,
                                      int NB, int bs, int D, int wb, int T, int S,
                                      long long table_stride, float scale, void* stream) {
  const dllm::verify::Args a{static_cast<const __nv_bfloat16*>(q),
                             k_pool,
                             v_pool,
                             nullptr,
                             nullptr,
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
                             wb,
                             T,
                             S,
                             scale,
                             table_stride};
  return dllm::verify::split_verify_attention<false>(a, stream);
}
