// Paged decode attention for Hopper over an int8 pool through a
// window-truncated block table: the dense windowed tick of an int8 tier.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel_q8` behind
// `paged_decode_attention_q8`
// (distributed_llm_tpu/ops/pallas_attention.py).  The batched engine's
// dense tick (TierConfig.attention_ragged=False) slices each slot's table
// to a bucketed high-water window of wb blocks covering every active
// position and passes q [B, Nq, D] bf16, one layer's int8 pools
// [Nkv, NB, bs, D] with float32 row scales [Nkv, NB, bs], tables [B, wb]
// int32 and pos [B] int32 with every pos < wb * bs.  The table is a column
// slice of the full [B, MB] table, read in place through its row stride
// (table_stride = MB, not wb).  Slot b attends positions 0 .. pos[b]; idle
// slots point their row at the trash block 0.
//
// The kernels are ragged_verify.cuh's split pass over the pool and its
// merge, as ragged_decode_q8.cu runs them, at G = 1 with MB = wb and
// TS = table_stride: the frontier clamp min(wb, pos / bs + 1) is the
// Pallas index map's min(j, pos // bs).  Layout, work split and numerics
// are described there.
//
// Bound on the card: bytes.  A slot streams D + 4 bytes per position and
// kv head for K and for V (about half the bf16 bytes), and does
// Nq / Nkv = 4 multiply-adds per element read at orin.  What the design
// does about it:
// - split-K over each slot's window (`ragged_decode_split_plan(wb, B,
//   Nkv)`, from shapes only): at orin's 4 slots in a 2048 window (wb = 32)
//   T = 2 blocks a split and S = 16, so the timed positions 0, 100, 700
//   and 1900 are 1 + 1 + 6 + 15 = 23 live splits, 184 live blocks, where
//   one block per (kv head, slot) was 32; each live block reads about
//   34 KB of int8 K/V and scales.  At the rungs wb = 64 and 128, T = 4 and
//   8, still 16 splits a row;
// - a ring of cp.async stages carrying the int8 tiles and their row
//   scales, widened exactly to bf16 in shared memory;
// - QK and PV on mma.sync, the group's 4 rows padded to one 16-row tile;
//   the K scale on the float32 scores and the V scale folded into P before
//   P is rounded to bf16 (the Pallas q8 kernel keeps P float32; chip_smoke
//   holds the output to the same bound as the bf16 kernels).
#include "ragged_verify.cuh"

extern "C" int paged_decode_attention_q8(const void* q, const void* k_pool, const void* v_pool,
                                         const void* k_scale, const void* v_scale,
                                         const void* tables, const void* pos, void* o,
                                         void* part_acc, void* part_ml, int B, int Nq, int Nkv,
                                         int NB, int bs, int D, int wb, int T, int S,
                                         long long table_stride, float scale, void* stream) {
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
                             wb,
                             T,
                             S,
                             scale,
                             table_stride};
  return dllm::verify::split_verify_attention<true>(a, stream);
}
