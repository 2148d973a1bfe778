// Ragged paged decode attention for Hopper over a bf16 pool: one launch
// serves every batch slot at its own length.
//
// Replaces the Pallas TPU kernel `_ragged_decode_kernel` behind
// `ragged_paged_decode_attention`
// (distributed_llm_tpu/ops/ragged_attention.py).  The kernels are
// ragged_verify.cuh's split pass over the pool and its merge, at G = 1
// (q [B, Nq, D] is [B, 1, Nq, D]; slot b attends positions 0 .. pos[b]
// through its full table row, TS = MB): the bf16 verify's arithmetic with
// one query per slot, as ragged_decode_q8.cu is the int8 verify's.
// Layout, work split and numerics are described there.
//
// Bound on the card: bytes.  A step reads each slot's ceil((pos + 1) / bs)
// blocks of K and V once (2 D bytes per position and kv head each) and
// does Nq / Nkv = 4 multiply-adds per element read at nano.  What the
// design does about it:
// - split-K over each slot's blocks (`ragged_decode_split_plan`, from
//   shapes only): T = ceil(B * Nkv * MB / 528) blocks a split.  At nano's
//   8 slots and 128-block tables T = 16, S = 8: the timed batch (positions
//   0 to 8191) has 22 live splits, 176 live blocks, where one block per
//   (kv head, slot) was 64 and the longest slot walked 128 blocks alone;
//   a split reads at most 16 tiles of 16 KB.  The nano draft's 4 slots in
//   orin's speculative path get T = 8, S = 16;
// - a ring of cp.async stages keeps the next tiles' bytes in flight while
//   the current tile is scored;
// - QK and PV on mma.sync, the group's 4 rows padded to one 16-row tile;
//   P rounded to bf16 before PV, as the Pallas kernel casts it;
// - a live block's partials (1 KB at D = 64), written once and read once,
//   are small beside the up to 256 KB of K/V its split reads.
#include "ragged_verify.cuh"

extern "C" int ragged_decode_attention(const void* q, const void* k_pool,
                                       const void* v_pool, const void* tables,
                                       const void* pos, void* o, void* part_acc,
                                       void* part_ml, int B, int Nq, int Nkv, int NB, int bs,
                                       int D, int MB, int T, int S, float scale,
                                       void* stream) {
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
                             MB,
                             T,
                             S,
                             scale,
                             MB};  // a full row per slot: the row stride is MB
  return dllm::verify::split_verify_attention<false>(a, stream);
}
