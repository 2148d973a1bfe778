// One-token decode attention over the sequential engines' contiguous bf16
// KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel `_decode_kernel` behind
// `flash_decode_attention` (distributed_llm_tpu/ops/pallas_attention.py).
// q [B, Nq, D], one layer's cache [B, S, Nkv, D] (the first W positions of
// each row are read in place through the cache's batch stride), pos [B]
// int32 read on the device; row h attends kv head h / (Nq / Nkv) at cache
// positions 0 .. min(pos[b], W - 1).  The kernels are ragged_verify.cuh's
// split pass, reading contiguous 64-position tiles (its `Contig` tile
// source) at G = 1, and its per-row merge; layout, work split and
// numerics are described there.
//
// Bound on the card: bytes.  A step reads each sequence's ceil((pos + 1) /
// 64) tiles of K and V once and does Nq / Nkv = 4 multiply-adds per
// element read at orin, far below the ~295 operations per byte the tensor
// cores could take.  What the design does about it:
// - split-K over the window (`decode_split_plan`, from shapes only): T =
//   ceil(B * Nkv * ceil(W / 64) / 528) tiles a split, T = 2 and S = 64
//   splits at orin's B = 1 and 8192-position window, so a sequence at 2255
//   streams from 144 blocks where one block per (kv head, sequence) was 8;
// - a ring of cp.async stages, 16 bytes a thread: both tiles of an orin
//   split are in flight before the first is scored;
// - QK and PV on mma.sync, the group's 4 rows padded to one 16-row tile,
//   in place of a D-deep fmaf chain per key;
// - the merge reads only the splits the frontier reaches, and the
//   partials (2 KB a live block at D = 128, written once and read once)
//   are 6% of the K/V bytes.
#include "ragged_verify.cuh"

extern "C" int flash_decode_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale, const void* q_pos,
                                      void* o, void* part_acc, void* part_ml, int B, int S_q,
                                      int Nq, int Nkv, int D, int W, int T, int S,
                                      long long kv_bstride, long long sc_bstride, float scale,
                                      void* stream) {
  return dllm::verify::split_window_attention<false>(q, k, v, k_scale, v_scale, q_pos, o,
                                                     part_acc, part_ml, B, S_q, Nq, Nkv, D, W,
                                                     T, S, kv_bstride, sc_bstride, scale, stream);
}
