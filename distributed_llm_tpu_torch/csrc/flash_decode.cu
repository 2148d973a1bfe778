// One-token decode attention over the sequential engines' contiguous bf16
// KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel `_decode_kernel` behind
// `flash_decode_attention` (distributed_llm_tpu/ops/pallas_attention.py).
// The kernel is contiguous.cuh's, instantiated for bf16 with one query
// position per sequence: q [B, Nq, D], one layer's cache [B, S, Nkv, D]
// (the first W positions of each row are read in place), pos [B] int32
// read on the device; row h attends kv head h / (Nq / Nkv) at cache
// positions 0 .. pos[b].  Layout, work split and numerics are described
// there.
//
// Bound on the card: a step reads every live K/V byte once and does 4 D
// operations per 4 D bytes of K/V and query head group, so it is bound
// by bytes.  What the design does about it: each sequence streams only
// its own ceil((pos + 1) / 64) tiles (the Pallas kernel's clamped index
// map), each staged tile serves the Nq / Nkv query heads of its kv head,
// and the cache is read in its serving layout with no transpose or copy.
// Known limit: one block per (sequence, kv head) at B = 1, as the
// sequential engines run, is Nkv = 8 blocks on 132 SMs, each walking its
// sequence's whole frontier alone; split-K over the cache is the next
// step.
#include "contiguous.cuh"

extern "C" int flash_decode_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale, const void* q_pos,
                                      void* o, int B, int S_q, int Nq, int Nkv, int D, int W,
                                      long long kv_bstride, long long sc_bstride, float scale,
                                      void* stream) {
  return dllm::contiguous_entry<false, false>(q, k, v, k_scale, v_scale, q_pos, o, B, S_q, Nq,
                                              Nkv, D, W, kv_bstride, sc_bstride, scale, stream);
}
