// Blocked causal prefill attention (flash) for Hopper: every cold prefill
// of every tier.
//
// Replaces the Pallas TPU kernel `_flash_kernel` behind
// `flash_causal_attention` (distributed_llm_tpu/ops/pallas_attention.py).
// q [B, S, Nq, D], k/v [B, S, Nkv, D] bf16 -> o [B, S, Nq, D] bf16, row r
// attends keys 0..r; query head h reads kv head h / (Nq / Nkv); any S.
//
// The kernel is flash_tc.cuh's, instantiated for bf16 tiles read from the
// fresh k/v (W = S, row stride Nkv * D) with implicit positions (row i at
// position i: no position array).  Layout, work split and numerics are
// described there.
//
// Bound on the card: the work is about 0.4 S bf16 operations per byte
// moved (Nq = 4 Nkv), so below S of about 700 the bound is bytes and above
// it operations; either bound is under 0.01 ms at the serving buckets
// (S = 64..2048).  What the design does about it: a block owns one kv head
// and 64 rows (16 positions times nano's group of 4), so each K/V tile is
// staged once per group, not once per query head; QK and PV run on the
// tensor cores with P kept in registers; the next tile's copy is in flight
// while one is scored; only a slab's diagonal tile is masked and tiles past
// a block's last row are never loaded.
#include "flash_tc.cuh"

// Returns the launch's cudaError_t (0 = launched).  D must be 64 or 128,
// Nq a multiple of Nkv with at most 64 query heads per kv head.
extern "C" int flash_causal_attention(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int Nq, int Nkv, int D, float scale,
                                      void* stream) {
  dllm::tc::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k;
  a.v = v;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.S_q = S;
  a.Nq = Nq;
  a.Nkv = Nkv;
  a.W = S;
  a.kv_bstride = (long long)S * Nkv * D;
  a.scale = scale;
  return dllm::tc::flash_tc_attention<false, dllm::tc::kFresh>(a, B, D, stream);
}
