// Ragged paged speculative-verify attention for Hopper over a bf16 pool:
// one launch verifies every slot's G = gamma + 1 chunk at its own length.
//
// Replaces the Pallas TPU kernel `_ragged_verify_kernel` behind
// `ragged_paged_verify_attention`
// (distributed_llm_tpu/ops/ragged_attention.py).  The kernel itself is
// ragged_paged.cuh's, instantiated for bf16 tiles (layout, work split and
// numerics are described there).
//
// Bound on the card: a verify reads each slot's ceil((pos + G) / bs)
// live blocks once and does about G multiply-adds per byte per query
// head of the group, so at the orin tier's verify (G <= 5, group 4, bs
// 64) it is bound by bytes.  What the design does about it: the walk
// stops at the slot's last query's block, and each staged [bs, D] tile
// serves all group * G rows of its kv head (20 at orin's G = 5, against
// the decode kernel's 4), so the verify costs one KV read per slot, not
// G.  The Pallas wrapper's head-major transpose of q (a copy here) is
// replaced by indexing the [B, G, Nq, D] layout in the kernel.  Known
// limit: B * Nkv blocks (32 at orin's 4 slots x 8 kv heads) leave most
// of the 132 SMs idle, and a long slot's block walks its table alone;
// split-K comes with a later change.
#include "ragged_paged.cuh"

extern "C" int ragged_verify_attention(const void* q, const void* k_pool,
                                       const void* v_pool, const void* tables,
                                       const void* pos, void* o, int B, int G, int Nq,
                                       int Nkv, int NB, int bs, int D, int MB, float scale,
                                       void* stream) {
  const dllm::RaggedArgs a{q,
                           k_pool,
                           v_pool,
                           nullptr,
                           nullptr,
                           static_cast<const int*>(tables),
                           static_cast<const int*>(pos),
                           o,
                           B,
                           G,
                           Nq,
                           Nkv,
                           NB,
                           bs,
                           D,
                           MB,
                           MB,
                           scale};
  return dllm::ragged_paged_attention<false, 10>(a, stream);
}
