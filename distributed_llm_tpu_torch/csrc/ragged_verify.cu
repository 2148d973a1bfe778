// Ragged paged speculative-verify attention for Hopper over a bf16 pool:
// one call verifies every slot's G = gamma + 1 chunk at its own length.
//
// Replaces the Pallas TPU kernel `_ragged_verify_kernel` behind
// `ragged_paged_verify_attention`
// (distributed_llm_tpu/ops/ragged_attention.py).  The kernels are
// ragged_verify.cuh's, instantiated for bf16 tiles: a split-K pass over
// each slot's tiles and a merge pass (layout, work split and numerics are
// described there).
//
// Bound on the card: bytes.  A verify reads each slot's
// ceil((pos + G) / bs) live blocks once and does about group * G = 20
// multiply-adds per element at orin's verify, far below what the tensor
// cores could take per byte.  What the design does about it: the split
// spreads a long slot's tiles over many blocks (192 live blocks at orin's
// timed verify, against 32 with one block per (kv head, slot)), so every
// SM streams; a ring of cp.async stages keeps the next tiles' bytes in
// flight while mma.sync runs QK and PV for all group * G rows of the kv
// head on the tensor cores, each staged tile read once for all of them.
// The merge reads only the splits each slot's frontier reaches; the
// partials it reads are about 8% of the K/V bytes at orin's shape.
#include "ragged_verify.cuh"

extern "C" int ragged_verify_attention(const void* q, const void* k_pool,
                                       const void* v_pool, const void* tables,
                                       const void* pos, void* o, void* part_acc,
                                       void* part_ml, int B, int G, int Nq, int Nkv,
                                       int NB, int bs, int D, int MB, int T, int S,
                                       float scale, void* stream) {
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
                             G,
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
