// Ragged paged speculative-verify attention for Hopper over an int8 pool.
//
// Replaces the Pallas TPU kernel `_ragged_verify_kernel_q8` behind
// `ragged_paged_verify_attention_q8`
// (distributed_llm_tpu/ops/ragged_attention.py).  The kernels are
// ragged_verify.cuh's, instantiated for int8 tiles: a split-K pass over
// each slot's tiles and a merge pass (layout, work split and numerics are
// described there).
//
// Bound on the card: bytes, as the bf16 verify (ragged_verify.cu): each
// slot's ceil((pos + G) / bs) live blocks are read once, int8 plus one
// float32 scale per row (about half the bf16 bytes).  What the design
// does about it: the same split over many blocks and the same cp.async
// ring, which stages the int8 tiles and their row scales; each landed tile
// is widened to bf16 in shared memory (exact for -127..127) for the
// mma.sync products, the K scale applied to the float32 scores and the V
// scale folded into P before P is rounded to bf16 (the Pallas q8 kernel
// keeps P float32; chip_smoke holds the output to the same bound as the
// bf16 kernel).  The dequantized window never reaches device memory; the
// partials are about 15% of the int8 K/V bytes at orin's shape.
#include "ragged_verify.cuh"

extern "C" int ragged_verify_attention_q8(const void* q, const void* k_pool,
                                          const void* v_pool, const void* k_scale,
                                          const void* v_scale, const void* tables,
                                          const void* pos, void* o, void* part_acc,
                                          void* part_ml, int B, int G, int Nq, int Nkv,
                                          int NB, int bs, int D, int MB, int T, int S,
                                          float scale, void* stream) {
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
  return dllm::verify::split_verify_attention<true>(a, stream);
}
