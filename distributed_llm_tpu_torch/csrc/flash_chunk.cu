// A chunk of queries against the sequential engines' contiguous bf16 KV
// cache, for Hopper: a prefix hit's suffix, a long prompt's 2048-row
// chunk and the speculative verify's gamma + 1 rows.
//
// Replaces the Pallas TPU kernels `_chunk_kernel_native` (chunks of at
// most 256 rows) and `_chunk_kernel` (wider chunks) behind
// `flash_chunk_attention` (distributed_llm_tpu/ops/pallas_attention.py);
// one kernel serves both regimes and any chunk length, the 5-row verify
// included (the JAX dispatcher keeps chunks of a length not divisible by
// 8 on XLA for the TPU compiler's sake; the card has no such limit).  The
// kernel is contiguous.cuh's, instantiated for bf16: q [B, S_c, Nq, D],
// one layer's cache window [B, W, Nkv, D] read in place (a window of a
// longer cache keeps the cache's batch stride), q_pos [B, S_c] int32.
// Each row's position is read from q_pos, not rebuilt as start + r, so
// rows past a chunk's true length (clamped there) match the plain
// version as well.  Layout, work split and numerics are described there.
//
// Bound on the card: a chunk of S_c rows over P cached positions does
// about 4 Nq D S_c P operations on 4 Nkv D P bytes of K/V, so short
// chunks (the verify, a prefix hit's few real rows) are bound by bytes
// and the 2048-row chunk by operations.  This first design runs both
// products on the CUDA cores in float32.  What it does about it: a
// block of 64 rows (16 query positions times a group of 4 heads) stages
// each 64-position K/V tile once for all of them, so GQA reads K/V once
// per group, and stops at its last row's frontier instead of walking the
// whole window.  wgmma and TMA come with a later change; so does split-K
// for the verify, which at B = 1 is Nkv = 8 blocks on 132 SMs.
#include "contiguous.cuh"

extern "C" int flash_chunk_attention(const void* q, const void* k, const void* v,
                                     const void* k_scale, const void* v_scale, const void* q_pos,
                                     void* o, int B, int S_q, int Nq, int Nkv, int D, int W,
                                     long long kv_bstride, long long sc_bstride, float scale,
                                     void* stream) {
  // The scale pointers and their batch stride are the int8 kernel's (one
  // signature for both chunk kernels): a bf16 cache has none.
  return dllm::contiguous_entry(q, k, v, q_pos, o, B, S_q, Nq, Nkv, D, W, kv_bstride, scale,
                                stream);
}
