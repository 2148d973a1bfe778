// A chunk of queries against the sequential engines' contiguous int8 KV
// cache, for Hopper: the int8 tier's prefix-hit suffixes, long-prompt
// chunks and the speculative verify's gamma + 1 rows.
//
// Replaces the Pallas TPU kernels `_chunk_kernel_native_q8` and
// `_chunk_kernel_q8` behind `flash_chunk_attention_q8`
// (distributed_llm_tpu/ops/pallas_attention.py); one kernel serves both
// regimes and any chunk length.  The kernel is flash_tc.cuh's,
// instantiated for int8 tiles: q [B, S_c, Nq, D] bf16, one layer's cache
// window [B, W, Nkv, D] int8 with float32 scales [B, W, Nkv], both read in
// place through their batch strides (a window of a longer cache is never
// copied), q_pos [B, S_c] int32 read row by row.  Layout, work split and
// numerics are described there.
//
// Bound on the card: a chunk of S_c rows over P cached positions does
// about 4 Nq D S_c P operations on 2 Nkv (D + 4) P bytes of K/V, so short
// chunks are bound by bytes and the 2048-row chunk by operations.  What
// the design does about it: int8 tiles travel with their row scales by
// cp.async (D + 4 bytes per position and kv head, against 2 D for bf16),
// are widened exactly to bf16 in shared memory and scored on the tensor
// cores, each staged tile serving the block's 64 rows (the group's heads
// packed); the walk stops at the block's last frontier.
#include "flash_tc.cuh"

// Returns the launch's cudaError_t (0 = launched).  D must be 64 or 128,
// Nq a multiple of Nkv with a group of at most 64, B, S_q and W >= 1.  The
// signature is the contiguous-cache kernels' one; this kernel has only the
// tensor-core route, so T must be 0 and the scratch pointers and S are not
// read.
extern "C" int flash_chunk_attention_q8(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale, const void* q_pos,
                                        void* o, void* part_acc, void* part_ml, int B, int S_q,
                                        int Nq, int Nkv, int D, int W, int T, int S,
                                        long long kv_bstride, long long sc_bstride, float scale,
                                        void* stream) {
  if (T != 0) return (int)cudaErrorInvalidValue;
  dllm::tc::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.q_pos = static_cast<const int*>(q_pos);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.S_q = S_q;
  a.Nq = Nq;
  a.Nkv = Nkv;
  a.W = W;
  a.kv_bstride = kv_bstride;
  a.sc_bstride = sc_bstride;
  a.scale = scale;
  return dllm::tc::flash_tc_attention<true, dllm::tc::kWindow>(a, B, D, stream);
}
