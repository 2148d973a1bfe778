// A chunk of queries against the sequential engines' contiguous bf16 KV
// cache, for Hopper: a prefix hit's suffix, a long prompt's 2048-row
// chunk and the speculative verify's gamma + 1 rows.
//
// Replaces the Pallas TPU kernels `_chunk_kernel_native` (chunks of at
// most 256 rows) and `_chunk_kernel` (wider chunks) behind
// `flash_chunk_attention` (distributed_llm_tpu/ops/pallas_attention.py),
// at any chunk length (the JAX dispatcher keeps chunks of a length not
// divisible by 8 on XLA for the TPU compiler's sake; the card has no such
// limit).  q [B, S_c, Nq, D] bf16, one layer's cache window [B, W, Nkv, D]
// read in place through its batch stride (a window of a longer cache is
// never copied), q_pos [B, S_c] int32; row (i, h) attends kv head
// h / (Nq / Nkv) at positions 0 .. min(q_pos[b, i], W - 1).  Each row's
// position is read from q_pos, not rebuilt as start + i, so rows past a
// chunk's true length (clamped there) match the plain version as well.
//
// Bound on the card: a chunk of S_c rows over P cached positions does
// about 4 Nq D S_c P operations on 4 Nkv D P bytes of K/V, so short
// chunks (the verify, a prefix hit's few real rows) are bound by bytes
// and the 2048-row chunk by operations.  Two routes, chosen by the caller
// from shapes alone (ops/flash_attention.py `chunk_route`), both on
// templates the int8 kernels already run:
// - few rows: a chunk whose block rows (the group's heads x S_c) fit one
//   split-kernel block, at most 48 (orin's 5-row verify: 4 x 5 = 20), is
//   ragged_verify.cuh's split-K kernel over the window at G = S_c, each
//   row's frontier read from q_pos.  At B = 1 a block per (query tile, kv
//   head) would leave 8 blocks on the 132 SMs, each streaming the whole
//   window; the split plan (`chunk_split_plan`: 2 tiles a split at orin's
//   8192 window, 192 live blocks at position 3000) spreads the window's
//   bytes over the card, and a merge pass combines the float32 partials.
//   T >= 1 selects this route (tiles a split, S splits, the partials'
//   scratch);
// - wide chunks: flash_tc.cuh's tensor-core flash kernel with the window
//   tile source (`kWindow`), bf16: 64 GQA-packed rows a block, two warps a
//   16-row slab over 128-key tiles, mma.sync with P in registers, masks
//   only on straddling tiles, a cp.async ring; the int8 chunk
//   (flash_chunk_q8.cu) less the widening.  T = 0 selects it; the scratch
//   pointers are not read.
// Both round P to bf16 before PV, as the Pallas chunk kernels cast it to
// the cache dtype; layout, work split and numerics are described in the
// two headers.
#include "flash_tc.cuh"

// Returns the first failing launch's cudaError_t (0 = launched).  D must
// be 64 or 128, Nq a multiple of Nkv, B, S_q and W >= 1; the split route
// takes at most 48 block rows and S * T >= ceil(W / 64), the tensor-core
// route a group of at most 64.  The scale pointers and their batch stride
// are the int8 kernels' (one signature for the contiguous-cache kernels):
// a bf16 cache has none.
extern "C" int flash_chunk_attention(const void* q, const void* k, const void* v,
                                     const void* k_scale, const void* v_scale, const void* q_pos,
                                     void* o, void* part_acc, void* part_ml, int B, int S_q,
                                     int Nq, int Nkv, int D, int W, int T, int S,
                                     long long kv_bstride, long long sc_bstride, float scale,
                                     void* stream) {
  if (T < 0) return (int)cudaErrorInvalidValue;
  if (T >= 1) {
    return dllm::verify::split_window_attention<false>(q, k, v, nullptr, nullptr, q_pos, o,
                                                       part_acc, part_ml, B, S_q, Nq, Nkv, D,
                                                       W, T, S, kv_bstride, 0, scale, stream);
  }
  dllm::tc::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k;
  a.v = v;
  a.q_pos = static_cast<const int*>(q_pos);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.S_q = S_q;
  a.Nq = Nq;
  a.Nkv = Nkv;
  a.W = W;
  a.kv_bstride = kv_bstride;
  a.scale = scale;
  return dllm::tc::flash_tc_attention<false, dllm::tc::kWindow>(a, B, D, stream);
}
