// One-token decode attention over the sequential engines' contiguous int8
// KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel `_decode_kernel_q8` behind
// `flash_decode_attention_q8` (distributed_llm_tpu/ops/pallas_attention.py).
// q [B, Nq, D] bf16, one layer's cache [B, S, Nkv, D] int8 with float32 row
// scales [B, S, Nkv], both read in place through their batch strides (the
// JAX wrapper's transpose of the scales to [B, Nkv, S] was for TPU
// tiling), pos [B] int32.  The kernels are ragged_verify.cuh's split pass
// over contiguous 64-position tiles (`Contig`) at G = 1, instantiated for
// int8 tiles, and its per-row merge; layout, work split and numerics are
// described there.
//
// Bound on the card: bytes, as the bf16 kernel (flash_decode.cu): a
// sequence streams D + 4 bytes per position and kv head for K and for V
// where the bf16 kernel streams 2 D.  What the design does about it: the
// same split plan (T = 2 tiles a split at orin's and nano's B = 1 over an
// 8192 window) and cp.async ring; the int8 tiles land in shared memory and
// are widened there to bf16 (exact) for the mma.sync products, the K scale
// applied to the float32 scores and the V scale folded into P.  The row
// scales of one kv head are strided by Nkv floats, so they go by 4-byte
// cp.async copies, one a thread, in the tile's commit group.  The
// dequantized window never reaches device memory; the partials (written once,
// read once) are about 12% of the int8 K/V bytes at D = 128.
#include "ragged_verify.cuh"

extern "C" int flash_decode_attention_q8(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* q_pos, void* o, void* part_acc,
                                         void* part_ml, int B, int S_q, int Nq, int Nkv, int D,
                                         int W, int T, int S, long long kv_bstride,
                                         long long sc_bstride, float scale, void* stream) {
  return dllm::verify::split_window_attention<true>(q, k, v, k_scale, v_scale, q_pos, o,
                                                    part_acc, part_ml, B, S_q, Nq, Nkv, D, W,
                                                    T, S, kv_bstride, sc_bstride, scale, stream);
}
