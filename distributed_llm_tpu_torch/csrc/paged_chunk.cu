// Suffix-chunk attention straight out of the paged KV pool, for Hopper: a
// prefix hit's suffix and each chunk of a chunked prefill.
//
// Replaces the Pallas TPU kernel `_paged_chunk_kernel` behind
// `paged_chunk_attention` (distributed_llm_tpu/ops/pallas_attention.py).
// q [1, S_c, Nq, D] bf16 are a chunk's queries at absolute positions
// start + r; the pool is one layer [Nkv, NB, bs, D] bf16 and table [MB]
// int32 is the slot's block row, so position p lives at
// (table[p / bs], p % bs).  Row r attends positions 0 .. start + r of the
// first window / bs table blocks (the chunk's own K/V are already
// written).  start [1] int32 is read on the device.
//
// The kernel is flash_tc.cuh's, instantiated for bf16 tiles gathered
// through the table (each 128-key tile's rows read from their pool blocks,
// bs = 16, 32, 64 or 128: at 16 a tile spans eight blocks) with positions
// start + r.  It is the causal prefill's kernel (flash_causal.cu) with
// another tile source, so a row
// scores the same keys with the same arithmetic on both: a prompt served
// cold and the same prompt's suffix served on a prefix hit give the same
// bits.  Layout, work split and numerics are described there.
//
// Bound on the card: a chunk of S_c rows over P cached positions does
// about 4 Nq D S_c P operations on about 4 Nkv D P bytes of K/V, so the
// serving chunks (S_c = 256) sit near the balance of bytes and bf16
// operations, and a prefix hit (few real rows) is bound by bytes.  What the
// design does about it: each table-gathered K/V tile is staged once by
// cp.async for the 64 GQA-packed rows of a block and scored on the tensor
// cores, and the walk stops at the block's furthest frontier instead of
// walking the whole window.
#include "flash_tc.cuh"

// Returns the launch's cudaError_t (0 = launched).  D must be 16, 64 or
// 128, bs 16, 32, 64 or 128, Nq a multiple of Nkv with a group of at most
// 64.
extern "C" int paged_chunk_attention(const void* q, const void* k_pool, const void* v_pool,
                                     const void* table, const void* start, void* o, int S_c,
                                     int Nq, int Nkv, int NB, int bs, int D, int window_blocks,
                                     float scale, void* stream) {
  dllm::tc::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k_pool;
  a.v = v_pool;
  a.table = static_cast<const int*>(table);
  a.start = static_cast<const int*>(start);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.S_q = S_c;
  a.Nq = Nq;
  a.Nkv = Nkv;
  a.W = window_blocks * bs;
  a.NB = NB;
  switch (bs) {
    case 16:
      a.bs_shift = 4;
      break;
    case 32:
      a.bs_shift = 5;
      break;
    case 64:
      a.bs_shift = 6;
      break;
    case 128:
      a.bs_shift = 7;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  a.scale = scale;
  return dllm::tc::flash_tc_attention<false, dllm::tc::kPaged>(a, 1, D, stream);
}
