// Shared pieces of the CUDA-core paged decode kernel (ragged_paged.cuh,
// K7): bf16 tile loads into padded shared memory and the per-query-row
// online-softmax (flash) update.
//
// Work split: a block of kThreads = 4 warps owns a set of query rows
// that read one kv head.  Each warp owns whole rows.  For every key
// tile the block stages K and V ([BK, D] bf16) in shared memory once;
// then, per row, lane t scores keys t, t+32, ... with a full D-long dot
// product, the warp reduces the tile max and sum with shuffles, and for
// the PV product each lane owns D/32 contiguous output dims.  Rows are
// padded to D/2 + 1 32-bit words (an odd stride), so the 32 lanes of a
// warp that read 32 different key rows hit 32 different banks.
//
// Numerics follow the Pallas kernels: the query is scaled in float32
// before QK, stats (max, sum) and the accumulator are float32, the
// probabilities are rounded to bf16 before PV (the sum uses them
// unrounded), and the output divides by max(l, 1e-30).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dllm {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

// 32-bit words per padded shared-memory row of D bf16 values.
template <int D>
struct Tile {
  static constexpr int kWords = D / 2 + 1;
};

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Stage BK rows of D bf16 values (row r at src + r * row_stride) into a
// padded tile; rows at or past valid_rows are zero-filled.  16-byte
// global loads: src and row_stride must keep every row 16-byte aligned.
template <int D, int BK>
__device__ __forceinline__ void load_tile(uint32_t* __restrict__ tile,
                                          const __nv_bfloat16* __restrict__ src,
                                          long row_stride, int valid_rows) {
  constexpr int kChunks = D / 8;  // uint4 per row
  for (int c = threadIdx.x; c < BK * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int cc = c % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows) {
      val = *reinterpret_cast<const uint4*>(src + (long)r * row_stride + cc * 8);
    }
    uint32_t* dst = tile + r * Tile<D>::kWords + cc * 4;
    dst[0] = val.x;
    dst[1] = val.y;
    dst[2] = val.z;
    dst[3] = val.w;
  }
}

// Load one query row (D bf16 at src) into shared memory as float32,
// multiplied by the softmax scale.  Called by one warp per row.
template <int D>
__device__ __forceinline__ void load_query_row(float* __restrict__ dst,
                                               const __nv_bfloat16* __restrict__ src,
                                               float scale, int lane) {
  for (int d = lane; d < D; d += 32) dst[d] = __bfloat162float(src[d]) * scale;
}

template <int D>
struct RowState {
  static constexpr int kDims = D / 32;  // output dims per lane
  float m;
  float l;
  float acc[kDims];

  __device__ __forceinline__ void init() {
    m = kNegInf;
    l = 0.f;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[e] = 0.f;
  }
};

// One online-softmax step of one query row against one staged key tile:
// keys col0 .. col0 + BK - 1, of which those with col > frontier are
// masked.  Must be called by all 32 lanes of the warp that owns the row.
// The caller only passes tiles whose first key is <= frontier, so the
// running max is finite after the first call.
template <int D, int BK>
__device__ __forceinline__ void attend_tile(const float* __restrict__ q_s,
                                            const uint32_t* __restrict__ k_s,
                                            const uint32_t* __restrict__ v_s,
                                            int col0, int frontier, int lane,
                                            RowState<D>& st) {
  constexpr int kKeys = BK / 32;  // keys per lane
  constexpr int kW = Tile<D>::kWords;
  constexpr int kDims = RowState<D>::kDims;

  float s[kKeys];
  float tile_max = kNegInf;
#pragma unroll
  for (int i = 0; i < kKeys; ++i) {
    const int t = lane + 32 * i;
    const uint32_t* krow = k_s + t * kW;
    float dot = 0.f;
#pragma unroll 8
    for (int w = 0; w < D / 2; ++w) {
      const float2 kf = bf16x2_to_float2(krow[w]);
      dot = fmaf(q_s[2 * w], kf.x, dot);
      dot = fmaf(q_s[2 * w + 1], kf.y, dot);
    }
    s[i] = (col0 + t <= frontier) ? dot : kNegInf;
    tile_max = fmaxf(tile_max, s[i]);
  }
  tile_max = warp_max(tile_max);
  const float m_new = fmaxf(st.m, tile_max);
  const float alpha = expf(st.m - m_new);

  float p[kKeys];
  float psum = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys; ++i) {
    p[i] = expf(s[i] - m_new);
    psum += p[i];
  }
  psum = warp_sum(psum);

  float pv[kDims];
#pragma unroll
  for (int e = 0; e < kDims; ++e) pv[e] = 0.f;
  const int w0 = lane * (kDims / 2);  // first output word of this lane
#pragma unroll
  for (int i = 0; i < kKeys; ++i) {
#pragma unroll 4
    for (int src = 0; src < 32; ++src) {
      const float pb = round_bf16(__shfl_sync(kFullMask, p[i], src));
      const uint32_t* vrow = v_s + (src + 32 * i) * kW + w0;
#pragma unroll
      for (int e = 0; e < kDims; e += 2) {
        const float2 vf = bf16x2_to_float2(vrow[e / 2]);
        pv[e] = fmaf(pb, vf.x, pv[e]);
        pv[e + 1] = fmaf(pb, vf.y, pv[e + 1]);
      }
    }
  }

  st.l = st.l * alpha + psum;
#pragma unroll
  for (int e = 0; e < kDims; ++e) st.acc[e] = st.acc[e] * alpha + pv[e];
  st.m = m_new;
}

// Write one finished row (D bf16 at dst): lane owns kDims contiguous dims.
template <int D>
__device__ __forceinline__ void store_row(__nv_bfloat16* __restrict__ dst,
                                          const RowState<D>& st, int lane) {
  constexpr int kDims = RowState<D>::kDims;
  const float denom = fmaxf(st.l, 1e-30f);
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dst + lane * kDims);
#pragma unroll
  for (int e = 0; e < kDims; e += 2) {
    out[e / 2] = __floats2bfloat162_rn(st.acc[e] / denom, st.acc[e + 1] / denom);
  }
}

}  // namespace dllm
