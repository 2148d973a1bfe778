// W1: the int8-weight product of the decode-shaped projections, for Hopper.
//
//   y[M, N] = bf16( bf16( sum_k x[m, k] * q[k, n] ) * s[n] )
//
// x bf16 [M, K] (row stride ldx elements), q int8 [K, N] row-major (the
// JAX package's [in, out] layout), s bf16 [N] (the per-output-channel
// scale), y bf16 [M, N] contiguous; M <= 64 (kMaxRows).  The sum is kept in
// float32 and rounded to bf16 before the scale, as the JAX package's
// `quant.matmul` rounds `x @ q.astype(bf16)` before `* s`.
//
// Replaces no Pallas kernel: it is the port's counterpart of XLA's fused
// convert-and-dot behind `distributed_llm_tpu/ops/quant.py:77` (`matmul`),
// where XLA widens the int8 weight in registers inside the dot.  In plain
// PyTorch the cast writes a bf16 copy of the weight and reads it back (5
// bytes a weight against 2 for a bf16 weight); this kernel reads each int8
// weight once.
//
// Bound on the card: bytes.  At the decode shapes (M = 1..8) a weight byte
// feeds M multiply-adds against the card's ~295 bf16 operations a byte; the
// byte bound is (K N + 2 N + 2 M K + 2 M N) / 3.35 TB/s (orin's w_gate,
// 4096 x 14336: 58.7 MB, 17.5 us).  What the design does about it:
//
// 1. Split-K over a grid of (column tiles, splits).  Block (bn, sp) owns
//    kBN = 128 output columns and the k-tiles [sp * T, min((sp + 1) * T,
//    ceil(K / 64))) of the contraction; T and S come from the wrapper's
//    shape-only plan (`ops/quant.w8_split_plan`), sized to at least 2 x 132
//    blocks (orin's w_gate: 112 column tiles x 3 splits; nano's wq: 16 x
//    16).  Each block writes a float32 partial [S, M, N] of its columns; a
//    second kernel sums a row's partials in split order, rounds, scales and
//    stores.  The reduction is deterministic: no float atomics, so the same
//    inputs give the same bits eagerly and inside a replayed CUDA graph.
// 2. The weights stream through a ring of kStages shared-memory stages by
//    16-byte cp.async.cg copies, coalesced along N (a 64 x 128 int8 tile a
//    stage, 4 copies a thread); the x slice of the same 64 k-rows (at most
//    64 rows of 128 bytes) rides in the same stage.  Rows past K and columns
//    past N are zero-filled (src-size 0); padded x rows past M are zeroed.
// 3. Tensor cores: mma.sync m16n8k16 bf16 -> f32 with the WEIGHTS as the
//    16-row A operand and x as the 8-column B operand, so M = 1..8 pads to
//    one n8 tile, not to 16 rows.  Warp w owns 32 of the block's columns as
//    two m16 tiles; the A rows are a permutation of them chosen so that a
//    thread's four columns (tile t, rows g and g + 8 -> columns 4g + 2t and
//    4g + 2t + 1) are four adjacent bytes: one 32-bit shared load per k-row
//    feeds both tiles, and the accumulators store as one float4 a row.
// 4. int8 -> bf16 without the conversion unit: a byte b is placed under the
//    float32 exponent of 2^23 by one byte-permute, (b ^ 0x80) | 0x4B000000
//    = 2^23 + 128 + v, and one subtraction of 2^23 + 128 gives v exactly;
//    two such floats pack into one bf16x2 register (exact: |v| <= 127).
// 5. Capture-safe: it allocates nothing (the partials are the caller's,
//    from torch's allocator) and never synchronises; every launch returns
//    its cudaError_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dllm {
namespace w8 {

constexpr int kBN = 128;         // output columns a block
constexpr int kBK = 64;          // k-rows a stage
constexpr int kThreads = 128;    // 4 warps, 32 columns each
constexpr int kStages = 4;
constexpr int kMaxRows = 64;
constexpr int kLdW = kBN + 16;   // bytes a weight row in shared memory
constexpr int kLdX = kBK + 8;    // bf16 elements an x row in shared memory

template <int NT>  // n8 tiles of x rows: M <= 8 NT
struct Cfg {
  static constexpr int kRows = 8 * NT;
  static constexpr int kWBytes = kBK * kLdW;
  static constexpr int kXBytes = kRows * kLdX * 2;
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kSmem = kStages * kStageBytes;
};

struct Args {
  const __nv_bfloat16* x;
  long long ldx;
  const int8_t* q;
  const __nv_bfloat16* s;
  __nv_bfloat16* y;
  float* part;
  int M, K, N, T, S;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte i of `lo` and of `hi` (each already XORed with 0x80) as one bf16x2,
// the low half from `lo`.
template <int I>
__device__ __forceinline__ uint32_t widen2(uint32_t lo, uint32_t hi) {
  constexpr uint32_t sel = 0x7440u | I;
  const float f0 = __uint_as_float(__byte_perm(lo, 0x4B000000u, sel)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(hi, 0x4B000000u, sel)) - 8388736.0f;
  const __nv_bfloat162 h = __floats2bfloat162_rn(f0, f1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Start the copies of k-tile `kt` into `stage`: the 64 x 128 weight tile
// and the 64 k-columns of every padded x row.
template <int NT>
__device__ __forceinline__ void load_stage(const Args& a, unsigned char* stage, int kt, int n0) {
  using C = Cfg<NT>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kBK * kBN / 16 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / (kBN / 16), cc = c % (kBN / 16);
    const int k = kt * kBK + r, n = n0 + cc * 16;
    const bool full = k < a.K && n < a.N;
    cp_async16_zfill(stage + r * kLdW + cc * 16, a.q + (full ? (long long)k * a.N + n : 0), full);
  }
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage + C::kWBytes);
  for (int c = tid; c < C::kRows * (kBK / 8); c += kThreads) {
    const int m = c / (kBK / 8), cc = c % (kBK / 8);
    const int k = kt * kBK + cc * 8;
    const bool full = m < a.M && k < a.K;
    cp_async16_zfill(xs + m * kLdX + cc * 8, a.x + (full ? m * a.ldx + k : 0), full);
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads) w8_split_kernel(const Args a) {
  using C = Cfg<NT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, quad = lane % 4;
  const int n0 = blockIdx.x * kBN;
  const int sp = blockIdx.y;
  const int k_tiles = (a.K + kBK - 1) / kBK;
  const int kt0 = sp * a.T;
  const int nk = min(a.T, k_tiles - kt0);

  float acc[2][NT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.0f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nk) load_stage<NT>(a, smem + i * C::kStageBytes, kt0 + i, n0);
    cp_async_commit();
  }
  const int wcol = warp * 32 + 4 * g;  // this thread's 4 columns in the tile
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; stage i - 1 is free for reuse
    if (i + kStages - 1 < nk) {
      load_stage<NT>(a, smem + ((i + kStages - 1) % kStages) * C::kStageBytes,
                     kt0 + i + kStages - 1, n0);
    }
    cp_async_commit();
    const unsigned char* ws = smem + (i % kStages) * C::kStageBytes;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(ws + C::kWBytes);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int r0 = ks * 16 + 2 * quad;
      const uint32_t w00 = *reinterpret_cast<const uint32_t*>(ws + r0 * kLdW + wcol) ^ 0x80808080u;
      const uint32_t w01 =
          *reinterpret_cast<const uint32_t*>(ws + (r0 + 1) * kLdW + wcol) ^ 0x80808080u;
      const uint32_t w10 =
          *reinterpret_cast<const uint32_t*>(ws + (r0 + 8) * kLdW + wcol) ^ 0x80808080u;
      const uint32_t w11 =
          *reinterpret_cast<const uint32_t*>(ws + (r0 + 9) * kLdW + wcol) ^ 0x80808080u;
      uint32_t af[2][4];
      af[0][0] = widen2<0>(w00, w01);
      af[0][1] = widen2<1>(w00, w01);
      af[0][2] = widen2<0>(w10, w11);
      af[0][3] = widen2<1>(w10, w11);
      af[1][0] = widen2<2>(w00, w01);
      af[1][1] = widen2<3>(w00, w01);
      af[1][2] = widen2<2>(w10, w11);
      af[1][3] = widen2<3>(w10, w11);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* xr = xs + (8 * j + g) * kLdX + ks * 16 + 2 * quad;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
        mma_bf16(acc[0][j], af[0], b0, b1);
        mma_bf16(acc[1][j], af[1], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // acc[t][j]: rows (weight columns) n0 + wcol + 2t (c0, c1) and + 1 (c2,
  // c3); columns (x rows) m = 8j + 2 quad (c0, c2) and m + 1 (c1, c3).
  const int n = n0 + wcol;
  if (n >= a.N) return;
  float* part = a.part + (long long)sp * a.M * a.N;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int m = 8 * j + 2 * quad;
    if (m < a.M) {
      *reinterpret_cast<float4*>(part + (long long)m * a.N + n) =
          make_float4(acc[0][j][0], acc[0][j][2], acc[1][j][0], acc[1][j][2]);
    }
    if (m + 1 < a.M) {
      *reinterpret_cast<float4*>(part + (long long)(m + 1) * a.N + n) =
          make_float4(acc[0][j][1], acc[0][j][3], acc[1][j][1], acc[1][j][3]);
    }
  }
}

// One thread a row's 4 adjacent columns: the S partials summed in split
// order, rounded to bf16, times the scale, rounded again.
__global__ void w8_merge_kernel(const Args a) {
  const int quads = a.N / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)a.M * quads) return;
  const int m = (int)(idx / quads), n = (int)(idx % quads) * 4;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = 0; sp < a.S; ++sp) {
    const float4 p =
        *reinterpret_cast<const float4*>(a.part + ((long long)sp * a.M + m) * a.N + n);
    sum.x += p.x;
    sum.y += p.y;
    sum.z += p.z;
    sum.w += p.w;
  }
  const float v[4] = {sum.x, sum.y, sum.z, sum.w};
  __nv_bfloat16 out[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float r = __bfloat162float(__float2bfloat16_rn(v[e]));
    out[e] = __float2bfloat16_rn(r * __bfloat162float(a.s[n + e]));
  }
  *reinterpret_cast<uint2*>(a.y + (long long)m * a.N + n) = *reinterpret_cast<const uint2*>(out);
}

template <int NT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<NT>;
  auto kernel = w8_split_kernel<NT>;
  if (C::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.N + kBN - 1) / kBN, a.S);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long work = (long long)a.M * (a.N / 4);
  w8_merge_kernel<<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace w8
}  // namespace dllm

// Returns the launch's cudaError_t (0 = launched).  1 <= M <= 64; K and N
// multiples of 16; ldx >= K and a multiple of 8; every split non-empty
// (S = ceil(ceil(K / 64) / T)); x, q and y 16-byte aligned.
extern "C" int w8_matmul(const void* x, long long ldx, const void* q, const void* s, void* y,
                         void* part, int M, int K, int N, int T, int S, void* stream) {
  using namespace dllm::w8;
  const int k_tiles = (K + kBK - 1) / kBK;
  if (M < 1 || M > kMaxRows || K < 16 || K % 16 || N < 16 || N % 16 || ldx < K || ldx % 8 ||
      T < 1 || S != (k_tiles + T - 1) / T) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{static_cast<const __nv_bfloat16*>(x), ldx, static_cast<const int8_t*>(q),
               static_cast<const __nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(y),
               static_cast<float*>(part), M, K, N, T, S};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((M + 7) / 8) {
    case 1: return (int)launch<1>(a, st);
    case 2: return (int)launch<2>(a, st);
    case 3: return (int)launch<3>(a, st);
    case 4: return (int)launch<4>(a, st);
    case 5: return (int)launch<5>(a, st);
    case 6: return (int)launch<6>(a, st);
    case 7: return (int)launch<7>(a, st);
    default: return (int)launch<8>(a, st);
  }
}
