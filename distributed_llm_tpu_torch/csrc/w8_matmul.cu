// W1: the int8-weight product, for Hopper.
//
//   y[M, N] = bf16( bf16( sum_k x[m, k] * q[k, n] ) * s[n] )
//
// x bf16 [M, K] (row stride ldx elements), q int8 [K, N] row-major (the
// JAX package's [in, out] layout), s bf16 [N] (the per-output-channel
// scale), y bf16 [M, N] contiguous.  The sum is kept in float32 and rounded
// to bf16 before the scale, as the JAX package's `quant.matmul` rounds
// `x @ q.astype(bf16)` before `* s`.  One launch computes up to three such
// products that share x (a layer's q/k/v or gate/up projections).
//
// Replaces no Pallas kernel: it is the port's counterpart of XLA's fused
// convert-and-dot behind `distributed_llm_tpu/ops/quant.py:77` (`matmul`),
// where XLA widens the int8 weight inside the dot.  Cast + matmul writes a
// bf16 copy of the weight and reads it back (5 bytes a weight); this kernel
// reads each int8 weight once.
//
// Bound on the card: bytes at decode rows (M <= 64: a weight byte feeds M
// multiply-adds against the card's ~295 bf16 operations a byte; orin's
// w_gate at 4 rows is 58.7 MB, 17.5 us), operations as M grows past a few
// hundred rows (2 M K N at 989 TFLOP/s).  One kernel serves both regimes:
//
// 1. Tensor cores, weights as A.  wgmma m64nBMk16 bf16 -> f32 with 64
//    weight COLUMNS as the A operand from registers and BM rows of x as B
//    from shared memory, so y^T = q^T x^T: M = 1..8 rows pad to one n8
//    tile, not to 64 rows.  A consumer warpgroup owns 128 weight columns as
//    two wgmmas a k-step; its A rows are a permutation of them chosen so a
//    thread's four columns (wgmma j, rows g and g + 8 of warp w -> columns
//    32 w + 4 g + 2 j and + 1) are four adjacent bytes: one 32-bit shared
//    load per k-row feeds both wgmmas, and the accumulators store as one
//    8-byte group a row.  A from registers rather than widened into a
//    bf16 copy in shared memory (not built, so not measured): widening in
//    the consumer reads each weight byte from shared memory once, where
//    the copy would write 2 bytes and wgmma read them back, and at decode,
//    where most launches are, the time is the weight bytes'.
// 2. int8 -> bf16 without the conversion unit: a byte b is placed under the
//    float32 exponent of 2^23 by one byte-permute, (b ^ 0x80) | 0x4B000000
//    = 2^23 + 128 + v, and one subtraction of 2^23 + 128 gives v exactly;
//    the top halves of two such floats are their bf16s (exact: |v| <= 127),
//    packed into one bf16x2 register by a third byte-permute.
// 3. Warp specialised.  After the consumers (wgmma wants each consumer
//    warpgroup's warps at 4 k .. 4 k + 3) comes the producer: one thread
//    keeps TMA loads (cp.async.bulk.tensor, 128-byte swizzle, zero fill
//    past K, N and M) of each k-tile's 64 x 128 int8 weight sub-tiles and
//    its BM x 64 bf16 x tile in flight into a ring of S shared-memory
//    stages, each guarded by a full and an empty mbarrier.  The swizzle
//    makes the consumers' 32-bit weight loads and wgmma's x reads
//    conflict-free.  A consumer widens a k-tile's fragments, issues its 8
//    wgmmas as one group and waits for them: ptxas serializes every wgmma
//    of a group whose register inputs are written while an older group is
//    in flight, so a consumer's arithmetic overlaps the ring's loads and
//    (wide) the other warpgroup's, not its own next k-tile.  Up to 32
//    decode rows the even and odd k-steps accumulate apart (two chains of
//    dependent wgmmas, not one), added in that order at the chunk's end.
// 4. Regimes by shape.  Decode (M <= 64): one consumer warpgroup, BM = 8,
//    16, 32 or 64 (M rounded up), a tile of 128 columns.  Wide (M > 64):
//    two consumer warpgroups and a tile of 256 columns, BM = 64, or 128
//    where the launch has a wave of 64-row tiles (half the weight tiles'
//    widening and reloading; the caller's plan picks, and the chunks do
//    not depend on it).  The 128-row tile's 128 accumulators a thread
//    would spill at the 168 registers a thread of a 288-thread block
//    gets, so its producer is a whole warpgroup that hands registers to
//    the consumers (setmaxnreg: 40 for it, 232 for each consumer).
// 5. A persistent grid and equal shares.  A weight's tiles are cut along K
//    into `nch` chunks of `chunk` k-tiles (the shape-only plan of
//    `ops/quant.w8_plan`, a function of that weight's M, K and N alone);
//    the launch's k-tiles, weight by weight, tile by tile, are cut into G
//    equal contiguous shares, and each item (weight, tile, chunk) goes to
//    the block whose share holds its first k-tile, so every block streams
//    the same weight bytes to within one chunk, whatever the weights'
//    chunk lengths.  The grid is at most one block an SM.
// 6. The fix-up in the same launch.  A chunk of a split tile writes its
//    float32 partial [BM, BN] to the caller's scratch (one slot an item),
//    then counts itself on the tile's counter; the block whose count
//    completes the tile sums the tile's partials in chunk order (from
//    zero: ((0 + P0) + P1) + ...), rounds, scales and stores.  The sum's
//    order is fixed by the plan, so a product gives the same bits eagerly,
//    in a replayed CUDA graph and in a grouped launch as alone; no float
//    atomics.  The counters are the launch's own: the caller allocates
//    them with the partials, per call, and the entry zeroes them on the
//    launch's stream just before the kernel (one memset), so no two
//    launches that may overlap share one.
// 7. Capture-safe: it allocates nothing (partials and counters are the
//    caller's, from torch's allocator, which inside a capture is the
//    graph's own pool) and never synchronises; the counters' memset and
//    the tensor maps, which ride in the kernel's parameters, are captured
//    with the launch and replay as captured.  Every launch returns its
//    cudaError_t.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace dllm {
namespace w8 {

constexpr int kBK = 64;                 // k-rows a k-tile
constexpr int kSub = 128;               // weight columns a consumer warpgroup
constexpr int kSubBytes = kBK * kSub;   // one swizzled int8 sub-tile
constexpr int kMaxWeights = 3;
constexpr int kMaxDecodeRows = 64;

struct Params {
  CUtensorMap xmap;                     // x [M, K] bf16, box 64 x BM
  CUtensorMap qmap[kMaxWeights];        // q [K, N] int8, box 128 x 64
  const __nv_bfloat16* s[kMaxWeights];
  __nv_bfloat16* y[kMaxWeights];
  long long item_base[kMaxWeights + 1]; // a weight's first item; [nw] = all
  long long kt_base[kMaxWeights + 1];   // its first k-tile; [nw] = all
  int tile_base[kMaxWeights];           // a weight's first tile counter
  int n[kMaxWeights];
  int chunk[kMaxWeights];               // k-tiles an item
  int nch[kMaxWeights];                 // items a tile
  float* part;                          // [items, BM, BN] float32
  int* cnt;                             // a counter a tile, the launch's own, zeroed
  int M, KT, row_tiles, nw;
  long long items;
  int grid;
};

struct Item {
  long long idx;   // the item's index (its partial's slot)
  int w, tile, rt, ct, chunk, nch, kt0, kt1;
};

// Item i: weight, tile (column tiles outer, row tiles inner), chunk.
__device__ __forceinline__ Item item_at(const Params& p, long long i) {
  Item it;
  it.idx = i;
  it.w = (p.nw > 2 && i >= p.item_base[2]) ? 2 : (p.nw > 1 && i >= p.item_base[1]) ? 1 : 0;
  const long long local = i - p.item_base[it.w];
  it.nch = p.nch[it.w];
  const int t = (int)(local / it.nch);
  it.chunk = (int)(local % it.nch);
  it.tile = p.tile_base[it.w] + t;
  it.ct = t / p.row_tiles;
  it.rt = t % p.row_tiles;
  it.kt0 = it.chunk * p.chunk[it.w];
  it.kt1 = min(it.kt0 + p.chunk[it.w], p.KT);
  return it;
}

// The first item whose first k-tile is at or past k-tile `o` of the
// launch's sequence (items in order, each tile's K split into chunks).
__device__ __forceinline__ long long item_from(const Params& p, long long o) {
  if (o >= p.kt_base[p.nw]) return p.items;
  const int w = (p.nw > 2 && o >= p.kt_base[2]) ? 2 : (p.nw > 1 && o >= p.kt_base[1]) ? 1 : 0;
  const long long local = o - p.kt_base[w];
  const long long t = local / p.KT;
  const int r = (int)(local % p.KT);
  const int j = (r + p.chunk[w] - 1) / p.chunk[w];  // <= nch: past the last, the next tile's first
  return p.item_base[w] + t * p.nch[w] + j;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of parity `parity` to complete.  A wait that never
// ends is a fault (a lost arrival): after about 2^28 polls the kernel traps,
// so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA load of a 2-D box at (c0 innermost, c1) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving an accumulator across a wgmma boundary.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Consumers only (the producer warp never joins): named barrier 1.
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// The B operand's descriptor: a K-major bf16 tile of 128-byte rows, 128-byte
// swizzle, 8-row groups 1024 bytes apart; the start address moves 32 bytes
// a k-step inside the swizzle atom.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Byte i of `lo` and of `hi` (each already XORed with 0x80) as one bf16x2,
// the low half from `lo`.
template <int I>
__device__ __forceinline__ uint32_t widen2(uint32_t lo, uint32_t hi) {
  constexpr uint32_t sel = 0x7440u | I;
  const float f0 = __uint_as_float(__byte_perm(lo, 0x4B000000u, sel)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(hi, 0x4B000000u, sel)) - 8388736.0f;
  // |v| <= 127 leaves a float32's low 16 bits zero: its top half is its
  // bf16, exactly (a byte-permute, not the quarter-rate conversion).
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// 4 bytes at (row r, byte column c) of a 128-byte-swizzled 64 x 128 tile.
__device__ __forceinline__ uint32_t lds_w(const unsigned char* tile, int r, int c) {
  const int off = r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15));
  return *reinterpret_cast<const uint32_t*>(tile + off) ^ 0x80808080u;
}

// k-step ks's A fragments of both wgmmas for the thread's four columns c
// (c = 32 w + 4 g) and its k-rows 2 t, 2 t + 1, 2 t + 8, 2 t + 9.
__device__ __forceinline__ void load_a(const unsigned char* tile, int ks, int c, int t,
                                       uint32_t (&a)[2][4]) {
  const int r0 = ks * 16 + 2 * t;
  const uint32_t w00 = lds_w(tile, r0, c), w01 = lds_w(tile, r0 + 1, c);
  const uint32_t w10 = lds_w(tile, r0 + 8, c), w11 = lds_w(tile, r0 + 9, c);
  a[0][0] = widen2<0>(w00, w01);
  a[0][1] = widen2<1>(w00, w01);
  a[0][2] = widen2<0>(w10, w11);
  a[0][3] = widen2<1>(w10, w11);
  a[1][0] = widen2<2>(w00, w01);
  a[1][1] = widen2<3>(w00, w01);
  a[1][2] = widen2<2>(w10, w11);
  a[1][3] = widen2<3>(w10, w11);
}

// d += A (64 x 16, registers) * B (16 x N, shared memory by descriptor).
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <int BM, int WG, int S, int CH, int PW>
struct Cfg {
  static constexpr int kBN = kSub * WG;
  static constexpr int kXBytes = BM * kBK * 2;
  static constexpr int kStage = WG * kSubBytes + kXBytes;
  static constexpr int kSmem = S * kStage + 1024;  // + the 1024-byte alignment slack
  static constexpr int kConsumers = 128 * WG;
  static constexpr int kThreads = kConsumers + PW;  // PW: the producer's threads
  static constexpr int kAcc = BM / 2;
  // Decode: two blocks an SM fit (registers and shared memory).
  static constexpr int kMinBlocks = WG == 1 ? 2 : 1;
};

// Rows 8 j + 2 t and + 1 of the thread's four columns, from the two
// accumulators (module note 1): v[0] the row, v[1] the next.
template <int BM>
__device__ __forceinline__ void row_pair(const float (&a0)[BM / 2], const float (&a1)[BM / 2],
                                         int j, float4 (&v)[2]) {
  v[0] = make_float4(a0[4 * j + 0], a0[4 * j + 2], a1[4 * j + 0], a1[4 * j + 2]);
  v[1] = make_float4(a0[4 * j + 1], a0[4 * j + 3], a1[4 * j + 1], a1[4 * j + 3]);
}

// Round to bf16, times the scale, round again; four columns of one row.
__device__ __forceinline__ void store4(__nv_bfloat16* y, const __nv_bfloat16* s, float4 v) {
  const uint2 sv = *reinterpret_cast<const uint2*>(s);
  const __nv_bfloat162 s01 = *reinterpret_cast<const __nv_bfloat162*>(&sv.x);
  const __nv_bfloat162 s23 = *reinterpret_cast<const __nv_bfloat162*>(&sv.y);
  const float in[4] = {v.x, v.y, v.z, v.w};
  const float sc[4] = {__low2float(s01), __high2float(s01), __low2float(s23), __high2float(s23)};
  __nv_bfloat16 out[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    out[e] = __float2bfloat16_rn(__bfloat162float(__float2bfloat16_rn(in[e])) * sc[e]);
  }
  *reinterpret_cast<uint2*>(y) = *reinterpret_cast<const uint2*>(out);
}

// Free a stage: each consumer warp arrives once its reads are done.
__device__ __forceinline__ void release(uint64_t* empty, int st, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(smem_addr(&empty[st]));
}

// Keep the compiler from sinking a fragment's or descriptor's definition
// past wgmma.fence: an input defined inside a wgmma group makes ptxas
// serialize the group.
__device__ __forceinline__ void fence_a(uint32_t (&af)[4][2][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(af[ks][j][e])::"memory");
}

// One k-tile: wait for its stage, widen its A fragments, issue its 8
// wgmmas as one group (k-step ks into accumulator chain ks % CH), wait for
// them and free the stage.
template <int BM, int WG, int S, int CH, int PW>
__device__ __forceinline__ void k_tile(uint32_t (&af)[4][2][4], float (&acc)[CH][2][BM / 2],
                                       const unsigned char* smem, uint32_t base, uint64_t* full,
                                       uint64_t* empty, int& stage, uint32_t& phase, int wg, int c,
                                       int t, int lane) {
  using C = Cfg<BM, WG, S, CH, PW>;
  mbar_wait(smem_addr(&full[stage]), phase);
  __syncwarp();  // wgmma is warp-aligned: reconverge after the spin
  // W8_SWEEP_CUT_BEGIN: a k-tile's widening and wgmmas, which
  // port_tools/w8_sweep.py cuts out for its no-arithmetic copy.
  const unsigned char* wt = smem + stage * C::kStage + wg * kSubBytes;
  const uint32_t xs = base + stage * C::kStage + WG * kSubBytes;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) load_a(wt, ks, c, t, af[ks]);
  uint64_t desc[4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    desc[ks] = b_desc(xs + 32 * ks);
    asm volatile("" : "+l"(desc[ks])::"memory");
  }
  fence_a(af);
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) {
    fence_acc(acc[ch][0]);
    fence_acc(acc[ch][1]);
  }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    Wgmma<BM>::mma(acc[ks % CH][0], af[ks][0], desc[ks]);
    Wgmma<BM>::mma(acc[ks % CH][1], af[ks][1], desc[ks]);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) {
    fence_acc(acc[ch][0]);
    fence_acc(acc[ch][1]);
  }
  // W8_SWEEP_CUT_END
  release(empty, stage, lane);
  if (++stage == S) {
    stage = 0;
    phase ^= 1;
  }
}

template <int BM, int WG, int S, int CH, int PW>
__global__ void __launch_bounds__(Cfg<BM, WG, S, CH, PW>::kThreads,
                                  Cfg<BM, WG, S, CH, PW>::kMinBlocks)
    w8_kernel(const __grid_constant__ Params p) {
  using C = Cfg<BM, WG, S, CH, PW>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S];
  __shared__ __align__(8) uint64_t empty[S];
  __shared__ int tile_done;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);
  // Equal shares of the k-tiles: each item to the block whose share holds
  // its first k-tile.
  const long long total = p.kt_base[p.nw];
  const long long i0 = item_from(p, (long long)blockIdx.x * total / p.grid);
  const long long i1 = item_from(p, (long long)(blockIdx.x + 1) * total / p.grid);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), 4 * WG);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;

  if (threadIdx.x >= C::kConsumers) {
    // The producer, after the consumers (wgmma wants each consumer
    // warpgroup's warps at 4 k .. 4 k + 3): one thread streams every k-tile
    // of the block's items.  A whole producer warpgroup (PW = 128) hands
    // its registers to the consumers.
    if (PW == 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != C::kConsumers) return;
    int stage = 0;
    uint32_t phase = 0;
    for (long long i = i0; i < i1; ++i) {
      const Item it = item_at(p, i);
      const CUtensorMap* qmap = &p.qmap[it.w];
      for (int kt = it.kt0; kt < it.kt1; ++kt) {
        mbar_wait(smem_addr(&empty[stage]), phase ^ 1);
        const uint32_t bar = smem_addr(&full[stage]);
        const uint32_t dst = base + stage * C::kStage;
        mbar_expect_tx(bar, C::kStage);
#pragma unroll
        for (int c = 0; c < WG; ++c) {
          tma_load(dst + c * kSubBytes, qmap, bar, it.ct * C::kBN + c * kSub, kt * kBK);
        }
        tma_load(dst + WG * kSubBytes, &p.xmap, bar, kt * kBK, it.rt * BM);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns columns [128 wg, 128 wg + 128) of a tile.
  if (PW == 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ctid = threadIdx.x;
  const int wg = ctid / 128;
  const int warp = (ctid / 32) % 4;
  const int g = lane / 4, t = lane % 4;
  const int c = 32 * warp + 4 * g;  // the thread's 4 columns in its sub-tile
  const int col = wg * kSub + c;    // ... in the tile
  float acc[CH][2][C::kAcc];  // [chain][wgmma][register]
  uint32_t a[4][2][4];        // a k-tile's fragments: 4 k-steps x 2 wgmmas
  int stage = 0;
  uint32_t phase = 0;
  for (long long i = i0; i < i1; ++i) {
    const Item it = item_at(p, i);
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
#pragma unroll
      for (int e = 0; e < C::kAcc; ++e) acc[ch][0][e] = acc[ch][1][e] = 0.0f;
    for (int kt = it.kt0; kt < it.kt1; ++kt) {
      k_tile<BM, WG, S, CH, PW>(a, acc, smem, base, full, empty, stage, phase, wg, c, t, lane);
    }
    if (CH == 2) {
      // The chains' sums in a fixed order: the even k-steps' plus the odd.
#pragma unroll
      for (int e = 0; e < C::kAcc; ++e) {
        acc[0][0][e] += acc[CH - 1][0][e];
        acc[0][1][e] += acc[CH - 1][1][e];
      }
    }
    const float(&acc0)[C::kAcc] = acc[0][0];
    const float(&acc1)[C::kAcc] = acc[0][1];

    const int w = it.w;
    const int n = it.ct * C::kBN + col;
    const int m0 = it.rt * BM + 2 * t;
    if (it.nch == 1) {
      // A whole tile: round, scale, store.
      if (n < p.n[w]) {
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          float4 v[2];
          row_pair<BM>(acc0, acc1, j, v);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int m = m0 + 8 * j + r;
            if (m < p.M) store4(p.y[w] + (long long)m * p.n[w] + n, p.s[w] + n, v[r]);
          }
        }
      }
      continue;
    }
    // A chunk of a split tile: its partial into its slot, then the count.
    float* slot = p.part + it.idx * (long long)(BM * C::kBN);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      float4 v[2];
      row_pair<BM>(acc0, acc1, j, v);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<float4*>(slot + (8 * j + 2 * t + r) * C::kBN + col) = v[r];
      }
    }
    __threadfence();
    consumer_sync(C::kConsumers);
    if (ctid == 0) {
      const int done = atomicAdd(p.cnt + it.tile, 1) == it.nch - 1;
      if (done) __threadfence();  // then read the other chunks' partials
      tile_done = done;
    }
    consumer_sync(C::kConsumers);
    if (!tile_done || n >= p.n[w]) continue;
    // The tile's last chunk to finish: sum its partials in chunk order,
    // into the accumulators (their own partial is in the scratch too).
    // Each partial's loads are all in flight at once.
    const float* first = p.part + (it.idx - it.chunk) * (long long)(BM * C::kBN);
#pragma unroll
    for (int e = 0; e < C::kAcc; ++e) acc[0][0][e] = acc[0][1][e] = 0.0f;
    for (int k = 0; k < it.nch; ++k) {
      const float* src = first + k * (long long)(BM * C::kBN);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float4 v =
              __ldcg(reinterpret_cast<const float4*>(src + (8 * j + 2 * t + r) * C::kBN + col));
          acc[0][0][4 * j + r] += v.x;  // row_pair's layout, row r
          acc[0][0][4 * j + 2 + r] += v.y;
          acc[0][1][4 * j + r] += v.z;
          acc[0][1][4 * j + 2 + r] += v.w;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      float4 v[2];
      row_pair<BM>(acc0, acc1, j, v);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + 8 * j + r;
        if (m < p.M) store4(p.y[w] + (long long)m * p.n[w] + n, p.s[w] + n, v[r]);
      }
    }
  }
}

// The encoder of TMA descriptors, from the libcuda PyTorch has loaded.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A row-major [rows, cols] matrix of `elem`-byte values, row stride `ld`
// elements, as boxes of box_rows x box_cols (box_cols * elem = 128 bytes).
static bool encode(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr,
                   long long rows, long long cols, long long ld, int box_rows, int box_cols) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * elem)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Internal linkage: its static is this library's own, not one merged with
// another library's instance of the same template.
template <int BM, int WG, int S, int CH, int PW>
static cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<BM, WG, S, CH, PW>;
  auto kernel = w8_kernel<BM, WG, S, CH, PW>;
  // The shared-memory opt-in, once a device (a bit a device, set after).
  static unsigned long long sized = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(sized >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) sized |= 1ull << dev;
  }
  kernel<<<p.grid, C::kThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace w8
}  // namespace dllm

// Returns the launch's cudaError_t (0 = launched).  x [M, K] bf16 with row
// stride ldx (>= K, a multiple of 8); nw (1-3) weights q_i [K, n_i] int8,
// s_i [n_i] bf16, y_i [M, n_i] bf16, n_i a multiple of 16, each cut into
// chunks of c_i k-tiles (1 <= c_i <= ceil(K / 64)); bm the tile's rows:
// at most 64 rows (decode) 8, 16, 32 or 64, the least that holds M, and
// above (wide) 64 or 128 (`ops/quant.w8_plan` picks); `part` holds
// part_len floats, a [bm, BN] float32 slot for every item when any
// weight has more than one chunk, and then `cnt` cnt_len int32 counters,
// one a tile, which the entry zeroes on `stream` before the launch (both
// unused, and may be null, when no weight splits; a shorter scratch is
// refused); 1 <= grid <= items.
// x, q_i and y_i 16-byte aligned.
extern "C" int w8_matmul(const void* x, long long ldx, int M, int K, int bm, int nw,
                         const void* q0,
                         const void* s0, void* y0, int n0, int c0, const void* q1,
                         const void* s1, void* y1, int n1, int c1, const void* q2,
                         const void* s2, void* y2, int n2, int c2, void* part,
                         long long part_len, void* cnt, long long cnt_len, int grid,
                         void* stream) {
  using namespace dllm::w8;
  const void* qs[kMaxWeights] = {q0, q1, q2};
  const void* ss[kMaxWeights] = {s0, s1, s2};
  void* ys[kMaxWeights] = {y0, y1, y2};
  const int ns[kMaxWeights] = {n0, n1, n2};
  const int cs[kMaxWeights] = {c0, c1, c2};
  const int kt = (K + kBK - 1) / kBK;
  if (M < 1 || K < 16 || K % 16 || ldx < K || ldx % 8 || nw < 1 || nw > kMaxWeights ||
      grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const bool wide = M > kMaxDecodeRows;
  const int pad = M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64;
  if (wide ? bm != 64 && bm != 128 : bm != pad) return (int)cudaErrorInvalidValue;
  const int bn = wide ? 2 * kSub : kSub;
  Params p;
  p.M = M;
  p.KT = kt;
  p.row_tiles = (M + bm - 1) / bm;
  p.nw = nw;
  p.part = static_cast<float*>(part);
  p.cnt = static_cast<int*>(cnt);
  long long items = 0, ktiles = 0;
  int tiles = 0;
  for (int i = 0; i < nw; ++i) {
    if (ns[i] < 16 || ns[i] % 16 || cs[i] < 1 || cs[i] > kt) return (int)cudaErrorInvalidValue;
    p.s[i] = static_cast<const __nv_bfloat16*>(ss[i]);
    p.y[i] = static_cast<__nv_bfloat16*>(ys[i]);
    p.n[i] = ns[i];
    p.chunk[i] = cs[i];
    p.nch[i] = (kt + cs[i] - 1) / cs[i];

    p.item_base[i] = items;
    p.kt_base[i] = ktiles;
    p.tile_base[i] = tiles;
    const int t = p.row_tiles * ((ns[i] + bn - 1) / bn);
    tiles += t;
    items += (long long)t * p.nch[i];
    ktiles += (long long)t * kt;
    if (!encode(&p.qmap[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qs[i], K, ns[i], ns[i], kBK, kSub)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  for (int i = nw; i <= kMaxWeights; ++i) {
    p.item_base[i] = items;
    p.kt_base[i] = ktiles;
  }
  p.items = items;
  p.grid = grid;
  bool split = false;
  for (int i = 0; i < nw; ++i) split = split || p.nch[i] > 1;
  if (grid > items || (split && (part == nullptr || part_len < items * bm * bn ||
                                  cnt == nullptr || cnt_len < tiles))) {
    return (int)cudaErrorInvalidValue;
  }
  if (!encode(&p.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, ldx, bm, kBK)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split) {
    const cudaError_t err = cudaMemsetAsync(cnt, 0, tiles * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  }
  if (wide) {
    return bm == 64 ? (int)launch<64, 2, 5, 1, 32>(p, st) : (int)launch<128, 2, 5, 1, 128>(p, st);
  }
  switch (bm) {
    case 8: return (int)launch<8, 1, 8, 2, 32>(p, st);
    case 16: return (int)launch<16, 1, 8, 2, 32>(p, st);
    case 32: return (int)launch<32, 1, 6, 2, 32>(p, st);
    default: return (int)launch<64, 1, 6, 1, 32>(p, st);
  }
}
