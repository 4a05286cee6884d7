// The 3xTF32 pieces of the port's two f32 matrix kernels on NVIDIA Hopper
// (sm_90a): imdct_window.cu (the decode's IMDCT + window) and mdct_rows.cu
// (the encode's MDCT).  Both compute
//
//     total[r, c] = sum_k a[row0 + r, k] * b[col0 + c, k]
//
// for a row-major a [M, K] and a K-major b [N, K], both f32, b given as its
// tf32 split b_hi + b_lo, each element by the same sequence of roundings
// (below), and add their own epilogue.  imdct_window calls tile_product,
// one 128x128 tile a block, as it was first written.  mdct_rows runs its own
// schedule on the same pieces (a persistent grid, the tile shape chosen by
// the row count, ping-pong warpgroups on 128 x 128 tiles: mdct_rows.cu):
// wgmma_tf32 at any width from 8 to 128 columns, split_tf32, the Fast2Sum
// carry, store_fragment.
//
// Why 3xTF32, and how it keeps f32 accuracy (what bounds the kernels: the
// f32 CUDA cores peak at 67 TFLOP/s; only the tensor cores go beyond, and
// they take TF32, a 10-bit mantissa, which alone misses the 2e-5 bar of
// the TPU kernel's Precision.HIGHEST):
//   * Each operand x is split into hi = tf32(x) and lo = tf32(x - hi), both
//     rounded to nearest, ties away; the product is a_hi*b_lo + a_lo*b_hi +
//     a_hi*b_hi (a_lo*b_lo, ~2^-22 of the product, is dropped), three wgmma
//     per k-step of 8.
//   * b is split once per table by the wrapper (ops/kernels.py): tf32 wgmma
//     takes its shared-memory operand K-major only.  a changes every
//     launch, so the consumers split it in registers with cvt.rna.tf32.f32
//     (a raw f32 fed to a tf32 wgmma would be truncated, not rounded) and
//     feed A from registers.  Each consumer reads the next k-tile's A
//     fragment while the current wgmma run.
//   * One producer thread streams [128, 32] tiles of a, b_hi and b_lo (48 KB
//     a stage) with TMA, 128-byte swizzle, into a 4-stage mbarrier ring
//     (full/empty barriers); two consumer warpgroups each own 64 rows of the
//     128x128 tile and run m64n128k8 wgmma on it.  The producer's warpgroup
//     gives its registers to the consumers (setmaxnreg 40 / 232).
//   * The tensor cores' fp32 accumulation behaves as if it truncated: a CPU
//     model that truncates after each wgmma predicted the card's error, and
//     in that model one accumulator over k = 1024 is 24x less accurate than
//     plain fp32.  So: the wgmma accumulator holds one 32-deep k-tile, then
//     is added to a register sum with __fadd_rn; within a k-tile the 8
//     small-term wgmma run first and the 4 large ones last; and the rounding
//     error of each add to the sum, (sum - t) + part (Fast2Sum), is left in
//     the accumulator as the start of the next k-tile (compensated summation
//     at no register cost).
//   * Rows never meet: no split-k, no reduction across blocks, rows past M
//     arrive as zeros.  A row's result depends on that row alone, whatever
//     M is and wherever the row sits in its tile.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a (no fast math, no
// -lcuda: the TMA map encoder is reached through the runtime).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int BM = 128;  // output rows per block: two warpgroups of 64
constexpr int BN = 128;  // output columns per block
constexpr int BK = 32;   // k-tile: 32 f32 make one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMER_WARPS = 8;                   // warpgroups 0 and 1
constexpr int THREADS = CONSUMER_WARPS * 32 + 128;  // + the producer's
constexpr uint32_t TILE_BYTES = BM * BK * 4;        // 16 KB
constexpr uint32_t STAGE_BYTES = 3 * TILE_BYTES;    // a, b_hi, b_lo
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack
static_assert(BN == BM, "the b tiles have the a tile's size");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `parity` to complete.  A phase that never
// completes traps after ~10 s (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// One [box_rows, 32] f32 box at (column c0, row c1) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle, whose
// 1024-byte swizzle atom starts on a 1024-byte boundary; `addr` may step
// 32 bytes (one k-step of 8 tf32) into the row.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |           // leading offset (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |  // stride: 8 rows of 128 B
         (static_cast<uint64_t>(1) << 62);           // 128-byte swizzle
}

// Keeps the compiler from moving register reads of `d` across the
// asynchronous wgmma that writes it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a * b over one k-step of 8: a [64, 8] tf32 from registers, b [8, N]
// tf32 from shared memory, N = 2R columns (m64nNk8; N = 128, 64, 32, 16 or
// 8), d the thread's R accumulators.  scale-d is always on: d never starts
// from zero (it carries the last k-tile's rounding error).
template <int R>
__device__ __forceinline__ void wgmma_tf32(float (&d)[R], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  static_assert(R == 64 || R == 32 || R == 16 || R == 8 || R == 4,
                "a wgmma width of 128, 64, 32, 16 or 8 columns");
  if constexpr (R == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  } else if constexpr (R == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  } else if constexpr (R == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  } else if constexpr (R == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
}

// x ~= hi + lo, each a tf32 value (low 13 bits zero) rounded to nearest with
// ties away; the mask clears whatever cvt leaves in the low bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(x));
  h &= 0xFFFFE000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(x - __uint_as_float(h)));
  hi = h;
  lo = l & 0xFFFFE000u;
}

// The accumulator fragment of a consumer thread (PTX ISA, wgmma register
// fragments of m64nNk8): warp w of a warpgroup holds tile rows row() and
// row() + 8; accumulator 4j + i is at column 8j + 2q + i % 2, row
// row() + 8 * (i / 2), with q = lane % 4.
__device__ __forceinline__ int fragment_row() {
  const int warp = threadIdx.x / 32;
  return (warp / 4) * 64 + (warp % 4) * 16 + (threadIdx.x % 32) / 4;
}

// The k-loop of the block's tile: `ktiles` k-tiles of 32 from the maps of a
// ([M, K] in [128, 32] boxes), b_hi and b_lo ([N, K] in [128, 32] boxes).
// Returns false in the producer's threads, which have nothing left to do,
// and true in the consumers', whose `total` then holds their fragment of
// the tile (fragment_row()).  Needs SMEM_BYTES of dynamic shared memory
// and THREADS threads.
__device__ __forceinline__ bool tile_product(const CUtensorMap* a_map,
                                             const CUtensorMap* hi_map,
                                             const CUtensorMap* lo_map,
                                             int ktiles, int row0, int col0,
                                             float (&total)[64]) {
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];

  // The 128-byte swizzle repeats every 1024 bytes: tiles start on one.
  const uint32_t pad = (1024 - (smem_addr(smem) & 1023)) & 1023;
  const uint32_t tiles = smem_addr(smem) + pad;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (warp == CONSUMER_WARPS && lane == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(smem_addr(&empty[s]), ((kt / STAGES) & 1) ^ 1);
        const uint32_t bar = smem_addr(&full[s]);
        const uint32_t dst = tiles + s * STAGE_BYTES;
        mbar_expect_tx(bar, STAGE_BYTES);  // rows past M arrive as zeros
        tma_load(dst, a_map, bar, kt * BK, row0);
        tma_load(dst + TILE_BYTES, hi_map, bar, kt * BK, col0);
        tma_load(dst + 2 * TILE_BYTES, lo_map, bar, kt * BK, col0);
      }
    }
    return false;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  // A element i of a k-step is at column q + 4 * (i / 2), row
  // fragment_row() + 8 * (i % 2).
  const int g = lane / 4;
  const int q = lane % 4;
  const int r = fragment_row();  // tile rows r, r + 8
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = part[i] = 0.f;

  // The A fragment of k-tile kt, read from shared memory while the wgmma of
  // k-tile kt - 1 run.  16-byte chunk c of tile row x lies at chunk
  // c ^ (x % 8), and r % 8 == g.
  float a_raw[BK / 8][4];
  auto load_a = [&](int kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_addr(&full[s]), (kt / STAGES) & 1);
    const float* a_tile =
        reinterpret_cast<const float*>(smem + pad + s * STAGE_BYTES);
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const int c0 = ((2 * ks) ^ g) * 4 + q;
      const int c1 = ((2 * ks + 1) ^ g) * 4 + q;
      a_raw[ks][0] = a_tile[r * BK + c0];
      a_raw[ks][1] = a_tile[(r + 8) * BK + c0];
      a_raw[ks][2] = a_tile[r * BK + c1];
      a_raw[ks][3] = a_tile[(r + 8) * BK + c1];
    }
  };

  load_a(0);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    const uint32_t stage = tiles + s * STAGE_BYTES;
    uint32_t a_hi[BK / 8][4], a_lo[BK / 8][4];
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a_raw[ks][i], a_hi[ks][i], a_lo[ks][i]);
    }

    // part starts as the rounding error carried from the last k-tile.
    fence_regs(part);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {  // the small terms first,
      wgmma_tf32(part, a_hi[ks], smem_desc(stage + 2 * TILE_BYTES + ks * 32));
      wgmma_tf32(part, a_lo[ks], smem_desc(stage + TILE_BYTES + ks * 32));
    }
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {  // the large ones last
      wgmma_tf32(part, a_hi[ks], smem_desc(stage + TILE_BYTES + ks * 32));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (kt + 1 < ktiles) load_a(kt + 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[s]));  // the stage is free

#pragma unroll
    for (int i = 0; i < 64; ++i) {  // Fast2Sum: total + part = t + error
      const float t = __fadd_rn(total[i], part[i]);
      part[i] = __fadd_rn(__fsub_rn(total[i], t), part[i]);
      total[i] = t;
    }
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = __fadd_rn(total[i], part[i]);
  return true;
}

// Stores a thread's accumulator fragment `v` of an m64nNk8 tile (R = N / 2
// values, already through the epilogue) into the row-major out [M, ld]:
// rows r and r + 8, columns col0 + 8j + 2q + {0, 1} (the layout above),
// rows past M dropped.  Lanes q and q ^ 1 swap halves: the even lane
// stores four adjacent columns of row r, the odd lane the same columns of
// row r + 8; each thread stores 16 bytes of one row.
template <int R>
__device__ __forceinline__ void store_fragment(const float (&v)[R], float* out,
                                               int M, int ld, int r, int col0) {
  const int q = threadIdx.x % 4;
  const bool odd = q & 1;
  const int row = r + (odd ? 8 : 0);
  float* dst = out + static_cast<size_t>(row) * ld + col0 + 4 * (q / 2);
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const float v0 = v[4 * j + 0], v1 = v[4 * j + 1];
    const float v2 = v[4 * j + 2], v3 = v[4 * j + 3];
    const float t0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
    const float t1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
    if (row < M) {
      *reinterpret_cast<float4*>(dst + 8 * j) =
          odd ? make_float4(t0, t1, v2, v3) : make_float4(v0, v1, t0, t1);
    }
  }
}

// Stores tile_product's `total` (through the epilogue) at tile (row0, col0).
__device__ __forceinline__ void store_tile(const float (&v)[64], float* out,
                                           int M, int ld, int row0, int col0) {
  store_fragment(v, out, M, ld, row0 + fragment_row(), col0);
}

// Named barriers (ids 1-15; 0 is __syncthreads) over `threads` threads:
// bar_sync waits until they have all arrived, bar_arrive arrives without
// waiting.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A map of a row-major [rows, cols] f32 array in boxes of [box_rows, 32],
// with the 128-byte swizzle; boxes past the last row read zeros.
inline bool make_map(CUtensorMap* map, const float* base, int rows, int cols,
                     int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(float)};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raises the kernel's dynamic shared-memory limit to `bytes`, once per
// device and kernel (`raised` is the kernel's own flag array).
template <typename Kernel>
inline cudaError_t raise_smem_once(Kernel kernel, bool (&raised)[64],
                                   int bytes = SMEM_BYTES) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!raised[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  return cudaSuccess;
}

// What the build made of a kernel: info[0..4] = registers a thread, local
// (spill) bytes a thread, static and dynamic shared memory bytes a block,
// pipeline stages (0 for a kernel without the ring).
template <typename Kernel>
inline int kernel_info(Kernel kernel, int dynamic_smem, int stages, int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = dynamic_smem;
  info[4] = stages;
  return 0;
}

}  // namespace tf32x3
