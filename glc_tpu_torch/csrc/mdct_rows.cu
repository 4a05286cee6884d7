// The encode's MDCT product for NVIDIA Hopper (sm_90a), fp32 in and out:
//
//     out[m, k] = (sum_t win[m, t] * cos_table[k, t]) * norm
//
// over windowed blocks win [M, 2n] and the cos table [n, 2n], with norm
// applied after the sum as the reference applies it to each dot product
// (reference src/codec.rs:358-374; the JAX package's
// glc_tpu/ops/mdct.py:67-68).
//
// Not the port of a Pallas kernel: it replaces the XLA einsum of
// glc_tpu/ops/mdct.py:67, which the port first ran as one cuBLAS product.
// cuBLAS picks its kernel, tiling and split-k by the problem's shape, so a
// frame's coefficients rounded differently in a 1292-row segment, a
// 2048-row shard and an 8192-row segment, and the quantizer turned an ulp
// into a +-1 flip: sharded and re-segmented encodes did not write the
// serial bytes.  Here a row's result depends on that row alone, whatever M
// and the tile plan are: every output element is the same sequence of
// roundings (below), no split-k, no reduction across tiles, the ragged
// edge masked.
//
// The arithmetic of an element, the same in every plan: ktiles_of(n)
// k-tiles of 32 (64 at 2n = 2048); in each, the 3xTF32 products of tf32x3.cuh (win split hi/lo
// with cvt.rna and a mask, the table's split read from memory), the 8
// small-term wgmma k-steps first and the 4 large ones last, into an
// accumulator that starts from the last k-tile's rounding error; the
// k-tile's sum added to a register total by Fast2Sum; at the end total +
// error, then one __fmul_rn by norm.  A wgmma of 64 rows computes each of
// its elements alike at any width N (checked on the card: every plan gives
// the default plan's bits, chip_smoke.py).
//
// What bounds it on an H100 (SXM, 132 SMs): 2*M*2n*n flops (34.4 GFLOP at
// M = 8192) against 4*(M*2n + 2n*n + M*n) bytes (~109 MB): bound by
// arithmetic, 0.0694 ms at M = 8192 for the one f32 product at the TF32
// peak (495 TFLOP/s).  3xTF32 runs three TF32 products: its floor is 3x
// that, 0.208 ms at M = 8192.  The first version (one 128 x 128 tile a
// block, a grid of tiles) took ~0.09-0.10 ms at any M up to 1292 and
// 0.37-0.39 ms at 8192, back to back.  What this one does about it:
//   * Small M left the card empty: 8 column tiles x ceil(M / 128) row
//     tiles, each block walking the whole 64-deep k-loop however few rows
//     it held.  The k-loop cannot be split (the rounding would depend on
//     M), so the plan (ops/kernels.py::mdct_rows_plan) cuts the columns
//     finer instead: a tile of 64 rows by N = 64, 32, 16 or 8 columns, one
//     to a consumer warpgroup, a block's two tiles side by side (they share
//     the block's rows of win), each warpgroup splitting the next k-tile's
//     A while its wgmma run.  A tile still walks 64 k-tiles of 12 dependent
//     wgmma, ~0.040 ms at any width: the floor of this arithmetic at small M.
//   * Large M keeps 128 x 128 tiles (the warpgroups split its rows and
//     share its table tiles: the fewest bytes a flop).  ptxas had put a
//     warpgroup fence (C7519) between the wgmma where the compiler sank the
//     A split among them; fence_a pins the split ahead of the batch.  The
//     two warpgroups take turns to issue (ping-pong, named barriers).  Read
//     on the card: 62-64% of the 3xTF32 floor at 8192 rows, the SM clock
//     at 1575-1815 MHz at the 700 W limit; issuing only after the other
//     warpgroup's batch completed, two or four accumulator chains a
//     warpgroup, or a one-time offset between the warpgroups were slower.
// Every plan walks its tiles with a persistent grid of at most one block
// an SM (ops/kernels.py sizes it by multi_processor_count), block b taking
// units b, b + grid, ...; its producer runs on into the next unit's loads
// while the consumers store the last one.  Each plan's build: 168
// registers a thread at launch (the consumers raise theirs to 232), 0
// spill bytes, 64 B static shared memory and 4 stages of dynamic (197632
// B at 128 x 128; kernels.mdct_smem_bytes for each shape).
//
// Shapes: win [M, 2n] f32 row-major, the table split into table_hi /
// table_lo, each [n, 2n] f32 (cos_table itself: it is already K-major, the
// layout tf32 wgmma takes for its shared-memory operand), each with rows
// of pitch_of(2n) floats (tf32x3.cuh: 2n itself for an even n), norm one
// f32 in device memory (read by the epilogue, so that the launch needs no
// host copy of it), out [M, n] f32 contiguous.  Any 1 <= n <= 8192 (the
// hop size: the codec's default 1024, a 48 kHz library's 20 ms hop 960,
// 44.1 kHz's 10 ms 441).  Pointers 16-byte aligned.
//
// Any n, with a row's bits the same in every plan: a unit's columns past
// n (units_n is a ceiling) read the table's rows past n as zeros and are
// not stored; the k-tail past 2n reads zeros in win and the table; and
// the k-loop is padded to an even count (ktiles_of) in every plan, since
// the narrow consumers take k-tiles in pairs: each added k-tile adds exact
// zero products.  At n = 1024 (64 k-tiles, every unit full) the launch and
// the bits are those of the kernel written for that n alone.
//
// Called through the plain C entry glc_mdct_rows below.

#include <climits>
#include <type_traits>

#include "f64_rows.cuh"
#include "tf32x3.cuh"

using namespace tf32x3;

namespace {

constexpr int MAX_DYNAMIC_SMEM = 232448 - 1024;  // an H100 block, less static

// A plan's unit of work: a block's tiles.  ROWS 128: one tile of 128 x COLS,
// the two warpgroups on its two 64-row halves; ROWS 64: two tiles of 64 x
// COLS side by side, one a warpgroup.  COLS is the wgmma width.
template <int ROWS, int COLS>
struct Unit {
  static_assert(ROWS == 128 || ROWS == 64, "tiles of 128 or 64 rows");
  static constexpr int BLOCK_ROWS = ROWS;
  static constexpr int BLOCK_COLS = ROWS == 128 ? COLS : 2 * COLS;
  static constexpr uint32_t A_BYTES = BLOCK_ROWS * BK * 4;
  static constexpr uint32_t B_BYTES = BLOCK_COLS * BK * 4;  // b_hi, b_lo each
  static constexpr uint32_t STAGE = A_BYTES + 2 * B_BYTES;
  static constexpr int RING = 4;                    // stages
  static constexpr int SMEM = RING * STAGE + 1024;  // + alignment slack
  static_assert(SMEM <= MAX_DYNAMIC_SMEM, "fits one block an SM");
  static_assert(B_BYTES % 1024 == 0 && (COLS * BK * 4) % 1024 == 0,
                "every tile starts on a 128-byte swizzle atom");
};

// The k-tiles of 32 every plan walks for width 2n: ceil(2n / 32), rounded
// up to even (the narrow consumers take them in pairs).
__host__ __device__ __forceinline__ int ktiles_of(int n) {
  return ((2 * n + BK - 1) / BK + 1) / 2 * 2;
}

constexpr int ORDER_0 = 1;  // warpgroup 0 has issued its k-tile
constexpr int ORDER_1 = 2;  // warpgroup 1 has issued its k-tile
constexpr int CONSUMERS = CONSUMER_WARPS * 32;

template <int B>
using Buf = std::integral_constant<int, B>;  // a static A-buffer index

// The shared-memory ring of a unit shape: U::RING stages, each the unit's
// win tile, then its table_hi and table_lo tiles; full[s] completes when
// stage s has landed, empty[s] when the consumer warps are done with it.
struct Ring {
  uint32_t base;              // stage 0's shared-memory address
  const unsigned char* data;  // the same, as a pointer
  uint64_t* full;
  uint64_t* empty;
};

// Waits for the stage of k-tile `it` and reads this thread's A fragment of
// its win tile (rows r, r + 8).  A element i of a k-step is at column
// q + 4 * (i / 2), row r + 8 * (i % 2); 16-byte chunk c of tile row x lies
// at chunk c ^ (x % 8), and r % 8 == g.
template <typename U>
__device__ __forceinline__ void read_a(const Ring& ring, int it, int r,
                                       float (&a)[BK / 8][4]) {
  const int s = it % U::RING;
  mbar_wait(smem_addr(&ring.full[s]), (it / U::RING) & 1);
  const float* tile = reinterpret_cast<const float*>(ring.data + s * U::STAGE);
  const int g = (threadIdx.x % 32) / 4;
  const int q = threadIdx.x % 4;
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    const int c0 = ((2 * ks) ^ g) * 4 + q;
    const int c1 = ((2 * ks + 1) ^ g) * 4 + q;
    a[ks][0] = tile[r * BK + c0];
    a[ks][1] = tile[(r + 8) * BK + c0];
    a[ks][2] = tile[r * BK + c1];
    a[ks][3] = tile[(r + 8) * BK + c1];
  }
}

// Pins the split A fragment before the wgmma: without it the compiler
// sinks the split's cvt between the wgmma that read its results and has
// to fence the warpgroup there (ptxas C7519), which stalls the chain.
__device__ __forceinline__ void fence_a(uint32_t (&a)[BK / 8][4]) {
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[ks][i])::"memory");
  }
}

// One k-tile's 12 wgmma into `part`: the 8 small terms, then the 4 large.
template <int R>
__device__ __forceinline__ void issue_ktile(float (&part)[R],
                                            uint32_t (&a_hi)[BK / 8][4],
                                            uint32_t (&a_lo)[BK / 8][4],
                                            uint32_t hi, uint32_t lo) {
  fence_a(a_hi);
  fence_a(a_lo);
  fence_regs(part);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {  // the small terms first,
    wgmma_tf32(part, a_hi[ks], smem_desc(lo + ks * 32));
    wgmma_tf32(part, a_lo[ks], smem_desc(hi + ks * 32));
  }
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {  // the large ones last
    wgmma_tf32(part, a_hi[ks], smem_desc(hi + ks * 32));
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits for this warpgroup's wgmma, frees stage s, adds part to total by
// Fast2Sum and leaves the add's rounding error in part (the next k-tile's
// start).
template <int R>
__device__ __forceinline__ void finish_ktile(const Ring& ring, int s,
                                             float (&total)[R], float (&part)[R]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_regs(part);
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(smem_addr(&ring.empty[s]));
#pragma unroll
  for (int i = 0; i < R; ++i) {  // Fast2Sum: total + part = t + error
    const float t = __fadd_rn(total[i], part[i]);
    part[i] = __fadd_rn(__fsub_rn(total[i], t), part[i]);
    total[i] = t;
  }
}

// The epilogue of a tile: the error's last add, then __fmul_rn(acc, norm),
// one rounding, as (x @ table.T) * norm; rows past M are not stored.
template <int R>
__device__ __forceinline__ void store_tile_of(float (&total)[R], const float (&part)[R],
                                              float s_norm, float* out, int M, int n,
                                              int row, int col0) {
#pragma unroll
  for (int i = 0; i < R; ++i) total[i] = __fmul_rn(__fadd_rn(total[i], part[i]), s_norm);
  store_fragment_ragged(total, out, M, n, row, col0);
}

// The consumers of a 128 x 128 unit: warpgroup wg takes rows 64 wg.. of
// the tile, all 128 columns.  The two take turns to issue: a warpgroup
// issues k-tile `it` once the other has issued its k-tile before (named
// barriers ORDER_0 / ORDER_1), then reads the next A while its wgmma run.
template <typename U>
__device__ __forceinline__ void consume_wide(const Ring& ring, float s_norm,
                                             float* out, int M, int n,
                                             int units_n, int units) {
  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;
  const int r = 64 * wg + (warp % 4) * 16 + (threadIdx.x % 32) / 4;
  const int ktiles = ktiles_of(n);
  float total[64], part[64];
  float a_raw[BK / 8][4];  // the next k-tile's A, read while wgmma run
  int it = 0;              // the k-tiles consumed so far, over all units
  if (static_cast<int>(blockIdx.x) < units) read_a<U>(ring, 0, r, a_raw);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int row0 = (u / units_n) * U::BLOCK_ROWS;
    const int col0 = (u % units_n) * U::BLOCK_COLS;
    const bool more = u + static_cast<int>(gridDim.x) < units;
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = part[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % U::RING;
      uint32_t a_hi[BK / 8][4], a_lo[BK / 8][4];
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(a_raw[ks][i], a_hi[ks][i], a_lo[ks][i]);
      }
      if (wg == 0) {
        if (it > 0) bar_sync(ORDER_1, CONSUMERS);
      } else {
        bar_sync(ORDER_0, CONSUMERS);
      }
      const uint32_t hi = ring.base + s * U::STAGE + U::A_BYTES;
      issue_ktile(part, a_hi, a_lo, hi, hi + U::B_BYTES);
      bar_arrive(wg == 0 ? ORDER_0 : ORDER_1, CONSUMERS);
      if (kt + 1 < ktiles || more) read_a<U>(ring, it + 1, r, a_raw);
      finish_ktile(ring, s, total, part);
    }
    store_tile_of(total, part, s_norm, out, M, n, row0 + r, col0);
  }
  if (wg == 0 && it > 0) bar_sync(ORDER_1, CONSUMERS);  // warpgroup 1's last
}                                                         // arrival

// The consumers of a unit of two 64 x COLS tiles side by side, one a
// warpgroup.  The registers allow splitting k-tile it + 1's A while k-tile
// it's wgmma run (two split buffers: a wgmma reads its A registers until
// it completes).
template <typename U, int COLS>
__device__ __forceinline__ void consume_narrow(const Ring& ring, float s_norm,
                                               float* out, int M, int n,
                                               int units_n, int units) {
  constexpr int R = COLS / 2;  // accumulators a thread
  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + (threadIdx.x % 32) / 4;
  const int ktiles = ktiles_of(n);  // even
  const uint32_t b_off = COLS * wg * BK * 4;  // its rows of the table tiles
  float total[R], part[R];
  uint32_t a_hi[2][BK / 8][4], a_lo[2][BK / 8][4];

  auto load = [&](int it, auto buf) {  // k-tile it's A, split into buffer b
    constexpr int b = decltype(buf)::value;
    float a_raw[BK / 8][4];
    read_a<U>(ring, it, r, a_raw);
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a_raw[ks][i], a_hi[b][ks][i], a_lo[b][ks][i]);
    }
  };
  auto step = [&](int it, bool next, auto buf) {
    constexpr int b = decltype(buf)::value;
    const int s = it % U::RING;
    const uint32_t hi = ring.base + s * U::STAGE + U::A_BYTES + b_off;
    issue_ktile(part, a_hi[b], a_lo[b], hi, hi + U::B_BYTES);
    if (next) load(it + 1, Buf<1 - b>{});
    finish_ktile(ring, s, total, part);
  };

  int it = 0;  // the k-tiles consumed so far, over all units
  if (static_cast<int>(blockIdx.x) < units) load(0, Buf<0>{});
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int row0 = (u / units_n) * U::BLOCK_ROWS;
    const int col0 = (u % units_n) * U::BLOCK_COLS + COLS * wg;
    const bool more = u + static_cast<int>(gridDim.x) < units;
#pragma unroll
    for (int i = 0; i < R; ++i) total[i] = part[i] = 0.f;
    for (int kt = 0; kt < ktiles; kt += 2, it += 2) {  // it % 2 == kt % 2
      step(it, true, Buf<0>{});
      step(it + 1, kt + 2 < ktiles || more, Buf<1>{});
    }
    store_tile_of(total, part, s_norm, out, M, n, row0 + r, col0);
  }
}

template <int ROWS, int COLS>
__global__ void __launch_bounds__(THREADS, 1)
mdct_rows_kernel(const __grid_constant__ CUtensorMap win_map,  // [M, 2n]
                 const __grid_constant__ CUtensorMap hi_map,   // [n, 2n]
                 const __grid_constant__ CUtensorMap lo_map,   // [n, 2n]
                 const float* __restrict__ norm,               // [1]
                 float* __restrict__ out,                      // [M, n]
                 int M, int n, int units_n, int units) {
  using U = Unit<ROWS, COLS>;
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[U::RING];
  __shared__ __align__(8) uint64_t empty[U::RING];

  // The 128-byte swizzle repeats every 1024 bytes: tiles start on one.
  const uint32_t pad = (1024 - (smem_addr(smem) & 1023)) & 1023;
  const Ring ring{smem_addr(smem) + pad, smem + pad, full, empty};
  const int warp = threadIdx.x / 32;
  const int ktiles = ktiles_of(n);

  if (threadIdx.x == 0) {
    for (int s = 0; s < U::RING; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == CONSUMER_WARPS * 32) {
      int it = 0;  // the k-tiles loaded so far, over all units
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int row0 = (u / units_n) * U::BLOCK_ROWS;
        const int col0 = (u % units_n) * U::BLOCK_COLS;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % U::RING;
          mbar_wait(smem_addr(&empty[s]), ((it / U::RING) & 1) ^ 1);
          const uint32_t bar = smem_addr(&full[s]);
          const uint32_t dst = ring.base + s * U::STAGE;
          mbar_expect_tx(bar, U::STAGE);  // rows past M arrive as zeros
          tma_load(dst, &win_map, bar, kt * BK, row0);
          tma_load(dst + U::A_BYTES, &hi_map, bar, kt * BK, col0);
          tma_load(dst + U::A_BYTES + U::B_BYTES, &lo_map, bar, kt * BK, col0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    if constexpr (ROWS == 128) {
      consume_wide<U>(ring, *norm, out, M, n, units_n, units);
    } else {
      consume_narrow<U, COLS>(ring, *norm, out, M, n, units_n, units);
    }
  }
}

// Builds the maps and launches one plan's kernel (see glc_mdct_rows).
template <int ROWS, int COLS>
int launch(const float* win, const float* table_hi, const float* table_lo,
           const float* norm, float* out, int M, int n, int grid,
           cudaStream_t stream) {
  using U = Unit<ROWS, COLS>;
  static bool raised[64] = {};  // the shared-memory limit, once per device
  const int units_n = (n + U::BLOCK_COLS - 1) / U::BLOCK_COLS;
  const long long units =
      static_cast<long long>((M + ROWS - 1) / ROWS) * units_n;
  if (units > INT_MAX || grid < 1 || grid > units) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap win_map, hi_map, lo_map;
  if (!make_map(&win_map, win, M, 2 * n, U::BLOCK_ROWS) ||
      !make_map(&hi_map, table_hi, n, 2 * n, U::BLOCK_COLS) ||
      !make_map(&lo_map, table_lo, n, 2 * n, U::BLOCK_COLS)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = mdct_rows_kernel<ROWS, COLS>;
  const cudaError_t err = raise_smem_once(kernel, raised, U::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, U::SMEM, stream>>>(
      win_map, hi_map, lo_map, norm, out, M, n, units_n, static_cast<int>(units));
  return static_cast<int>(cudaGetLastError());
}

template <int ROWS, int COLS>
int info_of(int* info) {
  using U = Unit<ROWS, COLS>;
  return kernel_info(mdct_rows_kernel<ROWS, COLS>, U::SMEM, U::RING, info);
}

// Calls fn<ROWS, COLS>(args...) for a built plan; cudaErrorInvalidValue
// for any other.  The tile shapes: (128, 128), and (64, N) for N = 64, 32,
// 16, 8 (ops/kernels.py::MDCT_TILES).
template <template <int, int> class Fn, typename... Args>
int dispatch(int rows, int cols, Args... args) {
  if (rows == 128 && cols == 128) return Fn<128, 128>::run(args...);
  if (rows == 64) {
    switch (cols) {
      case 64: return Fn<64, 64>::run(args...);
      case 32: return Fn<64, 32>::run(args...);
      case 16: return Fn<64, 16>::run(args...);
      case 8: return Fn<64, 8>::run(args...);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int ROWS, int COLS>
struct Launch {
  static int run(const float* win, const float* hi, const float* lo,
                 const float* norm, float* out, int M, int n, int grid,
                 cudaStream_t stream) {
    return launch<ROWS, COLS>(win, hi, lo, norm, out, M, n, grid, stream);
  }
};

// The f64 path's epilogue: acc * norm in f64, rounded once.
struct Scale {
  const float* norm;
  __device__ float operator()(double total, int) const {
    return __double2float_rn(__dmul_rn(total, *norm));
  }
};

template <int ROWS, int COLS>
struct Info {
  static int run(int* info) { return info_of<ROWS, COLS>(info); }
};

}  // namespace

// Launches the plan (rows, cols, grid) on `stream` (a cudaStream_t) and
// returns a cudaError_t as an int: 0 on success, cudaErrorInvalidValue for
// n outside [1, 8192], a plan that is not built or a grid outside [1,
// units].  Pointers must be device pointers, 16-byte aligned, to f32
// arrays of the shapes and pitches above; table_hi / table_lo are the tf32
// split of the cos table.
extern "C" int glc_mdct_rows(const float* win, const float* table_hi,
                             const float* table_lo, const float* norm,
                             float* out, int M, int n, int rows, int cols,
                             int grid, void* stream) {
  if (M < 0 || n < 1 || n > MAX_N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  return dispatch<Launch>(rows, cols, win, table_hi, table_lo, norm, out, M, n,
                          grid, static_cast<cudaStream_t>(stream));
}

// What the build made of a plan's kernel: info[0..4] = registers a thread,
// local (spill) bytes a thread, static and dynamic shared memory bytes a
// block, pipeline stages.  Returns a cudaError_t as an int.
extern "C" int glc_mdct_rows_plan_info(int rows, int cols, int* info) {
  return dispatch<Info>(rows, cols, info);
}

// The f64 path (f64_rows.cuh; the wrapper takes it at the n where the tile
// product fails its error bar): out[m, k] = (win[m] . cos_table[k]) * *norm
// in f64, rounded once to f32.  win [M, 2n] contiguous, table_t [2n, n]
// the transposed cos table in f32 (not its split: a warp's threads, on
// neighbouring k, read neighbouring floats), norm one f32 in device memory,
// out [M, n].  Any 1 <= n <= 8192; returns a cudaError_t as an int.
extern "C" int glc_mdct_rows_f64(const float* win, const float* table_t,
                                 const float* norm, float* out, int M, int n,
                                 void* stream) {
  if (M < 0 || n < 1 || n > MAX_N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  return f64rows::launch(win, 2 * n, table_t, 1, n, out, M, n, 2 * n,
                      Scale{norm}, static_cast<cudaStream_t>(stream));
}

// The default large-M plan's (128, 128), as the other kernels report theirs.
extern "C" int glc_mdct_rows_info(int* info) {
  return glc_mdct_rows_plan_info(128, 128, info);
}
