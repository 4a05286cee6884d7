// The f64 path of the port's two f32 matrix kernels on NVIDIA Hopper:
// mdct_rows.cu and imdct_window.cu take it at the n (the hop size) where
// the 3xTF32 tile product of tf32x3.cuh fails the bar they are held to,
// an error against float64 no more than twice the plain f32 product's
// (at most ops/kernels.py::_F64_MAX_N, which the wrappers read).  There
// they compute
//
//     out[m, j] = epilogue(sum_k a[m, k] * b[k, j], j)
//
// for a row-major f32 a [M, K] (rows lda floats apart, any 4-byte
// alignment) and a row-major f32 table b [K, ldb] (ldb a multiple of 4,
// zeros right of N: ops/kernels.py::f64_table), with every product and sum
// in f64 and one rounding to f32 at the end.
//
// Why: 3xTF32 carries each product with a relative error of up to ~2^-21
// (each operand's tf32 split keeps 22 bits), several f32 ulps of a short
// sum, while a plain f32 product's error grows with the k-loop.  Below a
// few hundred terms the plain product is the more accurate on some rows:
// chip_smoke.py --path-sweep finds the tile product past twice plain's
// error at n up to 456.  Here a product of two f32 is exact in f64 (48 of
// 53 bits), the sum of at most 16384 such terms in f64 lies far inside an
// f32 ulp of the exact sum, and the epilogue runs in f64 too, so each
// element is the exact result rounded once (but for a double rounding at
// a near tie): no f32 result lies nearer, so its error is at most the
// plain product's, element by element, on any data.
//
// The arithmetic of an element, the same in every build and at every M:
// a chain of mma.sync m16n8k16 f64 (the f64 tensor cores, 67 TFLOP/s on an
// H100 SXM, NVIDIA's data sheet) over the k16 steps in ascending k from a
// zero accumulator, each lane holding the same k in the same fragment
// register, then the epilogue.  Steps wholly past K are skipped; they
// would add exact zeros.  So the tile shape, the warp tile, the k-chunk,
// the ring's depth and the copies do not move a bit: a row's result
// depends on that row alone (chip_smoke and the cuda tests launch
// rows at shifted offsets, and --kernel-ab holds the bits to those of
// the path's first version).
//
// How (PERF.md has the measurements behind each point):
//   * Both operands stay f32 in memory and in shared memory and are
//     widened, exactly, as a warp loads its fragments.  Widening costs
//     next to nothing on this card (mma.sync f64 from registers runs at
//     the same rate with up to 4 conversions a mma a lane); an f64 copy of
//     the table would double the bytes the copies move, and the copies
//     bound the kernel as much as the mma do (tools/f64_lab.py).
//   * Copies are 16-byte cp.async: a's rows at any pitch and base by the
//     aligned 16-byte blocks that hold them (a row lands at its shift in
//     its stage row, and the fragment loads add the shift), the table at
//     its padded pitch; the input is never copied to a padded pitch.
//   * Two builds (Config), a block a tile of 4 warps, none spilling: 16
//     rows by 64 columns in k-chunks of 64 through 3 stages of dynamic
//     shared memory, 3 blocks an SM, for a few hundred rows or fewer (a
//     lone tile's chain is shorter), and 32 x 64 in k-chunks of 32 through
//     4 stages, 4 blocks an SM, above; ops/kernels.py::f64_plan picks one
//     by a model of measured unit times (F64_UNIT_US).  Tiles of 64 and
//     128 rows read fewer bytes a flop but held fewer warps an SM or
//     spilled, and came within 4% of these at best (tools/f64_lab.py).
//
// What bounds it: at n = 441 and M = 8192 the MDCT's 8192 x 441 x 882
// terms are 6.4 G f64 flops, 0.095 ms at the f64 tensor-core rate.  Each
// 32 x 64 tile reads its rows of a and its columns of the table from L2,
// 607 MB in all: those copies alone take 0.153 ms, the shared-memory and
// tensor-core path alone (no copies after the ring's first stages) 0.126
// ms, the two together 0.160 ms on an H100 SXM (tools/f64_lab.py).

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace f64rows {

// What a build leaves out: nothing in every build the wrappers launch; the
// copies after the ring's first stages, or the mma, in the variants that
// tools/f64_lab.py times to see what bounds the kernel.
enum Probe { WHOLE, NO_LOADS, NO_MMA };

// One build: WARPS_M x WARPS_N warps, each a WM x WN warp tile of TM x TN
// mma tiles of 16 x 8; a block tile of BM = WARPS_M * WM rows by
// BN = WARPS_N * WN columns; k-chunks of BK through STAGES ring buffers;
// MIN_BLOCKS blocks an SM asked of the register allocator.
template <int WARPS_M_, int WARPS_N_, int WM_, int WN_, int BK_, int STAGES_,
          int MIN_BLOCKS_, Probe PROBE_ = WHOLE>
struct Config {
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int WM = WM_, WN = WN_, BK = BK_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr Probe PROBE = PROBE_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int BM = WARPS_M * WM, BN = WARPS_N * WN;
  static constexpr int TM = WM / 16, TN = WN / 8;
  // Pitches (floats) that make the fragment loads conflict-free: a lane
  // (g, t) reads a at row g, column t and b at row t, column g.
  static constexpr int A_PITCH = BK + 4;
  static constexpr int B_PITCH = BN + 8;
  static constexpr int B_BYTES = BK * B_PITCH * 4;
  static constexpr int A_BYTES = BM * A_PITCH * 4;
  static constexpr int STAGE_BYTES = B_BYTES + A_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % 16 == 0, "mma shape");
  static_assert(STAGES >= 2 && STAGE_BYTES % 16 == 0, "ring");
};

// A 16-byte cp.async from src to shared dst, of which the first src_bytes
// are read and the rest written as zeros.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a * b for one 16 x 8 x 16 f64 mma.  This lane holds A's elements
// (row g + 8 (i % 2), k t + 4 (i / 2)) for i < 8, B's (k t + 4 i, column
// g) for i < 4 and d's (row g + 8 (i / 2), column 2 t + i % 2), with
// g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[8],
                                        const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// The floats by which a[m, 0] lies past a 16-byte boundary (a's rows are
// copied by the 16-byte blocks that hold them; k0 is a multiple of 4).
__device__ __forceinline__ int shift_of(const float* a, int lda, int m) {
  const int base = static_cast<int>(reinterpret_cast<uintptr_t>(a) >> 2);
  return (base + (m & 3) * (lda & 3)) & 3;
}

// Starts the copies of chunk k0 of rows m0.. of a and of columns n0.. of b
// into one ring stage, 16 bytes a copy.  A row of a lands at its shift
// (shift_of) in its stage row: its chunk's BK floats lie in BK / 4 + 1
// aligned blocks, read up to k = K.  Rows past M, k past K and columns
// past ldb are written as zeros (the floats of a block before k0, or
// before a row's start, are read but never used).
template <class C>
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const float* a, int lda,
                                           const float* b, int ldb,
                                           int M, int K, int m0, int n0,
                                           int k0) {
  float* bs = reinterpret_cast<float*>(stage);
  float* as = reinterpret_cast<float*>(stage + C::B_BYTES);
  constexpr int B_COPIES = C::BN / 4;  // a row of the chunk of b
  constexpr int B_ALL = C::BK * B_COPIES;
#pragma unroll
  for (int it = 0; it < (B_ALL + C::THREADS - 1) / C::THREADS; ++it) {
    const int i = threadIdx.x + it * C::THREADS;
    if (B_ALL % C::THREADS != 0 && i >= B_ALL) break;
    const int k = i / B_COPIES, v = i % B_COPIES;
    const int kk = k0 + k, j = n0 + 4 * v;
    const bool ok = kk < K && j < ldb;  // ldb % 4 == 0: in or out
    copy16(bs + k * C::B_PITCH + 4 * v,
           ok ? b + static_cast<size_t>(kk) * ldb + j : b, ok ? 16 : 0);
  }
  constexpr int A_COPIES = C::BK / 4 + 1;  // a row of the chunk of a
  constexpr int A_ALL = C::BM * A_COPIES;
  // the 16-byte aligned address a copy that reads nothing names
  const auto* none = reinterpret_cast<const float*>(
      reinterpret_cast<uintptr_t>(a) & ~uintptr_t{15});
  // Neighbouring threads copy neighbouring blocks of a row (the copies ran
  // slower with a thread a row).
#pragma unroll
  for (int it = 0; it < (A_ALL + C::THREADS - 1) / C::THREADS; ++it) {
    const int i = threadIdx.x + it * C::THREADS;
    if (A_ALL % C::THREADS != 0 && i >= A_ALL) break;
    const int r = i / A_COPIES, v = i % A_COPIES;
    const int m = m0 + r;
    const float* src = none;
    int left = 0;
    if (m < M) {
      const float* at = a + static_cast<size_t>(m) * lda + k0;
      const int kb = k0 - shift_of(a, lda, m) + 4 * v;  // the block's first k
      left = min(max(K - kb, 0), 4);
      src = reinterpret_cast<const float*>(
          (reinterpret_cast<uintptr_t>(at) & ~uintptr_t{15}) + 16 * v);
    }
    copy16(as + r * C::A_PITCH + 4 * v, left ? src : none, 4 * left);
  }
}

// acc += this warp's rows of the stage's a times its b, over the chunk's
// first `steps` k16 steps (all BK / 16 of them where FULL); shift[i][h]
// is the stage shift of the lane's row g + 16 i + 8 h.
template <class C, bool FULL>
__device__ __forceinline__ void multiply(const unsigned char* stage, int steps,
                                         const int (&shift)[C::TM][2],
                                         double (&acc)[C::TM][C::TN][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / C::WARPS_N * C::WM, wn = warp % C::WARPS_N * C::WN;
  const float* bs = reinterpret_cast<const float*>(stage) + wn + g;
  const float* as = reinterpret_cast<const float*>(stage + C::B_BYTES) +
                    (wm + g) * C::A_PITCH + t;
#pragma unroll
  for (int s = 0; s < C::BK / 16; ++s) {
    if (FULL || s < steps) {
      double af[C::TM][8];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          af[i][e] = static_cast<double>(
              as[(16 * i + 8 * (e % 2)) * C::A_PITCH + shift[i][e % 2] +
                 16 * s + 4 * (e / 2)]);
        }
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        double bf[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bf[e] = static_cast<double>(
              bs[(16 * s + t + 4 * e) * C::B_PITCH + 8 * j]);
        }
#pragma unroll
        for (int i = 0; i < C::TM; ++i) mma_f64(acc[i][j], af[i], bf);
      }
    }
  }
}

// out[m, j] = epilogue(sum over ascending k of a[m, k] * b[k, j] in f64, j)
// for m < M, j < N; out is contiguous [M, N].  Block x takes tile x of the
// ceil(M / BM) x ceil(N / BN) tiles, columns fastest.
template <class C, typename Epilogue>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
rows_kernel(const float* __restrict__ a, int lda, const float* __restrict__ b,
            int ldb, float* __restrict__ out, int M, int N, int K,
            Epilogue epilogue) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int tiles_n = (N + C::BN - 1) / C::BN;
  const int m0 = static_cast<int>(blockIdx.x) / tiles_n * C::BM;
  const int n0 = static_cast<int>(blockIdx.x) % tiles_n * C::BN;
  const int chunks = (K + C::BK - 1) / C::BK;
  auto load = [&](int c) {
    if (c < chunks) {
      load_stage<C>(ring + (c % C::STAGES) * C::STAGE_BYTES, a, lda, b, ldb,
                    M, K, m0, n0, c * C::BK);
    }
    commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int c = 0; c < C::STAGES - 1; ++c) load(c);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = m0 + warp / C::WARPS_N * C::WM + g;
  const int col0 = n0 + warp % C::WARPS_N * C::WN + 2 * t;
  double acc[C::TM][C::TN][4];
  int shift[C::TM][2];  // the stage shifts of this lane's rows of a
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      shift[i][h] = shift_of(a, lda, row0 + 16 * i + 8 * h);
    }
#pragma unroll
    for (int j = 0; j < C::TN; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0.0;
  }
  for (int c = 0; c < chunks; ++c) {
    wait_groups<C::STAGES - 2>();
    __syncthreads();  // this stage landed; the one loaded next is free
    if (C::PROBE == NO_LOADS) {
      commit();
    } else {
      load(c + C::STAGES - 1);
    }
    const unsigned char* stage = ring + (c % C::STAGES) * C::STAGE_BYTES;
    const int left = K - c * C::BK;
    if (C::PROBE == NO_MMA) continue;
    if (left >= C::BK) {
      multiply<C, true>(stage, C::BK / 16, shift, acc);
    } else {
      multiply<C, false>(stage, (left + 15) / 16, shift, acc);
    }
  }
  wait_groups<0>();
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = row0 + 16 * i + 8 * hr;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < C::TN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = col0 + 8 * j + h;
          if (col < N) {
            out[static_cast<size_t>(m) * N + col] =
                epilogue(acc[i][j][2 * hr + h], col);
          }
        }
    }
}

// rows_kernel<C, Epilogue>, with its dynamic shared memory limit raised to
// C::SMEM once a device.
template <class C, typename Epilogue>
cudaError_t kernel_of(void (**kernel)(const float*, int, const float*, int,
                                      float*, int, int, int, Epilogue)) {
  static bool raised[64] = {};
  *kernel = rows_kernel<C, Epilogue>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!raised[device]) {
    err = cudaFuncSetAttribute(*kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  return cudaSuccess;
}

// Launches rows_kernel<C>, a block a tile, on `stream`; returns a
// cudaError_t as an int: cudaErrorInvalidValue for more than INT_MAX
// tiles, an a that is not 4-byte aligned or a b that is not 16-byte
// aligned with ldb >= N a multiple of 4.
template <class C, typename Epilogue>
int launch(const float* a, int lda, const float* b, int ldb, float* out,
           int M, int N, int K, Epilogue epilogue, cudaStream_t stream) {
  const long long tiles = static_cast<long long>((M + C::BM - 1) / C::BM) *
                          ((N + C::BN - 1) / C::BN);
  if (tiles > INT_MAX || reinterpret_cast<uintptr_t>(a) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 || ldb % 4 != 0 || ldb < N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kernel)(const float*, int, const float*, int, float*, int, int, int,
                 Epilogue) = nullptr;
  const cudaError_t err = kernel_of<C>(&kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(tiles), C::THREADS, C::SMEM, stream>>>(
      a, lda, b, ldb, out, M, N, K, epilogue);
  return static_cast<int>(cudaGetLastError());
}

// What the build made of rows_kernel<C>: info[0..7] = registers a thread,
// local (spill) bytes a thread, static and dynamic shared memory bytes a
// block, ring stages, blocks resident on an SM, and the block tile's rows
// and columns.  Returns a cudaError_t as an int.
template <class C, typename Epilogue>
int info_of(int* info) {
  void (*kernel)(const float*, int, const float*, int, float*, int, int, int,
                 Epilogue) = nullptr;
  cudaError_t err = kernel_of<C>(&kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      C::THREADS, C::SMEM);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = C::SMEM;
  info[4] = C::STAGES;
  info[5] = blocks;
  info[6] = C::BM;
  info[7] = C::BN;
  return static_cast<int>(err);
}

// The builds the plans choose among, by their block tile (rows x 64;
// ops/kernels.py::F64_TILES, with the blocks an SM holds as F64_RESIDENT).
using Tile16 = Config<1, 4, 16, 16, 64, 3, 3>;  // 4 warps of 16 x 16
using Tile32 = Config<2, 2, 16, 32, 32, 4, 4>;  // 4 warps of 16 x 32

// Calls Fn::template run<Tile>(args...) for the build of block tile
// rows x cols; cudaErrorInvalidValue for any other.
template <class Fn, typename... Args>
int dispatch(int rows, int cols, Args... args) {
  if (cols != 64) return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 16: return Fn::template run<Tile16>(args...);
    case 32: return Fn::template run<Tile32>(args...);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

struct Launch {
  template <class C, typename Epilogue>
  static int run(const float* a, int lda, const float* b, int ldb, float* out,
                 int M, int N, int K, Epilogue epilogue,
                 cudaStream_t stream) {
    return launch<C>(a, lda, b, ldb, out, M, N, K, epilogue, stream);
  }
};

template <typename Epilogue>
struct Info {
  template <class C>
  static int run(int* info) { return info_of<C, Epilogue>(info); }
};

}  // namespace f64rows
