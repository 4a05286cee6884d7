// Fused IMDCT + synthesis window for NVIDIA Hopper (sm_90a), fp32 in and out.
//
// Replaces the TPU kernel glc_tpu/ops/pallas_kernels.py::imdct_fused
// (body _imdct_kernel): out[b, t] = ((sum_k coeffs[b, k] * table[k, t]) * norm)
// * window[t], the IMDCT of reference src/codec.rs:376-391 fused with the
// synthesis window of codec.rs:672-675.  The two roundings are kept in that
// order: (acc * norm) * window, never acc * (norm * window).
//
// Shapes: coeffs [B, n] f32, the table split into table_hi / table_lo, each
// [2n, n] f32 (the transposed cos table: tf32 wgmma takes its shared-memory
// operand K-major only), window [2n] f32, out [B, 2n] f32.  Any
// 0 <= B < 65536 * 128 and any 1 <= n <= 8192 (the hop size; the codec's
// default is 1024, a 48 kHz library's 20 ms hop 960, 44.1 kHz's 10 ms 441).
// The ragged edges are masked: rows past B and the k-tail past n read as
// zeros (TMA), columns past 2n are neither read from the window nor
// stored.  coeffs and the table halves have rows of pitch_of(n) floats
// (tf32x3.cuh: n itself where n % 4 == 0), out is contiguous.  Pointers
// 16-byte aligned.  At n = 1024 every column tile is full and the launch
// and the bits are those of the kernel written for that n alone.
//
// What bounds it on this card: 2*B*n*2n flops (11.8 GFLOP at B = 2816,
// n = 1024) against ~35 MB of activations, with the table read from L2: far
// above the ridge, so it is bound by arithmetic.  The 3xTF32 tile product
// of tf32x3.cuh (wgmma fed by TMA, a Fast2Sum carry across k-tiles) does
// 35.4 GFLOP of TF32 at B = 2816 in ~0.135 ms on an H100 SXM at 700 W, ~53%
// of the 495 TFLOP/s peak.  What holds it there: each consumer's split and
// sum work runs between its wgmma batches, and 352 tiles make 2.67 waves,
// paid as 3.  Below ~130 rows only 16-32 blocks run, each its whole
// k-loop, and cuBLAS's GEMV path is faster.
//
// The epilogue runs on the accumulator fragment in registers:
// __fmul_rn(__fmul_rn(acc, norm), window[col]).  Plain grid of 128x128
// tiles, one block per SM (192 KB of shared memory): 352 tiles, 2.67 waves
// on 132 SMs at B = 2816.  BN = 256 would need 128 accumulator plus 128 sum
// registers a thread.
//
// Called through the plain C entry glc_imdct_window below.

#include "f64_rows.cuh"
#include "tf32x3.cuh"

using namespace tf32x3;

namespace {

__global__ void __launch_bounds__(THREADS, 1)
imdct_window_kernel(const __grid_constant__ CUtensorMap coeffs_map,  // [B, n]
                    const __grid_constant__ CUtensorMap hi_map,      // [2n, n]
                    const __grid_constant__ CUtensorMap lo_map,      // [2n, n]
                    const float* __restrict__ window,                // [2n]
                    float* __restrict__ out,                         // [B, 2n]
                    int B, int n, float norm) {
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float total[64];
  if (!tile_product(&coeffs_map, &hi_map, &lo_map, n / BK, row0, col0, total)) {
    return;
  }
  // Epilogue: (acc * norm) * window, two roundings, no FMA contraction.
  const int q = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 w =
        *reinterpret_cast<const float2*>(window + col0 + 8 * j + 2 * q);
    total[4 * j + 0] = __fmul_rn(__fmul_rn(total[4 * j + 0], norm), w.x);
    total[4 * j + 1] = __fmul_rn(__fmul_rn(total[4 * j + 1], norm), w.y);
    total[4 * j + 2] = __fmul_rn(__fmul_rn(total[4 * j + 2], norm), w.x);
    total[4 * j + 3] = __fmul_rn(__fmul_rn(total[4 * j + 3], norm), w.y);
  }
  store_tile(total, out, B, 2 * n, row0, col0);
}

// imdct_window_kernel for an n whose 2n is no multiple of BN: the k-tail
// past n reads zeros, the last column tile reaches past 2n, and its
// columns there are neither read from the window nor stored.  Kept apart
// from the full-tile kernel (n a multiple of 64, the codec's default 1024
// among them), whose code and time stay those of the kernel written for
// full tiles alone.  The same arithmetic on every element.
__global__ void __launch_bounds__(THREADS, 1)
imdct_window_ragged_kernel(const __grid_constant__ CUtensorMap coeffs_map,
                           const __grid_constant__ CUtensorMap hi_map,
                           const __grid_constant__ CUtensorMap lo_map,
                           const float* __restrict__ window,
                           float* __restrict__ out, int B, int n, float norm) {
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float total[64];
  const int ktiles = (n + BK - 1) / BK;
  if (!tile_product(&coeffs_map, &hi_map, &lo_map, ktiles, row0, col0, total)) {
    return;
  }
  // Columns come in even pairs and 2n is even: a pair lies below 2n or
  // past it whole.
  const int q = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j + 2 * q;
    const float2 w = col < 2 * n
                         ? *reinterpret_cast<const float2*>(window + col)
                         : make_float2(0.f, 0.f);
    total[4 * j + 0] = __fmul_rn(__fmul_rn(total[4 * j + 0], norm), w.x);
    total[4 * j + 1] = __fmul_rn(__fmul_rn(total[4 * j + 1], norm), w.y);
    total[4 * j + 2] = __fmul_rn(__fmul_rn(total[4 * j + 2], norm), w.x);
    total[4 * j + 3] = __fmul_rn(__fmul_rn(total[4 * j + 3], norm), w.y);
  }
  store_fragment_ragged(total, out, B, 2 * n, row0 + fragment_row(), col0);
}

bool raised[2][64] = {};  // the shared-memory limit, once per build and device

// The f64 path's epilogue: (acc * norm) * window in f64, rounded once.
struct Window {
  float norm;
  const float* window;
  __device__ float operator()(double total, int t) const {
    return __double2float_rn(__dmul_rn(__dmul_rn(total, norm), window[t]));
  }
};

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns a cudaError_t
// as an int: 0 on success, cudaErrorInvalidValue for n outside [1, 8192].
// Pointers must be device pointers, 16-byte aligned, to f32 arrays of the
// shapes and pitches above; table_hi / table_lo are the tf32 split of the
// transposed cos table.
extern "C" int glc_imdct_window(const float* coeffs, const float* table_hi,
                                const float* table_lo, const float* window,
                                float* out, int B, int n, float norm,
                                void* stream) {
  if (B < 0 || n < 1 || n > MAX_N || (B + BM - 1) / BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  CUtensorMap coeffs_map, hi_map, lo_map;
  if (!make_map(&coeffs_map, coeffs, B, n, BM) ||
      !make_map(&hi_map, table_hi, 2 * n, n, BN) ||
      !make_map(&lo_map, table_lo, 2 * n, n, BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool ragged = (2 * n) % BN != 0;
  const auto kernel = ragged ? imdct_window_ragged_kernel : imdct_window_kernel;
  const cudaError_t err = raise_smem_once(kernel, raised[ragged]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((2 * n + BN - 1) / BN, (B + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      coeffs_map, hi_map, lo_map, window, out, B, n, norm);
  return static_cast<int>(cudaGetLastError());
}

// The f64 path (f64_rows.cuh; the wrapper takes it at the n where the tile
// product fails its error bar): out[b, t] = ((coeffs[b] . cos_table[:, t])
// * norm) * window[t] in f64, rounded once to f32.  coeffs [B, n]
// contiguous, any 4-byte alignment; table [n, pitch_of(2n)] the cos table
// itself, zeros right of 2n (ops/kernels.py::f64_table), 16-byte aligned;
// window [2n]; out [B, 2n].  The build of block tile rows x cols
// (ops/kernels.py::f64_plan), a block a tile.  Any 1 <= n <= 8192; returns
// a cudaError_t as an int.
extern "C" int glc_imdct_window_f64(const float* coeffs, const float* table,
                                    const float* window, float* out, int B,
                                    int n, float norm, int rows, int cols,
                                    void* stream) {
  if (B < 0 || n < 1 || n > MAX_N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  return f64rows::dispatch<f64rows::Launch>(
      rows, cols, coeffs, n, table, pitch_of(2 * n), out, B, 2 * n, n,
      Window{norm, window}, static_cast<cudaStream_t>(stream));
}

// What the build of block tile rows x cols made of the f64 path's kernel:
// info[0..7] as f64rows::info_of gives them.  Returns a cudaError_t as an
// int.
extern "C" int glc_imdct_window_f64_info(int rows, int cols, int* info) {
  return f64rows::dispatch<f64rows::Info<Window>>(rows, cols, info);
}

// What the build made of the kernel: info[0..4] = registers a thread, local
// (spill) bytes a thread, static and dynamic shared memory bytes a block,
// pipeline stages.  Returns a cudaError_t as an int.
extern "C" int glc_imdct_window_info(int* info) {
  return kernel_info(imdct_window_kernel, SMEM_BYTES, STAGES, info);
}
