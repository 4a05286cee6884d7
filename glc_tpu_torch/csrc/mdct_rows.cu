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
// serial bytes.  Here a row's result depends on that row alone: the 3xTF32
// tile product of tf32x3.cuh has no split-k and no reduction that depends
// on M or on the grid, and the ragged edge is masked.
//
// Shapes: win [M, 2n] f32 row-major (contiguous rows), the table split into
// table_hi / table_lo, each [n, 2n] f32 (cos_table itself: it is already
// K-major, the layout tf32 wgmma takes for its shared-memory operand), norm
// one f32 in device memory (read by the epilogue, so that the launch needs
// no host copy of it), out [M, n] f32.  Any 0 <= M < 65536 * 128; n a
// multiple of 128 (the codec's 1024: 8 column tiles, 64 k-tiles of 32).
// Pointers 16-byte aligned.
//
// What bounds it on this card: 2*M*2n*n flops (34.4 GFLOP at M = 8192)
// against 4*(M*2n + 2n*n + M*n) bytes (~109 MB), far above the ridge: bound
// by arithmetic, 0.0694 ms at M = 8192 for the one f32 product at the TF32
// peak (3xTF32 runs three TF32 products).  Against imdct_window, with the
// same flops at the same row count, the k-loop is twice as deep (64 tiles)
// and the grid half as wide (8 column tiles): 512 tiles at M = 8192, 3.9
// waves on 132 SMs.  A 15 s track's segment (1292 rows, 88 tiles) fills
// two thirds of the card and runs one k-loop long; split-k would fill it,
// and is not allowed, because it would make the rounding depend on M.
//
// Epilogue: __fmul_rn(acc, norm), one rounding, as (x @ table.T) * norm.
//
// Called through the plain C entry glc_mdct_rows below.

#include "tf32x3.cuh"

using namespace tf32x3;

namespace {

__global__ void __launch_bounds__(THREADS, 1)
mdct_rows_kernel(const __grid_constant__ CUtensorMap win_map,  // [M, 2n]
                 const __grid_constant__ CUtensorMap hi_map,   // [n, 2n]
                 const __grid_constant__ CUtensorMap lo_map,   // [n, 2n]
                 const float* __restrict__ norm,               // [1]
                 float* __restrict__ out,                      // [M, n]
                 int M, int n) {
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float total[64];
  if (!tile_product(&win_map, &hi_map, &lo_map, (2 * n) / BK, row0, col0, total)) {
    return;
  }
  const float s = *norm;
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = __fmul_rn(total[i], s);
  store_tile(total, out, M, n, row0, col0);
}

bool raised[64] = {};  // the shared-memory limit, raised once per device

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns a cudaError_t
// as an int: 0 on success.  Pointers must be device pointers, 16-byte
// aligned, to contiguous f32 arrays of the shapes above; table_hi / table_lo
// are the tf32 split of the cos table.
extern "C" int glc_mdct_rows(const float* win, const float* table_hi,
                             const float* table_lo, const float* norm,
                             float* out, int M, int n, void* stream) {
  if (M < 0 || n <= 0 || n % BN != 0 || (M + BM - 1) / BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  CUtensorMap win_map, hi_map, lo_map;
  if (!make_map(&win_map, win, M, 2 * n, BM) ||
      !make_map(&hi_map, table_hi, n, 2 * n, BN) ||
      !make_map(&lo_map, table_lo, n, 2 * n, BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = raise_smem_once(mdct_rows_kernel, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / BN, (M + BM - 1) / BM);
  mdct_rows_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      win_map, hi_map, lo_map, norm, out, M, n);
  return static_cast<int>(cudaGetLastError());
}

// What the build made of the kernel: info[0..4] = registers a thread, local
// (spill) bytes a thread, static and dynamic shared memory bytes a block,
// pipeline stages.  Returns a cudaError_t as an int.
extern "C" int glc_mdct_rows_info(int* info) {
  return kernel_info(mdct_rows_kernel, SMEM_BYTES, STAGES, info);
}
