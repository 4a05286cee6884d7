// Fused IMDCT + synthesis window for NVIDIA Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel glc_tpu/ops/pallas_kernels.py::imdct_fused
// (body _imdct_kernel): out[b, t] = ((sum_k coeffs[b, k] * table[k, t]) * norm)
// * window[t], the IMDCT of reference src/codec.rs:376-391 fused with the
// synthesis window of codec.rs:672-675.  The two roundings are kept in that
// order: (acc * norm) * window, never acc * (norm * window).
//
// Shapes: coeffs [B, n] f32, table [n, 2n] f32, window [2n] f32, out [B, 2n]
// f32, any B (the ragged edge is masked).  n must be a multiple of 64, so
// that 2n is a multiple of the 128-column tile; the codec uses n = 1024.
//
// What bounds it on this card: 2*B*n*2n flops against about
// 4*(B*n + B*2n) bytes of activations (the 8 MB table is re-read from L2,
// where it fits in the 50 MB), i.e. ~340 flops per byte at n = 1024 — far
// above the ~20 flops per byte at which fp32 CUDA-core math (67 TFLOP/s)
// outruns HBM (3.35 TB/s).  It is compute-bound on fp32 FMA.
//
// Design.  The TPU kernel kept the whole table resident in VMEM and ran a
// 128-row tile through the MXU at Precision.HIGHEST.  A Hopper block has at
// most 227 KB of shared memory, so the product is tiled instead: each block
// owns a 128x128 output tile, each of its 256 threads an 8x8 register
// micro-tile, and the loop over n stages 128x8 slices of coeffs and 8x128
// slices of the table through shared memory.  Accumulation is fp32 FMA on
// the CUDA cores — TF32 tensor cores would break the Precision.HIGHEST bar
// (a bf16-class lowering measured 2e-3 error on the TPU).  Each 8-deep
// slice is summed into a partial that is then added to the accumulator, so
// no rounding chain is longer than n/8 + 8 additions.  The norm/window
// epilogue runs in registers before the store.  wgmma, TMA and 3xTF32 are
// left to later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (no --use_fast_math)
// and called through the plain C entry glc_imdct_window below.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 8;    // depth of one shared-memory slice
constexpr int TM = 8;    // rows per thread
constexpr int TN = 8;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

static_assert(BM * BK == THREADS * 4, "one float4 of coeffs per thread");
static_assert(BK * BN == THREADS * 4, "one float4 of the table per thread");

__global__ void __launch_bounds__(THREADS)
imdct_window_kernel(const float* __restrict__ coeffs,  // [B, n]
                    const float* __restrict__ table,   // [n, 2n]
                    const float* __restrict__ window,  // [2n]
                    float* __restrict__ out,           // [B, 2n]
                    int B, int n, float norm) {
  const int N = 2 * n;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN);  // micro-tile row, 0..15
  const int tx = tid % (BN / TN);  // micro-tile column, 0..15

  __shared__ __align__(16) float As[BK][BM];  // coeffs slice, transposed
  __shared__ __align__(16) float Bs[BK][BN];  // table slice

  // Loader coordinates: each thread moves one float4 of each slice.
  const int a_row = tid / (BK / 4);       // 0..127
  const int a_k = (tid % (BK / 4)) * 4;   // 0 or 4
  const bool a_live = row0 + a_row < B;
  const float* a_src =
      coeffs + (size_t)min(row0 + a_row, B - 1) * n + a_k;
  const int b_k = tid / (BN / 4);         // 0..7
  const int b_col = (tid % (BN / 4)) * 4; // 0..124
  const float* b_src = table + (size_t)b_k * N + col0 + b_col;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    const float4 a = a_live ? *reinterpret_cast<const float4*>(a_src + k0)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    As[a_k + 0][a_row] = a.x;
    As[a_k + 1][a_row] = a.y;
    As[a_k + 2][a_row] = a.z;
    As[a_k + 3][a_row] = a.w;
    *reinterpret_cast<float4*>(&Bs[b_k][b_col]) =
        *reinterpret_cast<const float4*>(b_src + (size_t)k0 * N);
    __syncthreads();

    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float am[TM], bn[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN + 4]);
      am[0] = a0.x; am[1] = a0.y; am[2] = a0.z; am[3] = a0.w;
      am[4] = a1.x; am[5] = a1.y; am[6] = a1.z; am[7] = a1.w;
      bn[0] = b0.x; bn[1] = b0.y; bn[2] = b0.z; bn[3] = b0.w;
      bn[4] = b1.x; bn[5] = b1.y; bn[6] = b1.z; bn[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(am[i], bn[j], part[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    __syncthreads();
  }

  // Epilogue: (acc * norm) * window, two roundings, no FMA contraction.
  const int col = col0 + tx * TN;
  const float4 w0 = *reinterpret_cast<const float4*>(window + col);
  const float4 w1 = *reinterpret_cast<const float4*>(window + col + 4);
  const float w[TN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty * TM + i;
    if (row >= B) break;
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) v[j] = __fmul_rn(__fmul_rn(acc[i][j], norm), w[j]);
    float* dst = out + (size_t)row * N + col;
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError() as an int: 0 on success.  Pointers must be device
// pointers, 16-byte aligned, to contiguous f32 arrays of the shapes above.
extern "C" int glc_imdct_window(const float* coeffs, const float* table,
                                const float* window, float* out, int B, int n,
                                float norm, void* stream) {
  if (B < 0 || n <= 0 || (2 * n) % BN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const dim3 grid((2 * n) / BN, (B + BM - 1) / BM);
  imdct_window_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      coeffs, table, window, out, B, n, norm);
  return static_cast<int>(cudaGetLastError());
}
