// The band sums of squares of the masking model, for NVIDIA Hopper (sm_90a):
//
//     out[m, b] = sum over k in [lo_b, hi_b) of coeffs[m, k]^2
//
// for coeffs [M, n] f32 and the bands' contiguous bin ranges [bands, 2]
// int32 (lo_b == hi_b gives 0: the padding bands).  That is
// (coeffs * coeffs) @ band_mask.T over a 0/1 band-membership matrix whose
// rows are contiguous runs of ones (reference src/codec.rs:186-240).
//
// Not the port of a Pallas kernel: it replaces the XLA einsum of
// glc_tpu/ops/psycho.py:155, which the port first ran as one cuBLAS
// product; cuBLAS picks its kernel by the problem's shape, so a row's sums
// rounded differently at different row counts.  Here each row's sums are
// taken in one fixed order whatever M is: one block a row stages the row in
// shared memory, and one thread a band adds the squares in ascending k.
// Each square and each add is rounded on its own (__fmul_rn, __fadd_rn), so
// nvcc cannot contract them into FMAs, and the adds are compensated (the
// rounding error of each add, found exactly by TwoSum, is summed beside
// it), so the widest band (653 bins at 44.1 kHz) is as accurate as its
// narrowest.
//
// What bounds it on this card: it reads M*n*4 bytes and writes M*bands*4;
// its 2*M*n flops (plus the compensation's) are far below the ridge, so the
// bytes bound it: 0.010 ms at M = 8192 at 3.35 TB/s.  Simple first: one
// thread adds a whole band in sequence, so the widest band sets the
// block's time.
//
// Called through the plain C entry glc_band_energy below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;  // >= the codec's 50 bands

__global__ void __launch_bounds__(THREADS)
band_energy_kernel(const float* __restrict__ coeffs,  // [M, n]
                   const int* __restrict__ ranges,    // [bands, 2]
                   float* __restrict__ out,           // [M, bands]
                   int n, int bands) {
  extern __shared__ float4 row4[];  // the block's row, n floats
  const float* row = reinterpret_cast<const float*>(row4);
  const size_t m = blockIdx.x;
  const float4* src = reinterpret_cast<const float4*>(coeffs + m * n);
  for (int i = threadIdx.x; i < n / 4; i += THREADS) row4[i] = src[i];
  __syncthreads();
  for (int b = threadIdx.x; b < bands; b += THREADS) {
    const int lo = ranges[2 * b];
    const int hi = ranges[2 * b + 1];
    float sum = 0.f, err = 0.f;
    for (int k = lo; k < hi; ++k) {
      const float x = __fmul_rn(row[k], row[k]);
      const float t = __fadd_rn(sum, x);  // TwoSum: sum + x == t + e exactly
      const float xv = __fsub_rn(t, sum);
      const float e = __fadd_rn(__fsub_rn(sum, __fsub_rn(t, xv)), __fsub_rn(x, xv));
      err = __fadd_rn(err, e);
      sum = t;
    }
    out[m * bands + b] = __fadd_rn(sum, err);
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns a cudaError_t
// as an int: 0 on success.  coeffs, ranges and out are device pointers to
// contiguous arrays of the shapes above, coeffs 16-byte aligned, n a
// multiple of 4, every range within [0, n].
extern "C" int glc_band_energy(const float* coeffs, const int* ranges, float* out,
                               int M, int n, int bands, void* stream) {
  if (M < 0 || n <= 0 || n % 4 != 0 || bands <= 0 ||
      static_cast<size_t>(n) * sizeof(float) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  band_energy_kernel<<<M, THREADS, n * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      coeffs, ranges, out, n, bands);
  return static_cast<int>(cudaGetLastError());
}

// What the build made of the kernel: info[0..4] = registers a thread, local
// (spill) bytes a thread, static and dynamic shared memory bytes a block
// (the dynamic one for n = 1024), pipeline stages (none).  Returns a
// cudaError_t as an int.
extern "C" int glc_band_energy_info(int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, band_energy_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = 1024 * static_cast<int>(sizeof(float));
  info[4] = 0;
  return 0;
}
