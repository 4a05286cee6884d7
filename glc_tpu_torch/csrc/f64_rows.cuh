// The f64 path of the port's two f32 matrix kernels on NVIDIA Hopper:
// mdct_rows.cu and imdct_window.cu take it at the n (the hop size) where
// the 3xTF32 tile product of tf32x3.cuh fails the bar they are held to,
// an error against float64 no more than twice the plain f32 product's
// (at most ops/kernels.py::_F64_MAX_N, which the wrappers read).  There
// they compute
//
//     out[m, j] = epilogue(sum_k a[m, k] * b[j, k], j)
//
// for a row-major a [M, K] (rows lda floats apart) and b given by its
// strides (element (j, k) at b[j * sbj + k * sbk]), with every product and
// sum in f64 and one rounding to f32 at the end.
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
// How: on the f64 tensor cores (mma.sync m16n8k16 f64, 67 TFLOP/s on an
// H100 SXM, NVIDIA's data sheet).  A block of 4 warps takes a 64 x 64
// tile of out; each warp a 32 x 32 quarter, 2 x 4 mma tiles of 16 x 8.
// The k-loop runs in chunks of BK = 32 floats of its 64 rows of a and 64
// columns of b, copied by 4-byte cp.async (any alignment; past M, N or K
// the copy writes zeros) into one of two shared-memory buffers while the
// warps multiply the other; each float is widened to f64 (exactly) as the
// warps load their fragments.  Past M and N nothing is stored.  An
// element's sum runs over the same mma in ascending k, whatever M and
// wherever its row lies in its tile, so a row's bits do not depend on M
// (chip_smoke and the cuda tests launch rows at shifted offsets).
//
// What bounds it: at n = 441 and M = 8192 the MDCT's 8192 x 441 x 882
// terms are 6.4 G f64 flops, 0.095 ms at the f64 tensor-core rate.  Two
// earlier designs took 0.84 ms there (one thread a column on the f64
// CUDA cores) and 0.64 ms (m8n8k4, f64 staging without the copy
// pipeline; chip_smoke.py's product_paths, NVIDIA H100 80GB HBM3, 700 W).

#pragma once

#include <cuda_runtime.h>

namespace f64rows {

constexpr int BM = 64, BN = 64, BK = 32;  // the block's tile and k-chunk
constexpr int THREADS = 128;              // 4 warps, 2 x 2, 32 x 32 each
constexpr int TM = 2, TN = 4;             // a warp's 16 x 8 mma tiles
constexpr int A_PITCH = BK + 4;           // floats: conflict-free fragment
constexpr int B_PITCH = BN + 8;           // loads of both operands
constexpr int MAX_ROW_TILES = 65535;

// A 4-byte cp.async of *src into shared memory at dst, or zeros when !ok.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
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

// Starts the copies of chunk k0 of rows m0.. of a and columns n0.. of b
// into `as` and `bs`, as one cp.async group.
__device__ __forceinline__ void stage(float (&as)[BM][A_PITCH],
                                      float (&bs)[BK][B_PITCH], const float* a,
                                      int lda, const float* b, long long sbj,
                                      long long sbk, int M, int N, int K,
                                      int m0, int n0, int k0) {
  for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
    const int r = i / BK, k = i % BK;  // a warp on one row's k
    const int m = m0 + r, kk = k0 + k;
    const bool ok = m < M && kk < K;
    copy4(&as[r][k], a + (ok ? static_cast<size_t>(m) * lda + kk : 0), ok);
  }
  for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
    const int k = i / BN, c = i % BN;  // a warp on neighbouring columns
    const int j = n0 + c, kk = k0 + k;
    const bool ok = j < N && kk < K;
    copy4(&bs[k][c], b + (ok ? j * sbj + kk * sbk : 0), ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// out[m, j] = epilogue(sum over ascending k of a[m, k] * b[j, k] in f64, j)
// for m < M, j < N; out is contiguous [M, N].  Block (x, y) takes the
// column tile x and the row tiles y, y + gridDim.y, ...
template <typename Epilogue>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const float* __restrict__ a, int lda, const float* __restrict__ b,
            long long sbj, long long sbk, float* __restrict__ out, int M, int N,
            int K, Epilogue epilogue) {
  __shared__ float as[2][BM][A_PITCH];  // as[.][r][k] = a[m0 + r, k0 + k]
  __shared__ float bs[2][BK][B_PITCH];  // bs[.][k][c] = b[n0 + c, k0 + k]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int n0 = blockIdx.x * BN;
  const int chunks = (K + BK - 1) / BK;
  for (int m0 = blockIdx.y * BM; m0 < M; m0 += gridDim.y * BM) {
    double acc[TM][TN][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[i][j][h] = 0.0;
    __syncthreads();  // the last row tile's reads are done
    stage(as[0], bs[0], a, lda, b, sbj, sbk, M, N, K, m0, n0, 0);
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        stage(as[(c + 1) & 1], bs[(c + 1) & 1], a, lda, b, sbj, sbk, M, N, K,
              m0, n0, (c + 1) * BK);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      const auto& ab = as[c & 1];
      const auto& bb = bs[c & 1];
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        double af[TM][8], bf[TN][4];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            af[i][e] = static_cast<double>(
                ab[wm + 16 * i + g + 8 * (e % 2)][ks + t + 4 * (e / 2)]);
          }
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bf[j][e] = static_cast<double>(bb[ks + t + 4 * e][wn + 8 * j + g]);
          }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) mma_f64(acc[i][j], af[i], bf[j]);
      }
      __syncthreads();  // this buffer's reads are done before its next copy
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + wm + 16 * i + g + 8 * hr;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = n0 + wn + 8 * j + 2 * t + h;
            if (col < N) {
              out[static_cast<size_t>(m) * N + col] =
                  epilogue(acc[i][j][2 * hr + h], col);
            }
          }
      }
  }
}

// Launches rows_kernel on `stream`; returns a cudaError_t as an int.
template <typename Epilogue>
int launch(const float* a, int lda, const float* b, long long sbj,
           long long sbk, float* out, int M, int N, int K, Epilogue epilogue,
           cudaStream_t stream) {
  const int row_tiles = (M + BM - 1) / BM;
  const dim3 grid((N + BN - 1) / BN,
                  row_tiles < MAX_ROW_TILES ? row_tiles : MAX_ROW_TILES);
  rows_kernel<<<grid, THREADS, 0, stream>>>(a, lda, b, sbj, sbk, out, M, N, K,
                                            epilogue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f64rows
