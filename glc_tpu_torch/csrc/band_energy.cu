// The band sums of squares of the masking model, for NVIDIA Hopper (sm_90a):
//
//     out[m, b] = sum over k in [lo_b, hi_b) of coeffs[m, k]^2
//
// for coeffs [M, n] f32 and a band mask [bands, n] whose rows are contiguous
// runs of ones (reference src/codec.rs:186-240).  Not the port of a Pallas
// kernel: it replaces the XLA einsum of glc_tpu/ops/psycho.py:155,
// (coeffs * coeffs) @ band_mask.T, which the port first ran as one cuBLAS
// product; cuBLAS picks its kernel by the product's shape, so a row's sums
// rounded differently at different row counts.  Here a row's bits depend on
// that row and the band plan alone: one warp takes a whole row, whichever
// warp and block that is, whatever M is; no atomics, no split of a row.
//
// The plan (ops/kernels.py::band_plan, made once per mask on the host) cuts
// each band into work items of BAND_CHUNK = 33 consecutive bins counted from
// its lo (the last one shorter), and gives the items to the 32 lanes so that
// each lane sums about as many bins (longest item first, to the lane with
// the fewest bins).  Arithmetic, in a fixed order a numpy model repeats bit
// for bit (tests/test_torch_encode_kernels.py::band_energy_model):
//   1. an item is a compensated in-order sum: each square and each add
//      rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn: nvcc cannot
//      contract them into FMAs), the rounding error of each add found
//      exactly by TwoSum and summed beside it, giving a pair (s, e);
//   2. a band of several items folds their pairs in ascending item order:
//      e_i added to E, then s_i to S by TwoSum, its error added to E; the
//      band is S + E, or S where S is +Inf (a finite sum that overflowed).
//      A band of <= 33 bins is one item, the sum of the earlier one-thread-a-
//      band kernel bit for bit: 49 of the 50 bands at 44.1 and 48 kHz;
//   3. a row with a NaN or Inf square gets the einsum's pattern, where a
//      bin outside a band adds x * 0: a band is +Inf if every non-finite
//      square of the row lies in it and none is NaN, else NaN.  The plan's
//      items cover every bin (bins no band holds get items of their own that
//      feed no band), so a non-finite square always leaves some item's s
//      non-finite; only such a row pays for a scan of its squares.
//
// What bounds it on this card: it reads 4*M*n bytes and writes 4*M*bands;
// about 10 f32 operations a bin are well under the CUDA cores' rate, so the
// bytes bound it: 0.0106 ms at M = 8192 at 3.35 TB/s.  What the design does
// about that: every lane works (the earlier kernel summed the 653-bin top
// band in one thread while 31 lanes idled); each warp streams rows through
// two shared-memory buffers with 16-byte cp.async copies, the next row's
// copy in flight while this one is summed; the grid is sized to the card
// (blocks a SM by occupancy, rows by a grid-stride loop), so every SM keeps
// its warps' copies in flight.  33, not 32, bins an item: the items of a wide
// band start 33 bins apart, so the lanes that sum them in step read 32
// different shared-memory banks.
//
// Called through the plain C entry glc_band_energy below.

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
constexpr int WARPS = 4;           // rows in flight a block, one a warp
constexpr int THREADS = WARPS * LANES;
constexpr int STAGES = 2;          // row buffers a warp
constexpr int MAX_ITEMS = 192;     // work items a plan may hold
constexpr int PLAN_CAP = 1024;     // ints a plan may hold
constexpr unsigned FULL = 0xffffffffu;

// One compensated add: s + x == t + e exactly (TwoSum); e is added to err
// and s becomes t.
__device__ __forceinline__ void two_sum_add(float& s, float& err, float x) {
  const float t = __fadd_rn(s, x);
  const float xv = __fsub_rn(t, s);
  const float e = __fadd_rn(__fsub_rn(s, __fsub_rn(t, xv)), __fsub_rn(x, xv));
  err = __fadd_rn(err, e);
  s = t;
}

// The warp's copy of one row (n floats, 16-byte aligned) into shared memory:
// 16 bytes a lane a copy, neighbouring lanes on neighbouring addresses.
__device__ __forceinline__ void copy_row_async(float* dst, const float* src,
                                               int n, int lane) {
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  for (int q = lane; q < n / 4; q += LANES) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(base + 16u * q), "l"(src + 4 * q) : "memory");
  }
}

__global__ void __launch_bounds__(THREADS)
band_energy_kernel(const float* __restrict__ coeffs,  // [M, n]
                   const int* __restrict__ plan_g,    // the plan, plan_len ints
                   float* __restrict__ out,           // [M, bands]
                   int M, int n, int bands, int items, int plan_len) {
  __shared__ int plan[PLAN_CAP];
  __shared__ float2 pairs_of[WARPS][MAX_ITEMS];  // each item's (s, e)
  extern __shared__ float4 rows4[];              // [WARPS][STAGES][n]

  for (int i = threadIdx.x; i < plan_len; i += THREADS) plan[i] = plan_g[i];
  __syncthreads();
  // the plan's layout (ops/kernels.py::band_plan)
  const int* item_lo = plan;
  const int* item_hi = item_lo + items;
  const int* order = item_hi + items;           // the items, lane by lane
  const int* lane_first = order + items;        // [LANES + 1] into order
  const int* lane_bins = lane_first + LANES + 1;
  const int* band_first = lane_bins + LANES;    // [bands + 1] into the items
  const int* band_lo = band_first + bands + 1;
  const int* band_hi = band_lo + bands;

  const int warp = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  float2* pairs = pairs_of[warp];
  float* buf = reinterpret_cast<float*>(rows4) +
               static_cast<size_t>(warp) * STAGES * n;
  const int stride = gridDim.x * WARPS;
  const int first = lane_first[lane], last = lane_first[lane + 1];
  const int bins = lane_bins[lane];

  int m = blockIdx.x * WARPS + warp;
  if (m < M) copy_row_async(buf, coeffs + static_cast<size_t>(m) * n, n, lane);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int it = 0; m < M; ++it, m += stride) {
    const int next = m + stride;
    if (next < M) {
      copy_row_async(buf + ((it + 1) % STAGES) * n,
                     coeffs + static_cast<size_t>(next) * n, n, lane);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this row's copy
    __syncwarp();
    const float* row = buf + (it % STAGES) * n;

    // 1. the lane's items, one bin a step, the items back to back
    int p = first, item = 0, k = 0, end = 0;
    if (p < last) { item = order[p]; k = item_lo[item]; end = item_hi[item]; }
    float s = 0.f, err = 0.f;
    bool odd = false;  // an item of this lane ended non-finite
    for (int step = 0; step < bins; ++step) {
      const float c = row[k];
      two_sum_add(s, err, __fmul_rn(c, c));
      if (++k == end) {
        pairs[item] = make_float2(s, err);
        odd |= !(s <= FLT_MAX);
        s = 0.f;
        err = 0.f;
        if (++p < last) { item = order[p]; k = item_lo[item]; end = item_hi[item]; }
      }
    }
    __syncwarp();

    // 2. a row with a non-finite item: where its non-finite squares lie
    int bad_lo = INT_MAX, bad_hi = -1;
    unsigned nan = 0;
    if (__any_sync(FULL, odd)) {
      for (int q = lane; q < n; q += LANES) {
        const float x = __fmul_rn(row[q], row[q]);
        if (!(x <= FLT_MAX)) {
          bad_lo = min(bad_lo, q);
          bad_hi = max(bad_hi, q);
          nan |= (x != x);
        }
      }
      bad_lo = __reduce_min_sync(FULL, bad_lo);
      bad_hi = __reduce_max_sync(FULL, bad_hi);
      nan = __reduce_or_sync(FULL, nan);
    }

    // 3. each band's items folded in ascending order, a lane a band
    float* dst = out + static_cast<size_t>(m) * bands;
    for (int b = lane; b < bands; b += LANES) {
      const int i0 = band_first[b], i1 = band_first[b + 1];
      float S = 0.f, E = 0.f;
      if (i0 < i1) { S = pairs[i0].x; E = pairs[i0].y; }
      for (int i = i0 + 1; i < i1; ++i) {
        const float2 pr = pairs[i];
        E = __fadd_rn(E, pr.y);
        two_sum_add(S, E, pr.x);
      }
      float v = isinf(S) ? S : __fadd_rn(S, E);
      if (bad_hi >= 0) {
        v = (!nan && bad_lo >= band_lo[b] && bad_hi < band_hi[b])
                ? __int_as_float(0x7f800000) : __int_as_float(0x7fffffff);
      }
      dst[b] = v;
    }
    __syncwarp();  // the row buffer and the pairs are free again
  }
}

constexpr int MAX_DEVICES = 64;
int g_grid_cap[MAX_DEVICES];   // blocks the card holds at once, by device
int g_grid_cap_n[MAX_DEVICES];  // the n that g_grid_cap was found for

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns a cudaError_t
// as an int: 0 on success.  coeffs, plan and out are device pointers to
// contiguous arrays, coeffs [M, n] 16-byte aligned with n a multiple of 4,
// plan the int32 table of ops/kernels.py::band_plan (plan_len ints: `items`
// work items, each of >= 1 bin within [0, n), lanes summing them, `bands`
// bands with their item spans and bin ranges), out [M, bands].
extern "C" int glc_band_energy(const float* coeffs, const int* plan, float* out,
                               int M, int n, int bands, int items, int plan_len,
                               void* stream) {
  const size_t smem = static_cast<size_t>(WARPS) * STAGES * n * sizeof(float);
  if (M < 0 || n <= 0 || n % 4 != 0 || bands <= 0 || items < 0 ||
      items > MAX_ITEMS || plan_len > PLAN_CAP ||
      plan_len != 3 * items + 2 * LANES + 1 + 3 * bands + 1 ||
      smem > 200 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_grid_cap_n[dev] != n) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(band_energy_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, band_energy_kernel, THREADS, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    g_grid_cap[dev] = sms * (per_sm > 0 ? per_sm : 1);
    g_grid_cap_n[dev] = n;
  }
  const int wanted = (M + WARPS - 1) / WARPS;
  const int grid = wanted < g_grid_cap[dev] ? wanted : g_grid_cap[dev];
  band_energy_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      coeffs, plan, out, M, n, bands, items, plan_len);
  return static_cast<int>(cudaGetLastError());
}

// What the build made of the kernel: info[0..4] = registers a thread, local
// (spill) bytes a thread, static shared memory a block (the plan and each
// warp's item pairs), dynamic shared memory a block for n = 1024 (each
// warp's row buffers), pipeline stages (row buffers a warp).  Returns a
// cudaError_t as an int.
extern "C" int glc_band_energy_info(int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, band_energy_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = WARPS * STAGES * 1024 * static_cast<int>(sizeof(float));
  info[4] = STAGES;
  return 0;
}
