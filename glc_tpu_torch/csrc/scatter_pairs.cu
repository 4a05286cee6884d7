// The decode's dense q from the container's pair words, for NVIDIA Hopper
// (sm_90a):
//
//     out[r, k] = q of the last pair of row r whose k it is, else 0
//
// for rows r = frame·C + channel of a pass, each row's pairs the int32 words
// words[row_off[r] : row_off[r + 1]], in stream order.  A word is a pair as
// the .glc container stores it (PAIR_DTYPE, little-endian): k in its low 16
// bits (u16), q in its high 16 bits (i16).  A pair with k >= n is dropped
// (reference src/codec.rs:661); among the rest the last pair of a position
// wins (codec.rs:660-663).  A row may hold any number of pairs; a row with
// none is zeros.
//
// Not the port of a Pallas kernel: it replaces none.  The decode's host built
// each chunk's flat positions and values with a numpy pass over every pair
// (widen k, repeat the row index, a range check, a sortedness check, a
// strided copy of q), uploaded 10 bytes a pair and scattered them into a
// zero-filled q.  Here the host uploads the words
// as the container holds them, 4 bytes a pair, and the card expands them.
//
// What bounds it on this card: it reads 4 bytes a pair and 8 a row (the
// offsets) and writes 2·n bytes a row, with a few integer operations a byte:
// the bytes bound it, 4·P + 8·rows + 2·rows·n at 3.35 TB/s.  What the design
// does about that: one block a row; the row's words are read once, coalesced
// (neighbouring threads on neighbouring words); each in-range pair takes
// atomicMax of its index within the row on a shared-memory int32 winner[n]
// set to -1, which gives the last pair of each position whatever order the
// threads run in; after a barrier each position reads its winner's q (a word
// the block has just read, so from L1) or 0, and the dense row goes out in
// 16-byte stores where n % 8 == 0 (2-byte ones otherwise).  Nothing is
// zero-filled first: every element of the output is written once.
//
// Any n from 1 to 8192 (the hop size); winner[] is n ints of dynamic shared
// memory (32 KB at most, under the 48 KB a block has without opting in).
//
// Called through the plain C entry glc_scatter_pairs below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_N = 8192;

// q's 16 bits of the row's pair `i`, or 0 where no pair holds the position
__device__ __forceinline__ unsigned q_bits(const int* row, int i) {
  return i >= 0 ? static_cast<unsigned>(__ldg(row + i)) >> 16 : 0u;
}

__global__ void __launch_bounds__(THREADS)
scatter_pairs_kernel(const int* __restrict__ words,
                     const long long* __restrict__ row_off,
                     short* __restrict__ out, int n) {
  extern __shared__ int4 smem[];
  int* winner = reinterpret_cast<int*>(smem);
  const long long r = blockIdx.x;
  const int tid = threadIdx.x;
  const bool vec = n % 8 == 0;
  if (vec) {
    for (int j = tid; j < n / 4; j += THREADS) smem[j] = make_int4(-1, -1, -1, -1);
  } else {
    for (int j = tid; j < n; j += THREADS) winner[j] = -1;
  }
  const long long begin = __ldg(row_off + r);
  const int count = static_cast<int>(__ldg(row_off + r + 1) - begin);
  const int* row = words + begin;
  __syncthreads();
  for (int i = tid; i < count; i += THREADS) {
    const unsigned k = static_cast<unsigned>(__ldg(row + i)) & 0xFFFFu;
    if (k < static_cast<unsigned>(n)) atomicMax(winner + k, i);
  }
  __syncthreads();
  short* dst = out + r * n;
  if (vec) {
    uint4* dst16 = reinterpret_cast<uint4*>(dst);
    for (int j = tid; j < n / 8; j += THREADS) {
      const int4 a = smem[2 * j], b = smem[2 * j + 1];
      dst16[j] = make_uint4(q_bits(row, a.x) | q_bits(row, a.y) << 16,
                            q_bits(row, a.z) | q_bits(row, a.w) << 16,
                            q_bits(row, b.x) | q_bits(row, b.y) << 16,
                            q_bits(row, b.z) | q_bits(row, b.w) << 16);
    }
  } else {
    for (int j = tid; j < n; j += THREADS) {
      dst[j] = static_cast<short>(q_bits(row, winner[j]));
    }
  }
}

}  // namespace

// q [rows, n] int16 (out, 16-byte aligned) of the words [row_off[rows]]
// int32 and the row offsets row_off [rows + 1] int64 (row_off[0] = 0,
// non-decreasing, each row's count below 2**31), on `stream`.  Any
// 1 <= n <= 8192; returns a cudaError_t as an int.
extern "C" int glc_scatter_pairs(const int* words, const long long* row_off,
                                 short* out, int rows, int n, void* stream) {
  if (rows < 0 || n < 1 || n > MAX_N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  scatter_pairs_kernel<<<rows, THREADS, n * static_cast<int>(sizeof(int)),
                         static_cast<cudaStream_t>(stream)>>>(words, row_off,
                                                              out, n);
  return static_cast<int>(cudaGetLastError());
}

// What the build made of the kernel: info[0..4] = registers a thread, local
// (spill) bytes a thread, static shared memory a block, dynamic shared memory
// a block for n = 1024 (winner[]), stages (1: no pipeline).  Returns a
// cudaError_t as an int.
extern "C" int glc_scatter_pairs_info(int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, scatter_pairs_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = 1024 * static_cast<int>(sizeof(int));
  info[4] = 1;
  return 0;
}
