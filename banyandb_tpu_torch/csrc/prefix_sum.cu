// Inclusive i32 prefix sum of a delta column: the Hopper counterpart of
// banyandb_tpu/ops/pallas_kernels.py::prefix_sum_narrow.  With x[0] =
// first and x[1:] = deltas, the output is the decoded series
// (ops/decode.delta_decode).  Exact integer math that wraps mod 2^32,
// like torch.cumsum / jnp.cumsum in i32: every add is done on uint32_t
// (signed overflow is undefined in C++) and the bits are stored back.
//
// The TPU ran its grid in order and carried the running total from tile
// to tile in a revisited [1, 1] output block.  CUDA blocks run in no
// order, so the carry is rebuilt in three launches (reduce, then scan):
//
//   1. tile_totals: one block per 2048-row tile sums its tile;
//   2. scan_totals: one block turns the tile totals, in place, into
//      their exclusive prefix (the carry into each tile), walking them
//      1024 at a time with a running carry;
//   3. scan_tiles: one block per tile scans its tile (8 rows per thread
//      in registers, warp __shfl_up_sync scans of the thread totals, a
//      scan of the 8 warp totals in shared memory) and adds its carry.
//
// Integer addition mod 2^32 is associative, so the result does not
// depend on the order the blocks run in: the same bits on every run and
// on every device.
//
// What bounds it on an H100: bytes.  The least traffic is 4 B read and
// 4 B written per row; at N = 1,048,576 that is 8,388,608 B / 3.35 TB/s
// = 2.50 us.  This design reads x twice (passes 1 and 3), 12 B per row,
// and pays three launches; a single-pass decoupled look-back would
// remove the second read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;               // rows per tile (pallas TILE)
constexpr int kThreads = 256;             // threads per tile block
constexpr int kPer = kTile / kThreads;    // rows per thread: 8
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;        // pass-2 block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load_rows(const int32_t* __restrict__ x,
                                          long long tile, uint32_t (&v)[kPer]) {
  const uint4* p = reinterpret_cast<const uint4*>(
      x + tile * kTile + (long long)threadIdx.x * kPer);
  const uint4 a = p[0];
  const uint4 b = p[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ uint32_t warp_inclusive(uint32_t v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

__device__ __forceinline__ uint32_t warp_total(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Pass 1: totals[t] = sum of tile t (mod 2^32).
__global__ void __launch_bounds__(kThreads)
tile_totals(const int32_t* __restrict__ x, uint32_t* __restrict__ totals) {
  __shared__ uint32_t warp_sums[kWarps];
  uint32_t v[kPer];
  load_rows(x, blockIdx.x, v);
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) s += v[i];
  s = warp_total(s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? warp_sums[lane] : 0u;
    w = warp_total(w);
    if (lane == 0) totals[blockIdx.x] = w;
  }
}

// Pass 2 (one block): totals[t] <- sum of totals[0..t) (exclusive).
__global__ void __launch_bounds__(kScanThreads)
scan_totals(uint32_t* __restrict__ totals, long long tiles) {
  __shared__ uint32_t warp_sums[kScanThreads / 32];
  __shared__ uint32_t chunk_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t carry = 0;
  for (long long base = 0; base < tiles; base += kScanThreads) {
    const long long i = base + threadIdx.x;
    const uint32_t v = i < tiles ? totals[i] : 0u;
    const uint32_t inc = warp_inclusive(v, lane);
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const uint32_t w = warp_inclusive(warp_sums[lane], lane);
      warp_sums[lane] = w;  // inclusive scan of the 32 warp totals
      if (lane == 31) chunk_total = w;
    }
    __syncthreads();
    const uint32_t before = warp > 0 ? warp_sums[warp - 1] : 0u;
    if (i < tiles) totals[i] = carry + before + inc - v;
    carry += chunk_total;
    __syncthreads();  // warp_sums and chunk_total are reused next round
  }
}

// Pass 3: out = inclusive scan of each tile + the carry into the tile.
__global__ void __launch_bounds__(kThreads)
scan_tiles(const int32_t* __restrict__ x, const uint32_t* __restrict__ carry,
           int32_t* __restrict__ out) {
  __shared__ uint32_t warp_sums[kWarps];
  uint32_t v[kPer];
  load_rows(x, blockIdx.x, v);
#pragma unroll
  for (int i = 1; i < kPer; ++i) v[i] += v[i - 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t inc = warp_inclusive(v[kPer - 1], lane);
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? warp_sums[lane] : 0u;
    w = warp_inclusive(w, lane);
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const uint32_t add = carry[blockIdx.x] + (warp > 0 ? warp_sums[warp - 1] : 0u)
                       + inc - v[kPer - 1];
  uint4 a, b;
  a.x = v[0] + add; a.y = v[1] + add; a.z = v[2] + add; a.w = v[3] + add;
  b.x = v[4] + add; b.y = v[5] + add; b.z = v[6] + add; b.w = v[7] + add;
  uint4* o = reinterpret_cast<uint4*>(
      out + (long long)blockIdx.x * kTile + (long long)threadIdx.x * kPer);
  o[0] = a;
  o[1] = b;
}

}  // namespace

// x, out: int32 [n], n a multiple of 2048, 16-byte aligned; scratch:
// uint32 [n / 2048].  Launches on `stream`, does not synchronize; ->
// cudaGetLastError() after the last launch (0 = success).
extern "C" int bydb_prefix_sum_narrow(const void* x, long long n,
                                      void* scratch, void* out, int device,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n % kTile != 0) return (int)cudaErrorInvalidValue;
  const long long tiles = n / kTile;
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int32_t* xi = static_cast<const int32_t*>(x);
  uint32_t* totals = static_cast<uint32_t*>(scratch);
  tile_totals<<<(unsigned)tiles, kThreads, 0, st>>>(xi, totals);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_totals<<<1, kScanThreads, 0, st>>>(totals, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_tiles<<<(unsigned)tiles, kThreads, 0, st>>>(
      xi, totals, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
