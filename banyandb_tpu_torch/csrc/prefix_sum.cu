// Inclusive i32 prefix sum of a delta column: the Hopper counterpart of
// banyandb_tpu/ops/pallas_kernels.py::prefix_sum_narrow.  With x[0] =
// first and x[1:] = deltas, the output is the decoded series
// (ops/decode.delta_decode).  Exact integer math that wraps mod 2^32,
// like torch.cumsum / jnp.cumsum in i32: every add is done on uint32_t
// (signed overflow is undefined in C++) and the bits are stored back.
//
// What bounds it on an H100: bytes.  The least traffic is 4 B read and
// 4 B written per row; at N = 1,048,576 that is 8,388,608 B / 3.35 TB/s
// = 2.50 us.  The TPU ran its grid in order and carried the running
// total from tile to tile in a revisited [1, 1] output block.  CUDA
// blocks run in no order, so this is one single-pass scan with
// decoupled look-back (Merrill and Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", NVIDIA, 2016): x is read once
// and out written once.
//
//   - Block t scans tile t: 4,096 rows, 16 a thread as four 16-byte
//     vectors laid out warp-striped, so every load and store instruction
//     of a warp moves 512 contiguous bytes (the last tile may be half
//     full and is masked).  A lane scans each vector in registers, the
//     warp scans the vector totals with __shfl_up_sync, one warp scans
//     the 8 warp totals.
//   - It publishes its tile total in a 64-bit status word {tag, value},
//     tag = epoch << 2 | flag, flag 1 = "aggregate", 2 = "inclusive
//     prefix", with one store.
//   - Warp 0 looks back over the predecessors' words, 32 at a time,
//     waits until all 32 carry this call's epoch, and adds the
//     aggregates up to the nearest inclusive prefix (which ends the
//     walk; tile 0 publishes its inclusive prefix at once).  The block
//     then publishes its own inclusive prefix and writes its rows.
//     The word carries its value and nothing else is published with it,
//     so relaxed gpu-scope loads and stores suffice (acquire/release
//     took 1.1 us more at N = 2^20 on an H100: chip_ablation.py).
//
// Forward progress: a block waits only on lower tile ids, and the
// hardware dispatches blocks in index order, so every block it waits on
// is running or done and publishes without waiting on a later one (the
// assumption CUB's scan makes).  An atomic ticket would not need it, but
// every block's loads would wait on one contended atomic.
// Initialisation: the status words are never cleared.  The wrapper keeps
// one status buffer per (device, stream), zeroed once when it is made,
// and passes an epoch that it raises by one per call; a word from an
// earlier call carries another epoch and reads as "not yet published".
// That saves the launch that would clear the words every call.
//
// Determinism: addition mod 2^32 is associative, so the bits depend
// neither on the order the blocks run in nor on how the look-back groups
// the aggregates: the same bits on every run, equal to np.cumsum in i32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                  // rows per thread
constexpr int kVecs = kPer / 4;           // 16-byte vectors per thread
constexpr int kTile = kThreads * kPer;    // 4,096 rows per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kAggregate = 1, kInclusive = 2;

// The status word carries its value: no other data is published with
// it, so relaxed gpu-scope accesses (served by L2, never a stale L1
// line) suffice and save the fences of release/acquire.
__device__ __forceinline__ uint64_t ld_relaxed(const unsigned long long* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t pack(uint32_t epoch, uint32_t flag,
                                         uint32_t value) {
  return (uint64_t)((epoch << 2) | flag) << 32 | value;
}

__device__ __forceinline__ uint32_t warp_inclusive(uint32_t v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Tile t = blockIdx.x; status[t]: tile t's status word.
__global__ void __launch_bounds__(kThreads)
scan_lookback(const int32_t* __restrict__ x, int32_t* __restrict__ out,
              long long n, unsigned long long* __restrict__ status,
              uint32_t epoch) {
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t s_prefix;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile = blockIdx.x;

  // warp-striped 16-byte vectors: vector j of a lane holds rows
  // base + 4 (32 j + lane) .. + 3, so each load and store instruction of
  // a warp covers 512 contiguous bytes
  const long long base = tile * kTile + (long long)warp * kPer * 32;
  const bool in = base < n;  // n % 2048 == 0: a warp's rows are all in or out
  uint32_t v[kVecs][4];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    uint4 a = make_uint4(0u, 0u, 0u, 0u);
    if (in) a = reinterpret_cast<const uint4*>(x + base)[j * 32 + lane];
    v[j][0] = a.x;
    v[j][1] = a.x + a.y;
    v[j][2] = v[j][1] + a.z;
    v[j][3] = v[j][2] + a.w;
  }
  // scan the vector totals across the warp, vector by vector
  uint32_t before[kVecs], warp_total = 0u;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const uint32_t inc = warp_inclusive(v[j][3], lane);
    before[j] = warp_total + inc - v[j][3];
    warp_total += __shfl_sync(kFull, inc, 31);
  }
  if (lane == 0) warp_sums[warp] = warp_total;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? warp_sums[lane] : 0u;
    w = warp_inclusive(w, lane);
    const uint32_t agg = __shfl_sync(kFull, w, kWarps - 1);
    if (lane < kWarps) warp_sums[lane] = w;  // inclusive scan of warp totals
    uint32_t excl = 0u;
    if (tile == 0) {
      if (lane == 0) st_relaxed(&status[0], pack(epoch, kInclusive, agg));
    } else {
      if (lane == 0) st_relaxed(&status[tile], pack(epoch, kAggregate, agg));
      for (long long end = tile - 1;; end -= 32) {
        const long long i = end - lane;  // lane 0 is the nearest tile
        uint64_t s = i >= 0 ? ld_relaxed(&status[i]) : pack(epoch, kInclusive, 0u);
        while (!__all_sync(kFull, (uint32_t)(s >> 34) == epoch))
          if ((uint32_t)(s >> 34) != epoch) s = ld_relaxed(&status[i]);
        const unsigned incl =
            __ballot_sync(kFull, ((uint32_t)(s >> 32) & 3u) == kInclusive);
        const int stop = incl ? __ffs(incl) - 1 : 31;
        excl += warp_sum(lane <= stop ? (uint32_t)s : 0u);
        if (incl) break;
      }
      if (lane == 0) st_relaxed(&status[tile], pack(epoch, kInclusive, excl + agg));
    }
    if (lane == 0) s_prefix = excl;
  }
  __syncthreads();
  if (!in) return;
  const uint32_t add = s_prefix + (warp > 0 ? warp_sums[warp - 1] : 0u);
  uint4* o = reinterpret_cast<uint4*>(out + base);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const uint32_t d = add + before[j];
    o[j * 32 + lane] = make_uint4(v[j][0] + d, v[j][1] + d, v[j][2] + d, v[j][3] + d);
  }
}

}  // namespace

// x, out: int32 [n], n a multiple of 2048, 16-byte aligned; state:
// uint64 [ceil(n / 4096)], zeroed when it was made and used by no
// other call in flight; epoch: 1 <= epoch < 2^30, never the epoch of an
// earlier call on this state since it was zeroed.  One launch on
// `stream`, no synchronize; -> cudaGetLastError() (0 = success).
extern "C" int bydb_prefix_sum_narrow(const void* x, long long n, void* state,
                                      unsigned epoch, void* out, int device,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n % 2048 != 0 || epoch == 0 || epoch >= (1u << 30))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scan_lookback<<<(unsigned)tiles, kThreads, 0, st>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), n,
      static_cast<unsigned long long*>(state), epoch);
  return (int)cudaGetLastError();
}
