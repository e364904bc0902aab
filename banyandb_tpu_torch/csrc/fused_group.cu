// Filtered per-group count and field sums: the Hopper counterpart of
// banyandb_tpu/ops/pallas_kernels.py::fused_group_multi.
//
// Computes, for int32 codes [N], 0/1 predicate and valid flags [N] and
// f32 values [F, N]:  count[g] = #rows with code g, pred and valid;
// sums[f][g] = the f32 sum of values[f] over those rows.  N is a
// multiple of TILE; every TILE-row tile yields an f32 partial, and the
// tile partials are folded in tile order with Kahan-compensated f32,
// the residual folded last (the TPU kernel's precision contract).
//
// What bounds it on an H100: the input bytes (4 + 1 + 1 + 4F per row)
// against 3.35 TB/s; a segment sum does one add per row and field.
// The TPU kernel reaches the MXU through a one-hot contraction; here
// that would cost G multiply-adds per row, and TF32 tensor cores would
// round integer-valued sums.  Instead:
//   pass 1 (grid: row tile x group tile, 8 warps): each warp walks its
//     256 rows in steps of 32.  __match_any_sync finds the lanes that
//     share a group; every lane sums its peers' values in lane order
//     through 32 shuffles, and the lowest peer adds the result into the
//     warp's own shared-memory copy of the group tile.  No two lanes of
//     a warp write one slot, and no warp writes another warp's copy, so
//     no float atomics are needed and the order of every add is fixed.
//     The eight copies are then summed in warp order and written as the
//     tile's partial [T, 1+F, Gpad].
//   pass 2: one thread per (field, group) folds the T tile partials in
//     tile order with Kahan compensation.
// The result is the same bits on every run, which the staged and fused
// executors and the serving cache rely on.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kTile / kWarps;

__global__ void __launch_bounds__(kWarps * 32)
tile_partials(const int32_t* __restrict__ codes,
              const uint8_t* __restrict__ pred,
              const float* __restrict__ vals,
              const uint8_t* __restrict__ valid,
              long long n, int nf, int gt, int gpad,
              float* __restrict__ partials) {
  extern __shared__ float acc[];  // [kWarps][1 + nf][gt]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int width = (1 + nf) * gt;
  for (int i = threadIdx.x; i < kWarps * width; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  float* wacc = acc + warp * width;
  const int g0 = blockIdx.y * gt;
  const long long row0 = (long long)blockIdx.x * kTile + warp * kRowsPerWarp;
  for (int b = 0; b < kRowsPerWarp; b += 32) {
    const long long r = row0 + b + lane;
    const int local = codes[r] - g0;
    const bool in = valid[r] && pred[r] && local >= 0 && local < gt;
    const unsigned peers = __match_any_sync(0xffffffffu, in ? local : -1);
    const bool leader = in && (__ffs(peers) - 1 == lane);
    if (leader) wacc[local] += (float)__popc(peers);
    for (int k = 0; k < nf; ++k) {
      const float v = in ? vals[(long long)k * n + r] : 0.f;
      float s = 0.f;
#pragma unroll
      for (int src = 0; src < 32; ++src) {
        const float x = __shfl_sync(0xffffffffu, v, src);
        if ((peers >> src) & 1u) s += x;
      }
      if (leader) wacc[(k + 1) * gt + local] += s;
    }
  }
  __syncthreads();

  float* out = partials + (long long)blockIdx.x * (1 + nf) * gpad;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += acc[w * width + i];
    const int k = i / gt;
    out[(long long)k * gpad + g0 + (i - k * gt)] = s;
  }
}

__global__ void kahan_fold(const float* __restrict__ partials, int tiles,
                           int nf, int gpad, int g,
                           float* __restrict__ count,
                           float* __restrict__ sums) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (1 + nf) * g) return;
  const int k = i / g;
  const int col = i - k * g;
  const long long stride = (long long)(1 + nf) * gpad;
  const float* p = partials + (long long)k * gpad + col;
  float s = 0.f, c = 0.f;
#pragma unroll 8
  for (int t = 0; t < tiles; ++t) {
    const float y = p[t * stride] - c;
    const float u = s + y;
    c = (u - s) - y;
    s = u;
  }
  if (k == 0)
    count[col] = s - c;
  else
    sums[(long long)(k - 1) * g + col] = s - c;
}

}  // namespace

extern "C" int bydb_fused_group_multi(const void* codes, const void* pred,
                                      const void* vals, const void* valid,
                                      long long n, int nf, int g, int gt,
                                      void* partials, void* count, void* sums,
                                      int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (int)(n / kTile);
  const int gpad = (g + gt - 1) / gt * gt;
  const size_t smem = (size_t)kWarps * (1 + nf) * gt * sizeof(float);
  err = cudaFuncSetAttribute(
      tile_partials, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles, gpad / gt);
  tile_partials<<<grid, kWarps * 32, smem, st>>>(
      static_cast<const int32_t*>(codes), static_cast<const uint8_t*>(pred),
      static_cast<const float*>(vals), static_cast<const uint8_t*>(valid), n,
      nf, gt, gpad, static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cols = (1 + nf) * g;
  kahan_fold<<<(cols + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partials), tiles, nf, gpad, g,
      static_cast<float*>(count), static_cast<float*>(sums));
  return (int)cudaGetLastError();
}
