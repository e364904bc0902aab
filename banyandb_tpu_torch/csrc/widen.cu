// Narrow i8/i16 column -> i32: the Hopper counterpart of
// banyandb_tpu/ops/pallas_kernels.py::widen_narrow.
//
// What bounds it on an H100: bytes only (1 or 2 bytes read and 4
// written per element, no arithmetic).  Each thread moves one 16-byte
// vector load (16 i8 or 8 i16 values) and writes it back as 16-byte
// i32 stores, so a warp touches 512 contiguous input bytes per load.
// The ragged edge (the last partial vector) is masked and handled one
// element at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void widen(const T* __restrict__ x, int32_t* __restrict__ out,
                      long long n) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte load
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long base = v * kPer;
  if (base + kPer <= n) {
    const int4 raw = reinterpret_cast<const int4*>(x)[v];
    const T* e = reinterpret_cast<const T*>(&raw);
    int4* o = reinterpret_cast<int4*>(out + base);
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q)
      o[q] = make_int4(e[4 * q], e[4 * q + 1], e[4 * q + 2], e[4 * q + 3]);
  } else {
    for (long long i = base; i < n; ++i) out[i] = x[i];
  }
}

template <typename T>
int launch(const void* x, long long n, void* out, cudaStream_t st) {
  constexpr int kPer = 16 / sizeof(T);
  const long long vecs = (n + kPer - 1) / kPer;
  const int threads = 256;
  const long long blocks = (vecs + threads - 1) / threads;
  widen<T><<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<int32_t*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bydb_widen_narrow(const void* x, int elem_bytes, long long n,
                                 void* out, int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (elem_bytes == 1) return launch<int8_t>(x, n, out, st);
  if (elem_bytes == 2) return launch<int16_t>(x, n, out, st);
  return (int)cudaErrorInvalidValue;
}
