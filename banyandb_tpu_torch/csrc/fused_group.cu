// Filtered per-group count and field sums: the Hopper counterpart of
// banyandb_tpu/ops/pallas_kernels.py::fused_group_multi.
//
// Computes, for int32 codes [N], 0/1 predicate and valid flags [N] and
// f32 values [F, N]:  count[g] = #rows with code g, pred and valid;
// sums[f][g] = the f32 sum of values[f] over those rows.  N is a
// multiple of TILE (2048); every TILE-row tile yields an f32 partial
// (exact below 2^24), and the partials are folded with compensated
// arithmetic (the TPU kernel's precision contract).
//
// What bounds it on an H100: the input bytes (4 + 1 + 1 + 4F per row),
// read once per group tile, against 3.35 TB/s; a segment sum does about
// one add per row and field.  The TPU kernel reaches the MXU through a
// one-hot contraction.  Tensor cores are not the route here: TF32 rounds
// integer-valued sums, and a bf16x3 split that stays exact costs 9 G
// multiply-adds a row (about 19 GFLOP at N = 2^20, G = 1,024), 4.4x the
// bytes bound at bf16 peak.
//
// Two launches, one pass over the rows, no [T, 1 + F, Gpad] partials:
//
//   group_rows (grid: P row blocks x group tiles; 16 warps, one block
//   per SM).  Block p walks the contiguous tile range
//   [p T / P, (p + 1) T / P), P fixed by (N, F, G) alone
//   (ops/hopper_kernels.py::_partition), four tiles at a time: the 16
//   warps form 4 groups of 4, and each warp reduces 512 rows of its
//   group's tile.  A lane loads 4 consecutive rows per 16-byte vector
//   (codes, values; 4 pred and 4 valid bytes as one word) and a warp
//   keeps 2 of its 4 steps of 128 rows in flight in registers, the first
//   two issued before the block clears its tags; the next round's rows
//   load while the block folds.
//   Each lane first sums the runs of equal keys among its 4 rows, in row
//   order (the key is the local group code, or -1 outside this group
//   tile; pred and valid only zero a row, so masked rows do not split a
//   run).  Then the warp adds run r of every lane, r = 0 .. the most
//   runs a lane has (1-2 on rows stored by series, 4 on uniform codes),
//   at a cost that follows the keys:
//     - distinct keys (most steps on uniform codes, G = 1,024): each lane
//       adds its own into the warp's copy.  Lanes write their id + 1 into
//       the warp's byte tag of the key's column and read it back; a lane
//       that reads another value shares its key.  Which lane wins the
//       byte does not matter, only whether any lane lost;
//     - otherwise __match_any_sync groups the lanes by key.  When no key
//       has more than 5 adding lanes, the key's lowest lane sums its
//       peers in lane order, one shuffle per peer and field; when every
//       key's lanes form one contiguous run (rows by series), a
//       head-flag segmented scan takes 5 shuffles per field and the
//       run's last lane holds the sum; otherwise the peer loop.
//   The count rides as field 0 (small integers, exact in f32).  One
//   lane per key adds into its warp's own shared-memory copy
//   [1 + F, gt]: no float atomics, no shared atomics.  A nonzero tag
//   marks a column the warp touched this round; the first write to an
//   untouched column stores instead of adding, so the copies are never
//   zeroed, only the tags (16 bytes a column).
//   After the round, each thread owns columns c = tid + 512 j: it reads
//   the column's 16 tags at once and clears them, and for each of the
//   round's tiles in tile order sums the copies its warps touched, in
//   warp order (the tile's f32 partial, exact below 2^24), and
//   Kahan-folds the partial into the block's (sum, compensation) pair,
//   which stays in registers across rounds.  At the end each block
//   writes its pairs to scratch [P, 2, 1 + F, Gpad].
//
//   fold_pairs (32 columns x 16 warps a block): warp w folds the blocks
//   of chunk [w P / 16, (w + 1) P / 16) in block order in float-float
//   (each pair enters as the exact TwoSum of sum - compensation; the
//   chunk's loads are issued together), and warp 0 adds the 16 chunk
//   totals in order.  Integer counts come out exact.
//
// Determinism: P, the tile ranges, the row-to-lane map, the order of
// adds inside a lane and a warp (fixed by the keys, not by timing), the
// warp order of a tile partial, the tile order of the Kahan fold and the
// block and chunk order of the last fold are fixed by the shapes and the
// data, so the result is the same bits on every run; the staged and
// fused executors and the serving cache rely on that.
//
// Shared memory: 16 warps x (1 + F) x gt floats and 16 x gt tag bytes
// (208 KB at F = 2, gt = 1,024); the group tile is the widest that fits,
// so G = 1,024 reads every row once at F <= 2.  Fields beyond 4 take
// another launch (the wrapper splits them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kSplit = 4;                     // warps that share a tile
constexpr int kGroups = kWarps / kSplit;      // tiles a block reduces at once
constexpr int kRowsPerWarp = kTile / kSplit;  // 512: four 128-row steps
constexpr int kSteps = kRowsPerWarp / 128;
constexpr int kMaxCols = 4;                   // group-tile columns a thread owns
constexpr int kMaxFields = 4;
constexpr int kLoopMax = 5;                   // peer loop up to this many adding lanes
constexpr int kFoldWarps = 16;
constexpr int kFoldBatch = 9;                 // 132 blocks / 16 warps, rounded up
constexpr int kSmemLimit = 232448;            // 227 KB a block on sm_90
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr long long smem_bytes(int gt, int nf) {
  return 4LL * kWarps * (1 + nf) * gt + (long long)kWarps * gt;
}

// 128-row steps whose loads a warp keeps in flight (registers): two
// measured faster than four, whose step-0 data came in last
constexpr int kDepth = 2;

// 128 rows of one warp: lane l holds rows 4 l .. 4 l + 3
template <int NF>
struct Rows {
  int4 code;
  uint32_t pred, valid;
  float4 val[NF > 0 ? NF : 1];
};

template <int NF>
__device__ __forceinline__ Rows<NF> load_rows(
    const int32_t* __restrict__ codes, const uint8_t* __restrict__ pred,
    const float* __restrict__ vals, const uint8_t* __restrict__ valid,
    long long n, long long r) {
  Rows<NF> x;
  x.code = *reinterpret_cast<const int4*>(codes + r);
  x.pred = *reinterpret_cast<const uint32_t*>(pred + r);
  x.valid = *reinterpret_cast<const uint32_t*>(valid + r);
#pragma unroll
  for (int k = 0; k < NF; ++k)
    x.val[k] = *reinterpret_cast<const float4*>(vals + k * n + r);
  return x;
}

// Adds x[0..NF] into the warp's copy at column `key`, or stores it
// there if the warp has not touched the column this round (`fresh`):
// the copies are never zeroed.
template <int NF>
__device__ __forceinline__ void add_into(float* __restrict__ wacc, int gt,
                                         int key, bool fresh,
                                         const float (&x)[1 + NF]) {
  float a[1 + NF];
#pragma unroll
  for (int k = 0; k <= NF; ++k) a[k] = fresh ? 0.f : wacc[k * gt + key];
#pragma unroll
  for (int k = 0; k <= NF; ++k) wacc[k * gt + key] = a[k] + x[k];
}

// Lanes holding the same key combine x[0..NF] (count, then the field
// sums) in a fixed order; one lane per key adds them into the warp's copy.
// tag[key * kWarps]: the warp's byte tag of each column, 0 = untouched
// this round.
template <int NF>
__device__ __forceinline__ void warp_add(int key, float (&x)[1 + NF],
                                         float* __restrict__ wacc,
                                         uint8_t* __restrict__ tag, int gt,
                                         int lane) {
  const bool adds = key >= 0 && x[0] > 0.f;
  const bool fresh = key >= 0 && tag[key * kWarps] == 0;
  __syncwarp();
  // distinct keys (most steps on uniform codes): each lane adds its own.
  // A lane that reads back another lane's id + 1 shares its key; which
  // lane wins the byte does not matter, only whether any lane lost.  The
  // nonzero tag then marks the column touched for the rest of the round.
  if (adds) tag[key * kWarps] = (uint8_t)(lane + 1);
  __syncwarp();
  if (!__any_sync(kFull, adds && tag[key * kWarps] != lane + 1)) {
    if (adds) add_into<NF>(wacc, gt, key, fresh, x);
    return;
  }
  const unsigned peers = __match_any_sync(kFull, key);
  const unsigned mine = peers & __ballot_sync(kFull, adds);
  const int n_add = __popc(mine);
  const unsigned most = __reduce_max_sync(kFull, key >= 0 ? n_add : 0);
  if (most == 0) return;
  const int low = __ffs(peers) - 1;
  const unsigned run = peers >> low;
  const bool contiguous = key < 0 || (run & (run + 1)) == 0;
  const bool scan = most > kLoopMax && __all_sync(kFull, contiguous);
  float sum[1 + NF];
  if (scan) {
    // segmented inclusive scan; the run's last lane holds its sum
#pragma unroll
    for (int k = 0; k <= NF; ++k) {
      float v = x[k];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFull, v, off);
        if (lane - off >= low) v += y;
      }
      sum[k] = v;
    }
  } else {
    // every lane walks its key's adding lanes in lane order; the key's
    // lowest lane keeps the sum
#pragma unroll
    for (int k = 0; k <= NF; ++k) sum[k] = 0.f;
    unsigned rest = mine;
    for (unsigned it = 0; it < most; ++it) {
      const int src = rest ? __ffs(rest) - 1 : lane;
      rest &= rest - 1;
#pragma unroll
      for (int k = 0; k <= NF; ++k) {
        const float y = __shfl_sync(kFull, x[k], src);
        if ((int)it < n_add) sum[k] += y;
      }
    }
  }
  const int writer = scan ? 31 - __clz(peers) : low;
  if (key >= 0 && lane == writer && n_add > 0) add_into<NF>(wacc, gt, key, fresh, sum);
}

// One warp's 128 rows: each lane first sums the runs of equal keys among
// its 4 rows (in row order), then the warp combines run r of every lane,
// r = 0 .. most runs a lane has.
template <int NF>
__device__ __forceinline__ void reduce_rows(const Rows<NF>& x, int g0, int gt,
                                            int g, float* __restrict__ wacc,
                                            uint8_t* __restrict__ tag,
                                            int lane) {
  const int code[4] = {x.code.x, x.code.y, x.code.z, x.code.w};
  int key[4], idx[4];
  float cnt[4], val[NF > 0 ? NF : 1][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int local = code[i] - g0;
    const bool inr = local >= 0 && local < gt && code[i] < g;
    key[i] = inr ? local : -1;
    const bool take = inr && ((x.pred >> (8 * i)) & 0xff) && ((x.valid >> (8 * i)) & 0xff);
    cnt[i] = take ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      const float4 v = x.val[k];
      const float e = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
      val[k][i] = take ? e : 0.f;
    }
    idx[i] = i == 0 ? 0 : idx[i - 1] + (key[i] != key[i - 1]);
  }
  const int runs = __reduce_max_sync(kFull, idx[3] + 1);
  for (int r = 0; r < runs; ++r) {
    int k_r = -1;
    float s[1 + NF];
#pragma unroll
    for (int k = 0; k <= NF; ++k) s[k] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (idx[i] == r) {
        k_r = key[i];
        s[0] += cnt[i];
#pragma unroll
        for (int k = 0; k < NF; ++k) s[k + 1] += val[k][i];
      }
    }
    warp_add<NF>(k_r, s, wacc, tag, gt, lane);
  }
}

template <int NF>
__global__ void __launch_bounds__(kThreads, 1)
group_rows(const int32_t* __restrict__ codes, const uint8_t* __restrict__ pred,
           const float* __restrict__ vals, const uint8_t* __restrict__ valid,
           long long n, int g, int gt, int gpad, long long tiles,
           float* __restrict__ pairs) {
  extern __shared__ __align__(16) float acc[];  // [kWarps][1 + NF][gt]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g0 = blockIdx.y * gt;
  const long long t0 = (long long)blockIdx.x * tiles / gridDim.x;
  const long long t1 = (long long)(blockIdx.x + 1) * tiles / gridDim.x;

  float ks[kMaxCols][1 + NF], kc[kMaxCols][1 + NF];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j)
#pragma unroll
    for (int k = 0; k <= NF; ++k) ks[j][k] = kc[j][k] = 0.f;

  float* wacc = acc + warp * (1 + NF) * gt;
  uint8_t* tags = reinterpret_cast<uint8_t*>(acc + kWarps * (1 + NF) * gt);
  const int group = warp / kSplit;
  constexpr int D = kDepth;
  // warp (group q, quarter h) takes 512 rows of tile round + q
  const long long quarter = (warp % kSplit) * kRowsPerWarp + lane * 4;
  Rows<NF> buf[D];
  if (t0 + group < t1) {
#pragma unroll
    for (int s = 0; s < D; ++s)
      buf[s] = load_rows<NF>(codes, pred, vals, valid, n,
                             (t0 + group) * kTile + quarter + s * 128);
  }
  // the tags (not the copies) zeroed while the first rows load
  for (int i = tid; i < gt; i += kThreads)
    reinterpret_cast<uint4*>(tags)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (long long round = t0; round < t1; round += kGroups) {
    __syncthreads();  // the tags are clear
    const long long tile = round + group;
    if (tile < t1) {
      const long long r0 = tile * kTile + quarter;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        reduce_rows<NF>(buf[s % D], g0, gt, g, wacc, tags + warp, lane);
        if (s + D < kSteps)
          buf[s % D] = load_rows<NF>(codes, pred, vals, valid, n, r0 + (s + D) * 128);
      }
      // the next round's first rows load while the block folds
      if (tile + kGroups < t1) {
#pragma unroll
        for (int s = 0; s < D; ++s)
          buf[s] = load_rows<NF>(codes, pred, vals, valid, n,
                                 (tile + kGroups) * kTile + quarter + s * 128);
      }
    }
    __syncthreads();
    // -- fold: each tile's partial (the copies its warps touched, in warp
    // order), Kahan-folded in tile order into the owned columns' pairs
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int c = tid + j * kThreads;
      if (c >= gt) break;
      // the 16 warps' tags of column c; word q holds tile group q's four
      uint4* ctag = reinterpret_cast<uint4*>(tags) + c;
      const uint4 t4 = *ctag;
      *ctag = make_uint4(0u, 0u, 0u, 0u);
      const uint32_t tw[kGroups] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        if (round + q >= t1) break;
        float part[1 + NF];
#pragma unroll
        for (int k = 0; k <= NF; ++k) part[k] = 0.f;
#pragma unroll
        for (int h = 0; h < kSplit; ++h) {
          if ((tw[q] >> (8 * h)) & 0xffu) {  // only touched columns hold sums
#pragma unroll
            for (int k = 0; k <= NF; ++k)
              part[k] += acc[((q * kSplit + h) * (1 + NF) + k) * gt + c];
          }
        }
#pragma unroll
        for (int k = 0; k <= NF; ++k) {
          const float y = part[k] - kc[j][k];
          const float u = ks[j][k] + y;
          kc[j][k] = (u - ks[j][k]) - y;
          ks[j][k] = u;
        }
      }
    }
  }

  float* out = pairs + (long long)blockIdx.x * 2 * (1 + NF) * gpad;
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int c = tid + j * kThreads;
    if (c < gt) {
#pragma unroll
      for (int k = 0; k <= NF; ++k) {
        out[(long long)k * gpad + g0 + c] = ks[j][k];
        out[(long long)(1 + NF + k) * gpad + g0 + c] = kc[j][k];
      }
    }
  }
}

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

// (hi, lo) += (bh, bl) in float-float; the pair stays normalized
__device__ __forceinline__ void ff_add(float& hi, float& lo, float bh, float bl) {
  float s, e;
  two_sum(hi, bh, s, e);
  e += lo + bl;
  hi = s + e;
  lo = e - (hi - s);
}

__global__ void __launch_bounds__(kFoldWarps * 32)
fold_pairs(const float* __restrict__ pairs, int blocks, int nfield, int gpad,
           int g, float* __restrict__ count, float* __restrict__ sums) {
  __shared__ float part[kFoldWarps][2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * 32 + lane;  // column of [1 + F, Gpad]
  const int cols = nfield * gpad;
  const long long stride = 2LL * cols;   // one block's pairs
  float hi = 0.f, lo = 0.f;
  if (q < cols) {
    const int p1 = (int)((long long)(warp + 1) * blocks / kFoldWarps);
    for (int p = (int)((long long)warp * blocks / kFoldWarps); p < p1; p += kFoldBatch) {
      float s[kFoldBatch], c[kFoldBatch];
#pragma unroll
      for (int i = 0; i < kFoldBatch; ++i) {
        s[i] = p + i < p1 ? pairs[(p + i) * stride + q] : 0.f;
        c[i] = p + i < p1 ? pairs[(p + i) * stride + cols + q] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kFoldBatch; ++i) {
        if (p + i < p1) {
          float a, b;
          two_sum(s[i], -c[i], a, b);
          ff_add(hi, lo, a, b);
        }
      }
    }
  }
  part[warp][0][lane] = hi;
  part[warp][1][lane] = lo;
  __syncthreads();
  if (warp != 0 || q >= cols) return;
  hi = lo = 0.f;
  for (int w = 0; w < kFoldWarps; ++w) ff_add(hi, lo, part[w][0][lane], part[w][1][lane]);
  const int k = q / gpad, col = q - k * gpad;
  if (col >= g) return;
  if (k == 0)
    count[col] = hi + lo;
  else
    sums[(long long)(k - 1) * g + col] = hi + lo;
}

template <int NF>
int launch(const void* codes, const void* pred, const void* vals,
           const void* valid, long long n, int g, int gt, int blocks,
           float* pairs, float* count, float* sums, cudaStream_t st) {
  const long long smem = smem_bytes(gt, NF);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      group_rows<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int gpad = (g + gt - 1) / gt * gt;
  group_rows<NF><<<dim3(blocks, gpad / gt), kThreads, (size_t)smem, st>>>(
      static_cast<const int32_t*>(codes), static_cast<const uint8_t*>(pred),
      static_cast<const float*>(vals), static_cast<const uint8_t*>(valid), n,
      g, gt, gpad, n / kTile, pairs);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int cols = (1 + NF) * gpad;
  fold_pairs<<<(cols + 31) / 32, kFoldWarps * 32, 0, st>>>(
      pairs, blocks, 1 + NF, gpad, g, count, sums);
  return (int)cudaGetLastError();
}

}  // namespace

// codes i32 [n], pred/valid u8 [n], vals f32 [nf, n], all 16-byte
// aligned, n a positive multiple of 2048; nf <= 4; gt a multiple of 32,
// at most 2048; 1 <= blocks <= n / 2048; pairs f32 [blocks, 2, 1 + nf,
// Gpad]; count f32 [g]; sums f32 [nf, g].  Launches on `stream`, does
// not synchronize; -> cudaGetLastError() (0 = success).
extern "C" int bydb_fused_group_multi(const void* codes, const void* pred,
                                      const void* vals, const void* valid,
                                      long long n, int nf, int g, int gt,
                                      int blocks, void* pairs, void* count,
                                      void* sums, int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || n % kTile != 0 || gt <= 0 || gt % 32 != 0 ||
      gt > kMaxCols * kThreads || blocks < 1 || blocks > n / kTile ||
      nf < 0 || nf > kMaxFields)
    return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(pairs);
  float* c = static_cast<float*>(count);
  float* s = static_cast<float*>(sums);
  switch (nf) {
    case 0: return launch<0>(codes, pred, vals, valid, n, g, gt, blocks, p, c, s, st);
    case 1: return launch<1>(codes, pred, vals, valid, n, g, gt, blocks, p, c, s, st);
    case 2: return launch<2>(codes, pred, vals, valid, n, g, gt, blocks, p, c, s, st);
    case 3: return launch<3>(codes, pred, vals, valid, n, g, gt, blocks, p, c, s, st);
    default: return launch<4>(codes, pred, vals, valid, n, g, gt, blocks, p, c, s, st);
  }
}
