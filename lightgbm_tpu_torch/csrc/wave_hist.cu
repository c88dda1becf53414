// Wave histogram for the leaf-wise tree grower, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py::_wave_hist_pallas
// (body _kernel, helpers _build_bmat/_pair_one_hot) and its XLA twin
// GrowerPrograms._wave_hist (lightgbm_tpu/ops/grow.py), including the 64-bin
// strip tiling that only XLA needed.  It computes the same function:
//
//   out[(g*NB + b), k, w] = sum of ghk[r, k] over rows r with
//                           bins_t[g, r] == b and leaf_id[r] == pending[w]
//
// for every wave width W and K in {3,4,5,6}, with bf16, int8 or f32 stat
// columns.  A second entry, wave_hist_rows_launch, computes one slot's
// histogram over a caller's row list (a leaf's window of the host
// learner's partition buffer, lightgbm_tpu/tree/learner.py
// _window_histogram): no pre-pass, no sort, and no gather of the bins
// before the kernel.  The TPU kernel built a one-hot
// of the bins and contracted it on the MXU because the TPU has no scatter;
// here each row adds its K values into exactly one (bin, slot) cell of a
// shared-memory histogram.
//
// What bounds it on this card: bytes.  A wave must read n*(G + 4) bytes
// (bins, leaf ids), the stats of the rows in the wave and write
// G*NB*K*W*4 bytes; at 2M rows, G=28, K=3, W=128 that is ~24 us at
// 3.35 TB/s.
//
// The earlier design gave each CTA one 16-slot tile of the wave (the int64
// (NB, K, 16) tile fills the shared memory at NB=256) and had every such
// CTA read every row's slot: 8 passes over the rows at W=128, each a
// dependent load chain with nothing in flight.  The design now:
//   * a pre-pass maps every row's leaf id to its wave slot (int16, -1 when
//     the leaf is not pending);
//   * the wave's slots are cut into the fewest slot tiles whose int64 (or
//     int32) (gb, NB, K, wt) tile fits a CTA's 225 KB: one tile up to 32
//     slots at NB=256, K=3, bf16 and up to 128 at NB=64;
//   * the pre-pass also counts each block's rows of each tile, and a
//     counting sort (tile offsets, then a scatter; the order within a
//     block of the pre-pass is arbitrary, the sums are exact integers)
//     lists the rows of each tile, so a row's slot, stats and bins are
//     read once per group tile, not once per slot tile, and no thread
//     spends a step on a row outside the wave.  A one-slot wave (W=1,
//     where every row may be in the wave) skips the sort: its list is
//     every row;
//   * CTA (slot tile, part, group tile) reads its part of its tile's list,
//     four entries a thread in flight, loads all their slots, stats and
//     bins before their atomics, and converts a row's stats once for the
//     gb groups it holds (all 28 at W=1, NB=256);
//   * 64-bit shared adds stay two native 32-bit atomics (the low word's old
//     value gives the carry); a row issues all its low words first.
// The wave's tile over a thread-block cluster's distributed shared memory
// (each row streamed once per cluster, hits on other CTAs' slots added as
// remote atomics) ran 2-4x slower than this partition, and a 2-stage
// cp.async row ring for one-slot waves no faster than the unsorted list
// (PERF.md).  Without the sort a one-tile wave of half the rows ran
// 1.3-1.4x slower (PERF.md).
// nvcc 12.8 (sm_90a): the row kernel is held to 64 registers by its 1024
// threads a CTA; it then spills 16-40 bytes a thread for bf16 at K=3-5
// (its four list entries' K int64 stats), 0-8 for int8 at K=3-5 and 76 at
// K=6.  Its tile is 196,608 B of dynamic shared memory at NB=256, K=3,
// W=128.
// What still holds it back: the shared-memory atomics (two a stat for
// int64, contended where many rows share a bin), the pre-pass and sort
// (three more launches over the rows), and one CTA an SM of 1024 threads
// whose list reads are gathers.
//
// Determinism: no float atomics anywhere.  bf16 (and f32) stats are
// converted to int64 fixed point with one power-of-two scale per stat column
// (chosen by the caller from max|column| and the row count, so no sum can
// overflow; an f32 stat keeps the bits above 2^-scale, bf16 loses none),
// accumulated with integer atomics in shared and then global memory, and
// converted to f32 at the end.  Integer addition is associative, so the
// result is bit-identical from run to run and to any other exact order
// (ops/hist_cuda.wave_hist_fixed_reference).  int8 stats accumulate in
// int32 exactly like the TPU kernel's int8->int32 path.


#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int THREADS = 1024;  // threads per CTA, one CTA per SM
constexpr int LIST_ROWS = 4;   // list entries a thread takes per step
constexpr int PRE_THREADS = 1024;

// leaf -> slot table in shared memory: index into pending, or -1
__device__ void fill_slot_of_leaf(int16_t* slot_of_leaf,
                                  const int32_t* __restrict__ pending, int w,
                                  int leaf_bound) {
  for (int i = threadIdx.x; i < leaf_bound; i += blockDim.x)
    slot_of_leaf[i] = -1;
  __syncthreads();
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    const int leaf = pending[j];
    // empty slots (pending < 0) stay zero; pending leaves are distinct
    if (leaf >= 0 && leaf < leaf_bound) slot_of_leaf[leaf] = (int16_t)j;
  }
  __syncthreads();
}

// Pre-pass: the slot of every row, and (tiles >= 1, when the rows are
// sorted) how many rows of block b's row range fall in each slot tile:
// counts[b * tiles + t].
__global__ void row_slots_kernel(const int32_t* __restrict__ leaf_id,
                                 const int32_t* __restrict__ pending,
                                 int16_t* __restrict__ slot_of_row,
                                 int* __restrict__ counts, long long n, int w,
                                 int leaf_bound, int wt, int tiles,
                                 long long rows_per_block) {
  extern __shared__ int pre_smem[];
  int* tile_count = pre_smem;  // [tiles]
  int16_t* slot_of_leaf = reinterpret_cast<int16_t*>(pre_smem + tiles);
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) tile_count[t] = 0;
  fill_slot_of_leaf(slot_of_leaf, pending, w, leaf_bound);
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int leaf = leaf_id[r];
    const int s =
        (leaf >= 0 && leaf < leaf_bound) ? slot_of_leaf[leaf] : -1;
    slot_of_row[r] = (int16_t)s;
    if (tiles > 0 && s >= 0) atomicAdd(&tile_count[s / wt], 1);
  }
  if (tiles == 0) return;
  __syncthreads();
  for (int t = threadIdx.x; t < tiles; t += blockDim.x)
    counts[(long long)blockIdx.x * tiles + t] = tile_count[t];
}

// One block: tile t's rows go to list[start[t], start[t] + len[t]), and
// block b's rows of tile t start at counts[b * tiles + t] (rewritten from
// counts to offsets in place).
__global__ void tile_offsets_kernel(int* __restrict__ counts,
                                    long long* __restrict__ tile_range,
                                    int blocks, int tiles) {
  extern __shared__ long long total[];  // [tiles]
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    long long s = 0;
    for (int b = 0; b < blocks; ++b) s += counts[(long long)b * tiles + t];
    total[t] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int t = 0; t < tiles; ++t) {
      const long long len = total[t];
      tile_range[2 * t] = s;
      tile_range[2 * t + 1] = len;
      total[t] = s;
      s += len;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    long long at = total[t];
    for (int b = 0; b < blocks; ++b) {
      const long long i = (long long)b * tiles + t;
      const int c = counts[i];
      counts[i] = (int)at;
      at += c;
    }
  }
}

// Counting sort's scatter: each row of the wave into its slot tile's list
// (in any order within a block).
__global__ void scatter_rows_kernel(const int16_t* __restrict__ slot_of_row,
                                    const int* __restrict__ offsets,
                                    int* __restrict__ list, long long n,
                                    int wt, int tiles,
                                    long long rows_per_block) {
  extern __shared__ int cursor[];  // [tiles]
  for (int t = threadIdx.x; t < tiles; t += blockDim.x)
    cursor[t] = offsets[(long long)blockIdx.x * tiles + t];
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int s = slot_of_row[r];
    if (s >= 0) list[atomicAdd(&cursor[s / wt], 1)] = (int)r;
  }
}

// `list_len` >= 0: a one-slot histogram over a caller's row list of that
// length (every entry in slot 0, no row -> slot map); -1 otherwise.
struct Geo {
  long long n, list_len;
  int g, nb, w, wt, gb, splits;
};

// stat column types: bf16 and f32 accumulate in int64 fixed point, int8 in
// int32
enum Mode { BF16 = 0, INT8 = 1, F32 = 2 };
template <int MODE>
using AccT = typename std::conditional<MODE == INT8, int, long long>::type;
template <int MODE>
using StatT = typename std::conditional<
    MODE == INT8, int8_t,
    typename std::conditional<MODE == F32, float, __nv_bfloat16>::type>::type;

__device__ __forceinline__ float stat_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float stat_float(float v) { return v; }

// a row's K stats as fixed-point integers (bf16, f32) or int8 values
template <int K, int MODE>
__device__ __forceinline__ void to_fixed(const StatT<MODE>* s,
                                         const int (&exps)[K],
                                         AccT<MODE> (&q)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if constexpr (MODE == INT8)
      q[k] = s[k];
    else
      q[k] = __float2ll_rn(ldexpf(stat_float(s[k]), exps[k]));
  }
}

// add a row's K values into the shared-memory cells cell[0], cell[wt], ...
template <int K, int MODE>
__device__ __forceinline__ void add_row(AccT<MODE>* cell, int wt,
                                        const AccT<MODE> (&q)[K]) {
  if constexpr (MODE == INT8) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (q[k]) atomicAdd(cell + k * wt, q[k]);
  } else {
    // exact 64-bit add from two native 32-bit atomics: the low word's old
    // value tells whether the add carried.  All low words first, so the K
    // round trips overlap.  (A 64-bit shared atomicAdd compiles to a
    // compare-and-swap loop.)
    unsigned old[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      old[k] = q[k] ? atomicAdd(reinterpret_cast<unsigned*>(cell + k * wt),
                                (unsigned)q[k])
                    : 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned lo = (unsigned)q[k];
      const unsigned hi = (unsigned)((unsigned long long)q[k] >> 32) +
                          (old[k] + lo < old[k]);
      if (hi) atomicAdd(reinterpret_cast<unsigned*>(cell + k * wt) + 1, hi);
    }
  }
}

// flush a CTA's (gb, NB, K, wt) tile, slots from slot0: integer atomics
// into the (G*NB, K, W) accumulator (row splits add into the same cells)
template <int K, int MODE>
__device__ void flush_tile(const AccT<MODE>* cells, int ncell, int g0,
                           int slot0, const Geo& p, void* acc_raw) {
  for (int i = threadIdx.x; i < ncell; i += THREADS) {
    const int j = i % p.wt;
    const AccT<MODE> v = cells[i];
    if (v == 0 || slot0 + j >= p.w) continue;
    const int gbk = i / p.wt;  // (gi*nb + b)*K + k
    const long long o =
        ((long long)g0 * p.nb * K + gbk) * p.w + slot0 + j;
    if constexpr (MODE == INT8)
      atomicAdd(reinterpret_cast<int*>(acc_raw) + o, v);
    else
      atomicAdd(reinterpret_cast<unsigned long long*>(acc_raw) + o,
                (unsigned long long)v);
  }
}

// Grid (slot tiles * splits, group tiles): CTA (t, s) holds the (gb
// groups, NB, K, wt slots) tile of slot tile t and reads the s-th of
// `splits` parts of the tile's list from the counting sort (list null: a
// one-slot wave, whose list is every row; p.list_len >= 0: the caller's
// list, every entry in slot 0), LIST_ROWS entries a thread per step with
// all their loads issued before their atomics.
template <int K, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
wave_hist_list_kernel(const uint8_t* __restrict__ bins_t,
                      const int16_t* __restrict__ slot_of_row,
                      const void* __restrict__ ghk_raw,
                      const int32_t* __restrict__ scale_exp,
                      const int* __restrict__ list,
                      const long long* __restrict__ tile_range,
                      void* __restrict__ acc_raw, const Geo p) {
  using Acc = AccT<MODE>;
  using Stat = StatT<MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = p.nb, wt = p.wt;
  Acc* cells = reinterpret_cast<Acc*>(smem);  // [gb][nb][K][wt]
  const int ncell = p.gb * nb * K * wt;
  const int tile = blockIdx.x / p.splits, part = blockIdx.x % p.splits;
  const int slot0 = tile * wt;
  const int g0 = blockIdx.y * p.gb;
  const int g_here = min(p.gb, p.g - g0);

  for (int i = threadIdx.x; i < ncell; i += THREADS) cells[i] = 0;
  int exps[K];
#pragma unroll
  for (int k = 0; k < K; ++k) exps[k] = MODE == INT8 ? 0 : scale_exp[k];
  const bool direct = p.list_len >= 0;
  const long long start = (list && !direct) ? tile_range[2 * tile] : 0;
  const long long len =
      direct ? p.list_len : (list ? tile_range[2 * tile + 1] : p.n);
  const long long a = start + len * part / p.splits;
  const long long b = start + len * (part + 1) / p.splits;
  __syncthreads();

  const Stat* ghk = reinterpret_cast<const Stat*>(ghk_raw);
  for (long long e0 = a; e0 < b; e0 += (long long)LIST_ROWS * THREADS) {
    int row[LIST_ROWS], j[LIST_ROWS];
#pragma unroll
    for (int u = 0; u < LIST_ROWS; ++u) {
      const long long e = e0 + u * THREADS + threadIdx.x;
      row[u] = e < b ? (list ? list[e] : (int)e) : -1;
    }
#pragma unroll
    for (int u = 0; u < LIST_ROWS; ++u)
      j[u] = row[u] < 0 ? -1 : (direct ? 0 : slot_of_row[row[u]] - slot0);
    Acc q[LIST_ROWS][K];
#pragma unroll
    for (int u = 0; u < LIST_ROWS; ++u) {
      if (j[u] >= 0)
        to_fixed<K, MODE>(ghk + (long long)row[u] * K, exps, q[u]);
    }
    for (int gi = 0; gi < g_here; ++gi) {
      const uint8_t* col = bins_t + (long long)(g0 + gi) * p.n;
      unsigned bin[LIST_ROWS];
#pragma unroll
      for (int u = 0; u < LIST_ROWS; ++u) bin[u] = j[u] >= 0 ? col[row[u]] : nb;
#pragma unroll
      for (int u = 0; u < LIST_ROWS; ++u)
        if (bin[u] < (unsigned)nb)
          add_row<K, MODE>(cells + ((gi * nb + bin[u]) * K) * wt + j[u],
                           wt, q[u]);
    }
  }
  __syncthreads();
  flush_tile<K, MODE>(cells, ncell, g0, slot0, p, acc_raw);
}

// int64 fixed point -> f32 with the column's scale 2^-scale_exp[k]
__global__ void fixed_to_f32_kernel(const long long* __restrict__ acc,
                                    float* __restrict__ out,
                                    const int32_t* __restrict__ scale_exp,
                                    long long total, int k, int w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int kk = (int)((i / w) % k);
  out[i] = (float)ldexp((double)acc[i], -scale_exp[kk]);
}

struct Buffers {
  const uint8_t* bins_t;
  const int16_t* slots;
  const void* ghk;
  const int32_t* scale_exp;
  const int* list;
  const long long* tile_range;
  void* acc;
};

template <int K, int MODE>
cudaError_t launch_k(dim3 grid, size_t smem, cudaStream_t st,
                     const Buffers& b, const Geo& geo) {
  auto kern = wave_hist_list_kernel<K, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, THREADS, smem, st>>>(b.bins_t, b.slots, b.ghk, b.scale_exp,
                                    b.list, b.tile_range, b.acc, geo);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_mode(int mode, dim3 grid, size_t smem, cudaStream_t st,
                        const Buffers& b, const Geo& geo) {
  switch (mode) {
    case BF16:
      return launch_k<K, BF16>(grid, smem, st, b, geo);
    case INT8:
      return launch_k<K, INT8>(grid, smem, st, b, geo);
    case F32:
      return launch_k<K, F32>(grid, smem, st, b, geo);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_any(int k, int mode, dim3 grid, size_t smem,
                       cudaStream_t st, const Buffers& b, const Geo& geo) {
  switch (k) {
    case 3:
      return launch_mode<3>(mode, grid, smem, st, b, geo);
    case 4:
      return launch_mode<4>(mode, grid, smem, st, b, geo);
    case 5:
      return launch_mode<5>(mode, grid, smem, st, b, geo);
    case 6:
      return launch_mode<6>(mode, grid, smem, st, b, geo);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t to_f32(const void* acc, void* out, const void* scale_exp,
                   long long total, int k, int w, cudaStream_t st) {
  const int tpb = 256;
  fixed_to_f32_kernel<<<(unsigned)((total + tpb - 1) / tpb), tpb, 0, st>>>(
      (const long long*)acc, (float*)out, (const int32_t*)scale_exp, total,
      k, w);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `acc` must be zeroed by the
// caller: int64 (bf16 or f32 input, `mode` 0 or 2) or int32 (int8 input,
// `mode` 1) of G*NB*K*W cells.
// `slots` is int16 scratch of n entries; for w > 1 the rows are sorted,
// and `counts` is int32 scratch of pre_blocks * tiles entries, `list` of
// n, `tile_range` int64 of 2 * tiles (all three unused at w = 1).  For bf16
// and f32 input `out_f32` receives the converted histogram (null: the
// launch only adds into `acc`); for int8 input the int32 accumulator is the
// output.  The launch shape comes from
// ops/hist_cuda.py `_geometry`.  Returns the CUDA error code of the
// launches (0 on success).
extern "C" int wave_hist_launch(const void* bins_t, const void* leaf_id,
                                const void* ghk, const void* pending,
                                const void* scale_exp, void* slots,
                                void* counts, void* list, void* tile_range,
                                void* acc, void* out_f32, long long n, int g,
                                int nb, int k, int w, int wt, int gb,
                                int tiles, int splits, int pre_blocks,
                                long long pre_rows, int leaf_bound, int mode,
                                long long smem, void* stream) {
  if (wt < 1 || gb < 1 || splits < 1 || tiles < 1 || pre_blocks < 1 ||
      (long long)tiles * wt < w)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int sorted = w > 1 ? tiles : 0;  // tiles the pre-pass counts
  const size_t pre_smem = (size_t)sorted * 4 + (size_t)leaf_bound * 2;
  row_slots_kernel<<<pre_blocks, PRE_THREADS, pre_smem, st>>>(
      (const int32_t*)leaf_id, (const int32_t*)pending, (int16_t*)slots,
      (int*)counts, n, w, leaf_bound, wt, sorted, pre_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (sorted) {
    tile_offsets_kernel<<<1, PRE_THREADS, (size_t)tiles * 8, st>>>(
        (int*)counts, (long long*)tile_range, pre_blocks, tiles);
    scatter_rows_kernel<<<pre_blocks, PRE_THREADS, (size_t)tiles * 4, st>>>(
        (const int16_t*)slots, (const int*)counts, (int*)list, n, wt, tiles,
        pre_rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }

  const Geo geo{n, -1, g, nb, w, wt, gb, splits};
  const dim3 grid((unsigned)(tiles * splits), (unsigned)((g + gb - 1) / gb),
                  1);
  const Buffers buf{(const uint8_t*)bins_t, (const int16_t*)slots, ghk,
                    (const int32_t*)scale_exp,
                    sorted ? (const int*)list : nullptr,
                    (const long long*)tile_range, acc};
  e = launch_any(k, mode, grid, (size_t)smem, st, buf, geo);
  if (e != cudaSuccess || mode == INT8 || out_f32 == nullptr) return (int)e;
  return (int)to_f32(acc, out_f32, scale_exp, (long long)g * nb * k * w, k,
                     w, st);
}

// One slot over the caller's `m` rows `rows` (int32 indices into the n
// columns of bins_t and the n rows of ghk; any order, no repeats needed for
// exactness): acc and out_f32 as above with W = 1.  The grid is `splits`
// parts of the list x the group tiles of `gb` groups.
extern "C" int wave_hist_rows_launch(const void* bins_t, const void* ghk,
                                     const void* rows, const void* scale_exp,
                                     void* acc, void* out_f32, long long n,
                                     long long m, int g, int nb, int k,
                                     int gb, int splits, int mode,
                                     long long smem, void* stream) {
  if (gb < 1 || splits < 1 || m < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Geo geo{n, m, g, nb, 1, 1, gb, splits};
  const dim3 grid((unsigned)splits, (unsigned)((g + gb - 1) / gb), 1);
  const Buffers buf{(const uint8_t*)bins_t, nullptr, ghk,
                    (const int32_t*)scale_exp, (const int*)rows, nullptr,
                    acc};
  cudaError_t e = launch_any(k, mode, grid, (size_t)smem, st, buf, geo);
  if (e != cudaSuccess || mode == INT8 || out_f32 == nullptr) return (int)e;
  return (int)to_f32(acc, out_f32, scale_exp, (long long)g * nb * k, k, 1,
                     st);
}

// The conversion alone: `total` int64 fixed-point cells of a (rows, k, w)
// accumulator to f32 with the columns' scales 2^-scale_exp[k].  The sharded
// wrappers launch every shard into one accumulator with a null `out_f32`,
// then convert once.
extern "C" int wave_hist_to_f32(const void* acc, void* out_f32,
                                const void* scale_exp, long long total,
                                int k, int w, void* stream) {
  if (k < 1 || w < 1 || total < 0) return (int)cudaErrorInvalidValue;
  return (int)to_f32(acc, out_f32, scale_exp, total, k, w,
                     reinterpret_cast<cudaStream_t>(stream));
}
