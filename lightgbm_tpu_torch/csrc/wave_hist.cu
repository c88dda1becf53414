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
// for every wave width W and K in {3,4,5,6}.  The TPU kernel built a one-hot
// of the bins and contracted it on the MXU because the TPU has no scatter;
// here each row adds its K values into exactly one (bin, slot) cell of a
// block-private shared-memory histogram.
//
// What bounds it on this card: bytes.  A wave must read n*(G + 4 + 2K) bytes
// (bins, leaf ids, bf16 stat columns) and write G*NB*K*W*4 bytes; at 2M rows,
// G=28, K=3, W=128 that is ~76 MB + 11 MB, ~26 us at 3.35 TB/s.  The design:
//   * a pre-pass maps every row's leaf id to its wave slot (int16, -1 when
//     the leaf is not pending), so the main pass reads 2 bytes a row for
//     membership instead of a 4-byte leaf id and a table lookup;
//   * grid = (row tiles, group tiles, slot tiles); a block owns Gb groups'
//     NB x Wt x K tiles in shared memory.  Narrow waves (small Wt) pack many
//     groups into a block, so a row's slot and stats are loaded and
//     converted once for all of them;
//   * each thread takes 4 consecutive rows per step: one 8-byte load of
//     their slots and one 4-byte load of their bins per group, instead of
//     a chain of dependent scalar loads;
//   * stat columns are read only for rows whose slot is in the block's tile;
//     slots, bins and stats stay L2-resident across the slot tiles of a wave
//     (4 + 2 + 12 MB at 2M rows, against a 50 MB L2).
//   * 64-bit shared adds are two native 32-bit atomics (add_i64).
// It is not near that bound yet: wide waves re-read the slot array and the
// bins once per 16-slot tile (8 times at W=128); a cluster of blocks
// sharing one wave-wide tile through distributed shared memory would read
// them once.
//
// Determinism: no float atomics anywhere.  bf16 stats are converted to
// int64 fixed point with one power-of-two scale per stat column (chosen by
// the caller from max|column| and the row count, so no sum can overflow),
// accumulated with integer atomics in shared and then global memory, and
// converted to f32 at the end.  Integer addition is associative, so the
// result is bit-identical from run to run.  int8 stats accumulate in int32
// exactly like the TPU kernel's int8->int32 path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int ROWS = 4;       // rows per thread per step
constexpr int THREADS = 512;  // threads per block of the main pass
// two resident blocks per SM: caps registers at 64 a thread
constexpr int MIN_BLOCKS = 2;

// Exact 64-bit add into shared memory from two native 32-bit atomics: the
// low word's atomicAdd returns the old value, which tells whether the add
// carried into the high word.  (A 64-bit shared atomicAdd compiles to a
// compare-and-swap loop, measured ~3x slower at the root wave.)
__device__ __forceinline__ void add_i64(long long* cell, long long q) {
  unsigned* w32 = reinterpret_cast<unsigned*>(cell);
  const unsigned lo = (unsigned)q;
  const unsigned old = atomicAdd(w32, lo);
  const unsigned hi = (unsigned)((unsigned long long)q >> 32) + (old + lo < old);
  if (hi) atomicAdd(w32 + 1, hi);
}

// slot of every row: index into pending, or -1
__global__ void row_slots_kernel(const int32_t* __restrict__ leaf_id,
                                 const int32_t* __restrict__ pending,
                                 int16_t* __restrict__ slot_of_row,
                                 long long n, int w, int leaf_bound) {
  extern __shared__ int16_t slot_of_leaf[];  // [leaf_bound]
  for (int i = threadIdx.x; i < leaf_bound; i += blockDim.x)
    slot_of_leaf[i] = -1;
  __syncthreads();
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    const int leaf = pending[j];
    // empty slots (pending < 0) stay zero; pending leaves are distinct
    if (leaf >= 0 && leaf < leaf_bound) slot_of_leaf[leaf] = (int16_t)j;
  }
  __syncthreads();
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    const int leaf = leaf_id[r];
    slot_of_row[r] =
        (leaf >= 0 && leaf < leaf_bound) ? slot_of_leaf[leaf] : (int16_t)-1;
  }
}

template <int K, bool QUANT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
wave_hist_kernel(const uint8_t* __restrict__ bins_t,
                                 const int16_t* __restrict__ slot_of_row,
                                 const void* __restrict__ ghk_raw,
                                 const int32_t* __restrict__ scale_exp,
                                 void* __restrict__ acc_raw, long long n,
                                 int g_total, int nb, int w, int wt, int gb,
                                 long long rows_per_block, int vec) {
  using Acc = typename std::conditional<QUANT, int, long long>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* cells = reinterpret_cast<Acc*>(smem_raw);  // [gb][nb][K][wt]
  const int ncell = gb * nb * K * wt;

  const int g0 = blockIdx.y * gb;
  const int g_here = min(gb, g_total - g0);
  const int slot0 = blockIdx.z * wt;
  const int wt_here = min(wt, w - slot0);

  for (int i = threadIdx.x; i < ncell; i += blockDim.x) cells[i] = 0;
  int exps[K];
#pragma unroll
  for (int k = 0; k < K; ++k) exps[k] = QUANT ? 0 : scale_exp[k];
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  for (long long base = r0 + (long long)ROWS * threadIdx.x; base < r1;
       base += (long long)ROWS * blockDim.x) {
    const bool full = vec && base + ROWS <= r1;
    int ls[ROWS];  // slot within this tile, -1 when the row is not in it
    if (full) {
      const uint2 raw = *reinterpret_cast<const uint2*>(slot_of_row + base);
      const int16_t* s = reinterpret_cast<const int16_t*>(&raw);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) ls[i] = s[i];
    } else {
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        ls[i] = base + i < r1 ? slot_of_row[base + i] : -1;
    }
    unsigned hit = 0;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      ls[i] -= slot0;
      if (ls[i] >= 0 && ls[i] < wt_here) hit |= 1u << i;
    }
    if (!hit) continue;

    // stats of the rows in the tile, as 32-bit values (registers are the
    // scarce resource here); the fixed-point conversion happens per add
    float v[ROWS][K];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        v[i][k] = 0.0f;
        if (!(hit >> i & 1)) continue;
        const long long at = (base + i) * K + k;
        if (QUANT)
          v[i][k] = reinterpret_cast<const int8_t*>(ghk_raw)[at];
        else
          v[i][k] = ldexpf(__bfloat162float(reinterpret_cast<
                               const __nv_bfloat16*>(ghk_raw)[at]),
                           exps[k]);
      }
    }

    for (int gi = 0; gi < g_here; ++gi) {
      const uint8_t* col = bins_t + (long long)(g0 + gi) * n;
      uint8_t b8[ROWS];
      if (full) {
        const unsigned raw = *reinterpret_cast<const unsigned*>(col + base);
        const uint8_t* bb = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) b8[i] = bb[i];
      } else {
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          b8[i] = base + i < r1 ? col[base + i] : 0;
      }
      Acc* tile = cells + (long long)gi * nb * K * wt;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        if (!(hit >> i & 1) || b8[i] >= nb) continue;
        Acc* cell = tile + (b8[i] * K) * wt + ls[i];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (v[i][k] == 0.0f) continue;
          if (QUANT)
            atomicAdd(reinterpret_cast<int*>(cell + k * wt), (int)v[i][k]);
          else
            add_i64(reinterpret_cast<long long*>(cell + k * wt),
                    __float2ll_rn(v[i][k]));
        }
      }
    }
  }
  __syncthreads();

  // flush the tiles: integer atomics into the (G*NB, K, W) accumulator
  for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
    const int j = i % wt;
    if (j >= wt_here) continue;
    const Acc v = cells[i];
    if (v == 0) continue;
    const int gbk = i / wt;  // (gi*nb + b)*K + k
    const long long o = ((long long)g0 * nb * K + gbk) * w + slot0 + j;
    if (QUANT)
      atomicAdd(reinterpret_cast<int*>(acc_raw) + o, (int)v);
    else
      atomicAdd(reinterpret_cast<unsigned long long*>(acc_raw) + o,
                (unsigned long long)v);
  }
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

template <int K, bool QUANT>
cudaError_t launch_k(dim3 grid, size_t smem, cudaStream_t st,
                     const void* bins_t, const int16_t* slots,
                     const void* ghk, const void* scale_exp, void* acc,
                     long long n, int g, int nb, int w, int wt, int gb,
                     long long rpb, int vec) {
  auto kern = wave_hist_kernel<K, QUANT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, THREADS, smem, st>>>((const uint8_t*)bins_t, slots, ghk,
                                    (const int32_t*)scale_exp, acc, n, g, nb,
                                    w, wt, gb, rpb, vec);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `acc` must be zeroed by the
// caller: int64 (bf16 input) or int32 (int8 input) of G*NB*K*W cells.
// `slots` is int16 scratch of n entries.  For bf16 input `out_f32`
// receives the converted histogram; for int8 input the int32 accumulator
// is the output.  Returns the CUDA error code of the launches (0 on
// success).
extern "C" int wave_hist_launch(const void* bins_t, const void* leaf_id,
                                const void* ghk, const void* pending,
                                const void* scale_exp, void* slots,
                                void* acc, void* out_f32, long long n, int g,
                                int nb, int k, int w, int wt, int gb,
                                int leaf_bound, long long row_tiles,
                                long long rows_per_block, int quant,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long pre_blocks =
      std::max<long long>(std::min<long long>((n + 1023) / 1024, 1024), 1);
  row_slots_kernel<<<(unsigned)pre_blocks, 1024,
                     (size_t)leaf_bound * sizeof(int16_t), st>>>(
      (const int32_t*)leaf_id, (const int32_t*)pending, (int16_t*)slots, n,
      w, leaf_bound);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t cell_bytes = quant ? 4 : 8;
  const size_t smem = (size_t)gb * nb * k * wt * cell_bytes;
  dim3 grid((unsigned)row_tiles, (unsigned)((g + gb - 1) / gb),
            (unsigned)((w + wt - 1) / wt));
  // vector loads need aligned group columns and row tiles
  const int vec = (n % ROWS == 0) && (rows_per_block % ROWS == 0);
  const int16_t* sl = (const int16_t*)slots;
  e = cudaErrorInvalidValue;
#define WH_CASE(KK)                                                          \
  case KK:                                                                   \
    e = quant ? launch_k<KK, true>(grid, smem, st, bins_t, sl, ghk,          \
                                   scale_exp, acc, n, g, nb, w, wt, gb,      \
                                   rows_per_block, vec)                      \
              : launch_k<KK, false>(grid, smem, st, bins_t, sl,              \
                                    ghk, scale_exp, acc, n, g, nb, w, wt,    \
                                    gb, rows_per_block, vec);                \
    break;
  switch (k) {
    WH_CASE(3)
    WH_CASE(4)
    WH_CASE(5)
    WH_CASE(6)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WH_CASE
  if (e != cudaSuccess || quant) return (int)e;
  const long long total = (long long)g * nb * k * w;
  const int tpb = 256;
  fixed_to_f32_kernel<<<(unsigned)((total + tpb - 1) / tpb), tpb, 0, st>>>(
      (const long long*)acc, (float*)out_f32, (const int32_t*)scale_exp,
      total, k, w);
  return (int)cudaGetLastError();
}
