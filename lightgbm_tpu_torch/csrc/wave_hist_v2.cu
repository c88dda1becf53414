// Wave histogram as a one-hot matrix product on the tensor cores,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py::_wave_hist_pallas_v2
// (body _kernel_v2, helpers _build_bmat/_pair_one_hot).  It computes the same
// function as csrc/wave_hist.cu:
//
//   out[(g*NB + b), k, w] = sum of ghk[r, k] over rows r with
//                           bins_t[g, r] == b and leaf_id[r] == pending[w]
//
// for bf16 stat columns only (as the TPU kernel), any wave width W,
// duplicate pending ids (each slot is its own column) and empty slots
// (pending < 0: the column stays zero).
//
// What it keeps from the TPU kernel: the formulation.  The histogram is the
// product out(G*NB, B) = onehot^T(G*NB, rows) @ bmat(rows, B), B = K*W
// columns (column kk*W + w holds stat kk of wave slot w).  bmat, the leaf
// mask times the stat columns, is built per chunk of rows in shared memory;
// the one-hot A fragments are built in registers from the bin codes and
// never written anywhere.  The products run on warp-level
// mma.sync.m16n8k16 bf16 -> f32 (wgmma/TMA are later work).
//
// What it does differently: the TPU grid walks the row chunks in order and
// accumulates in one VMEM tile.  Hopper blocks run in no order, so the grid
// is (row splits, output-row tiles, column tiles); each block reduces its
// own run of rows into registers and writes its partial tile, and a second
// kernel adds the partials of the row splits in a fixed order.  No float
// atomics: the result is bit-identical from run to run.
//
// What bounds it on this card: operations.  The dense product does
// 2 * n * G*NB * B flops, nearly all on zeros of the one-hot; at 2M rows,
// G=28, NB=64, W=128 (B=384) that is 2.75 TFLOP, ~2.8 ms at the 989
// TFLOP/s bf16 peak, against a bytes bound of ~25 us.  Building the A
// fragments costs about as many integer instructions as the mma does
// tensor-core work, so this simple kernel stays well below that peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output rows (group bins) per block
constexpr int BN = 64;         // output columns (stat x slot) per block
constexpr int CH = 128;        // data rows staged in shared memory per step
constexpr int PITCH = CH + 8;  // bf16 per bmat row: the pad spreads banks
constexpr int THREADS = 256;   // 8 warps: 4 along M (32 rows each) x 2 along N
constexpr int MAX_K = 8;
// groups a block's BM output rows can span (NB is a multiple of 32)
constexpr int MAX_GROUPS = BM / 32 + 1;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 one-hot entries of output row `bin`: 1.0 where the data row's
// bin code equals it (low half: the lower data row)
__device__ __forceinline__ unsigned one_hot2(unsigned bin, unsigned code_lo,
                                             unsigned code_hi) {
  return (code_lo == bin ? 0x3F80u : 0u) | (code_hi == bin ? 0x3F800000u : 0u);
}

__global__ void __launch_bounds__(THREADS)
wave_hist_v2_kernel(const uint8_t* __restrict__ bins_t,
                    const int32_t* __restrict__ leaf_id,
                    const __nv_bfloat16* __restrict__ ghk,
                    const int32_t* __restrict__ pending,
                    float* __restrict__ partial, long long n, int g, int nb,
                    int k, int w, int b_pad, long long rows_per_split) {
  __shared__ __align__(16) __nv_bfloat16 bmat_s[BN * PITCH];  // [col][row]
  __shared__ __align__(16) uint8_t bins_s[MAX_GROUPS][CH];
  __shared__ int leaf_s[CH];
  __shared__ __nv_bfloat16 ghk_s[CH * MAX_K];
  __shared__ int col_leaf[BN];  // leaf id a column selects (-2: none)
  __shared__ int col_stat[BN];  // stat a column carries

  const int m_total = g * nb;
  const int kw = k * w;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.z * BN;
  const int g_lo = m0 / nb;
  const int g_hi = min(g, (min(m0 + BM, m_total) - 1) / nb + 1);
  const long long r_begin = blockIdx.x * rows_per_split;
  const long long r_end = min(n, r_begin + rows_per_split);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm0 = m0 + (warp & 3) * 32;  // first output row of this warp
  const int wn0 = (warp >> 2) * 32;      // first column, within the block
  // a warp's 32 rows lie in one group; warps past the last row or column
  // compute nothing (their partials are never read)
  const bool live = wm0 < m_total && n0 + wn0 < kw;
  const int wg = wm0 / nb - g_lo;
  const unsigned wbin = (unsigned)(wm0 % nb);

  if (tid < BN) {
    const int c = n0 + tid;
    int leaf = -2, stat = 0;  // rows carry ids >= -1, so -2 matches none
    if (c < kw) {
      stat = c / w;
      const int p = pending[c - stat * w];
      if (p >= 0) leaf = p;
    }
    col_leaf[tid] = leaf;
    col_stat[tid] = stat;
  }
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (long long base = r_begin; base < r_end; base += CH) {
    const int rows = (int)min((long long)CH, r_end - base);
    __syncthreads();  // the previous step's tiles are consumed
    for (int i = tid; i < CH; i += THREADS)
      leaf_s[i] = i < rows ? leaf_id[base + i] : -1;
    for (int i = tid; i < (g_hi - g_lo) * CH; i += THREADS) {
      const int gi = i / CH, r = i - gi * CH;
      bins_s[gi][r] = r < rows ? bins_t[(long long)(g_lo + gi) * n + base + r]
                               : (uint8_t)0;
    }
    for (int i = tid; i < CH * k; i += THREADS)
      ghk_s[i] = i < rows * k ? ghk[base * k + i] : zero;
    __syncthreads();
    // bmat^T tile: bmat_s[c][r] = (leaf[r] == pending[slot(c)]) * ghk[r, stat(c)];
    // rows past the split's end carry leaf -1 and so stay zero
    for (int i = tid; i < BN * (CH / 2); i += THREADS) {
      const int c = i / (CH / 2), r = (i - c * (CH / 2)) * 2;
      const int cl = col_leaf[c], st = col_stat[c];
      const __nv_bfloat16 v0 = leaf_s[r] == cl ? ghk_s[r * k + st] : zero;
      const __nv_bfloat16 v1 =
          leaf_s[r + 1] == cl ? ghk_s[(r + 1) * k + st] : zero;
      *reinterpret_cast<__nv_bfloat162*>(&bmat_s[c * PITCH + r]) =
          __halves2bfloat162(v0, v1);
    }
    __syncthreads();
    if (!live) continue;
    const uint8_t* codes = bins_s[wg];
    for (int k0 = 0; k0 < rows; k0 += 16) {
      // this thread's data rows: k0 + 2*tig + {0, 1} and the same + 8
      const unsigned lo =
          *reinterpret_cast<const unsigned short*>(codes + k0 + tig * 2);
      const unsigned hi =
          *reinterpret_cast<const unsigned short*>(codes + k0 + tig * 2 + 8);
      const unsigned c0 = lo & 0xFFu, c1 = lo >> 8, c2 = hi & 0xFFu,
                     c3 = hi >> 8;
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned bin = wbin + i * 16 + gid;  // fragment rows bin, bin+8
        a[i][0] = one_hot2(bin, c0, c1);
        a[i][1] = one_hot2(bin + 8, c0, c1);
        a[i][2] = one_hot2(bin, c2, c3);
        a[i][3] = one_hot2(bin + 8, c2, c3);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* bp =
            bmat_s + (wn0 + j * 8 + gid) * PITCH + k0 + tig * 2;
        const unsigned b0 = *reinterpret_cast<const unsigned*>(bp);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(bp + 8);
        mma_bf16(acc[0][j], a[0], b0, b1);
        mma_bf16(acc[1][j], a[1], b0, b1);
      }
    }
  }
  if (!live) return;
  float* dst = partial + (long long)blockIdx.x * m_total * b_pad;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wm0 + i * 16 + gid;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn0 + j * 8 + tig * 2;
      if (row < m_total) {
        dst[(long long)row * b_pad + col] = acc[i][j][0];
        dst[(long long)row * b_pad + col + 1] = acc[i][j][1];
      }
      if (row + 8 < m_total) {
        dst[(long long)(row + 8) * b_pad + col] = acc[i][j][2];
        dst[(long long)(row + 8) * b_pad + col + 1] = acc[i][j][3];
      }
    }
  }
}

// out[m, c] = sum over the row splits, in split order, of partial[s, m, c]
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int splits,
                                    int m_total, int kw, int b_pad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)m_total * kw) return;
  const long long m = i / kw, c = i - m * kw;
  float s = 0.0f;
  for (int p = 0; p < splits; ++p)
    s += partial[((long long)p * m_total + m) * b_pad + c];
  out[i] = s;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `partial` is f32 scratch of
// splits * G*NB * b_pad cells (b_pad: K*W rounded up to a multiple of 64);
// `out` receives the (G*NB, K, W) f32 histogram.  NB must be a multiple of
// 32, K at most 8, rows_per_split a multiple of 128.  Returns the CUDA error
// code of the launches (0 on success).
extern "C" int wave_hist_v2_launch(const void* bins_t, const void* leaf_id,
                                   const void* ghk, const void* pending,
                                   void* partial, void* out, long long n,
                                   int g, int nb, int k, int w, int b_pad,
                                   int splits, long long rows_per_split,
                                   void* stream) {
  if (nb % 32 != 0 || nb > 256 || k < 1 || k > MAX_K || b_pad % BN != 0 ||
      rows_per_split % CH != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int m_total = g * nb;
  dim3 grid((unsigned)splits, (unsigned)((m_total + BM - 1) / BM),
            (unsigned)(b_pad / BN));
  wave_hist_v2_kernel<<<grid, THREADS, 0, st>>>(
      (const uint8_t*)bins_t, (const int32_t*)leaf_id,
      (const __nv_bfloat16*)ghk, (const int32_t*)pending, (float*)partial, n,
      g, nb, k, w, b_pad, rows_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)m_total * k * w;
  const int tpb = 256;
  sum_partials_kernel<<<(unsigned)((total + tpb - 1) / tpb), tpb, 0, st>>>(
      (const float*)partial, (float*)out, splits, m_total, k * w, b_pad);
  return (int)cudaGetLastError();
}
