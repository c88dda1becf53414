// Packed-forest prediction: route every query row through every tree of a
// packed ensemble (or of one tenant of a stacked fleet) and return either
// the per-class sums of the reached leaf values or the leaf indices.
//
// Replaces the XLA program of the JAX package's packed-forest traversal,
// lightgbm_tpu/serve/packed.py::_traverse / _apply_scores / _apply_leaves
// and lightgbm_tpu/serve/fleet.py::_fleet_traverse / _fleet_scores /
// _fleet_leaves.  That program advances the whole (rows x trees) lattice
// one level per step of a lax.scan over the padded depth, so every pair
// pays max_depth steps of gathers.  Here one thread owns one row: it walks
// each tree from the root until it reaches a leaf (a finished pair costs
// nothing more), the loop capped at max_depth as the scan is.
//
// Decision semantics are route_left's (serve/packed.py), bit for bit:
// thresholds are hi/lo float32 pairs, the query value is split the same
// way inside the kernel (__double2float_rn; a non-finite hi takes lo = 0),
// the compare is (zhi < thi) | (zhi == thi & zlo <= tlo), NaN is zeroed
// unless the missing type is NaN, zero-missing tests |v| <= kZero, and a
// categorical value becomes an integer by truncation corrected by the sign
// of lo when hi is integral.  Every conversion is a round-to-nearest
// intrinsic; the library is built without fast-math, so denormals are
// kept and compare as numpy compares them.
//
// Scores sum the float32 leaf values of class k's trees (t = k, k + K,
// ...) in tree order, starting from +0, with __fadd_rn: the plain PyTorch
// version does the same adds in the same order, so the two agree bit for
// bit.  bf16 leaf values (the fleet's value_dtype="bf16") widen to f32
// before the add.
//
// What bounds it: the bytes of the function are the query rows read once,
// the outputs written once and the pack, which at the main path's shapes
// take well under a millisecond at 3.35 TB/s.  The walk is a chain of
// dependent loads (node -> feature -> value -> child), so node-visit
// latency sets the time.  Each block stages its rows' feature values,
// already split into (hi, lo), in shared memory (feature-major, so a
// warp's reads of one feature at its 32 rows hit 32 banks whatever
// feature each lane reads); the tree tables are small and stay in L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;                 // rows (threads) per block
constexpr int kStageBytes = 48 * 1024;      // dynamic shared memory without
                                            // an opt-in attribute
constexpr float kCatClip = 2.0e9f;          // exact in f32; < 2^31

struct Forest {
  const int* split_feature;
  const float* threshold_hi;
  const float* threshold_lo;
  const int* decision_type;
  const int* left_child;
  const int* right_child;
  const int* cat_start;
  const int* cat_len;
  const unsigned* cat_words;
  const void* leaf_value;
  const unsigned char* is_stump;
  int trees;        // T (padded), per tenant
  int nodes;        // N (padded internal nodes)
  int leaves;       // L = N + 1
  int words;        // W (padded bitset words), per tenant
  int num_model;    // K
  int max_depth;
  float k_zero;
};

__device__ __forceinline__ void split_hi_lo(double v, float& hi, float& lo) {
  hi = __double2float_rn(v);
  lo = isfinite(hi) ? __double2float_rn(__dsub_rn(v, (double)hi)) : 0.0f;
}

// goes-left at node i of the (tenant's) flattened node tables
__device__ __forceinline__ bool route_left(const Forest& f, long long i,
                                           const unsigned* words_m,
                                           float vhi, float vlo) {
  const int dt = __ldg(f.decision_type + i);
  const int missing = (dt >> 2) & 3;
  const bool nan_v = isnan(vhi);
  const float zhi = (nan_v && missing != 2) ? 0.0f : vhi;
  const float zlo = nan_v ? 0.0f : vlo;
  if (!(dt & 1)) {
    const bool is_miss = (missing == 1 && fabsf(zhi) <= f.k_zero) ||
                         (missing == 2 && nan_v);
    if (is_miss) return (dt & 2) != 0;
    const float thi = __ldg(f.threshold_hi + i);
    return (zhi < thi) || (zhi == thi && zlo <= __ldg(f.threshold_lo + i));
  }
  int iv;
  if (nan_v) {
    iv = missing == 2 ? -1 : 0;
  } else {
    const float zc = fminf(fmaxf(zhi, -kCatClip), kCatClip);
    const int iv0 = __float2int_rz(zc);
    const bool integral = zc == __int2float_rn(iv0);
    iv = iv0 - (integral && zc > 0.0f && zlo < 0.0f ? 1 : 0)
             + (integral && zc < 0.0f && zlo > 0.0f ? 1 : 0);
  }
  const int widx = iv >> 5;
  if (iv < 0 || widx >= __ldg(f.cat_len + i)) return false;
  const unsigned word = __ldg(words_m + __ldg(f.cat_start + i) + widx);
  return ((word >> (iv & 31)) & 1u) != 0;
}

template <typename XT, bool kBF16, bool kLeaves, bool kStage>
__global__ void __launch_bounds__(kBlock) forest_predict_kernel(
    const XT* __restrict__ x, long long n_rows, long long row_stride, int nf,
    const int* __restrict__ tenant, Forest f, float* __restrict__ scores,
    int* __restrict__ leaves) {
  extern __shared__ float2 stage[];   // (nf, kBlock) when kStage
  const long long row0 = (long long)blockIdx.x * kBlock;
  const long long r = row0 + threadIdx.x;
  if (kStage) {
    const int rows_here = (int)min((long long)kBlock, n_rows - row0);
    for (int e = threadIdx.x; e < rows_here * nf; e += kBlock) {
      const int rr = e / nf, ff = e - rr * nf;
      float hi, lo;
      split_hi_lo((double)x[(row0 + rr) * row_stride + ff], hi, lo);
      stage[ff * kBlock + rr] = make_float2(hi, lo);
    }
    __syncthreads();
  }
  if (r >= n_rows) return;
  const long long m = tenant ? (long long)__ldg(tenant + r) : 0;
  const long long tree0 = m * f.trees;
  const unsigned* words_m = f.cat_words + m * f.words;

  auto walk = [&](int t) -> int {
    const long long tb = tree0 + t;
    if (__ldg(f.is_stump + tb)) return 0;
    const long long nb = tb * f.nodes;
    int node = 0;
    for (int d = 0; d < f.max_depth; ++d) {
      const long long i = nb + node;
      const int feat = __ldg(f.split_feature + i);
      float vhi, vlo;
      if (kStage) {
        const float2 p = stage[feat * kBlock + threadIdx.x];
        vhi = p.x;
        vlo = p.y;
      } else {
        split_hi_lo((double)__ldg(x + r * row_stride + feat), vhi, vlo);
      }
      node = route_left(f, i, words_m, vhi, vlo) ? __ldg(f.left_child + i)
                                                 : __ldg(f.right_child + i);
      if (node < 0) break;
    }
    // a node still >= 0 after max_depth steps maps as the scan maps it
    return ~node;
  };

  if (kLeaves) {
    for (int t = 0; t < f.trees; ++t) leaves[r * f.trees + t] = walk(t);
    return;
  }
  for (int k = 0; k < f.num_model; ++k) {
    float acc = 0.0f;
    for (int t = k; t < f.trees; t += f.num_model) {
      const long long li = (tree0 + t) * f.leaves + walk(t);
      float v;
      if (kBF16) {
        v = __bfloat162float(
            static_cast<const __nv_bfloat16*>(f.leaf_value)[li]);
      } else {
        v = __ldg(static_cast<const float*>(f.leaf_value) + li);
      }
      acc = __fadd_rn(acc, v);
    }
    scores[k * n_rows + r] = acc;
  }
}

template <typename XT, bool kBF16, bool kLeaves>
void launch3(bool stage, const void* x, long long n_rows,
             long long row_stride, int nf, const int* tenant, const Forest& f,
             float* scores, int* leaves, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n_rows + kBlock - 1) / kBlock);
  const XT* xt = static_cast<const XT*>(x);
  if (stage) {
    const size_t smem = (size_t)nf * kBlock * sizeof(float2);
    forest_predict_kernel<XT, kBF16, kLeaves, true><<<grid, kBlock, smem,
                                                      stream>>>(
        xt, n_rows, row_stride, nf, tenant, f, scores, leaves);
  } else {
    forest_predict_kernel<XT, kBF16, kLeaves, false><<<grid, kBlock, 0,
                                                       stream>>>(
        xt, n_rows, row_stride, nf, tenant, f, scores, leaves);
  }
}

template <typename XT>
void launch2(bool bf16, bool want_leaves, bool stage, const void* x,
             long long n_rows, long long row_stride, int nf,
             const int* tenant, const Forest& f, float* scores, int* leaves,
             cudaStream_t stream) {
  if (want_leaves) {
    launch3<XT, false, true>(stage, x, n_rows, row_stride, nf, tenant, f,
                             scores, leaves, stream);
  } else if (bf16) {
    launch3<XT, true, false>(stage, x, n_rows, row_stride, nf, tenant, f,
                             scores, leaves, stream);
  } else {
    launch3<XT, false, false>(stage, x, n_rows, row_stride, nf, tenant, f,
                              scores, leaves, stream);
  }
}

}  // namespace

// Launch on `stream`.  x: (n_rows, >= nf) f64 (x_f64 = 1) or f32 rows with
// `row_stride` elements between rows; tenant: (n_rows,) int32 tenant ids or
// null (tenant 0); tables of every tenant back to back, (M, T, N) node
// tables, (M, W) words, (M, T, L) leaf values (f32 or bf16), (M, T) stump
// flags.  Writes scores (K, n_rows) f32 when `scores` is not null, else
// leaves (n_rows, T) int32.  Returns the CUDA error of the launch.
extern "C" int forest_predict_launch(
    const void* x, int x_f64, long long n_rows, long long row_stride, int nf,
    const int* tenant, const int* split_feature, const float* threshold_hi,
    const float* threshold_lo, const int* decision_type,
    const int* left_child, const int* right_child, const int* cat_start,
    const int* cat_len, const unsigned* cat_words, const void* leaf_value,
    int value_bf16, const unsigned char* is_stump, int trees, int nodes,
    int leaves_per_tree, int words, int num_model, int max_depth,
    float k_zero, float* scores, int* leaves, void* stream) {
  if (n_rows <= 0) return 0;
  Forest f{split_feature, threshold_hi, threshold_lo, decision_type,
           left_child,    right_child,  cat_start,    cat_len,
           cat_words,     leaf_value,   is_stump,     trees,
           nodes,         leaves_per_tree, words,     num_model,
           max_depth,     k_zero};
  const bool stage = (long long)nf * kBlock * (long long)sizeof(float2) <=
                     kStageBytes;
  const bool want_leaves = scores == nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f64) {
    launch2<double>(value_bf16 != 0, want_leaves, stage, x, n_rows,
                    row_stride, nf, tenant, f, scores, leaves, s);
  } else {
    launch2<float>(value_bf16 != 0, want_leaves, stage, x, n_rows,
                   row_stride, nf, tenant, f, scores, leaves, s);
  }
  return (int)cudaGetLastError();
}
