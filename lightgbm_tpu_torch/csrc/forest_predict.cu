// Packed-forest prediction: route every query row through every tree of a
// packed ensemble (or of one tenant of a stacked fleet) and return either
// the per-class sums of the reached leaf values or the leaf indices.
//
// Replaces the XLA program of the JAX package's packed-forest traversal,
// lightgbm_tpu/serve/packed.py::_traverse / _apply_scores / _apply_leaves
// and lightgbm_tpu/serve/fleet.py::_fleet_traverse / _fleet_scores /
// _fleet_leaves.  That program advances the whole (rows x trees) lattice
// one level per step of a lax.scan over the padded depth, so every pair
// pays max_depth steps of gathers.  Here each walk leaves a tree at its
// leaf (a finished pair costs nothing more), the loop capped at max_depth
// as the scan is.
//
// Decision semantics are route_left's (serve/packed.py), bit for bit:
// thresholds are hi/lo float32 pairs, the query value is split the same
// way inside the kernel (__double2float_rn; a non-finite hi takes lo = 0;
// an f32 value widens exactly, so its lo is 0), the compare is
// (zhi < thi) | (zhi == thi & zlo <= tlo), NaN is zeroed unless the
// missing type is NaN, zero-missing tests |v| <= kZero, and a categorical
// value becomes an integer by truncation corrected by the sign of lo when
// hi is integral.  Every conversion is a round-to-nearest intrinsic; the
// library is built without fast-math, so denormals are kept and compare as
// numpy compares them.
//
// Scores sum the float32 leaf values of class k's trees (t = k, k + K,
// ...) in tree order, starting from +0, with __fadd_rn: the plain PyTorch
// version does the same adds in the same order, so the two agree bit for
// bit.  bf16 leaf values (the fleet's value_dtype="bf16") were widened to
// f32 when the records were built, which is exact.
//
// What bounds it: the bytes of the function are the query rows read once
// and the outputs written once (the pack is small), well under a
// millisecond at 3.35 TB/s; the walk is a chain of dependent loads (node
// -> feature -> value -> child) that the lanes of a warp take in lockstep,
// each tree costing the deepest lane's path, so issued instructions and
// shared-memory wavefronts a visit set the time.  The design:
//
// * The node-record table (serve/packed.py::forest_records): a tree is one
//   row of S words, node i's threshold pair and children one 16-byte load
//   at 4i, its feature and decision type one word at 4N + i, the leaf
//   values after them.  A visit is two independent loads where the tables
//   took six dependent ones; categorical nodes alone read their
//   (start, len) pair and bitset word from global memory.  Trees past a
//   tenant's last non-padding tree (stumps of value 0) are skipped.
// * Route "rows" (large batches, and a few rows against a few trees): a
//   thread owns one row; a block's rows are staged in shared memory
//   row-major at an odd pitch (f64 rows as (hi, lo) pairs, f32 rows as hi
//   alone; written and read without bank conflicts, 8 loads in flight a
//   thread), and the trees stream through shared memory in chunks: one
//   thread issues a cp.async.bulk copy of chunk c + 2 into a two-chunk
//   ring (completing on an mbarrier) while the block walks chunk c + 1.
//   The lanes of a warp walk the same tree together, one tree after
//   another, so reads near the root are broadcasts (lanes that claim their
//   next tree on their own, or several trees a thread at once, measured
//   slower: PERF.md).  The per-class sums stay in a register (K = 1) or
//   the thread's shared-memory column, added in tree order.  Leaves go
//   through a shared tile (odd pitch) so that each row's run of a chunk's
//   trees is one coalesced store.  Where a tree does not fit the ring (or
//   a fleet has more tenants than the grouping counts) the chunks are read
//   from global memory, and where the rows do not fit either, each visit
//   also reads its value from global memory.  The geometry keeps the most
//   rows resident an SM.
// * A fleet's rows are grouped by tenant before a rows-route launch with
//   a counting sort (per-block counts, one offsets block, a scatter with
//   shared-memory cursors, as csrc/wave_hist.cu sorts rows by slot tile):
//   every block then serves one tenant and copies that tenant's chunks.
// * Route "trees" (small batches): a block serves one row or a few, its
//   threads walk different trees straight from the records in global
//   memory (L2-resident after the first request), kTreeWalks walks a
//   thread, each claiming the thread's next tree as soon as it reaches a
//   leaf; the leaf values of a pass go to shared memory, and one thread a
//   class adds them in tree order.  A 1-row request against 512 trees is a
//   few walks' latency and 512 adds, not 512 walks in one thread.
//
// serve/packed.py::forest_geometry chooses the route (choose_route, from
// crossovers measured on the card) and every size (rows a block, trees a
// chunk, shared memory) and passes them here; the
// launcher recomputes the shared-memory layout and refuses a mismatch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTreeWalks = 2;  // packed.TREE_WALKS
constexpr int kDtBits = 4;      // packed._DT_BITS
constexpr float kCatClip = 2.0e9f;  // exact in f32; < 2^31

struct Params {
  const void* x;
  long long n_rows;
  long long row_stride;
  int nf;
  const int* tenant;      // (n_rows,) or null: tenant 0
  int tenants;            // M
  const int* blob;        // (M, T, S) node records
  const int2* cat;        // (M, T, N) (cat_start, cat_len)
  const unsigned* words;  // (M, W) bitset words
  const int* live;        // (M,) trees up to the last that is not padding
  int trees;              // T (padded), per tenant
  int nodes;              // N (padded internal nodes)
  int tree_words;         // S
  int words_per_tenant;   // W
  int num_model;          // K
  int max_depth;
  float k_zero;
  int rows_per_block;
  int chunk_trees;
  // the tenant grouping (rows route over a fleet), else null
  const int* order;       // (n_rows,) row indices grouped by tenant
  const int* row_off;     // (M + 1,) first grouped index of each tenant
  const int* tile_off;    // (M + 1,) first block of each tenant
  float* scores;          // (K, n_rows), or null
  int* leaves;            // (n_rows, T), or null
};

// ---- small helpers ---------------------------------------------------------

__device__ __forceinline__ void split_hi_lo(double v, float& hi, float& lo) {
  hi = __double2float_rn(v);
  lo = isfinite(hi) ? __double2float_rn(__dsub_rn(v, (double)hi)) : 0.0f;
}

template <bool kSmem>
__device__ __forceinline__ int ld1(const int* p) {
  if constexpr (kSmem) {
    return *p;
  } else {
    return __ldg(p);
  }
}

template <bool kSmem>
__device__ __forceinline__ int4 ld4(const int* p) {
  if constexpr (kSmem) {
    return *reinterpret_cast<const int4*>(p);
  } else {
    return __ldg(reinterpret_cast<const int4*>(p));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// bulk copy global -> shared (16-byte aligned, size a multiple of 16),
// completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// goes-left at a node: decision type `dt`, threshold pair (thi, tlo), the
// query value (vhi, vlo); a categorical node reads its (start, len) at `cn`
// and its bitset word of the tenant's `words_m`
__device__ __forceinline__ bool route_left(int dt, float thi, float tlo,
                                           float vhi, float vlo, float k_zero,
                                           const int2* cn,
                                           const unsigned* words_m) {
  const int missing = (dt >> 2) & 3;
  const bool nan_v = isnan(vhi);
  const float zhi = (nan_v && missing != 2) ? 0.0f : vhi;
  const float zlo = nan_v ? 0.0f : vlo;
  if (!(dt & 1)) {
    const bool is_miss = (missing == 1 && fabsf(zhi) <= k_zero) ||
                         (missing == 2 && nan_v);
    if (is_miss) return (dt & 2) != 0;
    return (zhi < thi) || (zhi == thi && zlo <= tlo);
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
  const int2 cs = __ldg(cn);
  const int widx = iv >> 5;
  if (iv < 0 || widx >= cs.y) return false;
  const unsigned word = __ldg(words_m + cs.x + widx);
  return ((word >> (iv & 31)) & 1u) != 0;
}

// The query value of feature `f` for the walking thread: from the staged
// rows (row-major, `pitch` = nf | 1 values a row, an odd count, so that a
// warp's reads of 32 rows hit 32 banks whatever feature each lane reads;
// this thread's row `i`), or from global memory (row `r`) when the rows
// are not staged.
template <typename XT, bool kStage>
__device__ __forceinline__ void query_value(const Params& p,
                                            const void* stage, int pitch,
                                            int i, long long r, int f,
                                            float& vhi, float& vlo) {
  if constexpr (kStage) {
    if constexpr (sizeof(XT) == 8) {
      const float2 v = static_cast<const float2*>(stage)[i * pitch + f];
      vhi = v.x;
      vlo = v.y;
    } else {
      vhi = static_cast<const float*>(stage)[i * pitch + f];
      vlo = 0.0f;
    }
  } else {
    const XT v = __ldg(static_cast<const XT*>(p.x) + r * p.row_stride + f);
    if constexpr (sizeof(XT) == 8) {
      split_hi_lo(v, vhi, vlo);
    } else {
      vhi = v;
      vlo = 0.0f;
    }
  }
}

// Stage `rows` query rows (row i of the batch at row_of(i)) into shared
// memory, row-major at `pitch` values a row: f64 values split into (hi,
// lo) pairs, f32 values as they are.  Consecutive threads read consecutive
// values of a row and write consecutive words; each thread keeps kStageLoads
// loads in flight.
template <typename XT, typename RowOf>
__device__ __forceinline__ void stage_rows(const Params& p, void* stage,
                                           int pitch, int rows,
                                           RowOf&& row_of) {
  constexpr int kStageLoads = 8;
  const int total = rows * p.nf;
  const XT* x = static_cast<const XT*>(p.x);
  for (int e0 = threadIdx.x; e0 < total; e0 += kStageLoads * blockDim.x) {
    XT v[kStageLoads];
    int at[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      at[u] = -1;
      if (e < total) {
        const int i = e / p.nf, f = e - i * p.nf;
        v[u] = __ldg(x + row_of(i) * p.row_stride + f);
        at[u] = i * pitch + f;
      }
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      if (at[u] < 0) continue;
      if constexpr (sizeof(XT) == 8) {
        float hi, lo;
        split_hi_lo(v[u], hi, lo);
        static_cast<float2*>(stage)[at[u]] = make_float2(hi, lo);
      } else {
        static_cast<float*>(stage)[at[u]] = v[u];
      }
    }
  }
}

// Walk trees to their leaves, W walks at once.  `claim()` gives the next
// tree to walk (an index into `base`'s rows of S words and `cat_base`'s
// rows of N pairs), or -1 when there is none; `finish(t, leaf)` takes each
// reached leaf.  A walk that reaches its leaf claims the next tree at once,
// so a warp runs until its slowest lane has walked all its trees, not to
// the deepest lane of every tree.  Each step first issues every walk's
// loads (an idle walk reads tree 0's root, a valid address), then the
// query values, then decides: the W loads are in flight together instead
// of one walk's after another's.  A walk still at a node after max_depth
// steps finishes there (~node), as the scan does.
template <int W, typename XT, bool kSmem, bool kStage, typename Claim,
          typename Finish>
__device__ __forceinline__ void walk_claimed(
    const Params& p, const int* base, const int2* cat_base,
    const unsigned* words_m, const void* stage, int pitch, int i,
    long long r, Claim&& claim, Finish&& finish) {
  const int S = p.tree_words, N = p.nodes, n4 = 4 * p.nodes;
  int cur[W], node[W], depth[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    cur[j] = claim();
    node[j] = 0;
    depth[j] = 0;
  }
  while (true) {
    int word[W];
    int4 rec[W];
    bool any = false;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      any |= cur[j] >= 0;
      const int* tb = base + (size_t)max(cur[j], 0) * S;
      word[j] = ld1<kSmem>(tb + n4 + node[j]);
      rec[j] = ld4<kSmem>(tb + 4 * node[j]);
    }
    if (!any) break;
    float vhi[W], vlo[W];
#pragma unroll
    for (int j = 0; j < W; ++j)
      query_value<XT, kStage>(p, stage, pitch, i, r, word[j] >> kDtBits,
                              vhi[j], vlo[j]);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (cur[j] >= 0) {
        const bool left = route_left(
            word[j] & ((1 << kDtBits) - 1), __int_as_float(rec[j].x),
            __int_as_float(rec[j].y), vhi[j], vlo[j], p.k_zero,
            cat_base + (long long)cur[j] * N + node[j], words_m);
        node[j] = left ? rec[j].z : rec[j].w;
        if (node[j] < 0 || ++depth[j] >= p.max_depth) {
          finish(cur[j], ~node[j]);
          cur[j] = claim();
          node[j] = 0;
          depth[j] = 0;
        }
      }
    }
  }
}

// Walk tree `tb` (a row of S words; `cat_t` its row of N pairs) from its
// root, all lanes of a warp in the same tree: near the root their
// shared-memory reads are broadcasts.  Returns the leaf reached as ~leaf
// (a walk still at a node after max_depth steps ends there, as the scan
// does).
template <typename XT, bool kSmem, bool kStage>
__device__ __forceinline__ int walk_tree(const Params& p, const int* tb,
                                         const int2* cat_t,
                                         const unsigned* words_m,
                                         const void* stage, int pitch, int i,
                                         long long r) {
  const int n4 = 4 * p.nodes;
  int node = 0;
  for (int d = 0; d < p.max_depth && node >= 0; ++d) {
    const int word = ld1<kSmem>(tb + n4 + node);
    const int4 rec = ld4<kSmem>(tb + 4 * node);
    float vhi, vlo;
    query_value<XT, kStage>(p, stage, pitch, i, r, word >> kDtBits, vhi, vlo);
    const bool left = route_left(word & ((1 << kDtBits) - 1),
                                 __int_as_float(rec.x), __int_as_float(rec.y),
                                 vhi, vlo, p.k_zero, cat_t + node, words_m);
    node = left ? rec.z : rec.w;
  }
  return node;
}

// ---- route "rows" ----------------------------------------------------------

template <typename XT, bool kLeaves, bool kSmemTrees, bool kStage>
__global__ void __launch_bounds__(kMaxThreads, 2) rows_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char rows_smem[];
  unsigned char* smem = rows_smem;
  const int rb = p.rows_per_block;
  const int C = p.chunk_trees;
  const int S = p.tree_words;
  const int N = p.nodes;
  const int T = p.trees;
  const int K = p.num_model;
  const int tid = threadIdx.x;
  const int pitch = C | 1;

  // layout: serve/packed.py::rows_smem_bytes
  size_t off = 0;
  int* ring = reinterpret_cast<int*>(smem);
  uint64_t* bars = nullptr;
  if (kSmemTrees) {
    off += 2ull * C * S * 4;
    bars = reinterpret_cast<uint64_t*>(smem + off);
    off += 16;
  }
  void* stage = smem + off;
  const int xpitch = p.nf | 1;  // staged values a row
  if (kStage) off += (size_t)xpitch * rb * (sizeof(XT) == 8 ? 8 : 4);
  int* tile = reinterpret_cast<int*>(smem + off);       // kLeaves
  float* acc_s = reinterpret_cast<float*>(smem + off);  // K > 1 scores

  // this block's rows: a run of the batch, or of one tenant's grouped rows
  int m = 0;
  long long first = (long long)blockIdx.x * rb, end = p.n_rows;
  if (p.tile_off) {
    const int b = blockIdx.x;
    if (b >= p.tile_off[p.tenants]) return;  // the grid's spare blocks
    int lo = 0, hi = p.tenants;  // the last tenant whose tiles start <= b
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (p.tile_off[mid] <= b) lo = mid; else hi = mid;
    }
    m = lo;
    first = p.row_off[m] + (long long)(b - p.tile_off[m]) * rb;
    end = p.row_off[m + 1];
  }
  const int rows_here = (int)min((long long)rb, end - first);
  auto row_of = [&](int i) -> long long {
    return p.order ? (long long)p.order[first + i] : first + i;
  };

  const long long tree0 = (long long)m * T;  // the block's tenant
  // trees past the tenant's last non-padding tree reach leaf 0 and add +0
  // (a sum from +0 is never -0): neither copied nor walked.  A fleet walked
  // without grouping walks every tree.
  const int T_live = (p.tenant && !p.tile_off) ? T : __ldg(p.live + m);
  const int nchunks = (T_live + C - 1) / C;
  auto issue = [&](int c) {
    const int nt = min(C, T_live - c * C);
    uint64_t* bar = &bars[c & 1];
    const unsigned bytes = (unsigned)nt * S * 4;
    mbar_expect_tx(bar, bytes);
    bulk_copy(ring + (size_t)(c & 1) * C * S,
              p.blob + (tree0 + (long long)c * C) * S, bytes, bar);
  };
  if (kSmemTrees && tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (nchunks > 0) issue(0);
    if (nchunks > 1) issue(1);
  }
  if (kStage) stage_rows<XT>(p, stage, xpitch, rows_here, row_of);
  __syncthreads();

  const bool valid = tid < rows_here;
  const long long r = valid ? row_of(tid) : 0;
  // a fleet walked without grouping reads each row's own tenant
  const int m_row =
      (p.tenant && !p.tile_off && valid) ? __ldg(p.tenant + r) : m;
  const unsigned* words_m = p.words + (long long)m_row * p.words_per_tenant;
  const int2* cat_m = p.cat + (long long)m_row * T * N;
  int* own = tile + tid * pitch;  // this row's leaf per tree (kLeaves)
  float acc1 = 0.0f;
  if (!kLeaves && K > 1)
    for (int k = 0; k < K; ++k) acc_s[k * rb + tid] = 0.0f;

  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * C;
    const int nt = min(C, T_live - t0);
    const int* cb;
    if constexpr (kSmemTrees) {
      mbar_wait(&bars[c & 1], (c >> 1) & 1);
      cb = ring + (size_t)(c & 1) * C * S;
    } else {
      cb = p.blob + ((long long)m_row * T + t0) * S;
    }
    if (valid) {
      // a warp's lanes walk the same tree together; a stump takes leaf 0;
      // leaves go to the lane's tile row, values are added in tree order
      for (int j = 0; j < nt; ++j) {
        const int* tb = cb + (size_t)j * S;
        const int leaf =
            ld1<kSmemTrees>(tb + 6 * N + 1)
                ? 0
                : ~walk_tree<XT, kSmemTrees, kStage>(
                      p, tb, cat_m + (long long)(t0 + j) * N, words_m, stage,
                      xpitch, tid, r);
        if constexpr (kLeaves) {
          own[j] = leaf;
        } else {
          const float v = __int_as_float(ld1<kSmemTrees>(tb + 5 * N + leaf));
          if (K == 1) {
            acc1 = __fadd_rn(acc1, v);
          } else {
            float* a = acc_s + ((t0 + j) % K) * rb + tid;
            *a = __fadd_rn(*a, v);
          }
        }
      }
    }
    if constexpr (kLeaves) {
      __syncthreads();
      for (int e = tid; e < rows_here * nt; e += blockDim.x) {
        const int i = e / nt, t = e - i * nt;
        p.leaves[row_of(i) * T + t0 + t] = tile[i * pitch + t];
      }
    }
    if (kSmemTrees || kLeaves) __syncthreads();  // ring stage / tile free
    if (kSmemTrees && tid == 0 && c + 2 < nchunks) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(c + 2);
    }
  }
  if constexpr (kLeaves) {
    const int pad = T - T_live;
    for (int e = tid; e < rows_here * pad; e += blockDim.x) {
      const int i = e / pad;
      p.leaves[row_of(i) * T + T_live + (e - i * pad)] = 0;
    }
  }
  if (!kLeaves && valid) {
    if (K == 1) {
      p.scores[r] = acc1;
    } else {
      for (int k = 0; k < K; ++k)
        p.scores[k * p.n_rows + r] = acc_s[k * rb + tid];
    }
  }
}

// ---- route "trees" ---------------------------------------------------------

template <typename XT, bool kLeaves>
__global__ void __launch_bounds__(kMaxThreads) trees_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char trees_smem[];
  unsigned char* smem = trees_smem;
  const int G = p.rows_per_block;
  const int lanes = blockDim.x / G;
  const int pass = p.chunk_trees;  // trees a pass (all of them, if they fit)
  const int T = p.trees, N = p.nodes, S = p.tree_words, K = p.num_model;
  const int tid = threadIdx.x;
  const int g = tid / lanes, lane = tid - g * lanes;

  // layout: serve/packed.py::trees_smem_bytes
  void* stage = smem;
  const int xpitch = p.nf | 1;
  float* vals = reinterpret_cast<float*>(
      smem + (size_t)G * xpitch * (sizeof(XT) == 8 ? 8 : 4));
  float* cacc = vals + G * pass;

  const long long row0 = (long long)blockIdx.x * G;
  const int rows_here = (int)min((long long)G, p.n_rows - row0);
  stage_rows<XT>(p, stage, xpitch, rows_here,
                 [&](int i) { return row0 + i; });
  if (!kLeaves)
    for (int e = tid; e < G * K; e += blockDim.x) cacc[e] = 0.0f;
  __syncthreads();

  const bool valid = g < rows_here;
  const long long r = row0 + g;
  const int m = (p.tenant && valid) ? __ldg(p.tenant + r) : 0;
  const int* blob_m = p.blob + (long long)m * T * S;
  const int2* cat_m = p.cat + (long long)m * T * N;
  const unsigned* words_m = p.words + (long long)m * p.words_per_tenant;
  float* row_vals = vals + g * pass;

  for (int p0 = 0; p0 < T; p0 += pass) {
    const int pend = min(T, p0 + pass);
    if (valid) {
      // the lane's trees of the pass, lane, lane + lanes, ..., in turn
      int next = p0 + lane;
      auto finish = [&](int t, int leaf) {
        if constexpr (kLeaves) {
          p.leaves[r * T + t] = leaf;
        } else {
          row_vals[t - p0] =
              __int_as_float(__ldg(blob_m + (size_t)t * S + 5 * N + leaf));
        }
      };
      auto claim = [&]() -> int {
        while (next < pend && __ldg(blob_m + (size_t)next * S + 6 * N + 1)) {
          finish(next, 0);
          next += lanes;
        }
        if (next >= pend) return -1;
        const int t = next;
        next += lanes;
        return t;
      };
      walk_claimed<kTreeWalks, XT, false, true>(p, blob_m, cat_m, words_m,
                                                stage, xpitch, g, r, claim,
                                                finish);
    }
    if constexpr (!kLeaves) {
      __syncthreads();
      if (valid) {
        // class k's trees of this pass, t = k (mod K), in tree order
        for (int k = lane; k < K; k += lanes) {
          float a = cacc[g * K + k];
          for (int i = ((k - p0) % K + K) % K; i < pend - p0; i += K)
            a = __fadd_rn(a, row_vals[i]);
          cacc[g * K + k] = a;
        }
      }
      __syncthreads();
    }
  }
  if (!kLeaves && valid)
    for (int k = lane; k < K; k += lanes)
      p.scores[k * p.n_rows + r] = cacc[g * K + k];
}

// ---- the tenant grouping (counting sort of row indices) --------------------

// counts[b * M + m] = rows of tenant m in block b's row range
__global__ void tenant_count_kernel(const int* __restrict__ tenant,
                                    long long n, int tenants,
                                    long long rows_per_block,
                                    int* __restrict__ counts) {
  extern __shared__ int cnt[];  // [tenants]
  for (int m = threadIdx.x; m < tenants; m += blockDim.x) cnt[m] = 0;
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x)
    atomicAdd(&cnt[tenant[r]], 1);
  __syncthreads();
  for (int m = threadIdx.x; m < tenants; m += blockDim.x)
    counts[(long long)blockIdx.x * tenants + m] = cnt[m];
}

// One block: row_off[m] / tile_off[m] = first grouped row / first block of
// tenant m (tiles of rows_per_block rows), and counts rewritten in place
// to the first grouped index of block b's rows of tenant m.
__global__ void tenant_offsets_kernel(int* __restrict__ counts,
                                      int* __restrict__ row_off,
                                      int* __restrict__ tile_off, int blocks,
                                      int tenants, int rows_per_block) {
  extern __shared__ int total[];  // [tenants]
  for (int m = threadIdx.x; m < tenants; m += blockDim.x) {
    int s = 0;
    for (int b = 0; b < blocks; ++b) s += counts[(long long)b * tenants + m];
    total[m] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int rows = 0, tiles = 0;
    for (int m = 0; m < tenants; ++m) {
      row_off[m] = rows;
      tile_off[m] = tiles;
      rows += total[m];
      tiles += (total[m] + rows_per_block - 1) / rows_per_block;
      total[m] = row_off[m];
    }
    row_off[tenants] = rows;
    tile_off[tenants] = tiles;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < tenants; m += blockDim.x) {
    int s = total[m];
    for (int b = 0; b < blocks; ++b) {
      int* c = counts + (long long)b * tenants + m;
      const int here = *c;
      *c = s;
      s += here;
    }
  }
}

// the scatter: each row's index into its tenant's run (any order within a
// block's share)
__global__ void tenant_scatter_kernel(const int* __restrict__ tenant,
                                      long long n, int tenants,
                                      long long rows_per_block,
                                      const int* __restrict__ offsets,
                                      int* __restrict__ order) {
  extern __shared__ int cursor[];  // [tenants]
  for (int m = threadIdx.x; m < tenants; m += blockDim.x)
    cursor[m] = offsets[(long long)blockIdx.x * tenants + m];
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x)
    order[atomicAdd(&cursor[tenant[r]], 1)] = (int)r;
}

// ---- launch ------------------------------------------------------------------

// Opt a kernel into `smem` bytes of dynamic shared memory (on the current
// device: the attribute is per device, so it is set at every launch that
// needs more than the default 48 KB) and launch it.
template <typename Kernel>
int launch(Kernel kernel, unsigned grid, int threads, int smem,
           cudaStream_t stream, const Params& p) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename XT, bool kLeaves>
int launch_route(bool trees, bool smem_trees, bool stage, unsigned grid,
                 int threads, int smem, cudaStream_t s, const Params& p) {
  // tree chunks in shared memory come with the rows staged beside them
  // (forest_geometry never asks for the one without the other)
  if (trees)
    return launch(trees_kernel<XT, kLeaves>, grid, threads, smem, s, p);
  if (smem_trees)
    return launch(rows_kernel<XT, kLeaves, true, true>, grid, threads, smem,
                  s, p);
  return stage ? launch(rows_kernel<XT, kLeaves, false, true>, grid, threads,
                        smem, s, p)
               : launch(rows_kernel<XT, kLeaves, false, false>, grid,
                        threads, smem, s, p);
}

}  // namespace

// Launch on `stream`.  x: (n_rows, >= nf) f64 (x_f64 = 1) or f32 rows with
// `row_stride` elements between rows; tenant: (n_rows,) int32 tenant ids in
// [0, tenants) or null (tenant 0); blob: (tenants, trees, tree_words) node
// records, cat: (tenants, trees, nodes, 2), words: (tenants,
// words_per_tenant), live: (tenants,) (serve/packed.py::ForestRecords).  The geometry
// (route_trees, threads, rows_per_block, chunk_trees, smem_trees,
// stage_rows, group_blocks, smem_bytes, grid) is
// serve/packed.py::forest_geometry's; the shared-memory layout is
// recomputed here and a mismatch refused (cudaErrorInvalidValue).  With
// group_blocks > 0, scratch holds n_rows + 2 (tenants + 1) + group_blocks *
// tenants ints.  Writes scores (K, n_rows) f32 when `scores` is not null,
// else leaves (n_rows, trees) int32.  Returns the first CUDA error.
extern "C" int forest_predict_launch(
    const void* x, int x_f64, long long n_rows, long long row_stride, int nf,
    const int* tenant, int tenants, const int* blob, const int* cat,
    const unsigned* words, const int* live, int trees, int nodes,
    int tree_words,
    int words_per_tenant, int num_model, int max_depth, float k_zero,
    int route_trees, int threads, int rows_per_block, int chunk_trees,
    int smem_trees, int stage_rows, int group_blocks, int smem_bytes,
    int grid, int* scratch, float* scores, int* leaves, void* stream) {
  if (n_rows <= 0) return 0;
  const bool want_leaves = scores == nullptr;
  const long long xb = x_f64 ? 8 : 4;
  long long smem;
  const long long xpitch = nf | 1;
  if (route_trees) {
    smem = rows_per_block * xpitch * xb;
    if (!want_leaves)
      smem += (long long)rows_per_block * (chunk_trees + num_model) * 4;
  } else {
    smem = smem_trees ? 2LL * chunk_trees * tree_words * 4 + 16 : 0;
    if (stage_rows) smem += xpitch * rows_per_block * xb;
    if (want_leaves) {
      smem += (long long)rows_per_block * (chunk_trees | 1) * 4;
    } else if (num_model > 1) {
      smem += (long long)num_model * rows_per_block * 4;
    }
  }
  const bool group = group_blocks > 0;
  if (smem != smem_bytes || threads <= 0 || threads > kMaxThreads ||
      rows_per_block <= 0 || chunk_trees <= 0 ||
      (!route_trees && threads != rows_per_block) ||
      (route_trees && threads % rows_per_block) ||
      (smem_trees && !stage_rows) ||
      (group && (!smem_trees || route_trees || !tenant || !scratch)) ||
      tree_words % 4)
    return (int)cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{x,        n_rows,     row_stride,      nf,
           tenant,   tenants,    blob,            reinterpret_cast<const int2*>(cat),
           words,    live,       trees,           nodes,           tree_words,
           words_per_tenant,     num_model,       max_depth,
           k_zero,   rows_per_block,              chunk_trees,
           nullptr,  nullptr,    nullptr,         scores,
           leaves};
  if (group) {
    int* order = scratch;
    int* row_off = order + n_rows;
    int* tile_off = row_off + tenants + 1;
    int* counts = tile_off + tenants + 1;
    const long long per = (n_rows + group_blocks - 1) / group_blocks;
    const size_t cnt_smem = (size_t)tenants * sizeof(int);
    tenant_count_kernel<<<group_blocks, kMaxThreads, cnt_smem, s>>>(
        tenant, n_rows, tenants, per, counts);
    tenant_offsets_kernel<<<1, kMaxThreads, cnt_smem, s>>>(
        counts, row_off, tile_off, group_blocks, tenants, rows_per_block);
    tenant_scatter_kernel<<<group_blocks, kMaxThreads, cnt_smem, s>>>(
        tenant, n_rows, tenants, per, counts, order);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    p.order = order;
    p.row_off = row_off;
    p.tile_off = tile_off;
  }
  const int sm = (int)smem;
  const unsigned g = (unsigned)grid;
  if (x_f64) {
    return want_leaves
               ? launch_route<double, true>(route_trees, smem_trees,
                                            stage_rows, g, threads, sm, s, p)
               : launch_route<double, false>(route_trees, smem_trees,
                                             stage_rows, g, threads, sm, s,
                                             p);
  }
  return want_leaves
             ? launch_route<float, true>(route_trees, smem_trees, stage_rows,
                                         g, threads, sm, s, p)
             : launch_route<float, false>(route_trees, smem_trees, stage_rows,
                                          g, threads, sm, s, p);
}
