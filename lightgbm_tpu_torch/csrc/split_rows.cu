// A wave's row routing for the leaf-wise tree grower, hand-written for
// Hopper (sm_90a): the grower's step 5 (ops/grow.py, _piece_wave).
//
// Not a Pallas kernel's port: the TPU package leaves this step to XLA, as
// the leaf-id update of its wave (lightgbm_tpu/ops/grow.py:869-916: one
// fused elementwise pass over the (W, N) codes of the selected features).
// The port first wrote it as ~45 row-sized PyTorch launches a wave, most
// of them int64 gathers, compares, adds and wheres over every padded row
// (~560 bytes a row a wave; ops/routing.py keeps that code as the plain
// version).  This kernel computes the same function in one pass:
//
//   for each row r whose leaf leaf_id[r] is split by selected lane w:
//     code = codes[group of w's feature, r]
//     if code does not go left under w's split: leaf_id[r] = right[w]
//
// with DenseBin::Split's rules (ops/partition.py's docstring): a code
// outside the feature's slot range, or at its default bin, takes the
// default side; the NaN bin follows default_left; a categorical split
// sends a row left iff its bin's bit is set in the lane's 256-bin set.
//
// What bounds it on this card: bytes.  Each row's leaf id is read (4
// bytes), a row in a split leaf reads one code byte, and a row that moves
// writes its new id (4 bytes): at higgs's shape (2^24 padded rows) 70-100
// MB a wave, 21-30 us at 3.35 TB/s.  The code bytes of neighbouring rows
// lie in different groups when their leaves split on different features,
// so a 32-byte sector is fetched for one byte: in a wide wave that read,
// not the arithmetic, keeps the kernel at 2-4x its bound (PERF.md).
//
// The design:
//   * the left/right decision of a lane depends on nothing but the code
//     byte, so every block first turns each selected lane into a 256-bit
//     table (bit c: code c goes left), each warp a 32-code word of it by
//     one ballot; with the lanes' groups and right children and a
//     leaf -> lane map of the L leaves it stays in shared memory
//     (MAX_LEAVES bytes at most);
//   * two blocks of 1024 threads an SM walk the rows (a grid-stride loop,
//     so the tables are built twice an SM), four rows a thread from one
//     16-byte load of leaf ids, their four code reads issued together
//     (one block an SM ran 7-11% slower; each row's code read and
//     decision in turn 5-12% slower again);
//   * a row whose leaf id is negative or names no selected lane reads no
//     code; a vector of four ids is written back only if one of its rows
//     moved.  No intermediate leaves the block.
// Each launch adds one to a device counter (`count`), so a replayed graph's
// launches are counted as they run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;     // ops/routing.py THREADS
constexpr int kBlocksPerSM = 2;    // ops/routing.py BLOCKS_PER_SM
constexpr int kMaxLanes = 128;     // ops/routing.py MAX_LANES
constexpr int kCatWords = 8;       // a categorical split's 256-bin set
// the fields of a feature's row in ops/routing.py::feature_table
constexpr int kFeatFields = 6;
enum { kGroup, kOffset, kWidth, kDefault, kNumBin, kMissing };

struct Lane {
  long long thr;
  int off, wid, db, nbin, miss;
  int on, dl, cat;
  unsigned words[kCatWords];
};

struct Args {
  int* leaf_id;
  const uint8_t* codes;
  long long n;
  const int* feat;
  int num_feat;
  const bool* sel;
  const long long* lsel;
  const long long* right;
  const long long* fidx;
  const long long* thr;
  const bool* dl;
  const int* words;    // (ws, 8), or null without a categorical feature
  const bool* is_cat;  // (ws,), or null likewise
  int ws;
  int num_leaves;
  unsigned long long* count;
};

// Whether code `c` of the lane's group goes left (ops/routing.py
// split_rows_reference, row by row).
__device__ __forceinline__ bool goes_left(const Lane& s, int c) {
  const int shift = s.db == 0 ? 1 : 0;
  const bool in_range = c >= s.off && c < s.off + s.wid;
  const int bin = in_range ? c - s.off + shift : s.db;
  if (s.cat) return (s.words[(bin >> 5) & (kCatWords - 1)] >> (bin & 31)) & 1u;
  if (bin == s.db) return s.miss == 1 ? s.dl != 0 : s.db <= s.thr;
  if (s.miss == 2 && bin == s.nbin - 1) return s.dl != 0;
  return bin <= s.thr;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    split_rows_kernel(Args a) {
  __shared__ Lane lane[kMaxLanes];
  __shared__ unsigned table[kMaxLanes * kCatWords];
  __shared__ int group[kMaxLanes];
  __shared__ int right[kMaxLanes];
  extern __shared__ signed char lane_of[];  // num_leaves entries

  const int t = threadIdx.x;
  if (blockIdx.x == 0 && t == 0) atomicAdd(a.count, 1ULL);
  for (int i = t; i < a.num_leaves; i += kThreads) lane_of[i] = -1;
  __syncthreads();
  // each selected lane's split, from its feature's row; a lane whose leaf
  // or feature lies outside the tables is left off (the grower's never do)
  if (t < a.ws) {
    Lane& s = lane[t];
    const long long leaf = a.lsel[t];
    const long long f = a.fidx[t];
    s.on = a.sel[t] && leaf >= 0 && leaf < a.num_leaves && f >= 0 &&
           f < a.num_feat;
    if (s.on) {
      const int* row = a.feat + f * kFeatFields;
      s.off = row[kOffset];
      s.wid = row[kWidth];
      s.db = row[kDefault];
      s.nbin = row[kNumBin];
      s.miss = row[kMissing];
      s.thr = a.thr[t];
      s.dl = a.dl[t];
      s.cat = a.is_cat != nullptr && a.is_cat[t];
      if (s.cat)
        for (int j = 0; j < kCatWords; ++j)
          s.words[j] = (unsigned)a.words[t * kCatWords + j];
      group[t] = row[kGroup];
      right[t] = (int)a.right[t];
      lane_of[leaf] = (signed char)t;
    }
  }
  __syncthreads();
  // the lanes' 256-bit tables: warp w builds word (w % 8) of the lanes
  // congruent to w / 8 modulo kThreads / 256
  {
    const int warp = t >> 5;
    const int word = warp & (kCatWords - 1);
    const int code = word * 32 + (t & 31);
    for (int w = warp >> 3; w < a.ws; w += kThreads / 256) {
      if (!lane[w].on) continue;
      const unsigned bits = __ballot_sync(0xffffffffu, goes_left(lane[w], code));
      if ((t & 31) == 0) table[w * kCatWords + word] = bits;
    }
  }
  __syncthreads();

  const long long n = a.n;
  const int L = a.num_leaves;
  // one vector of four rows from row r: each row's lane, then all their
  // code reads in flight together, then the decisions; whether a row moved
  auto route4 = [&](int (&id)[4], long long r) -> bool {
    int w[4];
    unsigned c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (unsigned)id[j] < (unsigned)L ? lane_of[id[j]] : -1;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = w[j] >= 0 ? __ldg(a.codes + (long long)group[w[j]] * n + r + j)
                       : 0u;
    bool moved = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (w[j] < 0) continue;
      if ((table[w[j] * kCatWords + (c[j] >> 5)] >> (c[j] & 31)) & 1u)
        continue;
      id[j] = right[w[j]];
      moved = true;
    }
    return moved;
  };
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + t;
  const bool aligned = (reinterpret_cast<uintptr_t>(a.leaf_id) & 15) == 0;
  const long long nvec = aligned ? n >> 2 : 0;
  int4* vec = reinterpret_cast<int4*>(a.leaf_id);
  for (long long v = first; v < nvec; v += stride) {
    const int4 x = vec[v];
    int id[4] = {x.x, x.y, x.z, x.w};
    if (route4(id, v << 2)) vec[v] = make_int4(id[0], id[1], id[2], id[3]);
  }
  // rows past the last whole vector (all of them if the ids are not
  // 16-byte aligned), one a thread
  for (long long r = (nvec << 2) + first; r < n; r += stride) {
    int id[4] = {a.leaf_id[r], -1, -1, -1};
    if (route4(id, r)) a.leaf_id[r] = id[0];
  }
}

}  // namespace

// Launches the routing of one wave on `stream` over `blocks` blocks of
// kThreads; returns the launch's CUDA error (0 when it was queued).
extern "C" int split_rows_launch(void* leaf_id, const void* codes,
                                 long long n, const void* feat, int num_feat,
                                 const void* sel, const void* lsel,
                                 const void* right, const void* fidx,
                                 const void* thr, const void* dl,
                                 const void* words, const void* is_cat,
                                 int ws, int num_leaves, int blocks,
                                 void* count, void* stream) {
  if (ws < 1 || ws > kMaxLanes || num_leaves < 1 || blocks < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<int*>(leaf_id),
               static_cast<const uint8_t*>(codes),
               n,
               static_cast<const int*>(feat),
               num_feat,
               static_cast<const bool*>(sel),
               static_cast<const long long*>(lsel),
               static_cast<const long long*>(right),
               static_cast<const long long*>(fidx),
               static_cast<const long long*>(thr),
               static_cast<const bool*>(dl),
               static_cast<const int*>(words),
               static_cast<const bool*>(is_cat),
               ws,
               num_leaves,
               static_cast<unsigned long long*>(count)};
  split_rows_kernel<<<blocks, kThreads, (size_t)num_leaves,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
