// The device clock of the grower's trees (ops/clock.py stamps it,
// ops/grow.py places the stamps in a tree's pieces).
//
// Not a kernel port: the TPU kernels have no counterpart.  It was added
// because the profiler's device trace of a composed tree graph loses the
// launches inside its WHILE nodes (ops/graphs.py), so the trace cannot
// say how long a tree, or kernel 1 within it, ran on the card.  This
// kernel reads the card's nanosecond clock (%globaltimer) and writes it,
// or adds it, into the row of tree slot `ctl[3]` of a (capacity, 6)
// int64 table: start, waves_start, waves_end, end, and the sums hist_ns
// and grad_ns (each interval opened by one stamp with -now and closed by
// the next with +now).  It is launched on the current stream like any
// other launch, so it is captured into the pieces and runs inside the
// WHILE nodes too.  Each launch also adds one to a device counter
// (`count`), so a replayed graph's stamps are counted as they run.
//
// What bounds it: one launch of one thread, a read of a control word, a
// store of 8 bytes and an add to the counter, about a microsecond a
// stamp.  A tree takes 4 stamps, a fused tree's gradient 2 and a wave 2.

#include <cuda_runtime.h>

// the table's fields a row (ops/clock.py FIELDS), and the sums a tree's
// first stamp zeroes
constexpr int kFields = 6;
constexpr int kHist = 4;
constexpr int kGrad = 5;

extern "C" __global__ void obs_clock_stamp(long long* clock, const int* ctl,
                                           int capacity, int field,
                                           int mode,
                                           unsigned long long* count) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  atomicAdd(count, 1ULL);
  const int t = ctl[3];
  if (t < 0 || t >= capacity) return;
  long long* row = clock + static_cast<long long>(t) * kFields;
  const long long v = static_cast<long long>(now);
  switch (mode) {
    case 0:  // set the field
      row[field] = v;
      break;
    case 1:  // open a tree: set the field, zero the sums
      row[field] = v;
      row[kHist] = 0;
      row[kGrad] = 0;
      break;
    case 2:  // open an interval of a sum
      row[field] -= v;
      break;
    default:  // close it
      row[field] += v;
      break;
  }
}

// Launches one stamp on `stream`; returns the launch's CUDA error (0 when
// it was queued).
extern "C" int obs_clock_stamp_launch(void* clock, const void* ctl,
                                      int capacity, int field, int mode,
                                      void* count, void* stream) {
  obs_clock_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(clock), static_cast<const int*>(ctl),
      capacity, field, mode, static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}
