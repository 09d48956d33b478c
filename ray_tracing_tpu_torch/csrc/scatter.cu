// K2: the masked scatter-add of per-row texel-gradient contributions into
// the atlas-gradient table, g[texel[r], c] += contrib[r, c] for every row r
// whose mask is set and whose texel lies in [0, P), over up to
// kMaxSegments row segments in one call.  Each texel's rows are added to
// its old value one at a time in row order (segment order, then the order
// inside each segment): the TPU kernel's serial order and the CPU
// index_add_'s, so the result is the same bits on every run and equals the
// plain version run on the CPU.
//
// Replaces ray_tracing_tpu/ops/pallas_scatter.py:_kernel.  The plain
// PyTorch version of the same function is scatter_add_plain in
// ray_tracing_tpu_torch/ops/cuda_scatter.py.
//
// What bounds it on an H100: reading every row's mask byte, the texel of
// each masked row, the contribution of each live row and each touched
// texel's three sums (read and written).  In a zy tile's tape sweep few
// rows are live (about 1,300 of 288,000) and few texels repeat (10), so
// the work is a few hundred KB and the time is one sweep of the rows, a
// few dependent trips to memory and a second, small launch (PERF.md,
// section 6).
//
// Design, two launches and no float atomics.  The rows of the segments
// are numbered by one call-wide position, and every call has its own
// generation ``gen``: a list entry tagged with another generation is
// empty, so nothing is cleared between calls.
//  1. scatter_add_push_kernel sweeps the rows.  Every live row swaps its
//     tagged position into head[texel] (a 64-bit integer atomicExch).  The
//     row that finds the head empty is its texel's first row in this call:
//     it writes g = old + contrib at once and keeps old in old[texel].  A
//     later row links the old head in next[position] and records itself as
//     a repeat (texel, position, previous position, gen).
//  2. scatter_add_repeat_kernel walks the repeats only.  The repeat that is
//     its texel's final head owns the texel and writes g = old plus all
//     the texel's rows, added in position order: two rows at once, more by
//     add_in_order.
// The live count never leaves the device.  The wrapper keeps the scratch
// per device and stream.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 2;
constexpr int kBlockRows = kThreads * kRowsPerThread;
constexpr int kMaxSegments = 8;
constexpr int kRepeatBlocks = 32;
constexpr int kBatch = 16;  // rows an owner of repeated rows sorts in registers
constexpr int kWalk = 256;  // list steps an owner takes before it reads every row

typedef unsigned long long u64;

struct Segment {
  const int* texel;
  const float* contrib;
  const bool* mask;
  int rows;
  int first_block;
  int first_pos;  // the call-wide position of the segment's row 0
};

struct Segments {
  Segment s[kMaxSegments];
  int count;
};

// The kernels' scratch, kept by the wrapper: head (P, tagged positions,
// zero at first), old (P x 3 floats), count (2 ints, zero at first), next
// (a tagged position per row, zero at first) and repeats (one int4 per row
// and kRepeatBlocks * kThreads more).
struct Scratch {
  u64* head;
  float* old;
  int* count;
  u64* next;
  int4* repeats;
};

__device__ __forceinline__ u64 tagged(unsigned gen, int pos) {
  return (static_cast<u64>(gen) << 32) | static_cast<unsigned>(pos);
}

__device__ __forceinline__ bool current(u64 v, unsigned gen) {
  return static_cast<unsigned>(v >> 32) == gen;
}

// The segment holding block ``b`` (by_block) or call-wide position ``b``;
// selected with constant indices, so the kernel parameters stay in the
// constant bank.
template <bool kByBlock>
__device__ __forceinline__ Segment segment_of(const Segments& sg, int b) {
  Segment seg = sg.s[0];
#pragma unroll
  for (int i = 1; i < kMaxSegments; ++i) {
    if (i < sg.count && b >= (kByBlock ? sg.s[i].first_block : sg.s[i].first_pos)) seg = sg.s[i];
  }
  return seg;
}

__device__ __forceinline__ const float* contrib_at(const Segments& sg, int pos) {
  const Segment seg = segment_of<false>(sg, pos);
  return seg.contrib + 3 * static_cast<size_t>(pos - seg.first_pos);
}

// This thread's rows of its block's segment: their row numbers and the
// texel of each live row (-1 for the others).  Rows lie kThreads apart, so
// a warp's loads are contiguous.
__device__ __forceinline__ void live_rows(const Segment& seg, int p, int row[kRowsPerThread],
                                          int tex[kRowsPerThread]) {
  const int row0 = (blockIdx.x - seg.first_block) * kBlockRows + threadIdx.x;
  bool m[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    row[k] = row0 + k * kThreads;
    const bool in = row[k] < seg.rows;
    m[k] = in && seg.mask[row[k]];
    tex[k] = in ? seg.texel[row[k]] : -1;  // loaded beside the mask, not after it
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (!m[k] || tex[k] < 0 || tex[k] >= p) tex[k] = -1;
  }
}

__global__ void __launch_bounds__(kThreads)
    scatter_add_push_kernel(float* __restrict__ g, int p, const Segments sg, Scratch S,
                            unsigned gen) {
  const Segment seg = segment_of<true>(sg, blockIdx.x);
  int row[kRowsPerThread], tex[kRowsPerThread];
  live_rows(seg, p, row, tex);
  // the swap and, beside it, the loads a first row needs
  u64 prev[kRowsPerThread];
  float c[kRowsPerThread][3], o[kRowsPerThread][3];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    prev[k] = 0;
    if (tex[k] >= 0) {
      prev[k] = atomicExch(S.head + tex[k], tagged(gen, seg.first_pos + row[k]));
      const float* src = seg.contrib + 3 * static_cast<size_t>(row[k]);
      const float* dst = g + 3 * static_cast<size_t>(tex[k]);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        c[k][ch] = __ldg(src + ch);
        o[k][ch] = dst[ch];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (tex[k] < 0) continue;
    const int t = tex[k], pos = seg.first_pos + row[k];
    if (!current(prev[k], gen)) {  // the first row of t: no other row writes g[t] here
      float* dst = g + 3 * static_cast<size_t>(t);
      float* old = S.old + 3 * static_cast<size_t>(t);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        dst[ch] = o[k][ch] + c[k][ch];
        old[ch] = o[k][ch];
      }
    } else {
      S.next[pos] = prev[k];
      S.repeats[atomicAdd(S.count + (gen & 1), 1)] =
          make_int4(t, pos, static_cast<int>(prev[k] & 0xffffffffu), static_cast<int>(gen));
    }
  }
}

// The rows of texel ``t`` added onto old[t] in position order into g[t],
// its list starting at ``first``.  A walk of the list sorts the first
// kBatch rows it meets; if that was all of them they are added in that
// order.  Else the rows between the least and the greatest position seen
// are read in order and those of texel t added, all rows of the call when
// the list is longer than kWalk (each step of a walk waits for the last;
// reading rows in order does not).
__device__ __forceinline__ void add_in_order(float* g, int t, int first, const Scratch& S,
                                             unsigned gen, const Segments& sg) {
  int pos[kBatch];
  int m = 0, lo = first, hi = first, q = first;
  bool end = false;
  for (int steps = 0; steps < kWalk && !end; ++steps) {
    lo = min(lo, q);
    hi = max(hi, q);
    if (m == kBatch) {
      ++m;  // more than kBatch rows
    } else if (m < kBatch) {
      int i = m++;
      for (; i > 0 && pos[i - 1] > q; --i) pos[i] = pos[i - 1];
      pos[i] = q;
    }
    const u64 nx = S.next[q];
    end = !current(nx, gen);
    q = static_cast<int>(nx & 0xffffffffu);
  }
  if (!end) {
    lo = 0;
    hi = INT_MAX - 1;
  }
  const float* old = S.old + 3 * static_cast<size_t>(t);
  float v0 = old[0], v1 = old[1], v2 = old[2];
  if (end && m <= kBatch) {
    for (int i = 0; i < m; ++i) {
      const float* c = contrib_at(sg, pos[i]);
      v0 = v0 + c[0];
      v1 = v1 + c[1];
      v2 = v2 + c[2];
    }
  } else {
#pragma unroll
    for (int s = 0; s < kMaxSegments; ++s) {
      if (s >= sg.count) break;
      const Segment& seg = sg.s[s];
      const int a = max(lo, seg.first_pos) - seg.first_pos;
      const int b = min(hi + 1, seg.first_pos + seg.rows) - seg.first_pos;
#pragma unroll 4
      for (int r = a; r < b; ++r) {
        if (seg.texel[r] == t && seg.mask[r]) {  // t is in [0, p): the row is live
          const float* c = seg.contrib + 3 * static_cast<size_t>(r);
          v0 = v0 + c[0];
          v1 = v1 + c[1];
          v2 = v2 + c[2];
        }
      }
    }
  }
  float* dst = g + 3 * static_cast<size_t>(t);
  dst[0] = v0;
  dst[1] = v1;
  dst[2] = v2;
}

__global__ void __launch_bounds__(kThreads)
    scatter_add_repeat_kernel(float* __restrict__ g, const Segments sg, Scratch S,
                              unsigned gen) {
  if (blockIdx.x == 0 && threadIdx.x == 0) S.count[(gen + 1) & 1] = 0;  // the next call's
  const int n = S.count[gen & 1];
  for (int i = blockIdx.x * kThreads + threadIdx.x;; i += kRepeatBlocks * kThreads) {
    const int4 e = S.repeats[i];  // loaded beside n, used only below it
    if (i >= n) break;
    const int t = e.x, r = e.y, pv = e.z;
    // every load of a two-row texel at once
    const u64 h = S.head[t];
    const u64 nxp = S.next[pv];
    const float* cr = contrib_at(sg, r);
    const float* cp = contrib_at(sg, pv);
    const float* old = S.old + 3 * static_cast<size_t>(t);
    const float a0 = cr[0], a1 = cr[1], a2 = cr[2];
    const float b0 = cp[0], b1 = cp[1], b2 = cp[2];
    const float o0 = old[0], o1 = old[1], o2 = old[2];
    // not this call's (a call whose repeat launch never ran), or not t's
    // final head
    if (static_cast<unsigned>(e.w) != gen || static_cast<int>(h & 0xffffffffu) != r) continue;
    if (current(nxp, gen)) {  // more than two rows
      add_in_order(g, t, r, S, gen, sg);
      continue;
    }
    float* dst = g + 3 * static_cast<size_t>(t);  // two rows: pv, the first, and r
    if (pv < r) {
      dst[0] = (o0 + b0) + a0;
      dst[1] = (o1 + b1) + a1;
      dst[2] = (o2 + b2) + a2;
    } else {
      dst[0] = (o0 + a0) + b0;
      dst[1] = (o1 + a1) + b1;
      dst[2] = (o2 + a2) + b2;
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

// The most segments one call takes, and the repeat entries a call needs
// beyond one per row.
extern "C" int scatter_add_max_segments() { return kMaxSegments; }
extern "C" int scatter_add_repeat_slack() { return kRepeatBlocks * kThreads; }

// Launches K2 over ``n_seg`` segments (host arrays of their texel,
// contribution and mask pointers and row counts, fewer than 2**31 rows in
// all) into the (p, 3) table ``g`` on ``stream`` as generation ``gen``
// (> 0, a new one every call with the same scratch), with the scratch of
// struct Scratch, and returns the CUDA error (0 = launched).
extern "C" int scatter_add_launch(float* g, int p, const int* const* texel,
                                  const float* const* contrib, const bool* const* mask,
                                  const int* rows, int n_seg, u64* head, float* old, int* count,
                                  u64* next, int* repeats, unsigned gen, cudaStream_t stream) {
  if (n_seg < 1 || n_seg > kMaxSegments || gen == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Segments sg = {};
  sg.count = n_seg;
  long long blocks = 0, pos = 0;
  for (int s = 0; s < n_seg; ++s) {
    if (rows[s] < 1 || pos + rows[s] >= (1LL << 31) - 1)
      return static_cast<int>(cudaErrorInvalidValue);
    sg.s[s] = {texel[s], contrib[s], mask[s], rows[s], static_cast<int>(blocks),
               static_cast<int>(pos)};
    blocks += (rows[s] + kBlockRows - 1) / kBlockRows;
    pos += rows[s];
  }
  const Scratch S = {head, old, count, next, reinterpret_cast<int4*>(repeats)};
  const unsigned grid = static_cast<unsigned>(blocks);
  scatter_add_push_kernel<<<grid, kThreads, 0, stream>>>(g, p, sg, S, gen);
  scatter_add_repeat_kernel<<<kRepeatBlocks, kThreads, 0, stream>>>(g, sg, S, gen);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel through the same route: the floor of a launch, for
// measurements.
extern "C" int empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
