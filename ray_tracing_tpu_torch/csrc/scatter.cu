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
// The table is the tape sweep's [atlas | colors | metal albedo]
// (render/prb.py), so a "texel" here is any row of it.  What bounds it on
// an H100: reading every row's mask byte, the texel of each masked row,
// the contribution of each live row and each touched texel's three sums
// (read and written).  A tile's tape sweep has about 300,000 rows, a
// quarter of them live, and most live rows fall on the few color rows: a
// color row can take 60,000 rows of one call, which must be added one
// after another in row order (PERF.md, section 6).
//
// Design: a stable partition of the live rows by texel, then one ordered
// sum per texel; two launches, no float atomics.  The rows of the segments
// are cut into blocks of kBlockRows, numbered in row order, and every call
// has its own generation ``gen``: a list entry tagged with another
// generation is empty, so nothing is cleared between calls.
//  1. scatter_add_place_kernel, one CUDA block per block of rows, counts
//     its live rows per texel (a hash table in shared memory), lays the
//     texels' runs out one after another in the block's region of
//     ``placed`` and writes each live row's contribution there at its rank
//     among the block's rows of its texel (one warp ranks the rows in row
//     order).  Each run (start, length) is pushed onto its texel's list
//     (an integer atomicExch on head[texel]); the first push of a texel in
//     the call adds the texel to the touched list.
//  2. scatter_add_sum_kernel, one warp per touched texel, collects the
//     texel's runs (at most one per block), orders them by start, which is
//     block order, and adds every row of them onto g[texel] in that order:
//     the warp stages kDepth * 32 rows at a time in shared memory, the next
//     ones' loads in flight, and one lane adds them.
// Every live row is read once by each launch.  The live count never leaves
// the device.  The wrapper keeps the scratch per device and stream and
// cuts a call at kMaxRuns blocks.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;  // place kernel
constexpr int kRowsPerThread = 4;
constexpr int kBlockRows = kThreads * kRowsPerThread;
constexpr int kSlotBits = 12;
constexpr int kSlots = 1 << kSlotBits;  // twice the rows of a block
constexpr int kSlotsPerThread = kSlots / kThreads;
constexpr int kMaxSegments = 8;
constexpr int kMaxRuns = 1024;  // blocks a call may have: the runs one texel can have
constexpr int kSumWarps = 2;    // sum kernel
constexpr int kSumBlocks = 1024;
constexpr int kDepth = 8;  // rows a lane loads per step of a sum

typedef unsigned long long u64;

struct Segment {
  const int* texel;
  const float* contrib;
  const bool* mask;
  int rows;
  int first_block;
};

struct Segments {
  Segment s[kMaxSegments];
  int count;
};

// The kernels' scratch, kept by the wrapper: head (P tagged run starts,
// zero at first), count (2 ints, zero at first), and per block row of the
// call the next run of a run's texel (tagged), a run's length, a placed
// contribution (3 floats) and a touched texel.
struct Scratch {
  u64* head;
  int* count;
  u64* next;
  int* len;
  float* placed;
  int* touched;
};

__device__ __forceinline__ u64 tagged(unsigned gen, int pos) {
  return (static_cast<u64>(gen) << 32) | static_cast<unsigned>(pos);
}

__device__ __forceinline__ bool current(u64 v, unsigned gen) {
  return static_cast<unsigned>(v >> 32) == gen;
}

// The segment holding block ``b``; selected with constant indices, so the
// kernel parameters stay in the constant bank.
__device__ __forceinline__ Segment segment_of(const Segments& sg, int b) {
  Segment seg = sg.s[0];
#pragma unroll
  for (int i = 1; i < kMaxSegments; ++i) {
    if (i < sg.count && b >= sg.s[i].first_block) seg = sg.s[i];
  }
  return seg;
}

// The slot of texel ``t`` in the block's hash table, inserted if new (at
// most kBlockRows texels in kSlots slots, so a free slot is always found).
__device__ __forceinline__ int slot_of(int* key, int t) {
  unsigned h = (static_cast<unsigned>(t) * 2654435761u) >> (32 - kSlotBits);
  for (;;) {
    const int was = atomicCAS(key + h, -1, t);
    if (was == -1 || was == t) return static_cast<int>(h);
    h = (h + 1) & (kSlots - 1);
  }
}

__global__ void __launch_bounds__(kThreads)
    scatter_add_place_kernel(int p, const Segments sg, Scratch S, unsigned gen) {
  __shared__ int key[kSlots];   // texel of each slot, -1 when free
  __shared__ int fill[kSlots];  // rows per slot, then the next free place of its run
  __shared__ short at[kBlockRows];  // slot of each row (-1 dead), then its place
  __shared__ int warp_total[kThreads / 32];
  const Segment seg = segment_of(sg, blockIdx.x);
  const int row0 = (blockIdx.x - seg.first_block) * kBlockRows;
  const int region = blockIdx.x * kBlockRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kSlots; i += kThreads) {
    key[i] = -1;
    fill[i] = 0;
  }
  __syncthreads();

  // this thread's rows, kThreads apart so that a warp's loads are
  // contiguous: texel, contribution, slot
  int tex[kRowsPerThread];
  float c[kRowsPerThread][3];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = row0 + threadIdx.x + k * kThreads;
    const bool in = r < seg.rows;
    int t = in ? __ldg(seg.texel + r) : -1;
    if (!(in && seg.mask[r]) || t < 0 || t >= p) t = -1;
    tex[k] = t;
    if (t >= 0) {
      const float* src = seg.contrib + 3 * static_cast<size_t>(r);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) c[k][ch] = __ldg(src + ch);
    }
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    int s = -1;
    if (tex[k] >= 0) {
      s = slot_of(key, tex[k]);
      atomicAdd(fill + s, 1);
    }
    at[threadIdx.x + k * kThreads] = static_cast<short>(s);
  }
  __syncthreads();

  // the runs one after another in slot order: an exclusive scan of the
  // counts, kSlotsPerThread consecutive slots per thread
  int cnt[kSlotsPerThread];
  int sum = 0;
#pragma unroll
  for (int q = 0; q < kSlotsPerThread; ++q) {
    cnt[q] = fill[threadIdx.x * kSlotsPerThread + q];
    sum += cnt[q];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kThreads / 32 ? warp_total[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    if (lane < kThreads / 32) warp_total[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int off[kSlotsPerThread];
  off[0] = (warp > 0 ? warp_total[warp - 1] : 0) + incl - sum;
#pragma unroll
  for (int q = 1; q < kSlotsPerThread; ++q) off[q] = off[q - 1] + cnt[q - 1];
#pragma unroll
  for (int q = 0; q < kSlotsPerThread; ++q) fill[threadIdx.x * kSlotsPerThread + q] = off[q];
  __syncthreads();

  // one warp ranks the live rows in row order: a row's place is its run's
  // next free place plus the rows of its texel before it among these 32
  if (warp == 0) {
    const unsigned below = (1u << lane) - 1u;
    for (int j = lane; j < kBlockRows; j += 32) {
      const int s = at[j];
      const unsigned peers = __match_any_sync(0xffffffffu, s);
      const int place = s >= 0 ? fill[s] + __popc(peers & below) : -1;
      __syncwarp();
      if (s >= 0 && (peers & below) == 0) fill[s] += __popc(peers);
      __syncwarp();
      at[j] = static_cast<short>(place);
    }
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (tex[k] < 0) continue;
    float* dst = S.placed + 3 * static_cast<size_t>(region + at[threadIdx.x + k * kThreads]);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) dst[ch] = c[k][ch];
  }
  // push each run onto its texel's list
#pragma unroll
  for (int q = 0; q < kSlotsPerThread; ++q) {
    if (cnt[q] == 0) continue;
    const int t = key[threadIdx.x * kSlotsPerThread + q];
    const int start = region + off[q];
    S.len[start] = cnt[q];
    const u64 prev = atomicExch(S.head + t, tagged(gen, start));
    S.next[start] = prev;
    if (!current(prev, gen)) S.touched[atomicAdd(S.count + (gen & 1), 1)] = t;
  }
}

// One step of a sum: this lane's kDepth rows of the texel's ordered rows,
// lane + 32 k past the step's first, and its cursor (run, offset) moved
// on by 32 rows after each.
struct Cursor {
  int run;
  int off;
};

__device__ __forceinline__ void advance(Cursor& cur, const int* len, int m) {
  while (cur.run < m && cur.off >= len[cur.run]) {
    cur.off -= len[cur.run];
    ++cur.run;
  }
}

__device__ __forceinline__ void load_step(const float* placed, const int* start, const int* len,
                                          int m, Cursor& cur, float4 v[kDepth]) {
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (cur.run < m) {
      const float* src = placed + 3 * static_cast<size_t>(start[cur.run] + cur.off);
      v[k] = make_float4(src[0], src[1], src[2], 0.f);
    }
    cur.off += 32;
    advance(cur, len, m);
  }
}

__global__ void __launch_bounds__(kSumWarps * 32)
    scatter_add_sum_kernel(float* __restrict__ g, Scratch S, unsigned gen) {
  __shared__ int runs[kSumWarps][kMaxRuns];   // the texel's run starts as pushed
  __shared__ int start[kSumWarps][kMaxRuns];  // in block order
  __shared__ int len[kSumWarps][kMaxRuns];
  __shared__ float4 buf[kSumWarps][kDepth * 32];
  if (blockIdx.x == 0 && threadIdx.x == 0) S.count[(gen + 1) & 1] = 0;  // the next call's
  const int n = S.count[gen & 1];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int* my_runs = runs[w];
  int* my_start = start[w];
  int* my_len = len[w];
  float4* my_buf = buf[w];
  for (int i = blockIdx.x * kSumWarps + w; i < n; i += gridDim.x * kSumWarps) {
    const int t = S.touched[i];
    // the texel's runs, pushed in any order
    int m = 0;
    for (u64 h = S.head[t];; ++m) {
      const int r = static_cast<int>(h & 0xffffffffu);
      if (lane == 0) my_runs[m] = r;
      h = S.next[r];
      if (!current(h, gen)) {
        ++m;
        break;
      }
    }
    __syncwarp();
    // in block order: a run's rank is the number of runs that start before it
    for (int a = lane; a < m; a += 32) {
      const int r = my_runs[a];
      int rank = 0;
      for (int b = 0; b < m; ++b) rank += my_runs[b] < r;
      my_start[rank] = r;
      my_len[rank] = S.len[r];
    }
    __syncwarp();
    int total = 0;
    for (int a = 0; a < m; ++a) total += my_len[a];
    float v0 = g[3 * static_cast<size_t>(t)], v1 = g[3 * static_cast<size_t>(t) + 1],
          v2 = g[3 * static_cast<size_t>(t) + 2];
    Cursor cur = {0, lane};
    advance(cur, my_len, m);
    float4 now[kDepth], next[kDepth];
    load_step(S.placed, my_start, my_len, m, cur, now);
    for (int base = 0; base < total; base += kDepth * 32) {
      if (base + kDepth * 32 < total) load_step(S.placed, my_start, my_len, m, cur, next);
#pragma unroll
      for (int k = 0; k < kDepth; ++k) my_buf[32 * k + lane] = now[k];
      __syncwarp();
      if (lane == 0) {
        const int end = min(kDepth * 32, total - base);
#pragma unroll 32
        for (int j = 0; j < end; ++j) {
          const float4 x = my_buf[j];
          v0 = v0 + x.x;
          v1 = v1 + x.y;
          v2 = v2 + x.z;
        }
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kDepth; ++k) now[k] = next[k];
    }
    if (lane == 0) {
      float* dst = g + 3 * static_cast<size_t>(t);
      dst[0] = v0;
      dst[1] = v1;
      dst[2] = v2;
    }
    __syncwarp();
  }
}

__global__ void empty_kernel() {}

}  // namespace

// The most segments and blocks one call takes, and the rows of a block.
extern "C" int scatter_add_max_segments() { return kMaxSegments; }
extern "C" int scatter_add_max_blocks() { return kMaxRuns; }
extern "C" int scatter_add_block_rows() { return kBlockRows; }

// Launches K2 over ``n_seg`` segments (host arrays of their texel,
// contribution and mask pointers and row counts, in at most kMaxRuns
// blocks of kBlockRows rows, each segment starting a block) into the (p,
// 3) table ``g`` on ``stream`` as generation ``gen`` (> 0, a new one every
// call with the same scratch), with the scratch of struct Scratch (next,
// len, placed and touched sized for kBlockRows rows per block), and
// returns the CUDA error (0 = launched).
extern "C" int scatter_add_launch(float* g, int p, const int* const* texel,
                                  const float* const* contrib, const bool* const* mask,
                                  const int* rows, int n_seg, u64* head, int* count, u64* next,
                                  int* len, float* placed, int* touched, unsigned gen,
                                  cudaStream_t stream) {
  if (n_seg < 1 || n_seg > kMaxSegments || gen == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Segments sg = {};
  sg.count = n_seg;
  int blocks = 0;
  for (int s = 0; s < n_seg; ++s) {
    if (rows[s] < 1) return static_cast<int>(cudaErrorInvalidValue);
    const long long need = (rows[s] + static_cast<long long>(kBlockRows) - 1) / kBlockRows;
    if (blocks + need > kMaxRuns) return static_cast<int>(cudaErrorInvalidValue);
    sg.s[s] = {texel[s], contrib[s], mask[s], rows[s], blocks};
    blocks += static_cast<int>(need);
  }
  const Scratch S = {head, count, next, len, placed, touched};
  scatter_add_place_kernel<<<blocks, kThreads, 0, stream>>>(p, sg, S, gen);
  scatter_add_sum_kernel<<<kSumBlocks, kSumWarps * 32, 0, stream>>>(g, S, gen);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel through the same route: the floor of a launch, for
// measurements.
extern "C" int empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
