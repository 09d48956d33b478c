// K5 and K6: each ray's nearest triangle of a (T, 16) table in [t_min,
// t_max], by the Moeller-Trumbore triple-product form, through one
// front-to-back traversal of 128-triangle clusters.
//
// K5 (triangle_sweep_kernel) replaces ray_tracing_tpu/ops/
// pallas_triangles.py:_kernel (with its body _tri_sweep_body), the dense
// sweep of a table of at most 32,768 triangles; its plain PyTorch version
// is triangle_sweep_plain in ray_tracing_tpu_torch/ops/cuda_triangles.py,
// which has no cull.  K6 (cluster_sweep_kernel) replaces
// pallas_triangles.py:_cluster_kernel and _cluster_kernel_paged (K7) for
// any number of clusters; its plain version is cluster_sweep_plain.  The
// two kernels run the same routine (traverse); they stay two entry points
// with two launch counts because the JAX package splits them.
//
// What bounds it on an H100: arithmetic, ~40 flops per ray-triangle pair
// (four 3-term dot products, a division, the mask chain) and ~12 per
// slab test, over the (ray, cluster) pairs that a front-to-back sweep
// needs: those whose box the ray enters before its own hit
// (cuda_triangles.needed_cluster_pairs).  Device memory sees 24 B of ray
// in and 9 B of winner out per ray; the table (64 B per triangle, 318 KB
// for scene.json's bunny, 5.1 MB for C6) and the (Kc, 6) boxes sit in
// L2.
//
// Design, one warp of 32 rays as the unit of every decision (no block
// barrier anywhere):
// 1. List.  Per page of kListCap clusters in index order, the lanes first
//    build the exact boxes of groups of kGroup clusters (lane-parallel,
//    into the warp's cluster buffer).  The warp then slab-tests each
//    group box (each lane its own ray), and only inside a group that
//    some lane enters each cluster box (all lanes the same box, a
//    broadcast through L1); with __ballot_sync it appends each cluster
//    that some lane enters before its best to a per-warp list in shared
//    memory, keyed by the smallest entry distance of those lanes
//    (__reduce_min_sync).
// 2. Sort.  A bitonic sort of the list in shared memory by that key (the
//    key's top bits, then the cluster), so clusters go front to back.
// 3. Sweep.  Before each cluster every lane re-tests the box against its
//    running best; the warp skips the cluster when no lane survives
//    (__ballot_sync), so a ray stops paying for clusters behind its hit.
//    The cluster's 8 KB arrive in the warp's buffer by cp.async, stored
//    by row kind (row q of triangle j at q * 128 + j).  With kWideLanes
//    or more surviving lanes, each of them sweeps the 128 triangles, read
//    as broadcasts; with fewer, the warp takes the survivors one at a
//    time (the ray by __shfl_sync), each lane tests 4 of the 128
//    triangles (conflict-free loads) and a butterfly of shuffles reduces
//    (t, index) to the warp's winner, so an incoherent warp pays for the
//    pairs its rays need and not 32 lanes per cluster.  One buffer per
//    warp, not two: the shared memory a second one takes costs more
//    warps per SM than overlapping a warp's own load saves (PERF.md).
//    The triangle test has no early exit, so the tests of a loop overlap.
// The cull is conservative: the boxes are padded outward by a few ulps
// (models/scene.py:pack_cluster_aabbs), a group box holds its clusters'
// boxes exactly, and a NaN slab (0 * inf, a ray in a face's plane)
// passes, so rounding can cost work but never a hit.  The winner moves
// on a smaller t, or an equal t at a lower index, inside [t_min, t_max]:
// the plain versions' argmin, lowest index on equal t, whatever order the
// clusters and triangles are visited in.  Every dot product is summed as
// (a0 b0 + a1 b1) + a2 b2, m = ro x rd in the plain version's order, 1/rd
// and 1/det are IEEE divisions, and the build uses -fmad=false, so
// winners and their t equal the plain versions'.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kClusterTris = 128;               // triangles per cluster
constexpr int kClusterRows = 4 * kClusterTris;  // float4 rows of a cluster (8 KB)
constexpr int kWarps = 4;                       // warps of 32 rays per block
constexpr int kThreads = 32 * kWarps;
constexpr int kListCap = 512;   // clusters per page of a warp's list
constexpr int kGroup = 8;       // clusters per group box of the listing
constexpr int kWideLanes = 24;  // surviving lanes from which each sweeps the cluster itself
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoIndex = 0x7fffffff;
constexpr int kSmemBytes = kWarps * (kClusterRows * static_cast<int>(sizeof(float4)) +
                                     kListCap * static_cast<int>(sizeof(unsigned)));
static_assert((kListCap / kGroup) * 6 * sizeof(float) <= kClusterRows * sizeof(float4),
              "a page's group boxes fit in the cluster buffer");
static_assert(kSmemBytes <= 48 * 1024, "no opt-in to more dynamic shared memory is needed");

// A ray translated to the sweep origin (s), its direction (d), m = s x d
// and the IEEE reciprocals of d.
struct Ray {
  float sx, sy, sz, dx, dy, dz, mx, my, mz, ix, iy, iz;
};

// max and min that return NaN when either operand is NaN, as the plain
// versions' torch.maximum / torch.minimum / amax / amin do
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// Whether the triangle with rows [e12x e12y e12z e13x] [e13y e13z nx ny]
// [nz g1x g1y g1z] [g2x g2y g2z d0] is hit in [t_min, t_max], at ``t``;
// every term is computed and the mask chain applied at the end.
__device__ __forceinline__ bool hit_triangle(float4 a, float4 b, float4 c, float4 e,
                                             const Ray& r, float t_min, float t_max, float& t) {
  const float det = -((r.dx * b.z + r.dy * b.w) + r.dz * c.x);
  const float inv = 1.0f / det;
  const float u = inv * (((r.mx * a.w + r.my * b.x) + r.mz * b.y) -
                         ((r.dx * c.y + r.dy * c.z) + r.dz * c.w));
  const float v = inv * (((r.dx * e.x + r.dy * e.y) + r.dz * e.z) -
                         ((r.mx * a.x + r.my * a.y) + r.mz * a.z));
  t = inv * (((r.sx * b.z + r.sy * b.w) + r.sz * c.x) - e.w);
  return fabsf(det) > 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t >= t_min && t <= t_max;
}

// The winner order: a smaller t, or an equal t at a lower index.  A best
// of (inf, 0), the start, never loses to t = inf.
__device__ __forceinline__ bool better(float t, int index, float best_t, int best_idx) {
  return t < best_t || (t == best_t && index < best_idx);
}

// (t, index) of the warp's winner in every lane.
__device__ __forceinline__ void warp_min(float& t, int& index) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float ot = __shfl_xor_sync(kFull, t, offset);
    const int oi = __shfl_xor_sync(kFull, index, offset);
    if (better(ot, oi, t, index)) {
      t = ot;
      index = oi;
    }
  }
}

// Whether the ray enters the box [lo hi] within [t_min, t_hi]; ``near``
// is its entry distance.  A NaN passes.
__device__ __forceinline__ bool slab(float lx, float ly, float lz, float hx, float hy, float hz,
                                     const Ray& r, float t_min, float t_hi, float& near) {
  const float ax = (lx - r.sx) * r.ix, bx = (hx - r.sx) * r.ix;
  const float ay = (ly - r.sy) * r.iy, by = (hy - r.sy) * r.iy;
  const float az = (lz - r.sz) * r.iz, bz = (hz - r.sz) * r.iz;
  near = max_nan(max_nan(max_nan(min_nan(ax, bx), min_nan(ay, by)), min_nan(az, bz)), t_min);
  const float far =
      min_nan(min_nan(min_nan(max_nan(ax, bx), max_nan(ay, by)), max_nan(az, bz)), t_hi);
  return !(near > far);
}

// slab() of cluster k's box, row k of the (Kc, 6) table (8-byte aligned).
__device__ __forceinline__ bool enters(const float* __restrict__ aabb, int k, const Ray& r,
                                       float t_min, float t_hi, float& near) {
  const float2* box = reinterpret_cast<const float2*>(aabb + 6 * k);
  const float2 p = __ldg(box), q = __ldg(box + 1), w = __ldg(box + 2);
  return slab(p.x, p.y, q.x, q.y, w.x, w.y, r, t_min, t_hi, near);
}

// A monotone map of a float to an unsigned key; NaN first.
__device__ __forceinline__ unsigned order_key(float x) {
  if (x != x) return 0u;
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Ascending bitonic sort of list[0, count) by one warp, padded to a power
// of two with ~0 (which sorts last).
__device__ __forceinline__ void sort_list(unsigned* list, int count, int lane) {
  int n = 1;
  while (n < count) n <<= 1;
  for (int i = count + lane; i < n; i += 32) list[i] = kFull;
  __syncwarp();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < (n >> 1); i += 32) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned a = list[lo], b = list[hi];
        if ((a > b) == ((lo & size) == 0)) {
          list[lo] = b;
          list[hi] = a;
        }
      }
      __syncwarp();
    }
  }
}

// The group boxes of clusters [page, page + page_n), kGroup to a box, as
// six floats each in ``group`` (the lanes take a box each); NaN-propagating,
// so a NaN cluster box makes its group box pass.
__device__ __forceinline__ void group_boxes(const float* __restrict__ aabb, int page, int page_n,
                                            float* group, int lane) {
  for (int g = lane; g * kGroup < page_n; g += 32) {
    float lx = CUDART_INF_F, ly = CUDART_INF_F, lz = CUDART_INF_F;
    float hx = -CUDART_INF_F, hy = -CUDART_INF_F, hz = -CUDART_INF_F;
    const int end = min(page_n, (g + 1) * kGroup);
    for (int j = g * kGroup; j < end; ++j) {
      const float2* box = reinterpret_cast<const float2*>(aabb + 6 * (page + j));
      const float2 p = __ldg(box), q = __ldg(box + 1), w = __ldg(box + 2);
      lx = min_nan(lx, p.x);
      ly = min_nan(ly, p.y);
      lz = min_nan(lz, q.x);
      hx = max_nan(hx, q.y);
      hy = max_nan(hy, w.x);
      hz = max_nan(hz, w.y);
    }
    float* out = group + 6 * g;
    out[0] = lx;
    out[1] = ly;
    out[2] = lz;
    out[3] = hx;
    out[4] = hy;
    out[5] = hz;
  }
}

// The warp's lanes copy cluster k's real rows into ``dst``, row q of
// triangle j to dst[q * kClusterTris + j] (16 bytes each, cp.async), and
// wait for them.
__device__ __forceinline__ void load_cluster(float4* dst, const float4* __restrict__ tri, int k,
                                             int n_tri, int lane) {
  const int rows = 4 * min(kClusterTris, n_tri - k * kClusterTris);
  const float4* src = tri + k * kClusterRows;
  for (int i = lane; i < rows; i += 32) {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + (i & 3) * kClusterTris + (i >> 2)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sweep the cluster whose first triangle is ``base`` (``count``
// triangles, rows in ``rows``) for the lanes in ``alive_mask`` (see the
// header, step 3).
__device__ __forceinline__ void sweep_cluster(const float4* rows, int base, int count,
                                              unsigned alive_mask, bool alive, const Ray& ray,
                                              float t_min, float t_max, float& best_t,
                                              int& best_idx, bool& found, int lane) {
  if (__popc(alive_mask) >= kWideLanes) {
    if (!alive) return;
#pragma unroll 4
    for (int j = 0; j < count; ++j) {
      float t;
      if (hit_triangle(rows[j], rows[kClusterTris + j], rows[2 * kClusterTris + j],
                       rows[3 * kClusterTris + j], ray, t_min, t_max, t) &&
          better(t, base + j, best_t, best_idx)) {
        best_t = t;
        best_idx = base + j;
        found = true;
      }
    }
    return;
  }
  for (unsigned m = alive_mask; m != 0; m &= m - 1) {
    const int src = __ffs(m) - 1;
    Ray r;
    r.sx = __shfl_sync(kFull, ray.sx, src);
    r.sy = __shfl_sync(kFull, ray.sy, src);
    r.sz = __shfl_sync(kFull, ray.sz, src);
    r.dx = __shfl_sync(kFull, ray.dx, src);
    r.dy = __shfl_sync(kFull, ray.dy, src);
    r.dz = __shfl_sync(kFull, ray.dz, src);
    r.mx = __shfl_sync(kFull, ray.mx, src);
    r.my = __shfl_sync(kFull, ray.my, src);
    r.mz = __shfl_sync(kFull, ray.mz, src);
    float lt = CUDART_INF_F;
    int li = kNoIndex;
#pragma unroll
    for (int j = lane; j < kClusterTris; j += 32) {
      float t;
      if (j < count &&
          hit_triangle(rows[j], rows[kClusterTris + j], rows[2 * kClusterTris + j],
                       rows[3 * kClusterTris + j], r, t_min, t_max, t) &&
          better(t, base + j, lt, li)) {
        lt = t;
        li = base + j;
      }
    }
    warp_min(lt, li);
    if (lane == src && better(lt, li, best_t, best_idx)) {
      best_t = lt;
      best_idx = li;
      found = true;
    }
  }
}

// The front-to-back traversal of one warp (see the header).  ``buf``
// holds one cluster (or a page's group boxes while listing) and ``list``
// kListCap entries, both the warp's own shared memory.  ``listed``,
// ``sweeps`` and ``pairs`` count the listed clusters, the (warp, cluster)
// sweeps and the lane's swept clusters that it could still hit.
__device__ __forceinline__ void traverse(const float4* __restrict__ tri, int n_tri,
                                         const float* __restrict__ aabb, int n_clusters,
                                         const Ray& ray, bool live, float t_min, float t_max,
                                         float4* buf, unsigned* list, float& best_t,
                                         int& best_idx, bool& found, int& listed, int& sweeps,
                                         int& pairs) {
  const int lane = threadIdx.x & 31;
  float* group = reinterpret_cast<float*>(buf);
  for (int page = 0; page < n_clusters; page += kListCap) {
    const int page_n = min(kListCap, n_clusters - page);
    const float t_hi = fminf(best_t, t_max);
    __syncwarp();  // every lane is done with the previous page's list and buffer
    group_boxes(aabb, page, page_n, group, lane);
    __syncwarp();
    int count = 0;
    for (int g = 0; g * kGroup < page_n; ++g) {
      float near = 0.0f;
      const bool in_group =
          live && slab(group[6 * g], group[6 * g + 1], group[6 * g + 2], group[6 * g + 3],
                       group[6 * g + 4], group[6 * g + 5], ray, t_min, t_hi, near);
      if (!__any_sync(kFull, in_group)) continue;
      const int end = min(page_n, (g + 1) * kGroup);
      for (int j = g * kGroup; j < end; ++j) {
        const bool in = in_group && enters(aabb, page + j, ray, t_min, t_hi, near);
        if (__ballot_sync(kFull, in)) {
          const unsigned key = __reduce_min_sync(kFull, in ? order_key(near) : kFull);
          if (lane == 0) list[count] = (key & ~(kListCap - 1u)) | j;
          ++count;
        }
      }
    }
    __syncwarp();  // the list is written and the group boxes read
    listed += count;
    sort_list(list, count, lane);

    for (int pos = 0; pos < count; ++pos) {
      const int k = page + (list[pos] & (kListCap - 1));
      float near = 0.0f;
      const bool alive = live && enters(aabb, k, ray, t_min, fminf(best_t, t_max), near);
      const unsigned alive_mask = __ballot_sync(kFull, alive);
      if (alive_mask == 0) continue;
      ++sweeps;
      pairs += alive;
      load_cluster(buf, tri, k, n_tri, lane);
      __syncwarp();  // every lane's copies have landed
      const int base = k * kClusterTris;
      sweep_cluster(buf, base, min(kClusterTris, n_tri - base), alive_mask, alive, ray, t_min,
                    t_max, best_t, best_idx, found, lane);
      __syncwarp();  // every lane is done with the buffer before it is refilled
    }
  }
}

// One thread per ray, rays as contiguous (N, 3) float32 with the ragged
// tail masked; each ray is translated by the table's sweep origin in
// float32 (as pallas_triangles.py:_blocked_rays does).
__device__ __forceinline__ void sweep_rays(const float4* __restrict__ tri, int n_tri,
                                           const float* __restrict__ aabb, int n_clusters,
                                           const float* __restrict__ origin,
                                           const float* __restrict__ ro,
                                           const float* __restrict__ rd, int n, float t_min,
                                           float t_max, float* __restrict__ t_out,
                                           int* __restrict__ idx_out,
                                           bool* __restrict__ found_out, int* stats) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5;
  float4* buf = smem + warp * kClusterRows;
  unsigned* list = reinterpret_cast<unsigned*>(smem + kWarps * kClusterRows) + warp * kListCap;

  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool live = r < n;
  Ray ray;
  ray.sx = ray.sy = ray.sz = 0.0f;
  ray.dx = 1.0f;
  ray.dy = ray.dz = 0.0f;
  if (live) {
    ray.sx = ro[3 * r] - origin[0];
    ray.sy = ro[3 * r + 1] - origin[1];
    ray.sz = ro[3 * r + 2] - origin[2];
    ray.dx = rd[3 * r];
    ray.dy = rd[3 * r + 1];
    ray.dz = rd[3 * r + 2];
  }
  ray.mx = ray.sy * ray.dz - ray.sz * ray.dy;
  ray.my = ray.sz * ray.dx - ray.sx * ray.dz;
  ray.mz = ray.sx * ray.dy - ray.sy * ray.dx;
  ray.ix = 1.0f / ray.dx;
  ray.iy = 1.0f / ray.dy;
  ray.iz = 1.0f / ray.dz;

  float best_t = CUDART_INF_F;
  int best_idx = 0;
  bool found = false;
  int listed = 0, sweeps = 0, pairs = 0;
  traverse(tri, n_tri, aabb, n_clusters, ray, live, t_min, t_max, buf, list, best_t, best_idx,
           found, listed, sweeps, pairs);

  if (live) {
    t_out[r] = best_t;
    idx_out[r] = best_idx;
    found_out[r] = found;
  }
  if (stats != nullptr) {
    const int warp_pairs = __reduce_add_sync(kFull, pairs);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(stats, listed);
      atomicAdd(stats + 1, sweeps);
      atomicAdd(stats + 2, warp_pairs);
    }
  }
}

#define SWEEP_PARAMS                                                                          \
  const float4 *__restrict__ tri, int n_tri, const float *__restrict__ aabb, int n_clusters, \
      const float *__restrict__ origin, const float *__restrict__ ro,                        \
      const float *__restrict__ rd, int n, float t_min, float t_max,                         \
      float *__restrict__ t_out, int *__restrict__ idx_out, bool *__restrict__ found_out,    \
      int *stats
#define SWEEP_ARGS \
  tri, n_tri, aabb, n_clusters, origin, ro, rd, n, t_min, t_max, t_out, idx_out, found_out, stats

__global__ void __launch_bounds__(kThreads) triangle_sweep_kernel(SWEEP_PARAMS) {
  sweep_rays(SWEEP_ARGS);
}

__global__ void __launch_bounds__(kThreads) cluster_sweep_kernel(SWEEP_PARAMS) {
  sweep_rays(SWEEP_ARGS);
}

using SweepKernel = void (*)(SWEEP_PARAMS);

// Launches ``kernel`` with kSmemBytes of dynamic shared memory on
// ``stream``; returns the launch's CUDA error (0 = launched).
int launch(SweepKernel kernel, const float* tri, int n_tri, const float* aabb, int n_clusters,
           const float* origin, const float* ro, const float* rd, int n, float t_min,
           float t_max, float* t_out, int* idx_out, bool* found_out, int* stats,
           cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, kSmemBytes, stream>>>(reinterpret_cast<const float4*>(tri), n_tri,
                                                   aabb, n_clusters, origin, ro, rd, n, t_min,
                                                   t_max, t_out, idx_out, found_out, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch K5 / K6 on ``stream`` and return the first CUDA error (0 =
// launched).  ``tri`` is the (n_tri, 16) table, 16-byte aligned; ``aabb``
// the (n_clusters, 6) padded boxes [lo hi] of its kClusterTris-triangle
// clusters in sweep-origin space, 8-byte aligned; ``stats`` (may be null)
// gains the clusters the warps listed, the (warp, cluster) sweeps and the
// (ray, cluster) pairs swept by a lane that could still hit the cluster.
extern "C" int triangle_sweep_launch(const float* tri, int n_tri, const float* aabb,
                                     int n_clusters, const float* origin, const float* ro,
                                     const float* rd, int n, float t_min, float t_max,
                                     float* t_out, int* idx_out, bool* found_out, int* stats,
                                     cudaStream_t stream) {
  return launch(triangle_sweep_kernel, tri, n_tri, aabb, n_clusters, origin, ro, rd, n,
                t_min, t_max, t_out, idx_out, found_out, stats, stream);
}

extern "C" int cluster_sweep_launch(const float* tri, int n_tri, const float* aabb,
                                    int n_clusters, const float* origin, const float* ro,
                                    const float* rd, int n, float t_min, float t_max,
                                    float* t_out, int* idx_out, bool* found_out, int* stats,
                                    cudaStream_t stream) {
  return launch(cluster_sweep_kernel, tri, n_tri, aabb, n_clusters, origin, ro, rd, n,
                t_min, t_max, t_out, idx_out, found_out, stats, stream);
}
