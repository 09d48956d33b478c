// K5: the dense triangle sweep -- each ray's nearest triangle of a whole
// table in [t_min, t_max], by the Moeller-Trumbore triple-product form.
// K6: the same function by a two-level cluster sweep, for large meshes
// (see cluster_sweep_kernel below).
//
// K5 replaces ray_tracing_tpu/ops/pallas_triangles.py:_kernel (with its
// body _tri_sweep_body).  The plain PyTorch version of the same function is
// triangle_sweep_plain in ray_tracing_tpu_torch/ops/cuda_triangles.py.
//
// What bounds it on an H100: arithmetic.  Every ray meets every triangle,
// ~40 flops per pair (four 3-term dot products, a division, the mask
// chain), so a 65,536-ray tile against the 4,969-triangle bunny is ~13
// GFLOP; device memory sees only 24 B of ray in and 9 B of winner out per
// ray.  The table, 64 B per triangle ([e12 e13 n g1 g2 d0], T x 16 float32),
// is too large for one block's shared memory (318 KB for the bunny), so
// each block streams it through shared memory in chunks of kChunk
// triangles (32 KB): the block loads a chunk cooperatively with 16-byte
// loads, then every thread sweeps the chunk against its running winner.
// All threads of a warp read the same triangle at once, a shared-memory
// broadcast.
//
// Design: one thread per ray, rays as contiguous (N, 3) float32 with the
// ragged tail masked; each ray is translated by the table's sweep origin
// in float32 (as pallas_triangles.py:_blocked_rays does).  Chunks and the
// triangles in a chunk go in ascending order and a triangle wins only
// with a strictly smaller t, so on equal t the lowest index wins, as the
// argmin of the plain version does.  Every dot product is summed as
// (a0 b0 + a1 b1) + a2 b2 and m = ro x rd in the plain version's order,
// and the build uses -fmad=false, so the winners and their t equal the
// plain version's.  The TPU kernel's chunk-AABB cull is left out: a cull
// only saves work, and a per-ray one is exposed to rounding on box faces.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 512;  // triangles per shared-memory chunk (32 KB)

// The triple-product test of one triangle (four float4 rows [e12x e12y e12z
// e13x] [e13y e13z nx ny] [nz g1x g1y g1z] [g2x g2y g2z d0]) against a ray
// translated to the sweep origin (s), its direction (d) and m = s x d; the
// winner moves only on a strictly smaller t.  Every dot product is summed
// as (a0 b0 + a1 b1) + a2 b2, the plain version's order.
__device__ __forceinline__ void sweep_triangle(
    const float4* row, int index, float sx, float sy, float sz, float dx,
    float dy, float dz, float mx, float my, float mz, float t_min,
    float t_max, float* best_t, int* best_idx, bool* found) {
  const float4 a = row[0], b = row[1], c = row[2], e = row[3];
  const float det = -((dx * b.z + dy * b.w) + dz * c.x);
  if (!(fabsf(det) > 0.0f)) return;
  const float inv = 1.0f / det;
  const float u = inv * (((mx * a.w + my * b.x) + mz * b.y) -
                         ((dx * c.y + dy * c.z) + dz * c.w));
  if (!(u >= 0.0f && u <= 1.0f)) return;
  const float v = inv * (((dx * e.x + dy * e.y) + dz * e.z) -
                         ((mx * a.x + my * a.y) + mz * a.z));
  if (!(v >= 0.0f && u + v <= 1.0f)) return;
  const float t = inv * (((sx * b.z + sy * b.w) + sz * c.x) - e.w);
  if (t >= t_min && t <= t_max && t < *best_t) {
    *best_t = t;
    *best_idx = index;
    *found = true;
  }
}

__global__ void __launch_bounds__(kThreads) triangle_sweep_kernel(
    const float4* __restrict__ tri, int n_tri, const float* __restrict__ origin,
    const float* __restrict__ ro, const float* __restrict__ rd, int n,
    float t_min, float t_max, float* __restrict__ t_out,
    int* __restrict__ idx_out, bool* __restrict__ found_out) {
  __shared__ float4 s_tri[kChunk * 4];

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < n;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, dx = 1.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    sx = ro[3 * r] - origin[0];
    sy = ro[3 * r + 1] - origin[1];
    sz = ro[3 * r + 2] - origin[2];
    dx = rd[3 * r];
    dy = rd[3 * r + 1];
    dz = rd[3 * r + 2];
  }
  // m = ro_s x rd
  const float mx = sy * dz - sz * dy;
  const float my = sz * dx - sx * dz;
  const float mz = sx * dy - sy * dx;

  float best_t = CUDART_INF_F;
  int best_idx = 0;
  bool found = false;

  for (int base = 0; base < n_tri; base += kChunk) {
    const int count = min(kChunk, n_tri - base);
    __syncthreads();  // the previous chunk is swept by every thread
    for (int i = threadIdx.x; i < 4 * count; i += blockDim.x) {
      s_tri[i] = tri[4 * base + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < count; ++j) {
      sweep_triangle(s_tri + 4 * j, base + j, sx, sy, sz, dx, dy, dz, mx, my,
                     mz, t_min, t_max, &best_t, &best_idx, &found);
    }
  }

  if (live) {
    t_out[r] = best_t;
    idx_out[r] = best_idx;
    found_out[r] = found;
  }
}

// K6: the two-level cluster sweep.  Replaces
// ray_tracing_tpu/ops/pallas_triangles.py:_cluster_kernel (K6) and
// _cluster_kernel_paged (K7) with one kernel; the plain PyTorch version of
// the same function is cluster_sweep_plain in
// ray_tracing_tpu_torch/ops/cuda_triangles.py.
//
// What bounds it on an H100: the arithmetic of the ray-triangle pairs that
// survive the cull (~40 flops each, as K5) and the slab tests (~20 flops
// per ray and cluster); device memory sees the rays, the winners and the
// table's clusters that some block needs (the 5.1 MB table of the 79,488-
// triangle grid sits in L2).  Design: one thread per ray, kClusterThreads
// rays per block, each translated by the sweep origin and windowed by
// [t_min, t_max] and its running best.  The table goes in clusters of
// kClusterTris consecutive (Morton-sorted) triangles in ascending order.
// For each cluster every thread slab-tests its ray against the cluster's
// AABB with IEEE 1/rd (a 0 * inf NaN fails, as in the plain version);
// __syncthreads_or decides whether the block needs the cluster, and only
// then does the block load its 8 KB of constants into shared memory with
// 16-byte loads; a warp with no surviving ray skips the sweep.  A culled
// cluster costs neither the load nor the sweep.  The (Kc, 6) AABB table
// stays in device memory (15 KB for the grid, in L2 and L1); every thread
// of the block reads the same row, a broadcast, so any Kc works and the
// TPU kernel's paging of AABBs through SMEM (K7) has no counterpart.  The
// triangle test is K5's (sweep_triangle, strict <, ascending global index,
// -fmad=false), so the winners and their t equal the plain version's
// wherever the cull is conservative.  128 rays per block: smaller blocks
// cull better (the block needs a cluster when any of its rays does), and
// 128 keeps four warps to share each load.
constexpr int kClusterThreads = 128;
constexpr int kClusterTris = 128;  // triangles per cluster (8 KB)

// max and min that return NaN when either operand is NaN, as the plain
// version's torch.maximum / torch.minimum / amax / amin do
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kClusterThreads) cluster_sweep_kernel(
    const float4* __restrict__ tri, int n_tri, const float* __restrict__ aabb,
    int n_clusters, const float* __restrict__ origin,
    const float* __restrict__ ro, const float* __restrict__ rd, int n,
    float t_min, float t_max, float* __restrict__ t_out,
    int* __restrict__ idx_out, bool* __restrict__ found_out,
    int* __restrict__ stats) {
  __shared__ float4 s_tri[kClusterTris * 4];

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < n;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, dx = 1.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    sx = ro[3 * r] - origin[0];
    sy = ro[3 * r + 1] - origin[1];
    sz = ro[3 * r + 2] - origin[2];
    dx = rd[3 * r];
    dy = rd[3 * r + 1];
    dz = rd[3 * r + 2];
  }
  const float mx = sy * dz - sz * dy;
  const float my = sz * dx - sx * dz;
  const float mz = sx * dy - sy * dx;
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;

  float best_t = CUDART_INF_F;
  int best_idx = 0;
  bool found = false;
  int loads = 0, sweeps = 0, needs = 0;

  for (int k = 0; k < n_clusters; ++k) {
    bool alive = false;
    if (live) {
      const float* box = aabb + 6 * k;
      const float ax = (box[0] - sx) * ix, bx = (box[3] - sx) * ix;
      const float ay = (box[1] - sy) * iy, by = (box[4] - sy) * iy;
      const float az = (box[2] - sz) * iz, bz = (box[5] - sz) * iz;
      const float near = max_nan(
          max_nan(max_nan(min_nan(ax, bx), min_nan(ay, by)), min_nan(az, bz)),
          t_min);
      const float far = min_nan(
          min_nan(min_nan(max_nan(ax, bx), max_nan(ay, by)), max_nan(az, bz)),
          t_max);
      alive = near <= min_nan(far, fminf(best_t, t_max));
      needs += alive;
    }
    // a barrier too: every thread has swept the previous cluster
    if (!__syncthreads_or(alive)) continue;
    const int base = k * kClusterTris;
    const int count = min(kClusterTris, n_tri - base);
    for (int i = threadIdx.x; i < 4 * count; i += blockDim.x) {
      s_tri[i] = tri[4 * base + i];
    }
    __syncthreads();
    ++loads;
    if (!__any_sync(0xffffffffu, alive)) continue;
    ++sweeps;
    if (!live) continue;
    for (int j = 0; j < count; ++j) {
      sweep_triangle(s_tri + 4 * j, base + j, sx, sy, sz, dx, dy, dz, mx, my,
                     mz, t_min, t_max, &best_t, &best_idx, &found);
    }
  }

  if (live) {
    t_out[r] = best_t;
    idx_out[r] = best_idx;
    found_out[r] = found;
  }
  if (stats != nullptr) {
    if (threadIdx.x == 0) atomicAdd(stats, loads);
    const int warp_needs = __reduce_add_sync(0xffffffffu, needs);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(stats + 1, sweeps);
      atomicAdd(stats + 2, warp_needs);
    }
  }
}

}  // namespace

// Launches K5 on ``stream`` and returns cudaGetLastError() (0 = launched).
// ``tri`` is the (n_tri, 16) table, 16-byte aligned.
extern "C" int triangle_sweep_launch(const float* tri, int n_tri,
                                     const float* origin, const float* ro,
                                     const float* rd, int n, float t_min,
                                     float t_max, float* t_out, int* idx_out,
                                     bool* found_out, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  triangle_sweep_kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(tri), n_tri, origin, ro, rd, n, t_min,
      t_max, t_out, idx_out, found_out);
  return static_cast<int>(cudaGetLastError());
}

// Launches K6 on ``stream`` and returns cudaGetLastError() (0 = launched).
// ``tri`` is the (n_tri, 16) table, 16-byte aligned; ``aabb`` the
// (n_clusters, 6) boxes [lo hi] of its kClusterTris-triangle clusters in
// sweep-origin space; ``stats`` (may be null) gains the (block, cluster)
// loads, the (warp, cluster) sweeps and the (ray, cluster) pairs whose
// window the cull let through.
extern "C" int cluster_sweep_launch(const float* tri, int n_tri,
                                    const float* aabb, int n_clusters,
                                    const float* origin, const float* ro,
                                    const float* rd, int n, float t_min,
                                    float t_max, float* t_out, int* idx_out,
                                    bool* found_out, int* stats,
                                    cudaStream_t stream) {
  const int blocks = (n + kClusterThreads - 1) / kClusterThreads;
  cluster_sweep_kernel<<<blocks, kClusterThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(tri), n_tri, aabb, n_clusters, origin,
      ro, rd, n, t_min, t_max, t_out, idx_out, found_out, stats);
  return static_cast<int>(cudaGetLastError());
}
