// K5: the dense triangle sweep -- each ray's nearest triangle of a whole
// table in [t_min, t_max], by the Moeller-Trumbore triple-product form.
//
// Replaces ray_tracing_tpu/ops/pallas_triangles.py:_kernel (with its body
// _tri_sweep_body).  The plain PyTorch version of the same function is
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
      // [e12x e12y e12z e13x] [e13y e13z nx ny] [nz g1x g1y g1z] [g2x g2y g2z d0]
      const float4 a = s_tri[4 * j], b = s_tri[4 * j + 1];
      const float4 c = s_tri[4 * j + 2], e = s_tri[4 * j + 3];
      const float det = -((dx * b.z + dy * b.w) + dz * c.x);
      if (!(fabsf(det) > 0.0f)) continue;
      const float inv = 1.0f / det;
      const float u = inv * (((mx * a.w + my * b.x) + mz * b.y) -
                             ((dx * c.y + dy * c.z) + dz * c.w));
      if (!(u >= 0.0f && u <= 1.0f)) continue;
      const float v = inv * (((dx * e.x + dy * e.y) + dz * e.z) -
                             ((mx * a.x + my * a.y) + mz * a.z));
      if (!(v >= 0.0f && u + v <= 1.0f)) continue;
      const float t = inv * (((sx * b.z + sy * b.w) + sz * c.x) - e.w);
      if (t >= t_min && t <= t_max && t < best_t) {
        best_t = t;
        best_idx = base + j;
        found = true;
      }
    }
  }

  if (live) {
    t_out[r] = best_t;
    idx_out[r] = best_idx;
    found_out[r] = found;
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
