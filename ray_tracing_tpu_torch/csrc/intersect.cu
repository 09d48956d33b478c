// K1: phase A of the scene intersection -- each ray's nearest sphere root
// and nearest axis-aligned rect hit in [t_min, t_max].
//
// Replaces ray_tracing_tpu/ops/pallas_intersect.py:_kernel in its plain
// variant (no instancing transforms, no motion blur).  The plain PyTorch
// version of the same function is phase_a_plain in
// ray_tracing_tpu_torch/ops/cuda_intersect.py.
//
// What bounds it on an H100: each ray reads its origin and direction
// (24 B) and writes its winner (t, kind, idx: 12 B), 36 B of device-memory
// traffic per ray, against ~20 flops per primitive.  The primitive tables
// (spheres (S, 4) = [cx cy cz r], rects (R, 14) = [ua ub uk a0 a1 b0 b1 k])
// are staged into shared memory once per block, so they cost no
// device-memory traffic per ray.
//
// Design: one thread per ray, rays as contiguous (N, 3) float32 with the
// ragged tail masked (no padding).  The loop order and the tie rule are
// the TPU kernel's: spheres, then rects, each taking the hit only when
// its t is strictly smaller than the best so far, so on equal t the lower
// kind and then the lower index wins.  Built with -fmad=false, so every
// product and sum rounds as PyTorch's unfused elementwise ops do and the
// winners compare exactly with the plain version.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSphereCols = 4;
constexpr int kRectCols = 14;
constexpr int kKindSphere = 0;
constexpr int kKindRect = 2;

__global__ void __launch_bounds__(kThreads) phase_a_kernel(
    const float* __restrict__ sph, int n_sph,
    const float* __restrict__ rect, int n_rect,
    const float* __restrict__ ro, const float* __restrict__ rd, int n,
    float t_min, float t_max,
    float* __restrict__ t_out, int* __restrict__ kind_out,
    int* __restrict__ idx_out) {
  extern __shared__ float tables[];
  float* s_sph = tables;
  float* s_rect = tables + kSphereCols * n_sph;
  for (int i = threadIdx.x; i < kSphereCols * n_sph; i += blockDim.x) {
    s_sph[i] = sph[i];
  }
  for (int i = threadIdx.x; i < kRectCols * n_rect; i += blockDim.x) {
    s_rect[i] = rect[i];
  }
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float ox = ro[3 * r], oy = ro[3 * r + 1], oz = ro[3 * r + 2];
  const float dx = rd[3 * r], dy = rd[3 * r + 1], dz = rd[3 * r + 2];

  float best_t = CUDART_INF_F;
  int best_kind = -1;
  int best_idx = 0;

  for (int s = 0; s < n_sph; ++s) {
    const float* c = s_sph + kSphereCols * s;
    const float ocx = ox - c[0], ocy = oy - c[1], ocz = oz - c[2];
    const float half_b = ocx * dx + ocy * dy + ocz * dz;
    const float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - c[3] * c[3];
    const float disc = half_b * half_b - cc;
    if (!(disc >= 0.0f)) continue;
    const float sq = sqrtf(disc);
    const float root1 = -half_b - sq;
    const float root2 = -half_b + sq;
    const float hi = fminf(best_t, t_max);
    const bool mask1 = root1 >= t_min && root1 <= hi;
    const bool mask2 = root2 >= t_min && root2 <= hi;
    const float t = mask1 ? root1 : root2;
    if ((mask1 || mask2) && t < best_t) {
      best_t = t;
      best_kind = kKindSphere;
      best_idx = s;
    }
  }

  for (int q = 0; q < n_rect; ++q) {
    const float* p = s_rect + kRectCols * q;
    const float d2 = dx * p[6] + dy * p[7] + dz * p[8];
    if (d2 == 0.0f) continue;
    const float o2 = ox * p[6] + oy * p[7] + oz * p[8];
    const float t = (p[13] - o2) / d2;
    if (!(t >= t_min && t <= fminf(best_t, t_max))) continue;
    const float a = (ox * p[0] + oy * p[1] + oz * p[2]) + t * (dx * p[0] + dy * p[1] + dz * p[2]);
    const float b = (ox * p[3] + oy * p[4] + oz * p[5]) + t * (dx * p[3] + dy * p[4] + dz * p[5]);
    if (a >= p[9] && a <= p[10] && b >= p[11] && b <= p[12] && t < best_t) {
      best_t = t;
      best_kind = kKindRect;
      best_idx = q;
    }
  }

  t_out[r] = best_t;
  kind_out[r] = best_kind;
  idx_out[r] = best_idx;
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() (0 = launched).
extern "C" int phase_a_launch(const float* sph, int n_sph, const float* rect,
                              int n_rect, const float* ro, const float* rd,
                              int n, float t_min, float t_max, float* t_out,
                              int* kind_out, int* idx_out,
                              cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kSphereCols * static_cast<size_t>(n_sph) +
                       kRectCols * static_cast<size_t>(n_rect));
  const int blocks = (n + kThreads - 1) / kThreads;
  phase_a_kernel<<<blocks, kThreads, smem, stream>>>(
      sph, n_sph, rect, n_rect, ro, rd, n, t_min, t_max, t_out, kind_out,
      idx_out);
  return static_cast<int>(cudaGetLastError());
}
