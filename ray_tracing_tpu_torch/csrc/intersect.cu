// K1, K3 and K4: phase A of the scene intersection -- each ray's nearest
// sphere root and nearest axis-aligned rect hit in [t_min, t_max].
//
// Replaces ray_tracing_tpu/ops/pallas_intersect.py:_kernel: K1 is its
// plain variant, K3 its transformed variants (sph_tf / rect_tf, rows
// tested in object space through _object_ray), K4 its motion variant
// (sph_motion: each sphere at the ray's own centre c + t_ray v).  The
// plain PyTorch version of the same function is phase_a_plain in
// ray_tracing_tpu_torch/ops/cuda_intersect.py.
//
// What bounds it on an H100: each ray reads its origin and direction
// (24 B) and writes its winner (t, kind, idx: 12 B), 36 B of device-memory
// traffic per ray (K4 reads 4 B more, its t_ray), against ~20 flops per
// primitive, ~60 with a transform.  The primitive tables (spheres (S, 4) =
// [cx cy cz r], rects (R, 14) = [ua ub uk a0 a1 b0 b1 k], each row
// followed by [inv(9) inv_t(3)] when its table is transformed; a moving
// sphere table (S, 7) = [cx cy cz r vx vy vz]) are staged into shared
// memory once per block, so they cost no device-memory traffic per ray.
//
// Design: one thread per ray, rays as contiguous (N, 3) float32 with the
// ragged tail masked (no padding).  The loop order and the tie rule are
// the TPU kernel's: spheres, then rects, each taking the hit only when
// its t is strictly smaller than the best so far, so on equal t the lower
// kind and then the lower index wins.  Built with -fmad=false, so every
// product and sum rounds as PyTorch's unfused elementwise ops do and the
// winners compare exactly with the plain version.
//
// A transformed row follows the plain version's object-space grid, not
// the TPU kernel's running window: ro_o = inv ro + inv_t and d = inv rd
// (((m0 x + m1 y) + m2 z) per row), nrm = |d|, rd_o = d / max(nrm, 1e-30);
// roots are bounded by [t_min nrm, t_max nrm] and the world t = t_obj / nrm
// then competes with strict <.  Bounding object-space roots by best_t nrm
// instead, as the TPU kernel does, can round to another winner.
//
// K4 computes each centre as c[j] + t_ray v[j] (the product, then the sum,
// as the plain version does) and tests the sphere there.  Moving and
// transformed spheres never share a table (the compiler refuses it), so
// kSphMotion excludes kSphTf; the rect table may still be transformed.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSphereCols = 4;
constexpr int kRectCols = 14;
constexpr int kTfCols = 12;
constexpr int kMotionCols = 3;
constexpr int kKindSphere = 0;
constexpr int kKindRect = 2;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// The ray in the object space of a row whose [inv(9) inv_t(3)] start at
// ``m``; returns nrm = |inv rd|, world t = object t / nrm.
__device__ __forceinline__ float object_ray(const Ray& w, const float* m,
                                            Ray* o) {
  o->ox = ((m[0] * w.ox + m[1] * w.oy) + m[2] * w.oz) + m[9];
  o->oy = ((m[3] * w.ox + m[4] * w.oy) + m[5] * w.oz) + m[10];
  o->oz = ((m[6] * w.ox + m[7] * w.oy) + m[8] * w.oz) + m[11];
  const float ex = (m[0] * w.dx + m[1] * w.dy) + m[2] * w.dz;
  const float ey = (m[3] * w.dx + m[4] * w.dy) + m[5] * w.dz;
  const float ez = (m[6] * w.dx + m[7] * w.dy) + m[8] * w.dz;
  const float nrm = sqrtf((ex * ex + ey * ey) + ez * ez);
  const float den = fmaxf(nrm, 1e-30f);
  o->dx = ex / den;
  o->dy = ey / den;
  o->dz = ez / den;
  return nrm;
}

// Sphere root of ``r`` in [lo, hi]: true and the root in *t on a hit.
__device__ __forceinline__ bool sphere_hit(const Ray& r, const float* c,
                                           float lo, float hi, float* t) {
  const float ocx = r.ox - c[0], ocy = r.oy - c[1], ocz = r.oz - c[2];
  const float half_b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - c[3] * c[3];
  const float disc = half_b * half_b - cc;
  if (!(disc >= 0.0f)) return false;
  const float sq = sqrtf(disc);
  const float root1 = -half_b - sq;
  const float root2 = -half_b + sq;
  const bool mask1 = root1 >= lo && root1 <= hi;
  const bool mask2 = root2 >= lo && root2 <= hi;
  *t = mask1 ? root1 : root2;
  return mask1 || mask2;
}

// Rect plane hit of ``r`` in [lo, hi] inside the rect's bounds.
__device__ __forceinline__ bool rect_hit(const Ray& r, const float* p,
                                         float lo, float hi, float* t_out) {
  const float d2 = r.dx * p[6] + r.dy * p[7] + r.dz * p[8];
  if (d2 == 0.0f) return false;
  const float o2 = r.ox * p[6] + r.oy * p[7] + r.oz * p[8];
  const float t = (p[13] - o2) / d2;
  if (!(t >= lo && t <= hi)) return false;
  const float a = (r.ox * p[0] + r.oy * p[1] + r.oz * p[2]) +
                  t * (r.dx * p[0] + r.dy * p[1] + r.dz * p[2]);
  const float b = (r.ox * p[3] + r.oy * p[4] + r.oz * p[5]) +
                  t * (r.dx * p[3] + r.dy * p[4] + r.dz * p[5]);
  *t_out = t;
  return a >= p[9] && a <= p[10] && b >= p[11] && b <= p[12];
}

template <bool kSphTf, bool kRectTf, bool kSphMotion>
__global__ void __launch_bounds__(kThreads) phase_a_kernel(
    const float* __restrict__ sph, int n_sph,
    const float* __restrict__ rect, int n_rect,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ t_ray, int n, float t_min, float t_max,
    float* __restrict__ t_out, int* __restrict__ kind_out,
    int* __restrict__ idx_out) {
  static_assert(!(kSphTf && kSphMotion), "moving spheres are never transformed");
  constexpr int kSph =
      kSphereCols + (kSphTf ? kTfCols : 0) + (kSphMotion ? kMotionCols : 0);
  constexpr int kRect = kRectCols + (kRectTf ? kTfCols : 0);
  extern __shared__ float tables[];
  float* s_sph = tables;
  float* s_rect = tables + kSph * n_sph;
  for (int i = threadIdx.x; i < kSph * n_sph; i += blockDim.x) {
    s_sph[i] = sph[i];
  }
  for (int i = threadIdx.x; i < kRect * n_rect; i += blockDim.x) {
    s_rect[i] = rect[i];
  }
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const Ray w = {ro[3 * r], ro[3 * r + 1], ro[3 * r + 2],
                 rd[3 * r], rd[3 * r + 1], rd[3 * r + 2]};
  const float tr = kSphMotion ? t_ray[r] : 0.0f;

  float best_t = CUDART_INF_F;
  int best_kind = -1;
  int best_idx = 0;
  float t;

  for (int s = 0; s < n_sph; ++s) {
    const float* c = s_sph + kSph * s;
    if (kSphTf) {
      Ray o;
      const float nrm = object_ray(w, c + kSphereCols, &o);
      if (sphere_hit(o, c, t_min * nrm, t_max * nrm, &t)) {
        t = t / nrm;
        if (t < best_t) {
          best_t = t;
          best_kind = kKindSphere;
          best_idx = s;
        }
      }
    } else {
      float moved[4];
      if (kSphMotion) {
        moved[0] = c[0] + tr * c[4];
        moved[1] = c[1] + tr * c[5];
        moved[2] = c[2] + tr * c[6];
        moved[3] = c[3];
      }
      if (sphere_hit(w, kSphMotion ? moved : c, t_min, fminf(best_t, t_max), &t) &&
          t < best_t) {
        best_t = t;
        best_kind = kKindSphere;
        best_idx = s;
      }
    }
  }

  for (int q = 0; q < n_rect; ++q) {
    const float* p = s_rect + kRect * q;
    if (kRectTf) {
      Ray o;
      const float nrm = object_ray(w, p + kRectCols, &o);
      if (rect_hit(o, p, t_min * nrm, t_max * nrm, &t)) {
        t = t / nrm;
        if (t < best_t) {
          best_t = t;
          best_kind = kKindRect;
          best_idx = q;
        }
      }
    } else if (rect_hit(w, p, t_min, fminf(best_t, t_max), &t) && t < best_t) {
      best_t = t;
      best_kind = kKindRect;
      best_idx = q;
    }
  }

  t_out[r] = best_t;
  kind_out[r] = best_kind;
  idx_out[r] = best_idx;
}

template <bool kSphTf, bool kRectTf, bool kSphMotion>
int launch(const float* sph, int n_sph, const float* rect, int n_rect,
           const float* ro, const float* rd, const float* t_ray, int n,
           float t_min, float t_max, float* t_out, int* kind_out, int* idx_out,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) *
      ((kSphereCols + (kSphTf ? kTfCols : 0) + (kSphMotion ? kMotionCols : 0)) *
           static_cast<size_t>(n_sph) +
       (kRectCols + (kRectTf ? kTfCols : 0)) * static_cast<size_t>(n_rect));
  const int blocks = (n + kThreads - 1) / kThreads;
  phase_a_kernel<kSphTf, kRectTf, kSphMotion><<<blocks, kThreads, smem, stream>>>(
      sph, n_sph, rect, n_rect, ro, rd, t_ray, n, t_min, t_max, t_out, kind_out,
      idx_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K1 (no flag set), a K3 variant (sph_tf or rect_tf) or a K4
// variant (sph_motion, with rect_tf or not; t_ray then holds the n rays'
// shutter times) on ``stream`` and returns cudaGetLastError() (0 =
// launched).  sph_tf and sph_motion exclude each other.
extern "C" int phase_a_launch(const float* sph, int n_sph, int sph_tf,
                              int sph_motion, const float* rect, int n_rect,
                              int rect_tf, const float* ro, const float* rd,
                              const float* t_ray, int n, float t_min,
                              float t_max, float* t_out, int* kind_out,
                              int* idx_out, cudaStream_t stream) {
  if (sph_tf && sph_motion) return static_cast<int>(cudaErrorInvalidValue);
#define PHASE_A(TF, RTF, MO)                                                 \
  return launch<TF, RTF, MO>(sph, n_sph, rect, n_rect, ro, rd, t_ray, n,    \
                             t_min, t_max, t_out, kind_out, idx_out, stream)
  if (sph_motion) {
    if (rect_tf) PHASE_A(false, true, true);
    PHASE_A(false, false, true);
  }
  if (sph_tf && rect_tf) PHASE_A(true, true, false);
  if (sph_tf) PHASE_A(true, false, false);
  if (rect_tf) PHASE_A(false, true, false);
  PHASE_A(false, false, false);
#undef PHASE_A
}
