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
// sphere and ~36 per rect, plus ~45 (a square root and three divisions)
// for each distinct transform a ray meets.  At a 65,536-ray tile the bytes
// bound it, but what holds a kernel this short back is issue latency: a
// dependent chain of divisions and square roots per thread, unfused
// (-fmad=false), at 15 warps per SM for 65,536 one-thread rays.
//
// Tables (ops/cuda_intersect.py, models/scene.py:PhaseATables): rows are
// a table's base columns (spheres [cx cy cz r], moving spheres [cx cy cz r
// vx vy vz], rects [ua ub uk a0 a1 b0 b1 k]) followed by two int32 words
// stored as float bits, the row's transform slot and its row in the
// scene's own table.  A transformed table is ordered by slot and ``slots``
// holds each distinct [inv(9) inv_t(3)] once.
//
// Design:
//  - One object ray per ray and distinct slot: a lane keeps the last
//    slot's object ray in registers and recomputes it only when the slot
//    changes.  It is the same arithmetic on the same inputs as one object
//    ray per row, so the same bits.
//  - The winner is the least (t, kind, row): spheres before rects on equal
//    t, then the lower row, in any visiting order.  That is the plain
//    version's rule (argmin within a kind, a later kind only with a
//    strictly smaller t), so rows grouped by slot give the same winner.
//    An untransformed table keeps its row order, so there a lane's strict
//    < on t gives the same and reads no row words.
//  - kLanes lanes per ray, each taking a contiguous share of the rows,
//    then a shuffle reduction on (t, kind, row).  K3 takes two lanes, K1
//    and K4 one: the counts that measured fastest (PERF.md, section 6).
//  - A table that fits in the shared memory a block may opt in to (227 KB
//    on an H100; above the default 48 KB the launch opts in, once per
//    instance and device) is staged once.  A larger one streams through
//    in chunks (kChunked), and every thread of a block joins every chunk's
//    loads and barriers.  Each thread loads its ray before the first
//    staging, so the two loads overlap.
//  - Built with -fmad=false, so every product and sum rounds as PyTorch's
//    unfused elementwise ops do and t compares bit for bit with the plain
//    version.
//
// A transformed row follows the plain version's object-space grid, not
// the TPU kernel's running window: ro_o = inv ro + inv_t and d = inv rd
// (((m0 x + m1 y) + m2 z) per row), nrm = |d|, rd_o = d / max(nrm, 1e-30);
// roots are bounded by [t_min nrm, t_max nrm] and the world t = t_obj / nrm
// then competes.  Bounding object-space roots by best_t nrm instead, as
// the TPU kernel does, can round to another winner.  An untransformed
// table narrows its window to the lane's best t, which only drops rows
// that could not win.
//
// K4 computes each centre as c[j] + t_ray v[j] (the product, then the sum,
// as the plain version does) and tests the sphere there.  Moving and
// transformed spheres never share a table (the compiler refuses it), so
// kSphMotion excludes kSphTf; the rect table may still be transformed.

#include <atomic>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
// lanes per ray of each table kind (PERF.md, section 6)
constexpr int kPlainLanes = 1;   // K1
constexpr int kTfLanes = 2;      // K3
constexpr int kMotionLanes = 1;  // K4
constexpr int kSphereCols = 4;
constexpr int kRectCols = 14;
constexpr int kTfCols = 12;
constexpr int kMotionCols = 3;
constexpr int kMetaCols = 2;
constexpr int kKindSphere = 0;
constexpr int kKindRect = 2;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

struct Best {
  float t;
  int kind;
  int idx;
};

struct Args {
  const float* sph;
  int n_sph;
  const float* rect;
  int n_rect;
  const float* slots;
  const float* ro;
  const float* rd;
  const float* t_ray;
  int n;
  float t_min;
  float t_max;
  float* t_out;
  int* kind_out;
  int* idx_out;
};

// Whether (t, kind, idx) comes before ``b`` in the winner order.
__device__ __forceinline__ bool before(float t, int kind, int idx, const Best& b) {
  return t < b.t || (t == b.t && (kind < b.kind || (kind == b.kind && idx < b.idx)));
}

// The ray in the object space of the slot whose [inv(9) inv_t(3)] start
// at ``slot``; returns nrm = |inv rd|, world t = object t / nrm.
__device__ __forceinline__ float object_ray(const Ray& w, const float* slot, Ray* o) {
  float m[kTfCols];
#pragma unroll
  for (int i = 0; i < kTfCols; ++i) m[i] = __ldg(slot + i);
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
__device__ __forceinline__ bool sphere_hit(const Ray& r, const float* c, float lo, float hi,
                                           float* t) {
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

// Rect plane hit of ``r`` in [lo, hi] inside the rect's bounds.  With
// kWorld the ray is in a slot's object space: *t_out is then the world t =
// t / nrm, and a plane hit whose world t is past ``best`` (which cannot
// win) skips the bounds; without it ``nrm`` and ``best`` are not read.
template <bool kWorld>
__device__ __forceinline__ bool rect_hit(const Ray& r, const float* p, float lo, float hi,
                                         float nrm, float best, float* t_out) {
  const float d2 = r.dx * p[6] + r.dy * p[7] + r.dz * p[8];
  if (d2 == 0.0f) return false;
  const float o2 = r.ox * p[6] + r.oy * p[7] + r.oz * p[8];
  const float t = (p[13] - o2) / d2;
  if (!(t >= lo && t <= hi)) return false;
  if (kWorld) {
    *t_out = t / nrm;
    if (*t_out > best) return false;
  }
  const float a = (r.ox * p[0] + r.oy * p[1] + r.oz * p[2]) +
                  t * (r.dx * p[0] + r.dy * p[1] + r.dz * p[2]);
  const float b = (r.ox * p[3] + r.oy * p[4] + r.oz * p[5]) +
                  t * (r.dx * p[3] + r.dy * p[4] + r.dz * p[5]);
  if (!kWorld) *t_out = t;
  return a >= p[9] && a <= p[10] && b >= p[11] && b <= p[12];
}

// One lane's state: its best hit and the object ray of the last slot it
// met (slot -1: none yet).
struct Lane {
  Best best;
  int slot;
  Ray o;
  float nrm;

  __device__ __forceinline__ void object(const Ray& w, const float* slots, int s) {
    if (s != slot) {
      slot = s;
      nrm = object_ray(w, slots + kTfCols * s, &o);
    }
  }
};

// The lane's share [lo, hi) of ``count`` staged rows.
template <int kLanes>
__device__ __forceinline__ void share(int count, int lane, int* lo, int* hi) {
  *lo = count * lane / kLanes;
  *hi = count * (lane + 1) / kLanes;
}

// The staged rows [0, count) of a sphere table, its row ``first`` and on.
// A transformed table is in slot order and takes the full winner order; an
// untransformed one is in row order, after no rect, so strict < on t does.
template <bool kTf, bool kMotion, int kLanes>
__device__ __forceinline__ void sweep_spheres(const float* rows, int first, int count, int lane,
                                              const Ray& w, float tr, const Args& a,
                                              Lane* s) {
  constexpr int kW = (kMotion ? kSphereCols + kMotionCols : kSphereCols) + kMetaCols;
  int lo, hi;
  share<kLanes>(count, lane, &lo, &hi);
  float t;
  for (int j = lo; j < hi; ++j) {
    const float* c = rows + kW * j;
    if (kTf) {
      const int row = __float_as_int(c[kW - 1]);
      s->object(w, a.slots, __float_as_int(c[kW - 2]));
      if (sphere_hit(s->o, c, a.t_min * s->nrm, a.t_max * s->nrm, &t)) {
        t = t / s->nrm;
        if (before(t, kKindSphere, row, s->best)) s->best = {t, kKindSphere, row};
      }
    } else {
      float moved[4];
      if (kMotion) {
        moved[0] = c[0] + tr * c[4];
        moved[1] = c[1] + tr * c[5];
        moved[2] = c[2] + tr * c[6];
        moved[3] = c[3];
      }
      if (sphere_hit(w, kMotion ? moved : c, a.t_min, fminf(s->best.t, a.t_max), &t) &&
          t < s->best.t) {
        s->best = {t, kKindSphere, first + j};
      }
    }
  }
}

// As sweep_spheres, for rects; an untransformed table comes after every
// sphere, so strict < on t keeps a sphere on a tie.
template <bool kTf, int kLanes>
__device__ __forceinline__ void sweep_rects(const float* rows, int first, int count, int lane,
                                            const Ray& w, const Args& a, Lane* s) {
  constexpr int kW = kRectCols + kMetaCols;
  int lo, hi;
  share<kLanes>(count, lane, &lo, &hi);
  float t;
  for (int j = lo; j < hi; ++j) {
    const float* p = rows + kW * j;
    if (kTf) {
      const int row = __float_as_int(p[kW - 1]);
      s->object(w, a.slots, __float_as_int(p[kW - 2]));
      if (rect_hit<true>(s->o, p, a.t_min * s->nrm, a.t_max * s->nrm, s->nrm, s->best.t,
                         &t) &&
          before(t, kKindRect, row, s->best)) {
        s->best = {t, kKindRect, row};
      }
    } else if (rect_hit<false>(w, p, a.t_min, fminf(s->best.t, a.t_max), 1.0f, 0.0f, &t) &&
               t < s->best.t) {
      s->best = {t, kKindRect, first + j};
    }
  }
}

// ``table_floats`` floats of dynamic shared memory hold the staged rows:
// the whole table, or with kChunked as many rows as fit at a time.
template <bool kSphTf, bool kRectTf, bool kSphMotion, int kLanes, bool kChunked>
__global__ void __launch_bounds__(kThreads) phase_a_kernel(const Args a, int table_floats) {
  static_assert(!(kSphTf && kSphMotion), "moving spheres are never transformed");
  constexpr int kSph = (kSphMotion ? kSphereCols + kMotionCols : kSphereCols) + kMetaCols;
  constexpr int kRect = kRectCols + kMetaCols;
  extern __shared__ float smem[];
  const int r = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const bool valid = r < a.n;

  Lane s;
  s.best = {CUDART_INF_F, -1, 0};
  s.slot = -1;
  s.nrm = 1.0f;
  Ray w = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float tr = 0.0f;
  if (valid) {
    const size_t k = 3 * static_cast<size_t>(r);
    w = {__ldg(a.ro + k), __ldg(a.ro + k + 1), __ldg(a.ro + k + 2),
         __ldg(a.rd + k), __ldg(a.rd + k + 1), __ldg(a.rd + k + 2)};
    if (kSphMotion) tr = __ldg(a.t_ray + r);
  }
  // stage the spheres, then the rects, as many rows as fit at a time
  int s0 = 0, q0 = 0;
  do {
    const int s1 = kChunked ? min(a.n_sph, s0 + table_floats / kSph) : a.n_sph;
    const int q1 = !kChunked ? a.n_rect
                 : s1 < a.n_sph ? q0
                                : min(a.n_rect, q0 + (table_floats - (s1 - s0) * kSph) / kRect);
    if (kChunked && s0 + q0 > 0) __syncthreads();  // every lane is done with the last chunk
    const float* sph = a.sph + kSph * static_cast<size_t>(s0);
    for (int i = threadIdx.x; i < (s1 - s0) * kSph; i += kThreads) smem[i] = __ldg(sph + i);
    float* s_rect = smem + (s1 - s0) * kSph;
    const float* rect = a.rect + kRect * static_cast<size_t>(q0);
    for (int i = threadIdx.x; i < (q1 - q0) * kRect; i += kThreads) s_rect[i] = __ldg(rect + i);
    __syncthreads();
    if (valid) {
      sweep_spheres<kSphTf, kSphMotion, kLanes>(smem, s0, s1 - s0, lane, w, tr, a, &s);
      sweep_rects<kRectTf, kLanes>(s_rect, q0, q1 - q0, lane, w, a, &s);
    }
    s0 = s1;
    q0 = q1;
  } while (kChunked && (s0 < a.n_sph || q0 < a.n_rect));

#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, s.best.t, off);
    const int ok = __shfl_xor_sync(0xffffffffu, s.best.kind, off);
    const int oi = __shfl_xor_sync(0xffffffffu, s.best.idx, off);
    if (before(ot, ok, oi, s.best)) s.best = {ot, ok, oi};
  }
  if (valid && lane == 0) {
    a.t_out[r] = s.best.t;
    a.kind_out[r] = s.best.kind;
    a.idx_out[r] = s.best.idx;
  }
}

// The shared memory a block may opt in to on ``dev`` (cached per device).
int opt_in_limit(int dev, int* bytes) {
  static std::atomic<int> limits[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int v = limits[dev].load();
  if (v == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    limits[dev].store(v);
  }
  *bytes = v;
  return 0;
}

// Opts ``kernel`` in to ``bytes`` of dynamic shared memory above the
// default, once per device.
template <typename Kernel>
int opt_in(Kernel kernel, int dev, int bytes, std::atomic<unsigned long long>* opted) {
  if ((opted->load() >> dev) & 1ull) return 0;
  const int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (err == 0) opted->fetch_or(1ull << dev);
  return err;
}

template <bool kSphTf, bool kRectTf, bool kSphMotion, int kLanes>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int kSph = (kSphMotion ? kSphereCols + kMotionCols : kSphereCols) + kMetaCols;
  constexpr int kRect = kRectCols + kMetaCols;
  int dev = 0, limit = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0) err = opt_in_limit(dev, &limit);
  if (err != 0) return err;
  const long long want = static_cast<long long>(a.n_sph) * kSph +
                         static_cast<long long>(a.n_rect) * kRect;
  const long long cap = limit / 4;
  const int table_floats = static_cast<int>(want < cap ? want : cap);
  const size_t smem = 4 * static_cast<size_t>(table_floats);
  const int blocks = (a.n + kThreads / kLanes - 1) / (kThreads / kLanes);
  if (want <= cap) {
    auto kernel = phase_a_kernel<kSphTf, kRectTf, kSphMotion, kLanes, false>;
    static std::atomic<unsigned long long> opted{0};
    if (smem > kDefaultSmem && (err = opt_in(kernel, dev, limit, &opted)) != 0) return err;
    kernel<<<blocks, kThreads, smem, stream>>>(a, table_floats);
  } else {
    auto kernel = phase_a_kernel<kSphTf, kRectTf, kSphMotion, kLanes, true>;
    static std::atomic<unsigned long long> opted{0};
    if ((err = opt_in(kernel, dev, limit, &opted)) != 0) return err;
    kernel<<<blocks, kThreads, smem, stream>>>(a, table_floats);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K1 (no flag set), a K3 variant (sph_tf or rect_tf) or a K4
// variant (sph_motion, with rect_tf or not; t_ray then holds the n rays'
// shutter times) on ``stream`` and returns the CUDA error (0 = launched).
// sph and rect are PhaseATables rows, slots its (X, 12) transforms.
extern "C" int phase_a_launch(const float* sph, int n_sph, const float* rect, int n_rect,
                              const float* slots, int sph_tf, int rect_tf, int sph_motion,
                              const float* ro, const float* rd, const float* t_ray, int n,
                              float t_min, float t_max, float* t_out, int* kind_out,
                              int* idx_out, cudaStream_t stream) {
  const Args a = {sph, n_sph, rect, n_rect, slots, ro, rd, t_ray, n, t_min, t_max, t_out,
                  kind_out, idx_out};
  if (sph_tf && sph_motion) return static_cast<int>(cudaErrorInvalidValue);
  if (sph_motion) {
    if (rect_tf) return launch<false, true, true, kMotionLanes>(a, stream);
    return launch<false, false, true, kMotionLanes>(a, stream);
  }
  if (sph_tf && rect_tf) return launch<true, true, false, kTfLanes>(a, stream);
  if (sph_tf) return launch<true, false, false, kTfLanes>(a, stream);
  if (rect_tf) return launch<false, true, false, kTfLanes>(a, stream);
  return launch<false, false, false, kPlainLanes>(a, stream);
}
