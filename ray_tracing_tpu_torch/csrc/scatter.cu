// K2: the masked scatter-add of per-row texel-gradient contributions into
// the atlas-gradient table, g[texel[r], c] += contrib[r, c] for every row r
// whose mask is set and whose texel lies in [0, P).  Duplicate texels sum.
//
// Replaces ray_tracing_tpu/ops/pallas_scatter.py:_kernel.  The plain
// PyTorch version of the same function is scatter_add_plain in
// ray_tracing_tpu_torch/ops/cuda_scatter.py.
//
// What bounds it on an H100: the table is texel-major (P, 3) float32; for
// the zy atlas (P = 524,288 texels) that is 6.3 MB, which stays resident
// in the 50 MB L2, so each live row costs three atomicAdds that resolve in
// L2, and the kernel is bound by L2 atomic throughput on live rows.  A dead
// row costs its mask byte and nothing else (reading the (N,) mask column
// is the bound when few rows are live, as in most sweep stages).
//
// Design: one thread per row, contributions contiguous (N, 3) float32 with
// the ragged tail masked (no padding to the TPU kernel's 1024-row chunks).
// A dead row returns at once: the counterpart of the TPU kernel's block
// skip.  The TPU kernel adds in a fixed serial order; atomics add in
// whatever order the rows arrive, so the last bits of a texel that several
// rows hit vary from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) scatter_add_kernel(
    float* __restrict__ g, long long p, const int* __restrict__ texel,
    const float* __restrict__ contrib, const bool* __restrict__ mask,
    long long n) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n || !mask[r]) return;
  const int t = texel[r];
  if (t < 0 || t >= p) return;
  float* dst = g + 3 * static_cast<long long>(t);
  atomicAdd(dst, contrib[3 * r]);
  atomicAdd(dst + 1, contrib[3 * r + 1]);
  atomicAdd(dst + 2, contrib[3 * r + 2]);
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() (0 = launched).
extern "C" int scatter_add_launch(float* g, long long p, const int* texel,
                                  const float* contrib, const bool* mask,
                                  long long n, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  scatter_add_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      g, p, texel, contrib, mask, n);
  return static_cast<int>(cudaGetLastError());
}
