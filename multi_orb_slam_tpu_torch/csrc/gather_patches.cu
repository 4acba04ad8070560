// Per-keypoint patch gather from the pyramid canvas.
//
// Replaces: multi_orb_slam_tpu/ops/pallas_kernels.py `gather_patches_pallas`
// / `_gather_patches_kernel` (aligned HBM->VMEM DMA windows plus dynamic
// rolls, because Mosaic only slices (8, 128)-aligned windows).  The GPU
// has no such alignment rule: each block reads its own (image, y0, x0) and
// copies the side x side patch directly.
//
// out[n, i, j] = canvas[b_n, y0_n + i, x0_n + j].  Callers pass pre-clipped
// starts; b, y0 and x0 are clamped into [0, B-1], [0, H-side], [0, W-side]
// all the same, so no read leaves the canvas.
//
// Bound on the H100: memory latency.  There is no arithmetic; 2 x 1024
// patches of 45 x 45 floats are 16.6 MB read and written per frame.  The
// reads come from the 4 MB-per-camera canvas, which sits in the 50 MB L2,
// so the limit is the number of loads in flight: one block per patch and
// 256 threads walking the patch row-major keep each warp's loads on
// consecutive addresses of a row.  The copy is bit-exact.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_patches_kernel(const float* __restrict__ canvas,
                                      const int* __restrict__ idx,
                                      float* __restrict__ out, int B, int H,
                                      int W, int side) {
  const int n = blockIdx.x;
  const int b = min(max(idx[3 * n + 0], 0), B - 1);
  const int y0 = min(max(idx[3 * n + 1], 0), H - side);
  const int x0 = min(max(idx[3 * n + 2], 0), W - side);
  const float* src = canvas + static_cast<size_t>(b) * H * W +
                     static_cast<size_t>(y0) * W + x0;
  float* dst = out + static_cast<size_t>(n) * side * side;
  const int total = side * side;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i / side;
    const int c = i - r * side;
    dst[i] = src[static_cast<size_t>(r) * W + c];
  }
}

}  // namespace

extern "C" int gather_patches_launch(const float* canvas, const int* idx,
                                     float* out, int N, int B, int H, int W,
                                     int side, void* stream) {
  if (N < 1 || B < 1 || side < 1 || side > H || side > W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gather_patches_kernel<<<N, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      canvas, idx, out, B, H, W, side);
  return static_cast<int>(cudaGetLastError());
}
