// Row-wise gather through an inverse observation map, and its sum over rows.
//
// Replaces: multi_orb_slam_tpu/ops/pallas_kernels.py `point_sums_pallas` /
// `_point_sums_kernel`, which built a one-hot [point tile, F] selection in
// fast memory and contracted it with the row's value matrix on the matrix
// unit, because that was the only fast gather there (values padded to 32
// lanes, points to 1024-wide tiles).  On the GPU the gather is an indexed
// load, so none of that layout is carried over.
//
//   gathered[r, p, d] = inv[r, p] >= 0 ? V[r, min(inv[r, p], F-1), d] : 0
//   summed[p, d]      = sum over r = 0 .. LC-1 of gathered[r, p, d]
//
// One thread per (p, d) walks the rows in ascending order, writes
// `gathered` as it goes and keeps the running sum in a register, so the
// float32 adds happen in one fixed order (no atomics) and the result is
// the same bits on every launch.
//
// Bound on the H100: bytes.  There is one add per gathered value; at the
// local-BA shapes (LC = 48..128, F = 1024, P = 2048, D = 4) the call moves
// about 3 to 8 MB, well under 3 us of memory time, so a launch's fixed
// cost dominates.  Consecutive threads hold consecutive (p, d): the reads
// of inv[r, p] are coalesced over p (the D threads of one point share one
// load), the writes of gathered[r] are fully coalesced, and the reads of V
// are scattered by nature but contiguous over d and served from L2.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void point_sums_kernel(const float* __restrict__ V,
                                  const int* __restrict__ inv,
                                  float* __restrict__ summed,
                                  float* __restrict__ gathered, int LC, int F,
                                  int P, int D) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long PD = static_cast<long long>(P) * D;
  if (t >= PD) return;
  const int p = static_cast<int>(t / D);
  const int d = static_cast<int>(t - static_cast<long long>(p) * D);
  float acc = 0.0f;
  for (int r = 0; r < LC; ++r) {
    const int f = inv[static_cast<long long>(r) * P + p];
    float v = 0.0f;
    if (f >= 0) {
      v = V[(static_cast<long long>(r) * F + min(f, F - 1)) * D + d];
    }
    gathered[static_cast<long long>(r) * PD + t] = v;
    acc += v;
  }
  summed[t] = acc;
}

}  // namespace

extern "C" int point_sums_launch(const float* V, const int* inv, float* summed,
                                 float* gathered, int LC, int F, int P, int D,
                                 void* stream) {
  if (LC < 1 || F < 1 || P < 1 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long PD = static_cast<long long>(P) * D;
  const int blocks = static_cast<int>((PD + kThreads - 1) / kThreads);
  point_sums_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      V, inv, summed, gathered, LC, F, P, D);
  return static_cast<int>(cudaGetLastError());
}
