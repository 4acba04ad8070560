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
// Bound on the H100: bytes (one add per gathered value; 3 to 8 MB at the
// local-BA shapes LC = 48..128, F = 1024, P = 2048, D = 4, under 3 us of
// memory time).  What a kernel pays here is latency: every value sits behind
// a dependent pair of loads (inv[r, p], then V[r, inv, :]), so the design
// keeps as many of those pairs in flight at once as the shape has, and
// still adds the rows in one fixed order.
//
// D = 4 with 16-byte aligned V and gathered (the local-BA re-layout):
// a block owns a tile of 8 points and walks the rows in chunks of 128.  Its
// 256 threads are 32 rows x 8 points; a thread starts the index loads of
// its 4 rows of the chunk together, then the 4 value loads as one float4
// each, stores them to `gathered` as float4 and stages them in shared memory
// (16 KB a chunk).  After a barrier the first 32 threads, one per (point,
// d), add the chunk's rows in ascending order into a register that they
// carry across chunks.  At P = 2048 that is 256 blocks of 8 warps with
// every (row, point) pair of a chunk in flight.
//
// Any other D, or unaligned pointers: one thread per (point, d) column
// walks the rows in ascending order.  At the wide shape that path was built
// for (D = 30, P = 4096: 122,880 threads, 30.8 MB) the threads themselves
// hide the latency and the bytes bind: 1.3x their bound.  Batches of 8
// independent row loads a thread were tried there and were 34% slower.
//
// Both add float32 values one row at a time from row 0 upward with no
// atomics, so `summed` is bit-equal to the plain version and the same bits
// on every launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTilePoints = 8;     // points a block owns (vector path)
constexpr int kRowLanes = 32;      // rows a block loads side by side
constexpr int kRowsPerThread = 4;  // independent row loads a thread has in flight
constexpr int kChunkRows = kRowLanes * kRowsPerThread;  // 128
constexpr int kVecThreads = kTilePoints * kRowLanes;    // 256
constexpr int kScalarThreads = 256;

__global__ void __launch_bounds__(kVecThreads)
point_sums_kernel_vec4(const float4* __restrict__ V, const int* __restrict__ inv,
                       float* __restrict__ summed, float4* __restrict__ gathered,
                       int LC, int F, int P) {
  __shared__ float4 stage[kChunkRows][kTilePoints];
  const int pl = threadIdx.x % kTilePoints;
  const int rl = threadIdx.x / kTilePoints;
  const int p = blockIdx.x * kTilePoints + pl;
  const bool live = p < P;
  // the summing threads: thread t < 32 owns value t % 4 of point t / 4
  const int sum_p = blockIdx.x * kTilePoints + threadIdx.x / 4;
  float acc = 0.0f;
  for (int r0 = 0; r0 < LC; r0 += kChunkRows) {
    int f[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = r0 + rl + i * kRowLanes;
      f[i] = (live && r < LC) ? inv[static_cast<long long>(r) * P + p] : -1;
    }
    float4 v[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = r0 + rl + i * kRowLanes;
      v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (f[i] >= 0) {
        v[i] = V[static_cast<long long>(r) * F + min(f[i], F - 1)];
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = r0 + rl + i * kRowLanes;
      stage[rl + i * kRowLanes][pl] = v[i];
      if (live && r < LC) {
        gathered[static_cast<long long>(r) * P + p] = v[i];
      }
    }
    __syncthreads();
    if (threadIdx.x < kTilePoints * 4) {
      const float* flat = reinterpret_cast<const float*>(&stage[0][0]);
      const int rows = min(kChunkRows, LC - r0);
      for (int r = 0; r < rows; ++r) {
        acc += flat[r * (kTilePoints * 4) + threadIdx.x];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < kTilePoints * 4 && sum_p < P) {
    summed[static_cast<long long>(blockIdx.x) * (kTilePoints * 4) + threadIdx.x] = acc;
  }
}

__global__ void point_sums_kernel_scalar(const float* __restrict__ V,
                                         const int* __restrict__ inv,
                                         float* __restrict__ summed,
                                         float* __restrict__ gathered, int LC,
                                         int F, int P, int D) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kScalarThreads + threadIdx.x;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(V) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(gathered) % 16 == 0;
  if (D == 4 && aligned) {
    const int blocks = (P + kTilePoints - 1) / kTilePoints;
    point_sums_kernel_vec4<<<blocks, kVecThreads, 0, s>>>(
        reinterpret_cast<const float4*>(V), inv, summed,
        reinterpret_cast<float4*>(gathered), LC, F, P);
  } else {
    const long long PD = static_cast<long long>(P) * D;
    const int blocks = static_cast<int>((PD + kScalarThreads - 1) / kScalarThreads);
    point_sums_kernel_scalar<<<blocks, kScalarThreads, 0, s>>>(
        V, inv, summed, gathered, LC, F, P, D);
  }
  return static_cast<int>(cudaGetLastError());
}
