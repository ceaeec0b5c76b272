// Beam-search KV-cache reorder for Hopper (sm_90a): a row gather of the
// live positions, as a byte copy.
//
// Replaces the Pallas TPU kernels K2a and K2b of
// speech_anonymization_tpu/ops/pallas/beam_gather.py: `_dma_kernel`
// (launched by `_gather_rows_dma`, which copies positions <= step in
// 8-position DMA chunks) and `_copy_kernel` (launched by
// `_gather_rows_vmem`, which copies whole rows). Both compute
//
//     out[l, n, p, :] = a[l, src[n], p, :]     for p <= step
//
// on an (L, N, U, M) cache; K2b is the case step = U - 1. Positions after
// `step` of `out` are left as they were (undefined to the caller: decode
// steps mask them and overwrite position step + 1 before reading it).
//
// Bound: the copy reads and writes L * N * (step + 1) * M * itemsize bytes
// each, so it is bound by device-memory bandwidth (3.35 TB/s on an H100
// SXM) and does no arithmetic. At the decode shape D1 (L 6, N 528, M 768,
// f32) that is 19.5 MB * (step + 1) per launch.
//
// Design: because U comes before M in the layout, the live part of one
// (l, n) row is ONE contiguous span of (step + 1) * M * itemsize bytes, so
// the TPU kernel's 8-position chunking has no counterpart here. Block
// (row, y) copies the y-th 16 KB piece of row `row`'s span: 256 threads,
// each moving 4 independent 16-byte vectors (all loads issued before the
// stores), neighbouring threads on neighbouring addresses. The source row
// index is read by the block itself (the TPU kernel's scalar prefetch).
// It is a byte copy: exact for any element type. Limits checked by the
// Python wrapper: M * itemsize and both base pointers 16-byte aligned,
// `out` not overlapping `a`. A source index outside [0, N) cannot be
// checked on the host without a synchronise: the kernel leaves that row
// unwritten and adds one per (layer, row) to the device counter `faults`,
// which the wrapper reads on request (the plain twin raises instead).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kVecPerBlock = static_cast<long long>(kThreads) * kUnroll;  // 16 KB

__global__ void __launch_bounds__(kThreads)
beam_gather_kernel(const int4* __restrict__ a, int4* __restrict__ out, const int* __restrict__ src,
                   int n, long long row_vec, long long span_vec, int* faults) {
  const int row = blockIdx.x;  // l * n + destination row
  const int l = row / n;
  const int s = __ldg(src + row % n);
  if (s < 0 || s >= n) {  // out-of-range parent: counted, the row left unwritten
    if (threadIdx.x == 0 && blockIdx.y == 0) atomicAdd(faults, 1);
    return;
  }
  const int4* from = a + (static_cast<long long>(l) * n + s) * row_vec;
  int4* to = out + static_cast<long long>(row) * row_vec;
  const long long base = static_cast<long long>(blockIdx.y) * kVecPerBlock + threadIdx.x;
  int4 v[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = base + j * kThreads;
    if (i < span_vec) v[j] = __ldg(from + i);
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = base + j * kThreads;
    if (i < span_vec) to[i] = v[j];
  }
}

}  // namespace

extern "C" {

// a, out: (layers, n, U, M) caches of any element type, contiguous, 16-byte
// aligned; src: (n,) int32 source rows; faults: one int32 on the device,
// incremented once per (layer, row) whose source is out of range. Copies
// the first `span_bytes` of every (layer, row) slice of `row_bytes` bytes.
// Both byte counts must be multiples of 16. Launches on `stream` and
// returns cudaGetLastError() (0 on success). Does not synchronise.
int sa_beam_gather(const void* a, void* out, const void* src, int layers, int n,
                   long long row_bytes, long long span_bytes, void* faults, int device,
                   void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long span_vec = span_bytes / 16;
  const long long pieces = (span_vec + kVecPerBlock - 1) / kVecPerBlock;
  if (layers > 0 && n > 0 && pieces > 0) {
    const dim3 grid(static_cast<unsigned>(layers * n), static_cast<unsigned>(pieces));
    beam_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(a), static_cast<int4*>(out), static_cast<const int*>(src), n,
        row_bytes / 16, span_vec, static_cast<int*>(faults));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
