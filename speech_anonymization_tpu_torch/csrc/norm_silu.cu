// One-pass bias + InstanceNorm + SiLU for Hopper (sm_90a): K8.
//
// No TPU kernel counterpart: the JAX package leaves the ConvAutoencoder's
// block epilogue (speech_anonymization_tpu/models/autoencoders.py `_encode`,
// `_decode`: glu(instance_norm(conv(x) + b))) to XLA. The port's inference
// path (models/autoencoders.py, no autograd) runs each convolution without
// its bias and hands the output here, in place of PyTorch's four memory-bound
// passes a block (the bias add, cuDNN's batch norm over B * C channels, the
// sigmoid, the multiply):
//
//     norm:     y = silu(g[c] * (x + b[c] - mu) / sqrt(var + eps) + beta[c])
//     no norm:  y = silu(x + b[c])                        (enc_conv0)
//
// for each (item, channel) row of a (B, C, L) tensor, c the row's channel;
// mu and var are the row's mean and biased variance of x + b, summed in fp32
// in two passes (the mean, then the centred squares); silu(z) = z / (1 +
// exp(-z)) (the reference's "GLU", models/components.py `glu`).
//
// Bound: bytes. A launch reads x once and writes y once, rows * L * 8 bytes
// (and b, g, beta: 12 C). At the anonymizer's main-path shape (32 x 10.07 s,
// T = 1008 frames) every launch moves 0.661 GB, 0.197 ms at 3.35 TB/s; the
// ~12 fp32 operations an element are 0.3 operations a byte.
//
// Design (norm): a row is split over a thread-block cluster of n = ceil(L /
// chunk) blocks (n <= 8), each holding a contiguous share of <= `chunk`
// floats in shared memory, so that each element leaves device memory once.
// A share arrives by TMA bulk copies (cp.async.bulk) in kPieces pieces, each
// completing on its own mbarrier, so the mean pass sums the first pieces
// while the last are in flight; the <= 3 floats before the share's first
// 16-byte boundary and the <= 3 after its last are loaded by one thread each.
// Each block sums its share (warp shuffles, then the warps in order) and puts
// the partial in its shared memory; after a cluster barrier every block adds
// the n partials in rank order over distributed shared memory, so all blocks
// of a row hold the same mean, and the centred sum of squares follows the
// same way. The third pass computes y from shared memory and stores it in
// 16-byte stores. Blocks are not persistent: at the wrapper's chunk (27,000
// floats, 108 KB) two blocks share an SM, so one block's loads overlap the
// other's passes (rows of 20,160 floats take one block, 40,320 two, 80,640
// three). The last block of a row's cluster leaves after a cluster barrier,
// once no other block can still read its partials.
//
// Design (norm, rows longer than kMaxCluster * kMaxChunk floats, 57 s of
// audio at 80 mels): no cluster holds the row, so it is read twice. Two
// streaming launches over tiles of kStreamTile floats, each thread holding
// kStreamPer of them in registers: norm_silu_moments puts each tile's mean
// and centred sum of squares of x + b (fp32, two passes over the registers)
// in a workspace; norm_silu_apply loads its tile, merges the row's tile
// moments in a fixed order (warp 0, Chan et al.'s pairwise update in fp64),
// and writes y. Three passes over the row where the one-pass path makes two;
// the rows' results equal a one-pass launch's to rounding.
//
// Design (no norm): a streaming pass; a block takes kBiasTile floats of one
// row (its bias read once), each thread 4 x 16-byte loads, then 4 stores.
//
// Limits checked by the Python wrapper (ops/norm_silu.py): float32,
// contiguous, 16-byte aligned x and y; 4 <= chunk <= kMaxChunk, a multiple
// of 4, and ceil(L / chunk) <= kMaxCluster. Any L >= 1 (odd L too).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPieces = 8;         // bulk copies (and mbarriers) a block's share arrives in
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxChunk = 57344;   // floats: 224 KB, and the 16 bytes of alignment slack, under 227 KB
constexpr int kBiasThreads = 256;
constexpr int kBiasVecs = 4;       // 16-byte vectors a thread
constexpr int kBiasTile = kBiasThreads * kBiasVecs * 4;  // floats a block
constexpr int kMaxDevices = 64;
constexpr int kStreamPer = 16;    // floats a thread holds on the long rows' path
constexpr int kStreamTile = kThreads * kStreamPer;  // floats a block

__device__ __forceinline__ float silu(float z) { return z * __frcp_rn(1.0f + __expf(-z)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The mbarrier at shared address `bar`: init (one arrival a phase), the
// arrival that also expects `bytes` of bulk-copy data, the wait for phase 0.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// `src` to shared address `dst`, completing on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The cluster: this block's rank, its number of blocks, the barrier of all
// its threads (release, then acquire: shared-memory writes before it are
// seen by every block after it), and a float of block `rank`'s shared memory
// at the address `p` has in this block's.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_blocks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float load_remote(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// The block's total of `v`, in every thread: warp shuffles, then the warps'
// sums in warp order.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += warp_sums[w];
  __syncthreads();  // warp_sums is used again
  return t;
}

// The row's total: this block's `partial` into `slot`, then the cluster's
// partials added in rank order, the same sum in every block of the row.
__device__ __forceinline__ float cluster_sum(float partial, float* slot, int n) {
  if (threadIdx.x == 0) *slot = partial;
  cluster_sync();
  float t = 0.0f;
  for (int r = 0; r < n; ++r) t += load_remote(slot, r);
  return t;
}

// Block `rank` of a cluster of n holds floats [rank * share, rank * share +
// count) of row blockIdx.x / n.
__global__ void __launch_bounds__(kThreads, 2)
    norm_silu_rows(const float* x, float* y, const float* bias, const float* gamma,
                   const float* beta, int channels, int length, int share, float eps) {
  __shared__ __align__(8) uint64_t bars[kPieces];
  __shared__ float warp_sums[kWarps];
  __shared__ float partials[2];
  extern __shared__ __align__(16) float buf[];

  const int n = cluster_blocks();
  const int rank = cluster_rank();
  const long long row = blockIdx.x / n;
  const int c = static_cast<int>(row % channels);
  const int start = rank * share;
  const int count = min(length - start, share);
  const float* g = x + row * length + start;
  float* out = y + row * length + start;
  // s[i] holds g[i]; `lead` puts 16-byte aligned global floats on 16-byte
  // aligned shared ones (y has x's alignment, so out[i] is aligned with them)
  const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
  const int head = min(count, (4 - lead) & 3);
  const int nvec = (count - head) >> 2;
  const int tail = count - head - 4 * nvec;
  float* s = buf + lead;
  const float4* s4 = reinterpret_cast<const float4*>(s + head);
  const int per_piece = (nvec + kPieces - 1) / kPieces;

  if (threadIdx.x == 0) {
    for (int p = 0; p < kPieces; ++p) mbar_init(smem_addr(&bars[p]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int p = 0; p < kPieces && p * per_piece < nvec; ++p) {
      const int v0 = p * per_piece;
      const uint32_t bytes = 16u * static_cast<uint32_t>(min(nvec - v0, per_piece));
      mbar_expect(smem_addr(&bars[p]), bytes);
      bulk_load(smem_addr(s + head + 4 * v0), g + head + 4 * v0, bytes, smem_addr(&bars[p]));
    }
  }
  // the head and tail floats: one thread each, which keeps its float in
  // shared memory and reads it there in the later passes
  int e = -1;
  if (threadIdx.x < head) {
    e = threadIdx.x;
  } else if (threadIdx.x >= 4 && threadIdx.x < 4 + tail) {
    e = head + 4 * nvec + threadIdx.x - 4;
  }
  const float b = bias[c];
  float sum = 0.0f;
  if (e >= 0) {
    const float v = g[e];
    s[e] = v;
    sum = v + b;
  }
  // every thread reads the mbarriers, so none may wait before thread 0 has
  // initialised them
  __syncthreads();
  for (int p = 0; p < kPieces && p * per_piece < nvec; ++p) {
    const int v0 = p * per_piece, v1 = min(nvec, v0 + per_piece);
    mbar_wait0(smem_addr(&bars[p]));
    for (int v = v0 + threadIdx.x; v < v1; v += kThreads) {
      const float4 q = s4[v];
      sum += ((q.x + b) + (q.y + b)) + ((q.z + b) + (q.w + b));
    }
  }
  const float mean =
      cluster_sum(block_sum(sum, warp_sums), &partials[0], n) / static_cast<float>(length);

  float sq = 0.0f;
  if (e >= 0) {
    const float d = s[e] + b - mean;
    sq = d * d;
  }
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    const float4 q = s4[v];
    const float d0 = q.x + b - mean, d1 = q.y + b - mean, d2 = q.z + b - mean, d3 = q.w + b - mean;
    sq += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
  }
  const float var =
      cluster_sum(block_sum(sq, warp_sums), &partials[1], n) / static_cast<float>(length);
  const float scale = gamma[c] / sqrtf(var + eps);
  const float shift = beta[c];

  if (e >= 0) out[e] = silu((s[e] + b - mean) * scale + shift);
  float4* o4 = reinterpret_cast<float4*>(out + head);
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    const float4 q = s4[v];
    float4 r;
    r.x = silu((q.x + b - mean) * scale + shift);
    r.y = silu((q.y + b - mean) * scale + shift);
    r.z = silu((q.z + b - mean) * scale + shift);
    r.w = silu((q.w + b - mean) * scale + shift);
    o4[v] = r;
  }
  // no block leaves while another of its cluster may still read its partials
  cluster_sync();
}

// Block i takes floats [kBiasTile * (i % tiles), + kBiasTile) of row i / tiles.
// `vec`: L % 4 == 0, so every row is 16-byte aligned.
__global__ void __launch_bounds__(kBiasThreads)
    norm_silu_bias(const float* x, float* y, const float* bias, int channels, int length,
                   int tiles, int vec) {
  const long long row = blockIdx.x / tiles;
  const int t0 = static_cast<int>(blockIdx.x % tiles) * kBiasTile;
  const int count = min(length - t0, kBiasTile);
  const float b = bias[row % channels];
  const float* g = x + row * length + t0;
  float* out = y + row * length + t0;
  if (vec) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* o4 = reinterpret_cast<float4*>(out);
    const int nv = count >> 2;
    float4 q[kBiasVecs];
#pragma unroll
    for (int k = 0; k < kBiasVecs; ++k) {
      const int v = threadIdx.x + k * kBiasThreads;
      if (v < nv) q[k] = g4[v];
    }
#pragma unroll
    for (int k = 0; k < kBiasVecs; ++k) {
      const int v = threadIdx.x + k * kBiasThreads;
      if (v < nv) {
        float4 r;
        r.x = silu(q[k].x + b);
        r.y = silu(q[k].y + b);
        r.z = silu(q[k].z + b);
        r.w = silu(q[k].w + b);
        o4[v] = r;
      }
    }
  } else {
    for (int i = threadIdx.x; i < count; i += kBiasThreads) out[i] = silu(g[i] + b);
  }
}

// The long rows' path. Block i takes floats [kStreamTile * (i % tiles), +
// kStreamTile) of row i / tiles; element k * kThreads + threadIdx.x of the
// tile is the thread's v[k] (so a warp's loads are contiguous at any L).
__device__ __forceinline__ int load_tile(const float* g, int count, float b, float (&v)[kStreamPer]) {
  int held = 0;
#pragma unroll
  for (int k = 0; k < kStreamPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    v[k] = i < count ? g[i] + b : 0.0f;
    held += i < count;
  }
  return held;
}

// ws[i] = (the tile's mean of x + b, its centred sum of squares)
__global__ void __launch_bounds__(kThreads)
    norm_silu_moments(const float* x, const float* bias, float2* ws, int channels, int length,
                      int tiles) {
  __shared__ float warp_sums[kWarps];
  const long long row = blockIdx.x / tiles;
  const int t0 = static_cast<int>(blockIdx.x % tiles) * kStreamTile;
  const int count = min(length - t0, kStreamTile);
  float v[kStreamPer];
  const int held = load_tile(x + row * length + t0, count, bias[row % channels], v);
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kStreamPer; ++k) sum += v[k];
  const float mean = block_sum(sum, warp_sums) / static_cast<float>(count);
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < kStreamPer; ++k) {
    const float d = k < held ? v[k] - mean : 0.0f;
    sq += d * d;
  }
  const float m2 = block_sum(sq, warp_sums);
  if (threadIdx.x == 0) ws[blockIdx.x] = make_float2(mean, m2);
}

// (n, mean, m2) of a and b together (Chan, Golub and LeVeque), into a
__device__ __forceinline__ void merge(double& n, double& mean, double& m2, double nb, double meanb,
                                      double m2b) {
  const double total = n + nb;
  if (nb == 0.0) return;
  const double d = meanb - mean;
  mean += d * (nb / total);
  m2 += m2b + d * d * (n * nb / total);
  n = total;
}

__global__ void __launch_bounds__(kThreads)
    norm_silu_apply(const float* x, float* y, const float* bias, const float* gamma,
                    const float* beta, const float2* ws, int channels, int length, int tiles,
                    float eps) {
  __shared__ float stats[2];
  const long long row = blockIdx.x / tiles;
  const int c = static_cast<int>(row % channels);
  const int t0 = static_cast<int>(blockIdx.x % tiles) * kStreamTile;
  const int count = min(length - t0, kStreamTile);
  float v[kStreamPer];
  load_tile(x + row * length + t0, count, bias[c], v);
  if (threadIdx.x < 32) {
    // lane l merges tiles l, l + 32, ... in order, then the lanes down a tree
    const float2* m = ws + row * tiles;
    double n = 0.0, mean = 0.0, m2 = 0.0;
    for (int t = threadIdx.x; t < tiles; t += 32) {
      const float2 p = m[t];
      merge(n, mean, m2, static_cast<double>(min(length - t * kStreamTile, kStreamTile)), p.x, p.y);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const double nb = __shfl_down_sync(0xffffffffu, n, o);
      const double meanb = __shfl_down_sync(0xffffffffu, mean, o);
      const double m2b = __shfl_down_sync(0xffffffffu, m2, o);
      merge(n, mean, m2, nb, meanb, m2b);
    }
    if (threadIdx.x == 0) {
      const float var = static_cast<float>(m2 / n);
      stats[0] = static_cast<float>(mean);
      stats[1] = gamma[c] / sqrtf(var + eps);
    }
  }
  __syncthreads();
  const float mean = stats[0], scale = stats[1], shift = beta[c];
  float* out = y + row * length + t0;
#pragma unroll
  for (int k = 0; k < kStreamPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < count) out[i] = silu((v[k] - mean) * scale + shift);
  }
}

}  // namespace

extern "C" {

// x and y (rows, length) fp32, rows = B * C, contiguous and 16-byte aligned on
// `device`; bias, gamma, beta (channels,) fp32. gamma and beta both null: y =
// silu(x + bias); else the instance norm between, rows split over clusters of
// ceil(length / chunk) blocks. Launches on `stream` and returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for a chunk out of
// range. Does not synchronise.
int sa_norm_silu(const void* x, void* y, const void* bias, const void* gamma, const void* beta,
                 int rows, int channels, int length, int chunk, float eps, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || length <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gamma == nullptr) {
    const int tiles = (length + kBiasTile - 1) / kBiasTile;
    norm_silu_bias<<<static_cast<unsigned>(rows) * tiles, kBiasThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), static_cast<const float*>(bias),
        channels, length, tiles, static_cast<int>(length % 4 == 0));
    return static_cast<int>(cudaGetLastError());
  }
  const int n = (length + chunk - 1) / chunk;
  if (chunk < 4 || chunk > kMaxChunk || chunk % 4 != 0 || n > kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the row's floats spread evenly: ceil(length / n), up to a multiple of 4
  const int share = ((length + n - 1) / n + 3) / 4 * 4;
  const size_t smem = (static_cast<size_t>(share) + 4) * sizeof(float);
  static bool smem_set[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[device]) {
    err = cudaFuncSetAttribute(norm_silu_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>((kMaxChunk + 4) * sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, norm_silu_rows, static_cast<const float*>(x), static_cast<float*>(y),
                           static_cast<const float*>(bias), static_cast<const float*>(gamma),
                           static_cast<const float*>(beta), channels, length, share, eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The norm on rows of any length (the long rows' path: two launches), ws a
// workspace of ws_floats >= 2 * rows * ceil(length / kStreamTile) fp32 on
// `device`. As sa_norm_silu otherwise; cudaErrorInvalidValue for a short ws.
int sa_norm_silu_long(const void* x, void* y, const void* bias, const void* gamma,
                      const void* beta, void* ws, long long ws_floats, int rows, int channels,
                      int length, float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || length <= 0) return 0;
  const int tiles = (length + kStreamTile - 1) / kStreamTile;
  if (ws_floats < 2LL * rows * tiles) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(rows) * tiles;
  norm_silu_moments<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                static_cast<const float*>(bias),
                                                static_cast<float2*>(ws), channels, length, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  norm_silu_apply<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(y), static_cast<const float*>(bias),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float2*>(ws), channels, length, tiles, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
