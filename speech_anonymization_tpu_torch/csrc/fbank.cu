// Fused log-mel frontend kernel for Hopper (sm_90a): frames -> mel power.
//
// Replaces the Pallas TPU kernel K1, speech_anonymization_tpu/ops/pallas/
// fbank_kernel.py `_fbank_kernel` (launched by `_fused_fbank_padded`):
//
//     spec  = frames @ [W*cos | -W*sin]      (R, win) x (win, 2*n_bins)
//     power = re^2 + im^2                    (R, n_bins), never in device memory
//     mel   = power @ mel_fb                 (R, n_bins) x (n_bins, n_mels)
//
// Only the frames are read from device memory and the mel power written; the
// spectrum lives in registers and the power, one bin tile at a time, in
// shared memory.
//
// Arithmetic: the DFT product runs on the TF32 tensor cores in three passes
// ("3xTF32"). Each fp32 operand x is split as hi = tf32(x) (round to nearest,
// ties away, as cvt.rna) and lo = tf32(x - hi), and the product accumulates
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in fp32 (mma.sync m16n8k8, f32
// accumulators); each TF32 x TF32 product is exact in fp32, and the dropped
// a_lo*b_lo term is ~2^-22 relative. One TF32 pass breaks the 1e-3 log-mel
// budget (the reference runs at Precision.HIGHEST); three passes stay within
// K1's 1e-4 of the fp32 twin. The frames are split in registers as their
// fragments are loaded (hi by two integer ops; lo = x - hi goes to the tensor
// core as is, which reads a TF32 operand's top 19 bits). The DFT's halves are
// split once on the host (`prepare_dft` in ops/fbank_kernel.py) and stored in
// mma-fragment order: for k8 tile kt, n8 tile nt and lane (g = lane / 4, t =
// lane % 4) one float4 {hi b0, hi b1, lo b0, lo b1}, b0 = B[8 kt + t][8 nt +
// g], b1 = B[8 kt + t + 4][8 nt + g], where B's columns interleave the bins
// (2 b: cos, 2 b + 1: -sin), so an accumulator fragment's (c0, c1) and (c2,
// c3) are (re, im) of one bin and the power is formed in registers. The mel
// product (1/30 of the operations) is fp32 FMA from shared memory.
//
// Bound on an H100 SXM at the main-path shape (R = 32 * 1008 = 32,256 frames,
// win 400, 201 bins, 80 mels): an fp32-accurate DFT product needs 3 * 2 * R *
// 400 * 402 = 31.1 GFLOP on the TF32 tensor cores, 0.063 ms at their 495
// TFLOP/s; the mel product's 2 * R * 201 * 80 = 1.0 GFLOP of fp32 FMA (0.016
// ms at 67 TFLOP/s) can run beside them. The bytes (frames in, mel power out,
// ~63 MB) take 0.019 ms at 3.35 TB/s. So it is bound by operations, 0.063 ms
// (chip_smoke.py computes it from the run's shape). This design issues a
// little more: 408 columns (51 whole n8 tiles), 1.5% over.
//
// Design: one block of 512 threads (16 warps, one block an SM) per tile of
// 128 frames; it walks the bins in tiles of 64 (16 n8 tiles; the last has 3
// live n8 tiles and only the warps that own them issue products). The window
// (K = win) streams through a 4-stage cp.async ring in chunks of 16 samples:
// each stage holds the frame chunk (128 x 16, rows padded to 20 floats so
// the fragment loads hit 32 distinct banks) and the DFT fragments of the two
// k8 tiles for the live n8 tiles of the bin tile (L2-resident: 1.3 MB in
// all). The ring runs on across bin tiles, so the next tile's first chunks
// load while a tile's epilogue runs. What moves from L2 to shared memory
// costs this design about as much as the products: every block reads the
// whole DFT and, once per bin tile, its frames (~530 MB at bench.py's
// shape; PERF.md has the measurements). Warp (wm, wn) owns rows 32 wm .. 32 wm +
// 31 and n8 tiles wn + 4 j (j < 4) of the bin tile: 2 x 4 accumulator tiles.
// Epilogue of a bin tile: re^2 + im^2 into a shared (64 bins x 128 frames)
// power tile, the mel slice of those bins into shared memory, then each
// thread adds 4 frames x 5 mels of power @ mel to its registers.
// Shared memory: 4 * (128 * 20 + 2 * 16 * 32 * 4) * 4 + 64 * 136 * 4 + 64 *
// 80 * 4 = 161,792 bytes, whatever win is.
// Limits checked by the Python wrapper: win % 16 == 0, n_mels <= 80, the DFT
// fragments of `prepare_dft` for this win and n_bins, 16-byte aligned frames
// and fragments.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;         // frames per block
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;         // window samples per stage (two k8 tiles)
constexpr int kStages = 4;
constexpr int kFrameStride = kChunk + 4;   // floats per staged frame row
constexpr int kTileN8 = 16;        // n8 tiles per bin tile
constexpr int kTileBins = kTileN8 * 4;      // 64 bins
constexpr int kPowerStride = kRows + 8;     // floats per power row (one bin)
constexpr int kMaxMels = 80;
constexpr int kMelsPerThread = 5;  // 16 mel lanes x 5 = 80 mel columns
constexpr int kStageFrames = kRows * kFrameStride;          // floats
constexpr int kStageDft = (kChunk / 8) * kTileN8 * 32 * 4;  // floats
constexpr int kStageFloats = kStageFrames + kStageDft;
constexpr size_t kSmemBytes =
    (static_cast<size_t>(kStages) * kStageFloats + kTileBins * kPowerStride +
     kTileBins * kMaxMels) * sizeof(float);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 fills zeros (rows past the end)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x -> (hi, lo) TF32 halves. hi is cvt.rna.tf32.f32 done with two integer
// ops (add half an ulp of the 10-bit mantissa to the magnitude's bits, drop
// the low 13), cheaper than the conversion instruction, which every warp
// would issue for every fragment element. lo = x - hi is exact in fp32 and
// goes to the tensor core as is (truncated there: at most 2^-21 of x).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 1)
fbank_kernel(const float* __restrict__ frames, const float4* __restrict__ frag,
             const float* __restrict__ mel, float* __restrict__ out, int n_rows, int win,
             int n_bins, int n_mels) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_power = smem + kStages * kStageFloats;   // [kTileBins][kPowerStride]
  float* s_mel = s_power + kTileBins * kPowerStride;  // [kTileBins][n_mels]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 2;  // rows 32 wm .. 32 wm + 31
  const int wn = warp & 3;   // n8 tiles wn + 4 j of the bin tile
  const int row0 = blockIdx.x * kRows;

  const int n_chunks = win / kChunk;
  const int n8 = (2 * n_bins + 7) / 8;  // n8 tiles of interleaved columns
  const int n_bin_tiles = (n8 + kTileN8 - 1) / kTileN8;
  const int total = n_bin_tiles * n_chunks;

  // Stage `it` of the flattened (bin tile, chunk) walk into ring slot it % kStages.
  auto issue = [&](int it) {
    if (it < total) {
      const int bt = it / n_chunks;
      const int c = it - bt * n_chunks;
      float* st = smem + (it % kStages) * kStageFloats;
      // frames: 128 rows x 4 16-byte pieces = one per thread
      {
        const int r = tid >> 2;
        const int q = tid & 3;
        const int row = row0 + r;
        const float* src =
            frames + static_cast<size_t>(row < n_rows ? row : 0) * win + c * kChunk + 4 * q;
        cp_async16(st + r * kFrameStride + 4 * q, src, row < n_rows ? 16 : 0);
      }
      // DFT fragments: two k8 tiles x the live n8 tiles of this bin tile, each
      // n8 tile 32 lanes x 16 bytes, contiguous in a k8 tile
      const int live = min(kTileN8, n8 - bt * kTileN8);
      float4* sb = reinterpret_cast<float4*>(st + kStageFrames);
      for (int i = tid; i < 2 * live * 32; i += kThreads) {
        const int kk = i / (live * 32);
        const int rem = i - kk * live * 32;
        const float4* src = frag + (static_cast<size_t>(2 * c + kk) * n8 + bt * kTileN8) * 32 + rem;
        cp_async16(sb + kk * kTileN8 * 32 + rem, src, 16);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  };

  float acc[2][4][4];
  float macc[4][kMelsPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kMelsPerThread; ++j) macc[i][j] = 0.f;
  }
  auto zero_acc = [&]() {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
      }
    }
  };
  zero_acc();

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` has landed for every thread; slot it - 1 is free
    issue(it + kStages - 1);

    const int bt = it / n_chunks;
    const int c = it - bt * n_chunks;
    const int live = min(kTileN8, n8 - bt * kTileN8);
    const float* st = smem + (it % kStages) * kStageFloats;
    const float4* sb = reinterpret_cast<const float4*>(st + kStageFrames);
#pragma unroll
    for (int kk = 0; kk < kChunk / 8; ++kk) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* fa = st + (32 * wm + 16 * mi + g) * kFrameStride + 8 * kk + t;
        split_tf32(fa[0], ahi[mi][0], alo[mi][0]);
        split_tf32(fa[8 * kFrameStride], ahi[mi][1], alo[mi][1]);
        split_tf32(fa[4], ahi[mi][2], alo[mi][2]);
        split_tf32(fa[8 * kFrameStride + 4], ahi[mi][3], alo[mi][3]);
      }
      uint32_t bhi[4][2], blo[4][2];  // the DFT's halves, split on the host
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (wn + 4 * j < live) {
          const float4 b = sb[(kk * kTileN8 + wn + 4 * j) * 32 + lane];
          bhi[j][0] = __float_as_uint(b.x);
          bhi[j][1] = __float_as_uint(b.y);
          blo[j][0] = __float_as_uint(b.z);
          blo[j][1] = __float_as_uint(b.w);
        }
      }
      // pass by pass over the 8 accumulator tiles, so that the three products
      // into one tile are 8 instructions apart rather than back to back
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (wn + 4 * j < live) {  // warp-uniform
            const uint32_t(&b)[2] = pass == 1 ? blo[j] : bhi[j];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_tf32(acc[mi][j], pass == 0 ? alo[mi] : ahi[mi], b[0], b[1]);
            }
          }
        }
      }
    }

    if (c == n_chunks - 1) {
      // Epilogue of bin tile bt. The power tile's last readers (the previous
      // epilogue's mel product) passed the barrier at the top of this iteration.
      const int bin0 = bt * kTileBins;
      const int bins_live = min(kTileBins, n_bins - bin0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nt = wn + 4 * j;
        const int b = 4 * nt + t;  // this lane's bin within the tile
        if (nt < live && b < bins_live) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int r = 32 * wm + 16 * mi + g;
            const float* a = acc[mi][j];
            s_power[b * kPowerStride + r] = a[0] * a[0] + a[1] * a[1];
            s_power[b * kPowerStride + r + 8] = a[2] * a[2] + a[3] * a[3];
          }
        }
      }
      for (int i = tid; i < bins_live * n_mels; i += kThreads) {
        s_mel[i] = __ldg(mel + static_cast<size_t>(bin0) * n_mels + i);
      }
      __syncthreads();
      const int rg = tid >> 4;  // frames 4 rg .. 4 rg + 3
      const int mg = tid & 15;  // mels mg, mg + 16, ..., mg + 64
      for (int b = 0; b < bins_live; ++b) {
        const float4 p = *reinterpret_cast<const float4*>(s_power + b * kPowerStride + 4 * rg);
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int j = 0; j < kMelsPerThread; ++j) {
          const int m = mg + 16 * j;
          const float w = m < n_mels ? s_mel[b * n_mels + m] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) macc[i][j] = fmaf(pv[i], w, macc[i][j]);
        }
      }
      zero_acc();
      // s_mel and s_power are next written in the following epilogue, after
      // the next iteration's barrier
    }
  }
  cp_async_wait<0>();

  const int rg = tid >> 4;
  const int mg = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * rg + i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < kMelsPerThread; ++j) {
      const int m = mg + 16 * j;
      if (m < n_mels) out[static_cast<size_t>(row) * n_mels + m] = macc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// frames (n_rows, win) fp32; frag: the DFT in mma-fragment order
// (win / 8, n8, 32, 4) fp32 with n8 = ceil(2 * n_bins / 8) (ops/fbank_kernel.py
// `prepare_dft`); mel (n_bins, n_mels); out (n_rows, n_mels). All contiguous
// on `device`. Launches on `stream` and returns cudaGetLastError() (0 on
// success). Does not synchronise.
int sa_fbank(const void* frames, const void* frag, const void* mel, void* out, int n_rows,
             int win, int n_bins, int n_mels, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool smem_set[64] = {};
  if (device >= 0 && device < 64 && !smem_set[device]) {
    err = cudaFuncSetAttribute(fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = true;
  }
  const int blocks = (n_rows + kRows - 1) / kRows;
  if (blocks > 0) {
    fbank_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(frames), static_cast<const float4*>(frag),
        static_cast<const float*>(mel), static_cast<float*>(out), n_rows, win, n_bins, n_mels);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
