// The paper's whole two-layer net in one launch, for Hopper (sm_90a), bound to
// Python with ctypes.
//
// fused_mlp_kernel replaces the Pallas kernel fused_mlp_predict
// (src/repro/kernels/fused_mlp/fused_mlp.py, _fused_mlp_kernel):
//
//     a  = x > threshold                     x uint8 (B, K)
//     hi = a . w1                            w1 int32 (K, H), int32 wrap
//     ho = hi > 0                            strict step
//     fi = ho . w2                           w2 int32 (H, O), int32 wrap
//     y  = argmax(fi)                        the first maximum wins
//
// One block per tile of BM rows; the rows' activations never leave shared
// memory:
//   1. binarize and pack: lane i of a warp tests pixel 32c+i of row r, and the
//      warp's __ballot_sync is the packed word (pixels past K, rows past B: 0);
//   2. layer 1: each thread owns one hidden unit h and the tile's BM rows, and
//      walks K reading w1[k, h] once for all BM rows, coalesced along H, adding
//      it to the rows whose bit k is set (a branch-free predicated add);
//   3. strict step hi > 0 and repack: a warp's 32 consecutive units ballot one
//      word of the hidden activations into shared memory;
//   4. layer 2: one warp per class o sweeps H in lanes, adds w2[h, o] for the
//      rows whose hidden bit h is set, and reduces across the warp with
//      shuffles into a (BM, O) score table in shared memory;
//   5. argmax: one thread per row scans its O scores in order with a strict >,
//      so ties go to the lower class index.
// Sums are uint32, so overflow wraps exactly as the int32 reference does.
//
// What bounds it on an H100: the adds. Layer 1 of a 784-500-10 net at 256 rows
// is 100 M select-adds against ~1.8 MB of operands; 32-bit integer add issues
// at 64 results per clock per SM (CUDA C++ Programming Guide, arithmetic
// instruction throughput, compute capability 9.0). Each block reads all of w1
// from L2, so fewer rows per block means more blocks on the 132 SMs but more
// L2 traffic; the default BM balances the two. Keeping w1 resident across
// a thread-block cluster, and the int8 tensor cores where |w| fits in int8,
// are later work.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
// Threads per block: one hidden unit each, looping when H is wider.
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;

template <int BM>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_kernel(const uint8_t* __restrict__ x, int B, int K, int threshold,
                     const uint32_t* __restrict__ w1, int H, const uint32_t* __restrict__ w2,
                     int O, int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int kw = (K + kWarp - 1) / kWarp;
  const int hw = (H + kWarp - 1) / kWarp;
  uint32_t* xs = smem;                                       // BM x kw words
  uint32_t* hs = xs + BM * kw;                               // BM x hw words
  int* scores = reinterpret_cast<int*>(hs + BM * hw);        // BM x O

  const int row0 = blockIdx.x * BM;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;

  // 1. Binarize and pack.
  for (int i = warp; i < BM * kw; i += kWarps) {
    const int r = i / kw;
    const int c = i % kw;
    const int row = row0 + r;
    const int k = c * kWarp + lane;
    const bool bit =
        row < B && k < K && static_cast<int>(x[static_cast<size_t>(row) * K + k]) > threshold;
    const uint32_t word = __ballot_sync(kFullMask, bit);
    if (lane == 0) xs[r * kw + c] = word;
  }
  __syncthreads();

  // 2-3. Layer 1, strict step, repack. `base` is warp-uniform and the unit
  // range is padded to whole words, so every lane takes part in each ballot;
  // padded units read no weight and step to 0.
  for (int base = warp * kWarp; base < hw * kWarp; base += kThreads) {
    const int h = base + lane;
    const bool valid = h < H;
    uint32_t acc[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[r] = 0u;
    for (int c = 0; c < kw; ++c) {
      uint32_t a[BM];
#pragma unroll
      for (int r = 0; r < BM; ++r) a[r] = xs[r * kw + c];
      const int k0 = c * kWarp;
#pragma unroll
      for (int i = 0; i < kWarp; ++i) {
        const int k = k0 + i;
        const uint32_t v = (valid && k < K) ? __ldg(w1 + static_cast<size_t>(k) * H + h) : 0u;
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r] += (a[r] & (1u << i)) ? v : 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const uint32_t word = __ballot_sync(kFullMask, static_cast<int>(acc[r]) > 0);
      if (lane == 0) hs[r * hw + base / kWarp] = word;
    }
  }
  __syncthreads();

  // 4. Layer 2: lane l of word t holds hidden unit 32t + l.
  for (int o = warp; o < O; o += kWarps) {
    uint32_t acc[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[r] = 0u;
    for (int t = 0; t < hw; ++t) {
      const int h = t * kWarp + lane;
      const uint32_t v = h < H ? __ldg(w2 + static_cast<size_t>(h) * O + o) : 0u;
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] += (hs[r * hw + t] & (1u << lane)) ? v : 0u;
    }
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      uint32_t s = acc[r];
      for (int off = kWarp / 2; off > 0; off /= 2) s += __shfl_down_sync(kFullMask, s, off);
      if (lane == 0) scores[r * O + o] = static_cast<int>(s);
    }
  }
  __syncthreads();

  // 5. Argmax, the first maximum winning.
  if (threadIdx.x < BM && row0 + static_cast<int>(threadIdx.x) < B) {
    const int* sr = scores + threadIdx.x * O;
    int best_v = sr[0];
    int best_i = 0;
    for (int o = 1; o < O; ++o) {
      if (sr[o] > best_v) {
        best_v = sr[o];
        best_i = o;
      }
    }
    out[row0 + threadIdx.x] = best_i;
  }
}

template <int BM>
cudaError_t launch_fused(const void* x, int B, int K, int threshold, const void* w1, int H,
                         const void* w2, int O, void* out, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_mlp_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((B + BM - 1) / BM);
  fused_mlp_kernel<BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(x), B, K, threshold, static_cast<const uint32_t*>(w1), H,
      static_cast<const uint32_t*>(w2), O, static_cast<int32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fmlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns a cudaError_t: 0 on a launch that was accepted.
int fmlp_predict(const void* x, int B, int K, int threshold, const void* w1, int H,
                 const void* w2, int O, void* out, int bm, int device, void* stream) {
  if (B <= 0 || K < 0 || H < 0 || O < 1) return cudaErrorInvalidValue;
  const size_t kw = (static_cast<size_t>(K) + kWarp - 1) / kWarp;
  const size_t hw = (static_cast<size_t>(H) + kWarp - 1) / kWarp;
  const size_t smem = static_cast<size_t>(bm) * (kw + hw + O) * sizeof(uint32_t);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 1: return launch_fused<1>(x, B, K, threshold, w1, H, w2, O, out, smem, s);
    case 2: return launch_fused<2>(x, B, K, threshold, w1, H, w2, O, out, smem, s);
    case 4: return launch_fused<4>(x, B, K, threshold, w1, H, w2, O, out, smem, s);
    case 8: return launch_fused<8>(x, B, K, threshold, w1, H, w2, O, out, smem, s);
    case 16: return launch_fused<16>(x, B, K, threshold, w1, H, w2, O, out, smem, s);
    case 32: return launch_fused<32>(x, B, K, threshold, w1, H, w2, O, out, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
