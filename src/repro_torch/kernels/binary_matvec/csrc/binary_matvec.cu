// Bit-plane popcount kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Both kernels compute the planes datapath of the netgen compiler: activations
// are bits packed 32 to a little-endian uint32 word (bit i of word j is unit
// 32j+i), and each integer weight matrix is split into signed bit-planes,
// w = sum_b 2^b (pos_b - neg_b), each plane packed along fan_in the same way.
// One layer is then
//
//     y[r, n] = sum_b 2^b sum_w (popc(x[r, w] & pos[b, w, n]) - popc(x[r, w] & neg[b, w, n]))
//
// and accumulates in uint32 so that overflow wraps exactly as the int32
// reference does.
//
// matmul_planes_kernel replaces the Pallas kernel binary_matmul_planes
// (src/repro/kernels/binary_matvec/binary_matvec.py, _binary_matmul_planes_kernel).
// forward_planes_kernel replaces binary_forward_planes
// (same file, _forward_planes_kernel): the whole net in one launch.
//
// What bounds them on an H100: popcount. __popc issues at 16 results per clock
// per SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
// compute capability 9.0), a quarter of the rate of 32-bit AND and add. One
// 784-500-10 layer-1 pass at 256 rows is ~26 M popcounts against ~0.6 MB of
// operands, so the work, not the bytes, sets the floor. The designs below keep
// every popcount operand in a register or in shared memory: the activation
// words of a row tile sit in shared memory and are read as warp broadcasts, and
// each thread owns one output unit and reads its weight words once per tile,
// coalesced along the unit axis. Making the kernels reach that floor
// (register-blocked weights, cluster-resident planes, cp.async) is later work.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// matmul: the K sweep runs inside the block in chunks of this many words,
// staged in shared memory, so the grid needs no reduction across blocks.
constexpr int kChunkWords = 32;

// forward: threads per block, and the deepest net one launch takes (the layer
// table travels in the kernel's parameter space). ops.py mirrors both as
// FORWARD_WARPS and FORWARD_MAX_LAYERS.
constexpr int kForwardThreads = 256;
constexpr int kForwardWarps = kForwardThreads / kWarp;
constexpr int kMaxLayers = 16;

struct PlaneLayer {
  const uint32_t* pos;  // (P, W, N) words, or (M, P, W, N) when stacked
  const uint32_t* neg;
  int planes;           // P
  int words;            // W: packed fan_in
  int units;            // N: fan_out (hidden layers: a multiple of 32)
};

struct PlaneNet {
  PlaneLayer layer[kMaxLayers];
  int depth;
};

// Adds one (word, plane) term to BM row accumulators.
template <int BM>
__device__ __forceinline__ void accumulate(uint32_t (&acc)[BM], const uint32_t (&a)[BM],
                                           uint32_t p, uint32_t q, int b) {
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int d = __popc(a[r] & p) - __popc(a[r] & q);
    acc[r] += static_cast<uint32_t>(d) << b;
  }
}

// y = x . planes for x (B, KW) words and pos/neg (P, KW, N) words; y int32 (B, N).
// Grid: (ceil(B / BM), ceil(N / blockDim.x)). Each thread owns one output
// column n and the block's BM rows; blockDim.x is the column tile bn.
template <int BM>
__global__ void matmul_planes_kernel(const uint32_t* __restrict__ x,
                                     const uint32_t* __restrict__ pos,
                                     const uint32_t* __restrict__ neg,
                                     int32_t* __restrict__ out, int B, int KW, int P, int N) {
  __shared__ uint32_t xs[BM][kChunkWords];
  const int row0 = blockIdx.x * BM;
  const int n = blockIdx.y * blockDim.x + threadIdx.x;
  const bool valid = n < N;

  uint32_t acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0u;

  for (int k0 = 0; k0 < KW; k0 += kChunkWords) {
    const int kc = min(kChunkWords, KW - k0);
    for (int i = threadIdx.x; i < BM * kChunkWords; i += blockDim.x) {
      const int r = i / kChunkWords;
      const int c = i % kChunkWords;
      const int row = row0 + r;
      xs[r][c] = (row < B && c < kc) ? x[static_cast<size_t>(row) * KW + k0 + c] : 0u;
    }
    __syncthreads();
    for (int c = 0; c < kc; ++c) {
      uint32_t a[BM];
#pragma unroll
      for (int r = 0; r < BM; ++r) a[r] = xs[r][c];
      for (int b = 0; b < P; ++b) {
        const size_t off = (static_cast<size_t>(b) * KW + k0 + c) * N + n;
        const uint32_t p = valid ? __ldg(pos + off) : 0u;
        const uint32_t q = valid ? __ldg(neg + off) : 0u;
        accumulate(acc, a, p, q, b);
      }
    }
    __syncthreads();
  }
  if (!valid) return;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    if (row0 + r < B) out[static_cast<size_t>(row0 + r) * N + n] = static_cast<int32_t>(acc[r]);
  }
}

// Keeps the first maximum: a larger score wins, an equal score wins only with
// a smaller unit index.
__device__ __forceinline__ void take_max(int& v, int& i, int ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// The whole planes-form net for one tile of BM rows of one model.
// Grid: (ceil(B / BM), M). Dynamic shared memory holds two activation buffers
// of BM x max_words words (this layer's input, the next layer's input) and the
// per-warp argmax partials.
template <int BM>
__global__ void __launch_bounds__(kForwardThreads)
    forward_planes_kernel(const uint8_t* __restrict__ x, int B, int K, int threshold,
                          PlaneNet net, int n_classes, int max_words,
                          int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* cur = smem;
  uint32_t* nxt = smem + BM * max_words;
  int* part_v = reinterpret_cast<int*>(smem + 2 * BM * max_words);
  int* part_i = part_v + kForwardWarps * BM;

  const int m = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const uint8_t* xm = x + static_cast<size_t>(m) * B * K;

  // Binarize and pack: lane i of a warp tests pixel 32w+i of row r, and the
  // ballot is the packed word. Pixels past K and rows past B are 0.
  const int w0 = net.layer[0].words;
  for (int i = warp; i < BM * w0; i += kForwardWarps) {
    const int r = i / w0;
    const int w = i % w0;
    const int row = row0 + r;
    const int k = w * kWarp + lane;
    const bool bit =
        row < B && k < K && static_cast<int>(xm[static_cast<size_t>(row) * K + k]) > threshold;
    const uint32_t word = __ballot_sync(kFullMask, bit);
    if (lane == 0) cur[r * w0 + w] = word;
  }
  __syncthreads();

  int best_v[BM];
  int best_i[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    best_v[r] = INT_MIN;
    best_i[r] = INT_MAX;
  }

  for (int l = 0; l < net.depth; ++l) {
    const PlaneLayer L = net.layer[l];
    const bool last = l + 1 == net.depth;
    const size_t per_model = static_cast<size_t>(L.planes) * L.words * L.units;
    const uint32_t* pos = L.pos + m * per_model;
    const uint32_t* neg = L.neg + m * per_model;
    // The final layer scores only the real classes; hidden layers compute
    // every (padded) unit so the ballot below fills whole words.
    const int units = last ? n_classes : L.units;
    const int out_words = L.units / kWarp;
    // `base` is warp-uniform and hidden `units` is a multiple of 32, so every
    // lane of a warp takes part in each ballot.
    for (int base = warp * kWarp; base < units; base += kForwardThreads) {
      const int n = base + lane;
      const bool valid = n < units;
      uint32_t acc[BM];
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] = 0u;
      for (int w = 0; w < L.words; ++w) {
        uint32_t a[BM];
#pragma unroll
        for (int r = 0; r < BM; ++r) a[r] = cur[r * L.words + w];
        for (int b = 0; b < L.planes; ++b) {
          const size_t off = (static_cast<size_t>(b) * L.words + w) * L.units + n;
          const uint32_t p = valid ? __ldg(pos + off) : 0u;
          const uint32_t q = valid ? __ldg(neg + off) : 0u;
          accumulate(acc, a, p, q, b);
        }
      }
      if (!last) {
        // Strict step and repack: the warp's 32 consecutive units form one
        // word of the next layer's input, bit i = unit base + i.
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const uint32_t word = __ballot_sync(kFullMask, static_cast<int>(acc[r]) > 0);
          if (lane == 0) nxt[r * out_words + base / kWarp] = word;
        }
      } else if (valid) {
        // Units visit in increasing order per thread, so a strict > keeps
        // the first maximum.
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const int v = static_cast<int>(acc[r]);
          if (v > best_v[r]) {
            best_v[r] = v;
            best_i[r] = n;
          }
        }
      }
    }
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  // Argmax across the block: warp shuffles, then one thread per row over
  // the warps' partials.
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    int v = best_v[r];
    int i = best_i[r];
    for (int off = kWarp / 2; off > 0; off /= 2) {
      const int ov = __shfl_down_sync(kFullMask, v, off);
      const int oi = __shfl_down_sync(kFullMask, i, off);
      take_max(v, i, ov, oi);
    }
    if (lane == 0) {
      part_v[warp * BM + r] = v;
      part_i[warp * BM + r] = i;
    }
  }
  __syncthreads();
  if (threadIdx.x < BM) {
    const int r = threadIdx.x;
    int v = part_v[r];
    int i = part_i[r];
    for (int w = 1; w < kForwardWarps; ++w) take_max(v, i, part_v[w * BM + r], part_i[w * BM + r]);
    if (row0 + r < B) out[static_cast<size_t>(m) * B + row0 + r] = i;
  }
}

template <int BM>
cudaError_t launch_matmul(const void* x, const void* pos, const void* neg, void* out, int B,
                          int KW, int P, int N, int bn, cudaStream_t stream) {
  const dim3 grid((B + BM - 1) / BM, (N + bn - 1) / bn);
  matmul_planes_kernel<BM><<<grid, bn, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(pos),
      static_cast<const uint32_t*>(neg), static_cast<int32_t*>(out), B, KW, P, N);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_forward(const void* x, int M, int B, int K, int threshold, const PlaneNet& net,
                           int n_classes, int max_words, size_t smem, void* out,
                           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        forward_planes_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((B + BM - 1) / BM, M);
  forward_planes_kernel<BM><<<grid, kForwardThreads, smem, stream>>>(
      static_cast<const uint8_t*>(x), B, K, threshold, net, n_classes, max_words,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* bmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns a cudaError_t: 0 on a launch that was accepted.
int bmv_matmul_planes(const void* x, const void* pos, const void* neg, void* out, int B, int KW,
                      int P, int N, int bm, int bn, int device, void* stream) {
  if (B <= 0 || N <= 0 || KW < 0 || P < 0 || bn <= 0 || bn % kWarp != 0 || bn > 1024) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 1: return launch_matmul<1>(x, pos, neg, out, B, KW, P, N, bn, s);
    case 2: return launch_matmul<2>(x, pos, neg, out, B, KW, P, N, bn, s);
    case 4: return launch_matmul<4>(x, pos, neg, out, B, KW, P, N, bn, s);
    case 8: return launch_matmul<8>(x, pos, neg, out, B, KW, P, N, bn, s);
    case 16: return launch_matmul<16>(x, pos, neg, out, B, KW, P, N, bn, s);
    case 32: return launch_matmul<32>(x, pos, neg, out, B, KW, P, N, bn, s);
    default: return cudaErrorInvalidValue;
  }
}

// pos/neg: `depth` device pointers each; planes/words/units: `depth` ints.
int bmv_forward_planes(const void* x, int M, int B, int K, int threshold, int depth,
                       const void* const* pos, const void* const* neg, const int* planes,
                       const int* words, const int* units, int n_classes, void* out, int bm,
                       int device, void* stream) {
  if (M <= 0 || B <= 0 || K < 0 || depth < 1 || depth > kMaxLayers || n_classes < 1) {
    return cudaErrorInvalidValue;
  }
  PlaneNet net{};
  int max_words = 0;
  for (int l = 0; l < depth; ++l) {
    net.layer[l] = PlaneLayer{static_cast<const uint32_t*>(pos[l]),
                              static_cast<const uint32_t*>(neg[l]), planes[l], words[l], units[l]};
    max_words = words[l] > max_words ? words[l] : max_words;
  }
  net.depth = depth;
  const size_t smem =
      (2 * static_cast<size_t>(bm) * max_words + 2 * static_cast<size_t>(kForwardWarps) * bm) *
      sizeof(uint32_t);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 1: return launch_forward<1>(x, M, B, K, threshold, net, n_classes, max_words, smem, out, s);
    case 2: return launch_forward<2>(x, M, B, K, threshold, net, n_classes, max_words, smem, out, s);
    case 4: return launch_forward<4>(x, M, B, K, threshold, net, n_classes, max_words, smem, out, s);
    case 8: return launch_forward<8>(x, M, B, K, threshold, net, n_classes, max_words, smem, out, s);
    case 16:
      return launch_forward<16>(x, M, B, K, threshold, net, n_classes, max_words, smem, out, s);
    case 32:
      return launch_forward<32>(x, M, B, K, threshold, net, n_classes, max_words, smem, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
