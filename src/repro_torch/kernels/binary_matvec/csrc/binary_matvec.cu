// Binary-activation matmul kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Activations are {0,1}. A layer y = x . w is then a masked column sum, the
// rows of w selected by the set activations added up, with no multiply. The
// four kernels differ in how the operands travel:
//
//   matmul_dense_kernel   x int8 (B, K), w int32 (K, N). Replaces the Pallas
//                         kernel binary_matmul (src/repro/kernels/binary_matvec/
//                         binary_matvec.py, _binary_matmul_kernel).
//   matmul_packed_kernel  x packed 32 to a little-endian uint32 word (bit i of
//                         word j is unit 32j+i), w int32 (KW*32, N). Replaces
//                         binary_matmul_packed (same file, _binary_matmul_packed_kernel).
//   matmul_planes_kernel  both operands packed: w split into signed bit-planes,
//                         w = sum_b 2^b (pos_b - neg_b), each plane packed along
//                         fan_in like x, so one layer is
//                             y[r, n] = sum_b 2^b sum_w (popc(x[r, w] & pos[b, w, n])
//                                                        - popc(x[r, w] & neg[b, w, n])).
//                         Replaces binary_matmul_planes (_binary_matmul_planes_kernel).
//   forward_planes_kernel the whole planes-form net in one launch. Replaces
//                         binary_forward_planes (_forward_planes_kernel).
//
// Every kernel accumulates in uint32, so overflow wraps exactly as the int32
// reference does.
//
// What bounds them on an H100. The dense and packed kernels do one select and
// one 32-bit add per (row, k, column); 32-bit integer add issues at 64 results
// per clock per SM (CUDA C++ Programming Guide, arithmetic instruction
// throughput, compute capability 9.0). One 784-500-10 layer-1 pass at 256 rows
// is 100 M adds against ~1.8 MB of operands, so the adds, not the bytes, set the
// floor. The planes kernels are bound by popcount: __popc issues at 16 results
// per clock per SM, a quarter of the add rate; layer 1 is ~26 M popcounts
// against ~0.6 MB of operands. The designs below keep every activation in a
// register or in shared memory: a tile of BM rows is staged in shared memory
// and read as warp broadcasts, and each thread owns one output column and
// reads each weight word once per tile, coalesced along the column axis, for
// BM rows. Reaching the floor (register-blocked weights, cp.async pipelines,
// clusters sharing a weight tile) is later work.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// matmul: the K sweep runs inside the block in chunks of this many words
// (packed, planes) or bytes (dense), staged in shared memory, so the grid
// needs no reduction across blocks.
constexpr int kChunkWords = 32;
constexpr int kDenseChunk = 256;
// The widest column tile (bn) a matmul block takes. The dense and packed
// kernels are compiled to launch with this many threads at every BM (their
// registers are capped to fit); the planes kernel at BM=32 needs fewer threads.
constexpr int kMaxBlockThreads = 1024;

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

// y = x . w for x int8 (B, K) with nonzero meaning 1 and w int32 (K, N); y int32
// (B, N). Grid: (ceil(B / BM), ceil(N / blockDim.x)). Each thread owns one
// output column n and the block's BM rows; blockDim.x is the column tile bn.
// A chunk of the tile's x bytes is staged in shared memory (bytes past K and
// rows past B are 0) and read four bytes of a row at a time: byte j of the
// word is x[row, k0 + g + j]. Each step loads 32 weights into registers before
// it adds any (so 32 loads are in flight, not one), and the weight load of the
// ragged K tail is masked. The select `(a & byte_j) ? v : 0` is branch-free (a
// predicated add), so the accumulation adds only.
template <int BM>
__global__ void __launch_bounds__(kMaxBlockThreads) matmul_dense_kernel(const uint8_t* __restrict__ x,
                                    const uint32_t* __restrict__ w,
                                    int32_t* __restrict__ out, int B, int K, int N) {
  __shared__ __align__(16) uint8_t xs[BM][kDenseChunk];
  const int row0 = blockIdx.x * BM;
  const int n = blockIdx.y * blockDim.x + threadIdx.x;
  const bool valid = n < N;

  uint32_t acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0u;

  for (int k0 = 0; k0 < K; k0 += kDenseChunk) {
    const int kc = min(kDenseChunk, K - k0);
#pragma unroll 8
    for (int i = threadIdx.x; i < BM * kDenseChunk; i += blockDim.x) {
      const int r = i / kDenseChunk;
      const int c = i % kDenseChunk;
      const int row = row0 + r;
      xs[r][c] = (row < B && c < kc) ? x[static_cast<size_t>(row) * K + k0 + c] : 0u;
    }
    __syncthreads();
    for (int g = 0; g < kc; g += kWarp) {
      uint32_t v[kWarp];
#pragma unroll
      for (int j = 0; j < kWarp; ++j) {
        const int k = k0 + g + j;
        v[j] = (valid && k < K) ? __ldg(w + static_cast<size_t>(k) * N + n) : 0u;
      }
#pragma unroll
      for (int q = 0; q < kWarp / 4; ++q) {
        uint32_t a[BM];
#pragma unroll
        for (int r = 0; r < BM; ++r) a[r] = *reinterpret_cast<const uint32_t*>(&xs[r][g + 4 * q]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int r = 0; r < BM; ++r) acc[r] += (a[r] & (0xffu << (8 * j))) ? v[4 * q + j] : 0u;
        }
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

// y = unpack(x) . w for x (B, KW) words and w int32 (KW * 32, N); y int32 (B, N).
// The grid and the thread's work are those of matmul_dense_kernel; the staged
// activations are words, and bit i of word c selects row 32c + i of w (the 32
// weights of a word are loaded into registers before any is added). Bits are
// tested on uint32_t, so bit 31 never sign-extends.
template <int BM>
__global__ void __launch_bounds__(kMaxBlockThreads) matmul_packed_kernel(const uint32_t* __restrict__ x,
                                     const uint32_t* __restrict__ w,
                                     int32_t* __restrict__ out, int B, int KW, int N) {
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
      const uint32_t* wc = w + static_cast<size_t>(k0 + c) * kWarp * N + n;
      uint32_t v[kWarp];
#pragma unroll
      for (int i = 0; i < kWarp; ++i) v[i] = valid ? __ldg(wc + static_cast<size_t>(i) * N) : 0u;
      uint32_t a[BM];
#pragma unroll
      for (int r = 0; r < BM; ++r) a[r] = xs[r][c];
#pragma unroll
      for (int i = 0; i < kWarp; ++i) {
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r] += (a[r] & (1u << i)) ? v[i] : 0u;
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
cudaError_t launch_dense(const void* x, const void* w, void* out, int B, int K, int N, int bn,
                         cudaStream_t stream) {
  const dim3 grid((B + BM - 1) / BM, (N + bn - 1) / bn);
  matmul_dense_kernel<BM><<<grid, bn, 0, stream>>>(static_cast<const uint8_t*>(x),
                                                   static_cast<const uint32_t*>(w),
                                                   static_cast<int32_t*>(out), B, K, N);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_packed(const void* x, const void* w, void* out, int B, int KW, int N, int bn,
                          cudaStream_t stream) {
  const dim3 grid((B + BM - 1) / BM, (N + bn - 1) / bn);
  matmul_packed_kernel<BM><<<grid, bn, 0, stream>>>(static_cast<const uint32_t*>(x),
                                                    static_cast<const uint32_t*>(w),
                                                    static_cast<int32_t*>(out), B, KW, N);
  return cudaGetLastError();
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
int bmv_matmul(const void* x, const void* w, void* out, int B, int K, int N, int bm, int bn,
               int device, void* stream) {
  if (B <= 0 || N <= 0 || K < 0 || bn <= 0 || bn % kWarp != 0 || bn > kMaxBlockThreads) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 1: return launch_dense<1>(x, w, out, B, K, N, bn, s);
    case 2: return launch_dense<2>(x, w, out, B, K, N, bn, s);
    case 4: return launch_dense<4>(x, w, out, B, K, N, bn, s);
    case 8: return launch_dense<8>(x, w, out, B, K, N, bn, s);
    case 16: return launch_dense<16>(x, w, out, B, K, N, bn, s);
    case 32: return launch_dense<32>(x, w, out, B, K, N, bn, s);
    default: return cudaErrorInvalidValue;
  }
}

int bmv_matmul_packed(const void* x, const void* w, void* out, int B, int KW, int N, int bm,
                      int bn, int device, void* stream) {
  if (B <= 0 || N <= 0 || KW < 0 || bn <= 0 || bn % kWarp != 0 || bn > kMaxBlockThreads) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 1: return launch_packed<1>(x, w, out, B, KW, N, bn, s);
    case 2: return launch_packed<2>(x, w, out, B, KW, N, bn, s);
    case 4: return launch_packed<4>(x, w, out, B, KW, N, bn, s);
    case 8: return launch_packed<8>(x, w, out, B, KW, N, bn, s);
    case 16: return launch_packed<16>(x, w, out, B, KW, N, bn, s);
    case 32: return launch_packed<32>(x, w, out, B, KW, N, bn, s);
    default: return cudaErrorInvalidValue;
  }
}

int bmv_matmul_planes(const void* x, const void* pos, const void* neg, void* out, int B, int KW,
                      int P, int N, int bm, int bn, int device, void* stream) {
  if (B <= 0 || N <= 0 || KW < 0 || P < 0 || bn <= 0 || bn % kWarp != 0 || bn > kMaxBlockThreads) {
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
