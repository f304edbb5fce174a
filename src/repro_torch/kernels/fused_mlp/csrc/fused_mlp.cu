// The paper's whole two-layer net in one launch, for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Two kernels replace the Pallas kernel fused_mlp_predict
// (src/repro/kernels/fused_mlp/fused_mlp.py, _fused_mlp_kernel):
//
//     a  = x > threshold                     x uint8 (B, K)
//     hi = a . w1                            w1 (K, H), int32 wrap
//     ho = hi > 0                            strict step
//     fi = ho . w2                           w2 (H, O), int32 wrap
//     y  = argmax(fi)                        the first maximum wins
//
// Sums wrap exactly as the int32 reference does, and the rows' activations
// never leave the chip.
//
// fused_mma_kernel, the route of int8 weights (every weight of the net fits
// int8): layer 1 on the int8 tensor cores (mma.sync m16n8k32 s8, no
// .satfinite), pixels binarized as the A fragments are built, w1 read from a
// K-contiguous copy made once (the B operand's layout, as for binary_matmul).
// A cluster of 8 blocks shares a tile of 16 rows: each block owns an eighth of
// the hidden units, so w1 is read once per row tile in all instead of once
// per block; K is swept in 256-byte chunks through a four-slot cp.async ring,
// and the block's slice of w2 is copied to shared memory meanwhile. Each block
// steps its hidden units (> 0) into shared memory, scores layer 2 over them
// (one thread per row and class), and rank 0 sums the 8 partial
// scores through distributed shared memory and takes the argmax. What bounds
// it on an H100: bytes, 0.6 MB (0.18 us at 3.35 TB/s) against 0.2 G int8
// operations (0.1 us at 1,979 TOP/s); in practice the launch, the latency of
// the K sweep and the two cluster barriers, as for binary_matmul.
//
// fused_mlp_kernel, the route of int32 weights: one block per tile of BM rows.
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
// It is bound by the adds: layer 1 of a 784-500-10 net at 256 rows is 100 M
// select-adds; 32-bit integer add issues at 64 results per clock per SM (CUDA
// C++ Programming Guide, arithmetic instruction throughput, compute capability
// 9.0). Each block reads all of w1 from L2; the default BM balances blocks on
// the 132 SMs against that L2 traffic.

#include <cstddef>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

// ---- the int8 tensor-core route ---------------------------------------------

// A cluster of kCluster blocks shares one tile of kTM rows: block rank q owns
// hidden units [q slice, (q + 1) slice), so w1 is read once per row tile in
// all, not once per block. 4 warps; a sub-tile of kSubN units (16 a warp) is
// swept over K in chunks of kMmaK bytes through a kStages-slot cp.async ring.
constexpr int kCluster = 8;
constexpr int kMmaThreads = 128;
constexpr int kTM = 16;
constexpr int kSubN = 64;
constexpr int kMmaK = 256;
constexpr int kStages = 4;
constexpr int kRow = kMmaK + 16;    // 68 words: fragment reads hit 32 distinct banks

// Hidden units per block: ceil(H / kCluster), rounded up to whole sub-tiles.
__host__ __device__ __forceinline__ int mma_slice(int H) {
  return ((H + kCluster - 1) / kCluster + kSubN - 1) / kSubN * kSubN;
}

// Dynamic shared memory of a tensor-core block, in the kernel's order: the x
// ring (kStages x kTM rows), the w1 ring (kStages x kSubN columns), the
// block's hidden activations as bytes (kTM x slice), its slice of w2 (O x
// slice int8), its partial class scores (kTM x O int32).
// ops.fused_mma_smem_bytes mirrors it.
__host__ __device__ __forceinline__ size_t mma_smem(int H, int O) {
  return static_cast<size_t>(kStages) * (kTM + kSubN) * kRow +
         static_cast<size_t>(kTM + O) * mma_slice(H) + 4 * static_cast<size_t>(kTM) * O;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

// Copies src_bytes (0..16) and zero-fills the rest of the 16.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld_u32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a . b for one m16n8k32 tile: a 16x32 s8 (row), b 32x8 s8 (col), c s32.
// Without .satfinite the sums wrap.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four pixels as four {0,1} bytes, pixel > threshold: `thr4` is the
// threshold in every byte (clamped to 0..255); `all_on` for a threshold
// below 0, where every pixel passes.
__device__ __forceinline__ uint32_t binarize4(uint32_t v, uint32_t thr4, bool all_on) {
  return all_on ? 0x01010101u : (__vcmpgtu4(v, thr4) & 0x01010101u);
}

// kTM rows x kMmaK pixels from (row0, k0), VEC bytes a copy (K % VEC == 0, so
// a vector lies wholly in or past K); rows past B and pixels past K are 0.
template <int VEC>
__device__ __forceinline__ void stage_x(uint8_t (*xs)[kRow], const uint8_t* x, int B, int K,
                                        int row0, int k0) {
  constexpr int per_row = kMmaK / VEC;
  for (int i = threadIdx.x; i < kTM * per_row; i += kMmaThreads) {
    const int r = i / per_row;
    const int c = (i % per_row) * VEC;
    const int row = row0 + r;
    const int k = k0 + c;
    const bool valid = row < B && k < K;
    const uint8_t* src = valid ? x + static_cast<size_t>(row) * K + k : x;
    if constexpr (VEC == 16) {
      cp_async16(&xs[r][c], src, valid ? 16 : 0);
    } else if constexpr (VEC == 4) {
      cp_async4(&xs[r][c], src, valid ? 4 : 0);
    } else {
      xs[r][c] = valid ? *src : 0u;
    }
  }
}

// kSubN columns of w1 from unit n0, kMmaK bytes of K from k0: int8 w1 laid
// out K-contiguous, column n at w1 + n * ld1 (ld1 and w1 16-byte aligned).
// Bytes past K and columns at or past n_end are 0.
__device__ __forceinline__ void stage_w(uint8_t (*ws)[kRow], const int8_t* w1, int ld1, int K,
                                        int n_end, int k0, int n0) {
  constexpr int per_col = kMmaK / 16;
  for (int i = threadIdx.x; i < kSubN * per_col; i += kMmaThreads) {
    const int n = i / per_col;
    const int c = (i % per_col) * 16;
    const int col = n0 + n;
    const int k = k0 + c;
    const int bytes = (col < n_end && k < K) ? min(16, K - k) : 0;
    cp_async16(&ws[n][c], bytes ? w1 + static_cast<size_t>(col) * ld1 + k : w1, bytes);
  }
}

// The whole net on the int8 tensor cores. Grid (kCluster, ceil(B / kTM)),
// clusters of kCluster blocks along x. Block rank q:
//   1. layer 1 for its kTM rows and its slice of hidden units: m16n8k32 s8
//      over K (pixels binarized as the A fragments are built), warp w owning
//      units 16w..16w+15 of each sub-tile;
//   2. strict step: the hidden activations as {0,1} bytes in shared memory;
//   3. layer 2 over its slice: one thread per (row, class), a partial score;
//   4. cluster barrier; rank 0 sums the kCluster partials of each score
//      through distributed shared memory (uint32, wrapping as int32) and
//      takes the argmax, the first maximum winning; a second barrier keeps
//      every block's partials alive until then.
template <int VEC>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMmaThreads)
    fused_mma_kernel(const uint8_t* __restrict__ x, int B, int K, int threshold,
                     const int8_t* __restrict__ w1, int ld1, int H,
                     const int8_t* __restrict__ w2, int ld2, int O, int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];           // the scalar kernel's declaration
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  auto xs = reinterpret_cast<uint8_t(*)[kTM][kRow]>(base);
  auto ws = reinterpret_cast<uint8_t(*)[kSubN][kRow]>(base + kStages * kTM * kRow);
  const int slice = mma_slice(H);
  uint8_t* hs = base + kStages * (kTM + kSubN) * kRow;
  int8_t* w2s = reinterpret_cast<int8_t*>(hs + kTM * slice);
  int* part = reinterpret_cast<int*>(w2s + O * slice);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = blockIdx.y * kTM;
  const int u0 = rank * slice;
  const int u_end = min(H, u0 + slice);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane / 4;
  const int t = lane % 4;
  const int chunks = (K + kMmaK - 1) / kMmaK;
  const bool all_on = threshold < 0;
  const uint32_t thr4 = static_cast<uint32_t>(min(max(threshold, 0), 255)) * 0x01010101u;

  for (int i = threadIdx.x; i < kTM * slice; i += kMmaThreads) hs[i] = 0;

  for (int n0 = u0; n0 < u_end; n0 += kSubN) {
    int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
    // One commit group per chunk, empty past the last, so that waiting for
    // all but kStages - 2 groups means chunk c has landed.
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < chunks) {
        stage_x<VEC>(xs[c], x, B, K, row0, c * kMmaK);
        stage_w(ws[c], w1, ld1, K, u_end, c * kMmaK, n0);
      }
      cp_async_commit();
    }
    if (n0 == u0) {
      // The block's slice of w2, column o at w2s + o * slice, while the first
      // chunks are in flight.
      for (int i = threadIdx.x; i < O * slice; i += kMmaThreads) {
        const int o = i / slice;
        const int u = u0 + i % slice;
        w2s[i] = u < u_end ? w2[static_cast<size_t>(o) * ld2 + u] : 0;
      }
    }
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      // The slot refilled here was read in iteration c - 1, which every warp
      // has left at the barrier above.
      const int next = c + kStages - 1;
      if (next < chunks) {
        stage_x<VEC>(xs[next % kStages], x, B, K, row0, next * kMmaK);
        stage_w(ws[next % kStages], w1, ld1, K, u_end, next * kMmaK, n0);
      }
      cp_async_commit();
      const int slot = c % kStages;
#pragma unroll
      for (int kk = 0; kk < kMmaK / 32; ++kk) {
        const uint8_t* p = &xs[slot][g][kk * 32 + t * 4];
        const uint32_t a[4] = {binarize4(ld_u32(p), thr4, all_on),
                               binarize4(ld_u32(p + 8 * kRow), thr4, all_on),
                               binarize4(ld_u32(p + 16), thr4, all_on),
                               binarize4(ld_u32(p + 8 * kRow + 16), thr4, all_on)};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint8_t* col = &ws[slot][16 * warp + 8 * j + g][kk * 32 + t * 4];
          const uint32_t b[2] = {ld_u32(col), ld_u32(col + 16)};
          mma_s8(acc[j], a, b);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring before it is refilled

    // Strict step: c0, c1 at row g, units 2t, 2t+1 of tile j; c2, c3 at row g+8.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int u = n0 - u0 + 16 * warp + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint8_t* o = hs + (g + 8 * h) * slice + u;
        o[0] = acc[j][2 * h] > 0;
        o[1] = acc[j][2 * h + 1] > 0;
      }
    }
  }
  __syncthreads();

  // Layer 2 over the block's units (hidden activations and w2 past u_end
  // are 0).
  for (int i = threadIdx.x; i < kTM * O; i += kMmaThreads) {
    const int r = i / O;
    const int o = i % O;
    const int8_t* wc = w2s + o * slice;
    const uint8_t* hr = hs + r * slice;
    uint32_t sum = 0u;
#pragma unroll 8
    for (int u = 0; u < slice; ++u) sum += hr[u] ? static_cast<uint32_t>(wc[u]) : 0u;
    part[i] = static_cast<int>(sum);
  }
  cluster.sync();

  if (rank == 0 && threadIdx.x < kTM && row0 + static_cast<int>(threadIdx.x) < B) {
    const int r = threadIdx.x;
    int best_v = 0;
    int best_i = 0;
    for (int o = 0; o < O; ++o) {
      uint32_t sum = 0u;
      for (int q = 0; q < kCluster; ++q)
        sum += static_cast<uint32_t>(cluster.map_shared_rank(part, q)[r * O + o]);
      const int v = static_cast<int>(sum);
      if (o == 0 || v > best_v) {
        best_v = v;
        best_i = o;
      }
    }
    out[row0 + r] = best_i;
  }
  cluster.sync();
}

template <int VEC>
cudaError_t launch_fused_mma(const void* x, int B, int K, int threshold, const void* w1, int ld1,
                             int H, const void* w2, int ld2, int O, void* out, size_t smem,
                             cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_mma_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(kCluster, (B + kTM - 1) / kTM);
  fused_mma_kernel<VEC><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const uint8_t*>(x), B, K, threshold, static_cast<const int8_t*>(w1), ld1, H,
      static_cast<const int8_t*>(w2), ld2, O, static_cast<int32_t*>(out));
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

// Bytes of dynamic shared memory of a tensor-core block (H hidden, O classes).
long long fmlp_mma_smem_bytes(int H, int O) { return static_cast<long long>(mma_smem(H, O)); }

// x uint8 (B, K); w1 int8 (K, H) K-contiguous with column stride ld1 (ld1 and
// w1 16-byte aligned); w2 int8 (H, O) H-contiguous with column stride ld2:
// the int8 tensor-core route. Returns a cudaError_t.
int fmlp_predict_mma(const void* x, int B, int K, int threshold, const void* w1, int ld1, int H,
                     const void* w2, int ld2, int O, void* out, int device, void* stream) {
  const bool layout = K == 0 || H == 0 ||
                      (ld1 >= K && ld1 % 16 == 0 && reinterpret_cast<uintptr_t>(w1) % 16 == 0);
  if (B <= 0 || K < 0 || H < 0 || O < 1 || !layout || (O > 1 && ld2 < H))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  const size_t smem = mma_smem(H, O);
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t p = reinterpret_cast<uintptr_t>(x);
  if (K % 16 == 0 && p % 16 == 0)
    return launch_fused_mma<16>(x, B, K, threshold, w1, ld1, H, w2, ld2, O, out, smem, s);
  if (K % 4 == 0 && p % 4 == 0)
    return launch_fused_mma<4>(x, B, K, threshold, w1, ld1, H, w2, ld2, O, out, smem, s);
  return launch_fused_mma<1>(x, B, K, threshold, w1, ld1, H, w2, ld2, O, out, smem, s);
}

}  // extern "C"
