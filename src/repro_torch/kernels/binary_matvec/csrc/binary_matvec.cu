// Binary-activation matmul kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Activations are {0,1}. A layer y = x . w is then a masked column sum, the
// rows of w selected by the set activations added up. The kernels differ in
// how the operands travel:
//
//   matmul_mma_kernel     y = x . w on the int8 tensor cores, for weights that
//                         fit int8, with one of two loaders of the activation
//                         tile: DenseRows (x int8 (B, K), nonzero meaning 1)
//                         replaces the Pallas kernel binary_matmul
//                         (src/repro/kernels/binary_matvec/binary_matvec.py:77,
//                         _binary_matmul_kernel); PackedRows (x packed 32 to a
//                         little-endian uint32 word, bit i of word j is unit
//                         32j+i) replaces binary_matmul_packed (same file,
//                         :134, _binary_matmul_packed_kernel).
//   matmul_dense_kernel   the same two functions with int32 weights, one
//   matmul_packed_kernel  predicated 32-bit add per (row, k, column): the
//                         route for weights that do not fit int8.
//   matmul_planes_mma_kernel
//                         both operands packed: w split into signed bit-planes,
//                         w = sum_b 2^b (pos_b - neg_b), each plane packed along
//                         fan_in like x, so one layer is
//                             y[r, n] = sum_b 2^b sum_w (popc(x[r, w] & pos[b, w, n])
//                                                        - popc(x[r, w] & neg[b, w, n])),
//                         on the 1-bit tensor cores (mma.sync m16n8k256
//                         b1.and.popc). Replaces binary_matmul_planes
//                         (_binary_matmul_planes_kernel).
//   forward_planes_mma_kernel
//                         the whole planes-form net in one launch, of any
//   forward_planes_kernel depth: binarize, per layer the planes product, a
//                         strict step and repack, argmax. The layer table
//                         lies in device memory, built once with the
//                         predictor. The first runs each layer on the 1-bit
//                         tensor cores with a hidden layer's units split
//                         across a thread-block cluster; the second, one
//                         thread per unit with scalar __popc, is the route
//                         for nets whose activations the first cannot hold
//                         in shared memory. Both replace binary_forward_planes
//                         (_forward_planes_kernel).
//
// Every kernel accumulates in 32-bit integers that wrap exactly as the int32
// reference does (the tensor-core product has no .satfinite).
//
// What bounds them on an H100. The tensor-core kernel computes x in {0,1}
// times int8 w exactly with mma.sync m16n8k32 s8.s8.s32. One 784-500-10
// layer-1 pass at 256 rows is 0.2 G int8 operations (0.1 us at 1,979 TOP/s)
// against 1.1 MB of operands (0.33 us at 3.35 TB/s): bytes bound it, and in
// practice the launch and the latency of the K sweep do. So wgmma, TMA and
// warp specialisation would buy nothing at this size; the design keeps the
// sweep short and the loads in flight instead: K in chunks of kMmaK bytes,
// both operands double-buffered in shared memory by cp.async, 32 x 32 output
// tiles (128 blocks at layer 1), weights read as int8 (a quarter of the
// int32 bytes) from a copy laid out K-contiguous per column (as the B
// operand wants it), made once when the predictor is built: transposing
// the (K, N) weights inside the kernel, through byte loads, cost more
// than the rest of the kernel together.
// The scalar kernels do one select and one add per (row, k, column); 32-bit
// integer add issues at 64 results per clock per SM (CUDA C++ Programming
// Guide, arithmetic instruction throughput, compute capability 9.0): ~100 M
// adds at layer 1, so the adds set their floor. The scalar designs stage a
// tile of BM rows in shared memory, read as warp broadcasts, and each thread
// owns one output column and reads each weight word once per tile,
// coalesced along the column axis, for BM rows.
// The planes product is what the 1-bit tensor cores compute: AND, then
// popcount summed over 256 bits of K, for a 16 x 8 tile per instruction.
// NVIDIA publishes no b1 rate for the H100, so its bound is by bytes
// (0.94 MB at layer 1, 0.28 us); like the int8 product it is bound in
// practice by the launch and the latency of the K sweep, and shares its
// design: 32 x 32 output tiles, operands double-buffered by cp.async, and
// planes read from a copy laid out K-contiguous per column (the B operand's
// layout), made once when the predictor is built.
// The whole-net forward_planes_mma_kernel does the same product per layer
// and keeps the activations on chip: 0.4 MB of layer-1 planes a model and
// 0.2 MB of images at 256 rows, bound by bytes (0.55 us for 3 models) and in
// practice by the latency of each layer's loads and of the cluster barriers
// between layers. Its design: a cluster of up to 8 blocks shares a tile of
// 16 or 32 rows, each block computing a slice of a hidden layer's units, so
// a model's planes are read once per row tile and the grid fills the card
// (128 blocks at B = 256; the wrapper takes the largest cluster whose grid
// the card holds in one wave); a block copies the planes of 32 columns at
// a time (every plane and word) into shared memory by bulk asynchronous
// copies, the next 32 while it computes these, so a stage's loads are in
// flight together (B fragments loaded into registers a few steps ahead
// left each step waiting about a whole L2 latency); each block packs its
// step bits and writes them into every block's next-layer buffer through
// distributed shared memory. The scalar forward_planes_kernel keeps __popc
// (16 results per clock per SM).

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// matmul: the K sweep runs inside the block in chunks of this many words
// (packed) or bytes (dense), staged in shared memory, so the grid needs no
// reduction across blocks.
constexpr int kChunkWords = 32;
constexpr int kDenseChunk = 256;
// The widest column tile (bn) a matmul block takes. The dense and packed
// kernels are compiled to launch with this many threads at every BM (their
// registers are capped to fit).
constexpr int kMaxBlockThreads = 1024;

// forward: threads per block (ops.py mirrors it as FORWARD_WARPS).
constexpr int kForwardThreads = 256;
constexpr int kForwardWarps = kForwardThreads / kWarp;

// One row of the forward kernel's layer table, which lies in device memory
// (any depth; ops.forward_table builds it, 32 bytes a layer, in this order).
// The scalar kernel reads planes row-major, word (b, w, n) at
// (b * W + w) * N + n; the tensor-core kernel K-contiguous per column, word
// (b, w, n) at (b * N + n) * ldw + w. Stacked, model m starts P W N or
// P N ldw words further on.
struct PlaneLayer {
  const uint32_t* pos;  // (P, W, N) words, or (M, P, W, N) when stacked
  const uint32_t* neg;
  int planes;           // P
  int words;            // W: packed fan_in
  int units;            // N: fan_out (hidden layers: a multiple of 32)
  int ldw;              // column stride in words (the tensor-core layout)
};
static_assert(sizeof(PlaneLayer) == 32, "ops.forward_table writes 32-byte rows");

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

// ---- the int8 tensor-core product ------------------------------------------

// Threads of a tensor-core block (4 warps), the K bytes staged per chunk (8
// steps of the m16n8k32 product), the slots of the cp.async ring, the
// columns of one sub-tile, and the staged row length: 16 bytes of padding
// make a row 68 words, so the fragment reads of a warp (8 rows x 4 words)
// hit 32 distinct banks. Of the chunks (64-256) and ring depths (2-6)
// tried on an H100 at layer 1 (K = 784), 256 x 2 was the fastest.
constexpr int kMmaThreads = 128;
constexpr int kMmaK = 256;
constexpr int kMmaStages = 2;
constexpr int kMmaN = 32;
constexpr int kMmaRow = kMmaK + 16;

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

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u32(const uint8_t* p) {
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

// Each byte of v as 1 when it is nonzero, else 0: bit 7 of a byte is set
// after the add iff its low 7 bits are nonzero (no carry leaves the byte).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t v) {
  return ((((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) >> 7) & 0x01010101u;
}

// Bits shift..shift+3 of a word as four {0,1} bytes, bit shift+i in byte i:
// the multiply places the nibble's bits 0-3 at bits 0, 8, 16, 24 (the four
// shifted copies do not overlap, so nothing carries).
__device__ __forceinline__ uint32_t bits_to_bytes(uint32_t word, int shift) {
  return (((word >> shift) & 0xfu) * 0x00204081u) & 0x01010101u;
}

// The two loaders of the activation tile. Each stages TM rows x kMmaK units
// of K starting at (row0, k0) into ring slot `slot` (rows past B and K past
// the end are 0), and builds a warp's A fragment of m16n8k32 for rows
// r0..r0+15 and K step kk of the chunk: lane (g, t) = (lane / 4, lane % 4)
// holds rows g and g+8 at K t*4..t*4+3 and 16+t*4..16+t*4+3, a byte per K.

// x int8 (B, K), nonzero meaning 1. The raw bytes are staged, VEC at a time
// (cp.async when VEC is 4 or 16: K % VEC == 0, so a vector lies wholly in or
// past K), and made exactly {0,1} as the fragment is built.
template <int TM, int VEC>
struct DenseRows {
  using T = uint8_t;
  struct Tile {
    __align__(16) uint8_t b[kMmaStages][TM][kMmaRow];
  };
  static __device__ __forceinline__ void stage(Tile& s, int slot, const uint8_t* x, int B,
                                               int K, int row0, int k0) {
    constexpr int per_row = kMmaK / VEC;
    for (int i = threadIdx.x; i < TM * per_row; i += kMmaThreads) {
      const int r = i / per_row;
      const int c = (i % per_row) * VEC;
      const int row = row0 + r;
      const int k = k0 + c;
      const bool valid = row < B && k < K;
      const uint8_t* src = valid ? x + static_cast<size_t>(row) * K + k : x;
      uint8_t* dst = &s.b[slot][r][c];
      if constexpr (VEC == 16) {
        cp_async16(dst, src, valid ? 16 : 0);
      } else if constexpr (VEC == 4) {
        cp_async4(dst, src, valid ? 4 : 0);
      } else {
        *dst = valid ? *src : 0u;
      }
    }
  }
  static __device__ __forceinline__ void fragment(const Tile& s, int slot, int r0, int kk, int g,
                                                  int t, uint32_t (&a)[4]) {
    const uint8_t* p = &s.b[slot][r0 + g][kk * 32 + t * 4];
    a[0] = nonzero_bytes(ld_shared_u32(p));
    a[1] = nonzero_bytes(ld_shared_u32(p + 8 * kMmaRow));
    a[2] = nonzero_bytes(ld_shared_u32(p + 16));
    a[3] = nonzero_bytes(ld_shared_u32(p + 8 * kMmaRow + 16));
  }
};

// x packed (B, KW) words. One K step of 32 is one word, so the words are
// staged by cp.async (kMmaK / 32 a row) and each fragment register unpacks
// four bits of a word into four {0,1} bytes. Bits are tested on uint32_t.
template <int TM>
struct PackedRows {
  using T = uint32_t;
  struct Tile {
    uint32_t w[kMmaStages][TM][kMmaK / 32];
  };
  static __device__ __forceinline__ void stage(Tile& s, int slot, const uint32_t* x, int B,
                                               int KW, int row0, int k0) {
    constexpr int per_row = kMmaK / 32;
    for (int i = threadIdx.x; i < TM * per_row; i += kMmaThreads) {
      const int r = i / per_row;
      const int c = i % per_row;
      const int row = row0 + r;
      const int word = k0 / 32 + c;
      const bool valid = row < B && word < KW;
      cp_async4(&s.w[slot][r][c], valid ? x + static_cast<size_t>(row) * KW + word : x,
                valid ? 4 : 0);
    }
  }
  static __device__ __forceinline__ void fragment(const Tile& s, int slot, int r0, int kk, int g,
                                                  int t, uint32_t (&a)[4]) {
    const uint32_t lo = s.w[slot][r0 + g][kk];
    const uint32_t hi = s.w[slot][r0 + g + 8][kk];
    a[0] = bits_to_bytes(lo, 4 * t);
    a[1] = bits_to_bytes(hi, 4 * t);
    a[2] = bits_to_bytes(lo, 16 + 4 * t);
    a[3] = bits_to_bytes(hi, 16 + 4 * t);
  }
};

// The weight tile of one chunk, kMmaK rows of K x kMmaN columns, from int8 w
// laid out K-contiguous: column n starts at w + n * ldw (ldw and w 16-byte
// aligned), as the B operand of m16n8k32.col wants it. 16 bytes of K per
// cp.async; the copy stops at K and zero-fills the rest, and columns past N
// are 0.
__device__ __forceinline__ void stage_w(uint8_t (*ws)[kMmaRow], const uint8_t* w, int ldw, int K,
                                        int N, int k0, int n0) {
  constexpr int per_col = kMmaK / 16;
  for (int i = threadIdx.x; i < kMmaN * per_col; i += kMmaThreads) {
    const int n = i / per_col;
    const int c = (i % per_col) * 16;
    const int col = n0 + n;
    const int k = k0 + c;
    const int bytes = (col < N && k < K) ? min(16, K - k) : 0;
    cp_async16(&ws[n][c], bytes ? w + static_cast<size_t>(col) * ldw + k : w, bytes);
  }
}

// y = x . w on the int8 tensor cores: x through loader A (`kx` units a row:
// K bytes, or KW words), w int8 (K, N) K-contiguous with column stride ldw,
// K = kx or 32 kx, y int32 (B, N). Grid: (ceil(B / TM), ceil(N / tn)). A
// block owns TM rows and tn columns and walks them in sub-tiles of kMmaN
// columns; per sub-tile each warp owns a 16 x (8 TM / 16) slab of the output
// (TM = 16: warp w has columns 8w..8w+7; TM = 32: rows 16 (w % 2), columns
// 16 (w / 2)). K is swept in chunks of kMmaK through a ring of kMmaStages
// slots: while the tensor cores work on one chunk, the next ones are in
// flight by cp.async.
template <int TM, class A>
__global__ void __launch_bounds__(kMmaThreads)
    matmul_mma_kernel(const typename A::T* __restrict__ x, const uint8_t* __restrict__ w,
                      int ldw, int32_t* __restrict__ out, int B, int kx, int K, int N, int tn) {
  constexpr int NT = TM / 16;  // n8 tiles per warp
  __shared__ typename A::Tile xs;
  __shared__ __align__(16) uint8_t ws[kMmaStages][kMmaN][kMmaRow];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = (warp % NT) * 16;
  const int c0 = (warp / NT) * NT * 8;
  const int row0 = blockIdx.x * TM;
  const int col0 = static_cast<int>(blockIdx.y) * tn;
  const int n_end = min(N, col0 + tn);
  const int chunks = (K + kMmaK - 1) / kMmaK;

  for (int n0 = col0; n0 < n_end; n0 += kMmaN) {
    int acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

    // One commit group per chunk, empty past the last, so that waiting for
    // all but kMmaStages - 2 groups means chunk c has landed.
#pragma unroll
    for (int c = 0; c < kMmaStages - 1; ++c) {
      if (c < chunks) {
        A::stage(xs, c, x, B, kx, row0, c * kMmaK);
        stage_w(ws[c], w, ldw, K, N, c * kMmaK, n0);
      }
      cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<kMmaStages - 2>();
      __syncthreads();
      // The slot refilled here was read in iteration c - 1, which every
      // warp has left at the barrier above.
      const int next = c + kMmaStages - 1;
      if (next < chunks) {
        A::stage(xs, next % kMmaStages, x, B, kx, row0, next * kMmaK);
        stage_w(ws[next % kMmaStages], w, ldw, K, N, next * kMmaK, n0);
      }
      cp_async_commit();
      const int slot = c % kMmaStages;
#pragma unroll
      for (int kk = 0; kk < kMmaK / 32; ++kk) {
        uint32_t a[4];
        A::fragment(xs, slot, r0, kk, g, t, a);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint8_t* col = &ws[slot][c0 + 8 * j + g][kk * 32 + t * 4];
          const uint32_t b[2] = {ld_shared_u32(col), ld_shared_u32(col + 16)};
          mma_s8(acc[j], a, b);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring before it is refilled

    // c0, c1 at row g, columns 2t, 2t+1; c2, c3 at row g + 8.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + c0 + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + r0 + g + 8 * h;
        if (row >= B) continue;
        int32_t* o = out + static_cast<size_t>(row) * N + col;
        if (col < N) o[0] = acc[j][2 * h];
        if (col + 1 < N) o[1] = acc[j][2 * h + 1];
      }
    }
  }
}

// ---- the scalar products (int32 weights) ------------------------------------

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

// ---- the bit-plane product on the 1-bit tensor cores -------------------------

// Words of K staged per chunk (one m16n8k256 step), the slots of the ring,
// and the staged row length in words: 12 words make the fragment reads of
// a warp (8 rows x 4 words) hit 32 distinct banks, and keep each row's
// start 16-byte aligned for cp.async.
constexpr int kPlaneWords = 8;
constexpr int kPlaneStages = 2;
constexpr int kPlaneRow = 12;

// d = popc(a AND b) for one m16n8k256 tile from a zero sum: a 16x256 bits
// (row), b 256x8 bits (col), d s32.
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(0));
}

// Dynamic shared memory of a planes block: per ring slot, TM x kPlaneRow
// words of x and 2P x kMmaN x kPlaneRow words of planes (pos_b, neg_b for
// each b). ops.py mirrors it as `planes_smem_bytes`.
__host__ __device__ constexpr size_t planes_smem(int tm, int P) {
  return static_cast<size_t>(kPlaneStages) * (tm + 2 * P * kMmaN) * kPlaneRow * sizeof(uint32_t);
}

// y = x . planes on the 1-bit tensor cores: x (B, KW) words, pos/neg planes
// (P, KW, N) with word (b, w, n) at b * lp + n * ldw + w (K-contiguous per
// column; lp, ldw and the base 16-byte aligned), y int32 (B, N). Grid and
// warp layout as matmul_mma_kernel: TM rows and tn columns per block, walked
// in sub-tiles of kMmaN columns; K in chunks of kPlaneWords words through a
// ring of kPlaneStages slots filled by cp.async (x 4 bytes a copy, its rows
// are not aligned; planes 16). Per chunk and plane b, each warp forms
// popc(x & pos_b) and popc(x & neg_b) from zero sums, and adds
// (pos - neg) << b to its uint32 totals: the shift and the adds distribute
// over the chunks modulo 2^32, so the totals wrap exactly as the int32
// reference does, for any P, with two temporary fragments per n8 tile.
template <int TM>
__global__ void __launch_bounds__(kMmaThreads)
    matmul_planes_mma_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ pos,
                             const uint32_t* __restrict__ neg, long long lp, int ldw,
                             int32_t* __restrict__ out, int B, int KW, int P, int N, int tn) {
  constexpr int NT = TM / 16;
  extern __shared__ __align__(16) uint32_t plane_smem[];
  const int slot_words = (TM + 2 * P * kMmaN) * kPlaneRow;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = (warp % NT) * 16;
  const int c0 = (warp / NT) * NT * 8;
  const int row0 = blockIdx.x * TM;
  const int col0 = static_cast<int>(blockIdx.y) * tn;
  const int n_end = min(N, col0 + tn);
  const int chunks = (KW + kPlaneWords - 1) / kPlaneWords;

  // Stages chunk c of x rows row0.. and of every plane's columns n0.. into
  // ring slot `slot`; words past KW, rows past B and columns past N are 0.
  auto stage = [&](int slot, int c, int n0) {
    uint32_t* xs = plane_smem + slot * slot_words;
    uint32_t* ws = xs + TM * kPlaneRow;
    const int w0 = c * kPlaneWords;
    for (int i = threadIdx.x; i < TM * kPlaneWords; i += kMmaThreads) {
      const int r = i / kPlaneWords;
      const int w = w0 + i % kPlaneWords;
      const bool valid = row0 + r < B && w < KW;
      cp_async4(&xs[r * kPlaneRow + i % kPlaneWords],
                valid ? x + static_cast<size_t>(row0 + r) * KW + w : x, valid ? 4 : 0);
    }
    // (plane-sign s, column n, half h): 16 bytes of words w0 + 4h.
    for (int i = threadIdx.x; i < 2 * P * kMmaN * 2; i += kMmaThreads) {
      const int h = i % 2;
      const int n = (i / 2) % kMmaN;
      const int s = i / (2 * kMmaN);
      const int col = n0 + n;
      const int w = w0 + 4 * h;
      const int bytes = col < N ? 4 * max(0, min(4, KW - w)) : 0;
      const uint32_t* src = (s % 2 ? neg : pos) + (s / 2) * lp + static_cast<size_t>(col) * ldw + w;
      cp_async16(&ws[(s * kMmaN + n) * kPlaneRow + 4 * h], bytes ? src : pos, bytes);
    }
  };

  for (int n0 = col0; n0 < n_end; n0 += kMmaN) {
    uint32_t acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0u;

#pragma unroll
    for (int c = 0; c < kPlaneStages - 1; ++c) {
      if (c < chunks) stage(c, c, n0);
      cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<kPlaneStages - 2>();
      __syncthreads();
      const int next = c + kPlaneStages - 1;
      if (next < chunks) stage(next % kPlaneStages, next, n0);
      cp_async_commit();
      const uint32_t* xs = plane_smem + (c % kPlaneStages) * slot_words;
      const uint32_t* ws = xs + TM * kPlaneRow;
      // a0/a1: rows g, g+8 at word t; a2/a3: the same rows at word 4+t.
      const uint32_t a[4] = {xs[(r0 + g) * kPlaneRow + t], xs[(r0 + g + 8) * kPlaneRow + t],
                             xs[(r0 + g) * kPlaneRow + 4 + t],
                             xs[(r0 + g + 8) * kPlaneRow + 4 + t]};
      for (int b = 0; b < P; ++b) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = c0 + 8 * j + g;
          const uint32_t* p = &ws[((2 * b) * kMmaN + n) * kPlaneRow];
          const uint32_t* q = &ws[((2 * b + 1) * kMmaN + n) * kPlaneRow];
          const uint32_t bp[2] = {p[t], p[4 + t]};
          const uint32_t bq[2] = {q[t], q[4 + t]};
          int dp[4], dq[4];
          mma_b1(dp, a, bp);
          mma_b1(dq, a, bq);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += static_cast<uint32_t>(dp[i] - dq[i]) << b;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring before it is refilled

#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + c0 + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + r0 + g + 8 * h;
        if (row >= B) continue;
        int32_t* o = out + static_cast<size_t>(row) * N + col;
        if (col < N) o[0] = static_cast<int32_t>(acc[j][2 * h]);
        if (col + 1 < N) o[1] = static_cast<int32_t>(acc[j][2 * h + 1]);
      }
    }
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
                          const PlaneLayer* __restrict__ net, int depth, int n_classes,
                          int max_words, int32_t* __restrict__ out) {
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
  const int w0 = net[0].words;
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

  for (int l = 0; l < depth; ++l) {
    const PlaneLayer L = net[l];
    const bool last = l + 1 == depth;
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

// ---- the whole net on the 1-bit tensor cores, across a cluster ---------------

// Threads of a block (4 warps), the largest cluster, and the columns of one
// stage of staged planes (one n8 tile per warp).
constexpr int kFwdThreads = 128;
constexpr int kFwdWarps = kFwdThreads / kWarp;
constexpr int kMaxCluster = 8;
constexpr int kFwdCols = 8 * kFwdWarps;

// Row stride in words of an activation buffer: the widest layer rounded up
// to whole m16n8k256 steps, then to 8 mod 16, so that a half-warp's 8-byte
// fragment reads (4 rows x 4 lanes) hit 32 distinct banks.
__host__ __device__ constexpr int forward_mma_ldx(int words) {
  return (words + 7) / 8 * 8 % 16 ? (words + 7) / 8 * 8 : (words + 7) / 8 * 8 + 8;
}

// Column stride in words of the planes, in device memory and staged alike
// (the plane_mma_weights layout): W rounded up to whole steps and no
// further, so a stage's columns of one plane and sign are one contiguous
// run, copied by one bulk copy. Padding to 8 mod 16 as above would spare
// the B reads a 4-way bank conflict at W = 25, but makes a 784-500-10 block
// 85 KB, two blocks an SM; unpadded it is 70 KB, three an SM.
__host__ __device__ constexpr int forward_mma_lds(int words) { return (words + 7) / 8 * 8; }

// Dynamic shared memory of a tensor-core forward block, in this order: two
// activation buffers of tm rows (this layer's input, the next one's), the
// per-warp argmax partials, the two stage slots' mbarriers (16 bytes), and
// the two stage slots of `stage_words` words each (the largest layer's 2P x
// kFwdCols plane columns). ops.py mirrors it as `forward_mma_smem_bytes`.
__host__ __device__ constexpr size_t forward_mma_smem(int tm, int max_words, int stage_words) {
  return (2 * static_cast<size_t>(tm) * forward_mma_ldx(max_words) + 2 * kFwdWarps * tm + 4 +
          2 * static_cast<size_t>(stage_words)) *
         sizeof(uint32_t);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits for the phase of parity `parity` of an mbarrier to complete; traps
// after about ten seconds of SM clock, so a fault shows as a launch error
// and never as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) asm volatile("trap;");
  }
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Four pixels > threshold as four bits, pixel i at bit i: `thr4` holds the
// threshold clamped to 0..255 in every byte, `all_on` a threshold below 0.
// The multiply moves byte j's flag (bit 8j) to bit 28 + j; its 16 partial
// products land on distinct bits, so nothing carries.
__device__ __forceinline__ uint32_t pixel_bits4(uint32_t v, uint32_t thr4, bool all_on) {
  return all_on ? 0xfu : (((__vcmpgtu4(v, thr4) & 0x01010101u) * 0x10204080u) >> 28);
}

// Binarizes and packs TM rows of x (rows past B and pixels past K are 0)
// into dst, `words` words a row at row stride ldx. Each lane tests VEC
// pixels (one 16-, 4- or 1-byte load), and the 32 / VEC lanes of a word
// OR their bits together with shuffles. A thread issues kBinarizeBatch
// loads before it tests any, so their latencies overlap. TM * words *
// (32 / VEC) is a multiple of 32, so every lane of a warp takes part in
// each shuffle.
constexpr int kBinarizeBatch = 8;

template <int VEC>
struct PixelLoad {
  using T = uint32_t;
  static __device__ __forceinline__ T load(const uint8_t* p) {
    if constexpr (VEC == 4) return __ldg(reinterpret_cast<const uint32_t*>(p));
    return *p;
  }
  static __device__ __forceinline__ uint32_t bits(T v, int threshold, uint32_t thr4, bool all_on) {
    if constexpr (VEC == 4) return pixel_bits4(v, thr4, all_on);
    return static_cast<int>(v) > threshold;
  }
};

template <>
struct PixelLoad<16> {
  using T = uint4;
  static __device__ __forceinline__ T load(const uint8_t* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ uint32_t bits(T v, int, uint32_t thr4, bool all_on) {
    return pixel_bits4(v.x, thr4, all_on) | pixel_bits4(v.y, thr4, all_on) << 4 |
           pixel_bits4(v.z, thr4, all_on) << 8 | pixel_bits4(v.w, thr4, all_on) << 12;
  }
};

template <int TM, int VEC>
__device__ __forceinline__ void binarize_rows(uint32_t* dst, int ldx, const uint8_t* x, int B,
                                              int K, int threshold, int row0, int words) {
  using Load = PixelLoad<VEC>;
  constexpr int kLanes = kWarp / VEC;
  const bool all_on = threshold < 0;
  const uint32_t thr4 = static_cast<uint32_t>(min(max(threshold, 0), 255)) * 0x01010101u;
  const int total = TM * words * kLanes;
  for (int base = threadIdx.x; base < total; base += kBinarizeBatch * kFwdThreads) {
    typename Load::T v[kBinarizeBatch];
    bool valid[kBinarizeBatch];
#pragma unroll
    for (int j = 0; j < kBinarizeBatch; ++j) {
      const int i = base + j * kFwdThreads;
      const int row = row0 + i / kLanes / words;
      const int k = i / kLanes % words * kWarp + i % kLanes * VEC;
      valid[j] = i < total && row < B && k < K;
      if (valid[j]) v[j] = Load::load(x + static_cast<size_t>(row) * K + k);
    }
#pragma unroll
    for (int j = 0; j < kBinarizeBatch; ++j) {
      const int i = base + j * kFwdThreads;
      if (i < total) {  // warp-uniform
        const int sub = i % kLanes;
        uint32_t bits = valid[j] ? Load::bits(v[j], threshold, thr4, all_on) << (sub * VEC) : 0u;
#pragma unroll
        for (int o = 1; o < kLanes; o *= 2) bits |= __shfl_xor_sync(kFullMask, bits, o);
        if (sub == 0) dst[i / kLanes / words * ldx + i / kLanes % words] = bits;
      }
    }
  }
}

// The units of layer l that block `rank` of `blocks` computes: hidden
// layers split N in whole words, rank-major; the final layer runs on rank 0
// alone, over its n_classes columns. Empty when u0 >= n_end.
__device__ __forceinline__ void forward_units(const PlaneLayer& L, bool last, int rank,
                                              int blocks, int n_classes, int& u0, int& n_end) {
  if (last) {
    u0 = 0;
    n_end = rank == 0 ? n_classes : 0;
  } else {
    const int slice = (L.units / kWarp + blocks - 1) / blocks * kWarp;
    u0 = rank * slice;
    n_end = min(L.units, u0 + slice);
  }
}

// The whole planes-form net on the 1-bit tensor cores. Grid (cluster, ceil(B /
// TM), M), clusters along x: the blocks of a cluster share TM rows of model
// blockIdx.z. Each block
//   1. binarizes and packs the tile's images into activation buffer 0;
//   2. per hidden layer, computes its slice of the units (ceil(N / 32 /
//      cluster) words each, rank-major) in stages of kFwdCols columns: a
//      stage's planes (all P, both signs, every word of K; 2P contiguous
//      runs) are copied into a shared-memory slot by 2P bulk asynchronous
//      copies that one thread issues, completing on the slot's mbarrier,
//      while the stage before is computed (the first stage while the
//      images are binarized); warp w computes the stage's n8 tile w over
//      (8-word chunk, plane) steps on m16n8k256 b1.and.popc, summing
//      (pos - neg) << b in uint32, so the sums wrap as the int32 reference
//      does;
//   3. steps its units (> 0), packs 8 units of a row into a byte (lane (g,
//      t) of the C fragment holds units 2t, 2t+1 of rows g and g + 8; two
//      shuffles OR the four lanes' bits), and stores each byte into every
//      block's next buffer through distributed shared memory (bit i of word
//      j is unit 32j + i, as the planes' K runs); a cluster barrier then
//      makes the next layer's whole input visible in every block;
//   4. the final layer runs on rank 0 alone, over its n_classes columns, and
//      rank 0 takes the argmax, the first maximum winning.
// Lane t's fragment words are words 2t and 2t + 1 of a step (K order is free
// within a step as long as A and B agree), so each is one 8-byte load. Words
// at or past W read as 0 in A, so the planes' padding words add nothing;
// columns past a final layer's classes are not copied, and their scores are
// never read. Stages run across layer boundaries: a layer's planes do not
// depend on the activations, so the next layer's first stage is in flight
// during the cluster barrier.
template <int TM, int VEC>
__global__ void __launch_bounds__(kFwdThreads)
    forward_planes_mma_kernel(const uint8_t* __restrict__ x, int B, int K, int threshold,
                              const PlaneLayer* __restrict__ net, int depth, int n_classes,
                              int ldx, int stage_words, int32_t* __restrict__ out) {
  constexpr int MT = TM / 16;  // m16 tiles a warp computes per n8 tile
  extern __shared__ __align__(16) uint32_t fwd_smem[];
  uint32_t* act0 = fwd_smem;
  uint32_t* act1 = fwd_smem + TM * ldx;
  int* part_v = reinterpret_cast<int*>(fwd_smem + 2 * TM * ldx);
  int* part_i = part_v + kFwdWarps * TM;
  uint64_t* full = reinterpret_cast<uint64_t*>(part_i + kFwdWarps * TM);
  uint32_t* slots = reinterpret_cast<uint32_t*>(full + 2);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int m = blockIdx.z;
  const int row0 = blockIdx.y * TM;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane / 4;
  const int t = lane % 4;

  // The next stage to copy: layer sl, columns sn.. (sl == depth: none).
  // Every thread moves the cursor; lanes of warp 0 issue the copies, one
  // each (one thread issuing all of them in turn was measurably slower).
  int sl = 0;
  int sn = 0;
  int s_end = 0;
  forward_units(net[0], depth == 1, rank, blocks, n_classes, sn, s_end);
  int staged = 0;  // stages issued so far; stage k fills slot k % 2
  auto issue = [&]() {
    while (sl < depth && sn >= s_end) {
      if (++sl < depth) forward_units(net[sl], sl + 1 == depth, rank, blocks, n_classes, sn, s_end);
    }
    if (sl == depth) return;
    if (warp == 0) {
      const PlaneLayer L = net[sl];
      const int lds = forward_mma_lds(L.words);
      const uint32_t run = static_cast<uint32_t>(min(kFwdCols, s_end - sn) * lds * 4);
      const size_t plane_stride = static_cast<size_t>(L.units) * lds;
      const size_t first = m * L.planes * plane_stride + static_cast<size_t>(sn) * lds;
      uint32_t* slot = slots + (staged % 2) * stage_words;
      uint64_t* bar = full + staged % 2;
      if (lane == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                     "r"(2 * L.planes * run)
                     : "memory");
      }
      __syncwarp();
      for (int q = lane; run > 0 && q < 2 * L.planes; q += kWarp) {  // q = 2 b + sign
        bulk_load(slot + q * kFwdCols * lds, (q % 2 ? L.neg : L.pos) + first + (q / 2) * plane_stride,
                  run, bar);
      }
    }
    ++staged;
    sn += kFwdCols;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(full + i)));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  issue();
  binarize_rows<TM, VEC>(act0, ldx, x + static_cast<size_t>(m) * B * K, B, K, threshold, row0,
                         net[0].words);
  // Also: every block of the cluster has started before any writes to it.
  cluster.sync();

  int best_v[MT][2];
  int best_i[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    best_v[mt][0] = best_v[mt][1] = INT_MIN;
    best_i[mt][0] = best_i[mt][1] = INT_MAX;
  }

  int used = 0;  // stages computed so far
  for (int l = 0; l < depth; ++l) {
    const bool last = l + 1 == depth;
    if (last && rank != 0) return;
    const PlaneLayer L = net[l];
    const uint32_t* cur = l % 2 ? act1 : act0;
    uint8_t* nxt = reinterpret_cast<uint8_t*>(l % 2 ? act0 : act1);
    const int lds = forward_mma_lds(L.words);
    const int chunks = (L.words + 7) / 8;
    int u0, n_end;
    forward_units(L, last, rank, blocks, n_classes, u0, n_end);

    for (int n0 = u0; n0 < n_end; n0 += kFwdCols) {
      issue();  // into the slot every warp left at the barrier closing the last stage
      mbar_wait(full + used % 2, (used / 2) % 2);
      const uint32_t* ws = slots + (used % 2) * stage_words;
      ++used;
      const int nt = n0 + 8 * warp;  // this warp's n8 tile
      if (nt < n_end) {
        uint32_t acc[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0u;
        for (int c = 0; c < chunks; ++c) {
          const int wd = 8 * c + 2 * t;
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int r = mt * 16 + g;
            const uint2 lo = *reinterpret_cast<const uint2*>(cur + r * ldx + wd);
            const uint2 hi = *reinterpret_cast<const uint2*>(cur + (r + 8) * ldx + wd);
            a[mt][0] = wd < L.words ? lo.x : 0u;
            a[mt][1] = wd < L.words ? hi.x : 0u;
            a[mt][2] = wd + 1 < L.words ? lo.y : 0u;
            a[mt][3] = wd + 1 < L.words ? hi.y : 0u;
          }
#pragma unroll 4
          for (int b = 0; b < L.planes; ++b) {
            const uint2 p = *reinterpret_cast<const uint2*>(
                ws + ((2 * b) * kFwdCols + 8 * warp + g) * lds + wd);
            const uint2 q = *reinterpret_cast<const uint2*>(
                ws + ((2 * b + 1) * kFwdCols + 8 * warp + g) * lds + wd);
            const uint32_t bp[2] = {p.x, p.y};
            const uint32_t bq[2] = {q.x, q.y};
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              int dp[4], dq[4];
              mma_b1(dp, a[mt], bp);
              mma_b1(dq, a[mt], bq);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][e] += static_cast<uint32_t>(dp[e] - dq[e]) << b;
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (!last) {
            // Step and repack: byte nt / 8 of a row is word nt / 32, byte
            // (nt % 32) / 8.
            uint32_t lo = (static_cast<int>(acc[mt][0]) > 0) | (static_cast<int>(acc[mt][1]) > 0) << 1;
            uint32_t hi = (static_cast<int>(acc[mt][2]) > 0) | (static_cast<int>(acc[mt][3]) > 0) << 1;
            lo <<= 2 * t;
            hi <<= 2 * t;
            lo |= __shfl_xor_sync(kFullMask, lo, 1);
            hi |= __shfl_xor_sync(kFullMask, hi, 1);
            lo |= __shfl_xor_sync(kFullMask, lo, 2);
            hi |= __shfl_xor_sync(kFullMask, hi, 2);
            if (t < 2) {
              const size_t off = static_cast<size_t>(mt * 16 + g + 8 * t) * ldx * 4 + nt / 8;
              const uint8_t byte = static_cast<uint8_t>(t ? hi : lo);
              for (int q = 0; q < blocks; ++q) cluster.map_shared_rank(nxt, q)[off] = byte;
            }
          } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int col = nt + 2 * t + c;
                if (col < n_classes) {
                  take_max(best_v[mt][h], best_i[mt][h], static_cast<int>(acc[mt][2 * h + c]), col);
                }
              }
            }
          }
        }
      }
      __syncthreads();  // every warp is done with the slot before it is refilled
    }
    // Hidden: every block's slice of the next input has landed everywhere,
    // and no block still reads the buffer the next layer writes.
    if (!last) cluster.sync();
  }

  // Rank 0: argmax across the four lanes of a row, then across the warps.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = best_v[mt][h];
      int i = best_i[mt][h];
      for (int o = 1; o < 4; o *= 2) {
        const int ov = __shfl_xor_sync(kFullMask, v, o);
        const int oi = __shfl_xor_sync(kFullMask, i, o);
        take_max(v, i, ov, oi);
      }
      if (t == 0) {
        part_v[warp * TM + mt * 16 + g + 8 * h] = v;
        part_i[warp * TM + mt * 16 + g + 8 * h] = i;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < TM) {
    const int r = threadIdx.x;
    int v = part_v[r];
    int i = part_i[r];
    for (int w = 1; w < kFwdWarps; ++w) take_max(v, i, part_v[w * TM + r], part_i[w * TM + r]);
    if (row0 + r < B) out[static_cast<size_t>(m) * B + row0 + r] = i;
  }
}

template <int TM, class A>
cudaError_t launch_mma(const void* x, const void* w, int ldw, void* out, int B, int kx, int K,
                       int N, int tn, cudaStream_t stream) {
  const dim3 grid((B + TM - 1) / TM, (N + tn - 1) / tn);
  matmul_mma_kernel<TM, A><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const typename A::T*>(x), static_cast<const uint8_t*>(w), ldw,
      static_cast<int32_t*>(out), B, kx, K, N, tn);
  return cudaGetLastError();
}

// The tensor-core tile of a (bm, bn) block shape: bm rows rounded up to 16
// (bm <= 16 -> 16 rows, 32 -> 32) and bn columns (a multiple of 32, walked
// in sub-tiles of 32). Returns false for a shape the scalar kernels refuse
// too, so every shape they take is taken here.
bool mma_blocks(int bm, int bn) {
  const bool rows = bm == 1 || bm == 2 || bm == 4 || bm == 8 || bm == 16 || bm == 32;
  return rows && bn > 0 && bn % kMmaN == 0 && bn <= kMaxBlockThreads;
}

// The weights' layout the tensor-core kernel reads: K-contiguous columns
// whose start is 16-byte aligned (nothing is read when K is 0).
bool mma_weights(const void* w, int ldw, int K) {
  return K == 0 || (ldw >= K && ldw % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0);
}

template <int TM>
cudaError_t launch_dense_mma(const void* x, const void* w, int ldw, void* out, int B, int K,
                             int N, int tn, cudaStream_t s) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(x);
  if (K % 16 == 0 && p % 16 == 0) {
    return launch_mma<TM, DenseRows<TM, 16>>(x, w, ldw, out, B, K, K, N, tn, s);
  }
  if (K % 4 == 0 && p % 4 == 0) {
    return launch_mma<TM, DenseRows<TM, 4>>(x, w, ldw, out, B, K, K, N, tn, s);
  }
  return launch_mma<TM, DenseRows<TM, 1>>(x, w, ldw, out, B, K, K, N, tn, s);
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

template <int TM>
cudaError_t launch_planes_mma(const void* x, const void* pos, const void* neg, long long lp,
                              int ldw, void* out, int B, int KW, int P, int N, int tn,
                              cudaStream_t stream) {
  const size_t smem = planes_smem(TM, P);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(matmul_planes_mma_kernel<TM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((B + TM - 1) / TM, (N + tn - 1) / tn);
  matmul_planes_mma_kernel<TM><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(pos),
      static_cast<const uint32_t*>(neg), lp, ldw, static_cast<int32_t*>(out), B, KW, P, N, tn);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_forward(const void* x, int M, int B, int K, int threshold, const void* net,
                           int depth, int n_classes, int max_words, size_t smem, void* out,
                           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        forward_planes_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((B + BM - 1) / BM, M);
  forward_planes_kernel<BM><<<grid, kForwardThreads, smem, stream>>>(
      static_cast<const uint8_t*>(x), B, K, threshold, static_cast<const PlaneLayer*>(net),
      depth, n_classes, max_words, static_cast<int32_t*>(out));
  return cudaGetLastError();
}

template <int TM, int VEC>
cudaError_t launch_forward_mma(const void* x, int M, int B, int K, int threshold, const void* net,
                               int depth, int n_classes, int ldx, int stage_words, int cluster,
                               size_t smem, void* out, cudaStream_t stream) {
  const auto kernel = forward_planes_mma_kernel<TM, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (B + TM - 1) / TM, M);
  cfg.blockDim = dim3(kFwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint8_t*>(x), B, K,
                                           threshold, static_cast<const PlaneLayer*>(net), depth,
                                           n_classes, ldx, stage_words, static_cast<int32_t*>(out));
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int TM>
cudaError_t launch_forward_mma_rows(const void* x, int M, int B, int K, int threshold,
                                    const void* net, int depth, int n_classes, int ldx,
                                    int stage_words, int cluster, size_t smem, void* out,
                                    cudaStream_t s) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(x);
  if (K % 16 == 0 && p % 16 == 0) {
    return launch_forward_mma<TM, 16>(x, M, B, K, threshold, net, depth, n_classes, ldx,
                                      stage_words, cluster, smem, out, s);
  }
  if (K % 4 == 0 && p % 4 == 0) {
    return launch_forward_mma<TM, 4>(x, M, B, K, threshold, net, depth, n_classes, ldx,
                                     stage_words, cluster, smem, out, s);
  }
  return launch_forward_mma<TM, 1>(x, M, B, K, threshold, net, depth, n_classes, ldx,
                                   stage_words, cluster, smem, out, s);
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

// x int8 (B, K), w int8 (K, N) K-contiguous with column stride ldw: the
// tensor-core product. Returns a cudaError_t.
int bmv_matmul_mma(const void* x, const void* w, int ldw, void* out, int B, int K, int N, int bm,
                   int bn, int device, void* stream) {
  if (B <= 0 || N <= 0 || K < 0 || !mma_blocks(bm, bn) || !mma_weights(w, ldw, K)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bm > 16 ? launch_dense_mma<32>(x, w, ldw, out, B, K, N, bn, s)
                 : launch_dense_mma<16>(x, w, ldw, out, B, K, N, bn, s);
}

// x (B, KW) words, w int8 (KW * 32, N) as in bmv_matmul_mma: the
// tensor-core product.
int bmv_matmul_packed_mma(const void* x, const void* w, int ldw, void* out, int B, int KW, int N,
                          int bm, int bn, int device, void* stream) {
  const int K = KW * kWarp;
  if (B <= 0 || N <= 0 || KW < 0 || !mma_blocks(bm, bn) || !mma_weights(w, ldw, K)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bm > 16 ? launch_mma<32, PackedRows<32>>(x, w, ldw, out, B, KW, K, N, bn, s)
                 : launch_mma<16, PackedRows<16>>(x, w, ldw, out, B, KW, K, N, bn, s);
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

// x (B, KW) words; pos/neg (P, KW, N) words laid out K-contiguous per
// column (word (b, w, n) at b * lp + n * ldw + w): the 1-bit tensor-core
// product. Returns a cudaError_t.
int bmv_matmul_planes(const void* x, const void* pos, const void* neg, long long lp, int ldw,
                      void* out, int B, int KW, int P, int N, int bm, int bn, int device,
                      void* stream) {
  const bool layout = KW == 0 || P == 0 ||
                      (ldw >= KW && ldw % 4 == 0 && lp % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(pos) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(neg) % 16 == 0);
  if (B <= 0 || N <= 0 || KW < 0 || P < 0 || !mma_blocks(bm, bn) || !layout) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bm > 16 ? launch_planes_mma<32>(x, pos, neg, lp, ldw, out, B, KW, P, N, bn, s)
                 : launch_planes_mma<16>(x, pos, neg, lp, ldw, out, B, KW, P, N, bn, s);
}

// Dynamic shared memory of a planes block at bm rows and P planes.
long long bmv_planes_smem_bytes(int bm, int P) {
  return static_cast<long long>(planes_smem(bm > 16 ? 32 : 16, P));
}

// table: `depth` PlaneLayer rows in device memory (16-byte aligned);
// max_words: the widest layer's W, which sizes the activation buffers.
int bmv_forward_planes(const void* x, int M, int B, int K, int threshold, const void* table,
                       int depth, int max_words, int n_classes, void* out, int bm, int device,
                       void* stream) {
  if (M <= 0 || B <= 0 || K < 0 || depth < 1 || max_words < 0 || n_classes < 1 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem =
      (2 * static_cast<size_t>(bm) * max_words + 2 * static_cast<size_t>(kForwardWarps) * bm) *
      sizeof(uint32_t);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FORWARD(BM) \
  launch_forward<BM>(x, M, B, K, threshold, table, depth, n_classes, max_words, smem, out, s)
  switch (bm) {
    case 1: return FORWARD(1);
    case 2: return FORWARD(2);
    case 4: return FORWARD(4);
    case 8: return FORWARD(8);
    case 16: return FORWARD(16);
    case 32: return FORWARD(32);
    default: return cudaErrorInvalidValue;
  }
#undef FORWARD
}

// Clusters of `cluster` tensor-core forward blocks the device can hold at
// once with `smem` bytes each (cudaOccupancyMaxActiveClusters), or a
// negated cudaError_t.
int bmv_forward_max_clusters(int bm, int cluster, long long smem, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const auto kernel = bm > 16 ? forward_planes_mma_kernel<32, 16> : forward_planes_mma_kernel<16, 16>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kFwdThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// Dynamic shared memory of a tensor-core forward block at bm rows (a tile
// of 16 or 32), the widest layer's max_words and stage_words per stage slot.
long long bmv_forward_mma_smem_bytes(int bm, int max_words, int stage_words) {
  return static_cast<long long>(forward_mma_smem(bm > 16 ? 32 : 16, max_words, stage_words));
}

// Words of one stage slot for a layer of P planes and W words: both signs
// of every plane for kFwdCols columns at the staged column stride.
long long bmv_forward_stage_words(int P, int W) {
  return 2LL * P * kFwdCols * forward_mma_lds(W);
}

// The tensor-core route of bmv_forward_planes: table rows hold planes laid
// out K-contiguous per column (ldw = W rounded up to 8, planes and models
// packed; both pointers 16-byte aligned); `cluster` blocks (1, 2, 4 or 8) share a row
// tile of 16 rows (bm <= 16) or 32; stage_words is the largest
// bmv_forward_stage_words over the layers.
int bmv_forward_planes_mma(const void* x, int M, int B, int K, int threshold, const void* table,
                           int depth, int max_words, int n_classes, void* out, int bm,
                           int cluster, int stage_words, int device, void* stream) {
  const bool rows = bm == 1 || bm == 2 || bm == 4 || bm == 8 || bm == 16 || bm == 32;
  const bool blocks = cluster == 1 || cluster == 2 || cluster == 4 || cluster == kMaxCluster;
  if (M <= 0 || B <= 0 || K < 0 || depth < 1 || max_words < 0 || n_classes < 1 || !rows ||
      !blocks || stage_words < 0 || stage_words % 4 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const int tm = bm > 16 ? 32 : 16;
  const size_t smem = forward_mma_smem(tm, max_words, stage_words);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ldx = forward_mma_ldx(max_words);
  return tm == 32 ? launch_forward_mma_rows<32>(x, M, B, K, threshold, table, depth, n_classes,
                                                ldx, stage_words, cluster, smem, out, s)
                  : launch_forward_mma_rows<16>(x, M, B, K, threshold, table, depth, n_classes,
                                                ldx, stage_words, cluster, smem, out, s);
}

}  // extern "C"
