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
//   forward_planes_kernel the whole planes-form net in one launch, of any
//                         depth: the layer table lies in device memory, built
//                         once with the predictor. Replaces
//                         binary_forward_planes (_forward_planes_kernel).
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
// layout), made once when the predictor is built. The whole-net
// forward_planes_kernel keeps the scalar __popc (16 results per clock per SM).

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

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
struct PlaneLayer {
  const uint32_t* pos;  // (P, W, N) words, or (M, P, W, N) when stacked
  const uint32_t* neg;
  int planes;           // P
  int words;            // W: packed fan_in
  int units;            // N: fan_out (hidden layers: a multiple of 32)
  int pad;
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

}  // extern "C"
