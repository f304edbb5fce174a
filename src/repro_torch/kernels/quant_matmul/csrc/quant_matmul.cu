// W8A8 integer matmul with a fused dequantizing epilogue, for Hopper (sm_90a),
// bound to Python with ctypes.
//
// qmm_wgmma_kernel replaces the Pallas kernel quant_matmul
// (src/repro/kernels/quant_matmul/quant_matmul.py:46, _quant_matmul_kernel):
//
//     acc = x_q . w_q                      x_q int8 (M, K), w_q int8 (K, N), int32 sum
//     y   = ((float) acc * sx) * sw[n]     sx fp32 scalar, sw fp32 (N,), y fp32 (M, N)
//
// What bounds it on an H100: the multiply-adds, 2MKN, against 1,979 TOP/s of
// int8 tensor cores, for the prefill shapes (in_proj 2048 x 2560 x 10576 is
// 111 G operations, 0.056 ms, against 0.036 ms of bytes, 87 MB of them the
// fp32 output); the weights' bytes for a decode step (M = 4: 27 MB,
// 0.008 ms). Only wgmma reaches the tensor-core rate, so the kernel has the
// shape the card is built for:
//
// - Both operands K-major (8-bit wgmma takes no transpose): x_q as it lies,
//   w_q as the transposed view of an (N, K) buffer (ops.qmm_weights), each
//   row stride a multiple of 16 bytes as TMA wants.
// - A ring of kStages slots, each one 128-byte K step of an A tile (BM rows)
//   and a B tile (BN columns), 128-byte swizzled, filled by TMA
//   (cp.async.bulk.tensor) and guarded by a full and an empty mbarrier.
//   Rows past M, columns past N and K past its end arrive as zeros, which
//   the sum takes exactly.
// - One producer warpgroup, lowered by setmaxnreg, of which one thread
//   issues the loads; CWG consumer warpgroups, each a 64 x BN slab of the
//   tile through wgmma m64nBNk32 (four per slot), one group kept in flight:
//   a slot is released when the group after it has been issued.
// - The epilogue in the reference's order, (float(acc) * sx) * sw[n], sx
//   read on the device. The int32 sum is exact, so the kernel equals its
//   plain version bit for bit.
// - The stores. Written straight from the registers, one block per tile,
//   the 87 MB of in_proj's output stalled the consumers while the tensor
//   cores idled (0.195 ms on an H100). So the 128 x 128 tile is persistent
//   (one block per SM walks the tiles, the producer loading the next tile
//   while the consumers finish this one), and each consumer stages its slab
//   in shared memory, 128-byte swizzled (conflict-free float2 writes), for
//   TMA stores that drain while the next tile's products run: 0.110 ms
//   (PERF.md).
//   TMA wants 16-byte row strides, so an N that is not a multiple of 4
//   stores from the registers.
//
// Two tiles, chosen by the caller from M: 128 x 128 (two consumer
// warpgroups) for prefill, and 64 x 64 (one, a block per tile, three
// blocks an SM) for M <= 64, so that a decode step's weights stream
// through 166 blocks (N = 10576) and not 83.
// The tensor maps are encoded on every call through libcuda's
// cuTensorMapEncodeTiled, reached through the runtime's entry-point query (no -lcuda),
// and passed as __grid_constant__ parameters.

#include <cstddef>
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 128;        // K bytes per ring slot: one 128-byte swizzle row
constexpr int kStages = 4;      // ring slots
constexpr int kWgThreads = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// Waits for the phase of parity `parity` to complete. A barrier that never
// completes traps after about ten seconds of the SM clock, so a fault shows
// as a launch error and never as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) asm volatile("trap;");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One box of a 2-D tensor map into shared memory: c0 the inner (K) coordinate
// in bytes, c1 the row; completion counts bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzled:
// start address / 16, stride between 8-row groups 1024 B, layout B128.
// The tile starts on a 1024-byte boundary; a K step of 32 bytes inside the
// swizzled row adds 2 to the start address.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving the accumulators across the asynchronous
// wgmma that writes them.
template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += a . b for m64nNk32, s8 x s8 -> s32 (no .satfinite: the sums are exact,
// |acc| <= K 127^2).
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k32(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) {
    wgmma_n128(d, da, db);
  } else {
    static_assert(BN == 64, "tile widths: 64 or 128");
    wgmma_n64(d, da, db);
  }
}

// How a tile leaves the kernel: through a 128-byte-swizzled staging slab in
// shared memory and TMA stores that run while the next tile's products do
// (needs N % 4 == 0: TMA wants 16-byte row strides), or straight from the
// registers, two columns a store where N is even.
constexpr int kStoreDirect = 0;
constexpr int kStoreTma = 1;

template <int CWG, int BN, int STORE>
constexpr size_t qmm_smem() {
  return static_cast<size_t>(kStages) * (64 * CWG + BN) * kBK +
         (STORE == kStoreTma ? static_cast<size_t>(64 * CWG) * BN * sizeof(float) : 0) + 1024 +
         2 * kStages * sizeof(uint64_t);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A 2-D box of the output map from shared memory; c0 the column, c1 the row.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// Each block walks tiles blockIdx.x, + gridDim.x, ..., m fastest, so that
// consecutive tiles share their weight columns in L2; (CWG + 1) warpgroups.
// The wide tile's grid is at most one block per SM (persistent); the narrow
// tile's is one block per tile, held to 80 registers so that three blocks
// share an SM.
template <int CWG, int BN, int STORE>
__global__ void __launch_bounds__((CWG + 1) * kWgThreads, CWG == 1 ? 3 : 1)
    qmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap, const float* __restrict__ sx,
                     const float* __restrict__ sw, float* __restrict__ out, int M, int N, int K) {
  constexpr int BM = 64 * CWG;
  constexpr int kABytes = BM * kBK;
  constexpr int kSlot = (BM + BN) * kBK;
  constexpr int kSlabBytes = 64 * BN * static_cast<int>(sizeof(float));
  extern __shared__ __align__(1024) uint8_t qmm_smem_raw[];
  uint8_t* ring = qmm_smem_raw + ((1024 - (smem_u32(qmm_smem_raw) & 1023)) & 1023);
  uint8_t* staging = ring + kStages * kSlot;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(staging + (STORE == kStoreTma ? CWG * kSlabBytes : 0));
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / kWgThreads;
  const int ktiles = (K + kBK - 1) / kBK;
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles = tiles_m * ((N + BN - 1) / BN);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CWG * kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CWG) {
    // Producer: one thread keeps the ring full, across tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % kWgThreads == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * BM;
        const int n0 = (tile / tiles_m) * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          uint8_t* slot = ring + s * kSlot;
          mbar_expect_tx(&full[s], kSlot);
          tma_load(slot, &xmap, &full[s], kt * kBK, m0);
          tma_load(slot + kABytes, &wmap, &full[s], kt * kBK, n0);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of each tile.
    const float scale = *sx;
    const int lt = threadIdx.x % kWgThreads;
    const int lane = threadIdx.x % 32;
    uint8_t* slab = staging + wg * kSlabBytes;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % tiles_m) * BM;
      const int n0 = (tile / tiles_m) * BN;
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        const uint8_t* slot = ring + s * kSlot;
        const uint64_t da = sw128_desc(slot + wg * 64 * kBK);
        const uint64_t db = sw128_desc(slot + kABytes);
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) wgmma_k32<BN>(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();
        fence_operands(acc);
        // The group of step it - 1 has finished reading its slot.
        if (kt > 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      fence_operands(acc);
      // The last slot is free too: the producer fills it for the next tile
      // while this one leaves.
      if (ktiles > 0) mbar_arrive(&empty[(it - 1) % kStages]);

      // acc[4j + 2h + e] is row r = 16 warp + g + 8h of the warpgroup's
      // slab, column 8j + 2t + e of the tile (lane = 4g + t). The epilogue
      // keeps the reference's order: (float(acc) * sx) * sw[n].
      const int r0 = (lt / 32) * 16 + lane / 4;
      if constexpr (STORE == kStoreTma) {
        // The slab is free once the previous tile's stores have read it.
        if (lt == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        named_sync(1 + wg, kWgThreads);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = 8 * j + 2 * (lane % 4);
          const float s0 = n0 + c < N ? sw[n0 + c] : 0.f;
          const float s1 = n0 + c + 1 < N ? sw[n0 + c + 1] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            // Box q = c / 32 holds 64 rows of 128 bytes; 16-byte chunk k of
            // row r lies at chunk k ^ (r % 8) (the map's 128-byte swizzle).
            const int cc = c % 32;
            uint8_t* dst = slab + (c / 32) * (64 * 128) + r * 128 +
                           ((((cc >> 2) ^ (r & 7)) << 4) | ((cc & 3) << 2));
            *reinterpret_cast<float2*>(dst) =
                make_float2((static_cast<float>(acc[4 * j + 2 * h]) * scale) * s0,
                            (static_cast<float>(acc[4 * j + 2 * h + 1]) * scale) * s1);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(1 + wg, kWgThreads);
        if (lt == 0) {
#pragma unroll
          for (int q = 0; q < BN / 32; ++q) {
            tma_store(&omap, slab + q * (64 * 128), n0 + 32 * q, m0 + 64 * wg);
          }
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * (lane % 4);
          const float s0 = col < N ? sw[col] : 0.f;
          const float s1 = col + 1 < N ? sw[col + 1] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + wg * 64 + r0 + 8 * h;
            if (row >= M) continue;
            float* o = out + static_cast<size_t>(row) * N + col;
            const float y0 = (static_cast<float>(acc[4 * j + 2 * h]) * scale) * s0;
            const float y1 = (static_cast<float>(acc[4 * j + 2 * h + 1]) * scale) * s1;
            if (N % 2 == 0 && col + 1 < N) {
              *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
            } else {
              if (col < N) o[0] = y0;
              if (col + 1 < N) o[1] = y1;
            }
          }
        }
      }
    }
    if (STORE == kStoreTma && lt == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once (the function, not
// any map, is kept).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, inner) row-major matrix of `type` with rows `ld` bytes apart,
// read or written in boxes of box_rows x box_inner elements (box_inner of
// them 128 bytes), 128-byte swizzled; out-of-bounds reads are zero and
// out-of-bounds writes are dropped.
bool encode(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int inner,
            int rows, long long ld, int box_inner, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CWG, int BN, int STORE>
cudaError_t launch(EncodeTiled fn, const void* x, long long ldx, const void* w, long long ldw,
                   const float* sx, const float* sw, float* out, int M, int N, int K,
                   cudaStream_t stream) {
  CUtensorMap xmap, wmap, omap;
  // K = 0 still needs a valid map (nothing is loaded): the callers' rows
  // then hold 16 zero bytes.
  const int inner = K > 0 ? K : 16;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!encode(fn, &xmap, u8, x, inner, M, ldx, kBK, 64 * CWG) ||
      !encode(fn, &wmap, u8, w, inner, N, ldw, kBK, BN)) {
    return cudaErrorInvalidValue;
  }
  if (STORE == kStoreTma) {
    if (!encode(fn, &omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out, N, M,
                static_cast<long long>(N) * sizeof(float), 32, 64)) {
      return cudaErrorInvalidValue;
    }
  } else {
    omap = xmap;  // unused
  }
  constexpr size_t smem = qmm_smem<CWG, BN, STORE>();
  cudaError_t e = cudaFuncSetAttribute(qmm_wgmma_kernel<CWG, BN, STORE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles = ((N + BN - 1) / BN) * ((M + 64 * CWG - 1) / (64 * CWG));
  int grid = tiles;
  if (CWG > 1) {  // persistent: at most one block per SM
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    grid = tiles < sms ? tiles : sms;
  }
  qmm_wgmma_kernel<CWG, BN, STORE><<<grid, (CWG + 1) * kWgThreads, smem, stream>>>(
      xmap, wmap, omap, sx, sw, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* qmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x int8 (M, K) with rows ldx bytes apart; w int8 (K, N) K-major, column n
// at w + n * ldw (ldx, ldw >= max(K, 16), multiples of 16; both bases
// 16-byte aligned); sx one fp32 on the device; sw fp32 (N,); out fp32 (M, N).
// narrow != 0 takes the 64 x 64 tile (M <= 64), else 128 x 128. Returns a
// cudaError_t: 0 on a launch that was accepted.
int qmm_matmul(const void* x, long long ldx, const void* w, long long ldw, const void* sx,
               const void* sw, void* out, int M, int N, int K, int narrow, int device,
               void* stream) {
  const int inner = K > 0 ? K : 16;
  if (M <= 0 || N <= 0 || K < 0 || ldx < inner || ldw < inner || ldx % 16 || ldw % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sxf = static_cast<const float*>(sx);
  const float* swf = static_cast<const float*>(sw);
  float* o = static_cast<float*>(out);
  if (narrow) return launch<1, 64, kStoreDirect>(fn, x, ldx, w, ldw, sxf, swf, o, M, N, K, s);
  const bool tma = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return tma ? launch<2, 128, kStoreTma>(fn, x, ldx, w, ldw, sxf, swf, o, M, N, K, s)
             : launch<2, 128, kStoreDirect>(fn, x, ldx, w, ldw, sxf, swf, o, M, N, K, s);
}

}  // extern "C"
