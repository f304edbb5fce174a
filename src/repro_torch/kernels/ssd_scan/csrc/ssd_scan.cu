// Mamba2 SSD chunked scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Two kernels replace the Pallas kernel ssd_scan
// (src/repro/kernels/ssd_scan/ssd_scan.py, _ssd_kernel). Per (batch b, head h),
// chunk by chunk of Q rows, with the (N, P) state s carried in fp32:
//
//     cum   = cumsum(dt * a_h)                                   (Q,)
//     y     = ((C B^T) o L)(x o dt) + (C o e^cum) s              L[t,u] = e^(cum_t - cum_u), t >= u
//     s     = e^cum_end s + (B o dt o e^(cum_end - cum))^T x
//
// Both take one block per (b, h); the TPU's sequential chunk axis is a loop
// inside the block. Both read the model layout in place: x (B, L, H, P), dt
// (B, L, H), B and C (B, L, G, N) through their batch and length strides, head
// h taking group h / (H / G), so B and C are never repeated over the heads.
// Rows past L (a ragged tail) are staged as zeros: dt = 0 adds nothing to y and
// leaves the state undecayed. y is rounded to its dtype once, on store; the
// final state is written in fp32.
//
// ssd_mma_kernel, the route of bf16 inputs (Q a multiple of 16 up to 128,
// N <= 128, P <= 64: mamba2-2.7b's layers), runs the three products on the
// tensor cores with mma.sync m16n8k16 bf16 and fp32 accumulators: C B^T, then
// y = C s + S x and the state update B^T (w o x). B, C and x are exact bf16
// operands; the fp32 operands S (after L o dt), s and w o x enter as bf16
// hi + lo pairs, two products each, which keeps every product within ~2^-17
// of its terms (one bf16 rounding, 2^-9, would break the bound the card holds
// the kernel to). Operands are staged in bf16 by 16-byte cp.async into a
// two-slot ring, the next chunk's copies in flight while this chunk is
// computed; cp.async waits end when the copies land and cannot spin.
//
// What bounds it on an H100 (mamba2-2.7b, B=4, L=512, Q=128, bf16): bytes,
// 53.8 MB in and out (0.016 ms at 3.35 TB/s), over 6.76 GFLOP (0.0068 ms at
// 989 TFLOP/s). In practice the grid and latency bound it: 320 blocks of
// 214 KB of shared memory, one an SM, so 3 rounds on 132 SMs, each block
// walking 4 chunks in order through phases separated by barriers, 8 warps an
// SM to hide the latency of each ldmatrix -> mma chain. Two heads of a group
// per block, staging B and C and forming C B^T once for both, ran slower on an
// H100 than one head a block: 160 two-head blocks take 2 rounds of twice the
// work, 320 one-head blocks 3 rounds of the single work.
//
// ssd_scan_kernel, the route of fp32 inputs and of the shapes the tensor-core
// kernel refuses, stages a chunk in fp32 and runs every product as a 16 x 16
// thread grid of register micro-tiles of scalar fp32 FMAs over shared memory;
// cum is a warp scan. The Q x Q score matrix is built 32 rows at a time, and a
// row tile only computes the columns at or below its last row. It is bound by
// the FMAs (~67 TFLOP/s of fp32 CUDA cores), held back further by shared-memory
// loads (6 for every 8 FMAs in the score tiles) and by one block of 256
// threads per SM (the chunk of a full-width head takes 215 KB).

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 16;             // thread grid of the products: kTX x kTY
constexpr int kRowTile = 32;        // score rows held at once
constexpr int kPass = 64;           // columns (or rows) one pass of 4 per thread covers
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);       // round to nearest even
}

// acc[i][j] += sum_{k < K} A(k, m0 + ty + 16 i) * B(k, n0 + tx + 16 j), with
// A(k, m) = a[k * a_k + m * a_m] and B(k, n) = b[k * b_k + n * b_n], both in
// shared memory; rows m >= M and columns n >= NC read as 0.
template <int MI, int MJ>
__device__ __forceinline__ void tile_dot(float (&acc)[MI][MJ], const float* a, int a_k, int a_m,
                                         int m0, int M, const float* b, int b_k, int b_n,
                                         int n0, int NC, int K) {
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  int ao[MI], bo[MJ];
  bool av[MI], bv[MJ];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int m = m0 + ty + 16 * i;
    av[i] = m < M;
    ao[i] = av[i] ? m * a_m : 0;
  }
#pragma unroll
  for (int j = 0; j < MJ; ++j) {
    const int n = n0 + tx + 16 * j;
    bv[j] = n < NC;
    bo[j] = bv[j] ? n * b_n : 0;
  }
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float ra[MI], rb[MJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) ra[i] = av[i] ? a[k * a_k + ao[i]] : 0.f;
#pragma unroll
    for (int j = 0; j < MJ; ++j) rb[j] = bv[j] ? b[k * b_k + bo[j]] : 0.f;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MJ; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
  }
}

// fp32 words of the block's dynamic shared memory: the buffers the kernel
// splits it into, in its order. ssd_smem_bytes (the size every launch asks
// for) is this count, and the kernel traps if its split ends elsewhere. (The
// split is written out in the kernel: computing its pointers through a shared
// helper put them in local memory, 16 bytes of stack, and slowed the kernel.)
__host__ __device__ __forceinline__ int smem_words(int Q, int N, int P) {
  return Q * P + Q * (N + 1) + Q * N + N * P + kRowTile * (Q + 1) + 3 * Q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, long long sxb, long long sxl,
                    const T* __restrict__ dt, long long sdb, long long sdl,
                    const float* __restrict__ a, const T* __restrict__ bmat, long long sbb,
                    long long sbl, const T* __restrict__ cmat, long long scb, long long scl,
                    T* __restrict__ y, float* __restrict__ sfin, int L, int H, int G, int N,
                    int P, int Q) {
  extern __shared__ float smem[];
  const int ldb = N + 1;
  const int lds = Q + 1;
  float* xs = smem;                 // Q x P      chunk of x
  float* bs = xs + Q * P;           // Q x (N+1)  chunk of B (odd stride: conflict-free)
  float* cs = bs + Q * ldb;         // Q x N      chunk of C
  float* st = cs + Q * N;           // N x P      carried state
  float* sc = st + N * P;           // kRowTile x (Q+1) score rows
  float* cum = sc + kRowTile * lds; // Q
  float* dts = cum + Q;             // Q
  float* wdec = dts + Q;            // Q          dt e^(cum_end - cum)
  if (wdec + Q != smem + smem_words(Q, N, P)) __trap();

  const int bh = blockIdx.x;
  const int bi = bh / H;
  const int h = bh % H;
  const int g = h / (H / G);
  const float ah = a[h];
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;

  const T* xb = x + bi * sxb + static_cast<long long>(h) * P;
  const T* db = dt + bi * sdb + h;
  const T* bb = bmat + bi * sbb + static_cast<long long>(g) * N;
  const T* cb = cmat + bi * scb + static_cast<long long>(g) * N;
  T* yb = y + (static_cast<long long>(bi) * L * H + h) * P;   // + l H P + p
  const long long y_row = static_cast<long long>(H) * P;

  for (int i = tid; i < N * P; i += kThreads) st[i] = 0.f;

  for (int l0 = 0; l0 < L; l0 += Q) {
    // 1. Stage the chunk in fp32; rows past L are zeros.
    for (int i = tid; i < Q * P; i += kThreads) {
      const int l = l0 + i / P;
      xs[i] = l < L ? to_f(xb[l * sxl + i % P]) : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int r = i / N;
      const int n = i % N;
      const int l = l0 + r;
      bs[r * ldb + n] = l < L ? to_f(bb[l * sbl + n]) : 0.f;
      cs[i] = l < L ? to_f(cb[l * scl + n]) : 0.f;
    }
    for (int r = tid; r < Q; r += kThreads) dts[r] = l0 + r < L ? to_f(db[(l0 + r) * sdl]) : 0.f;
    __syncthreads();

    // 2. cum: inclusive prefix sum of dt * a_h, one warp, 32 rows a step.
    if (tid < 32) {
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int r = base + tid;
        float v = r < Q ? dts[r] * ah : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
          const float u = __shfl_up_sync(kFullMask, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (r < Q) cum[r] = v;
        carry = __shfl_sync(kFullMask, v, 31);
      }
    }
    __syncthreads();
    const float cum_end = cum[Q - 1];

    // 3. y, kRowTile rows at a time.
    for (int r0 = 0; r0 < Q; r0 += kRowTile) {
      const int kmax = min(Q, r0 + kRowTile);   // score columns past the last row are 0
      // 3a. S[r, u] = (C_r . B_u) e^(cum_r - cum_u) dt_u for u <= r, else 0.
      for (int u0 = 0; u0 < kmax; u0 += kPass) {
        float acc[2][4] = {};
        tile_dot<2, 4>(acc, cs, 1, N, r0, Q, bs, 1, ldb, u0, kmax, N);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rr = ty + 16 * i;
          const int r = r0 + rr;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int u = u0 + tx + 16 * j;
            if (u < kmax)
              sc[rr * lds + u] =
                  (u <= r && r < Q) ? acc[i][j] * expf(cum[r] - cum[u]) * dts[u] : 0.f;
          }
        }
      }
      __syncthreads();
      // 3b. y[r, p] = sum_u S[r, u] x[u, p] + e^cum_r sum_n C[r, n] s[n, p].
      const int rows = min(kRowTile, Q - r0);
      for (int p0 = 0; p0 < P; p0 += kPass) {
        float yi[2][4] = {};
        float ys[2][4] = {};
        tile_dot<2, 4>(yi, sc, 1, lds, 0, rows, xs, P, 1, p0, P, kmax);
        tile_dot<2, 4>(ys, cs, 1, N, r0, Q, st, P, 1, p0, P, N);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + ty + 16 * i;
          if (r >= Q || l0 + r >= L) continue;
          const float e = expf(cum[r]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = p0 + tx + 16 * j;
            if (p < P) yb[(l0 + r) * y_row + p] = from_f<T>(yi[i][j] + e * ys[i][j]);
          }
        }
      }
      __syncthreads();              // the next row tile rewrites the scores
    }

    // 4. s = e^cum_end s + sum_u B_u^T (dt_u e^(cum_end - cum_u) x_u).
    for (int r = tid; r < Q; r += kThreads) wdec[r] = dts[r] * expf(cum_end - cum[r]);
    __syncthreads();
    for (int i = tid; i < Q * P; i += kThreads) xs[i] *= wdec[i / P];
    __syncthreads();
    const float decay = expf(cum_end);
    for (int n0 = 0; n0 < N; n0 += kPass) {
      for (int p0 = 0; p0 < P; p0 += kPass) {
        float acc[4][4] = {};
        tile_dot<4, 4>(acc, bs, ldb, 1, n0, N, xs, P, 1, p0, P, Q);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = p0 + tx + 16 * j;
            if (n < N && p < P) st[n * P + p] = decay * st[n * P + p] + acc[i][j];
          }
        }
      }
    }
    __syncthreads();                // the next chunk restages x and B
  }

  float* sb = sfin + static_cast<long long>(bh) * N * P;
  for (int i = tid; i < N * P; i += kThreads) sb[i] = st[i];
}

// ---- the bf16 tensor-core route ----------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaMaxQ = 128;       // rows of a chunk: one 16-row tile per warp
constexpr int kMmaMaxN = 128;       // state rows: one 16-row tile per warp
constexpr int kMmaMaxP = 64;        // head width: eight n8 tiles of accumulators
constexpr int kPad = 8;             // bf16 of padding per staged row (ldmatrix without conflicts)

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) / 16 * 16; }

// Bytes of dynamic shared memory of a tensor-core block, in the kernel's
// order: a ring of two slots of B and C (Q x NP each) and x (Q x PP), the
// scratch operand in bf16 hi and lo halves (max(Q, NP) x PP each), then dt,
// cum and w = dt e^(cum_end - cum) in fp32. Rows are padded by kPad.
__host__ __device__ __forceinline__ size_t mma_smem_bytes(int Q, int N, int P) {
  const size_t ldn = round16(N) + kPad;
  const size_t ldp = round16(P) + kPad;
  const size_t sr = Q > round16(N) ? Q : round16(N);
  return 2 * (2 * (2 * Q * ldn + Q * ldp) + 2 * sr * ldp) + 4 * (3 * static_cast<size_t>(Q));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col), c fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (v0, v1) as two bf16 pairs, hi the rounded values and lo the rounded
// remainders: hi + lo is v within 2^-17 of |v| (one bf16 alone: 2^-9).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - f.x, v1 - f.y));
}

// acc[j] += a . (b_hi + b_lo) over the PT n8 tiles of one k16 step, b read
// from row-major [k][n] hi and lo planes (ldmatrix.trans at offset bo). All
// fragments are loaded first and the hi products issued before the lo ones,
// so that consecutive products write different accumulators.
__device__ __forceinline__ void mma_split_b(float (&acc)[kMmaMaxP / 8][4], const uint32_t (&a)[4],
                                            const __nv_bfloat16* hi, const __nv_bfloat16* lo,
                                            int bo, int PT) {
  uint32_t bh[kMmaMaxP / 16][4], bl[kMmaMaxP / 16][4];
#pragma unroll
  for (int jj = 0; jj < kMmaMaxP / 16; ++jj) {
    if (2 * jj < PT) {
      ldsm_x4_t(bh[jj], hi + bo + 16 * jj);
      ldsm_x4_t(bl[jj], lo + bo + 16 * jj);
    }
  }
#pragma unroll
  for (int jj = 0; jj < kMmaMaxP / 16; ++jj) {
    if (2 * jj < PT) {
      mma_bf16(acc[2 * jj], a, bh[jj][0], bh[jj][1]);
      mma_bf16(acc[2 * jj + 1], a, bh[jj][2], bh[jj][3]);
    }
  }
#pragma unroll
  for (int jj = 0; jj < kMmaMaxP / 16; ++jj) {
    if (2 * jj < PT) {
      mma_bf16(acc[2 * jj], a, bl[jj][0], bl[jj][1]);
      mma_bf16(acc[2 * jj + 1], a, bl[jj][2], bl[jj][3]);
    }
  }
}

// acc[j] += (a_hi + a_lo) . b, likewise, b one row-major [k][n] plane.
__device__ __forceinline__ void mma_split_a(float (&acc)[kMmaMaxP / 8][4],
                                            const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                            const __nv_bfloat16* b, int bo, int PT) {
  uint32_t bx[kMmaMaxP / 16][4];
#pragma unroll
  for (int jj = 0; jj < kMmaMaxP / 16; ++jj)
    if (2 * jj < PT) ldsm_x4_t(bx[jj], b + bo + 16 * jj);
#pragma unroll
  for (int jj = 0; jj < kMmaMaxP / 16; ++jj) {
    if (2 * jj < PT) {
      mma_bf16(acc[2 * jj], ah, bx[jj][0], bx[jj][1]);
      mma_bf16(acc[2 * jj + 1], ah, bx[jj][2], bx[jj][3]);
    }
  }
#pragma unroll
  for (int jj = 0; jj < kMmaMaxP / 16; ++jj) {
    if (2 * jj < PT) {
      mma_bf16(acc[2 * jj], al, bx[jj][0], bx[jj][1]);
      mma_bf16(acc[2 * jj + 1], al, bx[jj][2], bx[jj][3]);
    }
  }
}

// One chunk row of `n` bf16 values (a row of B, C or x) into shared memory,
// zero past `valid` values or when the row lies past L. VEC: 16-byte
// cp.async copies (n, the row's start and the strides all multiples of 8
// values); otherwise one value at a time.
template <bool VEC>
__device__ __forceinline__ void stage_piece(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            bool row_ok, int c, int valid) {
  if constexpr (VEC) {
    const bool ok = row_ok && c < valid;
    const unsigned d = smem_u32(dst + c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(ok ? src + c : src), "r"(ok ? 16 : 0));
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[c + e] = (row_ok && c + e < valid) ? src[c + e] : __float2bfloat16(0.f);
  }
}

// The bf16 SSD on the tensor cores. Block: one (batch row, head), 8 warps,
// chunks in order, the head's state in the registers of the warps that own
// its rows. Chunk c + 1's B, C and x are copied (cp.async) into the second
// slot of a two-slot ring, and its dt into a register, while chunk c is
// computed. Per chunk:
//   1. cum = cumsum(dt a_h), then w = dt e^(cum_end - cum), one warp;
//   2. CB = C B^T: warp w owns rows 16w..16w+15 and the causal columns
//      0..16w+15, in fp32 registers;
//   3. the carried state s (fp32) into shared memory as bf16 hi + lo;
//   4. y = e^cum o (C s_hi + C s_lo) + S_hi x + S_lo x, where S = CB o L o dt
//      is formed in the CB registers, which are laid out as the A operand
//      (row g, columns 2t and 2t+1 of two n8 tiles = one k16 fragment);
//      y is rounded to bf16 once, on store;
//   5. w o x into shared memory as bf16 hi + lo;
//   6. s = e^cum_end s + B^T (wx_hi) + B^T (wx_lo), B^T read by ldmatrix.trans.
// B, C and x are exact bf16 operands; every fp32 operand (S, s, w o x) is
// split, so each product is exact to ~2^-17 of its terms, and sums are fp32.
template <bool VEC>
__global__ void __launch_bounds__(kMmaThreads, 1)
    ssd_mma_kernel(const __nv_bfloat16* __restrict__ x, long long sxb, long long sxl,
                   const __nv_bfloat16* __restrict__ dt, long long sdb, long long sdl,
                   const float* __restrict__ a, const __nv_bfloat16* __restrict__ bmat,
                   long long sbb, long long sbl, const __nv_bfloat16* __restrict__ cmat,
                   long long scb, long long scl, __nv_bfloat16* __restrict__ y,
                   float* __restrict__ sfin, int L, int H, int G, int N, int P, int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NP = round16(N);
  const int PP = round16(P);
  const int ldn = NP + kPad;
  const int ldp = PP + kPad;
  const int SR = Q > NP ? Q : NP;
  const int slot_elems = 2 * Q * ldn + Q * ldp;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 2 slots of B, C, x
  __nv_bfloat16* hi = ring + 2 * slot_elems;                          // SR x ldp  scratch
  __nv_bfloat16* lo = hi + SR * ldp;                                  // SR x ldp
  float* dts = reinterpret_cast<float*>(lo + SR * ldp);               // Q
  float* cum = dts + Q;                                               // Q
  float* wts = cum + Q;                                               // Q
  if (reinterpret_cast<unsigned char*>(wts + Q) != smem_raw + mma_smem_bytes(Q, N, P))
    __trap();

  const int bi = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g8 = lane / 4;
  const int t4 = lane % 4;
  const int QT = Q / 16;
  const int NT = NP / 16;
  const int PT = PP / 8;
  const int r0 = 16 * warp + g8;    // this lane's first row in a warp's 16-row tile
  const float ah = a[h];

  const __nv_bfloat16* xb = x + bi * sxb + static_cast<long long>(h) * P;
  const __nv_bfloat16* db = dt + bi * sdb + h;
  const __nv_bfloat16* bb = bmat + bi * sbb + static_cast<long long>(g) * N;
  const __nv_bfloat16* cb_ = cmat + bi * scb + static_cast<long long>(g) * N;
  const long long y_row = static_cast<long long>(H) * P;

  // Copies chunk l0's B, C and x into ring slot `slot` (one commit group).
  const auto stage = [&](int slot, int l0) {
    __nv_bfloat16* bs = ring + slot * slot_elems;
    __nv_bfloat16* cs = bs + Q * ldn;
    __nv_bfloat16* xs = cs + Q * ldn;
    const int nb = NP / 8;
    for (int i = tid; i < Q * nb; i += kMmaThreads) {
      const int r = i / nb;
      const int c = (i % nb) * 8;
      const long long l = l0 + r;
      const bool ok = l < L;
      stage_piece<VEC>(bs + r * ldn, bb + (ok ? l * sbl : 0), ok, c, N);
      stage_piece<VEC>(cs + r * ldn, cb_ + (ok ? l * scl : 0), ok, c, N);
    }
    const int pb = PP / 8;
    for (int i = tid; i < Q * pb; i += kMmaThreads) {
      const int r = i / pb;
      const int c = (i % pb) * 8;
      const long long l = l0 + r;
      const bool ok = l < L;
      stage_piece<VEC>(xs + r * ldp, xb + (ok ? l * sxl : 0), ok, c, P);
    }
    if constexpr (VEC) asm volatile("cp.async.commit_group;\n");
  };
  const auto load_dt = [&](int l0) {
    const int l = l0 + tid;
    return tid < Q && l < L ? __bfloat162float(db[static_cast<long long>(l) * sdl]) : 0.f;
  };

  float st[kMmaMaxP / 8][4];
#pragma unroll
  for (int j = 0; j < kMmaMaxP / 8; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;

  if (L > 0) stage(0, 0);
  float dnext = load_dt(0);
  for (int l0 = 0, slot = 0; l0 < L; l0 += Q, slot ^= 1) {
    const __nv_bfloat16* bs = ring + slot * slot_elems;
    const __nv_bfloat16* cs = bs + Q * ldn;
    const __nv_bfloat16* xs = cs + Q * ldn;
    if (tid < Q) dts[tid] = dnext;
    if constexpr (VEC) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    // The other slot held the previous chunk, which every warp has left at
    // the barrier ending the previous iteration.
    if (l0 + Q < L) {
      stage(slot ^ 1, l0 + Q);
      dnext = load_dt(l0 + Q);
    }

    // 1. cum: inclusive prefix sum of dt * a_h; then w = dt e^(cum_end - cum).
    if (warp == 0) {
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int r = base + lane;
        float v = r < Q ? dts[r] * ah : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
          const float u = __shfl_up_sync(kFullMask, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        if (r < Q) cum[r] = v;
        carry = __shfl_sync(kFullMask, v, 31);
      }
      __syncwarp();
      for (int r = lane; r < Q; r += 32) wts[r] = dts[r] * expf(carry - cum[r]);
    }

    // 2. CB = C B^T on the causal column tiles of the warp's rows.
    float cbt[kMmaMaxQ / 8][4];
#pragma unroll
    for (int j = 0; j < kMmaMaxQ / 8; ++j) cbt[j][0] = cbt[j][1] = cbt[j][2] = cbt[j][3] = 0.f;
    if (warp < QT) {
      for (int k0 = 0; k0 < NP; k0 += 16) {
        uint32_t af[4];
        ldsm_x4(af, cs + (16 * warp + (lane & 15)) * ldn + k0 + (lane >> 4) * 8);
#pragma unroll
        for (int jj = 0; jj < kMmaMaxQ / 16; ++jj) {
          if (jj <= warp) {
            uint32_t bf[4];
            ldsm_x4(bf, bs + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) * ldn + k0 +
                            ((lane >> 3) & 1) * 8);
            mma_bf16(cbt[2 * jj], af, bf[0], bf[1]);
            mma_bf16(cbt[2 * jj + 1], af, bf[2], bf[3]);
          }
        }
      }
    }

    // 3. The carried state as bf16 hi + lo, [n][p].
    if (warp < NT) {
#pragma unroll
      for (int j = 0; j < kMmaMaxP / 8; ++j) {
        if (j < PT) {
          const int o = r0 * ldp + 8 * j + 2 * t4;
          uint32_t h2, l2;
          split2(st[j][0], st[j][1], h2, l2);
          *reinterpret_cast<uint32_t*>(hi + o) = h2;
          *reinterpret_cast<uint32_t*>(lo + o) = l2;
          split2(st[j][2], st[j][3], h2, l2);
          *reinterpret_cast<uint32_t*>(hi + o + 8 * ldp) = h2;
          *reinterpret_cast<uint32_t*>(lo + o + 8 * ldp) = l2;
        }
      }
    }
    __syncthreads();                // cum, w and the state halves are visible
    const float cum_end = cum[Q - 1];

    // 4. y for the warp's 16 rows.
    if (warp < QT) {
      float acc[kMmaMaxP / 8][4];
#pragma unroll
      for (int j = 0; j < kMmaMaxP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int k0 = 0; k0 < NP; k0 += 16) {
        uint32_t af[4];
        ldsm_x4(af, cs + (16 * warp + (lane & 15)) * ldn + k0 + (lane >> 4) * 8);
        mma_split_b(acc, af, hi, lo, (k0 + (lane & 15)) * ldp + (lane >> 4) * 8, PT);
      }
      const float c0 = cum[r0];
      const float c1 = cum[r0 + 8];
      const float e0 = expf(c0);
      const float e1 = expf(c1);
#pragma unroll
      for (int j = 0; j < kMmaMaxP / 8; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
#pragma unroll
      for (int kk = 0; kk < kMmaMaxQ / 16; ++kk) {
        if (kk <= warp) {
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int tile = 2 * kk + half;
            const int u = 16 * kk + 8 * half + 2 * t4;
            const float d0 = dts[u], d1 = dts[u + 1];
            const float q0 = cum[u], q1 = cum[u + 1];
            const float s00 = u <= r0 ? cbt[tile][0] * __expf(c0 - q0) * d0 : 0.f;
            const float s01 = u + 1 <= r0 ? cbt[tile][1] * __expf(c0 - q1) * d1 : 0.f;
            const float s10 = u <= r0 + 8 ? cbt[tile][2] * __expf(c1 - q0) * d0 : 0.f;
            const float s11 = u + 1 <= r0 + 8 ? cbt[tile][3] * __expf(c1 - q1) * d1 : 0.f;
            split2(s00, s01, ahi[2 * half], alo[2 * half]);
            split2(s10, s11, ahi[2 * half + 1], alo[2 * half + 1]);
          }
          mma_split_a(acc, ahi, alo, xs, (16 * kk + (lane & 15)) * ldp + (lane >> 4) * 8, PT);
        }
      }
      // c0, c1 at row g, columns 2t, 2t+1; c2, c3 at row g + 8.
#pragma unroll
      for (int j = 0; j < kMmaMaxP / 8; ++j) {
        const int p = 8 * j + 2 * t4;
        if (j >= PT || p >= P) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int l = l0 + r0 + 8 * half;
          if (l >= L) continue;
          __nv_bfloat16* o = y + static_cast<long long>(bi) * L * y_row + l * y_row +
                             static_cast<long long>(h) * P + p;
          o[0] = __float2bfloat16(acc[j][2 * half]);
          if (p + 1 < P) o[1] = __float2bfloat16(acc[j][2 * half + 1]);
        }
      }
    }
    __syncthreads();                // every warp is done with the state halves

    // 5. w o x as bf16 hi + lo, [u][p].
    for (int i = tid; i < Q * (PP / 2); i += kMmaThreads) {
      const int u = i / (PP / 2);
      const int p = 2 * (i % (PP / 2));
      const float w = wts[u];
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + u * ldp + p));
      uint32_t h2, l2;
      split2(w * xv.x, w * xv.y, h2, l2);
      *reinterpret_cast<uint32_t*>(hi + u * ldp + p) = h2;
      *reinterpret_cast<uint32_t*>(lo + u * ldp + p) = l2;
    }
    __syncthreads();

    // 6. s = e^cum_end s + B^T (w o x), the warp's 16 state rows.
    if (warp < NT) {
      float acc[kMmaMaxP / 8][4];
#pragma unroll
      for (int j = 0; j < kMmaMaxP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int k0 = 0; k0 < Q; k0 += 16) {
        uint32_t af[4];
        ldsm_x4_t(af, bs + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ldn + 16 * warp +
                          ((lane >> 3) & 1) * 8);
        mma_split_b(acc, af, hi, lo, (k0 + (lane & 15)) * ldp + (lane >> 4) * 8, PT);
      }
      const float decay = expf(cum_end);
#pragma unroll
      for (int j = 0; j < kMmaMaxP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = decay * st[j][e] + acc[j][e];
    }
    __syncthreads();                // the scratch, dt and the slot are rewritten next
  }

  if (warp < NT) {
    float* sb = sfin + (static_cast<long long>(bi) * H + h) * N * P;
#pragma unroll
    for (int j = 0; j < kMmaMaxP / 8; ++j) {
      const int p = 8 * j + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = r0 + 8 * half;
        if (j >= PT || n >= N || p >= P) continue;
        sb[n * P + p] = st[j][2 * half];
        if (p + 1 < P) sb[n * P + p + 1] = st[j][2 * half + 1];
      }
    }
  }
}

template <bool VEC>
cudaError_t launch_mma(const void* x, long long sxb, long long sxl, const void* dt, long long sdb,
                       long long sdl, const void* a, const void* b, long long sbb, long long sbl,
                       const void* c, long long scb, long long scl, void* y, void* s, int B,
                       int L, int H, int G, int N, int P, int Q, size_t smem,
                       cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_mma_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  using bf = __nv_bfloat16;
  ssd_mma_kernel<VEC><<<B * H, kMmaThreads, smem, stream>>>(
      static_cast<const bf*>(x), sxb, sxl, static_cast<const bf*>(dt), sdb, sdl,
      static_cast<const float*>(a), static_cast<const bf*>(b), sbb, sbl,
      static_cast<const bf*>(c), scb, scl, static_cast<bf*>(y), static_cast<float*>(s), L, H, G,
      N, P, Q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ssd(const void* x, long long sxb, long long sxl, const void* dt,
                       long long sdb, long long sdl, const void* a, const void* b,
                       long long sbb, long long sbl, const void* c, long long scb,
                       long long scl, void* y, void* s, int B, int L, int H, int G, int N,
                       int P, int Q, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  ssd_scan_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sxb, sxl, static_cast<const T*>(dt), sdb, sdl,
      static_cast<const float*>(a), static_cast<const T*>(b), sbb, sbl,
      static_cast<const T*>(c), scb, scl, static_cast<T*>(y), static_cast<float*>(s), L, H, G,
      N, P, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of dynamic shared memory one block takes at chunk Q, state N, head P.
long long ssd_smem_bytes(int chunk, int N, int P) {
  return static_cast<long long>(sizeof(float)) * smem_words(chunk, N, P);
}

// Returns a cudaError_t: 0 on a launch that was accepted; cudaErrorInvalidValue
// also when a chunk needs more shared memory than a block of `device` may opt in
// to. `bf16` selects the input type of x, dt, B and C (and of y): 0 float,
// 1 bfloat16.
int ssd_scan(int bf16, const void* x, long long sxb, long long sxl, const void* dt,
             long long sdb, long long sdl, const void* a, const void* b, long long sbb,
             long long sbl, const void* c, long long scb, long long scl, void* y, void* s,
             int B, int L, int H, int G, int N, int P, int chunk, int device, void* stream) {
  if (B <= 0 || L < 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 || P <= 0 || chunk <= 0)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  const long long smem = ssd_smem_bytes(chunk, N, P);
  if (smem > optin) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  if (bf16)
    return launch_ssd<__nv_bfloat16>(x, sxb, sxl, dt, sdb, sdl, a, b, sbb, sbl, c, scb, scl, y,
                                     s, B, L, H, G, N, P, chunk, bytes, st);
  return launch_ssd<float>(x, sxb, sxl, dt, sdb, sdl, a, b, sbb, sbl, c, scb, scl, y, s, B, L,
                           H, G, N, P, chunk, bytes, st);
}

// 1 when the bf16 tensor-core kernel takes a chunk of Q rows, state N and
// head P: Q a multiple of 16 up to 128, N up to 128, P up to 64.
int ssd_mma_supported(int chunk, int N, int P) {
  return chunk > 0 && chunk % 16 == 0 && chunk <= kMmaMaxQ && N > 0 && N <= kMmaMaxN && P > 0 &&
         P <= kMmaMaxP;
}

// Bytes of dynamic shared memory one tensor-core block takes.
long long ssd_mma_smem_bytes(int chunk, int N, int P) {
  return static_cast<long long>(mma_smem_bytes(chunk, N, P));
}

// The bf16 route on the tensor cores, with ssd_scan's arguments (all of x, dt,
// B, C, y bfloat16). Returns a cudaError_t; cudaErrorInvalidValue for a shape
// ssd_mma_supported refuses or a block over the device's shared memory.
int ssd_scan_mma(const void* x, long long sxb, long long sxl, const void* dt, long long sdb,
                 long long sdl, const void* a, const void* b, long long sbb, long long sbl,
                 const void* c, long long scb, long long scl, void* y, void* s, int B, int L,
                 int H, int G, int N, int P, int chunk, int device, void* stream) {
  if (B <= 0 || L < 0 || H <= 0 || G <= 0 || H % G != 0 || !ssd_mma_supported(chunk, N, P))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  const long long smem = ssd_mma_smem_bytes(chunk, N, P);
  if (smem > optin) return cudaErrorInvalidValue;
  const auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = N % 8 == 0 && P % 8 == 0 && sxb % 8 == 0 && sxl % 8 == 0 && sbb % 8 == 0 &&
                   sbl % 8 == 0 && scb % 8 == 0 && scl % 8 == 0 && al16(x) && al16(b) && al16(c);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  if (vec)
    return launch_mma<true>(x, sxb, sxl, dt, sdb, sdl, a, b, sbb, sbl, c, scb, scl, y, s, B, L, H,
                            G, N, P, chunk, bytes, st);
  return launch_mma<false>(x, sxb, sxl, dt, sdb, sdl, a, b, sbb, sbl, c, scb, scl, y, s, B, L, H,
                           G, N, P, chunk, bytes, st);
}

}  // extern "C"
