// Mamba2 SSD chunked scan for Hopper (sm_90a), bound to Python with ctypes.
//
// ssd_scan_kernel replaces the Pallas kernel ssd_scan
// (src/repro/kernels/ssd_scan/ssd_scan.py, _ssd_kernel). Per (batch b, head h),
// chunk by chunk of Q rows, with the (N, P) state s carried in fp32:
//
//     cum   = cumsum(dt * a_h)                                   (Q,)
//     y     = ((C B^T) o L)(x o dt) + (C o e^cum) s              L[t,u] = e^(cum_t - cum_u), t >= u
//     s     = e^cum_end s + (B o dt o e^(cum_end - cum))^T x
//
// Design. One block per (b, h); the TPU's sequential chunk axis is a loop inside
// the block, and the state never leaves shared memory. The block reads the
// model layout in place: x (B, L, H, P), dt (B, L, H), B and C (B, L, G, N)
// through their batch and length strides, head h taking group h / (H / G), so
// B and C are never repeated over the heads. A chunk's x, B, C and dt are
// staged in fp32 (bf16 inputs widened once), cum is a warp scan, and every
// product is a 16 x 16 thread grid of register micro-tiles of scalar fp32 FMAs
// over shared memory. The Q x Q score matrix is built 32 rows at a time, and a
// row tile only computes the columns at or below its last row (the rest of the
// causal mask is zero). Rows past L (a ragged tail) are staged as zeros: dt = 0
// adds nothing to y and leaves the state undecayed. y is rounded to its dtype
// once, on store; the final state is written in fp32.
//
// What bounds it on an H100: the FMAs, BH (L/Q) (Q(Q+1)N + Q(Q+1)P + 4QNP) FLOP
// (the causal half of each chunk's score tile) against ~67 TFLOP/s of fp32 CUDA
// cores (bytes are ~10x below). This first
// version is held back further by shared-memory loads (6 for every 8 FMAs in
// the score tiles) and by one block of 256 threads per SM (the chunk of a
// full-width head takes 215 KB). Tensor cores (TF32 or bf16 mma/wgmma) and
// several heads per block are later work.

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

}  // extern "C"
