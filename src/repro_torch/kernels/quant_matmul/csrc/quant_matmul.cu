// W8A8 integer matmul with a fused dequantizing epilogue, for Hopper (sm_90a),
// bound to Python with ctypes.
//
// quant_matmul_kernel replaces the Pallas kernel quant_matmul
// (src/repro/kernels/quant_matmul/quant_matmul.py, _quant_matmul_kernel):
//
//     acc = x_q . w_q                      x_q int8 (M, K), w_q int8 (K, N), int32 sum
//     y   = ((float) acc * sx) * sw[n]     sx fp32 scalar, sw fp32 (N,), y fp32 (M, N)
//
// Design. One block of 256 threads per 64 x 64 output tile; K is swept in
// steps of 32 bytes staged in shared memory as int32 words of four k values:
// rows of x as they lie, columns of w (row-major (K, N)) gathered into words
// along k, so that both operands of __dp4a are four consecutive k. Each thread
// keeps a 4 x 4 register tile of int32 sums (exact: |acc| <= K 127^2), and the
// epilogue scales in the reference's order, so the kernel equals its plain
// version bit for bit. Ragged M, N and K are masked in the kernel (zeros are
// staged past the edges); no padded copy is made. sx is read from device
// memory, so a caller never syncs to hand it over.
//
// What bounds it on an H100: the multiply-adds, 2MKN, against 1,979 TOP/s of
// int8 tensor cores (bytes are below that for the serving shapes). This first
// version runs on the integer pipe through __dp4a (4 MACs an instruction) and
// is far from that bound; mma.sync/wgmma s8 tiles with TMA loads are later work.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;             // output rows of a block
constexpr int kBN = 64;             // output columns of a block
constexpr int kBK = 32;             // k values staged per step
constexpr int kKW = kBK / 4;        // int32 words per staged row
constexpr int kLd = kKW + 1;        // padded word stride: no bank conflicts

__global__ void __launch_bounds__(kThreads)
    quant_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ sx, const float* __restrict__ sw,
                        float* __restrict__ out, int M, int N, int K) {
  __shared__ int xs[kBM * kLd];
  __shared__ int ws[kBN * kLd];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // Rows of x: word (r, kw) holds x[m0 + r, k0 + 4 kw + t] in byte t.
    for (int i = tid; i < kBM * kKW; i += kThreads) {
      const int r = i / kKW;
      const int kw = i % kKW;
      const int m = m0 + r;
      uint32_t word = 0u;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = k0 + 4 * kw + t;
        const uint32_t v =
            (m < M && k < K) ? static_cast<uint8_t>(x[static_cast<size_t>(m) * K + k]) : 0u;
        word |= v << (8 * t);
      }
      xs[r * kLd + kw] = static_cast<int>(word);
    }
    // Columns of w: word (c, kw) holds w[k0 + 4 kw + t, n0 + c] in byte t.
    for (int i = tid; i < kBN * kKW; i += kThreads) {
      const int c = i % kBN;
      const int kw = i / kBN;
      const int n = n0 + c;
      uint32_t word = 0u;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = k0 + 4 * kw + t;
        const uint32_t v =
            (n < N && k < K) ? static_cast<uint8_t>(w[static_cast<size_t>(k) * N + n]) : 0u;
        word |= v << (8 * t);
      }
      ws[c * kLd + kw] = static_cast<int>(word);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kKW; ++kw) {
      int ra[4], rb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ra[i] = xs[(ty + 16 * i) * kLd + kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) rb[j] = ws[(tx + 16 * j) * kLd + kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float s = *sx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[static_cast<size_t>(m) * N + n] = (static_cast<float>(acc[i][j]) * s) * sw[n];
    }
  }
}

}  // namespace

extern "C" {

const char* qmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns a cudaError_t: 0 on a launch that was accepted.
int qmm_matmul(const void* x, const void* w, const void* sx, const void* sw, void* out, int M,
               int N, int K, int device, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  quant_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw), static_cast<float*>(out), M,
      N, K);
  return cudaGetLastError();
}

}  // extern "C"
