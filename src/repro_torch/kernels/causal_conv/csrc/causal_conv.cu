// Mamba2's causal depthwise conv with its bias and SiLU, for Hopper (sm_90a),
// bound to Python with ctypes.
//
// One pass over the prefill's x|B|C channels (conv_dim C of them, width W):
//
//     out[b, t, c] = silu(sum_{i < W} in[b, t - W + 1 + i, c] * w[i, c] + bias[c])
//
// with rows before the sequence's start read as zeros. `in` is read in place:
// a (B, S, C) view with batch and length strides, such as the x|B|C columns of
// in_proj's output, whose rows lie proj_out elements apart. Weights and bias
// are fp32; the sum and SiLU run in fp32 and the result is rounded once to the
// input's dtype (bf16 or fp32). `out` is a packed (B, S, C) tensor.
//
// The kernel is bound by bytes: each input element is read from HBM once (plus
// a halo of W - 1 rows a time tile) and each output element written once; at
// mamba2-2.7b's 5,376 bf16 channels that is 21.5 KB a token against a few
// dozen FLOPs an element. A block takes kThreads channel groups of one batch
// row over kTile timesteps; a thread walks its tile in order, keeping the last
// W - 1 rows of its channels in registers, so a row it has read is never read
// again, and the weights stay in registers for the whole tile.
//
// causal_conv_kernel<T, V>: a thread owns V channels. The vector route (V =
// 8) moves them as one 16-byte word a row (two for fp32), loading rows ahead
// of the arithmetic so that several loads are in flight a thread; it needs
// 16-byte aligned rows: the view's pointer, both its strides and C a multiple
// of 8 elements' bytes. The element route (V = 1) takes every other view (one
// a rank whose heads make proj_out odd takes) an element at a time. The conv
// width is Mamba2's 4, the only one the models use.

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;       // channel groups (or channels) a block
constexpr int kTile = 64;           // timesteps a block
constexpr int kVec = 8;             // channels a thread of the vector route
constexpr int kWidth = 4;           // conv width

// SiLU from the approximate exp and division (ex2.approx, rcp.approx): a few
// instructions an element where expf and an IEEE division take ~20, which at
// 8 elements a 16-byte load would make the bf16 route bound by issue, not by
// bytes. Relative error ~1e-6 at |v| <= 16; 0 where e^-v overflows (v < -88).
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V channels of one row as they come from memory: 16-byte words (one for 8
// bf16, two for 8 fp32), or one element.
template <typename T, int V>
struct Chans {
  uint4 w[V * sizeof(T) / 16];
};
template <typename T>
struct Chans<T, 1> {
  T e;
};

template <typename T, int V>
__device__ __forceinline__ Chans<T, V> load(const T* p) {
  Chans<T, V> r;
  if constexpr (V == 1) {
    r.e = __ldg(p);
  } else {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < V * int(sizeof(T)) / 16; ++i) r.w[i] = __ldg(q + i);
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const Chans<T, V>& r, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f(r.e);
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r.w);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    const float* f = reinterpret_cast<const float*>(r.w);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = f[i];
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = from_f<T>(v[0]);
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    uint4 o[V / 8];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(o);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
#pragma unroll
    for (int i = 0; i < V / 8; ++i) reinterpret_cast<uint4*>(p)[i] = o[i];
  } else {
    float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

// V fp32 values from p: 16-byte loads where V is a multiple of 4 (p aligned).
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __ldg(p + i);
  }
}

// Grid (ceil(C / V / kThreads), ceil(S / kTile), B). V = 8 requires C % 8 == 0
// and 16-byte aligned rows of `in`, `w` and `bias`; V = 1 takes any view.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
causal_conv_kernel(const T* __restrict__ in, long long sb, long long sl,
                   const float* __restrict__ w, const float* __restrict__ bias,
                   T* __restrict__ out, int S, int C) {
  constexpr int W = kWidth;
  constexpr int kUnroll = V > 1 && sizeof(T) == 4 ? 4 : 8;    // rows loaded ahead
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c0 >= C) return;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kTile;
  const int t1 = min(t0 + kTile, S);

  float wr[W][V], br[V];
#pragma unroll
  for (int i = 0; i < W; ++i) load_f32(w + static_cast<long long>(i) * C + c0, wr[i]);
  load_f32(bias + c0, br);

  const T* src = in + b * sb + c0;
  T* dst = out + (static_cast<long long>(b) * S) * C + c0;

  float win[W - 1][V];                // rows t - W + 1 .. t - 1
#pragma unroll
  for (int i = 0; i < W - 1; ++i) {
    const int t = t0 - (W - 1) + i;
    if (t >= 0) {
      unpack(load<T, V>(src + t * sl), win[i]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) win[i][k] = 0.0f;
    }
  }

  for (int t = t0; t < t1; t += kUnroll) {
    Chans<T, V> rows[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (t + u < t1) rows[u] = load<T, V>(src + (t + u) * sl);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u < t1) {
        float cur[V], acc[V];
        unpack(rows[u], cur);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float a = br[k];
#pragma unroll
          for (int i = 0; i < W - 1; ++i) a = fmaf(win[i][k], wr[i][k], a);
          acc[k] = silu(fmaf(cur[k], wr[W - 1][k], a));
        }
        store<T, V>(dst + static_cast<long long>(t + u) * C, acc);
#pragma unroll
        for (int i = 0; i < W - 2; ++i)
#pragma unroll
          for (int k = 0; k < V; ++k) win[i][k] = win[i + 1][k];
#pragma unroll
        for (int k = 0; k < V; ++k) win[W - 2][k] = cur[k];
      }
    }
  }
}

template <typename T>
cudaError_t launch(bool vec, const void* in, long long sb, long long sl, const float* w,
                   const float* bias, void* out, int B, int S, int C, cudaStream_t stream) {
  const int per_block = vec ? kThreads * kVec : kThreads;
  const dim3 grid((C + per_block - 1) / per_block, (S + kTile - 1) / kTile, B);
  const T* x = static_cast<const T*>(in);
  T* y = static_cast<T*>(out);
  if (vec)
    causal_conv_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(x, sb, sl, w, bias, y, S, C);
  else
    causal_conv_kernel<T, 1><<<grid, kThreads, 0, stream>>>(x, sb, sl, w, bias, y, S, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* causal_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 1 when the vector route takes a view: 16-byte aligned pointers and rows,
// C a multiple of 8. Strides in elements of `in`'s dtype (bf16 when bf16).
int causal_conv_vec_ok(int bf16, const void* in, long long sb, long long sl, const void* w,
                       const void* bias, int C) {
  const long long es = bf16 ? 2 : 4;
  const auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return C % kVec == 0 && (sb * es) % 16 == 0 && (sl * es) % 16 == 0 && al16(in) && al16(w) &&
         al16(bias);
}

// Returns a cudaError_t: 0 on a launch that was accepted; cudaErrorInvalidValue
// for a width other than 4, a shape out of range or a
// view the vector route refuses when `vec` asks for it. `bf16` selects the
// dtype of `in` and `out`: 0 float, 1 bfloat16; `w` (W, C) and `bias` (C,) are
// packed fp32.
int causal_conv(int bf16, int vec, const void* in, long long sb, long long sl, const void* w,
                const void* bias, void* out, int B, int S, int C, int width, int device,
                void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || B > 65535 || (S + kTile - 1) / kTile > 65535 ||
      width != kWidth)
    return cudaErrorInvalidValue;
  if (vec && !causal_conv_vec_ok(bf16, in, sb, sl, w, bias, C)) return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  if (bf16) return launch<__nv_bfloat16>(vec != 0, in, sb, sl, wf, bf, out, B, S, C, st);
  return launch<float>(vec != 0, in, sb, sl, wf, bf, out, B, S, C, st);
}

}  // extern "C"
