// Fused LayerNorm-GRU cell step, backward of the elementwise tail, for Hopper (sm_90a).
//
// Replaces `_bwd` of `fused_ln_gru` in sheeprl_tpu/models/pallas_gru.py
// (:172-182, `defvjp` :185): the VJP of `_gates_from_z` (:42-55) taken from
// the forward's saved f32 z, with no recompute of the product. For
// g = dL/dh' [B, H], z [B, 3H] f32, scale and ln_bias [3H] f32 and h [B, H]:
//
//   xhat = (z - mean) * rstd         row statistics over 3H (eps 1e-5), recomputed from z
//   y = xhat * scale + ln_bias;  r = sigmoid(y_r);  c = tanh(r * y_c);  u = sigmoid(y_u - 1)
//   dh_tail = g (1 - u)
//   dy_u = g (c - h) u (1 - u);  dy_c = g u (1 - c^2) r;  dy_r = g u (1 - c^2) y_c r (1 - r)
//   dscale = sum_b dy * xhat;  dln_bias = sum_b dy
//   dz = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),  dxhat = dy * scale
//
// It writes dz [B, 3H] f32, dh_tail [B, H] in h's dtype, and dscale and
// dln_bias [3H] f32. The three products (dinp = dz W^T, dW = inp^T dz,
// db = sum_b dz) stay torch.matmul in f32 in the wrapper, as the JAX package
// leaves them to XLA outside any Pallas kernel (:179-181).
//
// Bound on an H100 SXM. The tail is elementwise plus row reductions: about
// 40 operations per z element against 8 bytes of z and dz, so it is bound by
// bytes. At DreamerV3-S (H = 512) and the dynamic scan's B = 16 it moves
// about 0.25 MB (z and dz in f32, g, h and dh_tail in bf16): under 0.1 us at
// 3.35 TB/s, so launch latency, not bytes, sets its time. At B = 1024 it
// moves about 14 MB, about 4 us.
//
// Design. The TPU version is plain JAX differentiated by XLA; here:
//
// 1. `ln_gru_bwd_rows`: a block takes `rows` consecutive batch rows. Thread t
//    owns the gate indices i = t + k * blockDim and their three z columns
//    (i, H + i, 2H + i) in every row, so it reads and writes only its own
//    columns. Per row: two block reductions give the mean and variance of z
//    (the forward's two-pass order), one pass computes the gates and dy,
//    writes dh_tail, keeps dxhat in dz as scratch and adds dy * xhat and dy
//    into the block's partial rows of dscale and dln_bias, one two-value
//    block reduction gives mean(dxhat) and mean(dxhat * xhat), and a last
//    pass turns the dxhat scratch into dz. Any H works: no row is held in
//    shared memory.
// 2. `ln_gru_bwd_reduce`: dscale and dln_bias are the sums of the per-block
//    partials in block order, one thread per column, launched as a
//    programmatic dependent of (1). A fixed order and no atomics, the rule of
//    the forward's split-K: a gradient step is a function of its inputs.
//
// Plain C interface: the wrapper (sheeprl_tpu_torch/models/ln_gru.py) passes
// device pointers, sizes, the rows per block, the device index and the CUDA
// stream; it allocates every output and the partial-sum scratch
// [2, ceil(B / rows), 3H] f32. Each function returns cudaGetLastError() after
// its launches, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kReduceThreads = 128;
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums of a and b over the block; every thread gets both totals. blockDim.x
// is a multiple of 32 and at most 1024; s_red holds 64 floats.
__device__ void block_sum2(float& a, float& b, float* s_red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __syncthreads();  // s_red may still be read by a previous call
  if (lane == 0) {
    s_red[warp] = a;
    s_red[32 + warp] = b;
  }
  __syncthreads();
  const bool live = lane < static_cast<int>(blockDim.x / 32);
  a = warp_sum(live ? s_red[lane] : 0.f);
  b = warp_sum(live ? s_red[32 + lane] : 0.f);
}

__device__ __forceinline__ float block_sum(float v, float* s_red) {
  float unused = 0.f;
  block_sum2(v, unused, s_red);
  return v;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// grid: (ceil(batch / rows)); block: a multiple of 32, at most kMaxThreads.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
ln_gru_bwd_rows(const T* __restrict__ g, const float* __restrict__ z, const float* __restrict__ scale,
                const float* __restrict__ ln_bias, const T* __restrict__ h, float* __restrict__ dz,
                T* __restrict__ dh, float* __restrict__ part_scale, float* __restrict__ part_bias, int batch,
                int hidden, int rows) {
  asm volatile("griddepcontrol.launch_dependents;");  // let the reduction's launch begin
  __shared__ float s_red[64];
  const int width = 3 * hidden;
  const int b0 = blockIdx.x * rows;
  const int b1 = min(b0 + rows, batch);
  float* pscale = part_scale + static_cast<size_t>(blockIdx.x) * width;
  float* pbias = part_bias + static_cast<size_t>(blockIdx.x) * width;

  for (int b = b0; b < b1; ++b) {
    const float* zrow = z + static_cast<size_t>(b) * width;
    float* dzrow = dz + static_cast<size_t>(b) * width;
    const size_t hrow = static_cast<size_t>(b) * hidden;

    float sum = 0.f;
    for (int n = threadIdx.x; n < width; n += blockDim.x) sum += zrow[n];
    const float mean = block_sum(sum, s_red) / width;
    float sq = 0.f;
    for (int n = threadIdx.x; n < width; n += blockDim.x) sq += (zrow[n] - mean) * (zrow[n] - mean);
    const float rstd = rsqrtf(block_sum(sq, s_red) / width + kLnEps);

    float s1 = 0.f;  // sum of dxhat
    float s2 = 0.f;  // sum of dxhat * xhat
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      float xh[3], y[3], dy[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int col = k * hidden + i;
        xh[k] = (zrow[col] - mean) * rstd;
        y[k] = xh[k] * scale[col] + ln_bias[col];
      }
      const float r = sigmoid(y[0]);
      const float c = tanhf(r * y[1]);
      const float u = sigmoid(y[2] - 1.f);
      const float gv = to_float(g[hrow + i]);
      const float hv = to_float(h[hrow + i]);
      dh[hrow + i] = from_float<T>(gv * (1.f - u));
      const float dpre = gv * u * (1.f - c * c);  // d/d(r * y_c)
      dy[0] = dpre * y[1] * r * (1.f - r);
      dy[1] = dpre * r;
      dy[2] = gv * (c - hv) * u * (1.f - u);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int col = k * hidden + i;
        if (b == b0) {
          pscale[col] = dy[k] * xh[k];
          pbias[col] = dy[k];
        } else {
          pscale[col] += dy[k] * xh[k];
          pbias[col] += dy[k];
        }
        const float dxh = dy[k] * scale[col];
        dzrow[col] = dxh;  // scratch until the row's means are known
        s1 += dxh;
        s2 += dxh * xh[k];
      }
    }
    block_sum2(s1, s2, s_red);
    const float m1 = s1 / width;
    const float m2 = s2 / width;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int col = k * hidden + i;
        const float xh = (zrow[col] - mean) * rstd;
        dzrow[col] = rstd * (dzrow[col] - m1 - xh * m2);
      }
    }
  }
}

// grid: (ceil(width / kReduceThreads)); one thread per column, blocks summed in order.
__global__ void __launch_bounds__(kReduceThreads)
ln_gru_bwd_reduce(const float* __restrict__ part_scale, const float* __restrict__ part_bias,
                  float* __restrict__ dscale, float* __restrict__ dln_bias, int nblocks, int width) {
  // Launched as a programmatic dependent of the row kernel: wait here until
  // its partials are complete and visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= width) return;
  float a = 0.f;
  float c = 0.f;
#pragma unroll 8
  for (int k = 0; k < nblocks; ++k) {
    a += part_scale[static_cast<size_t>(k) * width + col];
    c += part_bias[static_cast<size_t>(k) * width + col];
  }
  dscale[col] = a;
  dln_bias[col] = c;
}

template <typename T>
int launch(const void* g, const void* z, const void* scale, const void* ln_bias, const void* h, void* dz, void* dh,
           void* dscale, void* dln_bias, void* partial, int batch, int hidden, int rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || hidden < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = 3 * hidden;
  const int nblocks = (batch + rows - 1) / rows;
  int threads = (hidden + 31) / 32 * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  float* part_scale = static_cast<float*>(partial);
  float* part_bias = part_scale + static_cast<size_t>(nblocks) * width;
  ln_gru_bwd_rows<T><<<nblocks, threads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const float*>(z), static_cast<const float*>(scale),
      static_cast<const float*>(ln_bias), static_cast<const T*>(h), static_cast<float*>(dz), static_cast<T*>(dh),
      part_scale, part_bias, batch, hidden, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((width + kReduceThreads - 1) / kReduceThreads);
  cfg.blockDim = dim3(kReduceThreads);
  cfg.stream = s;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ln_gru_bwd_reduce, static_cast<const float*>(part_scale),
                           static_cast<const float*>(part_bias), static_cast<float*>(dscale),
                           static_cast<float*>(dln_bias), nblocks, width);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ln_gru_backward_f32(const void* g, const void* z, const void* scale, const void* ln_bias,
                                   const void* h, void* dz, void* dh, void* dscale, void* dln_bias, void* partial,
                                   int batch, int hidden, int rows, int device, void* stream) {
  return launch<float>(g, z, scale, ln_bias, h, dz, dh, dscale, dln_bias, partial, batch, hidden, rows, device,
                       stream);
}

extern "C" int ln_gru_backward_bf16(const void* g, const void* z, const void* scale, const void* ln_bias,
                                    const void* h, void* dz, void* dh, void* dscale, void* dln_bias, void* partial,
                                    int batch, int hidden, int rows, int device, void* stream) {
  return launch<__nv_bfloat16>(g, z, scale, ln_bias, h, dz, dh, dscale, dln_bias, partial, batch, hidden, rows,
                               device, stream);
}
