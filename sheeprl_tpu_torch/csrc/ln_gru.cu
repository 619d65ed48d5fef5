// Fused LayerNorm-GRU cell step, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pallas_ln_gru` / `_kernel` in
// sheeprl_tpu/models/pallas_gru.py (pl.pallas_call at :118), reached from
// `fused_ln_gru` (forward) and `_fwd` (training residuals). Same function:
//
//   z  = inp @ W + b                      f32 sum for f32 and bf16 inputs
//   zn = LayerNorm(z) * scale + ln_bias   statistics over the whole 3H row, eps 1e-5
//   reset = sigmoid(zn[:H]); cand = tanh(reset * zn[H:2H]); update = sigmoid(zn[2H:] - 1)
//   h' = update * cand + (1 - update) * h  written in h's dtype; z is returned in f32
//
// inp [B, D] and W [D, 3H] are in the compute dtype (f32 or bf16); b, scale
// and ln_bias [3H] are f32; h [B, H] has the compute dtype.
//
// Bound on an H100 SXM. At DreamerV3-S (D = 1024, H = 512) and a serving
// batch of 1-8 the step is a matrix-vector product: W is 6.3 MB in f32
// (3.1 MB in bf16) and is read once, against 2*B*D*3H = 25 MFLOP at B = 8.
// Reading W takes about 1.9 us at 3.35 TB/s (0.94 us in bf16); everything
// else moved is under 0.2 MB. The step is bound by the bytes of W.
//
// Design. The TPU grid walks D tiles in order with the whole 3H row in
// VMEM; at B <= 8 that is one block, which would use one of 132 SMs and
// leave HBM idle. Here:
//
// 1. `ln_gru_projection` spreads the read of W over the SMs. Blocks split
//    the 3H columns (a warp reads 32 neighbouring 16-byte vectors of a row of
//    W, 8 bf16 or 4 f32 each; rows whose length is not a multiple of that
//    fall back to one element per lane) and, split-K, the D axis: each block
//    sums its own D range for a tile of 8 batch rows and writes an f32
//    partial sum. A thread issues all eight of its loads of a 64-row group
//    before it uses any, so at DV3-S every load of W is in flight at once.
//    The rows of `inp` are staged in shared memory and read as broadcasts;
//    the eight warps' sums meet in shared memory behind one barrier.
// 2. `ln_gru_epilogue`, one block per batch row, adds the split partials in
//    a fixed order (the result does not depend on scheduling), adds b,
//    writes z, takes the row's mean and variance in f32 with block
//    reductions that work for any H (3H = 12288 at XL needs no shared-memory
//    row), and applies the gates. Each thread owns whole gate indices (the
//    three z columns i, H + i, 2H + i) and keeps them in registers. It is
//    launched as a programmatic dependent of the projection, so its launch
//    overlaps the projection and `griddepcontrol.wait` orders its reads.
//
// The partial sums cost ksplit * B * 3H * 4 bytes of L2 traffic, 0.8 MB at
// DV3-S B = 8 bf16. Measured on an H100 (PERF.md) the step takes about 11 us
// at DV3-S: two dependent kernels and their rounds of dependent loads, not
// the bytes of W, set the time. wgmma, TMA and fusing the epilogue into the
// product are later work.
//
// Plain C interface: the wrapper (sheeprl_tpu_torch/models/ln_gru.py) passes
// device pointers, sizes, the split plan, the device index and the CUDA
// stream; it allocates every output and the partial-sum scratch. Each
// function returns cudaGetLastError() after its launches, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;                          // projection block: 8 warps
constexpr int kProjThreads = 32 * kWarps;
constexpr int kRowsPerThread = 8;                  // rows of W each thread has in flight per group
constexpr int kGroupD = kWarps * kRowsPerThread;   // 64 D rows per block per group
constexpr int kTileB = 8;                          // batch rows per projection block
constexpr int kEpilogueThreads = 1024;
constexpr int kCachedGates = 4;                    // gate indices per epilogue thread kept in registers
constexpr float kLnEps = 1e-5f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// One load of VEC neighbouring elements of a row of W: 16 bytes (VEC = 4
// floats or 8 bf16) on the vector path, one element on the scalar path.
template <typename T, int VEC>
using Raw = typename std::conditional<VEC == 1, T, uint4>::type;

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& raw, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_float(raw);
  } else {
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[v] = to_float(vals[v]);
  }
}

// partial[s, b, n] = sum over d in split s of inp[b, d] * w[d, n]
// grid: (ceil(width / (32 * VEC)), ksplit, ceil(batch / kTileB)); block: kProjThreads.
// Lane l of every warp owns columns [(32 * blockIdx.x + l) * VEC, + VEC); warp
// k owns rows g0 + k + 8 r (r < 8) of each 64-row group g0 of the block's D
// range. All eight loads of a group are issued before any is used.
template <typename T, int VEC>
__global__ void __launch_bounds__(kProjThreads)
ln_gru_projection(const T* __restrict__ inp, const T* __restrict__ w, float* __restrict__ partial, int batch,
                  int depth, int width, int depth_per_split) {
  constexpr int kTileN = 32 * VEC;
  __shared__ float s_inp[kGroupD][kTileB];
  extern __shared__ float s_red[];  // [kWarps][kTileB][32][VEC + 1]; the pad keeps the stores conflict-free

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n0 = (blockIdx.x * 32 + lane) * VEC;
  const bool live = n0 < width;  // on the vector path width % VEC == 0: a vector is all in or all out
  const int b0 = blockIdx.z * kTileB;
  const int d_begin = blockIdx.y * depth_per_split;
  const int d_end = min(d_begin + depth_per_split, depth);

  float acc[kTileB][VEC];
#pragma unroll
  for (int bb = 0; bb < kTileB; ++bb)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[bb][v] = 0.f;

  for (int g0 = d_begin; g0 < d_end; g0 += kGroupD) {
    Raw<T, VEC> raw[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int d = g0 + r * kWarps + warp;
      raw[r] = (live && d < d_end) ? *reinterpret_cast<const Raw<T, VEC>*>(w + static_cast<size_t>(d) * width + n0)
                                   : Raw<T, VEC>{};
    }
    if (g0 == d_begin) asm volatile("griddepcontrol.launch_dependents;");  // let the epilogue's launch begin
    for (int i = threadIdx.x; i < kGroupD * kTileB; i += kProjThreads) {
      const int j = i % kGroupD;
      const int bb = i / kGroupD;
      const int d = g0 + j;
      const int b = b0 + bb;
      s_inp[j][bb] = (d < d_end && b < batch) ? to_float(inp[static_cast<size_t>(b) * depth + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      float wv[VEC];
      unpack<T, VEC>(raw[r], wv);
      const int j = r * kWarps + warp;
#pragma unroll
      for (int bb = 0; bb < kTileB; ++bb) {
        const float x = s_inp[j][bb];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[bb][v] = fmaf(x, wv[v], acc[bb][v]);
      }
    }
    __syncthreads();
  }

  // Sum the eight warps' partials with one barrier; fixed order over warps.
#pragma unroll
  for (int bb = 0; bb < kTileB; ++bb)
#pragma unroll
    for (int v = 0; v < VEC; ++v) s_red[((warp * kTileB + bb) * 32 + lane) * (VEC + 1) + v] = acc[bb][v];
  __syncthreads();
  const int rows = min(kTileB, batch - b0);
  for (int i = threadIdx.x; i < rows * kTileN; i += kProjThreads) {
    const int bb = i / kTileN;
    const int c = i % kTileN;
    const int col = blockIdx.x * kTileN + c;
    if (col < width) {
      const int slot = (c / VEC) * (VEC + 1) + c % VEC;
      float sum = 0.f;
#pragma unroll
      for (int y = 0; y < kWarps; ++y) sum += s_red[(y * kTileB + bb) * 32 * (VEC + 1) + slot];
      partial[(static_cast<size_t>(blockIdx.y) * batch + b0 + bb) * width + col] = sum;
    }
  }
}

template <int VEC>
constexpr int projection_smem_bytes() {
  return kWarps * kTileB * 32 * (VEC + 1) * static_cast<int>(sizeof(float));
}

// Sum of v over the block; every thread gets the total. blockDim.x is a
// multiple of 32 and at most 1024.
__device__ float block_sum(float v, float* s_red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __syncthreads();  // s_red may still be read by a previous call
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x / 32) ? s_red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// z[b, n] for the three gate columns n = i, H + i, 2H + i: the split partials
// in a fixed order (the result does not depend on scheduling), then + b.
__device__ __forceinline__ void gate_columns(const float* prow, size_t stride, int ksplit, const float* bias,
                                             int hidden, int i, float (&v)[3]) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll 4
  for (int s = 0; s < ksplit; ++s) {
    const float* p = prow + s * stride;
    a0 += p[i];
    a1 += p[hidden + i];
    a2 += p[2 * hidden + i];
  }
  v[0] = a0 + bias[i];
  v[1] = a1 + bias[hidden + i];
  v[2] = a2 + bias[2 * hidden + i];
}

__device__ __forceinline__ float gate_update(const float (&v)[3], float mean, float rstd, const float* scale,
                                             const float* ln_bias, int hidden, int i, float h) {
  const int ic = hidden + i;
  const int iu = 2 * hidden + i;
  const float r = sigmoid((v[0] - mean) * rstd * scale[i] + ln_bias[i]);
  const float c = tanhf(r * ((v[1] - mean) * rstd * scale[ic] + ln_bias[ic]));
  const float u = sigmoid((v[2] - mean) * rstd * scale[iu] + ln_bias[iu] - 1.f);
  return u * c + (1.f - u) * h;
}

// grid: (batch); block: (kEpilogueThreads). Thread t owns gate indices
// i = t + k * kEpilogueThreads and their three z columns, so the gates need
// no exchange; the first kCachedGates of them stay in registers (all of them
// up to H = 4096), wider rows re-read this thread's own z writes.
template <typename T>
__global__ void __launch_bounds__(kEpilogueThreads)
ln_gru_epilogue(const float* __restrict__ partial, int ksplit, const float* __restrict__ bias,
                const float* __restrict__ scale, const float* __restrict__ ln_bias, const T* __restrict__ h,
                T* __restrict__ h_out, float* z, int batch, int hidden) {
  // Launched as a programmatic dependent of the projection: wait here until
  // its partial sums are complete and visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __shared__ float s_red[32];
  const int b = blockIdx.x;
  const int width = 3 * hidden;
  const size_t stride = static_cast<size_t>(batch) * width;
  const float* prow = partial + static_cast<size_t>(b) * width;
  float* zrow = z + static_cast<size_t>(b) * width;
  const int wide = threadIdx.x + kCachedGates * kEpilogueThreads;  // first gate index past the cache

  float cache[kCachedGates][3];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kCachedGates; ++k) {
    const int i = threadIdx.x + k * kEpilogueThreads;
    if (i < hidden) {
      gate_columns(prow, stride, ksplit, bias, hidden, i, cache[k]);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        zrow[g * hidden + i] = cache[k][g];
        sum += cache[k][g];
      }
    }
  }
  for (int i = wide; i < hidden; i += kEpilogueThreads) {
    float v[3];
    gate_columns(prow, stride, ksplit, bias, hidden, i, v);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      zrow[g * hidden + i] = v[g];
      sum += v[g];
    }
  }
  const float mean = block_sum(sum, s_red) / width;

  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < kCachedGates; ++k) {
    if (threadIdx.x + k * kEpilogueThreads < hidden) {
#pragma unroll
      for (int g = 0; g < 3; ++g) sq += (cache[k][g] - mean) * (cache[k][g] - mean);
    }
  }
  for (int i = wide; i < hidden; i += kEpilogueThreads) {
#pragma unroll
    for (int g = 0; g < 3; ++g) sq += (zrow[g * hidden + i] - mean) * (zrow[g * hidden + i] - mean);
  }
  const float rstd = rsqrtf(block_sum(sq, s_red) / width + kLnEps);

  const size_t hrow = static_cast<size_t>(b) * hidden;
#pragma unroll
  for (int k = 0; k < kCachedGates; ++k) {
    const int i = threadIdx.x + k * kEpilogueThreads;
    if (i < hidden)
      h_out[hrow + i] = from_float<T>(gate_update(cache[k], mean, rstd, scale, ln_bias, hidden, i, to_float(h[hrow + i])));
  }
  for (int i = wide; i < hidden; i += kEpilogueThreads) {
    const float v[3] = {zrow[i], zrow[hidden + i], zrow[2 * hidden + i]};
    h_out[hrow + i] = from_float<T>(gate_update(v, mean, rstd, scale, ln_bias, hidden, i, to_float(h[hrow + i])));
  }
}

template <typename T, int VEC>
cudaError_t launch_projection(const void* inp, const void* w, void* partial, int batch, int depth, int width,
                              int depth_per_split, int ksplit, int device, cudaStream_t s) {
  constexpr int smem = projection_smem_bytes<VEC>();
  static bool opted_in[kMaxDevices] = {};  // above 48 KB of shared memory needs an opt-in, per device
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(ln_gru_projection<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  const dim3 grid((width + 32 * VEC - 1) / (32 * VEC), ksplit, (batch + kTileB - 1) / kTileB);
  ln_gru_projection<T, VEC><<<grid, kProjThreads, smem, s>>>(static_cast<const T*>(inp), static_cast<const T*>(w),
                                                             static_cast<float*>(partial), batch, depth, width,
                                                             depth_per_split);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* inp, const void* w, const void* bias, const void* scale, const void* ln_bias,
           const void* h, void* h_out, void* z, void* partial, int batch, int depth, int hidden,
           int depth_per_split, int ksplit, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = 3 * hidden;
  // 16-byte loads of W when every row starts 16-byte aligned.
  constexpr int kVec = 16 / sizeof(T);
  if (width % kVec == 0 && reinterpret_cast<std::uintptr_t>(w) % 16 == 0) {
    err = launch_projection<T, kVec>(inp, w, partial, batch, depth, width, depth_per_split, ksplit, device, s);
  } else {
    err = launch_projection<T, 1>(inp, w, partial, batch, depth, width, depth_per_split, ksplit, device, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // Programmatic dependent launch: the epilogue's launch overlaps the
  // projection's run, and griddepcontrol.wait orders its reads.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch);
  cfg.blockDim = dim3(kEpilogueThreads);
  cfg.stream = s;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ln_gru_epilogue<T>, static_cast<const float*>(partial), ksplit,
                           static_cast<const float*>(bias), static_cast<const float*>(scale),
                           static_cast<const float*>(ln_bias), static_cast<const T*>(h), static_cast<T*>(h_out),
                           static_cast<float*>(z), batch, hidden);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ln_gru_forward_f32(const void* inp, const void* w, const void* bias, const void* scale,
                                  const void* ln_bias, const void* h, void* h_out, void* z, void* partial,
                                  int batch, int depth, int hidden, int depth_per_split, int ksplit, int device,
                                  void* stream) {
  return launch<float>(inp, w, bias, scale, ln_bias, h, h_out, z, partial, batch, depth, hidden, depth_per_split,
                       ksplit, device, stream);
}

extern "C" int ln_gru_forward_bf16(const void* inp, const void* w, const void* bias, const void* scale,
                                   const void* ln_bias, const void* h, void* h_out, void* z, void* partial,
                                   int batch, int depth, int hidden, int depth_per_split, int ksplit, int device,
                                   void* stream) {
  return launch<__nv_bfloat16>(inp, w, bias, scale, ln_bias, h, h_out, z, partial, batch, depth, hidden,
                               depth_per_split, ksplit, device, stream);
}
