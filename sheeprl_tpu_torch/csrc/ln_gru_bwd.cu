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
// 3.35 TB/s, so launch latency and dependent rounds, not bytes, set its time.
// At B = 1024 it moves about 14 MB, about 4 us.
//
// Design: one launch, `ln_gru_bwd_fused`.
//
// 1. A block takes `rows` consecutive batch rows (the wrapper's
//    backward_plan). Thread t owns the gate indices i = t + k * blockDim and
//    their three z columns (i, H + i, 2H + i) in every row. The first four of
//    them (every one up to H = 1024 with 256 threads) keep z, xhat and dxhat
//    in registers between the row's reductions, so nothing is parked in
//    memory; wider rows recompute them from z. Per row: two block reductions
//    give the mean and variance (the forward's two-pass order) and one
//    two-value reduction gives mean(dxhat) and mean(dxhat * xhat). The
//    thread's dscale and dln_bias sums over the block's rows stay in
//    registers and are written once, as the block's partial row.
// 2. dscale and dln_bias are summed over the blocks in the same launch. The
//    blocks form clusters of up to 16 (the dynamic scan's B = 16 is one
//    cluster of 16 one-row blocks; two blocks fit on an SM, so a cluster
//    needs 8 SMs of a GPC). After a cluster barrier, each CTA of a
//    cluster adds one slice of the columns over the cluster's partial rows,
//    in block order (read from L2; over distributed shared memory it measured
//    slower). With one cluster that is the result: no ticket and no
//    second pass. With several, each writes its cluster sums, and the last
//    cluster to close a slice's arrival ticket adds them in cluster order and
//    resets the ticket. Atomics only count arrivals: every sum is taken in a
//    fixed order, so a gradient step is a function of its inputs.
//
// Plain C interface: the wrapper (sheeprl_tpu_torch/models/ln_gru.py) passes
// device pointers, sizes, the plan (rows and threads per block, blocks, the
// cluster size), the device index and the CUDA stream; it allocates every
// output, the scratch ([blocks + clusters, 2, 3H] f32) and keeps the zeroed
// tickets. Each function returns cudaGetLastError() after its launch, 0 on
// success.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;  // 128 registers a thread and two blocks an SM
constexpr int kCached = 4;  // gate indices per thread kept in registers
constexpr int kMaxCluster = 16;  // row blocks per cluster (a non-portable size on H100)
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

// The tail's gradient at one gate index of one row, from its three z values
// and the LayerNorm's scale and bias of the three columns: xhat and dy of the
// three columns, and dh_tail.
__device__ __forceinline__ float gate_grad(const float (&v)[3], float mean, float rstd, const float (&sc)[3],
                                           const float (&lb)[3], float gv, float hv, float (&xh)[3],
                                           float (&dy)[3]) {
  float y[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    xh[k] = (v[k] - mean) * rstd;
    y[k] = xh[k] * sc[k] + lb[k];
  }
  const float r = sigmoid(y[0]);
  const float c = tanhf(r * y[1]);
  const float u = sigmoid(y[2] - 1.f);
  const float dpre = gv * u * (1.f - c * c);  // d/d(r * y_c)
  dy[0] = dpre * y[1] * r * (1.f - r);
  dy[1] = dpre * r;
  dy[2] = gv * (c - hv) * u * (1.f - u);
  return gv * (1.f - u);
}

// Programmatic dependent launch: the block may start while the previous
// kernel on the stream finishes; wait for it before touching global memory,
// then let the next kernel start launching (it waits the same way).
__device__ __forceinline__ void pdl_begin() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Count this block in at `ticket`; true in the block that makes the count
// reach `expected` (it also resets the ticket). The block's global writes
// before the call are visible to that block after it.
__device__ __forceinline__ bool last_to_arrive(int* ticket, int expected, int* s_flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // after the barrier: covers the block's writes (the pattern of a grid barrier)
    const int last = atomicAdd(ticket, 1) == expected - 1;
    if (last) {
      *ticket = 0;
      __threadfence();
    }
    *s_flag = last;
  }
  __syncthreads();
  return *s_flag != 0;
}

// grid: (blocks, a multiple of the cluster size), cluster (cluster_size);
// block: a multiple of 32, at most kMaxThreads.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
ln_gru_bwd_fused(const T* __restrict__ g, const float* __restrict__ z, const float* __restrict__ scale,
                 const float* __restrict__ ln_bias, const T* __restrict__ h, float* __restrict__ dz,
                 T* __restrict__ dh, float* __restrict__ out, float* __restrict__ scratch, int* __restrict__ tickets,
                 int batch, int hidden, int rows, unsigned cluster_size) {
  __shared__ float s_red[64];
  __shared__ int s_flag;
  pdl_begin();
  const int width = 3 * hidden;
  const int nthreads = blockDim.x;
  const int b0 = blockIdx.x * rows;
  const int b1 = min(b0 + rows, batch);  // the grid's last blocks may have no rows
  const int wide = threadIdx.x + kCached * nthreads;  // first gate index past the registers
  const size_t stride = 2 * static_cast<size_t>(width);
  float* part = scratch + blockIdx.x * stride;  // [dscale | dln_bias] of this block

  float ps[kCached][3], pb[kCached][3], sc[kCached][3], lb[kCached][3];
#pragma unroll
  for (int k = 0; k < kCached; ++k) {
    const int i = threadIdx.x + k * nthreads;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ps[k][c] = pb[k][c] = 0.f;
      sc[k][c] = i < hidden ? scale[c * hidden + i] : 0.f;
      lb[k][c] = i < hidden ? ln_bias[c * hidden + i] : 0.f;
    }
  }

  for (int b = b0; b < b1; ++b) {
    const float* zrow = z + static_cast<size_t>(b) * width;
    float* dzrow = dz + static_cast<size_t>(b) * width;
    const size_t hrow = static_cast<size_t>(b) * hidden;

    // z, g and h of the thread's gate indices, all loads in flight at once.
    float v[kCached][3], gv[kCached], hv[kCached];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kCached; ++k) {
      const int i = threadIdx.x + k * nthreads;
      gv[k] = i < hidden ? to_float(g[hrow + i]) : 0.f;
      hv[k] = i < hidden ? to_float(h[hrow + i]) : 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[k][c] = i < hidden ? zrow[c * hidden + i] : 0.f;
        sum += v[k][c];
      }
    }
    for (int i = wide; i < hidden; i += nthreads) sum += zrow[i] + zrow[hidden + i] + zrow[2 * hidden + i];
    const float mean = block_sum(sum, s_red) / width;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < kCached; ++k)
      if (threadIdx.x + k * nthreads < hidden)
#pragma unroll
        for (int c = 0; c < 3; ++c) sq += (v[k][c] - mean) * (v[k][c] - mean);
    for (int i = wide; i < hidden; i += nthreads)
#pragma unroll
      for (int c = 0; c < 3; ++c) sq += (zrow[c * hidden + i] - mean) * (zrow[c * hidden + i] - mean);
    const float rstd = rsqrtf(block_sum(sq, s_red) / width + kLnEps);

    float s1 = 0.f;  // sum of dxhat
    float s2 = 0.f;  // sum of dxhat * xhat
    float xh[kCached][3], dxh[kCached][3];
#pragma unroll
    for (int k = 0; k < kCached; ++k) {
      const int i = threadIdx.x + k * nthreads;
      if (i < hidden) {
        float dy[3];
        dh[hrow + i] = from_float<T>(gate_grad(v[k], mean, rstd, sc[k], lb[k], gv[k], hv[k], xh[k], dy));
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          ps[k][c] += dy[c] * xh[k][c];
          pb[k][c] += dy[c];
          dxh[k][c] = dy[c] * sc[k][c];
          s1 += dxh[k][c];
          s2 += dxh[k][c] * xh[k][c];
        }
      }
    }
    for (int i = wide; i < hidden; i += nthreads) {  // wider rows: partials in this block's own scratch columns
      const float vw[3] = {zrow[i], zrow[hidden + i], zrow[2 * hidden + i]};
      const float scw[3] = {scale[i], scale[hidden + i], scale[2 * hidden + i]};
      const float lbw[3] = {ln_bias[i], ln_bias[hidden + i], ln_bias[2 * hidden + i]};
      float xw[3], dy[3];
      dh[hrow + i] = from_float<T>(gate_grad(vw, mean, rstd, scw, lbw, to_float(g[hrow + i]), to_float(h[hrow + i]), xw, dy));
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int col = c * hidden + i;
        part[col] = (b == b0 ? 0.f : part[col]) + dy[c] * xw[c];
        part[width + col] = (b == b0 ? 0.f : part[width + col]) + dy[c];
        const float d = dy[c] * scale[col];
        s1 += d;
        s2 += d * xw[c];
      }
    }
    block_sum2(s1, s2, s_red);
    const float m1 = s1 / width;
    const float m2 = s2 / width;
#pragma unroll
    for (int k = 0; k < kCached; ++k) {
      const int i = threadIdx.x + k * nthreads;
      if (i < hidden)
#pragma unroll
        for (int c = 0; c < 3; ++c) dzrow[c * hidden + i] = rstd * (dxh[k][c] - m1 - xh[k][c] * m2);
    }
    for (int i = wide; i < hidden; i += nthreads) {
      const float vw[3] = {zrow[i], zrow[hidden + i], zrow[2 * hidden + i]};
      const float scw[3] = {scale[i], scale[hidden + i], scale[2 * hidden + i]};
      const float lbw[3] = {ln_bias[i], ln_bias[hidden + i], ln_bias[2 * hidden + i]};
      float xw[3], dy[3];
      gate_grad(vw, mean, rstd, scw, lbw, to_float(g[hrow + i]), to_float(h[hrow + i]), xw, dy);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int col = c * hidden + i;
        dzrow[col] = rstd * (dy[c] * scale[col] - m1 - xw[c] * m2);
      }
    }
  }
  if (b0 >= b1)  // no rows: the wide columns were never written
    for (int i = wide; i < hidden; i += nthreads)
#pragma unroll
      for (int c = 0; c < 3; ++c) part[c * hidden + i] = part[width + c * hidden + i] = 0.f;
#pragma unroll
  for (int k = 0; k < kCached; ++k) {
    const int i = threadIdx.x + k * nthreads;
    if (i < hidden)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        part[c * hidden + i] = ps[k][c];
        part[width + c * hidden + i] = pb[k][c];
      }
  }

  // dscale and dln_bias: the cluster's partial rows summed in block order,
  // each CTA of the cluster taking one slice of the 2 * 3H columns.
  const int csize = static_cast<int>(cluster_size);
  const int rank = blockIdx.x % csize;
  const int cl = blockIdx.x / csize;
  const int nclusters = gridDim.x / csize;
  const int slice = (2 * width + csize - 1) / csize;
  const int c0 = min(rank * slice, 2 * width);
  const int c1 = min(c0 + slice, 2 * width);
  float* cluster_sums = scratch + static_cast<size_t>(gridDim.x) * stride;
  float* dst = nclusters == 1 ? out : cluster_sums + cl * stride;
  cg::this_cluster().sync();  // the cluster's partial rows are written and visible
  const float* rows_of_cluster = scratch + static_cast<size_t>(cl) * csize * stride;
  for (int c = c0 + static_cast<int>(threadIdx.x); c < c1; c += nthreads) {
    float v[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) v[k] = k < csize ? __ldcg(rows_of_cluster + k * stride + c) : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) sum += v[k];
    dst[c] = sum;
  }
  if (nclusters == 1) return;
  // Several clusters: the last cluster to close a slice's ticket adds the
  // clusters' sums of that slice in cluster order.
  if (!last_to_arrive(tickets + rank, nclusters, &s_flag)) return;
  for (int c = c0 + static_cast<int>(threadIdx.x); c < c1; c += nthreads) {
    float sum = 0.f;
    for (int k = 0; k < nclusters; ++k) sum += __ldcg(cluster_sums + k * stride + c);
    out[c] = sum;
  }
}

template <typename T>
int launch(const void* g, const void* z, const void* scale, const void* ln_bias, const void* h, void* dz, void* dh,
           void* out, void* scratch, void* tickets, int batch, int hidden, int rows, int threads, int blocks,
           int cluster, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || hidden < 1 || rows < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      cluster < 1 || cluster > kMaxCluster || blocks % cluster != 0 || static_cast<long>(blocks) * rows < batch ||
      device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in[kMaxDevices] = {};  // clusters above 8 CTAs need an opt-in, per device
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(ln_gru_bwd_fused<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;  // overlap this launch with the previous kernel
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, ln_gru_bwd_fused<T>, static_cast<const T*>(g), static_cast<const float*>(z),
                           static_cast<const float*>(scale), static_cast<const float*>(ln_bias),
                           static_cast<const T*>(h), static_cast<float*>(dz), static_cast<T*>(dh),
                           static_cast<float*>(out), static_cast<float*>(scratch), static_cast<int*>(tickets), batch,
                           hidden, rows, static_cast<unsigned>(cluster));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out: dscale [3H] then dln_bias [3H], one f32 buffer.
extern "C" int ln_gru_backward_f32(const void* g, const void* z, const void* scale, const void* ln_bias,
                                   const void* h, void* dz, void* dh, void* out, void* scratch, void* tickets,
                                   int batch, int hidden, int rows, int threads, int blocks, int cluster,
                                   int device, void* stream) {
  return launch<float>(g, z, scale, ln_bias, h, dz, dh, out, scratch, tickets, batch, hidden, rows, threads, blocks,
                       cluster, device, stream);
}

extern "C" int ln_gru_backward_bf16(const void* g, const void* z, const void* scale, const void* ln_bias,
                                    const void* h, void* dz, void* dh, void* out, void* scratch, void* tickets,
                                    int batch, int hidden, int rows, int threads, int blocks, int cluster,
                                    int device, void* stream) {
  return launch<__nv_bfloat16>(g, z, scale, ln_bias, h, dz, dh, out, scratch, tickets, batch, hidden, rows, threads,
                               blocks, cluster, device, stream);
}
