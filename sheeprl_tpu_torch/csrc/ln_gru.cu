// Fused LayerNorm-GRU cell step, forward, streaming W, for Hopper (sm_90a).
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
// and ln_bias [3H] are f32; h [B, H] has the compute dtype. This kernel takes
// every shape the tensor-core kernel (csrc/ln_gru_tc.cu) does not: serving
// (B = 1-8), the dynamic scan (B = 16), every f32 call and shapes outside the
// tile plan (models/ln_gru.py:forward_plan).
//
// Bound on an H100 SXM. At DreamerV3-S (D = 1024, H = 512) and a batch of
// 1-16 the step is a matrix-vector product: W is 6.3 MB in f32 (3.1 MB in
// bf16) and is read once, against 2*B*D*3H = 50 MFLOP at B = 16. Reading W
// takes about 1.9 us at 3.35 TB/s (0.94 us in bf16); everything else moved is
// under 0.3 MB. The step is bound by the bytes of W.
//
// Design: one launch, `ln_gru_stream_forward`.
//
// 1. The read of W is spread over the SMs. Blocks split the 3H columns (a
//    warp reads 32 neighbouring 16-byte vectors of a row of W, 8 bf16 or 4
//    f32 each; rows whose length is not a multiple of that fall back to one
//    element per lane) and, split-K, the D axis (at most 16 splits): each
//    block sums its own D range for a tile of 8 batch rows into an f32
//    partial in its shared memory. A thread issues all eight of its loads of
//    a 64-row group before it uses any, so every load of W is in flight at
//    once. The rows of `inp` are staged in shared memory and read as
//    broadcasts; the eight warps' sums meet in shared memory behind one
//    barrier.
// 2. The splits of a (column block, batch tile) form one thread block
//    cluster. After a cluster barrier, split s adds rows s, s + ksplit, ...
//    of the partials over distributed shared memory in split order, adds b,
//    writes z, and writes each row's sum and squared deviation about its own
//    mean over its columns. No partial sum goes through global memory.
// 3. For each batch row, the last column block to write the row's statistics,
//    by the row's arrival ticket, combines the column blocks' statistics in
//    column order (the exact parallel-variance formula:
//    M2 = sum_c M2_c + n_c (mean_c - mean)^2, with no cancellation of large
//    squares) and applies the row's gates; the rows of a tile finish in
//    different blocks. It resets the ticket, so no memset launch is needed
//    between calls. The tile's h, scale and ln_bias were prefetched into L2
//    at the start.
//
// Atomics only count arrivals; every sum is taken in a fixed order, so the
// result does not depend on scheduling. The wrapper keeps one zeroed ticket
// buffer per device and stream (kernels on one stream do not overlap).
//
// Plain C interface: the wrapper (sheeprl_tpu_torch/models/ln_gru.py) passes
// device pointers, sizes, the plan's vector width and split, the device index
// and the CUDA stream; it allocates every output and the scratch (the column
// blocks' row statistics [B, ceil(3H / (32 vec))] float2). Each function returns cudaGetLastError()
// after its launch, 0 on success.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;                          // 8 warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerThread = 8;                  // rows of W each thread has in flight per group
constexpr int kGroupD = kWarps * kRowsPerThread;   // 64 D rows per block per group
constexpr int kTileB = 8;                          // batch rows per block (one warp per row in the epilogue)
constexpr int kMaxSplit = 16;                      // splits of D: one cluster (non-portable above 8)
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// h' at one gate index from its three z values, the row's statistics and
// the LayerNorm's scale and bias of the three columns.
__device__ __forceinline__ float gate_update(const float (&v)[3], float mean, float rstd, const float (&sc)[3],
                                             const float (&lb)[3], float h) {
  const float r = sigmoid((v[0] - mean) * rstd * sc[0] + lb[0]);
  const float c = tanhf(r * ((v[1] - mean) * rstd * sc[1] + lb[1]));
  const float u = sigmoid((v[2] - mean) * rstd * sc[2] + lb[2] - 1.f);
  return u * c + (1.f - u) * h;
}

// Programmatic dependent launch: the block may start while the previous
// kernel on the stream finishes; wait for it before touching global memory,
// then let the next kernel start launching (it waits the same way).
__device__ __forceinline__ void pdl_begin() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Add one to a ticket with release and acquire semantics at GPU scope: the
// block's writes before its barrier are visible to whoever closes the ticket,
// and the closer sees all of them. Returns the count before the add.
__device__ __forceinline__ int ticket_add(int* ticket) {
  int before;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n" : "=r"(before) : "l"(ticket) : "memory");
  return before;
}

// Ask L2 for part `part` of `parts` of [base, base + bytes), 128-byte lines.
__device__ __forceinline__ void prefetch_l2(const void* base, size_t bytes, int part, int parts) {
  const size_t lines = (bytes + 127) / 128;
  const size_t per = (lines + parts - 1) / parts;
  const size_t stop = (part + 1) * per;
  const size_t end = stop < lines ? stop : lines;
  for (size_t l = part * per + threadIdx.x; l < end; l += blockDim.x)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(static_cast<const char*>(base) + l * 128));
}

// grid: (nx = ceil(width / (32 * VEC)), ksplit, ceil(batch / kTileB)), cluster
// (1, ksplit, 1); block: kThreads.
// Lane l of every warp owns columns [(32 * blockIdx.x + l) * VEC, + VEC); warp
// k owns rows g0 + k + 8 r (r < 8) of each 64-row group g0 of the block's D
// range. All eight loads of a group are issued before any is used.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
ln_gru_stream_forward(const T* __restrict__ inp, const T* __restrict__ w, const float* __restrict__ bias,
                      const float* __restrict__ scale, const float* __restrict__ ln_bias, const T* __restrict__ h,
                      T* __restrict__ h_out, float* __restrict__ z, float2* __restrict__ stats, int* __restrict__ tickets, int batch, int depth, int hidden,
                      int depth_per_split) {
  constexpr int kTileN = 32 * VEC;
  __shared__ float s_inp[kGroupD][kTileB];
  __shared__ float s_part[kTileB * kTileN];  // this split's partial sums, read by the cluster
  __shared__ float s_mean[kTileB];
  __shared__ float s_rstd[kTileB];
  __shared__ int s_flag;
  extern __shared__ float s_red[];  // [kWarps][kTileB][32][VEC + 1]; the pad keeps the stores conflict-free

  const int width = 3 * hidden;
  const int nx = gridDim.x;
  const int ksplit = gridDim.y;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n0 = (blockIdx.x * 32 + lane) * VEC;
  const bool live = n0 < width;  // on the vector path width % VEC == 0: a vector is all in or all out
  const int b0 = blockIdx.z * kTileB;
  const int rows = min(kTileB, batch - b0);
  const int d_begin = blockIdx.y * depth_per_split;
  const int d_end = min(d_begin + depth_per_split, depth);

  // This thread's column in the cluster's sum (kTileN divides kThreads), and
  // what the rows' last blocks read after the product: loaded or asked of L2 now.
  pdl_begin();
  const float bias_own =
      blockIdx.x * kTileN + threadIdx.x % kTileN < width ? bias[blockIdx.x * kTileN + threadIdx.x % kTileN] : 0.f;
  if (blockIdx.y == 0) {
    prefetch_l2(h + static_cast<size_t>(b0) * hidden, static_cast<size_t>(rows) * hidden * sizeof(T), blockIdx.x, nx);
    if (blockIdx.z == 0) {
      prefetch_l2(scale, width * sizeof(float), blockIdx.x, nx);
      prefetch_l2(ln_bias, width * sizeof(float), blockIdx.x, nx);
    }
  }

  // ---- 1. This block's partial sum over its D range. ----
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
    // The group's rows of inp: every load issued before any is stored.
    constexpr int kInpPerThread = kGroupD * kTileB / kThreads;
    float xin[kInpPerThread];
#pragma unroll
    for (int k = 0; k < kInpPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int d = g0 + i % kGroupD;
      const int b = b0 + i / kGroupD;
      xin[k] = (d < d_end && b < batch) ? to_float(inp[static_cast<size_t>(b) * depth + d]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kInpPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      s_inp[i % kGroupD][i / kGroupD] = xin[k];
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
  const int col0 = blockIdx.x * kTileN;
  const int ncol = min(kTileN, width - col0);
  for (int i = threadIdx.x; i < rows * kTileN; i += kThreads) {
    const int bb = i / kTileN;
    const int c = i % kTileN;
    if (c < ncol) {
      const int slot = (c / VEC) * (VEC + 1) + c % VEC;
      float sum = 0.f;
#pragma unroll
      for (int y = 0; y < kWarps; ++y) sum += s_red[(y * kTileB + bb) * 32 * (VEC + 1) + slot];
      s_part[bb * kTileN + c] = sum;
    }
  }

  // ---- 2. Over the cluster (every split of this column block and tile): z and its statistics. ----
  // Split s adds rows s, s + ksplit, ... of the splits' partials, read over
  // distributed shared memory in split order.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is in its shared memory
  const int split = static_cast<int>(blockIdx.y);
  const int my_rows = split < rows ? (rows - split + ksplit - 1) / ksplit : 0;
  float* s_z = s_red;  // [my_rows][kTileN], free now
  for (int i = threadIdx.x; i < my_rows * kTileN; i += kThreads) {
    const int j = i / kTileN;
    const int c = i % kTileN;
    if (c < ncol) {
      const int at = (split + j * ksplit) * kTileN + c;
      float v[kMaxSplit];
#pragma unroll
      for (int k = 0; k < kMaxSplit; ++k) v[k] = k < ksplit ? cluster.map_shared_rank(s_part, k)[at] : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxSplit; ++k) sum += v[k];
      sum += bias_own;
      z[static_cast<size_t>(b0 + split + j * ksplit) * width + col0 + c] = sum;
      s_z[j * kTileN + c] = sum;
    }
  }
  // Done reading the other splits' shared memory; none may exit before all
  // are (the matching wait precedes every exit below).
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  if (warp < my_rows) {  // warp j: row b0 + split + j * ksplit over this block's columns
    const float* v = s_z + warp * kTileN;
    float sum = 0.f;
    for (int c = lane; c < ncol; c += 32) sum += v[c];
    sum = warp_sum(sum);
    const float mean = sum / ncol;
    float m2 = 0.f;
    for (int c = lane; c < ncol; c += 32) m2 += (v[c] - mean) * (v[c] - mean);
    m2 = warp_sum(m2);
    if (lane == 0) stats[static_cast<size_t>(b0 + split + warp * ksplit) * nx + blockIdx.x] = make_float2(sum, m2);
  }
  if (my_rows == 0) {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    return;
  }

  // ---- 3. Per row: the last column block to write its statistics applies its gates. ----
  __syncthreads();  // the block's z and statistics are written before lane j releases row j
  if (warp == 0) {
    bool last = false;
    if (lane < my_rows) {
      int* ticket = tickets + b0 + split + lane * ksplit;
      last = ticket_add(ticket) == nx - 1;
      if (last) *ticket = 0;  // reset for the next call
    }
    const unsigned mine = __ballot_sync(0xffffffffu, last);
    if (lane == 0) s_flag = static_cast<int>(mine);
  }
  __syncthreads();
  const int mine = s_flag;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (mine == 0) return;
  // Thread: gate indices i = t + k * kThreads in every row this block
  // finishes, two at a time; the first two's loads are in flight together
  // with the row statistics'.
  constexpr int kPerPass = 2;
  float sc[kPerPass][3], lb[kPerPass][3], v[kPerPass][kTileB][3], hv[kPerPass][kTileB];
  auto load_pass = [&](int i0) {
#pragma unroll
    for (int p = 0; p < kPerPass; ++p) {
      const int i = i0 + p * kThreads;
      if (i < hidden) {
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          sc[p][g] = scale[g * hidden + i];
          lb[p][g] = ln_bias[g * hidden + i];
        }
#pragma unroll
        for (int j = 0; j < kTileB; ++j) {
          if (j < my_rows && (mine >> j & 1)) {
            const size_t b = static_cast<size_t>(b0 + split + j * ksplit);
            const float* zrow = z + b * width;
#pragma unroll
            for (int g = 0; g < 3; ++g) v[p][j][g] = __ldcg(zrow + g * hidden + i);
            hv[p][j] = to_float(h[b * hidden + i]);
          }
        }
      }
    }
  };
  load_pass(threadIdx.x);
  if (warp < my_rows && (mine >> warp & 1)) {
    // Lane l holds the statistics of column blocks l and l + 32 (the rest are re-read).
    const float2* st = stats + static_cast<size_t>(b0 + split + warp * ksplit) * nx;
    const float2 p0 = lane < nx ? __ldcg(st + lane) : make_float2(0.f, 0.f);
    const float2 p1 = lane + 32 < nx ? __ldcg(st + lane + 32) : make_float2(0.f, 0.f);
    float sum = p0.x + p1.x;
    for (int c = lane + 64; c < nx; c += 32) sum += __ldcg(st + c).x;
    const float mean = warp_sum(sum) / width;
    float m2 = 0.f;
    for (int c = lane; c < nx; c += 32) {
      const float2 p = c == lane ? p0 : c == lane + 32 ? p1 : __ldcg(st + c);
      const float n_c = static_cast<float>(min(kTileN, width - c * kTileN));
      const float d = p.x / n_c - mean;
      m2 += p.y + n_c * d * d;
    }
    m2 = warp_sum(m2);
    if (lane == 0) {
      s_mean[warp] = mean;
      s_rstd[warp] = rsqrtf(m2 / width + kLnEps);
    }
  }
  __syncthreads();
  for (int i0 = threadIdx.x; i0 < hidden; i0 += kPerPass * kThreads) {
    if (i0 != static_cast<int>(threadIdx.x)) load_pass(i0);
#pragma unroll
    for (int p = 0; p < kPerPass; ++p) {
      const int i = i0 + p * kThreads;
      if (i < hidden)
#pragma unroll
        for (int j = 0; j < kTileB; ++j)
          if (j < my_rows && (mine >> j & 1))
            h_out[static_cast<size_t>(b0 + split + j * ksplit) * hidden + i] =
                from_float<T>(gate_update(v[p][j], s_mean[j], s_rstd[j], sc[p], lb[p], hv[p][j]));
    }
  }
}

template <int VEC>
constexpr int stream_smem_bytes() {
  return kWarps * kTileB * 32 * (VEC + 1) * static_cast<int>(sizeof(float));
}

template <typename T, int VEC>
cudaError_t launch_stream(const void* inp, const void* w, const void* bias, const void* scale, const void* ln_bias,
                          const void* h, void* h_out, void* z, void* scratch, void* tickets, int batch, int depth,
                          int hidden, int depth_per_split, int ksplit, int device, cudaStream_t s) {
  constexpr int smem = stream_smem_bytes<VEC>();
  static bool opted_in[kMaxDevices] = {};  // above 48 KB of shared memory and 8 CTAs a cluster need an opt-in
  if (!opted_in[device]) {
    cudaError_t err =
        cudaFuncSetAttribute(ln_gru_stream_forward<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ln_gru_stream_forward<T, VEC>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  const int width = 3 * hidden;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((width + 32 * VEC - 1) / (32 * VEC), ksplit, (batch + kTileB - 1) / kTileB);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ksplit;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, ln_gru_stream_forward<T, VEC>, static_cast<const T*>(inp),
                            static_cast<const T*>(w), static_cast<const float*>(bias),
                            static_cast<const float*>(scale), static_cast<const float*>(ln_bias),
                            static_cast<const T*>(h), static_cast<T*>(h_out), static_cast<float*>(z),
                            static_cast<float2*>(scratch), static_cast<int*>(tickets), batch, depth, hidden,
                            depth_per_split);
}

template <typename T>
int launch(const void* inp, const void* w, const void* bias, const void* scale, const void* ln_bias, const void* h,
           void* h_out, void* z, void* scratch, void* tickets, int batch, int depth, int hidden, int vec,
           int depth_per_split, int ksplit, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || depth < 1 || hidden < 1 || ksplit < 1 || ksplit > kMaxSplit || depth_per_split < 1 ||
      device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) {  // 16-byte loads of W: every row must start 16-byte aligned
    if ((3 * hidden) % kVec != 0 || reinterpret_cast<std::uintptr_t>(w) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    err = launch_stream<T, kVec>(inp, w, bias, scale, ln_bias, h, h_out, z, scratch, tickets, batch, depth, hidden,
                                 depth_per_split, ksplit, device, s);
  } else if (vec == 1) {
    err = launch_stream<T, 1>(inp, w, bias, scale, ln_bias, h, h_out, z, scratch, tickets, batch, depth, hidden,
                              depth_per_split, ksplit, device, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" int ln_gru_forward_f32(const void* inp, const void* w, const void* bias, const void* scale,
                                  const void* ln_bias, const void* h, void* h_out, void* z, void* scratch,
                                  void* tickets, int batch, int depth, int hidden, int vec, int depth_per_split,
                                  int ksplit, int device, void* stream) {
  return launch<float>(inp, w, bias, scale, ln_bias, h, h_out, z, scratch, tickets, batch, depth, hidden, vec,
                       depth_per_split, ksplit, device, stream);
}

extern "C" int ln_gru_forward_bf16(const void* inp, const void* w, const void* bias, const void* scale,
                                   const void* ln_bias, const void* h, void* h_out, void* z, void* scratch,
                                   void* tickets, int batch, int depth, int hidden, int vec, int depth_per_split,
                                   int ksplit, int device, void* stream) {
  return launch<__nv_bfloat16>(inp, w, bias, scale, ln_bias, h, h_out, z, scratch, tickets, batch, depth, hidden,
                               vec, depth_per_split, ksplit, device, stream);
}
