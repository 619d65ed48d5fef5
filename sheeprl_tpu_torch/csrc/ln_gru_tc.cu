// Fused LayerNorm-GRU cell step, forward, on the tensor cores of Hopper (sm_90a),
// for bf16 inputs at large batch (the DreamerV3 imagination's B = 1024).
//
// Replaces the TPU kernel `_pallas_ln_gru` / `_kernel` in
// sheeprl_tpu/models/pallas_gru.py (pl.pallas_call at :118) on the shapes the
// wrapper's plan gives it (sheeprl_tpu_torch/models/ln_gru.py:forward_plan);
// csrc/ln_gru.cu takes every other shape. Same function:
//
//   z  = inp @ W + b                      f32 sum of bf16 products
//   zn = LayerNorm(z) * scale + ln_bias   statistics over the whole 3H row, eps 1e-5
//   h' = u * tanh(r * zn[H:2H]) + (1 - u) * h,  r = sigmoid(zn[:H]), u = sigmoid(zn[2H:] - 1)
//
// Bound on an H100 SXM at DreamerV3-S (D = 1024, H = 512) and B = 1024:
// 2 B D 3H = 3.2 GFLOP, 3.26 us at 989 TFLOP/s bf16; inp 2 MB + W 3.1 MB +
// z 6.3 MB (f32) + h and h' 2 MB = 13.6 MB, 4.07 us at 3.35 TB/s. Bound by
// bytes, and z's f32 write is half of them.
//
// Design.
//
// 1. Gate-owning tiles. A CTA owns 64 batch rows and G = 64 gate indices
//    j..j+G and multiplies against W's three column strips [j, j+G),
//    [H+j, H+j+G) and [2H+j, 2H+j+G): N = 3G = 192 columns, so each thread
//    ends up holding the reset, candidate and update columns of the same gate
//    indices and applies the gates from registers. W keeps its [D, 3H]
//    layout; the kernel addresses the strips itself. A cluster of H / G CTAs
//    (8 at DV3-S) covers one row tile's 3H columns; 16 row tiles x 8 = 128
//    CTAs, one wave on 132 SMs. W is read from L2 once per row tile (16 times
//    in all), not once per 8 batch rows as in the streaming kernel.
// 2. Tensor cores from a shared-memory ring. Tiles of inp (64 x 64) and of
//    the three W strips (3 x 64 x 64) come by cp.async (16 bytes a thread,
//    zero-filled past the last batch row and past D) into a 3-stage ring of
//    32 KB stages (two CTAs fit on an SM, so a cluster of 8 never waits for
//    8 free SMs of one GPC). Each tile is 1024-byte aligned with 128-byte
//    rows whose 16-byte chunks are XOR-swizzled by the row: the layout TMA's
//    128-byte swizzle writes, which wgmma reads by descriptor. One warpgroup
//    issues wgmma.m64n192k16 (bf16 in, f32 accumulators in registers) on
//    each stage: inp K-major, W MN-major (the strips are its three 64-wide N
//    blocks, 8 KB apart). cp.async.wait_group, a proxy fence and one barrier
//    per K step order the ring; wgmma.wait_group 1 keeps one stage's product
//    in flight while the next stage is loaded. (The first version issued
//    mma.sync.m16n8k16 from ldmatrix: 31.2 us at B = 1024, PERF.md.)
// 3. The LayerNorm across the cluster. Each CTA sums its 192 columns per row
//    (lanes, then its four gate warps in order), puts the 64 row partials in
//    its shared memory, and after a cluster barrier every CTA reads the H / G
//    partials over distributed shared memory in rank order: the mean. The same
//    again for sum (z - mean)^2: the variance, two passes as in the reference
//    (pallas_gru.py:81-83). Every CTA adds the same numbers in the same order,
//    so all agree, and the result does not depend on scheduling. Then the
//    gates run from registers; z (f32) and h' (bf16) are written once. One
//    launch, no partial sums in global memory, no atomics.
//
// Plan (the wrapper checks it): bf16, H % 64 == 0 and H / 64 <= 8 (portable
// cluster), D % 8 == 0 (16-byte rows; the last K tile is zero-filled), any
// B >= 1 (rows past B are zero-filled and not written). Resources
// (`-Xptxas=-v`, printed by chip_smoke.py): 168 registers a thread, no
// spills, 1 KB of static shared memory beside the 97 KB dynamic ring (3 x
// 32 KB + 1 KB to align it), so two CTAs fit on an SM and the card holds
// all 16 clusters of 8 of B = 1024 at once (chip_smoke.py prints how many
// fit; a deeper ring leaves room for one CTA an SM, too few clusters for one
// wave). A CTA's time is set by latency, not by the tensor cores: the K
// loop's per-stage waits and the gate math (32 gate updates a thread on 4
// warps).
//
// Plain C interface: device pointers, sizes, the cluster size from the plan,
// the device index and the CUDA stream; the wrapper allocates every output.
// Returns cudaGetLastError() after the launch, 0 on success.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;        // batch rows per CTA
constexpr int kGates = 64;       // gate indices per CTA
constexpr int kTileK = 64;       // K per ring stage
constexpr int kStages = 3;     // 96 KB: two CTAs fit on an SM
constexpr int kThreads = 128;  // one warpgroup
constexpr int kTileBytes = kRows * kTileK * 2;   // one 64 x 64 bf16 tile, 8 KB
constexpr int kStageBytes = 4 * kTileBytes;      // inp + three W strips
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + room to align the ring to 1024 bytes
constexpr int kMaxCluster = 8;
constexpr float kLnEps = 1e-5f;
constexpr int kMaxDevices = 64;

// Byte offset of 16-byte chunk `chunk` of row `row` in a [64][64] bf16 tile.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  const int bytes = live ? 16 : 0;  // 0: zero-fill the chunk
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled tile at shared address
// `addr` (1024-byte aligned atoms): leading and stride byte offsets.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d[64 x 192] (+)= A[64 x 16] B[16 x 192]: A K-major, B MN-major (trans-b).
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Keep the compiler from moving the accumulators across the asynchronous
// wgmma (each stays in its register while a product is in flight).
__device__ __forceinline__ void fence_operands(float (&d)[96]) {
#pragma unroll
  for (int i = 0; i < 96; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Programmatic dependent launch: the block may start while the previous
// kernel on the stream finishes; wait for it before touching global memory,
// then let the next kernel start launching (it waits the same way).
__device__ __forceinline__ void pdl_begin() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Sum over the cluster's CTAs, in rank order, of `local[row]` in each CTA.
__device__ __forceinline__ float cluster_row_sum(cg::cluster_group& cluster, float* local, int row, int ranks) {
  float total = 0.f;
  for (int r = 0; r < ranks; ++r) total += cluster.map_shared_rank(local, r)[row];
  return total;
}

// grid: (H / kGates, ceil(B / kRows)), cluster (H / kGates, 1, 1); block: kThreads.
__global__ void __launch_bounds__(kThreads)
ln_gru_tc_forward(const __nv_bfloat16* __restrict__ inp, const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ bias, const float* __restrict__ scale,
                  const float* __restrict__ ln_bias, const __nv_bfloat16* __restrict__ h,
                  __nv_bfloat16* __restrict__ h_out, float* __restrict__ z, int batch, int depth, int hidden) {
  extern __shared__ __align__(1024) unsigned char ring_raw[];
  __shared__ float s_cta[2][kRows];    // this CTA's row partials: sums, then squared deviations
  __shared__ float s_mean[kRows];
  __shared__ float s_rstd[kRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(gridDim.x);  // the cluster spans grid x
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = static_cast<int>(blockIdx.x) * kGates;
  const int b0 = static_cast<int>(blockIdx.y) * kRows;
  const int width = 3 * hidden;
  const int ktiles = (depth + kTileK - 1) / kTileK;  // the last tile is zero-filled past D
  const uint32_t ring_base = (static_cast<uint32_t>(__cvta_generic_to_shared(ring_raw)) + 1023u) & ~1023u;
  pdl_begin();

  // Stage loader: 2048 chunks of 16 bytes (inp 512, each W strip 512), 16 a thread.
  auto load_stage = [&](int kt, int slot) {
    const uint32_t stage = ring_base + slot * kStageBytes;
    const int k0 = kt * kTileK;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int idx = tid + it * kThreads;
      const int row = idx >> 3;
      const int chunk = idx & 7;
      const int b = b0 + row;
      const bool live = b < batch && k0 + chunk * 8 < depth;
      const __nv_bfloat16* src = live ? inp + (static_cast<size_t>(b) * depth + k0 + chunk * 8) : inp;
      cp_async16(stage + swz(row, chunk), src, live);
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int idx = tid + it * kThreads;
        const int row = idx >> 3;  // k within the stage
        const int chunk = idx & 7;
        const bool live = k0 + row < depth;
        const __nv_bfloat16* src = live ? w + (static_cast<size_t>(k0 + row) * width + s * hidden + j0 + chunk * 8) : w;
        cp_async16(stage + (s + 1) * kTileBytes + swz(row, chunk), src, live);
      }
    }
  };

  float acc[96];  // [strip * 32 + q * 4 + e]: the wgmma fragment of n8 block j = strip * 8 + q
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.f;

  fence_operands(acc);  // no instruction touches acc again until the last product is done

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ktiles) load_stage(st, st);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // cp.async's writes, seen by wgmma
    __syncthreads();  // stage kt has landed for every thread
    const uint32_t stage = ring_base + (kt % kStages) * kStageBytes;
    // inp: K-major, 8-row atoms 1024 bytes apart. W: MN-major, the three
    // strips are 64-wide N blocks 8 KB apart, 8-row (k) atoms 1024 bytes apart.
    const uint64_t desc_a = smem_desc(stage, 16, 1024);
    const uint64_t desc_b = smem_desc(stage + kTileBytes, kTileBytes, 1024);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)  // k16 steps: 32 bytes along A's rows, 16 rows of B
      wgmma_m64n192k16(acc, desc_a + 2 * kk, desc_b + 128 * kk, kt > 0 || kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // stage kt - 1's product is done
    const int next = kt + kStages - 1;  // into the slot of stage kt - 1
    if (next < ktiles) load_stage(next, next % kStages);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(acc);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // Fragment (s, q, e) is row r0 = 16 * warp + lane / 4 (e < 2) or r0 + 8,
  // gate j0 + q * 8 + 2 * (lane % 4) + e % 2, column s * H + gate.
  const int gbase = j0 + 2 * (lane & 3);
  const int r0 = 16 * warp + (lane >> 2);
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float2 bv = *reinterpret_cast<const float2*>(bias + s * hidden + gbase + q * 8);
      acc[s * 32 + q * 4 + 0] += bv.x;
      acc[s * 32 + q * 4 + 1] += bv.y;
      acc[s * 32 + q * 4 + 2] += bv.x;
      acc[s * 32 + q * 4 + 3] += bv.y;
    }

  // Row partial of this CTA into s_cta[pass]: a row's 192 columns are in the
  // four lanes of one quad.
  auto cta_row_partials = [&](float (&v)[2], int pass) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x = v[hf];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if ((lane & 3) == 0) s_cta[pass][r0 + 8 * hf] = x;
    }
  };

  // Pass 1: the mean.
  float part[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float x = 0.f;
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int q = 0; q < 8; ++q) x += acc[s * 32 + q * 4 + 2 * hf] + acc[s * 32 + q * 4 + 2 * hf + 1];
    part[hf] = x;
  }
  cta_row_partials(part, 0);
  cluster.sync();  // every CTA's sums are in its shared memory
  if (tid < kRows) s_mean[tid] = cluster_row_sum(cluster, s_cta[0], tid, ranks) / width;
  __syncthreads();

  // Pass 2: the variance, from deviations about the mean.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float mean = s_mean[r0 + 8 * hf];
    float x = 0.f;
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float d0 = acc[s * 32 + q * 4 + 2 * hf] - mean;
        const float d1 = acc[s * 32 + q * 4 + 2 * hf + 1] - mean;
        x += d0 * d0 + d1 * d1;
      }
    part[hf] = x;
  }
  cta_row_partials(part, 1);
  cluster.sync();
  if (tid < kRows) s_rstd[tid] = rsqrtf(cluster_row_sum(cluster, s_cta[1], tid, ranks) / width + kLnEps);
  // Done reading the other CTAs' shared memory: no CTA may exit before all are.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  // Gates from registers; z and h' written once.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + 8 * hf;
    const int b = b0 + row;
    if (b >= batch) continue;
    const float mean = s_mean[row];
    const float rstd = s_rstd[row];
    float* zrow = z + static_cast<size_t>(b) * width;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int gate = gbase + q * 8;
      float y[3][2];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const float v0 = acc[s * 32 + q * 4 + 2 * hf];
        const float v1 = acc[s * 32 + q * 4 + 2 * hf + 1];
        *reinterpret_cast<float2*>(zrow + s * hidden + gate) = make_float2(v0, v1);
        const float2 sc = *reinterpret_cast<const float2*>(scale + s * hidden + gate);
        const float2 lb = *reinterpret_cast<const float2*>(ln_bias + s * hidden + gate);
        y[s][0] = (v0 - mean) * rstd * sc.x + lb.x;
        y[s][1] = (v1 - mean) * rstd * sc.y + lb.y;
      }
      const size_t hidx = static_cast<size_t>(b) * hidden + gate;
      const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(h + hidx);
      const float hf2[2] = {__low2float(hv), __high2float(hv)};
      float out[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float r = sigmoid(y[0][e]);
        const float c = tanhf(r * y[1][e]);
        const float u = sigmoid(y[2][e] - 1.f);
        out[e] = u * c + (1.f - u) * hf2[e];
      }
      *reinterpret_cast<__nv_bfloat162*>(h_out + hidx) = __floats2bfloat162_rn(out[0], out[1]);
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace

// How many clusters of `cluster` CTAs the device can hold at once (0 on error).
extern "C" int ln_gru_tc_max_active_clusters(int cluster, int device) {
  if (cudaSetDevice(device) != cudaSuccess ||
      cudaFuncSetAttribute(ln_gru_tc_forward, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, ln_gru_tc_forward, &cfg) == cudaSuccess ? n : 0;
}

extern "C" int ln_gru_forward_tc_bf16(const void* inp, const void* w, const void* bias, const void* scale,
                                      const void* ln_bias, const void* h, void* h_out, void* z, int batch,
                                      int depth, int hidden, int cluster, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || depth < 1 || depth % 8 != 0 || hidden % kGates != 0 || cluster != hidden / kGates ||
      cluster < 1 || cluster > kMaxCluster || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in[kMaxDevices] = {};
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(ln_gru_tc_forward, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (batch + kRows - 1) / kRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
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
  err = cudaLaunchKernelEx(&cfg, ln_gru_tc_forward, static_cast<const __nv_bfloat16*>(inp),
                           static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
                           static_cast<const float*>(scale), static_cast<const float*>(ln_bias),
                           static_cast<const __nv_bfloat16*>(h), static_cast<__nv_bfloat16*>(h_out),
                           static_cast<float*>(z), batch, depth, hidden);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
