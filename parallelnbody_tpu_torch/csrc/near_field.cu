// K1: the exact softened Barnes-Hut near field, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_near_table_kernel` in
// parallelnbody_tpu/ops/pallas_bh.py (called through `near_field_pallas`).
// Wrapper, work-item builder and plain PyTorch version:
// parallelnbody_tpu_torch/ops/bh_kernels.py (`near_field`, `near_items`,
// `near_field_plain`).
//
// What it computes. Target leaf t holds G particles (rows t*G .. t*G+G-1 of
// the curve-sorted arrays). Its near list idx[t, 0:cnt[t]] names source
// leaves (front-packed, so cnt[t] is the live length). For every target i
// and every particle j of every listed source leaf:
//     u = rsqrt(|x_j - x_i|^2 + eps^2),  w = m_j u^3
//     acc_i += g * w (x_j - x_i),  pot_i -= g * m_j u   (terms.cuh)
// With softening 0 (GUARD_ZERO) u is zeroed where r^2 = 0, which skips
// exact overlaps and the self pair; with softening > 0 the self pair adds
// m_i / eps to the potential, as the JAX package does.
//
// What bounds it. A pair is 18 FP32 operations (FMA as two) and one rsqrt on
// the MUFU, while a staged source leaf (4 KB at G = 256) serves G^2 pairs and the
// whole packed source table (16 MB at N = 1M) sits in the 50 MB L2: the
// kernel is bound by FP32 issue, not by memory.
//
// Design.
//   * Balance. The near lists are uneven (at N = 1M, t = 0: 96.5 entries a
//     row on average, 1164 on the longest), and one block per row left the
//     longest rows as the kernel's tail. The wrapper cuts every row into
//     work items of at most C (bh_kernels.NEAR_CHUNK) entries, heaviest
//     first, one block per item. An item of a row that has one item writes
//     the row's output; the items of a longer row write raw partial sums to
//     `partial`, and near_combine_kernel adds them in chunk order. No float
//     atomics: the output is bit-equal from run to run.
//   * Staging. The wrapper packs [x, y, z, m] into one (n_pad, 4) table, so
//     a source leaf is one contiguous G-float4 block; terms.cuh sweep_tiles
//     streams a row's entries through a ring of pnb::kStages shared buffers
//     with cp.async, one __syncthreads per entry.
//   * Register blocking. A thread holds R targets (i, i + T, ...) of the
//     leaf, T = ceil(G / R) threads a block, so one broadcast LDS.128 serves
//     R pairs. By default R is the largest of 8, 4, 2 that still gives a
//     block a full warp (G >= 32 R), else 1: one warp at leaf 256 (N = 1M)
//     and leaf 128, so no lane idles. The caller may name R (8, 4, 2, 1);
//     a target's terms add up in source order whatever R, so R never
//     changes the bits.
//   * Windowed forms. `leaf_off` is subtracted from every source id the
//     kernel reads: the wrapper's window form passes a shard of the sorted
//     particles whose leaves start at global id leaf_off (the ring near field
//     of parallel/distributed.py), and builds the items from each row's
//     [lo, hi) run of list positions inside the window; the table form
//     passes a prebuilt source table with leaf_off 0 and items that stop at
//     its last row. The unwindowed form passes 0 and [0, count).
//   * The ring's windows. A rank's own window holds most of its near
//     entries, the others a few rows' worth: launched like the own window,
//     a light window lasted as long as one warp's serial sweep of its
//     longest item, and each launch wrote every row (zeros mostly) for
//     torch to add up. So each window's items and R are sized by its work
//     (bh_kernels.window_shape: one-warp blocks of 8 targets a thread for
//     the own window, 1 target a thread over 8 warps and short items for
//     the others), and with `accumulate` the kernel and the combining pass
//     add a row's sums into the output (rounded as written-then-added, no
//     FMA contraction, no atomics), so the first pass writes, the later
//     ones add in pass order, and rows with no entry in a window get no
//     item and are not touched.
//   * C and R were chosen on the card at N = 1M (PERF.md §6): one-warp
//     blocks (R = 8 at G = 256) ran a few per cent faster than two-warp
//     ones (R = 4), and every C from 8 to 64 lost the tail and ran within
//     the spread between runs; C = 32 keeps the items few (3.5 a row at
//     N = 1M) and the partial buffer at 60 MB there.

#include <cuda_runtime.h>

#include <type_traits>

#include "terms.cuh"

namespace {

// Stores a row's sums scaled as the callers expect: acc = g s.xyz, pot =
// -g s.w (0 without the potential). ACCUM adds them to what the row holds
// instead (pot untouched without the potential), each as one rounded
// multiply and one rounded add, never contracted into an FMA: the same bits
// as the sums written and then added by torch.
template <bool COMPUTE_POT, bool ACCUM>
__device__ __forceinline__ void store_row(float* acc, float* pot,
                                          long long row, float g, float4 s) {
  if (ACCUM) {
    acc[row * 3 + 0] = __fadd_rn(acc[row * 3 + 0], __fmul_rn(g, s.x));
    acc[row * 3 + 1] = __fadd_rn(acc[row * 3 + 1], __fmul_rn(g, s.y));
    acc[row * 3 + 2] = __fadd_rn(acc[row * 3 + 2], __fmul_rn(g, s.z));
    if (COMPUTE_POT) pot[row] = __fadd_rn(pot[row], __fmul_rn(-g, s.w));
  } else {
    acc[row * 3 + 0] = g * s.x;
    acc[row * 3 + 1] = g * s.y;
    acc[row * 3 + 2] = g * s.z;
    pot[row] = COMPUTE_POT ? -g * s.w : 0.f;
  }
}

// One block per work item (row, begin, end, dst) of `items`; R targets a
// thread.
template <int R, bool GUARD_ZERO, bool COMPUTE_POT, bool ACCUM>
__global__ void __launch_bounds__(1024 / R)
    near_field_kernel(const float4* __restrict__ table,
                      const float* __restrict__ tgt,
                      const int* __restrict__ idx,
                      const int4* __restrict__ items,
                      float* __restrict__ acc, float* __restrict__ pot,
                      float4* __restrict__ partial, int leaf_size,
                      int budget, int leaf_off, float g, float eps2) {
  extern __shared__ float4 ring[];
  const int4 item = items[blockIdx.x];
  const int G = leaf_size;
  pnb::Targets<R> t;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    const long long row = (long long)item.x * G + (i < G ? i : 0);
    t.x[r] = tgt[row * 3 + 0];
    t.y[r] = tgt[row * 3 + 1];
    t.z[r] = tgt[row * 3 + 2];
    t.s[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int* list = idx + (long long)item.x * budget + item.y;
  pnb::sweep_tiles<R, GUARD_ZERO, COMPUTE_POT>(
      ring, G, item.z - item.y,
      [&](int k) { return table + (long long)(list[k] - leaf_off) * G; },
      [&](int) { return G; }, eps2, t);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    if (i >= G) continue;
    const long long row = (long long)item.x * G + i;
    if (item.w < 0)
      store_row<COMPUTE_POT, ACCUM>(acc, pot, row, g, t.s[r]);
    else
      partial[(long long)item.w * G + i] = t.s[r];
  }
}

// Rows cut into several items: splits[k] = (row, first partial, count);
// one thread per (split row, target) adds the partials in chunk order.
template <bool COMPUTE_POT, bool ACCUM>
__global__ void near_combine_kernel(const float4* __restrict__ partial,
                                    const int* __restrict__ splits,
                                    float* __restrict__ acc,
                                    float* __restrict__ pot, int n_split,
                                    int leaf_size, float g) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)n_split * leaf_size) return;
  const int sr = (int)(k / leaf_size);
  const int i = (int)(k % leaf_size);
  const int* sp = splits + 3 * sr;
  const float4* p = partial + (long long)sp[1] * leaf_size + i;
  float4 s = p[0];
  for (int c = 1; c < sp[2]; ++c) {
    const float4 q = p[(long long)c * leaf_size];
    s.x += q.x;
    s.y += q.y;
    s.z += q.z;
    s.w += q.w;
  }
  store_row<COMPUTE_POT, ACCUM>(acc, pot, (long long)sp[0] * leaf_size + i,
                                g, s);
}

template <int R, bool GUARD_ZERO, bool COMPUTE_POT, bool ACCUM>
cudaError_t launch(const float4* table, const float* tgt, const int* idx,
                   const int4* items, const int* splits, float* acc,
                   float* pot, float4* partial, int n_items, int n_split,
                   int leaf_size, int budget, int leaf_off, float g,
                   float eps2, cudaStream_t stream) {
  const int threads = (leaf_size + R - 1) / R;
  const size_t smem = (size_t)pnb::kStages * leaf_size * sizeof(float4);
  auto kernel = near_field_kernel<R, GUARD_ZERO, COMPUTE_POT, ACCUM>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_items, threads, smem, stream>>>(table, tgt, idx, items, acc, pot,
                                             partial, leaf_size, budget,
                                             leaf_off, g, eps2);
  if (n_split > 0) {
    const long long n = (long long)n_split * leaf_size;
    near_combine_kernel<COMPUTE_POT, ACCUM><<<(int)((n + 255) / 256), 256,
                                              0, stream>>>(
        partial, splits, acc, pot, n_split, leaf_size, g);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int pnb_near_field(const void* table, const void* tgt,
                              const void* idx, const void* items,
                              const void* splits, void* acc, void* pot,
                              void* partial, int n_items, int n_split,
                              int leaf_size, int budget, int leaf_off,
                              float g, float eps2, int guard_zero,
                              int compute_pot, int accumulate,
                              int targets_per_thread, void* stream) {
  if (n_items <= 0) return (int)cudaSuccess;
  auto tb = static_cast<const float4*>(table);
  auto t = static_cast<const float*>(tgt);
  auto ix = static_cast<const int*>(idx);
  auto it = static_cast<const int4*>(items);
  auto sp = static_cast<const int*>(splits);
  auto a = static_cast<float*>(acc);
  auto ph = static_cast<float*>(pot);
  auto pa = static_cast<float4*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto fn) {
    return (int)fn(tb, t, ix, it, sp, a, ph, pa, n_items, n_split, leaf_size,
                   budget, leaf_off, g, eps2, st);
  };
  auto with_acc = [&](auto r, auto a) {
    constexpr int R = decltype(r)::value;
    constexpr bool A = decltype(a)::value;
    if (guard_zero)
      return compute_pot ? go(launch<R, true, true, A>)
                         : go(launch<R, true, false, A>);
    return compute_pot ? go(launch<R, false, true, A>)
                       : go(launch<R, false, false, A>);
  };
  auto with_r = [&](auto r) {
    return accumulate ? with_acc(r, std::true_type())
                      : with_acc(r, std::false_type());
  };
  int R = targets_per_thread;
  // 0: the most targets a thread that still leave a block one full warp.
  if (R == 0) R = leaf_size >= 256 ? 8 : leaf_size >= 128 ? 4
                                   : leaf_size >= 64 ? 2 : 1;
  if ((leaf_size + R - 1) / R > 1024) return (int)cudaErrorInvalidValue;
  switch (R) {
    case 8: return with_r(std::integral_constant<int, 8>());
    case 4: return with_r(std::integral_constant<int, 4>());
    case 2: return with_r(std::integral_constant<int, 2>());
    case 1: return with_r(std::integral_constant<int, 1>());
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* pnb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
