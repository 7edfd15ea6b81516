// K8: the near-field probe kernel of a TPU experiment, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel built by `make_kernel(mode, unroll)` in
// scripts/near_kernel_probe.py (inner `kern`, called through its
// `pallas_call`). Wrapper, bounds, work items, table packing and plain
// PyTorch version: parallelnbody_tpu_torch/ops/near_probe.py
// (`near_probe`, `probe_bounds`, `probe_items`, `probe_table`,
// `near_probe_plain`). No path of the system runs it;
// tools/near_kernel_probe.py times it against K1 (near_field.cu) on the
// same lists.
//
// What it computes. K1's near field for the acceleration only, over one
// segment of the source-leaf table: target leaf t holds G targets; the
// entries [lo, hi) of its front-packed ascending list name the source
// leaves of this segment (bnd[t, seg], bnd[t, seg + 1]). For each entry k
// every target adds the tile's G sources
//     u = rsqrt(|x_j - x_i|^2 + eps^2),  w = m_j u^3,  e += w (x_j - x_i)
// to a sum e of its own, then e to its carry (the script's order: a tile's
// sum, then the entry into the carry). The output row of leaf t is
// [ax; ay; az; 0] (4, G); the first segment writes it, the later ones add
// theirs (rounded as written and then added: the script's out + segment).
// The mode names which table row an entry reads:
//   A  the list entry's leaf id less the segment's base (the shipped form;
//      the script read the id without the base, which is only right in
//      the first segment);
//   B  row k % rows (k the list position, rows the segment's row count):
//      the loop and the math of A without the indirect read;
//   C  row 0: without the read of a new row either;
//   E  as A, but a trip's `unroll` tiles are all staged before any of its
//      arithmetic.
// unroll (4 or 8) is the entries a trip: the entry loop is unrolled that
// many times (A, B, C) or stages that many tiles at once (E). The
// script's tail (a trip past hi adds zero-mass tiles) adds nothing, and
// entries past hi are neither staged nor swept. F is A on a table whose
// sources are 8 floats apart (STRIDE 8), the script's rows padded to 8
// components.
//
// What bounds it. A pair is K1's: 18 FP32 operations and one rsqrt. A tile
// of G float4 (4 KB at G = 256) serves G^2 pairs: bound by FP32 issue, as
// K1 is.
//
// What bounded the first design: one block per target leaf and one
// target a thread, so one broadcast LDS.128 served one pair (K1: eight);
// each entry's tile staged synchronously between two barriers, so nothing
// hid the L2 latency; and rows not split, so the longest rows (1164
// entries against a mean of 96.5 at N = 1M) were the launch's tail. Mode A
// ran 26.0-26.3 ms on K1's 1M lists, 0.26 of its bound, against K1's 12.4.
//
// Design: K1's loop (near_field.cu), so that the modes ablate K1.
//   * Balance. The wrapper cuts each (row, segment) range [lo, hi) into
//     work items of at most bh_kernels.NEAR_CHUNK entries, heaviest first,
//     one block per item (`bh_kernels.near_items` per segment, built once
//     per list set). An item of a row's only item writes (segment 0) or
//     adds (later segments) the row; the items of a split row write raw
//     partial sums, which probe_combine_kernel adds in chunk order and
//     writes or adds likewise. No float atomics: repeat launches give the
//     same bits.
//   * Register blocking. A thread holds R targets (i, i + T, ...), T =
//     ceil(G / R) threads a block, R chosen as K1 chooses it (8 at G =
//     256): one broadcast LDS.128 serves R pairs, through terms.cuh's own
//     `sweep`.
//   * Staging. A, B and C stream an item's tiles through a ring of
//     pnb::kStages buffers with cp.async, one barrier an entry, as K1's
//     sweep_tiles; E through two buffers of `unroll` tiles, one barrier a
//     trip. The per-tile sum is kept: a tile sums into the targets' sums,
//     which are then added into their carries and zeroed.
// What it reaches (tools/near_kernel_probe.py, NVIDIA H100 80GB HBM3 at
// 700 W, PERF.md §6): mode A in 4 segments 12.37-12.46 ms on K1's N = 1M
// lists, 0.559 of its bound, the time of K1 itself on them; one segment
// 11.99-12.00 (0.580). Its inner loop is K1's (13.3 SASS instructions a
// pair); 127 registers at R = 8 leave 16 one-warp blocks an SM.

#include <cuda_runtime.h>

#include <type_traits>

#include "terms.cuh"

namespace {

enum Mode { kA = 0, kB = 1, kC = 2, kE = 3 };

// Sweeps the n entries of an item in groups of T tiles through a ring of S
// buffers of T tiles each (ring: S * T * G float4 of shared memory). Entry
// k's tile is the G sources of table row row_of(k), STRIDE floats apart,
// each staged with a 16-byte cp.async. The copies of the next S - 1 groups
// are in flight while one is swept; one __syncthreads a group publishes
// the group that landed and frees the one swept last. Each tile sums into
// t.s, which is then added into carry and zeroed. The group loop is
// unrolled U times. Every thread of the block must call this.
template <int R, int S, int T, int U, int STRIDE, class RowOf>
__device__ __forceinline__ void sweep_entries(float4* ring, const float* table,
                                              int G, int n, RowOf row_of,
                                              float eps2, pnb::Targets<R>& t,
                                              float3 (&carry)[R]) {
  static_assert(S >= 2, "the ring needs two buffers or more");
  const int n_groups = (n + T - 1) / T;
  auto stage = [&](int grp) {
    float4* dst = ring + (grp % S) * T * G;
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const int k = grp * T + u;
      if (k >= n) break;
      const float* src = table + (long long)row_of(k) * G * STRIDE;
      for (int q = threadIdx.x; q < G; q += blockDim.x)
        pnb::cp_async16(dst + u * G + q,
                        reinterpret_cast<const float4*>(src + q * STRIDE));
    }
  };
#pragma unroll
  for (int grp = 0; grp < S - 1; ++grp) {
    if (grp < n_groups) stage(grp);
    pnb::cp_async_commit();
  }
#pragma unroll (U)
  for (int grp = 0; grp < n_groups; ++grp) {
    pnb::cp_async_wait<S - 2>();  // this thread's copies of grp have landed
    __syncthreads();              // everyone's have; grp - 1 is swept by all
    if (grp + S - 1 < n_groups) stage(grp + S - 1);
    pnb::cp_async_commit();
    const float4* tiles = ring + (grp % S) * T * G;
#pragma unroll
    for (int u = 0; u < T; ++u) {
      if (grp * T + u >= n) break;
      pnb::sweep<R, false, false>(tiles + u * G, G, eps2, t);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        carry[r].x += t.s[r].x;
        carry[r].y += t.s[r].y;
        carry[r].z += t.s[r].z;
        t.s[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

// The row's [ax; ay; az; 0] at target i of o (4, G): written, or with
// accum added as one rounded add per component (the 0 row kept).
__device__ __forceinline__ void store_target(float* o, int G, int i, float3 c,
                                             bool accum) {
  if (accum) {
    o[i] = __fadd_rn(o[i], c.x);
    o[G + i] = __fadd_rn(o[G + i], c.y);
    o[2 * G + i] = __fadd_rn(o[2 * G + i], c.z);
  } else {
    o[i] = c.x;
    o[G + i] = c.y;
    o[2 * G + i] = c.z;
    o[3 * G + i] = 0.f;
  }
}

// One block per work item (row, begin, end, dst) of `items`, begin and end
// list positions; R targets a thread. dst < 0: the row's only item, which
// stores the row (store_target); else partial slot dst.
template <int MODE, int U, int STRIDE, int R>
__global__ void __launch_bounds__(1024 / R)
    near_probe_kernel(const int4* __restrict__ items,
                      const int* __restrict__ idx, int budget, int base,
                      int rows, const float* __restrict__ tgt,
                      const float* __restrict__ table, float* __restrict__ out,
                      float4* __restrict__ partial, int G, float eps2,
                      bool accum) {
  extern __shared__ float4 ring[];
  const int4 item = items[blockIdx.x];
  const float* tt = tgt + (long long)item.x * 4 * G;
  pnb::Targets<R> t;
  float3 carry[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    const int j = i < G ? i : 0;
    t.x[r] = tt[j];
    t.y[r] = tt[G + j];
    t.z[r] = tt[2 * G + j];
    t.s[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    carry[r] = make_float3(0.f, 0.f, 0.f);
  }
  const int* list = idx + (long long)item.x * budget + item.y;
  const int k0 = item.y;
  auto row_of = [&](int k) {
    if (MODE == kA || MODE == kE) return list[k] - base;
    if (MODE == kB) return (k0 + k) % rows;
    return 0;
  };
  const float* seg_table = table + (long long)base * G * STRIDE;
  const int n = item.z - item.y;
  if (MODE == kE)
    sweep_entries<R, 2, U, 1, STRIDE>(ring, seg_table, G, n, row_of, eps2, t,
                                      carry);
  else
    sweep_entries<R, pnb::kStages, 1, U, STRIDE>(ring, seg_table, G, n,
                                                 row_of, eps2, t, carry);
  float* o = out + (long long)item.x * 4 * G;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    if (i >= G) continue;
    if (item.w < 0)
      store_target(o, G, i, carry[r], accum);
    else
      partial[(long long)item.w * G + i] =
          make_float4(carry[r].x, carry[r].y, carry[r].z, 0.f);
  }
}

// Rows cut into several items: splits[k] = (row, first partial, count);
// one thread per (split row, target) adds the partials in chunk order and
// stores the row (store_target).
__global__ void probe_combine_kernel(const float4* __restrict__ partial,
                                     const int* __restrict__ splits,
                                     float* __restrict__ out, int n_split,
                                     int G, bool accum) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)n_split * G) return;
  const int* sp = splits + 3 * (k / G);
  const int i = (int)(k % G);
  const float4* p = partial + (long long)sp[1] * G + i;
  float3 s = make_float3(p[0].x, p[0].y, p[0].z);
  for (int c = 1; c < sp[2]; ++c) {
    const float4 q = p[(long long)c * G];
    s.x += q.x;
    s.y += q.y;
    s.z += q.z;
  }
  store_target(out + (long long)sp[0] * 4 * G, G, i, s, accum);
}

template <int MODE, int U, int STRIDE, int R>
cudaError_t launch(const int4* items, const int* splits, const int* idx,
                   const float* tgt, const float* table, float* out,
                   float4* partial, int n_items, int n_split, int G,
                   int budget, int base, int rows, bool accum, float eps2,
                   cudaStream_t stream) {
  auto kernel = near_probe_kernel<MODE, U, STRIDE, R>;
  const int tiles = MODE == kE ? 2 * U : pnb::kStages;
  const size_t smem = (size_t)tiles * G * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_items, (G + R - 1) / R, smem, stream>>>(
      items, idx, budget, base, rows, tgt, table, out, partial, G, eps2,
      accum);
  if (n_split > 0) {
    const long long n = (long long)n_split * G;
    probe_combine_kernel<<<(int)((n + 255) / 256), 256, 0, stream>>>(
        partial, splits, out, n_split, G, accum);
  }
  return cudaGetLastError();
}

}  // namespace

// One segment of rows source leaves, whose first global leaf id is base,
// over its work items (items (n_items, 4) [row, begin, end, dst], splits
// (n_split, 3) [row, first, n], partial (n_partial * G) float4): out
// (L, 4, G) is written (accumulate 0: the items must cover every row) or
// added to (accumulate 1). mode 0-3 = A, B, C, E; unroll 4 or 8; n_comp 4
// or 8 floats a source in table (n_leaves_total, G, n_comp).
extern "C" int pnb_near_probe(const void* items, const void* splits,
                              const void* idx, const void* tgt,
                              const void* table, void* out, void* partial,
                              int n_items, int n_split, int leaf_size,
                              int budget, int base, int rows, int n_comp,
                              int mode, int unroll, int accumulate,
                              float eps2, void* stream) {
  if (n_items <= 0) return (int)cudaSuccess;
  const int G = leaf_size;
  if (G <= 0 || G > 1024 || rows <= 0) return (int)cudaErrorInvalidValue;
  auto go = [&](auto fn) {
    return (int)fn(static_cast<const int4*>(items),
                   static_cast<const int*>(splits),
                   static_cast<const int*>(idx),
                   static_cast<const float*>(tgt),
                   static_cast<const float*>(table), static_cast<float*>(out),
                   static_cast<float4*>(partial), n_items, n_split, G, budget,
                   base, rows, accumulate != 0, eps2,
                   static_cast<cudaStream_t>(stream));
  };
  // R: the most targets a thread that still leave a block one full warp
  // (K1's rule, near_field.cu).
  const int R = G >= 256 ? 8 : G >= 128 ? 4 : G >= 64 ? 2 : 1;
  auto with_r = [&](auto m, auto u, auto s) {
    constexpr int M = decltype(m)::value;
    constexpr int U = decltype(u)::value;
    constexpr int S = decltype(s)::value;
    switch (R) {
      case 8: return go(launch<M, U, S, 8>);
      case 4: return go(launch<M, U, S, 4>);
      case 2: return go(launch<M, U, S, 2>);
      default: return go(launch<M, U, S, 1>);
    }
  };
  auto with_stride = [&](auto m, auto u) {
    if (n_comp == 4) return with_r(m, u, std::integral_constant<int, 4>());
    if (n_comp == 8) return with_r(m, u, std::integral_constant<int, 8>());
    return (int)cudaErrorInvalidValue;
  };
  auto with_unroll = [&](auto m) {
    if (unroll == 4) return with_stride(m, std::integral_constant<int, 4>());
    if (unroll == 8) return with_stride(m, std::integral_constant<int, 8>());
    return (int)cudaErrorInvalidValue;
  };
  switch (mode) {
    case kA: return with_unroll(std::integral_constant<int, kA>());
    case kB: return with_unroll(std::integral_constant<int, kB>());
    case kC: return with_unroll(std::integral_constant<int, kC>());
    case kE: return with_unroll(std::integral_constant<int, kE>());
    default: return (int)cudaErrorInvalidValue;
  }
}
