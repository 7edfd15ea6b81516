// K2: the octet-masked multipole far field, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_far_octet_kernel` in
// parallelnbody_tpu/ops/pallas_bh.py (called through `far_octet_pallas`).
// Wrapper, row packing and plain PyTorch version:
// parallelnbody_tpu_torch/ops/bh_kernels.py (`far_octet`, `far_rows`,
// `far_octet_plain`).
//
// What it computes. The node table (n8 rows) stacks every tree level, each
// padded to a multiple of 8 rows, so the 8 siblings of a node form an
// aligned octet of rows. The wrapper packs each row into ROW float4
// (terms.cuh: [x, y, z, m], plus [Qxx, Qyy, Qxy, Qxz] [Qyz, Qzz, 0, 0] with
// the traceless quadrupole). Target leaf t's far list holds keys
// (octet_id << 8) | child_mask, front-packed (cnt[t] live entries). Every
// child whose mask bit is set acts on every target i as
//     u = rsqrt(r^2 + eps^2), monopole: acc += g m u^3 d, pot -= g m u
//     quadrupole (qd = Q d, qq = d.Q.d):
//         acc += g (2.5 qq u^7 d - u^5 qd),  pot -= g 0.5 qq u^5
// with d = x_node - x_i: the formula of pallas_bh.py:438-455 (terms.cuh
// quad_term). Children whose bit is clear contribute nothing.
//
// What bounds it. A quadrupole term is 48 FP32 operations and one rsqrt per
// target against 48 bytes of node row shared by the G targets of a leaf,
// and the node table (under 1 MB at N = 1M) stays in L2: the kernel is
// bound by FP32 issue.
//
// Design (terms.cuh far_sweep).
//   * One block per target leaf; a thread holds R targets in registers, so a
//     node row's three LDS.128, the loop and the staging are paid once per R
//     terms. R = 4 from leaf 128 on (two warps a block at leaf 256, one at
//     leaf 128), fewer below, so that a block fills a warp.
//   * Only accepted children are staged: warp 0 expands a window of 32 keys
//     by a prefix sum of popc(mask) into a dense run of rows in list order
//     (key, then bit), copied with cp.async into a ring of two buffers while
//     the block sweeps the other one. The sweep has no mask test and no
//     branch per child. The TPU kernel's VMEM segments and (8, 128) tiles
//     are not needed.
//   * Balance. At N = 1M the longest list holds under 1.5 x the mean of
//     accepted children and the time per term is about the same on the
//     t = 0 lists and after 8 steps (chip_smoke.py), so rows are not split.
//     But the blocks do not all fit on the card at once, and in curve order
//     the long lists came last: the wrapper gives the leaves longest list
//     first (`order`), so the last blocks to start are short ones.
//   * No float atomics: every target adds its terms in list order, so the
//     output is the same bits from launch to launch, in any launch order.
//   * What decided the constants: a sweep of variant builds on the card at
//     N = 1M (PERF.md §6). R = 4 beat R = 8 (one-warp blocks at 96
//     registers, fewer warps an SM) and R = 2; capping R = 8's registers for
//     more blocks an SM lost; buffers of 64 rows beat 32 (in three buffers)
//     and 128; unrolling 1 or 4 rows instead of 2, computing a row's R
//     rsqrts before the rest of the term, and reading the keys a window
//     ahead did not help.

#include <cuda_runtime.h>

#include <type_traits>

#include "terms.cuh"

namespace {

template <int R, bool QUAD, bool GUARD_ZERO, bool COMPUTE_POT>
__global__ void __launch_bounds__(1024 / R)
    far_octet_kernel(const float4* __restrict__ nodes,
                     const float* __restrict__ tgt,
                     const int* __restrict__ keys,
                     const int* __restrict__ cnt,
                     const int* __restrict__ order, float* __restrict__ acc,
                     float* __restrict__ pot, int leaf_size, int budget,
                     float g, float eps2) {
  constexpr int ROW = QUAD ? 3 : 1;
  __shared__ float4 ring[pnb::kFarStages * pnb::kFarTile * ROW];
  __shared__ int n_rows[pnb::kFarStages];
  const int leaf = order[blockIdx.x];
  const long long first = (long long)leaf * leaf_size;
  const int* list = keys + (long long)leaf * budget;
  pnb::Targets<R> t;
  pnb::load_targets(tgt, first, leaf_size, t);
  pnb::far_sweep<R, ROW, GUARD_ZERO, COMPUTE_POT>(
      ring, n_rows, cnt[leaf],
      [&](int e, const float4*& src, unsigned& mask) {
        const int key = list[e];
        src = nodes + (long long)(key >> 8) * (8 * ROW);
        mask = key & 0xff;
      },
      eps2, t);
  pnb::store_targets<R, COMPUTE_POT>(acc, pot, first, leaf_size, g, t);
}

template <int R, bool QUAD, bool GUARD_ZERO, bool COMPUTE_POT>
cudaError_t launch(const float4* nodes, const float* tgt, const int* keys,
                   const int* cnt, const int* order, float* acc, float* pot,
                   int n_slice, int leaf_size, int budget, float g,
                   float eps2, cudaStream_t stream) {
  far_octet_kernel<R, QUAD, GUARD_ZERO, COMPUTE_POT>
      <<<n_slice, (leaf_size + R - 1) / R, 0, stream>>>(
          nodes, tgt, keys, cnt, order, acc, pot, leaf_size, budget, g, eps2);
  return cudaGetLastError();
}

}  // namespace

// nodes: (n8, n_comp) packed rows, n_comp 4 ([x, y, z, m]) or 12 (with the
// quadrupole, bh_kernels.far_rows), 16-byte aligned.
extern "C" int pnb_far_octet(const void* nodes, const void* tgt,
                             const void* keys, const void* cnt,
                             const void* order, void* acc, void* pot,
                             int n_slice, int leaf_size, int budget,
                             int n_comp, float g, float eps2, int guard_zero,
                             int compute_pot, void* stream) {
  if (n_slice <= 0) return (int)cudaSuccess;
  if (n_comp != 4 && n_comp != 12) return (int)cudaErrorInvalidValue;
  auto nd = static_cast<const float4*>(nodes);
  auto tg = static_cast<const float*>(tgt);
  auto k = static_cast<const int*>(keys);
  auto c = static_cast<const int*>(cnt);
  auto o = static_cast<const int*>(order);
  auto a = static_cast<float*>(acc);
  auto p = static_cast<float*>(pot);
  auto st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto fn) {
    return (int)fn(nd, tg, k, c, o, a, p, n_slice, leaf_size, budget, g,
                   eps2, st);
  };
  auto with_r = [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (n_comp == 12) {
      if (guard_zero)
        return compute_pot ? go(launch<R, true, true, true>)
                           : go(launch<R, true, true, false>);
      return compute_pot ? go(launch<R, true, false, true>)
                         : go(launch<R, true, false, false>);
    }
    if (guard_zero)
      return compute_pot ? go(launch<R, false, true, true>)
                         : go(launch<R, false, true, false>);
    return compute_pot ? go(launch<R, false, false, true>)
                       : go(launch<R, false, false, false>);
  };
  // 4 targets a thread, fewer where a block would not fill a warp.
  if (leaf_size >= 128) return with_r(std::integral_constant<int, 4>());
  if (leaf_size >= 64) return with_r(std::integral_constant<int, 2>());
  return with_r(std::integral_constant<int, 1>());
}
