// K4: the multipole far field over per-target lists of node rows,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_gathered_kernel` in
// parallelnbody_tpu/ops/pallas_bh.py (called through `_gathered_call`,
// `_far_eval` and `far_field_pallas`). Wrapper, row packing and plain
// PyTorch version: parallelnbody_tpu_torch/ops/bh_kernels.py (`far_gather`,
// `far_rows`, `far_gather_plain`).
//
// What it computes. The table holds node rows, packed by the wrapper into
// ROW float4 (terms.cuh: [x, y, z, m], plus [Qxx, Qyy, Qxy, Qxz]
// [Qyz, Qzz, 0, 0] with the traceless quadrupole). Target leaf t's list
// idx[t, :] names rows of it. Front-packed lists (SCATTERED false) have
// cnt[t] live entries at the front; a scattered list (SCATTERED true,
// `front_packed=False`) is read over all `budget` entries and its
// valid[t, :] mask decides which act. Every live row acts on every target i
// of the leaf with the monopole and quadrupole terms of terms.cuh (the
// formula of pallas_bh.py:98-117).
//
// What bounds it. As K2 (far_octet.cu): 48 FP32 operations and one rsqrt a
// quadrupole term against a 48-byte row shared by a leaf's G targets, the
// node tables (the upper table ~600 rows, the leaf table 4096 rows at
// N = 1M) in L2: FP32 issue.
//
// Design. The sweep of K2 (terms.cuh far_sweep, far_octet.cu): one block
// per target leaf, leaves launched longest list first (`order`), R targets a
// thread (R from G as K2 chooses it), warp 0 staging the rows of a window of
// 32 entries into a ring of two buffers with cp.async while the block
// sweeps the other. An entry names one row (mask 1); a scattered list's
// invalid entries get mask 0, so the prefix sum that places the rows also
// compacts the valid ones and the sweep walks live rows only. The TPU's
// gathered (L, B, 128) buffer in HBM (`_FAR_GATHER_BYTES` row chunking) and
// its fold8 lane accumulators are not needed. No float atomics: the output
// is the same bits from launch to launch.

#include <cuda_runtime.h>

#include <type_traits>

#include "terms.cuh"

namespace {

struct Args {
  const float4* table;
  const float* tgt;
  const int* idx;
  const unsigned char* valid;
  const int* cnt;
  const int* order;
  float* acc;
  float* pot;
  int n_slice, leaf_size, budget;
  float g, eps2;
};

template <int R, bool QUAD, bool GUARD_ZERO, bool COMPUTE_POT, bool SCATTERED>
__global__ void __launch_bounds__(1024 / R) far_gather_kernel(const Args a) {
  constexpr int ROW = QUAD ? 3 : 1;
  __shared__ float4 ring[pnb::kFarStages * pnb::kFarTile * ROW];
  __shared__ int n_rows[pnb::kFarStages];
  const int leaf = a.order[blockIdx.x];
  const long long first = (long long)leaf * a.leaf_size;
  const int* __restrict__ list = a.idx + (long long)leaf * a.budget;
  const unsigned char* __restrict__ ok = a.valid + (long long)leaf * a.budget;
  pnb::Targets<R> t;
  pnb::load_targets(a.tgt, first, a.leaf_size, t);
  pnb::far_sweep<R, ROW, GUARD_ZERO, COMPUTE_POT>(
      ring, n_rows, SCATTERED ? a.budget : a.cnt[leaf],
      [&](int e, const float4*& src, unsigned& mask) {
        mask = (!SCATTERED || ok[e]) ? 1u : 0u;
        if (mask) src = a.table + (long long)list[e] * ROW;
      },
      a.eps2, t);
  pnb::store_targets<R, COMPUTE_POT>(a.acc, a.pot, first, a.leaf_size, a.g,
                                     t);
}

template <int R, bool QUAD, bool GUARD_ZERO, bool COMPUTE_POT, bool SCATTERED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  far_gather_kernel<R, QUAD, GUARD_ZERO, COMPUTE_POT, SCATTERED>
      <<<a.n_slice, (a.leaf_size + R - 1) / R, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// table: (n_nodes, n_comp) packed rows, n_comp 4 ([x, y, z, m]) or 12 (with
// the quadrupole, bh_kernels.far_rows), 16-byte aligned.
extern "C" int pnb_far_gather(const void* table, const void* tgt,
                              const void* idx, const void* valid,
                              const void* cnt, const void* order, void* acc,
                              void* pot, int n_slice, int leaf_size, int budget,
                              int n_comp, float g, float eps2, int guard_zero,
                              int compute_pot, int scattered, void* stream) {
  if (n_slice <= 0) return (int)cudaSuccess;
  if (n_comp != 4 && n_comp != 12) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float4*>(table),
               static_cast<const float*>(tgt),
               static_cast<const int*>(idx),
               static_cast<const unsigned char*>(valid),
               static_cast<const int*>(cnt),
               static_cast<const int*>(order),
               static_cast<float*>(acc),
               static_cast<float*>(pot),
               n_slice, leaf_size, budget, g, eps2};
  auto st = static_cast<cudaStream_t>(stream);
  auto with_r = [&](auto r) {
    constexpr int R = decltype(r)::value;
    auto with_quad = [&](auto quad) {
      constexpr bool Q = decltype(quad)::value;
      if (guard_zero) {
        if (compute_pot)
          return scattered ? launch<R, Q, true, true, true>(a, st)
                           : launch<R, Q, true, true, false>(a, st);
        return scattered ? launch<R, Q, true, false, true>(a, st)
                         : launch<R, Q, true, false, false>(a, st);
      }
      if (compute_pot)
        return scattered ? launch<R, Q, false, true, true>(a, st)
                         : launch<R, Q, false, true, false>(a, st);
      return scattered ? launch<R, Q, false, false, true>(a, st)
                       : launch<R, Q, false, false, false>(a, st);
    };
    return (int)(n_comp == 12 ? with_quad(std::true_type())
                              : with_quad(std::false_type()));
  };
  // 4 targets a thread, fewer where a block would not fill a warp.
  if (leaf_size >= 128) return with_r(std::integral_constant<int, 4>());
  if (leaf_size >= 64) return with_r(std::integral_constant<int, 2>());
  return with_r(std::integral_constant<int, 1>());
}
