// K2: the octet-masked multipole far field, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_far_octet_kernel` in
// parallelnbody_tpu/ops/pallas_bh.py (called through `far_octet_pallas`).
// Wrapper and plain PyTorch version: parallelnbody_tpu_torch/ops/bh_kernels.py
// (`far_octet`, `far_octet_plain`).
//
// What it computes. The node table nodes8 (n8, C) stacks every tree level,
// each padded to a multiple of 8 rows, so the 8 siblings of a node form an
// aligned octet of rows [x, y, z, m(, Qxx, Qyy, Qxy, Qxz, Qyz)] (C = 4 for a
// monopole table, 9 with the traceless quadrupole). Target leaf t's far list
// holds keys (octet_id << 8) | child_mask, front-packed (cnt[t] live
// entries). Every child whose mask bit is set acts on every target i as
//     u = rsqrt(r^2 + eps^2), monopole: acc += g m u^3 d, pot -= g m u
//     quadrupole (Qzz = -Qxx - Qyy, qd = Q d, qq = d.Q.d):
//         acc += g (2.5 qq u^7 d - u^5 qd),  pot -= g 0.5 qq u^5
// with d = x_node - x_i: the formula of pallas_bh.py:438-455 (terms.cuh).
// Children whose bit is clear contribute nothing.
//
// Design. One block per target leaf, one thread per target particle
// (blockDim = G), sums in registers. The block walks its key list in chunks
// of CHUNK entries: all threads together decode the keys and copy the
// chunk's sibling octets (CHUNK * 8 * C floats) into shared memory, then each
// thread evaluates the accepted children. Every thread of a block reads the
// same key, so the test of a mask bit never diverges. The node table (under
// 1 MB at N = 1M) stays in L2; the TPU kernel's VMEM segments and (8, 128)
// tiles are not needed.
//
// What bounds it. Each accepted child costs ~50 FP32 operations and one
// rsqrt per target against 36 bytes of node data shared by the G targets,
// so the kernel is bound by FP32 FMA and rsqrt throughput; the shared-memory
// staging keeps the node reads off the arithmetic path (one broadcast LDS
// per value). Mask-dense octet packing, several targets per thread and
// double-buffered staging are later work.

#include <cuda_runtime.h>

#include "terms.cuh"

namespace {

constexpr int CHUNK = 32;

template <bool QUAD, bool GUARD_ZERO, bool COMPUTE_POT>
__global__ void far_octet_kernel(const float* __restrict__ nodes8,
                                 const float* __restrict__ tgt,
                                 const int* __restrict__ keys,
                                 const int* __restrict__ cnt,
                                 float* __restrict__ acc,
                                 float* __restrict__ pot, int leaf_size,
                                 int budget, float g, float eps2) {
  constexpr int C = QUAD ? 9 : 4;
  constexpr int OCT = 8 * C;  // floats per sibling octet
  __shared__ float rows[CHUNK * OCT];
  __shared__ int masks[CHUNK];

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const long long row = (long long)t * leaf_size + i;
  const float xi = tgt[row * 3 + 0];
  const float yi = tgt[row * 3 + 1];
  const float zi = tgt[row * 3 + 2];
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);

  const int n = cnt[t];
  const int* list = keys + (long long)t * budget;
  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int m = min(CHUNK, n - c0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int e = i; e < m * OCT; e += blockDim.x) {
      const int entry = e / OCT;
      const int key = list[c0 + entry];
      rows[e] = nodes8[(long long)(key >> 8) * OCT + (e - entry * OCT)];
    }
    for (int e = i; e < m; e += blockDim.x) masks[e] = list[c0 + e] & 0xff;
    __syncthreads();

    for (int e = 0; e < m; ++e) {
      const int mask = masks[e];
      const float* oct = rows + e * OCT;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (!((mask >> b) & 1)) continue;  // uniform across the block
        pnb::node_term<QUAD, GUARD_ZERO, COMPUTE_POT>(oct + b * C, xi, yi, zi,
                                                      eps2, sum);
      }
    }
  }
  acc[row * 3 + 0] = g * sum.x;
  acc[row * 3 + 1] = g * sum.y;
  acc[row * 3 + 2] = g * sum.z;
  pot[row] = COMPUTE_POT ? -g * sum.w : 0.f;
}

template <bool QUAD, bool GUARD_ZERO>
void launch_pot(bool compute_pot, const float* nodes8, const float* tgt,
                const int* keys, const int* cnt, float* acc, float* pot,
                int n_slice, int leaf_size, int budget, float g, float eps2,
                cudaStream_t stream) {
  if (compute_pot)
    far_octet_kernel<QUAD, GUARD_ZERO, true><<<n_slice, leaf_size, 0, stream>>>(
        nodes8, tgt, keys, cnt, acc, pot, leaf_size, budget, g, eps2);
  else
    far_octet_kernel<QUAD, GUARD_ZERO, false><<<n_slice, leaf_size, 0, stream>>>(
        nodes8, tgt, keys, cnt, acc, pot, leaf_size, budget, g, eps2);
}

}  // namespace

extern "C" int pnb_far_octet(const void* nodes8, const void* tgt,
                             const void* keys, const void* cnt, void* acc,
                             void* pot, int n_slice, int leaf_size, int budget,
                             int n_comp, float g, float eps2, int guard_zero,
                             int compute_pot, void* stream) {
  if (n_slice <= 0) return (int)cudaSuccess;
  if (n_comp != 4 && n_comp != 9) return (int)cudaErrorInvalidValue;
  auto nd = static_cast<const float*>(nodes8);
  auto t = static_cast<const float*>(tgt);
  auto k = static_cast<const int*>(keys);
  auto c = static_cast<const int*>(cnt);
  auto a = static_cast<float*>(acc);
  auto p = static_cast<float*>(pot);
  auto st = static_cast<cudaStream_t>(stream);
  const bool cp = compute_pot != 0;
  if (n_comp == 9) {
    if (guard_zero)
      launch_pot<true, true>(cp, nd, t, k, c, a, p, n_slice, leaf_size, budget,
                             g, eps2, st);
    else
      launch_pot<true, false>(cp, nd, t, k, c, a, p, n_slice, leaf_size,
                              budget, g, eps2, st);
  } else {
    if (guard_zero)
      launch_pot<false, true>(cp, nd, t, k, c, a, p, n_slice, leaf_size,
                              budget, g, eps2, st);
    else
      launch_pot<false, false>(cp, nd, t, k, c, a, p, n_slice, leaf_size,
                               budget, g, eps2, st);
  }
  return (int)cudaGetLastError();
}
