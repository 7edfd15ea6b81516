// K1: the exact softened Barnes-Hut near field, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_near_table_kernel` in
// parallelnbody_tpu/ops/pallas_bh.py (called through `near_field_pallas`).
// Wrapper and plain PyTorch version: parallelnbody_tpu_torch/ops/bh_kernels.py
// (`near_field`, `near_field_plain`).
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
// Design. One block per target leaf, one thread per target particle
// (blockDim = G); the four sums stay in registers. For each list entry the
// block stages the source leaf's G (x, y, z, m) into shared memory as float4
// (thread i loads particle i, so the reads of pos/mass are coalesced), then
// every thread sweeps the G sources. The TPU kernel's VMEM table segments,
// unroll tables and (L, 4, G) lane layout are not needed here: the whole
// source table (16 MB at N = 1M) sits in the 50 MB L2.
//
// What bounds it. Each pair costs ~20 FP32 operations and one rsqrt, while
// a staged source leaf (4 KB at G = 256) serves G^2 pairs, so the kernel is
// bound by FP32 FMA and MUFU rsqrt throughput, not by memory. The design
// answers that with the shared-memory broadcast (one LDS.128 per pair, the
// same address across the warp) and FMAs for every accumulation; several
// targets per thread, double-buffered staging and tensor-core variants are
// later work.

#include <cuda_runtime.h>

#include "terms.cuh"

namespace {

template <bool GUARD_ZERO, bool COMPUTE_POT>
__global__ void near_field_kernel(const float* __restrict__ pos,
                                  const float* __restrict__ mass,
                                  const float* __restrict__ tgt,
                                  const int* __restrict__ idx,
                                  const int* __restrict__ cnt,
                                  float* __restrict__ acc,
                                  float* __restrict__ pot,
                                  int leaf_size, int budget, float g,
                                  float eps2) {
  extern __shared__ float4 src[];
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const long long row = (long long)t * leaf_size + i;
  const float xi = tgt[row * 3 + 0];
  const float yi = tgt[row * 3 + 1];
  const float zi = tgt[row * 3 + 2];
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);

  const int n = cnt[t];
  const int* list = idx + (long long)t * budget;
  for (int k = 0; k < n; ++k) {
    const long long s = (long long)list[k] * leaf_size + i;
    __syncthreads();  // the previous source leaf is fully consumed
    src[i] = make_float4(pos[s * 3 + 0], pos[s * 3 + 1], pos[s * 3 + 2],
                         mass[s]);
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < leaf_size; ++j) {
      const float4 p = src[j];
      pnb::monopole_term<GUARD_ZERO, COMPUTE_POT>(
          p.x - xi, p.y - yi, p.z - zi, p.w, eps2, sum);
    }
  }
  acc[row * 3 + 0] = g * sum.x;
  acc[row * 3 + 1] = g * sum.y;
  acc[row * 3 + 2] = g * sum.z;
  pot[row] = COMPUTE_POT ? -g * sum.w : 0.f;
}

template <bool GUARD_ZERO, bool COMPUTE_POT>
void launch(const float* pos, const float* mass, const float* tgt,
            const int* idx, const int* cnt, float* acc, float* pot,
            int n_slice, int leaf_size, int budget, float g, float eps2,
            cudaStream_t stream) {
  const size_t smem = (size_t)leaf_size * sizeof(float4);
  near_field_kernel<GUARD_ZERO, COMPUTE_POT>
      <<<n_slice, leaf_size, smem, stream>>>(pos, mass, tgt, idx, cnt, acc,
                                             pot, leaf_size, budget, g, eps2);
}

}  // namespace

extern "C" int pnb_near_field(const void* pos, const void* mass,
                              const void* tgt, const void* idx,
                              const void* cnt, void* acc, void* pot,
                              int n_slice, int leaf_size, int budget, float g,
                              float eps2, int guard_zero, int compute_pot,
                              void* stream) {
  if (n_slice <= 0) return (int)cudaSuccess;
  auto p = static_cast<const float*>(pos);
  auto m = static_cast<const float*>(mass);
  auto t = static_cast<const float*>(tgt);
  auto ix = static_cast<const int*>(idx);
  auto c = static_cast<const int*>(cnt);
  auto a = static_cast<float*>(acc);
  auto ph = static_cast<float*>(pot);
  auto st = static_cast<cudaStream_t>(stream);
  if (guard_zero) {
    if (compute_pot)
      launch<true, true>(p, m, t, ix, c, a, ph, n_slice, leaf_size, budget, g,
                         eps2, st);
    else
      launch<true, false>(p, m, t, ix, c, a, ph, n_slice, leaf_size, budget,
                          g, eps2, st);
  } else {
    if (compute_pot)
      launch<false, true>(p, m, t, ix, c, a, ph, n_slice, leaf_size, budget,
                          g, eps2, st);
    else
      launch<false, false>(p, m, t, ix, c, a, ph, n_slice, leaf_size, budget,
                           g, eps2, st);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pnb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
