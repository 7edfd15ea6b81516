// K3: all-pairs softened gravity, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_allpairs_kernel` in
// parallelnbody_tpu/ops/pallas_direct.py (called through `allpairs_raw`).
// Wrapper and plain PyTorch version:
// parallelnbody_tpu_torch/ops/direct_kernels.py (`allpairs`,
// `allpairs_plain`).
//
// What it computes. The raw sums out (Ni, 4) =
// [sum w dx, sum w dy, sum w dz, sum m u] of every target i of pos_i (Ni, 3)
// against every source j of pos_j (Nj, 3), mass_j (Nj,), with
// d = x_j - x_i, u = rsqrt(|d|^2 + eps^2), w = m_j u^3 (terms.cuh). The
// caller scales by g and negates the last column into the potential;
// COMPUTE_POT false writes 0 there. With softening > 0 a target that is also
// a source adds m_i / eps to its own potential sum, as the JAX package does.
//
// Design. One thread per target, THREADS targets per block, four sums in
// registers. The block walks the sources in tiles of THREADS: each thread
// stages one source as float4 [x, y, z, m] in shared memory, then every
// thread sweeps the tile (one broadcast LDS.128 per pair). The last tile is
// cut to the sources that exist, and threads past Ni only help to stage, so
// any Ni and Nj work without padding. The TPU kernel's (TILE_I, TILE_J) grid,
// whose j-innermost steps carry the sums in VMEM, becomes the loop over
// tiles inside one block.
//
// What bounds it. Each pair costs ~12 FP32 instructions, one MUFU rsqrt and
// one LDS, while the sources (4 MB at N = 262144) stay in L2 and each staged
// tile serves THREADS^2 pairs. So the kernel is bound by instruction issue:
// at N = 262144, 6.9e10 pairs need >= 16 ms of the H100's rsqrt rate alone
// and ~20-30 ms of issue slots. Several targets per thread (fewer LDS per
// pair) and a tuned tile are later work.

#include <cuda_runtime.h>

#include "terms.cuh"

namespace {

constexpr int THREADS = 128;

template <bool GUARD_ZERO, bool COMPUTE_POT>
__global__ void __launch_bounds__(THREADS)
    allpairs_kernel(const float* __restrict__ pos_i,
                    const float* __restrict__ pos_j,
                    const float* __restrict__ mass_j,
                    float* __restrict__ out, int ni, int nj, float eps2) {
  __shared__ float4 src[THREADS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < ni;
  const float xi = live ? pos_i[(long long)i * 3 + 0] : 0.f;
  const float yi = live ? pos_i[(long long)i * 3 + 1] : 0.f;
  const float zi = live ? pos_i[(long long)i * 3 + 2] : 0.f;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int j0 = 0; j0 < nj; j0 += THREADS) {
    const int m = min(THREADS, nj - j0);
    const long long j = j0 + threadIdx.x;
    __syncthreads();  // the previous tile is fully consumed
    if (threadIdx.x < m)
      src[threadIdx.x] = make_float4(pos_j[j * 3 + 0], pos_j[j * 3 + 1],
                                     pos_j[j * 3 + 2], mass_j[j]);
    __syncthreads();
    if (m == THREADS) {
#pragma unroll 8
      for (int k = 0; k < THREADS; ++k) {
        const float4 p = src[k];
        pnb::monopole_term<GUARD_ZERO, COMPUTE_POT>(
            p.x - xi, p.y - yi, p.z - zi, p.w, eps2, sum);
      }
    } else {
      for (int k = 0; k < m; ++k) {
        const float4 p = src[k];
        pnb::monopole_term<GUARD_ZERO, COMPUTE_POT>(
            p.x - xi, p.y - yi, p.z - zi, p.w, eps2, sum);
      }
    }
  }
  if (live) {
    reinterpret_cast<float4*>(out)[i] =
        make_float4(sum.x, sum.y, sum.z, COMPUTE_POT ? sum.w : 0.f);
  }
}

template <bool GUARD_ZERO, bool COMPUTE_POT>
void launch(const float* pos_i, const float* pos_j, const float* mass_j,
            float* out, int ni, int nj, float eps2, cudaStream_t stream) {
  const int blocks = (ni + THREADS - 1) / THREADS;
  allpairs_kernel<GUARD_ZERO, COMPUTE_POT><<<blocks, THREADS, 0, stream>>>(
      pos_i, pos_j, mass_j, out, ni, nj, eps2);
}

}  // namespace

extern "C" int pnb_allpairs(const void* pos_i, const void* pos_j,
                            const void* mass_j, void* out, int ni, int nj,
                            float eps2, int guard_zero, int compute_pot,
                            void* stream) {
  if (ni <= 0) return (int)cudaSuccess;
  auto pi = static_cast<const float*>(pos_i);
  auto pj = static_cast<const float*>(pos_j);
  auto mj = static_cast<const float*>(mass_j);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (guard_zero) {
    if (compute_pot)
      launch<true, true>(pi, pj, mj, o, ni, nj, eps2, st);
    else
      launch<true, false>(pi, pj, mj, o, ni, nj, eps2, st);
  } else {
    if (compute_pot)
      launch<false, true>(pi, pj, mj, o, ni, nj, eps2, st);
    else
      launch<false, false>(pi, pj, mj, o, ni, nj, eps2, st);
  }
  return (int)cudaGetLastError();
}
