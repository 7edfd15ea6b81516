// K4: the multipole far field over per-target lists of node rows,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_gathered_kernel` in
// parallelnbody_tpu/ops/pallas_bh.py (called through `_gathered_call`,
// `_far_eval` and `far_field_pallas`). Wrapper and plain PyTorch version:
// parallelnbody_tpu_torch/ops/bh_kernels.py (`far_gather`,
// `far_gather_plain`).
//
// What it computes. table (n_nodes, C) holds node rows
// [x, y, z, m(, Qxx, Qyy, Qxy, Qxz, Qyz)] (C = 4 monopole, 9 with the
// traceless quadrupole). Target leaf t's list idx[t, :] names rows of it.
// Front-packed lists (SCATTERED false) have cnt[t] live entries at the
// front; a scattered list (SCATTERED true, `front_packed=False`) is walked
// over all `budget` entries and its valid[t, :] mask decides which act.
// Every live row acts on every target i of the leaf with the monopole and
// quadrupole terms of terms.cuh (the formula of pallas_bh.py:98-117).
//
// Design. One block per target leaf, one thread per target particle
// (blockDim = G), sums in registers. The block walks its list in chunks of
// CHUNK entries: all threads together read the chunk's rows by index into
// shared memory (CHUNK * C floats), then each thread evaluates them, every
// thread on the same row, so a skipped entry never diverges. The TPU's
// gathered (L, B, 128) buffer in HBM (`_FAR_GATHER_BYTES` row chunking) and
// its fold8 lane accumulators are not needed: the node tables (the upper
// table ~600 rows, the leaf table 4096 rows at N = 1M) stay in L2 and are
// read by index inside the kernel, as K2 reads its octets.
//
// What bounds it. Each row costs ~45 FP32 instructions and one rsqrt per
// target against 36 bytes of node data shared by the G targets, so the
// kernel is bound by FP32 issue and rsqrt throughput; the row reads are
// L2-latency-bound gathers, issued by all threads at once per chunk.
// Double-buffered staging and several targets per thread are later work.

#include <cuda_runtime.h>

#include "terms.cuh"

namespace {

constexpr int CHUNK = 128;

struct Args {
  const float* table;
  const float* tgt;
  const int* idx;
  const unsigned char* valid;
  const int* cnt;
  float* acc;
  float* pot;
  int n_slice, leaf_size, budget;
  float g, eps2;
};

template <bool QUAD, bool GUARD_ZERO, bool COMPUTE_POT, bool SCATTERED>
__global__ void far_gather_kernel(const Args a) {
  constexpr int C = QUAD ? 9 : 4;
  __shared__ float rows[CHUNK * C];
  __shared__ unsigned char live[CHUNK];

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const long long row = (long long)t * a.leaf_size + i;
  const float xi = a.tgt[row * 3 + 0];
  const float yi = a.tgt[row * 3 + 1];
  const float zi = a.tgt[row * 3 + 2];
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);

  const int n = SCATTERED ? a.budget : a.cnt[t];
  const int* __restrict__ list = a.idx + (long long)t * a.budget;
  const unsigned char* __restrict__ ok = a.valid + (long long)t * a.budget;
  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int m = min(CHUNK, n - c0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int e = i; e < m * C; e += blockDim.x) {
      const int entry = e / C;
      // A scattered list reads only the rows of its valid entries.
      rows[e] = (!SCATTERED || ok[c0 + entry])
                    ? a.table[(long long)list[c0 + entry] * C + (e - entry * C)]
                    : 0.f;
    }
    if (SCATTERED)
      for (int e = i; e < m; e += blockDim.x) live[e] = ok[c0 + e];
    __syncthreads();

    for (int e = 0; e < m; ++e) {
      if (SCATTERED && !live[e]) continue;  // uniform across the block
      pnb::node_term<QUAD, GUARD_ZERO, COMPUTE_POT>(rows + e * C, xi, yi, zi,
                                                    a.eps2, sum);
    }
  }
  a.acc[row * 3 + 0] = a.g * sum.x;
  a.acc[row * 3 + 1] = a.g * sum.y;
  a.acc[row * 3 + 2] = a.g * sum.z;
  a.pot[row] = COMPUTE_POT ? -a.g * sum.w : 0.f;
}

template <bool QUAD, bool GUARD_ZERO, bool COMPUTE_POT, bool SCATTERED>
void launch(const Args& a, cudaStream_t stream) {
  far_gather_kernel<QUAD, GUARD_ZERO, COMPUTE_POT, SCATTERED>
      <<<a.n_slice, a.leaf_size, 0, stream>>>(a);
}

template <bool QUAD, bool GUARD_ZERO, bool COMPUTE_POT>
void launch_sc(bool scattered, const Args& a, cudaStream_t stream) {
  if (scattered)
    launch<QUAD, GUARD_ZERO, COMPUTE_POT, true>(a, stream);
  else
    launch<QUAD, GUARD_ZERO, COMPUTE_POT, false>(a, stream);
}

template <bool QUAD, bool GUARD_ZERO>
void launch_pot(bool compute_pot, bool scattered, const Args& a,
                cudaStream_t stream) {
  if (compute_pot)
    launch_sc<QUAD, GUARD_ZERO, true>(scattered, a, stream);
  else
    launch_sc<QUAD, GUARD_ZERO, false>(scattered, a, stream);
}

template <bool QUAD>
void launch_guard(bool guard_zero, bool compute_pot, bool scattered,
                  const Args& a, cudaStream_t stream) {
  if (guard_zero)
    launch_pot<QUAD, true>(compute_pot, scattered, a, stream);
  else
    launch_pot<QUAD, false>(compute_pot, scattered, a, stream);
}

}  // namespace

extern "C" int pnb_far_gather(const void* table, const void* tgt,
                              const void* idx, const void* valid,
                              const void* cnt, void* acc, void* pot,
                              int n_slice, int leaf_size, int budget,
                              int n_comp, float g, float eps2, int guard_zero,
                              int compute_pot, int scattered, void* stream) {
  if (n_slice <= 0) return (int)cudaSuccess;
  if (n_comp != 4 && n_comp != 9) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(table),
               static_cast<const float*>(tgt),
               static_cast<const int*>(idx),
               static_cast<const unsigned char*>(valid),
               static_cast<const int*>(cnt),
               static_cast<float*>(acc),
               static_cast<float*>(pot),
               n_slice, leaf_size, budget, g, eps2};
  auto st = static_cast<cudaStream_t>(stream);
  if (n_comp == 9)
    launch_guard<true>(guard_zero != 0, compute_pot != 0, scattered != 0, a,
                       st);
  else
    launch_guard<false>(guard_zero != 0, compute_pot != 0, scattered != 0, a,
                        st);
  return (int)cudaGetLastError();
}
