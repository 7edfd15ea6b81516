// K8: the near-field probe kernel of a TPU experiment, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel built by `make_kernel(mode, unroll)` in
// scripts/near_kernel_probe.py (inner `kern`, called through its
// `pallas_call`). Wrapper, bounds, table packing and plain PyTorch version:
// parallelnbody_tpu_torch/ops/near_probe.py (`near_probe`,
// `probe_bounds`, `probe_table`, `near_probe_plain`). No path of the
// system runs it; tools/near_kernel_probe.py times it against K1
// (near_field.cu) on the same lists.
//
// What it computes. K1's near field for the acceleration only, over one
// segment of the source-leaf table: target leaf t holds G targets; the
// entries [lo, hi) of its front-packed ascending list name the source
// leaves of this segment (bnd[t, seg], bnd[t, seg + 1]). For each entry k,
// taken `unroll` entries a trip, every target adds the tile's G sources
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
//   E  as A, but the trip's `unroll` tiles are all staged before any
//      arithmetic.
// The script's tail rule is kept: a trip past hi reads row(hi - 1) (A, E)
// and the entry's mass is multiplied by (k < hi), so it adds zeros.
// F is A on a table whose sources are 8 floats apart (STRIDE 8), the
// script's rows padded to 8 components.
//
// What bounds it. A pair is K1's: 18 FP32 operations and one rsqrt. A tile
// of G float4 (4 KB at G = 256) serves G^2 pairs: bound by FP32 issue, as
// K1 is.
//
// Design. The first answer to the script's question, not a tuned kernel:
// one block per target leaf of the segment, one thread per target, and per
// entry one synchronous staging of the tile (thread i copies source i) and
// a barrier on each side of the sweep (E: one staging of all `unroll`
// tiles a trip). So A - B measures the list read, B - C the read of a new
// row, and E, unroll 8, F and the segmentation what they move. The TPU's
// lane reductions have no counterpart: a thread sums its own target.

#include <cuda_runtime.h>

#include <type_traits>

#include "terms.cuh"

namespace {

enum Mode { kA = 0, kB = 1, kC = 2, kE = 3 };

// Source i = threadIdx.x of table row `row` into dst[i], mass times live.
template <int STRIDE>
__device__ __forceinline__ void stage_tile(float4* dst, const float* seg,
                                           int row, int G, bool live) {
  const int i = threadIdx.x;
  float4 p = *reinterpret_cast<const float4*>(
      seg + ((long long)row * G + i) * STRIDE);
  p.w *= live ? 1.f : 0.f;
  dst[i] = p;
}

// The tile's G sources on one target, summed on their own, then the sum
// into the carry.
__device__ __forceinline__ void sweep_tile(const float4* tile, int G, float xi,
                                           float yi, float zi, float eps2,
                                           float3& carry) {
  float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int j = 0; j < G; ++j) {
    const float4 p = tile[j];
    pnb::monopole_term<false, false>(p.x - xi, p.y - yi, p.z - zi, p.w, eps2,
                                     e);
  }
  carry.x += e.x;
  carry.y += e.y;
  carry.z += e.z;
}

template <int MODE, int U, int STRIDE>
__global__ void __launch_bounds__(1024)
    near_probe_kernel(const int* __restrict__ bnd, int n_bnd, int seg,
                      const int* __restrict__ idx, int budget,
                      const float* __restrict__ tgt,
                      const float* __restrict__ table, int rows,
                      float* __restrict__ out, int G, float eps2) {
  extern __shared__ float4 tiles[];  // U tiles (E) or one
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int lo = bnd[(long long)t * n_bnd + seg];
  const int hi = bnd[(long long)t * n_bnd + seg + 1];
  const float* tt = tgt + (long long)t * 4 * G;
  const float xi = tt[i], yi = tt[G + i], zi = tt[2 * G + i];
  const int* list = idx + (long long)t * budget;
  const int base = seg * rows;
  const float* seg_table = table + (long long)base * G * STRIDE;
  auto row_of = [&](int k) {
    if (MODE == kA || MODE == kE) return list[min(k, hi - 1)] - base;
    if (MODE == kB) return k % rows;
    return 0;
  };
  float3 carry = make_float3(0.f, 0.f, 0.f);
  const int n_trips = (hi - lo + U - 1) / U;
  for (int c = 0; c < n_trips; ++c) {
    const int k0 = lo + c * U;
    if (MODE == kE) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        stage_tile<STRIDE>(tiles + u * G, seg_table, row_of(k0 + u), G,
                           k0 + u < hi);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < U; ++u)
        sweep_tile(tiles + u * G, G, xi, yi, zi, eps2, carry);
      __syncthreads();
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        stage_tile<STRIDE>(tiles, seg_table, row_of(k0 + u), G, k0 + u < hi);
        __syncthreads();
        sweep_tile(tiles, G, xi, yi, zi, eps2, carry);
        __syncthreads();
      }
    }
  }
  float* o = out + (long long)t * 4 * G;
  if (seg == 0) {
    o[i] = carry.x;
    o[G + i] = carry.y;
    o[2 * G + i] = carry.z;
    o[3 * G + i] = 0.f;
  } else {
    o[i] = __fadd_rn(o[i], carry.x);
    o[G + i] = __fadd_rn(o[G + i], carry.y);
    o[2 * G + i] = __fadd_rn(o[2 * G + i], carry.z);
  }
}

template <int MODE, int U, int STRIDE>
cudaError_t launch(const int* bnd, int n_bnd, int seg, const int* idx,
                   int budget, const float* tgt, const float* table, int rows,
                   float* out, int n_leaves, int G, float eps2,
                   cudaStream_t stream) {
  auto kernel = near_probe_kernel<MODE, U, STRIDE>;
  const size_t smem = (size_t)(MODE == kE ? U : 1) * G * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_leaves, G, smem, stream>>>(bnd, n_bnd, seg, idx, budget, tgt,
                                        table, rows, out, G, eps2);
  return cudaGetLastError();
}

}  // namespace

// One segment `seg` (of n_bnd - 1) of rows source leaves: out (L, 4, G) is
// written for seg 0 and added to after it. mode 0-3 = A, B, C, E; unroll 4
// or 8; n_comp 4 or 8 floats a source in table (n_leaves_total, G, n_comp).
extern "C" int pnb_near_probe(const void* bnd, const void* idx,
                              const void* tgt, const void* table, void* out,
                              int n_leaves, int leaf_size, int budget,
                              int n_bnd, int seg, int rows, int n_comp,
                              int mode, int unroll, float eps2,
                              void* stream) {
  if (n_leaves <= 0) return (int)cudaSuccess;
  if (leaf_size <= 0 || leaf_size > 1024 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto fn) {
    return (int)fn(static_cast<const int*>(bnd), n_bnd, seg,
                   static_cast<const int*>(idx), budget,
                   static_cast<const float*>(tgt),
                   static_cast<const float*>(table), rows,
                   static_cast<float*>(out), n_leaves, leaf_size, eps2,
                   static_cast<cudaStream_t>(stream));
  };
  auto with_stride = [&](auto m, auto u) {
    constexpr int M = decltype(m)::value;
    constexpr int U = decltype(u)::value;
    if (n_comp == 4) return go(launch<M, U, 4>);
    if (n_comp == 8) return go(launch<M, U, 8>);
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
