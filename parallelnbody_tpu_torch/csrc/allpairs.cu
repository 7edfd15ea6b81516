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
// against every source j of the packed table src (Nj, 4) = [x, y, z, m],
// with d = x_j - x_i, u = rsqrt(|d|^2 + eps^2), w = m_j u^3 (terms.cuh).
// The caller scales by g and negates the last column into the potential;
// COMPUTE_POT false writes 0 there. With softening > 0 a target that is also
// a source adds m_i / eps to its own potential sum, as the JAX package does.
//
// What bounds it. A pair is 18 FP32 operations (FMA as two) and one rsqrt on
// the MUFU; the sources (4 MB at N = 262144) stay in L2 and a staged tile
// serves every target of the block. The kernel is bound by FP32 issue:
// 6.87e10 pairs at N = 262144 need 18.5 ms at the H100's 67 TFLOP/s.
//
// Design. The register-blocked n-body tile: a block of THREADS threads owns
// THREADS * R targets (thread i holds i, i + THREADS, ...), so one
// broadcast LDS.128 serves R pairs, and walks its sources in tiles of TILE
// float4 that terms.cuh sweep_tiles streams through a cp.async ring. The
// last tile is zero-filled past Nj (massless sources add exactly 0) and threads past Ni only help to
// stage, so any Ni and Nj work without padding in memory. The TPU kernel's
// (TILE_I, TILE_J) grid, whose j-innermost steps carry the sums in VMEM,
// becomes the loop over tiles inside one block.
//
// Split over sources. Ni / (THREADS * R) blocks alone leave most of the card
// idle below N ~ 100k, and at N = 262144 give 16 warps an SM, too few to
// hide the rsqrt's latency. pnb_allpairs_splits cuts the source tiles into S
// contiguous ranges, S the most that still fits the grid in one wave of
// resident blocks; block (x, s) sums range s into partial[s], and
// allpairs_combine_kernel adds the S partials in range order. No float
// atomics: the output is bit-equal from run to run.
//
// Block size, R and the tile were chosen on the card at N = 262144 among 12
// shapes (PERF.md §6): 256 threads, R = 4 and 1024-source tiles ran
// fastest (R = 2 pays an LDS every second pair, R = 8 loses occupancy to
// registers); a longer tile halves the __syncthreads a pair, and a ring of
// 3 beat 2.

#include <cuda_runtime.h>

#include <algorithm>

#include "terms.cuh"

namespace {

constexpr int THREADS = 256;  // threads a block
constexpr int R = 4;          // targets a thread
constexpr int TILE = 1024;    // sources a shared-memory tile

// Block (x, s) sums source tiles [s * per_split, (s + 1) * per_split) on its
// THREADS * R targets into out + s * ni.
template <bool GUARD_ZERO, bool COMPUTE_POT>
__global__ void __launch_bounds__(THREADS)
    allpairs_kernel(const float* __restrict__ pos_i,
                    const float4* __restrict__ src, float4* __restrict__ out,
                    int ni, int nj, int per_split, float eps2) {
  __shared__ float4 ring[pnb::kStages * TILE];
  const long long base = (long long)blockIdx.x * THREADS * R + threadIdx.x;
  pnb::Targets<R> t;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = base + r * THREADS;
    const bool live = i < ni;
    t.x[r] = live ? pos_i[i * 3 + 0] : 0.f;
    t.y[r] = live ? pos_i[i * 3 + 1] : 0.f;
    t.z[r] = live ? pos_i[i * 3 + 2] : 0.f;
    t.s[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int first = blockIdx.y * per_split;
  const int n_tiles = min(per_split, (nj + TILE - 1) / TILE - first);
  pnb::sweep_tiles<R, GUARD_ZERO, COMPUTE_POT>(
      ring, TILE, n_tiles,
      [&](int k) { return src + (long long)(first + k) * TILE; },
      [&](int k) { return min(TILE, nj - (first + k) * TILE); }, eps2, t);
  float4* dst = out + (long long)blockIdx.y * ni;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = base + r * THREADS;
    if (i < ni) {
      const float4 s = t.s[r];
      dst[i] = make_float4(s.x, s.y, s.z, COMPUTE_POT ? s.w : 0.f);
    }
  }
}

// out[i] = partial[0][i] + partial[1][i] + ... in range order.
__global__ void allpairs_combine_kernel(const float4* __restrict__ partial,
                                        float4* __restrict__ out, int ni,
                                        int n_split) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ni) return;
  float4 s = partial[i];
  for (int k = 1; k < n_split; ++k) {
    const float4 q = partial[(long long)k * ni + i];
    s.x += q.x;
    s.y += q.y;
    s.z += q.z;
    s.w += q.w;
  }
  out[i] = s;
}

int tiles_of(int nj) { return (nj + TILE - 1) / TILE; }

template <bool GUARD_ZERO, bool COMPUTE_POT>
cudaError_t launch(const float* pos_i, const float4* src, float4* out,
                   float4* partial, int ni, int nj, int n_split, float eps2,
                   cudaStream_t stream) {
  const int per_split = (tiles_of(nj) + n_split - 1) / n_split;
  const dim3 grid((ni + THREADS * R - 1) / (THREADS * R), n_split);
  allpairs_kernel<GUARD_ZERO, COMPUTE_POT><<<grid, THREADS, 0, stream>>>(
      pos_i, src, n_split > 1 ? partial : out, ni, nj, per_split, eps2);
  if (n_split > 1)
    allpairs_combine_kernel<<<(ni + 255) / 256, 256, 0, stream>>>(
        partial, out, ni, n_split);
  return cudaGetLastError();
}

}  // namespace

// The number S of source ranges for (ni, nj): the most that keeps the grid
// within one wave of resident blocks on the current device, at most one
// range a tile, and no range empty. Negative: a CUDA error.
extern "C" int pnb_allpairs_splits(int ni, int nj) {
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, allpairs_kernel<false, false>, THREADS, 0);
  if (err != cudaSuccess) return -(int)err;
  const int blocks = (ni + THREADS * R - 1) / (THREADS * R);
  const int tiles = tiles_of(nj);
  if (tiles <= 1 || blocks <= 0) return 1;
  const int s = std::max(1, std::min(tiles, sms * per_sm / blocks));
  const int per_split = (tiles + s - 1) / s;
  return std::max(1, (tiles + per_split - 1) / per_split);
}

// out (ni, 4); partial (n_split, ni, 4), unused when n_split is 1.
extern "C" int pnb_allpairs(const void* pos_i, const void* src, void* out,
                            void* partial, int ni, int nj, int n_split,
                            float eps2, int guard_zero, int compute_pot,
                            void* stream) {
  if (ni <= 0) return (int)cudaSuccess;
  auto pi = static_cast<const float*>(pos_i);
  auto s = static_cast<const float4*>(src);
  auto o = static_cast<float4*>(out);
  auto pa = static_cast<float4*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto fn) {
    return (int)fn(pi, s, o, pa, ni, nj, n_split, eps2, st);
  };
  if (guard_zero)
    return compute_pot ? go(launch<true, true>) : go(launch<true, false>);
  return compute_pot ? go(launch<false, true>) : go(launch<false, false>);
}
