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
//
// Self-gravity (targets are the sources: direct_kernels.allpairs_self).
// Newton's third law halves the rsqrts and cuts the FP32 instructions a
// pair from 12 to 8 (terms.cuh mutual_term): each unordered pair is
// evaluated once and added to both particles. The N particles are cut into
// nb tiles of SYM_TILE = 2048 (a block of 256 threads, 8 particles a
// thread in registers with their sums). Row I of tiles takes the diagonal
// (I, I), by the cross form's broadcast sweep (the self pair adds exactly 0
// force and m_i / eps to the potential), and the tiles J = I + k mod nb for
// k = 1 .. nb / 2, the middle offset of an even nb only in rows I < nb / 2:
// every unordered tile pair once, every row the same work. A row's items
// (the diagonal, then the offsets) are cut into `chunks` contiguous runs,
// one block each, so that the SMs' shares of tile pairs come out even
// (direct_kernels.sym_chunks).
// Inside a tile pair, tile J's particles and sums sit in shared memory;
// warp w owns J's sub-tile (w + p) mod 8 in phase p, with a __syncthreads
// between phases, and in step s lane l updates the 8 particles of J's group
// (l + s) mod 32, so no two threads add to one sum at once; a group is
// laid out as every 32nd particle, so a warp's 32 lanes read and write 32
// consecutive float4 (no bank conflicts). The j side costs an LDS, an LDS
// and an STS a particle for 8 pairs.
//
// Slots, no float atomics: block (I, b) writes its particles' own sums to
// slot b, and the j-side sums of tile J at offset k go to slot chunks + k -
// 1, each written once (rows I >= nb / 2 write the zeros of the even nb's
// middle slot); allpairs_combine_kernel adds the chunks + nb / 2 slots in
// slot order, so the output is bit-equal from run to run. Scratch is
// (chunks + nb / 2) N float4: 289 MB at N = 262144 on the H100 (chunks 5).
// The wrapper runs this form from N_SYM = 36864, from where it ran faster
// than the cross form at every N of the card's sweep (23.55 against 32.93
// ms at 262144), up to N_SYM_MAX = 524288 (1.10 GB of slots); above that
// the scratch grows as N^2 / 256 bytes and the cross form runs instead
// (direct_kernels.py; PERF.md §6 has both measurements).

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

// ------------------------------------------------------- self-gravity form
constexpr int SYM_THREADS = 256;
constexpr int A = 8;                           // particles a thread
constexpr int SYM_TILE = SYM_THREADS * A;      // 2048 particles a tile
constexpr int WARPS = SYM_THREADS / 32;
constexpr int SUB = SYM_TILE / WARPS;          // a warp's sub-tile: 32 x A
constexpr size_t SYM_SMEM = 2 * SYM_TILE * sizeof(float4);  // 64 KB

// Adds every pair of the block's particles t (masses m) with the tile in
// jp (shared: [x, y, z, m]) to both sides: t.s and the tile's sums js
// (shared), in the warp-rotation order of the header note.
template <bool GUARD_ZERO, bool COMPUTE_POT>
__device__ __forceinline__ void mutual_tile(const float4* jp, float4* js,
                                            float eps2, pnb::Targets<A>& t,
                                            const float (&m)[A]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int p = 0; p < WARPS; ++p) {
    const int sub = ((warp + p) % WARPS) * SUB;
    for (int s = 0; s < 32; ++s) {
      const int g = sub + ((lane + s) & 31);
#pragma unroll
      for (int q = 0; q < A; ++q) {
        const float4 pj = jp[g + 32 * q];
        float4 sj = js[g + 32 * q];
#pragma unroll
        for (int r = 0; r < A; ++r)
          pnb::mutual_term<GUARD_ZERO, COMPUTE_POT>(
              t.x[r], t.y[r], t.z[r], m[r], t.s[r], pj, eps2, sj);
        js[g + 32 * q] = sj;
      }
      __syncwarp();  // the group a lane takes next was its neighbour's
    }
    __syncthreads();  // the sub-tiles change hands
  }
}

// Block (I, b) of the self-gravity form: row I's items [first, last) of
// its half + 1 (the diagonal, then offsets 1 .. half), with the slots of
// the header note (slots: (chunks + half) x n float4).
template <bool GUARD_ZERO, bool COMPUTE_POT>
__global__ void __launch_bounds__(SYM_THREADS, 2)
    allpairs_kernel(const float* __restrict__ pos,
                    const float* __restrict__ mass,
                    float4* __restrict__ slots, int n, int chunks,
                    float eps2) {
  extern __shared__ float4 smem[];
  float4* jp = smem;             // tile J: [x, y, z, m], zero past n
  float4* js = smem + SYM_TILE;  // tile J's sums
  const int nb = (n + SYM_TILE - 1) / SYM_TILE;
  const int half = nb / 2;
  const int row = blockIdx.x;
  const int first = blockIdx.y * (half + 1) / chunks;
  const int last = (blockIdx.y + 1) * (half + 1) / chunks;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long base = (long long)row * SYM_TILE + threadIdx.x;
  pnb::Targets<A> t;
  float m[A];
#pragma unroll
  for (int r = 0; r < A; ++r) {
    const long long i = base + r * SYM_THREADS;
    const bool live = i < n;  // past n: massless at 0, inert
    t.x[r] = live ? pos[i * 3 + 0] : 0.f;
    t.y[r] = live ? pos[i * 3 + 1] : 0.f;
    t.z[r] = live ? pos[i * 3 + 2] : 0.f;
    m[r] = live ? mass[i] : 0.f;
    t.s[r] = zero;
  }
  for (int k = first; k < last; ++k) {
    const int col = (row + k) % nb;
    const int live = min(SYM_TILE, n - col * SYM_TILE);
    float4* dst = slots + (long long)(chunks + k - 1) * n +
                  (long long)col * SYM_TILE;
    if (k > 0 && 2 * k == nb && row >= half) {  // row - half's pair
      for (int q = threadIdx.x; q < live; q += SYM_THREADS) dst[q] = zero;
      continue;
    }
    for (int q = threadIdx.x; q < SYM_TILE; q += SYM_THREADS) {
      const long long j = (long long)col * SYM_TILE + q;
      jp[q] = q < live ? make_float4(pos[j * 3 + 0], pos[j * 3 + 1],
                                     pos[j * 3 + 2], mass[j])
                       : zero;
      js[q] = zero;
    }
    __syncthreads();
    if (k == 0)
      pnb::sweep<A, GUARD_ZERO, COMPUTE_POT>(jp, SYM_TILE, eps2, t);
    else
      mutual_tile<GUARD_ZERO, COMPUTE_POT>(jp, js, eps2, t, m);
    __syncthreads();  // jp is free for the next tile
    if (k > 0)  // each thread reads back the sums it zeroed
      for (int q = threadIdx.x; q < live; q += SYM_THREADS) dst[q] = js[q];
  }
  float4* own = slots + (long long)blockIdx.y * n;
#pragma unroll
  for (int r = 0; r < A; ++r) {
    const long long i = base + r * SYM_THREADS;
    if (i < n) own[i] = t.s[r];
  }
}

template <bool GUARD_ZERO, bool COMPUTE_POT>
cudaError_t launch_self(const float* pos, const float* mass, float4* out,
                        float4* slots, int n, int chunks, float eps2,
                        cudaStream_t stream) {
  void (*kernel)(const float*, const float*, float4*, int, int, float) =
      allpairs_kernel<GUARD_ZERO, COMPUTE_POT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SYM_SMEM);
  if (err != cudaSuccess) return err;
  const int nb = (n + SYM_TILE - 1) / SYM_TILE;
  const int n_slots = chunks + nb / 2;
  kernel<<<dim3(nb, chunks), SYM_THREADS, SYM_SMEM, stream>>>(
      pos, mass, n_slots > 1 ? slots : out, n, chunks, eps2);
  if (n_slots > 1)
    allpairs_combine_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
        slots, out, n, n_slots);
  return cudaGetLastError();
}

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
        &per_sm,
        static_cast<void (*)(const float*, const float4*, float4*, int, int,
                             int, float)>(allpairs_kernel<false, false>),
        THREADS, 0);
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

// Self-gravity: out (n, 4) of the n particles pos (n, 3), mass (n,)
// against each other; slots ((chunks + nb / 2), n, 4), unused when that is
// 1.
extern "C" int pnb_allpairs_self(const void* pos, const void* mass,
                                 void* out, void* slots, int n, int chunks,
                                 float eps2, int guard_zero, int compute_pot,
                                 void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  auto p = static_cast<const float*>(pos);
  auto m = static_cast<const float*>(mass);
  auto o = static_cast<float4*>(out);
  auto sl = static_cast<float4*>(slots);
  auto st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto fn) {
    return (int)fn(p, m, o, sl, n, chunks, eps2, st);
  };
  if (guard_zero)
    return compute_pot ? go(launch_self<true, true>)
                       : go(launch_self<true, false>);
  return compute_pot ? go(launch_self<false, true>)
                     : go(launch_self<false, false>);
}
