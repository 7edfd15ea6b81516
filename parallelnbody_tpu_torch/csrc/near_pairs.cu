// K1's mutual work items: the pairing of mirror near-list entries, on the card.
//
// Wrapper and plain PyTorch version: parallelnbody_tpu_torch/ops/bh_kernels.py
// (`near_pairs`, which runs these kernels on CUDA tensors and its torch ops
// on the CPU; the card tests hold the two to the same items, bit for bit).
//
// What it computes. The near lists idx/valid (L, B) cover every leaf, and a
// row's live entries are front-packed and ascending. A live entry (t, s) is
// mutual where s != t and t is live in row s: the copy with t < s is kept
// (KEEP: K1 evaluates it once for both leaves), its mirror (s, t) is dropped
// (DROP: s's sums arrive in a partial slot). Every other live entry, the
// self entry among them, is one-way (ONE). From the kinds follow, per row,
// the items (one-way, then mutual) and the partial slots that the combining
// pass of near_field.cu adds in order; near_pairs' docstring has the layout.
//
// Why kernels. Built with torch ops the pairing took ~200 device operations
// a list build, each ~10-20 us of host dispatch; on the per-step path the
// host leads the card, so that dispatch was the pairing's cost. Here it is
// three launches, one host read of the sizes (with the list build's clip
// counter, as before) and one stable sort of the items by length:
//   * near_pairs_count_kernel: one warp a row classifies its live entries
//     (a binary search of row s for t), keeps each KEEP entry's mirror
//     column and each DROP entry's rank among the row's drops, and counts
//     the row's kinds;
//   * near_pairs_scan_kernel: one block scans the rows' counts into each
//     row's first partial slot, first served entry, first item, first
//     mutual item and split rank, and writes the totals the host reads;
//   * near_pairs_emit_kernel: one warp a row writes its served sources,
//     each KEEP entry's slot (its mirror's: first slot of s + s's own items
//     + the drop's rank), its items in row order with their sort keys, and
//     its split row.
// Integers only: the items are the same on every run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr signed char kOne = 1, kKeep = 2, kDrop = 3;
constexpr int kScanThreads = 1024;
// Scanned per row: partial slots, served entries, one-way items, mutual
// items, split rows; summed only: live entries, mutual entries.
constexpr int kScanned = 5, kSummed = 7;

__global__ void __launch_bounds__(256)
near_pairs_count_kernel(const int* __restrict__ idx,
                        const bool* __restrict__ valid, int n_rows,
                        int budget, signed char* __restrict__ kind,
                        int* __restrict__ aux, int4* __restrict__ rowc) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= n_rows) return;
  const size_t row = (size_t)t * budget;
  int n_keep = 0, n_in = 0, count = 0;
  for (int j0 = 0; j0 < budget; j0 += 32) {
    const int j = j0 + lane;
    const bool live = j < budget && valid[row + j];
    signed char k = 0;
    int a = 0;
    if (live) {
      const int s = idx[row + j];
      k = kOne;
      if (s != t) {
        // The first live position of row s whose leaf is not below t.
        const size_t srow = (size_t)s * budget;
        int lo = 0, hi = budget;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (valid[srow + mid] && idx[srow + mid] < t) lo = mid + 1;
          else hi = mid;
        }
        if (lo < budget && valid[srow + lo] && idx[srow + lo] == t) {
          k = s > t ? kKeep : kDrop;
          a = lo;
        }
      }
    }
    const unsigned drops = __ballot_sync(kFull, k == kDrop);
    if (k == kDrop) a = n_in + __popc(drops & ((1u << lane) - 1u));
    if (live) {
      kind[row + j] = k;
      aux[row + j] = a;
    }
    n_in += __popc(drops);
    n_keep += __popc(__ballot_sync(kFull, k == kKeep));
    const unsigned lives = __ballot_sync(kFull, live);
    count += __popc(lives);
    if (lives != kFull) break;  // front-packed: the row ends here
  }
  if (lane == 0)
    rowc[t] = make_int4(count - n_keep - n_in, n_keep, n_in, count);
}

__device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// offs: two int4 a row, {first slot, first served, first item, first mutual
// item} and {split rank, own items, partial slots (0: none), one-way items}.
// sizes (int64): entries, one-way items, mutual items, partial slots, split
// rows, served entries, mutual entries, clip count.
__global__ void __launch_bounds__(kScanThreads)
near_pairs_scan_kernel(const int4* __restrict__ rowc, int n_rows, int chunk,
                       const int64_t* __restrict__ overflow,
                       int4* __restrict__ offs, int64_t* __restrict__ sizes) {
  __shared__ int warp_sums[kScanThreads / 32][kSummed];
  __shared__ int carry[kSummed];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < kSummed) carry[threadIdx.x] = 0;
  __syncthreads();
  for (int t0 = 0; t0 < n_rows; t0 += kScanThreads) {
    const int t = t0 + threadIdx.x;
    int v[kSummed] = {0, 0, 0, 0, 0, 0, 0};
    int own = 0, one_items = 0;
    if (t < n_rows) {
      const int4 c = rowc[t];  // one-way, kept, dropped, live
      one_items = max(1, ceil_div(c.x, chunk));
      own = one_items + ceil_div(c.y, chunk);
      const int block = own + c.z > 1 ? own + c.z : 0;
      v[0] = block;
      v[1] = c.x + c.y;
      v[2] = one_items;
      v[3] = own - one_items;
      v[4] = block > 0;
      v[5] = c.w;
      v[6] = c.y;
    }
    int incl[kSummed];
#pragma unroll
    for (int q = 0; q < kSummed; ++q) {
      int x = v[q];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += y;
      }
      incl[q] = x;
      if (lane == 31) warp_sums[warp][q] = x;
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int q = 0; q < kSummed; ++q) {
        int x = warp_sums[lane][q];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, x, d);
          if (lane >= d) x += y;
        }
        warp_sums[lane][q] = x;  // inclusive over the tile's warps
      }
    }
    __syncthreads();
    int ex[kScanned];
#pragma unroll
    for (int q = 0; q < kScanned; ++q)
      ex[q] = carry[q] + (warp > 0 ? warp_sums[warp - 1][q] : 0) + incl[q] -
              v[q];
    if (t < n_rows) {
      offs[2 * t] = make_int4(ex[0], ex[1], ex[2], ex[3]);
      offs[2 * t + 1] = make_int4(ex[4], own, v[0], one_items);
    }
    __syncthreads();
    if (threadIdx.x < kSummed)
      carry[threadIdx.x] += warp_sums[kScanThreads / 32 - 1][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sizes[0] = carry[5];
    sizes[1] = carry[2];
    sizes[2] = carry[3];
    sizes[3] = carry[0];
    sizes[4] = carry[4];
    sizes[5] = carry[1];
    sizes[6] = carry[6];
    sizes[7] = overflow != nullptr ? *overflow : 0;
  }
}

// items: (n_items + n_pairs, 4) [row, begin, end, dst], the one-way items
// then the mutual ones, each in row order; keys: the stable sort's keys,
// chunk - length for a one-way item and 2 chunk + 1 - length for a mutual
// one, so that each kind comes out longest first and the one-way items
// before the mutual ones.
__global__ void __launch_bounds__(256)
near_pairs_emit_kernel(const int* __restrict__ idx,
                       const signed char* __restrict__ kind,
                       const int* __restrict__ aux,
                       const int4* __restrict__ rowc,
                       const int4* __restrict__ offs, int n_rows, int budget,
                       int chunk, int n_items, int* __restrict__ srcs,
                       int* __restrict__ slot_of, int4* __restrict__ items,
                       int* __restrict__ keys, int* __restrict__ splits) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= n_rows) return;
  const int4 c = rowc[t];
  const int4 o0 = offs[2 * t], o1 = offs[2 * t + 1];
  const int first = o0.x, base = o0.y, one_items = o1.w;
  const int block = o1.z;
  const size_t row = (size_t)t * budget;
  const unsigned below = (1u << lane) - 1u;
  int ones = 0, keeps = 0;
  for (int j0 = 0; j0 < c.w; j0 += 32) {
    const int j = j0 + lane;
    const signed char k = j < c.w ? kind[row + j] : 0;
    const unsigned one = __ballot_sync(kFull, k == kOne);
    const unsigned keep = __ballot_sync(kFull, k == kKeep);
    if (k == kOne) {
      const int p = base + ones + __popc(one & below);
      srcs[p] = idx[row + j];
      slot_of[p] = -1;
    } else if (k == kKeep) {
      const int p = base + c.x + keeps + __popc(keep & below);
      const int s = idx[row + j];
      const int rank = aux[(size_t)s * budget + aux[row + j]];
      srcs[p] = s;
      slot_of[p] = offs[2 * s].x + offs[2 * s + 1].y + rank;
    }
    ones += __popc(one);
    keeps += __popc(keep);
  }
  for (int q = lane; q < one_items; q += 32) {
    const int b = q * chunk, e = min(b + chunk, c.x);
    items[o0.z + q] = make_int4(t, base + b, base + e,
                                block > 0 ? first + q : -1);
    keys[o0.z + q] = chunk - (e - b);
  }
  const int pair_items = o1.y - one_items;
  for (int q = lane; q < pair_items; q += 32) {
    const int b = q * chunk, e = min(b + chunk, c.y);
    const int at = n_items + o0.w + q;
    items[at] = make_int4(t, base + c.x + b, base + c.x + e,
                          first + one_items + q);
    keys[at] = 2 * chunk + 1 - (e - b);
  }
  if (block > 0 && lane == 0) {
    splits[3 * o1.x] = t;
    splits[3 * o1.x + 1] = first;
    splits[3 * o1.x + 2] = block;
  }
}

}  // namespace

// Counts, then scans: sizes (8 int64) ready for one host read. overflow: a
// device int64 copied into sizes[7], or null (0).
extern "C" int pnb_near_pairs_count(const void* idx, const void* valid,
                                    void* kind, void* aux, void* rowc,
                                    void* offs, void* sizes,
                                    const void* overflow, int n_rows,
                                    int budget, int chunk, void* stream) {
  if (n_rows <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = (int)(((int64_t)n_rows * 32 + 255) / 256);
  near_pairs_count_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const int*>(idx), static_cast<const bool*>(valid), n_rows,
      budget, static_cast<signed char*>(kind), static_cast<int*>(aux),
      static_cast<int4*>(rowc));
  near_pairs_scan_kernel<<<1, kScanThreads, 0, st>>>(
      static_cast<const int4*>(rowc), n_rows, chunk,
      static_cast<const int64_t*>(overflow), static_cast<int4*>(offs),
      static_cast<int64_t*>(sizes));
  return (int)cudaGetLastError();
}

extern "C" int pnb_near_pairs_emit(const void* idx, const void* kind,
                                   const void* aux, const void* rowc,
                                   const void* offs, void* srcs,
                                   void* slot_of, void* items, void* keys,
                                   void* splits, int n_rows, int budget,
                                   int chunk, int n_items, void* stream) {
  if (n_rows <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = (int)(((int64_t)n_rows * 32 + 255) / 256);
  near_pairs_emit_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const int*>(idx), static_cast<const signed char*>(kind),
      static_cast<const int*>(aux), static_cast<const int4*>(rowc),
      static_cast<const int4*>(offs), n_rows, budget, chunk, n_items,
      static_cast<int*>(srcs), static_cast<int*>(slot_of),
      static_cast<int4*>(items), static_cast<int*>(keys),
      static_cast<int*>(splits));
  return (int)cudaGetLastError();
}
