// Ungrouped, grouped and fused bind-join filters (the brTPF server's hot
// spot).
//
// Replace the TPU kernels repro/kernels/bindjoin.py:
//   bindjoin_pallas         (body _bindjoin_kernel)
//   bindjoin_grouped_pallas (body _bindjoin_grouped_kernel)
//   bindjoin_fused_pallas   (body _bindjoin_fused_kernel)
//
// The grouped and fused kernels compute, for every candidate row and
// request group g:
//   keep[row, g]   -- the row matches at least one valid slot of group g
//   idx[row, g]    -- the smallest matching slot, or Mp when none
//   nmatch[row, g] -- how many valid slots of group g the row matches
// A slot component < 0 is a wildcard; a slot with valid == 0 is padding.
// Outputs are int32 [T, G], row-major: the reference layout.
//
// The ungrouped kernel (the sharded backend's full-shard stream) is the
// same filter over one slot set of M (padded) slots, and writes only
// keep[T] and idx[T], with idx == M when no slot matches; it computes no
// count. Its grid is ceil(T / 256) blocks: at a full shard stream
// (T ~ 9.25M rows) that is about 36k blocks, enough to fill the card.
//
// Design: grid (ceil(T / 256), G), 256 threads, one thread per row. The
// block stages its group's slots through shared memory kSlotTile at a
// time, packed as int4 (s, p, o, valid), so each slot costs every
// thread one broadcast 16-byte shared load. Each thread keeps any / min
// idx / count in registers across the slot tiles: this loop replaces
// the TPU kernel's revisited-output accumulation over its m grid axis.
//
// The fused kernel reads its tile's segment id from seg_of_tile itself
// (no scalar prefetch on this card) and stages only that segment's
// group-g slots, seg * G * Mp + g * Mp ..., tile by tile: the whole
// table (up to 32768 slots x 16 bytes = 512 KiB) is more than one
// block's 227 KB of shared memory and is never staged whole. A dead
// tile (segment -1) writes keep 0, idx Mp, nmatch 0 and reads no slot.
//
// Bound on an H100: integer operations. Every (row, slot) cell costs a
// few compares and selects while its bytes are read once per block from
// shared memory, so at the main path's shapes (Mp >= 128) the compare
// grid outweighs the candidate and output bytes by two orders of
// magnitude. The design keeps the inner loop free of global memory and
// of divergence (all threads read the same slot), and puts G on the
// grid so that a small T still fills the 132 SMs.
//
// Plain C interface, loaded with ctypes: every entry returns
// cudaGetLastError() so that a refused launch is reported at once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // rows per block == fused segment tile
constexpr int kSlotTile = 256;  // slots staged per shared-memory tile

// Match one row (a, b, c) against slots [0, mp) of one group. With
// kCount false the count is not kept (the ungrouped kernel needs none).
template <bool kCount>
__device__ __forceinline__ void match_group(
    int a, int b, int c, const int* __restrict__ ps,
    const int* __restrict__ pp, const int* __restrict__ po,
    const int* __restrict__ pv, int mp, int4* tile, int* first_out,
    int* count_out) {
  int first = mp;
  int count = 0;
  for (int base = 0; base < mp; base += kSlotTile) {
    const int n = min(kSlotTile, mp - base);
    for (int k = threadIdx.x; k < n; k += kThreads) {
      tile[k] = make_int4(ps[base + k], pp[base + k], po[base + k],
                          pv[base + k]);
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const int4 q = tile[k];
      const bool m = q.w != 0 && (q.x < 0 || q.x == a)
                     && (q.y < 0 || q.y == b) && (q.z < 0 || q.z == c);
      if (kCount) count += m ? 1 : 0;
      first = min(first, m ? base + k : mp);
    }
    __syncthreads();
  }
  *first_out = first;
  *count_out = count;
}

__global__ void bindjoin_kernel(
    const int* __restrict__ cs, const int* __restrict__ cp,
    const int* __restrict__ co, const int* __restrict__ ps,
    const int* __restrict__ pp, const int* __restrict__ po,
    const int* __restrict__ pv, int* __restrict__ keep,
    int* __restrict__ idx, long long t, int mp) {
  __shared__ int4 tile[kSlotTile];
  const long long row = static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x;
  const bool live = row < t;
  // Rows past the end still take part in the block's barriers.
  int a = 0, b = 0, c = 0;
  if (live) {
    a = cs[row];
    b = cp[row];
    c = co[row];
  }
  int first, count;
  match_group<false>(a, b, c, ps, pp, po, pv, mp, tile, &first, &count);
  if (live) {
    keep[row] = first < mp ? 1 : 0;
    idx[row] = first;
  }
}

__global__ void bindjoin_grouped_kernel(
    const int* __restrict__ cs, const int* __restrict__ cp,
    const int* __restrict__ co, const int* __restrict__ ps,
    const int* __restrict__ pp, const int* __restrict__ po,
    const int* __restrict__ pv, int* __restrict__ keep,
    int* __restrict__ idx, int* __restrict__ nmatch, long long t,
    int groups, int mp) {
  __shared__ int4 tile[kSlotTile];
  const int g = blockIdx.y;
  const long long row = static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x;
  const bool live = row < t;
  // Rows past the end still take part in the block's barriers.
  int a = 0, b = 0, c = 0;
  if (live) {
    a = cs[row];
    b = cp[row];
    c = co[row];
  }
  const long long off = static_cast<long long>(g) * mp;
  int first, count;
  match_group<true>(a, b, c, ps + off, pp + off, po + off, pv + off, mp,
                    tile, &first, &count);
  if (live) {
    const long long out = row * groups + g;
    keep[out] = count > 0 ? 1 : 0;
    idx[out] = first;
    nmatch[out] = count;
  }
}

__global__ void bindjoin_fused_kernel(
    const int* __restrict__ seg_of_tile, const int* __restrict__ cs,
    const int* __restrict__ cp, const int* __restrict__ co,
    const int* __restrict__ ps, const int* __restrict__ pp,
    const int* __restrict__ po, const int* __restrict__ pv,
    int* __restrict__ keep, int* __restrict__ idx,
    int* __restrict__ nmatch, long long t, int groups, int mp) {
  __shared__ int4 tile[kSlotTile];
  const int g = blockIdx.y;
  const long long row = static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x;
  const bool live = row < t;
  const int seg = seg_of_tile[blockIdx.x];  // uniform across the block
  int first = mp, count = 0;
  if (seg >= 0) {
    int a = 0, b = 0, c = 0;
    if (live) {
      a = cs[row];
      b = cp[row];
      c = co[row];
    }
    const long long off = (static_cast<long long>(seg) * groups + g) * mp;
    match_group<true>(a, b, c, ps + off, pp + off, po + off, pv + off, mp,
                      tile, &first, &count);
  }
  if (live) {
    const long long out = row * groups + g;
    keep[out] = count > 0 ? 1 : 0;
    idx[out] = first;
    nmatch[out] = count;
  }
}

}  // namespace

extern "C" int brtpf_bindjoin(
    const void* cs, const void* cp, const void* co, const void* ps,
    const void* pp, const void* po, const void* pv, void* keep, void* idx,
    long long t, int mp, void* stream) {
  if (t <= 0) return 0;
  const dim3 grid(static_cast<unsigned int>((t + kThreads - 1) / kThreads));
  bindjoin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cs), static_cast<const int*>(cp),
      static_cast<const int*>(co), static_cast<const int*>(ps),
      static_cast<const int*>(pp), static_cast<const int*>(po),
      static_cast<const int*>(pv), static_cast<int*>(keep),
      static_cast<int*>(idx), t, mp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brtpf_bindjoin_grouped(
    const void* cs, const void* cp, const void* co, const void* ps,
    const void* pp, const void* po, const void* pv, void* keep, void* idx,
    void* nmatch, long long t, int groups, int mp, void* stream) {
  if (t <= 0 || groups <= 0) return 0;
  const dim3 grid(static_cast<unsigned int>((t + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(groups));
  bindjoin_grouped_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cs), static_cast<const int*>(cp),
      static_cast<const int*>(co), static_cast<const int*>(ps),
      static_cast<const int*>(pp), static_cast<const int*>(po),
      static_cast<const int*>(pv), static_cast<int*>(keep),
      static_cast<int*>(idx), static_cast<int*>(nmatch), t, groups, mp);
  return static_cast<int>(cudaGetLastError());
}

// t must be a multiple of 256: seg_of_tile holds one id per 256 rows.
extern "C" int brtpf_bindjoin_fused(
    const void* seg_of_tile, const void* cs, const void* cp, const void* co,
    const void* ps, const void* pp, const void* po, const void* pv,
    void* keep, void* idx, void* nmatch, long long t, int groups, int mp,
    void* stream) {
  if (t <= 0 || groups <= 0) return 0;
  const dim3 grid(static_cast<unsigned int>(t / kThreads),
                  static_cast<unsigned int>(groups));
  bindjoin_fused_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg_of_tile), static_cast<const int*>(cs),
      static_cast<const int*>(cp), static_cast<const int*>(co),
      static_cast<const int*>(ps), static_cast<const int*>(pp),
      static_cast<const int*>(po), static_cast<const int*>(pv),
      static_cast<int*>(keep), static_cast<int*>(idx),
      static_cast<int*>(nmatch), t, groups, mp);
  return static_cast<int>(cudaGetLastError());
}
