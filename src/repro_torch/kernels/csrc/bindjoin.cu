// Ungrouped, grouped and fused bind-join filters (the brTPF server's hot
// spot).
//
// Replace the TPU kernels repro/kernels/bindjoin.py:
//   bindjoin_pallas         (body _bindjoin_kernel)
//   bindjoin_grouped_pallas (body _bindjoin_grouped_kernel), together
//                           with the tpf_match base mask of every
//                           grouped step (repro/kernels/tpf_match.py)
//   bindjoin_fused_pallas   (body _bindjoin_fused_kernel)
//
// A slot component < 0 is a wildcard; a slot with valid == 0 is padding.
// "No match" is the padded slot count Mp (M for the ungrouped kernel),
// the reference's value.
//
// The grouped kernel serves one request's window pages in one launch.
// Its rows stay where they lie: the store's own AoS int32 [S, N, 3]
// triples and valid [S, N] (a kernel-backend block is S = 1). It takes a
// chunk of P pages: per (page, shard) either an owned span [lo, hi) of
// positions (int64), or an explicit row list int32 [P, S, W] with -1
// padding (the sharded backend's compact pages). For each row it runs a
// fused prologue -- position in its span and below N, valid set, and
// the base pattern vector [s, p, o, eq_sp, eq_so, eq_po, 0, 0] (the
// tpf_match test, repeated-variable flags included) -- and only rows
// that pass enter the slot loop, which runs over each group's live
// slots: up to the group's last slot with valid != 0, read from the
// table (a hole below it stays in the loop). Outputs per (page, shard,
// group): mask uint8 [P, S, G, W] (so a compaction sorts along the last
// axis with no transpose), first int32 (written where the mask is set,
// or for every row when nmatch is asked for), and the Definition-2 cnt
// int64 [P, S, G], reduced in the kernel -- a warp sum, a shared-memory
// atomic per warp, one global atomic per group and (page, shard) a block
// covers -- exact in any order, since the sums are integers. With a wildcard base vector,
// every row in span and nmatch asked for, it is the reference op's
// grouped bind-join (keep / idx / nmatch per row and group).
//
// Design of the grouped kernel for the H100:
// * the live slots of all G groups (with the G cnt sums, at most 48 KiB:
//   G x live x 16 bytes, a few KiB at G x 30) are staged once per block
//   in shared memory as int4, so each slot costs every thread one
//   broadcast 16-byte load and the inner loop touches no global memory;
//   a table larger than that is staged a group range at a time;
// * the span test and the base test are computed once per row and shared
//   by all G groups: G is the thread's loop, not a grid axis;
// * the grid is persistent: min(items, SMs x resident blocks per SM)
//   blocks of 256 threads, each over a contiguous run of the chunk's
//   (page, shard, 256-row tile) items, so a chunk of many pages fills
//   all 132 SMs whatever one window gives (a 4 x 1024-row window is only
//   16 tiles), and a block keeps a (page, shard)'s cnt sums in shared
//   memory until its run leaves it: a million-row block of one page
//   makes a few global atomics per block, not one per warp on a single
//   address;
// * a row is three 4-byte loads of its 12-byte AoS record: a warp's
//   loads cover 384 contiguous bytes, so each 128-byte line is fetched
//   once and served from L1 to the other two loads (span mode);
// * tensor cores do not apply: the work is equality tests on 21-bit term
//   ids and has no product form.
// Bound on an H100: the larger of bytes (13 per row read: the triple and
// its valid flag; per (row, group) 1 mask byte, plus 4 for first where
// kept) over 3.35 TB/s, and integer operations -- 7 per (row, live slot)
// cell of the rows that pass the prologue, plus 6 per row for the base
// test -- over the card's INT32 rate. At one live slot a row is bound by
// its bytes; at maxMpR = 30 live slots by its operations.
//
// The ungrouped kernel (the sharded backend's full-shard stream) and the
// fused kernel keep the first design: grid (ceil(T / 256)[, G]), 256
// threads, one thread per row, the block staging its group's slots
// through shared memory kSlotTile at a time as int4 and each thread
// keeping any / min idx / count in registers across the tiles (this loop
// replaces the TPU kernels' revisited-output accumulation over their m
// grid axis). Their inputs are structure-of-arrays int32 [T] columns and
// their outputs int32, row-major [T(, G)]. The ungrouped kernel writes
// only keep[T] and idx[T] against one slot set of M (padded) slots; at a
// full shard stream (T ~ 9.25M rows) its grid is about 36k blocks. The
// fused kernel reads its tile's segment id from seg_of_tile itself (no
// scalar prefetch on this card) and stages only that segment's group-g
// slots, seg * G * Mp + g * Mp ..., tile by tile: the whole table (up to
// 32768 slots x 16 bytes = 512 KiB) is more than one block's 227 KB of
// shared memory and is never staged whole. A dead tile (segment -1)
// writes keep 0, idx Mp, nmatch 0 and reads no slot. Both are bound by
// integer operations: at Mp >= 128 the compare grid outweighs the
// candidate and output bytes by two orders of magnitude.
//
// Plain C interface, loaded with ctypes: every entry returns
// cudaGetLastError() so that a refused launch is reported at once.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;   // rows per block == fused segment tile
constexpr int kSlotTile = 256;  // slots staged per shared-memory tile
// Dynamic shared memory of the grouped kernel's slot table: under the
// 48 KiB a launch may take without opting in, and 4 such blocks fit one
// SM's 228 KiB.
constexpr int kStageBytes = 48 * 1024;

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

// Arguments of the windowed grouped kernel (see the note at the top).
struct GroupedArgs {
  const int* triples;           // int32 [S, N, 3], the store's own rows
  const unsigned char* valid;   // uint8 [S, N], or null: every row valid
  const long long* spans;       // int64 [P, S, 2] owned [lo, hi), or null
  const int* rows;              // int32 [P, S, W] positions, -1 = none
  const int4* slots;            // [G, Mp] (s, p, o, valid)
  const int* base;              // int32 [8] base pattern vector
  unsigned char* mask;          // uint8 [P, S, G, W]
  int* first;                   // int32 [P, S, G, W]
  unsigned long long* cnt;      // int64 [P, S, G], zeroed by the caller
  int* nmatch;                  // int32 [P, S, G, W], or null
  long long n;                  // rows per shard
  long long items;              // P * S * ceil(W / kThreads)
  int s, w, g, mp;
  int live;                     // slots staged per group
  int g_stage;                  // groups staged in shared memory at once
};

// Stage slots [0, live) of groups [g0, g0 + g_stage) as int4, then each
// group's live bound: one past its last slot with valid != 0 (a hole
// below it stays in the loop and matches nothing).
__device__ void stage_groups(const GroupedArgs& a, int g0, int4* tab,
                             int* bound) {
  const int ng = min(a.g_stage, a.g - g0);
  for (int i = threadIdx.x; i < ng * a.live; i += kThreads) {
    tab[i] = a.slots[static_cast<long long>(g0 + i / a.live) * a.mp
                     + i % a.live];
  }
  __syncthreads();
  for (int gl = threadIdx.x; gl < ng; gl += kThreads) {
    int b = a.live;
    while (b > 0 && tab[gl * a.live + b - 1].w == 0) --b;
    bound[gl] = b;
  }
  __syncthreads();
}

// Add the block's per-group cnt sums for (page, shard) ps to the output
// and clear them. Called by the whole block.
__device__ void flush_cnt(const GroupedArgs& a, long long ps,
                          unsigned long long* acc) {
  __syncthreads();
  for (int g = threadIdx.x; g < a.g; g += kThreads) {
    if (acc[g] != 0) {
      atomicAdd(a.cnt + ps * a.g + g, acc[g]);
      acc[g] = 0;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
bindjoin_grouped_kernel(const GroupedArgs a) {
  // Shared memory: the block's cnt sums [G], then the staged slots
  // [g_stage][live] and their live bounds [g_stage].
  extern __shared__ int4 smem[];
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(smem);
  int4* tab = smem + (a.g + 1) / 2;
  int* bound = reinterpret_cast<int*>(tab + a.g_stage * a.live);
  for (int g = threadIdx.x; g < a.g; g += kThreads) acc[g] = 0;
  const bool resident = a.g_stage >= a.g;
  if (resident) {
    stage_groups(a, 0, tab, bound);
  } else {
    __syncthreads();
  }
  const int bs = __ldg(a.base + 0), bp = __ldg(a.base + 1),
            bo = __ldg(a.base + 2), eq_sp = __ldg(a.base + 3),
            eq_so = __ldg(a.base + 4), eq_po = __ldg(a.base + 5);
  const int tiles = (a.w + kThreads - 1) / kThreads;
  const int lane = threadIdx.x & 31;
  // Persistent blocks, each over a contiguous run of (page, shard,
  // 256-row tile) items, so that consecutive items mostly share their
  // (page, shard) and its cnt sums stay in shared memory until it
  // changes. The run is uniform across the block: every thread reaches
  // every barrier and every warp shuffle.
  const long long per_block = (a.items + gridDim.x - 1) / gridDim.x;
  const long long begin = blockIdx.x * per_block;
  const long long end = begin + per_block < a.items ? begin + per_block
                                                    : a.items;
  long long ps = begin / tiles;                // page * S + shard
  int tile = static_cast<int>(begin - ps * tiles);
  long long sh = ps % a.s;
  long long held = -1;                         // ps whose sums acc holds
  for (long long item = begin; item < end; ++item) {
    if (ps != held) {
      if (held >= 0) flush_cnt(a, held, acc);
      held = ps;
    }
    const int r = tile * kThreads + threadIdx.x;
    // Prologue, once per row for all G groups: in span (or listed),
    // valid, and matching the base pattern (tpf_match's test).
    bool ok = false;
    int x = 0, y = 0, z = 0;
    if (r < a.w) {
      long long pos;
      bool in;
      if (a.rows != nullptr) {
        pos = a.rows[ps * a.w + r];
        in = pos >= 0;
      } else {
        pos = a.spans[2 * ps] + r;
        in = pos >= 0 && pos < a.spans[2 * ps + 1];
      }
      if (in && pos < a.n) {
        const long long at = sh * a.n + pos;
        const int* t = a.triples + 3 * at;
        x = t[0];
        y = t[1];
        z = t[2];
        ok = (a.valid == nullptr || a.valid[at] != 0)
             && (bs < 0 || x == bs) && (bp < 0 || y == bp)
             && (bo < 0 || z == bo) && (eq_sp == 0 || x == y)
             && (eq_so == 0 || x == z) && (eq_po == 0 || y == z);
      }
    }
    for (int g0 = 0; g0 < a.g; g0 += a.g_stage) {
      if (!resident) {
        __syncthreads();
        stage_groups(a, g0, tab, bound);
      }
      const int ng = min(a.g_stage, a.g - g0);
      for (int gl = 0; gl < ng; ++gl) {
        int first = a.mp, count = 0;
        if (ok) {
          const int4* q = tab + gl * a.live;
          const int nb = bound[gl];
          for (int k = 0; k < nb; ++k) {
            const int4 c = q[k];
            const bool m = c.w != 0 && (c.x < 0 || c.x == x)
                           && (c.y < 0 || c.y == y) && (c.z < 0 || c.z == z);
            count += m ? 1 : 0;
            first = (m && first == a.mp) ? k : first;
          }
        }
        if (r < a.w) {
          const long long out = (ps * a.g + g0 + gl) * a.w + r;
          a.mask[out] = count > 0 ? 1 : 0;
          if (a.nmatch != nullptr) {
            a.first[out] = first;
            a.nmatch[out] = count;
          } else if (count > 0) {
            a.first[out] = first;
          }
        }
        // Definition-2 cnt: a warp sum, a shared-memory atomic per warp,
        // and one global atomic per group when the block leaves this
        // (page, shard): integer sums, exact in any order.
        int sum = count;
        for (int off = 16; off > 0; off >>= 1) {
          sum += __shfl_down_sync(0xffffffffu, sum, off);
        }
        if (lane == 0 && sum != 0) {
          atomicAdd(acc + g0 + gl, static_cast<unsigned long long>(sum));
        }
      }
    }
    if (++tile == tiles) {
      tile = 0;
      ++ps;
      if (++sh == a.s) sh = 0;
    }
  }
  if (held >= 0) flush_cnt(a, held, acc);
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
    const void* triples, const void* valid, const void* spans,
    const void* rows, const void* slots, const void* base_vec, void* mask,
    void* first, void* cnt, void* nmatch, long long n, int p, int s, int w,
    int g, int mp, int live, void* stream) {
  if (p <= 0 || s <= 0 || w <= 0 || g <= 0) return 0;
  if (live < 0 || live > mp || (spans == nullptr) == (rows == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the cnt sums take G x 8 bytes (rounded to int4s), the slots the rest
  const long long acc_bytes = (static_cast<long long>(g) + 1) / 2 * 16;
  const long long g_stage = std::min<long long>(
      g, (kStageBytes - acc_bytes) / (live * 16 + 4));
  if (g_stage < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(acc_bytes)
                      + static_cast<size_t>(g_stage) * live * sizeof(int4)
                      + static_cast<size_t>(g_stage) * sizeof(int);
  GroupedArgs a;
  a.triples = static_cast<const int*>(triples);
  a.valid = static_cast<const unsigned char*>(valid);
  a.spans = static_cast<const long long*>(spans);
  a.rows = static_cast<const int*>(rows);
  a.slots = static_cast<const int4*>(slots);
  a.base = static_cast<const int*>(base_vec);
  a.mask = static_cast<unsigned char*>(mask);
  a.first = static_cast<int*>(first);
  a.cnt = static_cast<unsigned long long*>(cnt);
  a.nmatch = static_cast<int*>(nmatch);
  a.n = n;
  a.items = static_cast<long long>(p) * s * ((w + kThreads - 1) / kThreads);
  a.s = s;
  a.w = w;
  a.g = g;
  a.mp = mp;
  a.live = live;
  a.g_stage = static_cast<int>(g_stage);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bindjoin_grouped_kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident_blocks =
      static_cast<long long>(std::max(sms, 1)) * std::max(per_sm, 1);
  const unsigned int blocks =
      static_cast<unsigned int>(std::min(a.items, resident_blocks));
  bindjoin_grouped_kernel<<<blocks, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
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
