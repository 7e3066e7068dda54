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
// The grouped and the fused kernel are one windowed kernel body. The
// grouped kernel serves a chunk of one request's window pages in one
// launch; the fused kernel serves a chunk of the pages of several
// requests of different patterns (segments) in one launch, each page
// matched against its own segment's slot table and base vector. Rows
// stay where they lie: the store's own AoS int32 [S, N, 3] triples and
// valid [S, N] (a kernel-backend block is S = 1). A launch takes a chunk
// of P pages: per (page, shard) either an owned span [lo, hi) of
// positions (int64), or, grouped only, an explicit row list int32
// [P, S, W] with -1 padding (the sharded backend's compact pages). The
// fused kernel also takes seg_of_page int32 [P] (-1 = a dead page,
// which keeps nothing), the segments' slot tables [Sseg, G, Mp] and base
// vectors [Sseg, 8]. For each row it runs a prologue -- position in its
// span and below N, valid set, and the page's base pattern vector
// [s, p, o, eq_sp, eq_so, eq_po, 0, 0] (the tpf_match test, repeated-
// variable flags included) -- and only rows that pass enter the slot
// loop, which runs over each group's live slots: up to the group's last
// slot with valid != 0, read from the table (a hole below it stays in
// the loop). Outputs per (page, shard, group): mask uint8 [P, S, G, W]
// (so a compaction sorts along the last axis with no transpose), first
// int32 (written where the mask is set, or for every row when nmatch is
// asked for), and the Definition-2 cnt int64 [P, S, G], reduced in the
// kernel -- a warp sum, a shared-memory atomic per warp, one global
// atomic per group and (page, shard) a block covers -- exact in any
// order, since the sums are integers. With a wildcard base vector, every
// row in span and nmatch asked for, the grouped kernel is the reference
// op's grouped bind-join and the fused kernel, one 256-row page per
// candidate tile, the reference op's fused bind-join (keep / idx /
// nmatch per row and group).
//
// Design for the H100:
// * the live slots of all G groups of a segment (with the G cnt sums, at
//   most 48 KiB: G x live x 16 bytes, a few KiB at G x 30) are staged in
//   shared memory as int4, so each slot costs every thread one broadcast
//   16-byte load and the inner loop touches no global memory. A block
//   restages only when its run of items crosses into a page of another
//   segment (the test is uniform across the block, so the barriers stay
//   safe). A table larger than the budget is staged a group range at a
//   time, and a single group wider than it a slot range at a time, for
//   every item (at the MAX_FUSED_SLOTS ceiling one segment's table can
//   reach 256 KiB);
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
// * both kernels are held to 48 registers, five blocks an SM: a thread
//   has one row in flight at a time, so the loads an SM keeps in flight
//   (its resident threads) bound the shapes with one live slot; the
//   grouped kernel's one segment is set up before its run, so that its
//   item loop keeps its own shape inside the shared body;
// * tensor cores do not apply: the work is equality tests on 21-bit term
//   ids and has no product form.
// Bound on an H100, for each page against its own segment's table: the
// larger of bytes (13 per row read: the triple and its valid flag; per
// (row, group) 1 mask byte, plus 4 for first where kept) over 3.35 TB/s,
// and integer operations -- 7 per (row, live slot) cell of the rows that
// pass the prologue, plus 6 per row for the base test -- over the card's
// INT32 rate. At one live slot a row is bound by its bytes; at maxMpR =
// 30 live slots by its operations.
//
// The ungrouped kernel (the sharded backend's full-shard stream) keeps
// the first design: grid ceil(T / 256), 256 threads, one thread per row,
// the block staging the slots through shared memory kSlotTile at a time
// as int4 and each thread keeping any / min idx in registers across the
// tiles (this loop replaces the TPU kernel's revisited-output
// accumulation over its m grid axis). Its inputs are structure-of-arrays
// int32 [T] columns, and it writes only keep[T] and idx[T] against one
// slot set of M (padded) slots; at a full shard stream (T ~ 9.25M rows)
// its grid is about 36k blocks. It is bound by integer operations: at
// M >= 128 the compare grid outweighs the candidate and output bytes by
// two orders of magnitude.
//
// Plain C interface, loaded with ctypes: every entry returns
// cudaGetLastError() so that a refused launch is reported at once.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;   // rows per block == fused segment tile
constexpr int kSlotTile = 256;  // slots staged per shared-memory tile
// Dynamic shared memory of the windowed kernels' slot table: under the
// 48 KiB a launch may take without opting in, and 4 such blocks fit one
// SM's 228 KiB.
constexpr int kStageBytes = 48 * 1024;

// The first of slots [0, mp) that row (a, b, c) matches, or mp: the
// ungrouped kernel's slot loop, a tile of slots at a time through shared
// memory. Called by the whole block.
__device__ __forceinline__ int match_group(
    int a, int b, int c, const int* __restrict__ ps,
    const int* __restrict__ pp, const int* __restrict__ po,
    const int* __restrict__ pv, int mp, int4* tile) {
  int first = mp;
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
      first = min(first, m ? base + k : mp);
    }
    __syncthreads();
  }
  return first;
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
  const int first = match_group(a, b, c, ps, pp, po, pv, mp, tile);
  if (live) {
    keep[row] = first < mp ? 1 : 0;
    idx[row] = first;
  }
}

// Arguments of the windowed kernels (see the note at the top).
struct WindowArgs {
  const int* triples;           // int32 [S, N, 3], the store's own rows
  const unsigned char* valid;   // uint8 [S, N], or null: every row valid
  const long long* spans;       // int64 [P, S, 2] owned [lo, hi), or null
  const int* rows;              // int32 [P, S, W] positions, -1 = none
  const int* seg_of_page;       // int32 [P] (fused kernel only)
  const int4* slots;            // [Sseg, G, Mp] (s, p, o, valid)
  const int* base;              // int32 [Sseg, 8] base pattern vectors
  unsigned char* mask;          // uint8 [P, S, G, W]
  int* first;                   // int32 [P, S, G, W]
  unsigned long long* cnt;      // int64 [P, S, G], zeroed by the caller
  int* nmatch;                  // int32 [P, S, G, W], or null
  long long n;                  // rows per shard
  long long items;              // P * S * ceil(W / kThreads)
  int s, w, g, mp;
  int segs;                     // Sseg: a page's id outside [0, Sseg) is dead
  int live;                     // slots per group that may be valid
  int g_stage;                  // groups staged in shared memory at once
  int k_stage;                  // slots per group staged at once (<= live
                                // only when one group exceeds the budget;
                                // then g_stage is 1)
};

// Stage slots [k0, k0 + nk) of groups [g0, g0 + ng) of one segment's
// table as int4, then per group the staged slice's live bound: one past
// its last slot with valid != 0 (a hole below it stays in the loop and
// matches nothing). Called by the whole block.
__device__ __forceinline__ void stage_slots(const WindowArgs& a,
                                            const int4* table, int g0,
                                            int ng, int k0, int nk,
                                            int4* tab, int* bound) {
  for (int i = threadIdx.x; i < ng * nk; i += kThreads) {
    tab[i] = table[static_cast<long long>(g0 + i / nk) * a.mp + k0 + i % nk];
  }
  __syncthreads();
  for (int gl = threadIdx.x; gl < ng; gl += kThreads) {
    int b = nk;
    while (b > 0 && tab[gl * nk + b - 1].w == 0) --b;
    bound[gl] = b;
  }
  __syncthreads();
}

// Match row (x, y, z) against the staged slots q[k0, kb) of one group,
// numbered k0... in the group: count the matches and keep the first.
__device__ __forceinline__ void match_slots(const int4* q, int k0, int kb,
                                            int x, int y, int z, int none,
                                            int& first, int& count) {
  for (int k = k0; k < kb; ++k) {
    const int4 v = q[k];
    const bool m = v.w != 0 && (v.x < 0 || v.x == x)
                   && (v.y < 0 || v.y == y) && (v.z < 0 || v.z == z);
    count += m ? 1 : 0;
    first = (m && first == none) ? k : first;
  }
}

// Add the block's per-group cnt sums for (page, shard) ps to the output
// and clear them. Called by the whole block.
__device__ __forceinline__ void flush_cnt(const WindowArgs& a, long long ps,
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

// The body of both windowed kernels. kFused reads each page's segment
// from seg_of_page (its slot table and base vector); the grouped kernel
// has one segment.
template <bool kFused>
__device__ __forceinline__ void windowed_body(const WindowArgs& a) {
  // Shared memory: the block's cnt sums [G], then the staged slots
  // [g_stage][k_stage] and their live bounds [g_stage].
  extern __shared__ int4 smem[];
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(smem);
  int4* tab = smem + (a.g + 1) / 2;
  int* bound = reinterpret_cast<int*>(tab + a.g_stage * a.k_stage);
  for (int g = threadIdx.x; g < a.g; g += kThreads) acc[g] = 0;
  __syncthreads();
  // A segment's whole table fits: staged once for each segment the
  // block's run meets. Otherwise a group range (or, for one group wider
  // than the budget, a slot range) at a time, for every item.
  const bool resident = a.g_stage >= a.g && a.k_stage >= a.live;
  const int chunks = a.k_stage >= a.live ? 1
                                         : (a.live + a.k_stage - 1) / a.k_stage;
  const int tiles = (a.w + kThreads - 1) / kThreads;
  const int lane = threadIdx.x & 31;
  // Persistent blocks, each over a contiguous run of (page, shard,
  // 256-row tile) items, so that consecutive items mostly share their
  // (page, shard) and its cnt sums stay in shared memory until it
  // changes, and mostly share their segment and its staged table. The
  // item, and so the segment, is uniform across the block: every thread
  // reaches every barrier and every warp shuffle.
  const long long per_block = (a.items + gridDim.x - 1) / gridDim.x;
  const long long begin = blockIdx.x * per_block;
  const long long end = begin + per_block < a.items ? begin + per_block
                                                    : a.items;
  long long ps = begin / tiles;                // page * S + shard
  int tile = static_cast<int>(begin - ps * tiles);
  long long sh = ps % a.s;
  long long held = -1;                         // ps whose sums acc holds
  int staged = -1;                             // segment tab holds
  int based = -1;                              // segment of the base test
  int bs = 0, bp = 0, bo = 0, eq_sp = 0, eq_so = 0, eq_po = 0;
  // Set up a segment: its base pattern and, when its table fits, the
  // table. The grouped kernel's one segment is set up before its run.
  auto enter = [&](int seg) {
    if (seg != based) {
      const int* v = a.base + 8 * seg;
      bs = __ldg(v + 0);
      bp = __ldg(v + 1);
      bo = __ldg(v + 2);
      eq_sp = __ldg(v + 3);
      eq_so = __ldg(v + 4);
      eq_po = __ldg(v + 5);
      based = seg;
    }
    if (resident && seg != staged) {
      __syncthreads();                         // done with the last table
      stage_slots(a, a.slots + static_cast<long long>(seg) * a.g * a.mp, 0,
                  a.g, 0, a.live, tab, bound);
      staged = seg;
    }
  };
  if (!kFused) enter(0);
  for (long long item = begin; item < end; ++item) {
    if (ps != held) {
      if (held >= 0) flush_cnt(a, held, acc);
      held = ps;
    }
    int seg = 0;
    if (kFused) {
      seg = a.seg_of_page[ps / a.s];
      if (seg >= a.segs) seg = -1;
      if (seg >= 0) enter(seg);
    }
    const int4* table =
        a.slots + static_cast<long long>(seg < 0 ? 0 : seg) * a.g * a.mp;
    const int r = tile * kThreads + threadIdx.x;
    // Prologue, once per row for all G groups: a live page, in span (or
    // listed), valid, and matching the base pattern (tpf_match's test).
    bool ok = false;
    int x = 0, y = 0, z = 0;
    if (r < a.w && seg >= 0) {
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
      const int ng = min(a.g_stage, a.g - g0);
      if (!resident && chunks == 1 && seg >= 0) {
        __syncthreads();                       // done with the last range
        stage_slots(a, table, g0, ng, 0, a.live, tab, bound);
      }
      for (int gl = 0; gl < ng; ++gl) {
        int first = a.mp, count = 0;
        if (chunks == 1) {
          if (ok) {
            match_slots(tab + gl * a.live, 0, bound[gl], x, y, z, a.mp,
                        first, count);
          }
        } else {
          // one group wider than the budget (g_stage 1), a slot range at
          // a time; slot k of the group is q[k]
          for (int k0 = 0; k0 < a.live; k0 += a.k_stage) {
            const int nk = min(a.k_stage, a.live - k0);
            if (seg >= 0) {
              __syncthreads();                 // done with the last range
              stage_slots(a, table, g0, 1, k0, nk, tab, bound);
            }
            if (ok) {
              match_slots(tab - k0, k0, k0 + bound[0], x, y, z, a.mp,
                          first, count);
            }
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

// Five blocks an SM, so at most 48 registers a thread (see the note at
// the top).
__global__ void __launch_bounds__(kThreads, 5)
bindjoin_grouped_kernel(const WindowArgs a) {
  windowed_body<false>(a);
}

__global__ void __launch_bounds__(kThreads, 5)
bindjoin_fused_kernel(const WindowArgs a) {
  windowed_body<true>(a);
}

// Fill the staging geometry of a, size the persistent grid and launch
// kernel. Returns a CUDA error code.
int launch_windowed(void (*kernel)(const WindowArgs), WindowArgs a,
                    cudaStream_t stream) {
  // the cnt sums take G x 8 bytes (rounded to int4s), the slots the rest
  const long long acc_bytes = (static_cast<long long>(a.g) + 1) / 2 * 16;
  const long long room = kStageBytes - acc_bytes;
  if (room < 20) return static_cast<int>(cudaErrorInvalidValue);
  long long g_stage, k_stage;
  if (static_cast<long long>(a.live) * 16 + 4 <= room) {
    k_stage = a.live;
    g_stage = std::min<long long>(a.g, room / (k_stage * 16 + 4));
  } else {
    k_stage = (room - 4) / 16;
    g_stage = 1;
  }
  a.g_stage = static_cast<int>(g_stage);
  a.k_stage = static_cast<int>(k_stage);
  const size_t smem = static_cast<size_t>(acc_bytes)
                      + static_cast<size_t>(g_stage * k_stage) * sizeof(int4)
                      + static_cast<size_t>(g_stage) * sizeof(int);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident_blocks =
      static_cast<long long>(std::max(sms, 1)) * std::max(per_sm, 1);
  const unsigned int blocks =
      static_cast<unsigned int>(std::min(a.items, resident_blocks));
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

WindowArgs window_args(const void* triples, const void* valid,
                       const void* spans, const void* rows,
                       const void* seg_of_page, const void* slots,
                       const void* base, void* mask, void* first, void* cnt,
                       void* nmatch, long long n, int p, int s, int w, int g,
                       int mp, int segs, int live) {
  WindowArgs a;
  a.triples = static_cast<const int*>(triples);
  a.valid = static_cast<const unsigned char*>(valid);
  a.spans = static_cast<const long long*>(spans);
  a.rows = static_cast<const int*>(rows);
  a.seg_of_page = static_cast<const int*>(seg_of_page);
  a.slots = static_cast<const int4*>(slots);
  a.base = static_cast<const int*>(base);
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
  a.segs = segs;
  a.live = live;
  a.g_stage = 0;
  a.k_stage = 0;
  return a;
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
  return launch_windowed(
      bindjoin_grouped_kernel,
      window_args(triples, valid, spans, rows, nullptr, slots, base_vec,
                  mask, first, cnt, nmatch, n, p, s, w, g, mp, 1, live),
      static_cast<cudaStream_t>(stream));
}

// seg_of_page int32 [P]: the segment of each page, whose slot table
// slots[seg] ([G, Mp]) and base vector base_vecs[seg] it is matched
// against; an id outside [0, segs) marks a dead page that keeps nothing.
extern "C" int brtpf_bindjoin_fused(
    const void* triples, const void* valid, const void* spans,
    const void* seg_of_page, const void* slots, const void* base_vecs,
    void* mask, void* first, void* cnt, void* nmatch, long long n, int p,
    int s, int w, int g, int mp, int segs, int live, void* stream) {
  if (p <= 0 || s <= 0 || w <= 0 || g <= 0) return 0;
  if (live < 0 || live > mp || segs < 1 || spans == nullptr
      || seg_of_page == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_windowed(
      bindjoin_fused_kernel,
      window_args(triples, valid, spans, nullptr, seg_of_page, slots,
                  base_vecs, mask, first, cnt, nmatch, n, p, s, w, g, mp,
                  segs, live),
      static_cast<cudaStream_t>(stream));
}
