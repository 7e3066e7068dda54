// Single-triple-pattern matcher (the base mask of the full-shard stream,
// FederatedStore.execute_full and its steps).
//
// Replaces the TPU kernel repro/kernels/tpf_match.py:tpf_match_pallas
// (body _tpf_match_kernel). One thread per candidate row of an AoS
// int32 [T, 3] block, read where it lies (no column copies): apply the
// pattern's bound components and its three repeated-variable equality
// flags, write a uint8 mask (the caller views it as bool, no conversion
// pass). The pattern vector [s, p, o, eq_sp, eq_so, eq_po, 0, 0] stays in
// device memory and every thread reads it through the read-only cache
// (one broadcast line). The grouped steps do not launch this kernel: the
// grouped bind-join kernel runs the same test in its prologue.
//
// Bound on an H100: bytes. Each row reads 12 bytes and writes 1, for
// about a dozen integer operations, far below the card's
// operations-per-byte balance. A warp's three 4-byte loads cover 384
// contiguous bytes, so each line is fetched once; the kernel masks its
// own ragged edge, so no caller pads T (the TPU layout's 32768-row tile
// padding is gone).
//
// Plain C interface, loaded with ctypes: every entry returns
// cudaGetLastError() so that a refused launch is reported at once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void tpf_match_kernel(const int* __restrict__ rows,
                                 const int* __restrict__ pat,
                                 unsigned char* __restrict__ mask,
                                 long long t) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= t) return;
  const int s = __ldg(pat + 0), p = __ldg(pat + 1), o = __ldg(pat + 2);
  const int eq_sp = __ldg(pat + 3), eq_so = __ldg(pat + 4),
            eq_po = __ldg(pat + 5);
  const int a = rows[3 * i], b = rows[3 * i + 1], c = rows[3 * i + 2];
  const bool m = (s < 0 || a == s) && (p < 0 || b == p) && (o < 0 || c == o)
                 && (eq_sp == 0 || a == b) && (eq_so == 0 || a == c)
                 && (eq_po == 0 || b == c);
  mask[i] = m ? 1 : 0;
}

}  // namespace

extern "C" int brtpf_tpf_match(const void* rows, const void* pattern_vec,
                               void* mask, long long t, void* stream) {
  if (t <= 0) return 0;
  const long long blocks = (t + kThreads - 1) / kThreads;
  tpf_match_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int*>(pattern_vec),
      static_cast<unsigned char*>(mask), t);
  return static_cast<int>(cudaGetLastError());
}
