// Single-triple-pattern matcher (the TPF selector's base mask).
//
// Replaces the TPU kernel repro/kernels/tpf_match.py:tpf_match_pallas
// (body _tpf_match_kernel). One thread per candidate row: read s/p/o,
// apply the pattern's bound components and its three repeated-variable
// equality flags, write an int32 mask. The pattern vector
// [s, p, o, eq_sp, eq_so, eq_po, 0, 0] stays in device memory and every
// thread reads it through the read-only cache (one broadcast line).
//
// Bound on an H100: bytes. Each row reads 12 bytes and writes 4, for
// about a dozen integer operations, far below the card's
// operations-per-byte balance. The design keeps the access pattern
// fully coalesced (neighbouring threads on neighbouring rows of three
// structure-of-arrays inputs) and masks its own ragged edge, so no
// caller needs the TPU layout's 32768-row tile padding.
//
// Plain C interface, loaded with ctypes: every entry returns
// cudaGetLastError() so that a refused launch is reported at once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void tpf_match_kernel(const int* __restrict__ cs,
                                 const int* __restrict__ cp,
                                 const int* __restrict__ co,
                                 const int* __restrict__ pat,
                                 int* __restrict__ mask, long long t) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= t) return;
  const int s = __ldg(pat + 0), p = __ldg(pat + 1), o = __ldg(pat + 2);
  const int eq_sp = __ldg(pat + 3), eq_so = __ldg(pat + 4),
            eq_po = __ldg(pat + 5);
  const int a = cs[i], b = cp[i], c = co[i];
  const bool m = (s < 0 || a == s) && (p < 0 || b == p) && (o < 0 || c == o)
                 && (eq_sp == 0 || a == b) && (eq_so == 0 || a == c)
                 && (eq_po == 0 || b == c);
  mask[i] = m ? 1 : 0;
}

}  // namespace

extern "C" int brtpf_tpf_match(const void* cs, const void* cp,
                               const void* co, const void* pattern_vec,
                               void* mask, long long t, void* stream) {
  if (t <= 0) return 0;
  const long long blocks = (t + kThreads - 1) / kThreads;
  tpf_match_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cs), static_cast<const int*>(cp),
      static_cast<const int*>(co), static_cast<const int*>(pattern_vec),
      static_cast<int*>(mask), t);
  return static_cast<int>(cudaGetLastError());
}
