// Fingerprint CIDR first match for Hopper (sm_90a): the route or ACL
// rule of each query of a batch against a packed-fingerprint CIDR
// table, one launch per batch (B7).
//
// Replaces: vproxy_tpu/ops/fphash.py:1176 `cidr_fp_match` (jitted as
// `cidr_fp_jit`, :1237) with `_trie4_lookup` (:1148), `_acl_first`
// (:1161), `_fnv32_words_dev` (:123) and `_pack_words16_dev` (:144):
// the XLA program every cidr batch of a "jax-fp" CidrMatcher runs, and
// two of the three programs of `classify_fp_all` (:1240). Plain
// version: ops/fphash.py `cidr_fp_match` of this package, which tier-1
// holds int32-equal to the reference.
//
// What it computes, for one query (a 16-byte address, its family, and a
// port when the table is an ACL and the caller gates on ports):
// * a V4-family query of a table with a trie walks the 16/8/8
//   direct-index trie over the low 32 bits: t_l0 cell; t_l1 only when
//   that cell names a subtable (< 0), t_l2 only when the t_l1 cell does.
//   Route cell = rule + 1 (0 a miss); ACL cell = a member row;
// * any other query, for each group of its family: the address masked
//   by the group's 4 mask words, FNV-32 + fmix32 under the group's 3
//   salts (slot, fp1, fp2); the slot row rec[g_off + (slot & capmask)]
//   holds E entries (fp1, fp2, value); an entry whose pair matches
//   gives a route's least rule index directly, or an ACL's member row;
// * an ACL member row lists (rule, lo | hi << 16) pairs; the answer is
//   the least rule whose [lo, hi] holds the port (any rule without a
//   port). Pad rows (family -1) answer -1; a route table never gates on
//   ports.
//
// Bound. Per query the kernel must read its address, family (and
// port) and write one int32; per trie query 2-3 cells (and one member
// row for an ACL); per group of the query's family one slot row of
// E x 12 bytes (and the matched entry's member row for an ACL); the
// group arrays once. Those bytes over the 3.35 TB/s HBM rate are the
// floor (chip_smoke.py `fp_cidr_work()`), read against the cold time.
// ~40 integer ops per group hash (3 salts x 4 FNV rounds + fmix32), no
// products of tiles.
//
// Design (simple and right first): one thread per query, 128 queries
// per block. The block stages the group arrays (10 ints per group) in
// shared memory once, so a query's group loop reads no global memory
// but its slot rows. The trie walk takes t_l1 / t_l2 only when the
// previous level says so (the XLA program reads them at row 0 and
// discards the value). A route query keeps the least index over its
// groups' matching entries; an ACL query reads a member row only for a
// matched entry (at most one per group: distinct keys under one mask).
// Every index the reference gathers with JAX's clamp is clamped: the
// slot to [0, ct), trie subtables to their arrays, member rows to
// [0, nm). Not yet done: a warp per query spreading the groups over
// lanes (a V6 query of config #4's routes walks 64 groups one after
// another), and the row loads kept in flight together.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // queries per block
constexpr int GROUP_INTS = 10;  // staged ints per group
constexpr uint32_t FNV32_OFFSET = 2166136261u;
constexpr uint32_t FNV32_PRIME = 16777619u;
constexpr int V4 = 0;

}  // namespace

// Every pointer first, then every int: the ctypes mirror in
// ops/fphash_cuda.py has the same order, and its size is checked
// against vproxy_fp_cidr_args_size() at load.
struct FpCidrArgs {
  const uint8_t* a16;        // [B, 16] addresses
  const int32_t* fam;        // [B] family, -1 for pad rows
  const int32_t* port;       // [B], or null: no port gate
  const uint32_t* g_mask4;   // [g, 4] mask words
  const int32_t* g_fam;      // [g], -1 for padding groups
  const uint32_t* g_salt_s;  // [g]
  const uint32_t* g_salt_f1; // [g]
  const uint32_t* g_salt_f2; // [g]
  const int32_t* g_off;      // [g]
  const int32_t* g_capmask;  // [g]
  const int32_t* rec;        // [ct, 3e] (fp1, fp2, value) entries
  const int32_t* mrows;      // [nm, 2mk] ACL member rows, or null: routes
  const int32_t* t_l0;       // [65536] trie, or null: no trie
  const int32_t* t_l1;       // [s1]
  const int32_t* t_l2;       // [s2]
  int32_t* out;              // [B] (stride out_stride), -1 for none
  int32_t b, g, ct, e, nm, mk, s1, s2, r_cap, out_stride;
};

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t fnv32_words(const uint32_t w[4],
                                                uint32_t salt) {
  uint32_t h = FNV32_OFFSET ^ salt;
  for (int p = 0; p < 4; ++p) h = (h ^ w[p]) * FNV32_PRIME;
  return fmix32(h);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The least rule of member row `row` whose port range holds `port`
// (every listed rule without a port), r_cap when none.
__device__ int acl_first(const FpCidrArgs& a, int row, const int32_t* port,
                         int p) {
  const int32_t* m = a.mrows + (size_t)clampi(row, 0, a.nm - 1) * 2 * a.mk;
  int first = a.r_cap;
  for (int i = 0; i < a.mk; ++i) {
    const int idx = __ldg(m + 2 * i);
    if (idx < 0 || idx >= first) continue;
    if (port != nullptr) {
      const int pr = __ldg(m + 2 * i + 1);
      if (p < (pr & 0xFFFF) || p > ((pr >> 16) & 0xFFFF)) continue;
    }
    first = idx;
  }
  return first;
}

// The 16/8/8 walk: the raw cell of the address's low 32 bits.
__device__ int trie_cell(const FpCidrArgs& a, const uint8_t* ad) {
  int v = __ldg(a.t_l0 + (ad[12] * 256 + ad[13]));
  if (v < 0)
    v = __ldg(a.t_l1 + clampi((-v - 1) * 256 + ad[14], 0, a.s1 - 1));
  if (v < 0)
    v = __ldg(a.t_l2 + clampi((-v - 1) * 256 + ad[15], 0, a.s2 - 1));
  return v;
}

__global__ void __launch_bounds__(THREADS)
fp_cidr_kernel(FpCidrArgs a) {
  extern __shared__ __align__(16) int32_t smem[];  // [g, GROUP_INTS]
  for (int i = threadIdx.x; i < a.g; i += THREADS) {
    int32_t* s = smem + i * GROUP_INTS;
    for (int k = 0; k < 4; ++k) s[k] = (int32_t)__ldg(a.g_mask4 + 4 * i + k);
    s[4] = __ldg(a.g_fam + i);
    s[5] = (int32_t)__ldg(a.g_salt_s + i);
    s[6] = (int32_t)__ldg(a.g_salt_f1 + i);
    s[7] = (int32_t)__ldg(a.g_salt_f2 + i);
    s[8] = __ldg(a.g_off + i);
    s[9] = __ldg(a.g_capmask + i);
  }
  __syncthreads();
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= a.b) return;
  const int f = __ldg(a.fam + q);
  const size_t o = (size_t)q * a.out_stride;
  if (f < 0) {  // a pad row matches no group and walks no trie
    a.out[o] = -1;
    return;
  }
  const bool acl = a.mrows != nullptr;
  const int p = (acl && a.port != nullptr) ? __ldg(a.port + q) : 0;
  const int32_t* port = acl ? a.port : nullptr;
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(a.a16) + q);
  const uint8_t* ad = reinterpret_cast<const uint8_t*>(&raw);
  int first = a.r_cap;
  if (f == V4 && a.t_l0 != nullptr) {
    const int cell = trie_cell(a, ad);
    if (acl) {
      if (cell != 0) first = acl_first(a, cell, port, p);
    } else if (cell - 1 >= 0) {
      first = cell - 1;
    }
  } else {
    const uint32_t aw[4] = {raw.x, raw.y, raw.z, raw.w};
    const int ew = 3 * a.e;
    for (int gi = 0; gi < a.g; ++gi) {
      const int32_t* s = smem + gi * GROUP_INTS;
      if (s[4] != f) continue;
      const uint32_t w[4] = {aw[0] & (uint32_t)s[0], aw[1] & (uint32_t)s[1],
                             aw[2] & (uint32_t)s[2], aw[3] & (uint32_t)s[3]};
      const uint32_t hs = fnv32_words(w, (uint32_t)s[5]);
      const int f1 = (int)fnv32_words(w, (uint32_t)s[6]);
      const int f2 = (int)fnv32_words(w, (uint32_t)s[7]);
      const int slot = clampi(s[8] + (int)(hs & (uint32_t)s[9]), 0, a.ct - 1);
      const int32_t* row = a.rec + (size_t)slot * ew;
      int mrow = 0;
      for (int j = 0; j < a.e; ++j) {
        if (__ldg(row + 3 * j) != f1 || __ldg(row + 3 * j + 1) != f2)
          continue;
        const int v = __ldg(row + 3 * j + 2);
        if (!acl) first = min(first, v);
        else mrow = max(mrow, v);
      }
      if (acl && mrow != 0) first = min(first, acl_first(a, mrow, port, p));
    }
  }
  a.out[o] = first < a.r_cap ? first : -1;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int vproxy_fp_cidr_args_size() { return (int)sizeof(FpCidrArgs); }

// Launch on `stream` (PyTorch's current stream; no synchronisation).
// Returns cudaGetLastError() after the launch: 0 when it was accepted;
// cudaErrorInvalidValue, before any launch, for an empty table, an
// address array that is not 16-byte aligned, or more groups than the
// 48 KB of shared memory a launch may take unasked holds.
extern "C" int vproxy_fp_cidr(const FpCidrArgs* args, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const FpCidrArgs& a = *args;
  if (a.b <= 0) return 0;
  const size_t smem = (size_t)a.g * GROUP_INTS * sizeof(int32_t);
  if (a.ct <= 0 || a.e <= 0 || a.r_cap <= 0 || a.out_stride <= 0 ||
      smem > 48 * 1024 || !aligned16(a.a16) ||
      (a.mrows != nullptr && (a.nm <= 0 || a.mk <= 0)) ||
      (a.t_l0 != nullptr && (a.s1 <= 0 || a.s2 <= 0)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.b + THREADS - 1) / THREADS), block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fp_cidr_kernel<<<grid, block, smem, s>>>(a);
  return (int)cudaGetLastError();
}
