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
//   gives a route's least rule index directly, or an ACL's member row
//   (the reference takes the max over a group's matching entries);
// * an ACL member row lists (rule, lo | hi << 16) pairs; the answer is
//   the least rule whose [lo, hi] holds the port (any rule without a
//   port). Pad rows (family -1) answer -1; a route table never gates on
//   ports. Row 0 is the empty row (every rule -1, fphash.py:1067), so a
//   group with no match, or a trie cell of 0, lists no row.
//
// Bound. Per query the kernel must read its address, family (and
// port) and write one int32; per trie query 2-3 cells (and one member
// row for an ACL); per group of the query's family one slot row of
// E x 12 bytes (and the matched entry's member row for an ACL); the
// group arrays once. Those bytes over the 3.35 TB/s HBM rate are the
// floor (chip_smoke.py `fp_cidr_work()`), read against the cold time.
// ~50 integer ops per group (3 salts x 4 FNV rounds + fmix32, the mask
// and the entry compares), no products of tiles. Well above the floor
// the time is latency: the chain of dependent loads a query walks.
//
// Chain depth (dependent global-load steps per query, counted from the
// source). The first version ran a thread per query: a warp's 32
// queries mixed the families, so the warp walked the union of their
// groups (all 24 of config #4's ACL, 64 V6 groups for a route query)
// with divergent lanes, one slot row after another, each row's E
// entries behind a short-circuit, and each matched member row pair by
// pair: ~100-200 dependent steps a warp. Here a group-path query takes
// 3 while its family has at most 32 x GROUPS live groups, its rows at
// most ENTRIES entries, and its matched member rows at most LIST pairs:
//   1. the block's group rows (an asynchronous copy into shared
//      memory) and the query's address, family and port;
//   2. the slot row of every live group of the query's family, GROUPS
//      per lane, all issued before any entry is compared;
//   3. the pairs of every matched member row, listed densely across
//      the warp, PAIRS per lane, all issued before any is gated (ACL
//      only; a route query ends at step 2);
// then a warp min-reduction. Each further 32 x GROUPS groups adds a
// round of step 2, each further ENTRIES entries of a row a step 2, each
// further LIST member pairs a step 3. A V4 query of a trie table keeps
// the walk's own length: the query, t_l0, t_l1, t_l2 (each only when
// the last cell says so), plus the member row of an ACL: at most 5.
//
// Design:
// * the block copies the group arrays (40 B per group) into shared
//   memory once (cp.async: no registers held, in flight beside the
//   query's own loads), so a lane reads its group's mask, salts, offset
//   and capacity with no global trip;
// * one warp per query: a ballot over the staged g_fam lists the
//   groups of the query's family in group order (padding groups,
//   g_fam -1, and pad rows, family -1, never match), so live group i
//   goes to lane i mod 32 and no lane walks another family's groups;
// * a lane hashes its GROUPS groups under their three salts (the FNV
//   rounds interleave), issues every slot-row load, then compares: a
//   row is 3 16-byte loads when E is a multiple of 4 (config #4's E = 4),
//   else one 4-byte load an int;
// * routes: each lane keeps the least matching entry value;
// * ACL: each group's member row is the max over its matching entries,
//   clamped to [0, nm); rows other than row 0 go to a per-warp row list
//   at their warp prefix sum (a shuffle scan); the Mk pairs of every
//   listed row are then numbered densely (pair x: row x / Mk, pair
//   x mod Mk) and dealt to the lanes, PAIRS at once as 8-byte loads,
//   gated on the port and min-reduced. The trie's member row takes the
//   same list (one row);
// * the answer is a minimum over entries and pairs, so no order of
//   groups, entries, rows, rounds or lanes can change it;
// * every index the reference gathers with JAX's clamp is clamped: the
//   slot to [0, ct), trie subtables to their arrays, member rows to
//   [0, nm).
// Half or quarter warps per query would keep more of config #4's ACL
// lanes busy at step 2 (its V4 family has 8 groups), but step 3 deals
// its member pairs over the whole warp; one warp per query keeps one
// shape for every layout.
//
// What Hopper's other tools would do here. wgmma and the tensor cores
// multiply tiles: this kernel hashes and compares, with no product.
// TMA copies tiles at given coordinates: the one tile-like read is the
// group arrays, contiguous and staged once per block (cp.async, a 1-D
// copy that needs no tensor map); every other read is a scattered
// 48-byte slot row, trie cell or 8-byte member pair chosen by the data,
// where a TMA issue and an mbarrier wait per row would add a step to
// the chain that row sits on. Plain loads through the read-only path,
// all of a step issued before any is used, are the shortest chain.
//
// The routine (the staged group rows, the trie and group walks, the
// member rows) is fp_cidr.cuh's `block_first`; B8 (sharded_match.cu)
// runs its warp part once per rule shard, or its interleaved form over
// S shards; this file is the kernel around it: the launch shape and the
// output.

#include <cstdint>

#include <cuda_runtime.h>

#include "fp_cidr.cuh"

using fpc::FpCidrArgs;
using fpc::WARPS;

namespace {

__global__ void __launch_bounds__(WARPS * 32)
fp_cidr_kernel(FpCidrArgs a) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  const int first = fpc::block_first(a, smem, q, warp, lane);
  if (q < a.b && lane == 0)
    a.out[(size_t)q * a.out_stride] = first < a.r_cap ? first : -1;
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

extern "C" int vproxy_fp_cidr_args_size() { return (int)sizeof(FpCidrArgs); }

// Launch on `stream` (PyTorch's current stream; no synchronisation).
// Returns cudaGetLastError() after the launch: 0 when it was accepted;
// cudaErrorInvalidValue, before any launch, for an empty table, an
// address, mask or slot-row array that is not 16-byte aligned, member
// rows that are not 8-byte aligned, or more groups than the 48 KB of
// shared memory a launch may take unasked holds (~680 groups; a table
// has at most 162 live ones).
extern "C" int vproxy_fp_cidr(const FpCidrArgs* args, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const FpCidrArgs& a = *args;
  if (a.b <= 0) return 0;
  const size_t smem = fpc::block_bytes(a.g);
  if (a.ct <= 0 || a.e <= 0 || a.r_cap <= 0 || a.out_stride <= 0 ||
      a.g < 0 || smem > 48 * 1024 || !aligned(a.a16, 16) ||
      !aligned(a.g_mask4, 16) || !aligned(a.rec, 16) ||
      (a.mrows != nullptr && (a.nm <= 0 || a.mk <= 0 ||
                              !aligned(a.mrows, 8))) ||
      (a.t_l0 != nullptr && (a.s1 <= 0 || a.s2 <= 0)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.b + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fp_cidr_kernel<<<grid, block, smem, s>>>(a);
  return (int)cudaGetLastError();
}
