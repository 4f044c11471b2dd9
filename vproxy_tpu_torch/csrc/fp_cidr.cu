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

#include <cstdint>

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;    // queries per block
constexpr int GROUPS = 2;   // live groups per lane per round
constexpr int ENTRIES = 4;  // slot-row entries per group per load step
constexpr int PAIRS = 4;    // member pairs per lane per window
constexpr int LIST = PAIRS * 32;  // member pairs per warp per window
constexpr int ROW_BYTES = 40;     // staged bytes per group
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

// The group arrays as staged in shared memory: g masks, then g words
// each of family, the three salts, first slot and capacity mask.
struct Rows {
  const uint4* mask;
  const int32_t* fam;
  const uint32_t* salt;  // salt[k * g + group], k = slot, fp1, fp2
  const int32_t* off;
  const int32_t* capmask;
};

// Shared memory a block needs: the staged rows, then per warp the
// family's group list (g ints) and the member-row list (g ints: at
// most one row per group; one for the trie's row when g is 0).
__host__ __device__ constexpr size_t rows_bytes(int g) {
  return (size_t)g * ROW_BYTES;
}
__host__ __device__ constexpr int warp_words(int g) {
  return g + (g > 0 ? g : 1);
}
__host__ __device__ constexpr size_t block_bytes(int g) {
  return rows_bytes(g) + (size_t)WARPS * warp_words(g) * 4;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ Rows rows_at(const int32_t* smem, int g) {
  const uint4* m = reinterpret_cast<const uint4*>(smem);
  const int32_t* w = reinterpret_cast<const int32_t*>(m + g);
  return {m, w, reinterpret_cast<const uint32_t*>(w + g), w + 4 * g,
          w + 5 * g};
}

// This thread's share of the asynchronous copy of the group arrays.
__device__ __forceinline__ void stage_rows(const FpCidrArgs& a,
                                           int32_t* smem, int tid) {
  uint4* m = reinterpret_cast<uint4*>(smem);
  const uint4* gm = reinterpret_cast<const uint4*>(a.g_mask4);
#pragma unroll 1
  for (int i = tid; i < a.g; i += WARPS * 32)
    __pipeline_memcpy_async(m + i, gm + i, 16);
  int32_t* w = reinterpret_cast<int32_t*>(m + a.g);
  const int32_t* src[6] = {
      a.g_fam, reinterpret_cast<const int32_t*>(a.g_salt_s),
      reinterpret_cast<const int32_t*>(a.g_salt_f1),
      reinterpret_cast<const int32_t*>(a.g_salt_f2), a.g_off, a.g_capmask};
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll 1
    for (int i = tid; i < a.g; i += WARPS * 32)
      __pipeline_memcpy_async(w + k * a.g + i, src[k] + i, 4);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// Cell `byte` of the subtable a negative cell v names (-v - 1), as an
// index into a level of n cells, clamped to its last cell.
__device__ __forceinline__ int sub_cell(int v, uint32_t byte, int n) {
  const long long i = (-(long long)v - 1) * 256 + byte;  // >= 0: v < 0
  return (int)(i < n ? i : n - 1);
}

// The 16/8/8 walk: the raw cell of the address's low 32 bits (bytes
// 12-15, the last little-endian word). Every lane walks the same cells.
__device__ __forceinline__ int trie_cell(const FpCidrArgs& a, uint32_t lo) {
  int v = __ldg(a.t_l0 + ((lo & 0xFFu) * 256 + ((lo >> 8) & 0xFFu)));
  if (v < 0) v = __ldg(a.t_l1 + sub_cell(v, (lo >> 16) & 0xFFu, a.s1));
  if (v < 0) v = __ldg(a.t_l2 + sub_cell(v, lo >> 24, a.s2));
  return v;
}

// Steps 2 (and the row list) for a query of family f >= 0: -> the
// number of member rows listed in `rlist` (ACL), and `first` lowered to
// the least matching entry value (routes).
__device__ __forceinline__ int group_walk(const FpCidrArgs& a,
                                          const Rows& r, int32_t* glist,
                                          int32_t* rlist, const uint4 addr,
                                          int f, bool acl, int lane,
                                          int& first) {
  const unsigned below = (1u << lane) - 1u;
  int ng = 0;  // the groups of the query's family, in group order
  for (int g0 = 0; g0 < a.g; g0 += 32) {
    const int gi = g0 + lane;
    const bool mine = gi < a.g && r.fam[gi] == f;
    const unsigned m = __ballot_sync(FULL, mine);
    if (mine) glist[ng + __popc(m & below)] = gi;
    ng += __popc(m);
  }
  __syncwarp();
  const int ew = 3 * a.e;
  const bool vec = a.e % ENTRIES == 0;  // rows and chunks 16-byte aligned
  int nrows = 0;
  for (int r0 = 0; r0 < ng; r0 += 32 * GROUPS) {
    int slot[GROUPS], f1[GROUPS], f2[GROUPS], mrow[GROUPS];
#pragma unroll
    for (int k = 0; k < GROUPS; ++k) {
      const int i = r0 + 32 * k + lane;
      slot[k] = -1;
      f1[k] = f2[k] = mrow[k] = 0;
      if (i < ng) {
        const int gi = glist[i];
        const uint4 mk = r.mask[gi];
        const uint32_t w[4] = {addr.x & mk.x, addr.y & mk.y, addr.z & mk.z,
                               addr.w & mk.w};
        uint32_t hs = FNV32_OFFSET ^ r.salt[gi];
        uint32_t h1 = FNV32_OFFSET ^ r.salt[a.g + gi];
        uint32_t h2 = FNV32_OFFSET ^ r.salt[2 * a.g + gi];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          hs = (hs ^ w[p]) * FNV32_PRIME;
          h1 = (h1 ^ w[p]) * FNV32_PRIME;
          h2 = (h2 ^ w[p]) * FNV32_PRIME;
        }
        f1[k] = (int)fmix32(h1);
        f2[k] = (int)fmix32(h2);
        slot[k] = clampi(r.off[gi] + (int)(fmix32(hs) &
                                           (uint32_t)r.capmask[gi]),
                         0, a.ct - 1);
      }
    }
    for (int e0 = 0; e0 < a.e; e0 += ENTRIES) {
      // every live group's entries [e0, e0 + ENTRIES) in flight at once
      int ent[GROUPS][3 * ENTRIES];
#pragma unroll
      for (int k = 0; k < GROUPS; ++k) {
#pragma unroll
        for (int x = 0; x < 3 * ENTRIES; ++x) ent[k][x] = 0;
        if (slot[k] < 0) continue;
        const int32_t* row = a.rec + (size_t)slot[k] * ew + 3 * e0;
        if (vec) {
          const int4* r4 = reinterpret_cast<const int4*>(row);
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            const int4 t = __ldg(r4 + v);
            ent[k][4 * v] = t.x;
            ent[k][4 * v + 1] = t.y;
            ent[k][4 * v + 2] = t.z;
            ent[k][4 * v + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < ENTRIES; ++j)
            if (e0 + j < a.e) {
              ent[k][3 * j] = __ldg(row + 3 * j);
              ent[k][3 * j + 1] = __ldg(row + 3 * j + 1);
              ent[k][3 * j + 2] = __ldg(row + 3 * j + 2);
            }
        }
      }
#pragma unroll
      for (int k = 0; k < GROUPS; ++k)
#pragma unroll
        for (int j = 0; j < ENTRIES; ++j) {
          if (slot[k] < 0 || e0 + j >= a.e || ent[k][3 * j] != f1[k] ||
              ent[k][3 * j + 1] != f2[k])
            continue;
          const int v = ent[k][3 * j + 2];
          if (acl) mrow[k] = max(mrow[k], v);
          else first = min(first, v);
        }
    }
    if (!acl) continue;
    // this round's member rows, listed at their warp prefix sum
    int mine = 0;
#pragma unroll
    for (int k = 0; k < GROUPS; ++k) {
      mrow[k] = clampi(mrow[k], 0, a.nm - 1);
      mine += mrow[k] != 0;
    }
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    int at = nrows + incl - mine;
#pragma unroll
    for (int k = 0; k < GROUPS; ++k)
      if (mrow[k] != 0) rlist[at++] = mrow[k];
    nrows += __shfl_sync(FULL, incl, 31);
  }
  return nrows;
}

// Step 3: the least rule of the listed member rows whose port range
// holds `port` (any listed rule without the gate), r_cap when none.
__device__ __forceinline__ int members_first(const FpCidrArgs& a,
                                             const int32_t* rlist,
                                             int nrows, bool gate, int port,
                                             int lane) {
  const int2* m2 = reinterpret_cast<const int2*>(a.mrows);
  const int np = nrows * a.mk;
  int first = a.r_cap;
  for (int w0 = 0; w0 < np; w0 += LIST) {
    int2 pr[PAIRS];
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
      const int x = w0 + 32 * q + lane;
      pr[q] = make_int2(-1, 0);
      if (x < np) {
        const int row = x / a.mk;
        pr[q] = __ldg(m2 + (size_t)rlist[row] * a.mk + (x - row * a.mk));
      }
    }
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
      const int idx = pr[q].x;
      const int lo = pr[q].y & 0xFFFF, hi = (pr[q].y >> 16) & 0xFFFF;
      if (idx >= 0 && idx < first && (!gate || (lo <= port && port <= hi)))
        first = idx;
    }
  }
  return first;
}

__global__ void __launch_bounds__(WARPS * 32)
fp_cidr_kernel(FpCidrArgs a) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  // step 1: the block's group rows, and beside them the query's inputs
  stage_rows(a, smem, threadIdx.x);
  __pipeline_commit();
  const bool live = q < a.b;  // warp-uniform
  const bool acl = a.mrows != nullptr;
  const bool gate = acl && a.port != nullptr;
  uint4 addr = make_uint4(0, 0, 0, 0);
  int f = -1, port = 0;
  if (live) {
    addr = __ldg(reinterpret_cast<const uint4*>(a.a16) + q);
    f = __ldg(a.fam + q);
    port = gate ? __ldg(a.port + q) : 0;
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // every thread's rows copied before any warp reads
  if (!live) return;
  int32_t* glist = reinterpret_cast<int32_t*>(
                       reinterpret_cast<uint8_t*>(smem) + rows_bytes(a.g)) +
                   warp * warp_words(a.g);
  int32_t* rlist = glist + a.g;
  int first = a.r_cap, nrows = 0;
  if (f < 0) {
    // a pad row matches no group and walks no trie
  } else if (f == V4 && a.t_l0 != nullptr) {
    const int cell = trie_cell(a, addr.w);
    if (!acl) {
      if (cell - 1 >= 0) first = cell - 1;
    } else {
      const int row = clampi(cell, 0, a.nm - 1);
      if (row != 0) {
        if (lane == 0) rlist[0] = row;
        nrows = 1;
      }
    }
  } else {
    nrows = group_walk(a, rows_at(smem, a.g), glist, rlist, addr, f, acl,
                       lane, first);
  }
  if (nrows > 0) {  // warp-uniform
    __syncwarp();
    first = min(first, members_first(a, rlist, nrows, gate, port, lane));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    first = min(first, __shfl_xor_sync(FULL, first, off));
  if (lane == 0) a.out[(size_t)q * a.out_stride] = first < a.r_cap ? first
                                                                   : -1;
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
  const size_t smem = block_bytes(a.g);
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
