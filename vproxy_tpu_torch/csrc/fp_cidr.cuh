// The fingerprint CIDR routine shared by the kernels that answer a
// route or ACL query of the fingerprint tables on Hopper (sm_90a):
// fp_cidr.cu (B7) and sharded_match.cu (B8: `warp_first` once per rule
// shard, or `warp_first_shards`, the interleaved form over S shards).
// fp_cidr.cu's note gives the design, the chain of dependent loads and
// the bound; this header holds the code it describes: the launch
// arguments (FpCidrArgs), the staged group rows, the trie walk, the
// group walk, the member rows, `warp_first`, one warp's first match
// over staged rows, and `block_first`, one block's first matches.
//
// Replaces: vproxy_tpu/ops/fphash.py:1176 `cidr_fp_match`; plain
// version: ops/fphash.py `cidr_fp_match` of this package.
#pragma once

#include <cstdint>

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace fpc {

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

// The group arrays as staged in shared memory: g masks, then g words
// each of family, the three salts, first slot and capacity mask.
struct Rows {
  const uint4* mask;
  const int32_t* fam;
  const uint32_t* salt;  // salt[k * g + group], k = slot, fp1, fp2
  const int32_t* off;
  const int32_t* capmask;
  __device__ __forceinline__ uint32_t salt_at(int k, int g, int gi) const {
    return salt[k * g + gi];
  }
};

// The same arrays read where the table keeps them (global memory,
// through L1), for a kernel whose warps work on different tables and
// stage nothing.
struct TableRows {
  const uint4* mask;
  const int32_t* fam;
  const uint32_t* salt_k[3];  // slot, fp1, fp2
  const int32_t* off;
  const int32_t* capmask;
  __device__ __forceinline__ uint32_t salt_at(int k, int, int gi) const {
    return salt_k[k][gi];
  }
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

__device__ __forceinline__ TableRows rows_of(const FpCidrArgs& a) {
  return {reinterpret_cast<const uint4*>(a.g_mask4), a.g_fam,
          {a.g_salt_s, a.g_salt_f1, a.g_salt_f2}, a.g_off, a.g_capmask};
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
template <class R>
__device__ __forceinline__ int group_walk(const FpCidrArgs& a,
                                          const R& r, int32_t* glist,
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
        uint32_t hs = FNV32_OFFSET ^ r.salt_at(0, a.g, gi);
        uint32_t h1 = FNV32_OFFSET ^ r.salt_at(1, a.g, gi);
        uint32_t h2 = FNV32_OFFSET ^ r.salt_at(2, a.g, gi);
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

// One warp's first match for one query (address `addr` of family f,
// `port` when the table gates ports) over the group rows `rows` (the
// staged Rows, or TableRows), with the warp's own lists at `glist`
// (warp_words(a.g) ints): a.r_cap when none. Every lane calls it.
template <class R>
__device__ __forceinline__ int warp_first(const FpCidrArgs& a,
                                          const R& rows, int32_t* glist,
                                          const uint4 addr, int f, int port,
                                          int lane) {
  const bool acl = a.mrows != nullptr;
  const bool gate = acl && a.port != nullptr;
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
    nrows = group_walk(a, rows, glist, rlist, addr, f, acl, lane, first);
  }
  if (nrows > 0) {  // warp-uniform
    __syncwarp();
    first = min(first, members_first(a, rlist, nrows, gate, port, lane));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    first = min(first, __shfl_xor_sync(FULL, first, off));
  return first;
}

// ------------------------------------------------ the interleaved form
//
// `warp_first_shards` answers one query over S rule shards in one warp
// (B8, sharded_match.cu): warp_first's steps once for all the shards
// together. An IPv4 query on trie tables walks the S tries on S lanes
// at once; any other query lists the groups of its family over every
// shard, so one round's groups, their slot rows and the member rows
// span the shards and are loaded at once, and the S chains of dependent
// loads overlap. The group rows are read where each shard keeps them.
// Each shard's first match is kept apart (a shared min a shard), as
// warp_first keeps it. `Sh` gives shard j's arguments (`at(j)`) and
// the key a first match takes (`key(j, rule)`: the greater key wins).
// -> the greatest key over the shards, 0 for none, on every lane.

// Ints of shared memory one warp needs over S shards: the shards'
// firsts, the group list (shard and group), the member rows and their
// shards.
__host__ __device__ constexpr int shards_warp_words(int g, int shards) {
  return ((shards + 3) & ~3) + 3 * shards * (g > 0 ? g : 1);
}

template <class Sh>
__device__ __forceinline__ unsigned long long warp_first_shards(
    const Sh& sh, int shards, int32_t* ws, const uint4 addr, int f,
    int port, int lane) {
  const FpCidrArgs& a0 = sh.at(0);
  const bool acl = a0.mrows != nullptr;
  const bool gate = acl && a0.port != nullptr;
  const int g = a0.g;
  const int cap = shards * (g > 0 ? g : 1);
  int32_t* sfirst = ws;
  int32_t* glist = ws + ((shards + 3) & ~3);
  int32_t* rlist = glist + cap;
  int32_t* rsh = rlist + cap;
  const unsigned below = (1u << lane) - 1u;
  for (int j = lane; j < shards; j += 32) sfirst[j] = a0.r_cap;
  __syncwarp();
  int nrows = 0;
  if (f < 0) {
    // a pad row matches no group and walks no trie
  } else if (f == V4 && a0.t_l0 != nullptr) {
    for (int j0 = 0; j0 < shards; j0 += 32) {
      const int j = j0 + lane;
      int row = 0;
      if (j < shards) {
        const FpCidrArgs& a = sh.at(j);
        const int cell = trie_cell(a, addr.w);
        if (!acl) {
          if (cell - 1 >= 0) sfirst[j] = cell - 1;
        } else {
          row = clampi(cell, 0, a.nm - 1);
        }
      }
      const unsigned m = __ballot_sync(FULL, row != 0);
      if (row != 0) {
        const int at = nrows + __popc(m & below);
        rlist[at] = row;
        rsh[at] = j;
      }
      nrows += __popc(m);
    }
  } else {
    // every shard's groups of the query's family: entry j * g + group
    int ng = 0;
    for (int x0 = 0; x0 < shards * g; x0 += 32) {
      const int x = x0 + lane;
      bool mine = false;
      if (x < shards * g) {
        const int j = x / g;
        mine = __ldg(sh.at(j).g_fam + (x - j * g)) == f;
      }
      const unsigned m = __ballot_sync(FULL, mine);
      if (mine) glist[ng + __popc(m & below)] = x;
      ng += __popc(m);
    }
    __syncwarp();
    const int ew = 3 * a0.e;
    const bool vec = a0.e % ENTRIES == 0;
    for (int r0 = 0; r0 < ng; r0 += 32 * GROUPS) {
      int slot[GROUPS], f1[GROUPS], f2[GROUPS], mrow[GROUPS], js[GROUPS];
      int first[GROUPS];
#pragma unroll
      for (int k = 0; k < GROUPS; ++k) {
        const int i = r0 + 32 * k + lane;
        slot[k] = -1;
        f1[k] = f2[k] = mrow[k] = js[k] = 0;
        first[k] = a0.r_cap;
        if (i < ng) {
          const int x = glist[i];
          const int j = x / g, gi = x - j * g;
          const FpCidrArgs& a = sh.at(j);
          const uint4 mk = __ldg(reinterpret_cast<const uint4*>(a.g_mask4) +
                                 gi);
          const uint32_t w[4] = {addr.x & mk.x, addr.y & mk.y,
                                 addr.z & mk.z, addr.w & mk.w};
          uint32_t hs = FNV32_OFFSET ^ __ldg(a.g_salt_s + gi);
          uint32_t h1 = FNV32_OFFSET ^ __ldg(a.g_salt_f1 + gi);
          uint32_t h2 = FNV32_OFFSET ^ __ldg(a.g_salt_f2 + gi);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            hs = (hs ^ w[p]) * FNV32_PRIME;
            h1 = (h1 ^ w[p]) * FNV32_PRIME;
            h2 = (h2 ^ w[p]) * FNV32_PRIME;
          }
          f1[k] = (int)fmix32(h1);
          f2[k] = (int)fmix32(h2);
          slot[k] = clampi(__ldg(a.g_off + gi) +
                               (int)(fmix32(hs) &
                                     (uint32_t)__ldg(a.g_capmask + gi)),
                           0, a.ct - 1);
          js[k] = j;
        }
      }
      for (int e0 = 0; e0 < a0.e; e0 += ENTRIES) {
        // every live group's entries [e0, e0 + ENTRIES) in flight at once
        int ent[GROUPS][3 * ENTRIES];
#pragma unroll
        for (int k = 0; k < GROUPS; ++k) {
#pragma unroll
          for (int x = 0; x < 3 * ENTRIES; ++x) ent[k][x] = 0;
          if (slot[k] < 0) continue;
          const int32_t* row =
              sh.at(js[k]).rec + (size_t)slot[k] * ew + 3 * e0;
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
              if (e0 + j < a0.e) {
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
            if (slot[k] < 0 || e0 + j >= a0.e || ent[k][3 * j] != f1[k] ||
                ent[k][3 * j + 1] != f2[k])
              continue;
            const int v = ent[k][3 * j + 2];
            if (acl) mrow[k] = max(mrow[k], v);
            else first[k] = min(first[k], v);
          }
      }
      if (!acl) {
#pragma unroll
        for (int k = 0; k < GROUPS; ++k)
          if (first[k] < a0.r_cap) atomicMin(sfirst + js[k], first[k]);
        continue;
      }
      // this round's member rows, listed at their warp prefix sum
      int mine = 0;
#pragma unroll
      for (int k = 0; k < GROUPS; ++k) {
        mrow[k] = clampi(mrow[k], 0, a0.nm - 1);
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
        if (mrow[k] != 0) {
          rlist[at] = mrow[k];
          rsh[at++] = js[k];
        }
      nrows += __shfl_sync(FULL, incl, 31);
    }
  }
  if (nrows > 0) {  // warp-uniform: the listed rows' members at once
    __syncwarp();
    const int np = nrows * a0.mk;
    for (int w0 = 0; w0 < np; w0 += LIST) {
      int2 pr[PAIRS];
      int pj[PAIRS];
#pragma unroll
      for (int q = 0; q < PAIRS; ++q) {
        const int x = w0 + 32 * q + lane;
        pr[q] = make_int2(-1, 0);
        pj[q] = 0;
        if (x < np) {
          const int row = x / a0.mk;
          pj[q] = rsh[row];
          const int2* m2 = reinterpret_cast<const int2*>(sh.at(pj[q]).mrows);
          pr[q] = __ldg(m2 + (size_t)rlist[row] * a0.mk + (x - row * a0.mk));
        }
      }
#pragma unroll
      for (int q = 0; q < PAIRS; ++q) {
        const int idx = pr[q].x;
        const int lo = pr[q].y & 0xFFFF, hi = (pr[q].y >> 16) & 0xFFFF;
        if (idx >= 0 && idx < a0.r_cap &&
            (!gate || (lo <= port && port <= hi)))
          atomicMin(sfirst + pj[q], idx);
      }
    }
  }
  __syncwarp();  // every lane's firsts in before they are read
  unsigned long long best = 0;
  for (int j = lane; j < shards; j += 32) {
    const int m = sfirst[j];
    if (m >= 0 && m < a0.r_cap) {
      const unsigned long long k = sh.key(j, m);
      best = k > best ? k : best;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(FULL, best, off);
    best = o > best ? o : best;
  }
  return best;
}

// One block's part of a batch: every thread stages the group rows and
// the block syncs once (so every thread of the block calls this,
// whatever its query), then warp `warp` answers query q: -> its first
// match, a.r_cap when none, and a.r_cap on the warps whose q >= a.b.
// `smem`: block_bytes(a.g), 16-byte aligned.
__device__ __forceinline__ int block_first(const FpCidrArgs& a,
                                           int32_t* smem, int q, int warp,
                                           int lane) {
  // step 1: the block's group rows, and beside them the query's inputs
  stage_rows(a, smem, threadIdx.x);
  __pipeline_commit();
  const bool live = q < a.b;  // warp-uniform
  const bool gate = a.mrows != nullptr && a.port != nullptr;
  uint4 addr = make_uint4(0, 0, 0, 0);
  int f = -1, port = 0;
  if (live) {
    addr = __ldg(reinterpret_cast<const uint4*>(a.a16) + q);
    f = __ldg(a.fam + q);
    port = gate ? __ldg(a.port + q) : 0;
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // every thread's rows copied before any warp reads
  if (!live) return a.r_cap;
  int32_t* glist = reinterpret_cast<int32_t*>(
                       reinterpret_cast<uint8_t*>(smem) + rows_bytes(a.g)) +
                   warp * warp_words(a.g);
  return warp_first(a, rows_at(smem, a.g), glist, addr, f, port, lane);
}

}  // namespace fpc
