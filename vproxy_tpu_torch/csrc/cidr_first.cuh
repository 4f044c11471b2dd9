// The CIDR first-match routine shared by the two kernels that answer a
// route or ACL lookup on Hopper (sm_90a): cidr_first.cu (B4, the
// `cidr` kind of ClassifyService) and the route column of
// fused_classify_pick.cu (B1's [B, 3] form).
//
// Replaces: vproxy_tpu/ops/hashmatch.py:723 `cidr_hash_match` with
// `_fnv32_device` (:713), over the packed layout of
// vproxy_tpu/ops/fused.py:271 `_cidr_first_packed`. Reference
// semantics: ops/fused.py `_cidr_first_packed` of this package (the
// plain torch tier), bit for bit.
//
// What it computes, for one query (a 16-byte address, its family, and
// a port when the table is an ACL): for every (family, mask) group g
// of the table and each of its two cuckoo salts, the FNV-32 of the 16
// masked address bytes picks a slot in g's slot range; a slot whose
// record is used and whose 16-byte key equals the masked address
// lists its rules in cb_items[start, start + count); the answer is the
// least listed rule index whose meta row is valid and, with a port,
// whose [min_port, max_port] holds the port. r_cap or more means none.
//
// Bound. Per query: its address, family (and port), its answer; per
// live (group, salt) pair one 16-byte slot record and one 16-byte key;
// per entry of a matching bucket 4 bytes; per listed rule one 16-byte
// meta row; the g_* rows once. No products and ~40 integer ops per
// pair, so the floor is those distinct bytes over the 3.35 TB/s HBM
// rate (chip_smoke.py `cidr_work()`), read against the cold time. Well
// above it the time is latency: the chain of dependent loads a query
// walks, which this design keeps short.
//
// Chain depth (dependent global-load steps per query, counted from the
// source). The first version of this routine looped p = lane, lane +
// 32, ... over all 2 x g pairs, one after another: per pair it loaded
// g_fam (1 step), then the group's other rows, hashed and loaded the
// slot record and key (2 more), then walked the bucket one entry at a
// time, an entry and then the meta row that depends on it (2 steps per
// entry); a padding group cost its g_fam load. At config #4 (128
// groups for the routes, 32 for the ACL) that is ~16 steps per lane
// for a route query (8 iterations, 2-3 of them live, buckets of 1-2)
// and ~50 for an ACL query whose lane walks a 23-entry bucket. Here
// it is 4 while a query has at most 32 x PROBES live pairs and LIST
// bucket entries:
//   1. the block's group rows (an asynchronous copy into shared
//      memory) and the query's address, family and port;
//   2. every live pair's slot record and key, PROBES per lane at once;
//   3. the rule index of every entry of every matching bucket, spread
//      over the warp, ENTRIES per lane at once;
//   4. the meta row of every listed rule index in [0, r_cap), at once;
// then a warp min-reduction. Each further 32 x PROBES pairs adds a
// round of steps 2-4, each further LIST entries of a round steps 3-4.
//
// Design:
// * the block copies the g_* rows (36 B per group) into shared memory
//   once (cp.async: no registers held, in flight beside the query's
//   own loads), so a probe reads its group row with no global trip;
// * one warp per query: a ballot over the staged g_fam lists the
//   groups of the query's family (any order of families: g_fam < 0,
//   padding and pad rows' family -1, never matches), so the live
//   (group, salt) pairs are numbered densely and pair i goes to lane
//   i mod 32: no lane loops over padding groups;
// * a lane hashes up to PROBES pairs (the 16 FNV rounds interleave),
//   issues all their slot-record and key loads, then compares;
// * the matching pairs' live entries (count clamped to the bucket cap)
//   are listed at their warp prefix sum (a shuffle scan) in a per-warp
//   list of LIST entries; each lane loads ENTRIES entries at once,
//   drops rule indices < 0 or >= r_cap before their meta rows are read
//   (the reference's `c < r_cap` filter: a cut meta array is never
//   read past its end), then loads the survivors' meta rows at once,
//   gates them and keeps its least; the warp min-reduction folds the
//   lanes. The result is a minimum, so no order of pairs, entries or
//   lanes can change it.
// * every index the reference gathers with JAX's clamp is clamped:
//   the slot to [0, ct), a bucket's live count to [0, bk], an entry to
//   [0, cb) (a negative one lists nothing, as the reference drops it).
//
// What Hopper's other tools would do here. wgmma and the tensor cores
// multiply tiles: this routine hashes and compares, with no product.
// TMA copies tiles at given coordinates: the one tile-like read is the
// group rows, contiguous arrays staged once per block (cp.async, a
// 1-D copy that needs no tensor map); every other read is a scattered
// 16-byte row or 4-byte entry chosen by the data, where a TMA issue
// and an mbarrier wait per row would add a step to the chain that row
// sits on. Plain 16-byte loads through the read-only path, all of a
// step issued before any is used, are the shortest chain.
#pragma once

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cidr {

constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t FNV32_OFFSET = 2166136261u;
constexpr uint32_t FNV32_PRIME = 16777619u;
// Live pairs per lane per round: 3 takes a query of up to 96 pairs
// (config #4 has at most 78) in one round, and keeps every instance of
// fused_classify_pick.cu within its 64 registers with no spill, which
// 4 does not.
constexpr int PROBES = 3;
constexpr int ENTRIES = 4;           // bucket entries per lane per window
constexpr int LIST = ENTRIES * 32;   // bucket entries per warp per window
constexpr int ROW_BYTES = 36;        // staged bytes per group

// A packed cidr table (ops/fused.py pack_cidr_table) as the kernels
// read it.
struct Table {
  const int32_t* pk_cslot;   // [ct, 4] used, bucket start, count, 0
  const int32_t* pk_cmeta;   // [r_cap, 4] valid, min port, max port, 0
  const uint8_t* s_key;      // [ct, 16] masked keys
  const int32_t* cb_items;   // [cb] rule index per bucket entry, -1 pad
  const int32_t* g_fam;      // [g] family, -1 for a padding group
  const uint8_t* g_mask;     // [g, 16]
  const int32_t* g_off;      // [g] first slot of the group
  const int32_t* g_capmask;  // [g] group capacity - 1
  const uint32_t* g_salt1;   // [g]
  const uint32_t* g_salt2;   // [g]
  int32_t ct, r_cap, cb, g, bk;
};

// The group rows as staged in shared memory: g masks, then g words
// each of family, first slot and capacity mask, then the g first
// salts and the g second salts (salt[s * g + group]).
struct Rows {
  const uint4* mask;
  const int32_t* fam;
  const int32_t* off;
  const int32_t* capmask;
  const uint32_t* salt;
};

// Shared memory the routine needs: per block the staged rows (rounded
// to 16 B, so what follows them stays aligned), per warp (warp_words
// ints) the family's group list and the entry list.
__host__ __device__ constexpr size_t rows_bytes(int g) {
  return ((size_t)g * ROW_BYTES + 15) & ~(size_t)15;
}
__host__ __device__ constexpr int warp_words(int g) { return g + LIST; }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ Rows rows_at(const void* base, int g) {
  const uint4* m = static_cast<const uint4*>(base);
  const int32_t* w = reinterpret_cast<const int32_t*>(m + g);
  return {m, w, w + g, w + 2 * g,
          reinterpret_cast<const uint32_t*>(w + 3 * g)};
}

// Issue this thread's share (thread `tid` of `nthreads`) of the
// asynchronous copy of the group rows to `dst` (16-byte aligned,
// rows_bytes(t.g)). The caller commits, then waits
// (__pipeline_wait_prior(0)) and syncs the block before rows_at reads.
__device__ __forceinline__ void stage_rows(const Table& t, void* dst,
                                           int tid, int nthreads) {
  uint4* m = static_cast<uint4*>(dst);
  const uint4* gm = reinterpret_cast<const uint4*>(t.g_mask);
#pragma unroll 1
  for (int i = tid; i < t.g; i += nthreads)
    __pipeline_memcpy_async(m + i, gm + i, 16);
  int32_t* w = reinterpret_cast<int32_t*>(m + t.g);
  const int32_t* src[5] = {
      t.g_fam, t.g_off, t.g_capmask,
      reinterpret_cast<const int32_t*>(t.g_salt1),
      reinterpret_cast<const int32_t*>(t.g_salt2)};
#pragma unroll
  for (int k = 0; k < 5; ++k)
#pragma unroll 1
    for (int i = tid; i < t.g; i += nthreads)
      __pipeline_memcpy_async(w + k * t.g + i, src[k] + i, 4);
}

// FNV-32 over the 4 bytes of a little-endian word, lowest byte first
// (byte order of the 16-byte key: ops/cuckoo.py fnv32_masked).
__device__ __forceinline__ uint32_t fnv_word(uint32_t h, uint32_t w) {
#pragma unroll
  for (int s = 0; s < 32; s += 8) h = (h ^ ((w >> s) & 0xffu)) * FNV32_PRIME;
  return h;
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 m) {
  return make_uint4(a.x & m.x, a.y & m.y, a.z & m.z, a.w & m.w);
}

// The least matching rule index of one query, the same on every lane;
// t.r_cap or more when none matches. Every lane of the warp calls it
// with the same query (addr, fam, and port when `gate`); `r` are the
// staged rows, `glist` (t.g ints) and `list` (LIST ints) the warp's
// own shared memory.
__device__ __forceinline__ int first_match(const Table& t, const Rows& r,
                                           int32_t* glist, int32_t* list,
                                           const uint4 addr, int fam,
                                           bool gate, int port, int lane) {
  const unsigned below = (1u << lane) - 1u;
  // the groups of the query's family, in group order
  int ng = 0;
  for (int g0 = 0; g0 < t.g; g0 += 32) {
    const int gi = g0 + lane;
    const int gf = gi < t.g ? r.fam[gi] : -1;
    const bool live = gf >= 0 && gf == fam;
    const unsigned m = __ballot_sync(FULL, live);
    if (live) glist[ng + __popc(m & below)] = gi;
    ng += __popc(m);
  }
  __syncwarp();
  const int np = 2 * ng;  // pair i: group glist[i >> 1], salt i & 1
  int best = t.r_cap;
  for (int p0 = 0; p0 < np; p0 += 32 * PROBES) {
    // step 2: PROBES pairs per lane, hashed together, then every slot
    // record and key loaded before any is compared
    int slot[PROBES];
#pragma unroll
    for (int k = 0; k < PROBES; ++k) {
      const int i = p0 + 32 * k + lane;
      slot[k] = -1;
      if (i < np) {
        const int gi = glist[i >> 1];
        const uint4 mk = and4(addr, r.mask[gi]);
        uint32_t h = FNV32_OFFSET ^ r.salt[(i & 1) * t.g + gi];
        h = fnv_word(h, mk.x);
        h = fnv_word(h, mk.y);
        h = fnv_word(h, mk.z);
        h = fnv_word(h, mk.w);
        slot[k] = clampi(r.off[gi] + ((int)h & r.capmask[gi]), 0, t.ct - 1);
      }
    }
    int4 rec[PROBES];
    uint4 key[PROBES];
#pragma unroll
    for (int k = 0; k < PROBES; ++k) {
      rec[k] = make_int4(0, 0, 0, 0);
      key[k] = make_uint4(0, 0, 0, 0);
      if (slot[k] >= 0) {
        rec[k] = __ldg(reinterpret_cast<const int4*>(t.pk_cslot) + slot[k]);
        key[k] = __ldg(reinterpret_cast<const uint4*>(t.s_key) + slot[k]);
      }
    }
    // live entries: j < count and j < the bucket cap, as the reference
    // takes j from bk_iota
    int cnt[PROBES], mine = 0;
#pragma unroll
    for (int k = 0; k < PROBES; ++k) {
      const int i = p0 + 32 * k + lane;
      const uint4 mk =
          slot[k] >= 0 ? and4(addr, r.mask[glist[i >> 1]]) : key[k];
      const bool ok = slot[k] >= 0 && rec[k].x > 0 && key[k].x == mk.x &&
                      key[k].y == mk.y && key[k].z == mk.z &&
                      key[k].w == mk.w;
      cnt[k] = ok ? clampi(rec[k].z, 0, t.bk) : 0;
      mine += cnt[k];
    }
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    // steps 3 and 4, per LIST entries: this lane's entries listed at
    // its prefix sum, then every entry's rule index loaded at once,
    // then the meta row of every index in [0, r_cap) at once
    for (int w0 = 0; w0 < total; w0 += LIST) {
      int e = incl - mine;
#pragma unroll
      for (int k = 0; k < PROBES; ++k) {
        const int lo = e > w0 ? e : w0;
        const int hi = e + cnt[k] < w0 + LIST ? e + cnt[k] : w0 + LIST;
        for (int x = lo; x < hi; ++x) {
          const int j = rec[k].y + (x - e);
          list[x - w0] = j < 0 ? -1 : (j < t.cb ? j : t.cb - 1);
        }
        e += cnt[k];
      }
      __syncwarp();
      int item[ENTRIES];
#pragma unroll
      for (int q = 0; q < ENTRIES; ++q) {
        const int x = w0 + 32 * q + lane;
        const int j = x < total ? list[x - w0] : -1;
        item[q] = j >= 0 ? __ldg(t.cb_items + j) : -1;
      }
      int4 meta[ENTRIES];
#pragma unroll
      for (int q = 0; q < ENTRIES; ++q) {
        meta[q] = make_int4(0, 0, 0, 0);
        if (item[q] >= 0 && item[q] < t.r_cap)
          meta[q] = __ldg(reinterpret_cast<const int4*>(t.pk_cmeta) + item[q]);
      }
#pragma unroll
      for (int q = 0; q < ENTRIES; ++q)
        if (meta[q].x > 0 && (!gate || (meta[q].y <= port && port <= meta[q].z))
            && item[q] < best)
          best = item[q];
      __syncwarp();  // the list is rewritten by the next window
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int o = __shfl_xor_sync(FULL, best, off);
    best = o < best ? o : best;
  }
  return best;
}

// Shared memory a block of `nwarps` warps needs for block_first_match.
__host__ __device__ constexpr size_t block_bytes(int g, int nwarps) {
  return rows_bytes(g) + (size_t)nwarps * warp_words(g) * 4;
}

// One block's part of a batch of n queries (a16 [n, 16], fam [n], port
// [n] or null): every thread stages the group rows, warp `warp` of
// `nwarps` takes query b, and the block syncs once (so every thread of
// the block calls this, whatever its b). `smem`: block_bytes(t.g,
// nwarps), 16-byte aligned. -> the query's first match, t.r_cap or more
// when none; -1 on the warps whose b >= n, which may leave.
__device__ __forceinline__ int block_first_match(
    const Table& t, int32_t* smem, const uint8_t* a16, const int32_t* fam,
    const int32_t* port, int n, int b, int warp, int lane, int nwarps) {
  // step 1: the block's group rows, and beside them the query's inputs
  stage_rows(t, smem, warp * 32 + lane, nwarps * 32);
  __pipeline_commit();
  const bool live = b < n;  // warp-uniform
  const bool gate = port != nullptr;
  uint4 addr = make_uint4(0, 0, 0, 0);
  int f = -1, p = 0;
  if (live) {
    addr = __ldg(reinterpret_cast<const uint4*>(a16) + b);
    f = __ldg(fam + b);
    p = gate ? __ldg(port + b) : 0;
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // every thread's rows copied before any warp reads
  if (!live) return -1;
  int32_t* w = reinterpret_cast<int32_t*>(reinterpret_cast<uint8_t*>(smem) +
                                          rows_bytes(t.g)) +
               warp * warp_words(t.g);
  return first_match(t, rows_at(smem, t.g), w, w + t.g, addr, f, gate, p,
                     lane);
}

}  // namespace cidr
