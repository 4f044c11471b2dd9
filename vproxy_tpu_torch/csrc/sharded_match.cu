// The sharded winner reduction for Hopper (sm_90a): a batch of hint or
// CIDR queries against S rule shards, every (query, shard) pair and the
// winner across the shards in one launch per batch (B8).
//
// Replaces: vproxy_tpu/parallel/mesh.py `make_sharded_hint_fn` (:364),
// `make_sharded_cidr_fn` (:406) and `make_sharded_classify` (:449): the
// shard_map programs of the "jax-sharded" and "jax-fp-sharded" backends,
// where each device of the mesh's "rules" axis runs the single-shard
// matcher on its slice and the winner rides pmax / pmin collectives.
// Plain version: ops/sharded_cuda.py `hint_keys_plain` /
// `cidr_keys_plain` + `finish_plain` of this package, which tier-1
// holds int32-equal to the reference.
//
// What it computes. The tables are S per-shard tables compiled under
// one unified caps dict (vproxy_tpu/ops/hashmatch.py:816
// `_compile_sharded`), stacked on a leading shard axis; shard s holds
// the rules [s * size, (s + 1) * size) of the list. For shard s a query
// runs the unchanged single-shard routine on shard s's slice of the
// stacked arrays:
// * cuckoo hint: B3's `hint::warp_verdict` (hint_probe.cuh), over the
//   packed layout (ops/sharded_cuda.py `pack_hint_sharded`);
// * cuckoo CIDR (routes, ACL with its port gate): B4's
//   `cidr::first_match` over staged group rows (cidr_first.cuh);
// * fingerprint hint: B6's `fph::warp_best` (fp_hint.cuh);
// * fingerprint CIDR: B7's `fpc::warp_first` (fp_cidr.cuh).
// The global answer (mesh.py:383-393, :418-437):
// * hint: the highest level over the shards with a match, then among
//   the shards at that level the least global index s * size + idx;
//   -1 when the best level is 0 (a shard that matched at level 0 never
//   wins);
// * CIDR: the least global index, -1 for none.
// The classify form answers hint, routes and ACL in the columns of one
// int32 [B, 3].
//
// The reduction is decided in the kernel, on one 64-bit key per
// (query, column): hint key (level << 32) | (BIG - gidx) when the level
// is above 0, else 0; CIDR key BIG - gidx (the least index is the
// greatest key, so both columns reduce with one max, and one
// all_reduce(MAX) does for every column where the rules axis spans
// ranks). BIG = 2^30, the reference's sentinel, bounds gidx. The answer
// is BIG - (key & 0xffffffff), -1 for 0. A launch without `out` writes
// the keys: parallel/mesh.py reduces them across the ranks of the rules
// axis, then `vproxy_sharded_finish` is the last pass.
//
// Bound. The bytes the S shards' probes read, each shard as its own
// single-shard kernel reads them (chip_smoke.py `b8_work`: the batch's
// queries and answers once, each shard's table rows), over the 3.35
// TB/s HBM rate. As for B3 / B4 / B6 / B7, the time sits well above it:
// each (query, shard) pair walks the chain of dependent loads of its
// routine (4 steps for B3 / B4, 3 for B6 / B7), so what counts is how
// many chains are in flight together.
//
// Design. The grid is query tiles x columns. A block is WARPS warps;
// a query's S local shards are dealt over G = 1, 2 or 4 of them
// (`group_of`: shard j to warp j % G), so a block holds WARPS / G
// queries and up to four chains of one query run side by side instead
// of queuing in waves of blocks. A shard's slice of a stacked array is
// the array's base plus the shard times its stride (in elements, passed
// per pointer; 0 for a query array every shard shares). Each warp runs
// the single-shard routine on its shards: B3's `hint::warp_verdict`,
// B6's `fph::warp_best`, B4's `cidr::first_match` and B7's
// `fpc::warp_first` over the shard's group rows where the table keeps
// them (`rows_of`: read through L1; staging them would cost each block
// G shards' rows for one query). Each warp keeps the max key of its
// shards in a register; the block max-reduces a query's G keys in
// shared memory and writes the key or the answer once per (query,
// column): no atomics, no ticket, and no fill before the launch. S
// launches of the unsharded kernel and a torch max would answer the
// same, but pay S launches and a [S, B] round trip through memory.
//
// The interleaved form. Past one wave of blocks the split layout's
// warps queue (at B = 4096 and S = 4, 16,384 warps), and each of them
// leaves most lanes idle on a step (a query's live probes, pairs and
// candidates in one shard are few). There a column runs one warp a
// query over all S shards, through the routine's interleaved form
// beside it (`hint::warp_verdict_shards`, `cidr::first_match_shards`,
// `fpc::warp_first_shards`): the routine's steps once for all the
// shards, a step's items of every shard listed densely over the lanes
// and loaded at once, so every shard's step-k loads are in flight
// before any shard's step k + 1, and the batch takes 1 / G of the
// warps. Within one wave it answers later than the split layout (one
// warp walks S shards' items in more rounds, where the split layout
// had G warps side by side and the SMs to hold them), so the launcher
// picks, per column, the split layout while its grid fits HINT_WAVES
// (hint) or CIDR_WAVES (CIDR) waves of blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count), and
// the interleaved form past them (PERF.md has both layouts' times). The
// fingerprint hint column stays split: its interleaved form (every
// shard's query arrays staged by one warp) read slower at every batch
// size.
//
// The Maglev column (the PICK instances, `sharded_hash_kernel_pick` and
// `sharded_fp_kernel_pick`, with a ShardedPickArgs of their own, on a
// launch whose one column is the hint): B5's take folded in, so a
// classify+pick batch of "torch-sharded" or "torch-fp-sharded" is one
// launch. Replaces, with B5 (csrc/maglev_take.cu),
// vproxy_tpu/rules/maglev.py:235 `_device_take` on that path. The pick
// depends on no rule shard, so it never rides the cross-rank reduction:
// the kernel writes it rank-locally, in every layout and on both paths
// (answers or keys), into `pick` (row stride `ostride`): the writing
// warp (the first of a query's group, or the query's one warp in the
// interleaved form) loads the flow slot and gathers
// mtab[clamp(slot, 0, m - 1)] before its routine's first load, off the
// verdict's chain, and lane 0 stores the pick beside the verdict. With
// `out`, the verdicts go to column 0 of rows of `ostride` ints (the
// caller's int32 [B, 2] (verdict, pick)); with `keys`, the keys go as
// ever and `vproxy_sharded_finish` later writes the verdicts into the
// same rows. 12 bytes a flow more (an 8-byte slot read, a 4-byte pick
// written) and 4 for each distinct entry gathered.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "cidr_first.cuh"
#include "fp_cidr.cuh"
#include "fp_hint.cuh"
#include "hint_probe.cuh"

namespace {

constexpr int WARPS = 4;  // warps a block (the routines' own shape)
// blocks per SM the register budget must allow: <= 128 registers. With
// no such bound ptxas took 72 registers and spilled 8 bytes in one
// instance (a chip run's ptxas report).
constexpr int MIN_BLOCKS = 4;
// a fingerprint column alone needs fewer (B6 44, B7 56 registers): 6
// blocks an SM, <= 85 registers, keep the shard loop's pointers from
// costing B = 4096 a fifth of its warps (both columns at that bound
// spill: they keep MIN_BLOCKS)
constexpr int FP_MIN_BLOCKS = 6;
// the fingerprint CIDR column with its interleaved form spilled 4 bytes
// at 80 registers (a chip run's ptxas report): 5 blocks, <= 102
constexpr int FP_CIDR_MIN_BLOCKS = 5;
// Waves of blocks the split layout's grid may take before a column
// runs the interleaved form: one for a hint column, two for a CIDR
// column (whose interleaved form walks more rounds of pairs a warp).
// The H100 read both turns between B = 512 and 2048 at S = 4
// (chip_smoke.py --ab, phase_sharded_layouts; PERF.md).
constexpr int HINT_WAVES = 1;
constexpr int CIDR_WAVES = 2;
constexpr unsigned long long BIG = 1ull << 30;
constexpr int HASH_STRIDES = 24;  // FusedArgs' pointers hostb .. wu_idx
constexpr int CIDR_STRIDES = 10;  // cidr::Table's pointers
constexpr int FPH_STRIDES = 19;   // FpHintArgs' pointers rec .. has_uri
constexpr int FPC_STRIDES = 12;   // FpCidrArgs' table pointers g_mask4 ..

}  // namespace

// Every field in the order of the ctypes mirrors in
// ops/sharded_cuda.py; their sizes are checked against
// vproxy_sharded_*_args_size() at load.
struct ShardedHashArgs {
  hint::FusedArgs h;         // hint column at the launch's first shard;
                             // h.pk_meta null: no hint column
  cidr::Table c[2];          // CIDR columns at the first shard (pk_cslot
                             // null: none)
  const uint8_t* a16;        // [B, 16] addresses (CIDR columns)
  const int32_t* fam;        // [B] family, -1 for pad rows
  const int32_t* cport[2];   // [B] a column's port gate, or null
  unsigned long long* keys;  // [B, ncols] written once (no `out`)
  int32_t* out;              // [B, ncols], or null: the keys only
  long long hstride[HASH_STRIDES];     // elements per shard, 0: shared
  long long cstride[2][CIDR_STRIDES];
  int32_t b, ncols, s0;
  int32_t np, smem_words;    // set by the launcher
  int32_t size[3];           // shard size per column
};

struct ShardedFpArgs {
  fph::FpHintArgs h;         // hint column (h.rec null: none)
  fpc::FpCidrArgs c;         // CIDR column (c.rec null: none)
  unsigned long long* keys;  // [B, ncols] written once (no `out`)
  int32_t* out;              // [B, ncols], or null: the keys only
  long long hstride[FPH_STRIDES];
  long long cstride[FPC_STRIDES];
  int32_t b, ncols, s0;
  int32_t smem_words;        // set by the launcher
  int32_t size[2];           // shard size per column
};

// The Maglev column, a parameter of the PICK instances alone (the
// argument structs above stay as they were, and with them the code of
// every other instance: a kernel parameter grown by a column's fields
// changed the SASS of B9's verdict-only instance and cost it 7-9%; here
// it cost the CIDR columns 2-5%).
struct ShardedPickArgs {
  const int32_t* mtab;       // [m] Maglev table
  const int64_t* mslots;     // [B] flow slots (maglev.flow_slots)
  int32_t* pick;             // [B], stride ostride
  int32_t m, ostride;        // table size; out's and pick's row stride
};

namespace {

template <typename T>
__device__ __forceinline__ void shift(T*& p, long long stride, int j) {
  if (p != nullptr) p += stride * j;
}

// The launch's arguments moved to local shard j.
__device__ __forceinline__ hint::FusedArgs hint_at(const ShardedHashArgs& a,
                                                   int j) {
  hint::FusedArgs h = a.h;
  const long long* st = a.hstride;
  shift(h.hostb, st[0], j);
  shift(h.urib, st[1], j);
  shift(h.hlen, st[2], j);
  shift(h.ulen, st[3], j);
  shift(h.port, st[4], j);
  shift(h.has_host, st[5], j);
  shift(h.has_uri, st[6], j);
  shift(h.hp_len, st[7], j);
  shift(h.hp_slot1, st[8], j);
  shift(h.hp_slot2, st[9], j);
  shift(h.up_len, st[10], j);
  shift(h.up_slot1, st[11], j);
  shift(h.up_slot2, st[12], j);
  shift(h.slots, st[13], j);
  shift(h.pk_meta, st[14], j);
  shift(h.pk_bytes, st[15], j);
  shift(h.pk_hslot, st[16], j);
  shift(h.pk_hkey, st[17], j);
  shift(h.pk_uslot, st[18], j);
  shift(h.pk_ukey, st[19], j);
  shift(h.hb_items, st[20], j);
  shift(h.ub_items, st[21], j);
  shift(h.wh_idx, st[22], j);
  shift(h.wu_idx, st[23], j);
  return h;
}

__device__ __forceinline__ cidr::Table cidr_at(const ShardedHashArgs& a,
                                               int ci, int j) {
  cidr::Table t = a.c[ci];
  const long long* st = a.cstride[ci];
  shift(t.pk_cslot, st[0], j);
  shift(t.pk_cmeta, st[1], j);
  shift(t.s_key, st[2], j);
  shift(t.cb_items, st[3], j);
  shift(t.g_fam, st[4], j);
  shift(t.g_mask, st[5], j);
  shift(t.g_off, st[6], j);
  shift(t.g_capmask, st[7], j);
  shift(t.g_salt1, st[8], j);
  shift(t.g_salt2, st[9], j);
  return t;
}

__device__ __forceinline__ fph::FpHintArgs fp_hint_at(const ShardedFpArgs& a,
                                                      int j) {
  fph::FpHintArgs h = a.h;
  const long long* st = a.hstride;
  shift(h.rec, st[0], j);
  shift(h.wh_rec, st[1], j);
  shift(h.wu_rec, st[2], j);
  shift(h.hp_slot, st[3], j);
  shift(h.hp_fp1, st[4], j);
  shift(h.hp_fp2, st[5], j);
  shift(h.hp_level, st[6], j);
  shift(h.up_slot, st[7], j);
  shift(h.up_fp1, st[8], j);
  shift(h.up_fp2, st[9], j);
  shift(h.up_score, st[10], j);
  shift(h.um_fp1, st[11], j);
  shift(h.um_fp2, st[12], j);
  shift(h.um_score, st[13], j);
  shift(h.q_hmeta, st[14], j);
  shift(h.hlen, st[15], j);
  shift(h.port, st[16], j);
  shift(h.has_host, st[17], j);
  shift(h.has_uri, st[18], j);
  return h;
}

__device__ __forceinline__ fpc::FpCidrArgs fp_cidr_at(const ShardedFpArgs& a,
                                                      int j) {
  fpc::FpCidrArgs c = a.c;
  const long long* st = a.cstride;
  shift(c.g_mask4, st[0], j);
  shift(c.g_fam, st[1], j);
  shift(c.g_salt_s, st[2], j);
  shift(c.g_salt_f1, st[3], j);
  shift(c.g_salt_f2, st[4], j);
  shift(c.g_off, st[5], j);
  shift(c.g_capmask, st[6], j);
  shift(c.rec, st[7], j);
  shift(c.mrows, st[8], j);
  shift(c.t_l0, st[9], j);
  shift(c.t_l1, st[10], j);
  shift(c.t_l2, st[11], j);
  return c;
}

__device__ __forceinline__ unsigned long long hint_key(int level, int s,
                                                       int size, int idx) {
  const unsigned long long g = (unsigned long long)s * size + idx;
  return level > 0 ? ((unsigned long long)level << 32) | (BIG - g) : 0ull;
}

__device__ __forceinline__ unsigned long long cidr_key(int s, int size,
                                                       int idx) {
  return BIG - ((unsigned long long)s * size + idx);
}

__device__ __forceinline__ int answer(unsigned long long k) {
  return k != 0 ? (int)(BIG - (k & 0xffffffffull)) : -1;
}

// Warps a query takes: its S shards are dealt over G warps of the
// block (shard j to warp j % G), so up to four chains of one query run
// side by side; WARPS / G queries a block.
__host__ __device__ constexpr int group_of(int shards) {
  return shards == 1 ? 1 : (shards == 2 ? 2 : WARPS);
}

// The per-warp keys of the block's queries, max-reduced through shared
// memory: the first warp of each query's group writes its one key (no
// output) or answer once. Every thread of the block calls it.
__device__ __forceinline__ void write_key(unsigned long long key, int warp,
                                          int lane, int g_warps, int q,
                                          int b, int ncols, int col,
                                          unsigned long long* keys,
                                          int32_t* out) {
  __shared__ unsigned long long s_key[WARPS];
  if (lane == 0) s_key[warp] = key;
  __syncthreads();
  if (warp % g_warps != 0 || lane != 0 || q >= b) return;
  for (int i = 1; i < g_warps; ++i) key = max(key, s_key[warp + i]);
  const size_t o = (size_t)q * ncols + col;
  if (out != nullptr)
    out[o] = answer(key);
  else
    keys[o] = key;
}

// One (query, column)'s key or answer, written by lane 0 of the one
// warp that holds it (the interleaved form).
__device__ __forceinline__ void write_once(unsigned long long key, int lane,
                                           int q, int ncols, int col,
                                           unsigned long long* keys,
                                           int32_t* out) {
  if (lane != 0) return;
  const size_t o = (size_t)q * ncols + col;
  if (out != nullptr)
    out[o] = answer(key);
  else
    keys[o] = key;
}

// Query q's Maglev pick (every lane loads the same slot and entry: one
// broadcast each).
template <class A>
__device__ __forceinline__ int pick_of(const A& a, int q) {
  return fph::maglev_at(
      a.mtab, a.m, __ldg(reinterpret_cast<const long long*>(a.mslots) + q));
}

// The shard views the interleaved forms take: shard j's arguments and
// the key a winner takes.
struct HintShards {
  const ShardedHashArgs& a;
  __device__ __forceinline__ hint::FusedArgs at(int j) const {
    return hint_at(a, j);
  }
  __device__ __forceinline__ bool shared_windows() const {
    return a.hstride[0] == 0 && a.hstride[1] == 0;
  }
  __device__ __forceinline__ unsigned long long key(int level, int j,
                                                    int idx) const {
    return hint_key(level, a.s0 + j, a.size[0], idx);
  }
};

struct CidrShards {
  const ShardedHashArgs& a;
  int ci, col;
  __device__ __forceinline__ cidr::Table at(int j) const {
    return cidr_at(a, ci, j);
  }
  __device__ __forceinline__ unsigned long long key(int j, int idx) const {
    return cidr_key(a.s0 + j, a.size[col], idx);
  }
};

struct FpCidrShards {
  const ShardedFpArgs& a;
  int col;
  __device__ __forceinline__ fpc::FpCidrArgs at(int j) const {
    return fp_cidr_at(a, j);
  }
  __device__ __forceinline__ unsigned long long key(int j, int idx) const {
    return cidr_key(a.s0 + j, a.size[col], idx);
  }
};

// HINT / CIDR: the launch has a hint column / a CIDR column (an
// instance without a kind holds none of its code, nor its registers).
// Bit c of `inter`: column c runs the interleaved form (a warp a query
// over every shard), else a query's shards over group_of(shards) warps.
template <bool URI, int W, bool HINT, bool CIDR>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
sharded_hash_kernel(const ShardedHashArgs a, int shards, int inter) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if ((inter >> blockIdx.y) & 1) {  // block-uniform
    const int q = blockIdx.x * WARPS + warp, col = blockIdx.y;
    if (q >= a.b) return;  // warp-uniform; no block sync on this path
    unsigned long long key = 0;
    if (HINT && col == 0) {
      key = hint::warp_verdict_shards<URI, W>(
          HintShards{a}, shards, smem + warp * a.smem_words, q, a.np, lane);
    } else if (CIDR) {
      const int ci = col - (HINT ? 1 : 0);
      const int g = a.c[ci].g;
      int32_t* w = smem + warp * cidr::shards_warp_words(g, shards);
      const bool gate = a.cport[ci] != nullptr;
      const uint4 addr = __ldg(reinterpret_cast<const uint4*>(a.a16) + q);
      const int f = __ldg(a.fam + q);
      const int p = gate ? __ldg(a.cport[ci] + q) : 0;
      key = cidr::first_match_shards(CidrShards{a, ci, col}, shards, w,
                                     w + shards * g,
                                     w + shards * g + cidr::LIST, addr, f,
                                     gate, p, lane);
    }
    write_once(key, lane, q, a.ncols, col, a.keys, a.out);
    return;
  }
  const int gw = group_of(shards);
  const int q = blockIdx.x * (WARPS / gw) + warp / gw;
  const int g = warp % gw;  // this warp's first shard
  const int col = blockIdx.y;
  unsigned long long key = 0;
  if (HINT && col == 0) {  // the hint column is column 0
    if (q < a.b) {  // warp-uniform; no block sync on this path
      for (int j = g; j < shards; j += gw) {
        const hint::FusedArgs h = hint_at(a, j);
        int bl, bi;
        hint::warp_verdict<URI, W, false>(h, smem + warp * a.smem_words, q,
                                          a.np, lane, bl, bi);
        key = max(key, hint_key(bl, a.s0 + j, a.size[col], bi));
      }
    }
  } else if (CIDR) {  // the group rows read where each shard keeps them
    const int ci = col - (HINT ? 1 : 0);
    int32_t* lists = smem + warp * cidr::warp_words(a.c[ci].g);
    const bool gate = a.cport[ci] != nullptr;
    if (q < a.b) {  // warp-uniform; no block sync on this path
      const uint4 addr = __ldg(reinterpret_cast<const uint4*>(a.a16) + q);
      const int f = __ldg(a.fam + q);
      const int p = gate ? __ldg(a.cport[ci] + q) : 0;
      for (int j = g; j < shards; j += gw) {
        const cidr::Table t = cidr_at(a, ci, j);
        const int m = cidr::first_match(t, cidr::rows_of(t), lists,
                                        lists + t.g, addr, f, gate, p, lane);
        if (m >= 0 && m < t.r_cap)
          key = max(key, cidr_key(a.s0 + j, a.size[col], m));
      }
    }
  }
  write_key(key, warp, lane, gw, q, a.b, a.ncols, col, a.keys, a.out);
}

// The hint column with its Maglev column (no CIDR column): the kernel
// above's hint paths, each warp that writes an answer also loading its
// query's flow slot and Maglev entry before its routine and storing the
// pick beside the answer. A kernel of its own (not a template flag of
// the one above) so that every instance above stays as it was: wrapping
// their body in a function shared with this one changed the SASS of the
// CIDR instances.
template <bool URI, int W>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
sharded_hash_kernel_pick(const ShardedHashArgs a, const ShardedPickArgs pa,
                         int shards, int inter) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // out's rows hold the picks beside the answers; the keys' do not
  const int os = a.out != nullptr ? pa.ostride : a.ncols;
  if (inter & 1) {  // block-uniform: the interleaved form
    const int q = blockIdx.x * WARPS + warp;
    if (q >= a.b) return;  // warp-uniform; no block sync on this path
    const int pick = pick_of(pa, q);  // before the routine
    const unsigned long long key = hint::warp_verdict_shards<URI, W>(
        HintShards{a}, shards, smem + warp * a.smem_words, q, a.np, lane);
    write_once(key, lane, q, os, 0, a.keys, a.out);
    if (lane == 0) pa.pick[(size_t)q * pa.ostride] = pick;
    return;
  }
  const int gw = group_of(shards);
  const int q = blockIdx.x * (WARPS / gw) + warp / gw;
  const int g = warp % gw;  // this warp's first shard
  // the writing warp's pick, before its routine (warp-uniform branch)
  const bool picks = g == 0 && q < a.b;
  const int pick = picks ? pick_of(pa, q) : 0;
  unsigned long long key = 0;
  if (q < a.b) {  // warp-uniform; no block sync on this path
    for (int j = g; j < shards; j += gw) {
      const hint::FusedArgs h = hint_at(a, j);
      int bl, bi;
      hint::warp_verdict<URI, W, false>(h, smem + warp * a.smem_words, q,
                                        a.np, lane, bl, bi);
      key = max(key, hint_key(bl, a.s0 + j, a.size[0], bi));
    }
  }
  write_key(key, warp, lane, gw, q, a.b, os, 0, a.keys, a.out);
  if (picks && lane == 0) pa.pick[(size_t)q * pa.ostride] = pick;
}

// Bit c of `inter` as above; the hint column has no interleaved form
// (it read slower at every batch size: PERF.md). PICK as above.
template <bool HINT, bool CIDR, bool PICK>
__device__ __forceinline__ void fp_block(const ShardedFpArgs& a,
                                         const ShardedPickArgs& pa,
                                         int shards, int inter) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int os = PICK && a.out != nullptr ? pa.ostride : a.ncols;
  if (CIDR && ((inter >> blockIdx.y) & 1)) {  // block-uniform
    const int q = blockIdx.x * WARPS + warp, col = blockIdx.y;
    if (q >= a.b) return;  // warp-uniform; no block sync on this path
    const bool gate = a.c.mrows != nullptr && a.c.port != nullptr;
    const uint4 addr = __ldg(reinterpret_cast<const uint4*>(a.c.a16) + q);
    const int f = __ldg(a.c.fam + q);
    const int p = gate ? __ldg(a.c.port + q) : 0;
    const unsigned long long key = fpc::warp_first_shards(
        FpCidrShards{a, col}, shards,
        smem + (size_t)warp * fpc::shards_warp_words(a.c.g, shards), addr,
        f, p, lane);
    write_once(key, lane, q, os, col, a.keys, a.out);
    return;
  }
  const int gw = group_of(shards);
  const int q = blockIdx.x * (WARPS / gw) + warp / gw;
  const int g = warp % gw;
  const int col = blockIdx.y;
  // the writing warp's pick, before its routine (warp-uniform branch)
  const bool picks = PICK && g == 0 && q < a.b;
  const int pick = picks ? pick_of(pa, q) : 0;
  unsigned long long key = 0;
  if (HINT && col == 0) {  // the hint column is column 0
    if (q < a.b) {  // warp-uniform; no block sync on this path
      for (int j = g; j < shards; j += gw) {
        const fph::FpHintArgs h = fp_hint_at(a, j);
        const int best =
            fph::warp_best(h, smem + (size_t)warp * a.smem_words, q, lane);
        if (best > 0)
          key = max(key, hint_key(best / (h.r_cap + 1), a.s0 + j,
                                  a.size[col],
                                  h.r_cap - best % (h.r_cap + 1)));
      }
    }
  } else if (CIDR) {  // the group rows read where each shard keeps them
    int32_t* lists = smem + warp * fpc::warp_words(a.c.g);
    const bool gate = a.c.mrows != nullptr && a.c.port != nullptr;
    if (q < a.b) {  // warp-uniform; no block sync on this path
      const uint4 addr = __ldg(reinterpret_cast<const uint4*>(a.c.a16) + q);
      const int f = __ldg(a.c.fam + q);
      const int p = gate ? __ldg(a.c.port + q) : 0;
      for (int j = g; j < shards; j += gw) {
        const fpc::FpCidrArgs c = fp_cidr_at(a, j);
        const int m = fpc::warp_first(c, fpc::rows_of(c), lists, addr, f, p,
                                      lane);
        if (m >= 0 && m < c.r_cap)
          key = max(key, cidr_key(a.s0 + j, a.size[col], m));
      }
    }
  }
  write_key(key, warp, lane, gw, q, a.b, os, col, a.keys, a.out);
  if (picks && lane == 0) pa.pick[(size_t)q * pa.ostride] = pick;
}

template <bool HINT, bool CIDR>
__global__ void __launch_bounds__(WARPS * 32,
                                  HINT && CIDR ? MIN_BLOCKS
                                  : HINT       ? FP_MIN_BLOCKS
                                               : FP_CIDR_MIN_BLOCKS)
sharded_fp_kernel(const ShardedFpArgs a, int shards, int inter) {
  fp_block<HINT, CIDR, false>(a, ShardedPickArgs{}, shards, inter);
}

// The fingerprint hint column with its Maglev column.
__global__ void __launch_bounds__(WARPS * 32, FP_MIN_BLOCKS)
sharded_fp_kernel_pick(const ShardedFpArgs a, const ShardedPickArgs pa,
                       int shards, int inter) {
  fp_block<true, false, true>(a, pa, shards, inter);
}

// n keys (rows of ncols) -> answers in rows of ostride ints.
__global__ void sharded_finish_kernel(const unsigned long long* keys,
                                      int32_t* out, int n, int ncols,
                                      int ostride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[(size_t)(i / ncols) * ostride + i % ncols] = answer(keys[i]);
}

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// A per-shard stride (elements of `elem` bytes) that keeps every
// shard's slice as aligned as the base.
bool stride_ok(long long stride, size_t elem, size_t n) {
  return stride >= 0 && ((size_t)stride * elem) % n == 0;
}

// The grid of a launch: WARPS / group_of(shards) queries a block, one
// block row per column; WARPS queries a block when every column runs
// the interleaved form (`inter` holds a bit for each of `ncols`).
dim3 grid_of(int b, int shards, int ncols, int inter) {
  const int qpb = inter == (1 << ncols) - 1 ? WARPS : WARPS / group_of(shards);
  return dim3((b + qpb - 1) / qpb, ncols);
}

// The layouts a launch may ask for: the launcher's choice, a query's
// shards over group_of(shards) warps, or the interleaved form.
enum Layout { AUTO = 0, SPLIT = 1, INTERLEAVED = 2 };

// The waves of `kern`'s blocks (`smem` bytes a block) on `device` that
// the split layout's grid of b queries over `shards` shards takes; 0
// when the card cannot say. Within a few waves the split layout
// answers sooner (its chains run in more warps side by side); past
// them the interleaved form takes 1 / group_of(shards) of the warps,
// so fewer waves.
template <class K>
double split_waves(K kern, int b, int shards, size_t smem, int device) {
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, WARPS * 32,
                                                    smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess || per_sm * sms <= 0)
    return 0.0;
  return (double)grid_of(b, shards, 1, 0).x / ((double)per_sm * sms);
}

using HashKernel = void (*)(const ShardedHashArgs, int, int);
using HashPickKernel = void (*)(const ShardedHashArgs, const ShardedPickArgs,
                                int, int);

template <int W>
HashKernel hash_kernel_word(bool uri, bool cidr) {
  if (uri && cidr) return sharded_hash_kernel<true, W, true, true>;
  if (uri) return sharded_hash_kernel<true, W, true, false>;
  if (cidr) return sharded_hash_kernel<false, W, true, true>;
  return sharded_hash_kernel<false, W, true, false>;
}

// The instance of a launch: the hint column's compare word and uri
// half, and whether it has a CIDR column.
HashKernel hash_kernel(bool hint, int word, bool uri, bool cidr) {
  if (!hint) return sharded_hash_kernel<false, 16, false, true>;
  switch (word) {
    case 16: return hash_kernel_word<16>(uri, cidr);
    case 8: return hash_kernel_word<8>(uri, cidr);
    case 4: return hash_kernel_word<4>(uri, cidr);
    default: return hash_kernel_word<1>(uri, cidr);
  }
}

// The instance of a launch with the Maglev column (the hint column
// alone): its compare word and uri half.
HashPickKernel hash_pick_kernel(int word, bool uri) {
  switch (word) {
    case 16: return uri ? sharded_hash_kernel_pick<true, 16>
                        : sharded_hash_kernel_pick<false, 16>;
    case 8: return uri ? sharded_hash_kernel_pick<true, 8>
                       : sharded_hash_kernel_pick<false, 8>;
    case 4: return uri ? sharded_hash_kernel_pick<true, 4>
                       : sharded_hash_kernel_pick<false, 4>;
    default: return uri ? sharded_hash_kernel_pick<true, 1>
                        : sharded_hash_kernel_pick<false, 1>;
  }
}

// A Maglev column (null: none): its table, slots and output, on a
// launch whose one column is the hint.
bool pick_ok(const ShardedPickArgs* p, int ncols, bool hint_col) {
  return p == nullptr ||
         (hint_col && ncols == 1 && p->mtab != nullptr &&
          p->mslots != nullptr && p->pick != nullptr && p->m > 0 &&
          p->ostride >= 1);
}

}  // namespace

extern "C" int vproxy_sharded_hash_args_size() {
  return (int)sizeof(ShardedHashArgs);
}
extern "C" int vproxy_sharded_fp_args_size() {
  return (int)sizeof(ShardedFpArgs);
}
extern "C" int vproxy_sharded_pick_args_size() {
  return (int)sizeof(ShardedPickArgs);
}

// Launch on `stream` (PyTorch's current stream; no synchronisation)
// over `shards` local shards in `layout` (AUTO, per column: the split
// layout while its grid fits HINT_WAVES / CIDR_WAVES waves, else the
// interleaved form; S = 1 stays split). Returns cudaGetLastError() after the launch: 0 when it was
// accepted; cudaErrorInvalidValue, before any launch, for an unknown
// layout, a column count that disagrees with the tables, a hint
// compare word that does not divide the windows or align the byte
// tables and every shard's slice of them, a CIDR table that is empty or
// whose 16-byte rows (or a shard's slice of them) are off 16 bytes, a
// Maglev column (`pick`, null: none) without its table (m <= 0),
// slots, output or a row stride, or beside another column than the
// hint (`pick_ok`), or more shared memory than a launch may take unasked
// (48 KB).
extern "C" int vproxy_sharded_hash(const ShardedHashArgs* args,
                                   const ShardedPickArgs* pick, int shards,
                                   int layout, int uri_rules, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ShardedHashArgs a = *args;
  if (a.b <= 0) return 0;
  if (shards <= 0 || layout < AUTO || layout > INTERLEAVED)
    return (int)cudaErrorInvalidValue;
  const bool hint_col = a.h.pk_meta != nullptr;
  const bool shared_windows = a.hstride[0] == 0 && a.hstride[1] == 0;
  int nc = 0;
  size_t split = 0;  // bytes a block in the split layout
  if (hint_col) {
    const hint::FusedArgs& h = a.h;
    a.np = 2 * h.maxp + (uri_rules ? 2 * h.lw : 0);
    const int w = h.word;
    const long long* st = a.hstride;
    const bool ok_w =
        (w == 16 || w == 8 || w == 4 || w == 1) && h.hw % w == 0 &&
        h.hw <= hint::MAX_HW && aligned(h.pk_bytes, w) &&
        aligned(h.pk_hkey, w) && stride_ok(st[15], 1, w) &&
        stride_ok(st[17], 1, w) && aligned(h.pk_meta, 16) &&
        aligned(h.pk_hslot, 16) && stride_ok(st[14], 4, 16) &&
        stride_ok(st[16], 4, 16) &&
        (!uri_rules || (h.uw % w == 0 && h.uw <= hint::MAX_UW &&
                        h.ukw == h.uw && aligned(h.pk_ukey, w) &&
                        stride_ok(st[19], 1, w) && aligned(h.pk_uslot, 16) &&
                        stride_ok(st[18], 4, 16)));
    if (!ok_w || h.b != a.b || h.mtab != nullptr || a.np <= 0)
      return (int)cudaErrorInvalidValue;
    split = (size_t)4 * WARPS * hint::warp_smem_words(h, a.np, uri_rules);
  }
  for (int i = 0; i < 2; ++i) {
    const cidr::Table& t = a.c[i];
    if (t.pk_cslot == nullptr) continue;
    if (i != nc) return (int)cudaErrorInvalidValue;  // columns in order
    const long long* st = a.cstride[i];
    if (t.ct <= 0 || t.r_cap <= 0 || t.cb <= 0 || t.g <= 0 ||
        a.fam == nullptr || !aligned(a.a16, 16) ||
        !aligned(t.pk_cslot, 16) || !aligned(t.pk_cmeta, 16) ||
        !aligned(t.s_key, 16) || !aligned(t.g_mask, 16) ||
        !stride_ok(st[0], 4, 16) || !stride_ok(st[1], 4, 16) ||
        !stride_ok(st[2], 1, 16) || !stride_ok(st[5], 1, 16))
      return (int)cudaErrorInvalidValue;
    split = std::max(split, (size_t)4 * WARPS * cidr::warp_words(t.g));
    ++nc;
  }
  if (a.ncols != (hint_col ? 1 : 0) + nc || a.ncols <= 0 ||
      !pick_ok(pick, a.ncols, hint_col))
    return (int)cudaErrorInvalidValue;
  const HashKernel kern = hash_kernel(hint_col, a.h.word,
                                      hint_col && uri_rules, nc > 0);
  const HashPickKernel pkern =
      pick != nullptr ? hash_pick_kernel(a.h.word, uri_rules) : nullptr;
  // bit c: column c runs the interleaved form
  const double waves =
      layout == AUTO && shards > 1
          ? (pkern != nullptr
                 ? split_waves(pkern, a.b, shards, split, device)
                 : split_waves(kern, a.b, shards, split, device))
          : 0.0;
  int mask = 0;
  for (int c = 0; c < a.ncols; ++c)
    if (layout == INTERLEAVED ||
        waves > (hint_col && c == 0 ? HINT_WAVES : CIDR_WAVES))
      mask |= 1 << c;
  size_t smem = 0;
  if (hint_col) {
    a.smem_words = (mask & 1) ? hint::shards_smem_words(a.h, a.np, uri_rules,
                                                        shards,
                                                        shared_windows)
                              : hint::warp_smem_words(a.h, a.np, uri_rules);
    smem = (size_t)4 * WARPS * a.smem_words;
  }
  for (int i = 0; i < nc; ++i) {
    const int c = i + (hint_col ? 1 : 0);
    smem = std::max(smem, (size_t)4 * WARPS *
                              ((mask >> c) & 1
                                   ? cidr::shards_warp_words(a.c[i].g, shards)
                                   : cidr::warp_words(a.c[i].g)));
  }
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(a.b, shards, a.ncols, mask);
  if (pkern != nullptr)
    pkern<<<grid, WARPS * 32, smem, s>>>(a, *pick, shards, mask);
  else
    kern<<<grid, WARPS * 32, smem, s>>>(a, shards, mask);
  return (int)cudaGetLastError();
}

// The fingerprint tables' form (B6 / B7's routines); errors as above,
// with B6's and B7's own checks (fp_hint.cu, fp_cidr.cu) per column.
extern "C" int vproxy_sharded_fp(const ShardedFpArgs* args,
                                 const ShardedPickArgs* pick, int shards,
                                 int layout, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ShardedFpArgs a = *args;
  if (a.b <= 0) return 0;
  if (shards <= 0 || layout < AUTO || layout > INTERLEAVED)
    return (int)cudaErrorInvalidValue;
  const bool hint_col = a.h.rec != nullptr;
  const bool cidr_col = a.c.rec != nullptr;
  size_t hint_smem = 0, split = 0, inter_smem = 0;
  if (hint_col) {
    const fph::FpHintArgs& h = a.h;
    a.smem_words = fph::warp_words(h);
    const long long* st = a.hstride;
    if (h.b != a.b || h.rows <= 0 || h.w <= 0 || h.p <= 0 || h.u <= 0 ||
        h.whc <= 0 || h.wuc <= 0 || h.he <= 0 || h.ue <= 0 || h.hm <= 0 ||
        h.um <= 0 || h.r_cap <= 0 || h.rw % 2 != 0 ||
        h.he * (2 + 4 * h.hm) > h.rw || h.ue * (2 + 4 * h.um) > h.rw ||
        (long long)h.rows * h.rw >= (1ll << 31) ||
        (h.um_fp1 != nullptr && h.l <= 0) || !aligned(h.rec, 8) ||
        !aligned(h.wh_rec, 8) || !aligned(h.wu_rec, 8) ||
        !stride_ok(st[0], 4, 8) || !stride_ok(st[1], 4, 8) ||
        !stride_ok(st[2], 4, 8))
      return (int)cudaErrorInvalidValue;
    hint_smem = (size_t)WARPS * a.smem_words * 4;
  }
  if (cidr_col) {
    const fpc::FpCidrArgs& c = a.c;
    const long long* st = a.cstride;
    if (c.b != a.b || c.ct <= 0 || c.e <= 0 || c.r_cap <= 0 || c.g < 0 ||
        !aligned(c.a16, 16) || !aligned(c.g_mask4, 16) ||
        !aligned(c.rec, 16) || !stride_ok(st[0], 4, 16) ||
        !stride_ok(st[7], 4, 16) ||
        (c.mrows != nullptr &&
         (c.nm <= 0 || c.mk <= 0 || !aligned(c.mrows, 8) ||
          !stride_ok(st[8], 4, 8))) ||
        (c.t_l0 != nullptr && (c.s1 <= 0 || c.s2 <= 0)))
      return (int)cudaErrorInvalidValue;
    split = (size_t)4 * WARPS * fpc::warp_words(c.g);
    inter_smem = (size_t)4 * WARPS * fpc::shards_warp_words(c.g, shards);
  }
  if (a.ncols != (hint_col ? 1 : 0) + (cidr_col ? 1 : 0) || a.ncols <= 0 ||
      !pick_ok(pick, a.ncols, hint_col))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pick != nullptr) {  // the hint column alone: split, no CIDR column
    if (hint_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    sharded_fp_kernel_pick<<<grid_of(a.b, shards, 1, 0), WARPS * 32,
                             hint_smem, s>>>(a, *pick, shards, 0);
    return (int)cudaGetLastError();
  }
  void (*kern)(const ShardedFpArgs, int, int) =
      hint_col && cidr_col ? sharded_fp_kernel<true, true>
      : hint_col           ? sharded_fp_kernel<true, false>
                           : sharded_fp_kernel<false, true>;
  // the CIDR column only: the hint column has no interleaved form
  const bool inter =
      cidr_col && (layout == INTERLEAVED ||
                   (layout == AUTO && shards > 1 &&
                    split_waves(kern, a.b, shards,
                                std::max(hint_smem, split), device) >
                        CIDR_WAVES));
  const size_t smem = std::max(hint_smem, inter ? inter_smem : split);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int mask = inter ? 1 << (a.ncols - 1) : 0;
  kern<<<grid_of(a.b, shards, a.ncols, mask), WARPS * 32, smem, s>>>(
      a, shards, mask);
  return (int)cudaGetLastError();
}

// The last pass of a launch made without `out`, after the keys were
// reduced across ranks: n keys (rows of ncols) -> n answers, in rows of
// `ostride` ints (ncols; 2 where a Maglev column's picks already fill
// column 1). cudaErrorInvalidValue for ncols <= 0 or ostride < ncols.
extern "C" int vproxy_sharded_finish(const unsigned long long* keys,
                                     int32_t* out, int n, int ncols,
                                     int ostride, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ncols <= 0 || ostride < ncols) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sharded_finish_kernel<<<(n + 255) / 256, 256, 0, s>>>(keys, out, n, ncols,
                                                        ostride);
  return (int)cudaGetLastError();
}
