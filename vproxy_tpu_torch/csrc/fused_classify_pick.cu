// Fused classify+pick for Hopper (sm_90a): hint verdict + Maglev pick,
// and, when the launch carries a packed cidr table, the CIDR route too,
// one launch per batch.
//
// Replaces: vproxy_tpu/ops/fused_pallas.py:56 `_fused_kernel` (entry
// `fused_classify_pick_pallas`), the Pallas kernel of the same contract.
// Reference semantics: ops/fused.py `fused_classify_pick` of this
// package (the plain torch tier), bit for bit, in its [B, 2] form and
// in its [B, 3] form (vproxy_tpu/ops/fused.py:304 with `ct`, the route
// column of rules/engine.py `fused_dispatch_all`).
//
// The route column. When the launch carries a cidr table (a non-null
// pk_cslot: a run-time flag, so the instances stay 8), the grid is twice
// as long: its first half computes the hint verdicts and picks as
// below, its second half the same queries' first-match routes with
// B4's block routine (cidr_first.cuh `block_first_match`, whose note
// gives its design, chain and bound), WARPS queries per block. The two
// chains of dependent loads run side by side, in blocks the SMs hold at
// once, instead of one after the other in one warp: the hint phase
// already takes the 64 registers, so a warp cannot hold the route's
// probes through it, and walking the route after the hint fold added
// its whole chain to the hint's (PERF.md has both designs' times). A
// hint block runs exactly the [B, 2] code and writes columns 0-1;
// without a cidr table the grid, the shared memory and the work are the
// [B, 2] kernel's.
//
// The verdict-only mode (B3). When the launch carries no Maglev column
// (a null mtab) the kernel is vproxy_tpu/ops/hashmatch.py:516
// `hint_hash_match`: it never reads `slots` or `mtab` and writes (rule
// index, level) per query, the level 0 where the index is -1. The fold
// already keeps the best level beside its index (max level, then the
// least index: _reduce_best's winner in both of its branches, whatever
// r_cap), so this mode only skips the Maglev loads and stores the level
// where the pick would go. Its bound and chain are the [B, 2] kernel's
// less the Maglev entry. The mode is a template flag (PICK = false:
// 8 more instances of the same body, which the null mtab selects at
// launch), not a run-time branch: as a run-time flag it took one more
// register in an instance and read 3.8% slower on B1 at B = 512 in a
// chip run (PERF.md), so B1's own instances now compile exactly
// as before.

// Bound. Per query the kernel reads its query windows and probe slots
// (~0.3 KB), one packed cuckoo slot row + key row per valid probe, the
// bucket items of live buckets, one 32 B meta row + one (hw+uw) B byte
// row per live candidate rule, then one 4 B Maglev entry. The work is
// byte compares and a few integer ops per candidate, so the floor is
// the distinct table bytes a batch touches over the 3.35 TB/s HBM rate
// (chip_smoke.py `work()`); at the north-star size (100k rules, 22.7 MB
// packed) the table also fits the 50 MB L2. Well above that floor, the
// time is set by latency: the chain of dependent global loads one query
// walks. That chain is what this design keeps short.
//
// Chain depth (dependent global-load steps per query, lane 0's store
// not counted). The first port (this file before the redesign; its
// SASS shows each byte loop as LDG.U8 -> LDS.U8 -> branch) compared
// bytes one load at a time with an early exit and walked a lane's
// candidates one after another: 1 (windows) + 3 (slot index, the slot
// record's length, its start and count after the compare) + min(plen,
// kw) key bytes, then per live candidate of a lane 3 (bucket item, the
// meta row's halves before and after the host bytes) + min(hl, hw) +
// min(ul, uw) row bytes, then 2 (Maglev slot and entry, after the
// reduction): 68 steps for a 26-byte host and a 7-byte uri with one
// live candidate per lane, 104 with two (most of them L1 hits).
// Here it is 4, whatever the key lengths, while a key fits the first
// compare step (32 B of host, 16 B of uri; 16 B and 8 B in 1-byte
// words), a query has at most 32 probes, 128 bucket and wildcard
// entries and 32 live candidates:
//   1. the query's windows, scalars, first probes and Maglev slot;
//   2. each probe's slot record and key words together (both depend on
//      the slot alone), and the Maglev entry;
//   3. the rule index of every bucket entry of every live probe and of
//      every wildcard entry, GROUP per lane at once;
//   4. each live candidate's meta row and byte row words together, one
//      candidate per lane, then score and fold.
// A longer key adds one step per further compare step it reaches; each
// further 32 probes, 128 entries or 32 candidates adds steps too.
//
// Design:
// * one warp per query, WARPS queries per block; registers capped at
//   64 (MIN_BLOCKS) so B = 4096 is one wave of 32 warps per SM;
// * byte windows are compared as W-byte words (W = 16, 8, 4 or 1,
//   chosen per table by ops/fused_cuda.py `word_bytes` so every row,
//   window and base is W-aligned): each word is XORed with the query's
//   word from shared memory (a broadcast), masked to the compare
//   length and tested for zero; every word of a step is loaded before
//   any is tested, and there is no early exit;
// * phase 1 leaves (bucket start, live count) per probe in shared
//   memory, so a probe's key compare runs once, not once per bucket
//   slot; phase 2 lists the live bucket entries at their prefix sum
//   over the probes (a shuffle scan) followed by the wildcard entries,
//   so lanes load only entries that exist, compacts the rule indices
//   >= 0 with a ballot, and folds the candidates with the tie rule of
//   fused_pallas.py:109-116 (strictly greater level wins, among equal
//   positive levels the smaller index) and a shuffle reduction;
// * uri-free tables (no pk_uslot) run the URI=false instances, which
//   have no uri work at all;
// * every gathered index is clamped where the reference clamps it.
//   Candidates with index < 0 score level 0 in the reference, and a
//   level-0 pair never changes the fold, so they are dropped at the
//   compaction.
//
// What Hopper's other tools would do here. wgmma and the tensor cores
// multiply tiles; this kernel has byte compares and no products. TMA
// moves a tile at given coordinates into shared memory and signals an
// mbarrier; this kernel gathers scattered 16 B slot records, 32 B meta
// rows and (hw+uw) B byte rows chosen by data, one of each per
// candidate, so a TMA issue and an mbarrier wait per row would add a
// step to the chain each row sits on. Plain vector loads (LDG.128
// through the read-only path), all of a step's issued before any is
// used, are the shortest chain; shared memory holds only the query's
// windows and the per-probe results a warp shares.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cidr_first.cuh"

namespace {

constexpr int WARPS = 4;          // queries per block
constexpr int MIN_BLOCKS = 8;     // blocks per SM: <= 64 registers
constexpr int HOST_SHIFT = 10;    // level = (host << 10) + uri
constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUP = 4;          // candidate slots per lane per step
constexpr int LIST = GROUP * 32;  // entry list length per warp
constexpr int MAX_HW = 96;        // widest windows a warp copies (3 and
constexpr int MAX_UW = 128;       // 4 bytes per lane)

}  // namespace

// Every pointer first, then every int: the ctypes mirror in
// ops/fused_cuda.py has the same order, and its size is checked
// against vproxy_fused_args_size() at load.
struct FusedArgs {
  // query batch
  const uint8_t* hostb;     // [B, hw] reversed host window
  const uint8_t* urib;      // [B, uw] uri window
  const int32_t* hlen;      // [B]
  const int32_t* ulen;      // [B]
  const int32_t* port;      // [B]
  const bool* has_host;     // [B]
  const bool* has_uri;      // [B]
  const int32_t* hp_len;    // [B, maxp]
  const int32_t* hp_slot1;  // [B, maxp]
  const int32_t* hp_slot2;  // [B, maxp]
  const int32_t* up_len;    // [B, lw]
  const int32_t* up_slot1;  // [B, lw]
  const int32_t* up_slot2;  // [B, lw]
  const int64_t* slots;     // [B] Maglev slots (null: verdict-only)
  // packed tables
  const int32_t* pk_meta;   // [r_cap, 8]
  const uint8_t* pk_bytes;  // [r_cap, pk_w]
  const int32_t* pk_hslot;  // [n_hslot, 4]
  const uint8_t* pk_hkey;   // [n_hslot, hw]
  const int32_t* pk_uslot;  // [n_uslot, 4]   (uri tables only)
  const uint8_t* pk_ukey;   // [n_uslot, ukw] (uri tables only)
  const int32_t* hb_items;  // [n_hb]
  const int32_t* ub_items;  // [n_ub]         (uri tables only)
  const int32_t* wh_idx;    // [n_wh]
  const int32_t* wu_idx;    // [n_wu]         (uri tables only)
  const int32_t* mtab;      // [m], or null: verdict-only (B3)
  int32_t* out;             // [B, 2] (verdict, pick) or [B, 3] (+ route);
                            // verdict-only: [B, 2] (verdict, level)
  // the route column (all null without a cidr table)
  const uint8_t* a16;       // [B, 16] addresses
  const int32_t* cfam;      // [B] family, -1 for pad rows
  const int32_t* cport;     // [B], or null: no port gate (routes)
  const int32_t* pk_cslot;  // [c_ct, 4]
  const int32_t* pk_cmeta;  // [c_rcap, 4]
  const uint8_t* s_key;     // [c_ct, 16]
  const int32_t* cb_items;  // [c_cb]
  const int32_t* g_fam;     // [c_g]
  const uint8_t* g_mask;    // [c_g, 16]
  const int32_t* g_off;     // [c_g]
  const int32_t* g_capmask; // [c_g]
  const uint32_t* g_salt1;  // [c_g]
  const uint32_t* g_salt2;  // [c_g]
  int32_t b, hw, uw, pk_w, ukw, maxp, lw, bh, bu;
  int32_t n_hb, n_ub, n_wh, n_wu, r_cap, m, word;
  int32_t c_ct, c_rcap, c_cb, c_g, c_bk;
};

namespace {

// The word a byte window is compared in, by width in bytes.
template <int W> struct Word;
template <> struct Word<16> { using T = uint4; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<1> { using T = uint8_t; };

// Words per compare step: 32 B of host and 16 B of uri (a 32-byte host
// key and a 16-byte uri prefix in one step); half that in 1-byte words,
// which hold one byte per register.
template <int W> constexpr int HOST_STEP = (W == 1 ? 16 : 32) / W;
template <int W> constexpr int URI_STEP = (W == 1 ? 8 : 16) / W;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void fold(int lvl, int idx, int& bl, int& bi) {
  if (lvl > bl || (lvl == bl && lvl > 0 && idx < bi)) {
    bl = lvl;
    bi = idx;
  }
}

// Bytes [0, v) of a little-endian 32-bit word (v clamped to [0, 4]):
// the funnel shift clamps its shift at 32, so v >= 4 gives every byte.
__device__ __forceinline__ uint32_t lo_mask(int v) {
  return __funnelshift_lc(FULL, 0u, v > 0 ? 8 * v : 0);
}

// Nonzero when one of the first v bytes of two words differs.
__device__ __forceinline__ uint32_t differ(uint4 a, uint4 b, int v) {
  return ((a.x ^ b.x) & lo_mask(v)) | ((a.y ^ b.y) & lo_mask(v - 4)) |
         ((a.z ^ b.z) & lo_mask(v - 8)) | ((a.w ^ b.w) & lo_mask(v - 12));
}
__device__ __forceinline__ uint32_t differ(uint2 a, uint2 b, int v) {
  return ((a.x ^ b.x) & lo_mask(v)) | ((a.y ^ b.y) & lo_mask(v - 4));
}
__device__ __forceinline__ uint32_t differ(uint32_t a, uint32_t b, int v) {
  return (a ^ b) & lo_mask(v);
}
__device__ __forceinline__ uint32_t differ(uint8_t a, uint8_t b, int v) {
  return v > 0 ? (uint32_t)(a ^ b) : 0u;
}

// CH words of one row, held in registers for one compare step.
template <int W, int CH>
struct Step {
  typename Word<W>::T w[CH];

  // Words [k0, k0 + CH) of a W-aligned global row of nw words; every
  // load issued before any result is used.
  __device__ __forceinline__ void load(const uint8_t* row, int k0, int nw) {
    using T = typename Word<W>::T;
    const T* p = reinterpret_cast<const T*>(row);
#pragma unroll
    for (int i = 0; i < CH; ++i) w[i] = k0 + i < nw ? __ldg(p + k0 + i) : T{};
  }

  // Differing bits among the first n bytes, words [k0, k0 + CH), of
  // these words against the query window q (shared memory, nw words).
  __device__ __forceinline__ uint32_t differ_from(const uint8_t* q, int k0,
                                                  int nw, int n) const {
    using T = typename Word<W>::T;
    const T* qw = reinterpret_cast<const T*>(q);
    uint32_t d = 0;
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if (k0 + i < nw) d |= differ(w[i], qw[k0 + i], n - (k0 + i) * W);
    return d;
  }
};

// Do the first n bytes of a row (nw words, global) equal those of the
// query window q? `s` holds the row's first step, loaded by the caller
// beside the row's other loads; a longer compare loads one further
// step at a time. No early exit.
template <int W, int CH>
__device__ __forceinline__ bool row_eq(Step<W, CH>& s, const uint8_t* row,
                                       const uint8_t* q, int nw, int n) {
  uint32_t d = s.differ_from(q, 0, nw, n);
  for (int k0 = CH; k0 * W < n; k0 += CH) {
    s.load(row, k0, nw);
    d |= s.differ_from(q, k0, nw, n);
  }
  return d == 0;
}

struct Query {
  const uint8_t* qh;  // shared memory: reversed host window
  const uint8_t* qu;  // shared memory: uri window
  int hlen, ulen, port;
  bool has_host, has_uri;
};

// Level of rule c (>= 0) for one query: fused._hint_verdict_packed's
// formulas over one meta row + one byte row, all loaded at once.
template <bool URI, int W>
__device__ __forceinline__ int score(const FusedArgs& a, int c,
                                     const Query& q) {
  constexpr int HS = HOST_STEP<W>, US = URI_STEP<W>;
  const int4* m4 = reinterpret_cast<const int4*>(a.pk_meta + (size_t)c * 8);
  const uint8_t* row = a.pk_bytes + (size_t)c * a.pk_w;
  const uint8_t* urow = row + a.hw;
  const int nwh = a.hw / W, nwu = a.uw / W;
  const int4 m0 = __ldg(m4);
  const int4 m1 = URI ? __ldg(m4 + 1) : make_int4(0, 0, 0, 0);
  Step<W, HS> hs;
  hs.load(row, 0, nwh);
  Step<W, US> us;
  if (URI) us.load(urow, 0, nwu);

  const int active = m0.x, rp = m0.y, hk = m0.z, hl = m0.w;
  int host_level = 0;
  if (hk > 0 && q.has_host) {
    const bool heq = row_eq(hs, row, q.qh, nwh, hl < a.hw ? hl : a.hw);
    const bool exact = heq && hl == q.hlen;
    const bool suffix = heq && hl < q.hlen &&
                        q.qh[clampi(hl, 0, a.hw - 1)] == '.';
    host_level = exact ? 3 : (suffix ? 2 : (hk == 2 ? 1 : 0));
  }
  int uri_level = 0;
  if (URI) {
    const int uk = m1.x, ul = m1.y, uscore = m1.z;
    if (uk > 0 && q.has_uri) {
      const bool ueq = row_eq(us, urow, q.qu, nwu, ul < a.uw ? ul : a.uw);
      const int prefix = (ueq && ul <= q.ulen) ? uscore : 0;
      const int wild = uk == 2 ? 1 : 0;
      uri_level = prefix > wild ? prefix : wild;
    }
  }
  const bool pg = q.port == 0 || rp == 0 || q.port == rp;
  return active > 0 && pg ? (host_level << HOST_SHIFT) + uri_level : 0;
}

// Probe pi of this query: its cuckoo slot and probe length. Probes are
// the host families (2 x maxp), then the uri families (2 x lw).
__device__ __forceinline__ void probe_in(const FusedArgs& a, int b, int pi,
                                         int& slot, int& plen) {
  const int nhp = 2 * a.maxp;
  if (pi < nhp) {
    const int p = pi < a.maxp ? pi : pi - a.maxp;
    const int32_t* sl = pi < a.maxp ? a.hp_slot1 : a.hp_slot2;
    slot = __ldg(sl + (size_t)b * a.maxp + p);
    plen = __ldg(a.hp_len + (size_t)b * a.maxp + p);
  } else {
    const int u = pi - nhp;
    const int p = u < a.lw ? u : u - a.lw;
    const int32_t* sl = u < a.lw ? a.up_slot1 : a.up_slot2;
    slot = __ldg(sl + (size_t)b * a.lw + p);
    plen = __ldg(a.up_len + (size_t)b * a.lw + p);
  }
}

template <bool URI, int W, bool PICK>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
fused_kernel(FusedArgs a, int np, int smem_words) {
  constexpr int HS = HOST_STEP<W>;
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // a route block: the second half of a route-column grid (the note
  // at the top); never in the verdict-only instances
  const bool route = PICK && a.pk_cslot != nullptr;
  const int nb = (a.b + WARPS - 1) / WARPS;  // blocks per half
  if (route && (int)blockIdx.x >= nb) {
    const cidr::Table ct = {a.pk_cslot, a.pk_cmeta, a.s_key, a.cb_items,
                            a.g_fam, a.g_mask, a.g_off, a.g_capmask,
                            a.g_salt1, a.g_salt2, a.c_ct, a.c_rcap, a.c_cb,
                            a.c_g, a.c_bk};
    const int rb = ((int)blockIdx.x - nb) * WARPS + warp;
    const int r = cidr::block_first_match(ct, smem, a.a16, a.cfam, a.cport,
                                          a.b, rb, warp, lane, WARPS);
    if (rb < a.b && lane == 0)
      a.out[(size_t)rb * 3 + 2] = r < a.c_rcap ? r : -1;
    return;
  }
  const int b = blockIdx.x * WARPS + warp;
  if (b >= a.b) return;  // warp-uniform: the whole warp leaves together

  // per warp: host window, uri window (each padded to 16 B), then the
  // probe starts and counts, then the entry list
  const int hpad = (a.hw + 15) & ~15, upad = URI ? (a.uw + 15) & ~15 : 0;
  uint8_t* qh = reinterpret_cast<uint8_t*>(smem + warp * smem_words);
  uint8_t* qu = qh + hpad;
  int32_t* pstart = reinterpret_cast<int32_t*>(qu + upad);
  int32_t* pcnt = pstart + np;
  int32_t* list = pcnt + np;

  // step 1: every input of the query at once
  uint8_t hb[MAX_HW / 32], ub[MAX_UW / 32];
#pragma unroll
  for (int k = 0; k < MAX_HW / 32; ++k) {
    const int i = lane + 32 * k;
    hb[k] = i < a.hw ? __ldg(a.hostb + (size_t)b * a.hw + i) : 0;
  }
  if (URI) {
#pragma unroll
    for (int k = 0; k < MAX_UW / 32; ++k) {
      const int i = lane + 32 * k;
      ub[k] = i < a.uw ? __ldg(a.urib + (size_t)b * a.uw + i) : 0;
    }
  }
  int slot0 = -1, plen0 = -1;  // this lane's first probe
  if (lane < np) probe_in(a, b, lane, slot0, plen0);
  Query q;
  q.qh = qh;
  q.qu = qu;
  q.hlen = __ldg(a.hlen + b);
  q.ulen = URI ? __ldg(a.ulen + b) : 0;
  q.port = __ldg(a.port + b);
  q.has_host = __ldg(reinterpret_cast<const uint8_t*>(a.has_host) + b) != 0;
  q.has_uri =
      URI && __ldg(reinterpret_cast<const uint8_t*>(a.has_uri) + b) != 0;
  // every lane loads the Maglev slot (one broadcast), so the load is not
  // held behind a lane-0 branch past the window stores
  const long long mslot =
      PICK ? __ldg(reinterpret_cast<const long long*>(a.slots) + b) : 0;
#pragma unroll
  for (int k = 0; k < MAX_HW / 32; ++k)
    if (lane + 32 * k < a.hw) qh[lane + 32 * k] = hb[k];
  if (URI) {
#pragma unroll
    for (int k = 0; k < MAX_UW / 32; ++k)
      if (lane + 32 * k < a.uw) qu[lane + 32 * k] = ub[k];
  }
  __syncwarp();

  // step 2: the Maglev take, and per probe its slot record and key
  // words together -> (start, live count)
  const int pick =
      PICK ? __ldg(a.mtab + (mslot < 0 ? 0 : (mslot >= a.m ? a.m - 1 : mslot)))
           : 0;
  const int nhp = 2 * a.maxp;
  for (int pi = lane; pi < np; pi += 32) {
    int slot = slot0, plen = plen0;
    if (pi != lane) probe_in(a, b, pi, slot, plen);
    const bool host = pi < nhp;
    const int kw = host ? a.hw : a.ukw;
    const int s = slot > 0 ? slot : 0;
    const int32_t* pslot = host ? a.pk_hslot : a.pk_uslot;
    const uint8_t* key = (host ? a.pk_hkey : a.pk_ukey) + (size_t)s * kw;
    const int4 rec = __ldg(reinterpret_cast<const int4*>(pslot) + s);
    Step<W, HS> ks;
    ks.load(key, 0, kw / W);
    const int n = plen < kw ? plen : kw;
    const bool ok = slot >= 0 && rec.x == plen &&
                    row_eq(ks, key, host ? qh : qu, kw / W, n);
    // live entries: j < count and j < the bucket cap, as the reference
    // takes j from iota(cap)
    pstart[pi] = rec.y;
    pcnt[pi] = ok ? clampi(rec.z, 0, host ? a.bh : a.bu) : 0;
  }
  __syncwarp();

  // steps 3 and 4, per LIST entries: the probes' live bucket entries,
  // listed at their prefix sum, then the wildcard entries; every rule
  // index of a lane's entries loaded at once, the live (>= 0) ones
  // compacted in place, then one candidate per lane scored from its
  // meta and byte rows
  const int nwild = a.n_wh + (URI ? a.n_wu : 0);
  int bl = 0, bi = a.r_cap;
  int total = 0;  // bucket + wildcard entries, known after the first list
  for (int w0 = 0; w0 == 0 || w0 < total; w0 += LIST) {
    int nb = 0;  // bucket entries of the probes so far
    for (int p0 = 0; p0 < np; p0 += 32) {
      const int pi = p0 + lane;
      const int cnt = pi < np ? pcnt[pi] : 0;
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += t;
      }
      const int beg = nb + incl - cnt;
      const int lo = beg > w0 ? beg : w0;
      const int hi = beg + cnt < w0 + LIST ? beg + cnt : w0 + LIST;
      for (int e = lo; e < hi; ++e) {  // uri entries stored as ~index
        const int j = pstart[pi] + e - beg;
        list[e - w0] = pi < nhp ? clampi(j, 0, a.n_hb - 1)
                                : ~clampi(j, 0, a.n_ub - 1);
      }
      nb += __shfl_sync(FULL, incl, 31);
    }
    total = nb + nwild;
    __syncwarp();
    int c[GROUP];
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const int e = w0 + 32 * k + lane;
      const int32_t* ip = nullptr;
      if (e < nb) {
        const int v = list[e - w0];
        ip = v >= 0 ? a.hb_items + v : a.ub_items + ~v;
      } else if (e < nb + a.n_wh) {
        ip = a.wh_idx + (e - nb);
      } else if (e < total) {
        ip = a.wu_idx + (e - nb - a.n_wh);
      }
      c[k] = ip ? __ldg(ip) : -1;
    }
    __syncwarp();  // every entry read before the compaction rewrites it
    int n = 0;
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const unsigned live = __ballot_sync(FULL, c[k] >= 0);
      if (c[k] >= 0) list[n + __popc(live & ((1u << lane) - 1u))] = c[k];
      n += __popc(live);
    }
    __syncwarp();
    for (int e = lane; e < n; e += 32) {
      const int ci = list[e];
      fold(score<URI, W>(a, ci, q), ci, bl, bi);
    }
    __syncwarp();  // the list is rewritten by the next group
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int ol = __shfl_xor_sync(FULL, bl, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    fold(ol, oi, bl, bi);
  }
  const int verdict = bl > 0 ? bi : -1;
  if (lane == 0) {
    if (route) {
      a.out[(size_t)b * 3] = verdict;
      a.out[(size_t)b * 3 + 1] = pick;
    } else {
      reinterpret_cast<int2*>(a.out)[b] = make_int2(verdict, PICK ? pick : bl);
    }
  }
}

template <bool URI, int W, bool PICK>
cudaError_t launch(const FusedArgs& a, int np, cudaStream_t s) {
  // per warp: the windows (16 B-padded), probe starts + counts, the
  // entry list, rounded to 16 B so every warp's windows align; a route
  // block (the route column) takes B4's block layout instead
  const bool route = a.pk_cslot != nullptr;
  const int hpad = (a.hw + 15) & ~15, upad = URI ? (a.uw + 15) & ~15 : 0;
  const int smem_words = ((hpad + upad) / 4 + 2 * np + LIST + 3) & ~3;
  size_t smem = (size_t)smem_words * 4 * WARPS;
  if (route && smem < cidr::block_bytes(a.c_g, WARPS))
    smem = cidr::block_bytes(a.c_g, WARPS);
  const int nb = (a.b + WARPS - 1) / WARPS;  // hint blocks (and route)
  const dim3 grid(route ? 2 * nb : nb), block(WARPS * 32);
  fused_kernel<URI, W, PICK><<<grid, block, smem, s>>>(a, np, smem_words);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_word(const FusedArgs& a, int np, cudaStream_t s,
                        bool uri, bool pick) {
  if (uri)
    return pick ? launch<true, W, true>(a, np, s)
                : launch<true, W, false>(a, np, s);
  return pick ? launch<false, W, true>(a, np, s)
              : launch<false, W, false>(a, np, s);
}

bool aligned(const void* p, int w) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)w == 0;
}

}  // namespace

extern "C" int vproxy_fused_args_size() { return (int)sizeof(FusedArgs); }

// Launch on `stream` (PyTorch's current stream; no synchronisation).
// uri_rules selects the uri-free instances when 0; args->word the
// compare word (ops/fused_cuda.py word_bytes); a non-null
// args->pk_cslot the route column (out is then [B, 3]); a null
// args->mtab the verdict-only mode (B3: out [B, 2] is (verdict, level)).
// Returns cudaGetLastError() after the launch: 0 when it was accepted;
// cudaErrorInvalidValue, before any launch, for a word that does not
// divide the windows or align the byte tables, windows wider than a
// warp copies, a cidr table that is empty, lacks its address batch or
// the Maglev column, or has a 16-byte row array off 16-byte alignment,
// or a Maglev column without its slots.
extern "C" int vproxy_fused_classify_pick(const FusedArgs* args,
                                          int uri_rules, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const FusedArgs& a = *args;
  if (a.b <= 0) return 0;
  const int w = a.word;
  const bool ok_w = (w == 16 || w == 8 || w == 4 || w == 1) &&
                    a.hw % w == 0 && a.hw <= MAX_HW &&
                    aligned(a.pk_bytes, w) && aligned(a.pk_hkey, w) &&
                    (!uri_rules || (a.uw % w == 0 && a.uw <= MAX_UW &&
                                    a.ukw == a.uw && aligned(a.pk_ukey, w)));
  if (!ok_w) return (int)cudaErrorInvalidValue;
  const bool ok_c =
      a.pk_cslot == nullptr ||
      (a.c_ct > 0 && a.c_rcap > 0 && a.c_cb > 0 && a.c_g > 0 &&
       a.mtab != nullptr &&
       a.cfam != nullptr && aligned(a.a16, 16) && aligned(a.pk_cslot, 16) &&
       aligned(a.pk_cmeta, 16) && aligned(a.s_key, 16) &&
       aligned(a.g_mask, 16) && a.a16 != nullptr);
  if (!ok_c || (a.mtab != nullptr && (a.slots == nullptr || a.m <= 0)))
    return (int)cudaErrorInvalidValue;
  const int np = 2 * a.maxp + (uri_rules ? 2 * a.lw : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pick = a.mtab != nullptr;
  switch (w) {
    case 16: return (int)launch_word<16>(a, np, s, uri_rules, pick);
    case 8: return (int)launch_word<8>(a, np, s, uri_rules, pick);
    case 4: return (int)launch_word<4>(a, np, s, uri_rules, pick);
    default: return (int)launch_word<1>(a, np, s, uri_rules, pick);
  }
}
