// The hint verdict routine of the cuckoo tables, shared by the kernels
// that answer a hint query on Hopper (sm_90a): fused_classify_pick.cu
// (B1, and B3 in its verdict-only instances) and sharded_match.cu (B8:
// `warp_verdict` once per rule shard, or `warp_verdict_shards`, the
// interleaved form over S shards at the end). fused_classify_pick.cu's
// note gives the design, the chain of dependent loads and the bound;
// this header holds the code that note describes: the launch arguments
// (FusedArgs), the word compares, the candidate score, and
// `warp_verdict`, one warp's (level, rule index) fold for one query.
//
// Replaces: vproxy_tpu/ops/hashmatch.py:516 `hint_hash_match`
// (`_probe_buckets` :468, `_reduce_best` :493) over the packed layout of
// vproxy_tpu/ops/fused.py; reference semantics: ops/fused.py
// `_hint_verdict_packed` of this package, bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hint {

constexpr int HOST_SHIFT = 10;    // level = (host << 10) + uri
constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUP = 4;          // candidate slots per lane per step
constexpr int LIST = GROUP * 32;  // entry list length per warp
constexpr int MAX_HW = 96;        // widest windows a warp copies (3 and
constexpr int MAX_UW = 128;       // 4 bytes per lane)

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

// Ints of shared memory one warp's verdict needs: the host and uri
// windows (each padded to 16 B), the np probe starts and counts, the
// entry list, rounded to 16 B so every warp's windows align.
__host__ __device__ inline int warp_smem_words(const FusedArgs& a, int np,
                                               bool uri) {
  const int hpad = (a.hw + 15) & ~15, upad = uri ? (a.uw + 15) & ~15 : 0;
  return ((hpad + upad) / 4 + 2 * np + LIST + 3) & ~3;
}

// One warp's hint verdict for query b (< a.b): every lane calls it and
// gets the fold's best level `bl` and its rule index `bi` (bl 0: no
// match), and returns the Maglev pick (PICK; 0 otherwise). `ws` is the
// warp's own shared memory (warp_smem_words ints, 16-byte aligned); np
// the probe count (2 x maxp host probes, then 2 x lw uri probes).
template <bool URI, int W, bool PICK>
__device__ __forceinline__ int warp_verdict(const FusedArgs& a, int32_t* ws,
                                            int b, int np, int lane,
                                            int& bl, int& bi) {
  constexpr int HS = HOST_STEP<W>;

  // per warp: host window, uri window (each padded to 16 B), then the
  // probe starts and counts, then the entry list
  const int hpad = (a.hw + 15) & ~15, upad = URI ? (a.uw + 15) & ~15 : 0;
  uint8_t* qh = reinterpret_cast<uint8_t*>(ws);
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
  bl = 0;
  bi = a.r_cap;
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
  return pick;
}

// ------------------------------------------------ the interleaved form
//
// `warp_verdict_shards` answers one query over S rule shards in one
// warp (B8, sharded_match.cu). It runs warp_verdict's steps once for
// all the shards together: a step's probes, entries and candidates of
// every shard are spread over the lanes and loaded at once, so the S
// chains of dependent loads overlap instead of running one after the
// other. `Sh` gives shard j's arguments (`at(j)`: the FusedArgs moved
// to shard j, whose windows are shared when `shared_windows()`) and
// the key a winner takes (`key(level, j, rule)`: the greater key wins,
// 0 for level 0). Probes per lane before the live ones are listed:
constexpr int SHARD_PROBES = 4;
// live probes a lane loads at once in step 2
constexpr int SHARD_LIVE = 2;

// Ints of shared memory one warp's interleaved verdict needs over S
// shards: the windows (one copy, or one a shard), 5 scalars a shard,
// the live probes' (shard and probe, slot or start, length or count),
// the entry list and the entries' shards.
__host__ __device__ inline int shards_smem_words(const FusedArgs& a, int np,
                                                 bool uri, int shards,
                                                 bool shared_windows) {
  const int hpad = (a.hw + 15) & ~15, upad = uri ? (a.uw + 15) & ~15 : 0;
  const int nwin = shared_windows ? 1 : shards;
  return nwin * (hpad + upad) / 4 + ((5 * shards + 3) & ~3) +
         ((3 * shards * np + 3) & ~3) + 2 * LIST;
}

template <bool URI, int W, class Sh>
__device__ __forceinline__ unsigned long long warp_verdict_shards(
    const Sh& sh, int shards, int32_t* ws, int b, int np, int lane) {
  constexpr int HS = HOST_STEP<W>;
  const FusedArgs& a0 = sh.at(0);
  const int hpad = (a0.hw + 15) & ~15, upad = URI ? (a0.uw + 15) & ~15 : 0;
  const int nwin = sh.shared_windows() ? 1 : shards;
  const int winb = hpad + upad;
  uint8_t* win = reinterpret_cast<uint8_t*>(ws);
  int32_t* qs = reinterpret_cast<int32_t*>(win + nwin * winb);
  int32_t* pinfo = qs + ((5 * shards + 3) & ~3);  // j * np + probe
  int32_t* pa = pinfo + shards * np;  // slot, then the bucket start
  int32_t* pb = pa + shards * np;     // length, then the live count
  int32_t* list = pinfo + ((3 * shards * np + 3) & ~3);
  int32_t* lsh = list + LIST;
  const unsigned below = (1u << lane) - 1u;
  const int total_probes = shards * np;

  // step 1: every shard's windows, scalars and probe slots at once,
  // the live probes (slot >= 0) listed densely
  for (int w = 0; w < nwin; ++w) {
    const FusedArgs& h = sh.at(w);
    uint8_t hb[MAX_HW / 32], ub[MAX_UW / 32];
#pragma unroll
    for (int k = 0; k < MAX_HW / 32; ++k) {
      const int i = lane + 32 * k;
      hb[k] = i < h.hw ? __ldg(h.hostb + (size_t)b * h.hw + i) : 0;
    }
    if (URI) {
#pragma unroll
      for (int k = 0; k < MAX_UW / 32; ++k) {
        const int i = lane + 32 * k;
        ub[k] = i < h.uw ? __ldg(h.urib + (size_t)b * h.uw + i) : 0;
      }
    }
    uint8_t* qh = win + w * winb;
#pragma unroll
    for (int k = 0; k < MAX_HW / 32; ++k)
      if (lane + 32 * k < h.hw) qh[lane + 32 * k] = hb[k];
    if (URI) {
#pragma unroll
      for (int k = 0; k < MAX_UW / 32; ++k)
        if (lane + 32 * k < h.uw) qh[hpad + lane + 32 * k] = ub[k];
    }
  }
  for (int j = lane; j < shards; j += 32) {
    const FusedArgs& h = sh.at(j);
    qs[5 * j] = __ldg(h.hlen + b);
    qs[5 * j + 1] = URI ? __ldg(h.ulen + b) : 0;
    qs[5 * j + 2] = __ldg(h.port + b);
    qs[5 * j + 3] =
        __ldg(reinterpret_cast<const uint8_t*>(h.has_host) + b) != 0;
    qs[5 * j + 4] =
        URI && __ldg(reinterpret_cast<const uint8_t*>(h.has_uri) + b) != 0;
  }
  int nl = 0;  // live probes
  for (int x0 = 0; x0 < total_probes; x0 += 32 * SHARD_PROBES) {
    int slot[SHARD_PROBES], plen[SHARD_PROBES];
#pragma unroll
    for (int k = 0; k < SHARD_PROBES; ++k) {
      const int x = x0 + 32 * k + lane;
      slot[k] = -1;
      plen[k] = -1;
      if (x < total_probes) {
        const int j = x / np;
        probe_in(sh.at(j), b, x - j * np, slot[k], plen[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < SHARD_PROBES; ++k) {
      const bool live = slot[k] >= 0;
      const unsigned m = __ballot_sync(FULL, live);
      if (live) {
        const int at = nl + __popc(m & below);
        pinfo[at] = x0 + 32 * k + lane;
        pa[at] = slot[k];
        pb[at] = plen[k];
      }
      nl += __popc(m);
    }
  }
  __syncwarp();

  // step 2: every live probe's slot record and key words, SHARD_LIVE a
  // lane at once -> (start, live count)
  const int nhp = 2 * a0.maxp;
  for (int c0 = 0; c0 < nl; c0 += 32 * SHARD_LIVE) {
    int4 rec[SHARD_LIVE];
    Step<W, HS> ks[SHARD_LIVE];
    int c[SHARD_LIVE], jj[SHARD_LIVE], pl[SHARD_LIVE];
#pragma unroll
    for (int k = 0; k < SHARD_LIVE; ++k) {
      c[k] = c0 + 32 * k + lane;
      rec[k] = make_int4(-1, 0, 0, 0);
      jj[k] = 0;
      pl[k] = 0;
      if (c[k] < nl) {
        const int x = pinfo[c[k]];
        const int j = x / np, pi = x - j * np;
        const FusedArgs& h = sh.at(j);
        const bool host = pi < nhp;
        const int kw = host ? h.hw : h.ukw;
        const int s = pa[c[k]];
        const int32_t* pslot = host ? h.pk_hslot : h.pk_uslot;
        const uint8_t* key = (host ? h.pk_hkey : h.pk_ukey) + (size_t)s * kw;
        rec[k] = __ldg(reinterpret_cast<const int4*>(pslot) + s);
        ks[k].load(key, 0, kw / W);
        jj[k] = j;
        pl[k] = pb[c[k]];
      }
    }
#pragma unroll
    for (int k = 0; k < SHARD_LIVE; ++k) {
      if (c[k] >= nl) continue;
      const int x = pinfo[c[k]];
      const int pi = x - jj[k] * np;
      const FusedArgs& h = sh.at(jj[k]);
      const bool host = pi < nhp;
      const int kw = host ? h.hw : h.ukw;
      const uint8_t* key =
          (host ? h.pk_hkey : h.pk_ukey) + (size_t)pa[c[k]] * kw;
      const uint8_t* qw = win + (nwin == 1 ? 0 : jj[k] * winb) +
                          (host ? 0 : hpad);
      const int n = pl[k] < kw ? pl[k] : kw;
      const bool ok =
          rec[k].x == pl[k] && row_eq(ks[k], key, qw, kw / W, n);
      pa[c[k]] = rec[k].y;
      pb[c[k]] = ok ? clampi(rec[k].z, 0, host ? h.bh : h.bu) : 0;
    }
  }
  __syncwarp();

  // steps 3 and 4, per LIST entries: the live probes' bucket entries at
  // their prefix sum, then every shard's wildcard entries; every rule
  // index of a lane's entries loaded at once, the live ones compacted
  // with their shards, then one candidate per lane scored
  const int nwild = a0.n_wh + (URI ? a0.n_wu : 0);
  unsigned long long best = 0;
  int total = 0;
  for (int w0 = 0; w0 == 0 || w0 < total; w0 += LIST) {
    int nb = 0;
    for (int p0 = 0; p0 < nl; p0 += 32) {
      const int ci = p0 + lane;
      const int cnt = ci < nl ? pb[ci] : 0;
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += t;
      }
      const int beg = nb + incl - cnt;
      const int lo = beg > w0 ? beg : w0;
      const int hi = beg + cnt < w0 + LIST ? beg + cnt : w0 + LIST;
      if (lo < hi) {
        const int x = pinfo[ci];
        const int j = x / np;
        const bool host = x - j * np < nhp;
        for (int e = lo; e < hi; ++e) {  // uri entries stored as ~index
          const int i = pa[ci] + e - beg;
          list[e - w0] = host ? clampi(i, 0, a0.n_hb - 1)
                              : ~clampi(i, 0, a0.n_ub - 1);
          lsh[e - w0] = j;
        }
      }
      nb += __shfl_sync(FULL, incl, 31);
    }
    total = nb + shards * nwild;
    __syncwarp();
    int cand[GROUP], js[GROUP];
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const int e = w0 + 32 * k + lane;
      const int32_t* ip = nullptr;
      js[k] = 0;
      if (e < nb) {
        const int v = list[e - w0];
        js[k] = lsh[e - w0];
        const FusedArgs& h = sh.at(js[k]);
        ip = v >= 0 ? h.hb_items + v : h.ub_items + ~v;
      } else if (e < total) {
        const int r = e - nb;
        js[k] = r / nwild;
        const int i = r - js[k] * nwild;
        const FusedArgs& h = sh.at(js[k]);
        ip = i < h.n_wh ? h.wh_idx + i : h.wu_idx + (i - h.n_wh);
      }
      cand[k] = ip ? __ldg(ip) : -1;
    }
    __syncwarp();  // every entry read before the compaction rewrites it
    int n = 0;
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const unsigned live = __ballot_sync(FULL, cand[k] >= 0);
      if (cand[k] >= 0) {
        const int at = n + __popc(live & below);
        list[at] = cand[k];
        lsh[at] = js[k];
      }
      n += __popc(live);
    }
    __syncwarp();
    for (int e = lane; e < n; e += 32) {
      const int ci = list[e], j = lsh[e];
      const uint8_t* qh = win + (nwin == 1 ? 0 : j * winb);
      Query q;
      q.qh = qh;
      q.qu = qh + hpad;
      q.hlen = qs[5 * j];
      q.ulen = qs[5 * j + 1];
      q.port = qs[5 * j + 2];
      q.has_host = qs[5 * j + 3] != 0;
      q.has_uri = qs[5 * j + 4] != 0;
      const unsigned long long k =
          sh.key(score<URI, W>(sh.at(j), ci, q), j, ci);
      best = k > best ? k : best;
    }
    __syncwarp();  // the list is rewritten by the next group
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(FULL, best, off);
    best = o > best ? o : best;
  }
  return best;
}

}  // namespace hint
