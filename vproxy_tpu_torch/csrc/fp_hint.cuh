// The fingerprint hint routine shared by the kernels that answer a
// hint query of the fingerprint tables on Hopper (sm_90a): fp_hint.cu
// (B6) and sharded_match.cu (B8, once per rule shard). fp_hint.cu's
// note gives the design, the chain of dependent loads and the bound;
// this header holds the code it describes: the launch arguments
// (FpHintArgs), the staged query, the member levels, and `warp_best`,
// one warp's packed best for one query.
//
// Replaces: vproxy_tpu/ops/fphash.py:555 `hint_fp_match`; plain
// version: ops/fphash.py `hint_fp_match` of this package.
#pragma once

#include <cstdint>

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace fph {

constexpr unsigned FULL = 0xffffffffu;
constexpr int PAIRS = 4;    // (probe, entry) pairs per lane per round
// Members per lane per window: 2 (a window of 64) holds the 100k
// table's ~17 members a query (wildcards included) and read 1-3.5%
// faster than 4 at B = 16 / 512 / 4096 on the H100, with 45
// registers against 56 (PERF.md).
constexpr int MEMBERS = 2;
constexpr int LIST = MEMBERS * 32;  // members per warp per window
constexpr int HOST_SHIFT = 10;
constexpr int WH = -2, WU = -3;  // a wildcard member's probe tag

// Every pointer first, then every int: the ctypes mirror in
// ops/fphash_cuda.py has the same order, and its size is checked
// against vproxy_fp_hint_args_size() at load.
struct FpHintArgs {
  const int32_t* rec;       // [rows, rw] slot rows (host, then uri)
  const int32_t* wh_rec;    // [whc, 4] host="*" members
  const int32_t* wu_rec;    // [wuc, 4] uri="*" members
  const int32_t* hp_slot;   // [B, P]
  const int32_t* hp_fp1;    // [B, P]
  const int32_t* hp_fp2;    // [B, P]
  const int32_t* hp_level;  // [B, P], 0 = no probe
  const int32_t* up_slot;   // [B, U]
  const int32_t* up_fp1;    // [B, U]
  const int32_t* up_fp2;    // [B, U]
  const int32_t* up_score;  // [B, U], 0 = no probe
  const int32_t* um_fp1;    // [B, L] or null: then up_* (L = U)
  const int32_t* um_fp2;    // [B, L] or null
  const int32_t* um_score;  // [B, L] or null
  const int32_t* q_hmeta;   // [B, W, 3] rolling host (fp1, fp2, isdot)
  const int32_t* hlen;      // [B]
  const int32_t* port;      // [B]
  const uint8_t* has_host;  // [B] bool
  const uint8_t* has_uri;   // [B] bool
  int32_t* out_idx;         // [B] rule, -1 for none (stride out_stride)
  int32_t* out_level;       // [B] level (stride out_stride), or null
  int32_t b, p, u, l, w, rows, rw, he, hm, ue, um, whc, wuc, r_cap,
      out_stride;
};

// The Maglev column, a parameter of B6's PICK instance alone (FpHintArgs,
// which B8 embeds, stays as it was, and with it the code of every
// verdict-only instance: a kernel parameter grown by a column's fields
// changed the SASS of B9's verdict-only instance and cost it 7-9%). The
// ctypes mirror in ops/fphash_cuda.py is checked against
// vproxy_fp_pick_args_size().
struct FpPickArgs {
  const int32_t* mtab;      // [m] Maglev table
  const int64_t* slots;     // [B] flow slots (maglev.flow_slots)
  int32_t* out_pick;        // [B] mtab[clamp(slot)] (stride out_stride)
  int32_t m;
};

// The Maglev entry at a flow slot, clamped to [0, m - 1] as
// jnp.take(mode="clip") clamps it, through the read-only path.
__device__ __forceinline__ int maglev_at(const int32_t* mtab, int m,
                                         long long slot) {
  return __ldg(mtab + (slot < 0 ? 0 : (slot >= m ? m - 1 : slot)));
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// A warp's shared memory, in ints, each part starting on 16 bytes: the
// probes' slot, fp1, fp2 and level (4 x (P + U)), the um_* copies (3
// rows of L, trimmed batches only), q_hmeta (3 x W), and the member
// list (offset and probe, 2 x LIST).
__host__ __device__ inline int warp_words(const FpHintArgs& a) {
  return round4(4 * (a.p + a.u)) +
         (a.um_fp1 != nullptr ? 3 * round4(a.l) : 0) + round4(3 * a.w) +
         2 * LIST;
}

// The query's staged arrays.
struct Query {
  const int32_t *slot, *fp1, *fp2, *lvl;  // [P + U], host probes first
  const int32_t *uf1, *uf2, *usc;         // [L] uri-side fingerprints
  const int32_t* hmeta;                   // [W, 3]
  int l, port, hlen, has_host, has_uri;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Copy n ints from global src to the warp's shared dst, lanes side by
// side (cp.async): 16 bytes a copy where both ends and n allow it (a
// q_hmeta row of W = 32 positions is 24 copies, not 96), else 4.
__device__ __forceinline__ void stage(int32_t* dst, const int32_t* src,
                                      int n, int lane) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)
        | (uintptr_t)n * 4) & 15) == 0) {
#pragma unroll 1
    for (int i = 4 * lane; i < n; i += 128)
      __pipeline_memcpy_async(dst + i, src + i, 16);
  } else {
#pragma unroll 1
    for (int i = lane; i < n; i += 32)
      __pipeline_memcpy_async(dst + i, src + i, 4);
  }
}

// The uri level of a host-side member (kind 0 none / 1 normal / 2
// wildcard): its fingerprints against the query's at lset position
// lidx.
__device__ __forceinline__ int uri_side_level(const Query& s, int meta,
                                              int f1, int f2) {
  const int kind = (meta >> 16) & 3;
  if (kind == 0) return 0;
  const int li = clampi((meta >> 18) & 0x7F, 0, s.l - 1);
  const int sc = s.usc[li];
  const int content = (s.uf1[li] == f1 && s.uf2[li] == f2 && sc > 0) ? sc
                                                                      : 0;
  if (kind == 1) return content;
  if (kind == 2) return content > s.has_uri ? content : s.has_uri;
  return 0;
}

// The host level of a uri-side member: exact 3 / dot-suffix 2 /
// wildcard 1, its reversed-host fingerprints against the query's
// rolling ones at the member's host length.
__device__ __forceinline__ int host_side_level(const Query& s, int meta,
                                               int f1, int f2, int w) {
  const int kind = (meta >> 16) & 3;
  if (kind == 0) return 0;
  const int hl = (meta >> 18) & 0x7F;
  const int32_t* hm = s.hmeta + 3 * clampi(hl, 0, w - 1);
  const bool fp_ok = hm[0] == f1 && hm[1] == f2;
  int lvl = 0;
  if (fp_ok && hl == s.hlen) lvl = 3;
  else if (fp_ok && hm[2] != 0) lvl = 2;
  if (kind == 1) return lvl;
  if (kind == 2) return lvl > s.has_host ? lvl : s.has_host;
  return 0;
}
// One warp's packed best for query q (< a.b): the max over the query's
// scored members of level * (r_cap + 1) + (r_cap - rule), 0 when none
// scores; every lane gets it. `sw` is the warp's own shared memory
// (warp_words(a) ints, 16-byte aligned).
__device__ __forceinline__ int warp_best(const FpHintArgs& a, int32_t* sw,
                                         int q, int lane) {
  // step 1: the query's arrays into the warp's shared memory
  const int n = a.p + a.u;
  const bool trimmed = a.um_fp1 != nullptr;
  int32_t* lvl = sw + 3 * n;
  stage(sw, a.hp_slot + (size_t)q * a.p, a.p, lane);
  stage(sw + a.p, a.up_slot + (size_t)q * a.u, a.u, lane);
  stage(sw + n, a.hp_fp1 + (size_t)q * a.p, a.p, lane);
  stage(sw + n + a.p, a.up_fp1 + (size_t)q * a.u, a.u, lane);
  stage(sw + 2 * n, a.hp_fp2 + (size_t)q * a.p, a.p, lane);
  stage(sw + 2 * n + a.p, a.up_fp2 + (size_t)q * a.u, a.u, lane);
  stage(lvl, a.hp_level + (size_t)q * a.p, a.p, lane);
  stage(lvl + a.p, a.up_score + (size_t)q * a.u, a.u, lane);
  Query s;
  s.slot = sw;
  s.fp1 = sw + n;
  s.fp2 = sw + 2 * n;
  s.lvl = lvl;
  int32_t* next = sw + round4(4 * n);
  if (trimmed) {
    const int lp = round4(a.l);
    stage(next, a.um_fp1 + (size_t)q * a.l, a.l, lane);
    stage(next + lp, a.um_fp2 + (size_t)q * a.l, a.l, lane);
    stage(next + 2 * lp, a.um_score + (size_t)q * a.l, a.l, lane);
    s.uf1 = next;
    s.uf2 = next + lp;
    s.usc = next + 2 * lp;
    s.l = a.l;
    next += 3 * lp;
  } else {  // the uri probes' own fingerprints, staged above
    s.uf1 = s.fp1 + a.p;
    s.uf2 = s.fp2 + a.p;
    s.usc = lvl + a.p;
    s.l = a.u;
  }
  stage(next, a.q_hmeta + (size_t)q * a.w * 3, 3 * a.w, lane);
  s.hmeta = next;
  int32_t* loff = next + round4(3 * a.w);  // the member list: offsets
  int32_t* lprb = loff + LIST;     // and their probes
  __pipeline_commit();
  s.port = __ldg(a.port + q);
  s.hlen = __ldg(a.hlen + q);
  s.has_host = __ldg(a.has_host + q) ? 1 : 0;
  s.has_uri = __ldg(a.has_uri + q) ? 1 : 0;
  __pipeline_wait_prior(0);
  __syncwarp();  // every lane's copies visible to the warp

  // pair x is probe x >> esh, entry x & (2^esh - 1): a probe's entries
  // padded to a power of two, so no lane divides
  const int esh = 32 - __clz(max(a.he, a.ue) - 1);
  const int npairs = n << esh;
  const int hew = 2 + 4 * a.hm, uew = 2 + 4 * a.um;
  const int nw = a.whc + a.wuc;
  int best = 0;
  for (int r0 = 0; r0 == 0 || r0 < npairs; r0 += 32 * PAIRS) {
    // step 2: PAIRS (probe, entry) pairs per lane, every pair of a live
    // probe loaded before any is compared
    int off[PAIRS], prb[PAIRS];
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const int x = r0 + 32 * k + lane;
      off[k] = -1;
      prb[k] = 0;
      const int pi = x >> esh, j = x & ((1 << esh) - 1);
      const bool host = pi < a.p;
      if (x < npairs && j < (host ? a.he : a.ue) && s.lvl[pi] > 0) {
        off[k] = clampi(s.slot[pi], 0, a.rows - 1) * a.rw +
                 j * (host ? hew : uew);
        prb[k] = pi;
      }
    }
    int2 fp[PAIRS];
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      fp[k] = make_int2(0, 0);
      if (off[k] >= 0)
        fp[k] = __ldg(reinterpret_cast<const int2*>(a.rec + off[k]));
    }
    int cnt[PAIRS], mine = 0;
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const bool ok = off[k] >= 0 && fp[k].x == s.fp1[prb[k]] &&
                      fp[k].y == s.fp2[prb[k]];
      cnt[k] = ok ? (prb[k] < a.p ? a.hm : a.um) : 0;
      mine += cnt[k];
    }
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    // round 0's sequence starts with the wildcard members
    const int nwr = r0 == 0 ? nw : 0;
    const int total = nwr + __shfl_sync(FULL, incl, 31);
    // step 3, per LIST members: this lane's members listed at its
    // prefix sum, then every member record loaded at once
    for (int w0 = 0; w0 < total; w0 += LIST) {
      int e = nwr + incl - mine;
#pragma unroll
      for (int k = 0; k < PAIRS; ++k) {
        const int lo = e > w0 ? e : w0;
        const int hi = e + cnt[k] < w0 + LIST ? e + cnt[k] : w0 + LIST;
        for (int x = lo; x < hi; ++x) {
          loff[x - w0] = off[k] + 2 + 4 * (x - e);
          lprb[x - w0] = prb[k];
        }
        e += cnt[k];
      }
      __syncwarp();
      int2 m0[MEMBERS], m1[MEMBERS];
      int tag[MEMBERS];
#pragma unroll
      for (int k = 0; k < MEMBERS; ++k) {
        const int x = w0 + 32 * k + lane;
        const int32_t* mp = nullptr;
        tag[k] = -1;
        if (x < nwr) {
          tag[k] = x < a.whc ? WH : WU;
          mp = x < a.whc ? a.wh_rec + 4 * x : a.wu_rec + 4 * (x - a.whc);
        } else if (x < total) {
          tag[k] = lprb[x - w0];
          mp = a.rec + loff[x - w0];
        }
        m0[k] = m1[k] = make_int2(0, -1);
        if (mp != nullptr) {
          m0[k] = __ldg(reinterpret_cast<const int2*>(mp));
          m1[k] = __ldg(reinterpret_cast<const int2*>(mp) + 1);
        }
      }
#pragma unroll
      for (int k = 0; k < MEMBERS; ++k) {
        const int meta = m0[k].x, idx = m0[k].y;
        if (tag[k] == -1 || idx < 0) continue;
        int level;
        if (tag[k] == WH)  // host="*": host level 1
          level = (s.has_host << HOST_SHIFT) +
                  uri_side_level(s, meta, m1[k].x, m1[k].y);
        else if (tag[k] == WU)  // uri="*": uri level 1
          level = (host_side_level(s, meta, m1[k].x, m1[k].y, a.w)
                   << HOST_SHIFT) + s.has_uri;
        else if (tag[k] < a.p)  // host probe: members score their uri
          level = (s.lvl[tag[k]] << HOST_SHIFT) +
                  uri_side_level(s, meta, m1[k].x, m1[k].y);
        else  // uri probe: members score their host
          level = (host_side_level(s, meta, m1[k].x, m1[k].y, a.w)
                   << HOST_SHIFT) + s.lvl[tag[k]];
        const int mport = meta & 0xFFFF;
        if (level <= 0 || (s.port != 0 && mport != 0 && mport != s.port))
          continue;
        best = max(best, level * (a.r_cap + 1) + (a.r_cap - idx));
      }
      __syncwarp();  // the list is rewritten by the next window
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(FULL, best, off));
  return best;
}

}  // namespace fph
