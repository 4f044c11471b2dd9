// Fingerprint hint verdict for Hopper (sm_90a): the rule index and
// level of each query of a batch against a packed-fingerprint hint
// table, one launch per batch (B6).
//
// Replaces: vproxy_tpu/ops/fphash.py:555 `hint_fp_match` (jitted as
// `hint_fp_jit`, :1236), the XLA program every hint batch of a
// "jax-fp" HintMatcher runs. Plain version: ops/fphash.py
// `hint_fp_match` of this package, which tier-1 holds int32-equal to
// the reference in its three member modes.
//
// What it computes, for one query: each host probe p (hp_level > 0)
// reads slot row rec[hp_slot]; the entry whose (fp1, fp2) equals the
// probe's is the key (the build leaves at most one per row,
// fphash.py _place_fp); each of that entry's M members (meta, rule,
// uri fp1, uri fp2) scores (hp_level << 10) + its uri level, the uri
// level read from the query's uri fingerprints at the member's lset
// position (um_* when the encoder trimmed the uri probes, up_*
// otherwise). Each uri probe (up_score > 0) reads rec[up_slot] the
// same way; its members score (host level << 10) + up_score, the host
// level from the query's rolling host fingerprints at the member's
// host length (q_hmeta). Every query also scores the wildcard lists
// wh_rec and wu_rec. A member scores only with a rule index >= 0 and
// past the port gate (query port 0, member port 0, or equal). The
// winner is the max of level * (r_cap + 1) + (r_cap - rule) in int32
// (the compiler asserts that it fits).
//
// Bound. Per query the kernel must read its probe arrays, and per live
// probe the E fingerprint pairs of its slot row and the M member
// records of the matched entry; the wildcard lists; and write two
// int32. Those bytes over the 3.35 TB/s HBM rate are the floor
// (chip_smoke.py `fp_hint_work()`), read against the cold time: at
// 100k rules the slot table is 155.7 MB, three times the 50 MB L2, so
// a batch's rows come from HBM unless an earlier batch left them in
// L2. There are no products and ~30 integer ops per member. Well above
// the floor the time is latency: the chain of dependent loads a query
// walks.
//
// Chain depth (dependent global-load steps per query, counted from the
// source). The first version gave each lane one probe: it loaded the
// probe's arrays (1 step), walked its row's E fingerprint pairs behind
// an early exit (up to E = 6 steps at the 100k table), then each of
// the matched entry's M = 5 members (a 4-int load, then the query's
// uri or host fingerprints at the member's position: 2 steps a
// member): ~6-17 steps a lane. Here it is 3 while the query's
// (probe, entry) slots fit one round of 32 x PAIRS and its members one
// window of LIST:
//   1. the query's probe arrays, its uri-side fingerprints (um_*, or
//      up_*) and its rolling host fingerprints (q_hmeta) copied into
//      the warp's shared memory (cp.async), beside its port, host
//      length and flags;
//   2. the (fp1, fp2) of every (probe, entry) pair of the live probes,
//      PAIRS slots per lane, all issued before any is compared;
//   3. every member of every matched entry, and every wildcard member
//      (round 0), listed densely across the warp, MEMBERS per lane, all
//      issued before any is scored; a member's uri or host level reads
//      the staged fingerprints, with no further global load;
// then a butterfly of shuffles folds the packed max. Each further
// 32 x PAIRS slots adds a round of steps 2-3, each further LIST members
// of a round a step 3. At the 100k table's batches (P = 5 host probes
// with hE = 6 entries, U = 8 uri probes with uE = 4) a query has 62
// pairs in 13 x 8 = 104 slots: one round.
//
// Design:
// * one warp per query, WARPS queries per block, each warp with its own
//   slice of shared memory (no block-wide sync);
// * the probes are numbered host first (0 .. P-1), then uri (P ..
//   P+U-1), and their (slot, fp1, fp2, level or score) staged as four
//   arrays; untrimmed batches read the uri-side fingerprints from the
//   staged up_* arrays, trimmed ones from staged um_* copies;
// * slot x is (probe x >> s, entry x & (2^s - 1)), 2^s the least power
//   of two >= max(hE, uE): a shift and a mask, not two integer
//   divisions a pair; slots past the probe's own E hold no pair. A
//   slot row's entry is 2 + 4M ints, so its (fp1, fp2) is one 8-byte
//   load (rows are 8-byte aligned, not 16: 22-int entries at the 100k
//   table);
// * a matched pair lists its entry's M members (the offset of each
//   member record and its probe) at its warp prefix sum (a shuffle
//   scan) in a per-warp list of LIST members; the whc + wuc wildcard
//   members take positions 0 .. whc + wuc - 1 of round 0's sequence,
//   found by their position with nothing listed; a member record is
//   two 8-byte loads;
// * the answer is a max of packed levels, so no order of pairs,
//   members, windows, rounds or lanes can change it;
// * every index the reference gathers with JAX's clamp is clamped: the
//   slot to the table's rows, a member's lset position and host length
//   to the query's arrays.
//
// What Hopper's other tools would do here. wgmma and the tensor cores
// multiply tiles: this kernel compares fingerprints and takes a max,
// with no product. TMA copies tiles at given coordinates: the query's
// arrays are a few hundred bytes, many at unaligned offsets (cp.async,
// 16 bytes a copy where aligned, else 4; no tensor map); every table
// read is a scattered 8-byte
// pair or 16-byte member chosen by the data, where a TMA issue and an
// mbarrier wait per row would add a step to the chain that row sits
// on. Plain loads through the read-only path, all of a step issued
// before any is used, are the shortest chain.

#include <cstdint>

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;    // queries per block
constexpr int PAIRS = 4;    // (probe, entry) pairs per lane per round
// Members per lane per window: 2 (a window of 64) holds the 100k
// table's ~17 members a query (wildcards included) and read 1-3.5%
// faster than 4 at B = 16 / 512 / 4096 on the H100, with 45
// registers against 56 (PERF.md).
constexpr int MEMBERS = 2;
constexpr int LIST = MEMBERS * 32;  // members per warp per window
constexpr int HOST_SHIFT = 10;
constexpr int WH = -2, WU = -3;  // a wildcard member's probe tag

}  // namespace

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

namespace {

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

__global__ void __launch_bounds__(WARPS * 32)
fp_hint_kernel(FpHintArgs a) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= a.b) return;  // whole warps leave together; no block sync
  // step 1: the query's arrays into the warp's shared memory
  const int n = a.p + a.u;
  const bool trimmed = a.um_fp1 != nullptr;
  int32_t* sw = smem + (size_t)warp * warp_words(a);
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
  if (lane == 0) {
    const size_t o = (size_t)q * a.out_stride;
    a.out_idx[o] = best > 0 ? a.r_cap - best % (a.r_cap + 1) : -1;
    if (a.out_level != nullptr) a.out_level[o] = best / (a.r_cap + 1);
  }
}

bool aligned8(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0;
}

}  // namespace

extern "C" int vproxy_fp_hint_args_size() { return (int)sizeof(FpHintArgs); }

// Launch on `stream` (PyTorch's current stream; no synchronisation).
// Returns cudaGetLastError() after the launch: 0 when it was accepted;
// cudaErrorInvalidValue, before any launch, for a table or batch whose
// sizes the kernel cannot index: entries wider than a row, a row width
// that is odd or a table of 2^31 ints or more, a table or wildcard
// array that is not 8-byte aligned, or a batch whose staged arrays pass
// the 48 KB of shared memory a launch may take unasked.
extern "C" int vproxy_fp_hint(const FpHintArgs* args, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const FpHintArgs& a = *args;
  if (a.b <= 0) return 0;
  const size_t smem = (size_t)WARPS * warp_words(a) * 4;
  if (a.rows <= 0 || a.w <= 0 || a.p <= 0 || a.u <= 0 || a.whc <= 0 ||
      a.wuc <= 0 || a.he <= 0 || a.ue <= 0 || a.hm <= 0 || a.um <= 0 ||
      a.r_cap <= 0 || a.out_stride <= 0 || a.rw % 2 != 0 ||
      a.he * (2 + 4 * a.hm) > a.rw || a.ue * (2 + 4 * a.um) > a.rw ||
      (long long)a.rows * a.rw >= (1ll << 31) ||
      (a.um_fp1 != nullptr && a.l <= 0) || smem > 48 * 1024 ||
      !aligned8(a.rec) || !aligned8(a.wh_rec) || !aligned8(a.wu_rec))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.b + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fp_hint_kernel<<<grid, block, smem, s>>>(a);
  return (int)cudaGetLastError();
}
