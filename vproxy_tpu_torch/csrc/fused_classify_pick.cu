// Fused classify+pick for Hopper (sm_90a): hint verdict + Maglev pick,
// one launch per batch.
//
// Replaces: vproxy_tpu/ops/fused_pallas.py `_fused_kernel` (entry
// `fused_classify_pick_pallas`), the Pallas kernel of the same contract.
// Reference semantics: ops/fused.py `fused_classify_pick` of this
// package (the plain torch tier), bit for bit.
//
// What bounds it on the H100: bytes, and gathered ones. Per query the
// kernel reads its query windows and probe slots (~0.3 KB), one packed
// cuckoo slot row + key row per valid probe, and one 32 B meta row +
// one (hw+uw) B byte row per live candidate rule, then one 4 B Maglev
// entry. There is no arithmetic to speak of (byte compares and a few
// integer ops per candidate), so the floor is the distinct table bytes
// a batch touches over 3.35 TB/s; at the north-star size (100k rules,
// 22.7 MB packed) the whole table also fits the 50 MB L2.
//
// Design (simple and right first; speed is later work):
// * one warp per query, WARPS queries per block;
// * phase 1: lanes split the probes (2 host families x maxp, 2 uri
//   families x lw); each verifies its slot row's key bytes against the
//   query window and leaves (bucket start, live count) in shared memory,
//   so a probe's key compare runs once, not once per bucket slot;
// * phase 2: lanes split the flattened candidate list — host probe
//   families (maxp x bh each), uri probe families (lw x bu each), then
//   the host and uri wildcard lists — score each live candidate from
//   its meta row and byte row, and fold (level, index) with the tie
//   rule of fused_pallas.py:109-116: strictly greater level wins, among
//   equal positive levels the smaller index;
// * a warp shuffle reduces the 32 pairs; lane 0 writes the verdict
//   (-1 when no level is positive) and mtab[clamp(slot, 0, M-1)];
// * uri-free tables (no pk_uslot) compile the URI=false instance, which
//   has no uri work at all;
// * every gathered index is clamped where the reference clamps it.
//   Candidates with index < 0 score level 0 in the reference, and a
//   level-0 pair never changes the fold, so they are skipped here.
// No wgmma/TMA: a gather-bound integer kernel has no use for them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;          // queries per block
constexpr int HOST_SHIFT = 10;    // level = (host << 10) + uri
constexpr unsigned FULL = 0xffffffffu;

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
  const int64_t* slots;     // [B] Maglev slots
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
  const int32_t* mtab;      // [m]
  int32_t* out;             // [B, 2] (verdict, pick)
  int32_t b, hw, uw, pk_w, ukw, maxp, lw, bh, bu;
  int32_t n_hb, n_ub, n_wh, n_wu, r_cap, m;
};

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void fold(int lvl, int idx, int& bl, int& bi) {
  if (lvl > bl || (lvl == bl && lvl > 0 && idx < bi)) {
    bl = lvl;
    bi = idx;
  }
}

// One probe of one family: -> live bucket count (0 when the slot's key
// is not the query's prefix of length plen) and the bucket start.
__device__ __forceinline__ void probe(const int32_t* pslot,
                                      const uint8_t* pkey, int kw,
                                      const uint8_t* qb, int slot, int plen,
                                      int& start, int& cnt) {
  const int s = slot > 0 ? slot : 0;
  const int32_t* rec = pslot + (size_t)s * 4;
  bool ok = slot >= 0 && __ldg(rec) == plen;
  const uint8_t* kb = pkey + (size_t)s * kw;
  const int n = plen < kw ? plen : kw;
  for (int i = 0; ok && i < n; ++i) ok = __ldg(kb + i) == qb[i];
  start = __ldg(rec + 1);
  cnt = ok ? __ldg(rec + 2) : 0;
}

// Level of rule c (>= 0) for one query: fused._hint_verdict_packed's
// formulas, one meta row + one byte row.
template <bool URI>
__device__ __forceinline__ int score(const FusedArgs& a, int c,
                                     const uint8_t* qh, const uint8_t* qu,
                                     int qhlen, int qulen, int qport,
                                     bool qhas_host, bool qhas_uri) {
  const int4* m4 = reinterpret_cast<const int4*>(a.pk_meta + (size_t)c * 8);
  const int4 m0 = __ldg(m4);
  const int active = m0.x, rp = m0.y, hk = m0.z, hl = m0.w;
  if (active <= 0) return 0;
  if (!(qport == 0 || rp == 0 || qport == rp)) return 0;
  const uint8_t* row = a.pk_bytes + (size_t)c * a.pk_w;
  int host_level = 0;
  if (hk > 0 && qhas_host) {
    bool heq = true;
    const int n = hl < a.hw ? hl : a.hw;
    for (int i = 0; heq && i < n; ++i) heq = __ldg(row + i) == qh[i];
    const bool exact = heq && hl == qhlen;
    const bool suffix = heq && hl < qhlen &&
                        qh[clampi(hl, 0, a.hw - 1)] == '.';
    host_level = exact ? 3 : (suffix ? 2 : (hk == 2 ? 1 : 0));
  }
  int uri_level = 0;
  if (URI) {
    const int4 m1 = __ldg(m4 + 1);
    const int uk = m1.x, ul = m1.y, uscore = m1.z;
    if (uk > 0 && qhas_uri) {
      bool ueq = true;
      const int n = ul < a.uw ? ul : a.uw;
      for (int i = 0; ueq && i < n; ++i) ueq = __ldg(row + a.hw + i) == qu[i];
      const int prefix = (ueq && ul <= qulen) ? uscore : 0;
      const int wild = uk == 2 ? 1 : 0;
      uri_level = prefix > wild ? prefix : wild;
    }
  }
  return (host_level << HOST_SHIFT) + uri_level;
}

template <bool URI>
__global__ void __launch_bounds__(WARPS * 32)
fused_kernel(FusedArgs a, int np, int smem_words) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= a.b) return;  // warp-uniform: the whole warp leaves together

  int32_t* pstart = smem + warp * smem_words;
  int32_t* pcnt = pstart + np;
  uint8_t* qh = reinterpret_cast<uint8_t*>(pcnt + np);
  uint8_t* qu = qh + a.hw;

  for (int i = lane; i < a.hw; i += 32) qh[i] = a.hostb[(size_t)b * a.hw + i];
  if (URI)
    for (int i = lane; i < a.uw; i += 32) qu[i] = a.urib[(size_t)b * a.uw + i];
  __syncwarp();

  // phase 1: probes -> (start, live count)
  const int nhp = 2 * a.maxp;
  for (int pi = lane; pi < np; pi += 32) {
    int start, cnt;
    if (pi < nhp) {
      const int p = pi < a.maxp ? pi : pi - a.maxp;
      const int32_t* sl = pi < a.maxp ? a.hp_slot1 : a.hp_slot2;
      probe(a.pk_hslot, a.pk_hkey, a.hw, qh, sl[(size_t)b * a.maxp + p],
            a.hp_len[(size_t)b * a.maxp + p], start, cnt);
    } else {
      const int u = pi - nhp;
      const int p = u < a.lw ? u : u - a.lw;
      const int32_t* sl = u < a.lw ? a.up_slot1 : a.up_slot2;
      probe(a.pk_uslot, a.pk_ukey, a.ukw, qu, sl[(size_t)b * a.lw + p],
            a.up_len[(size_t)b * a.lw + p], start, cnt);
    }
    pstart[pi] = start;
    pcnt[pi] = cnt;
  }
  __syncwarp();

  // phase 2: candidates -> (max level, min index)
  const int qhlen = a.hlen[b], qulen = a.ulen[b], qport = a.port[b];
  const bool qhas_host = a.has_host[b];
  const bool qhas_uri = URI && a.has_uri[b];
  const int nh = nhp * a.bh;                  // host probe candidates
  const int nu = URI ? 2 * a.lw * a.bu : 0;   // uri probe candidates
  const int nwh = nh + nu + a.n_wh;
  const int total = nwh + (URI ? a.n_wu : 0);
  int bl = 0, bi = a.r_cap;
  for (int f = lane; f < total; f += 32) {
    int c = -1;
    if (f < nh) {
      const int pi = f / a.bh, j = f - pi * a.bh;
      if (j < pcnt[pi])
        c = __ldg(a.hb_items + clampi(pstart[pi] + j, 0, a.n_hb - 1));
    } else if (f < nh + nu) {
      const int g = f - nh;
      const int pi = g / a.bu, j = g - pi * a.bu;
      if (j < pcnt[nhp + pi])
        c = __ldg(a.ub_items + clampi(pstart[nhp + pi] + j, 0, a.n_ub - 1));
    } else if (f < nwh) {
      c = __ldg(a.wh_idx + (f - nh - nu));
    } else {
      c = __ldg(a.wu_idx + (f - nwh));
    }
    if (c >= 0)
      fold(score<URI>(a, c, qh, qu, qhlen, qulen, qport, qhas_host,
                      qhas_uri),
           c, bl, bi);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int ol = __shfl_xor_sync(FULL, bl, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    fold(ol, oi, bl, bi);
  }
  if (lane == 0) {
    a.out[(size_t)b * 2] = bl > 0 ? bi : -1;
    const int64_t s = a.slots[b];
    const int si = s < 0 ? 0 : (s >= a.m ? a.m - 1 : (int)s);
    a.out[(size_t)b * 2 + 1] = a.mtab[si];
  }
}

}  // namespace

extern "C" int vproxy_fused_args_size() { return (int)sizeof(FusedArgs); }

// Launch on `stream` (PyTorch's current stream; no synchronisation).
// uri_rules selects the uri-free instance when 0. Returns
// cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int vproxy_fused_classify_pick(const FusedArgs* args,
                                          int uri_rules, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const FusedArgs& a = *args;
  if (a.b <= 0) return 0;
  const int np = 2 * a.maxp + (uri_rules ? 2 * a.lw : 0);
  // per warp: probe starts + counts, then the query's host+uri windows
  const int smem_words = 2 * np + (a.hw + a.uw + 3) / 4;
  const size_t smem = (size_t)smem_words * 4 * WARPS;
  const dim3 grid((a.b + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uri_rules)
    fused_kernel<true><<<grid, block, smem, s>>>(a, np, smem_words);
  else
    fused_kernel<false><<<grid, block, smem, s>>>(a, np, smem_words);
  return (int)cudaGetLastError();
}
