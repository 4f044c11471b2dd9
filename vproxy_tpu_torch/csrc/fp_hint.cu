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
// L2. There are no products and ~30 integer ops per member.
//
// Design (simple and right first): one warp per query. The query's
// work items (its P host probes, U uri probes and the whc + wuc
// wildcard members) are dealt to the lanes, item i to lane i mod 32,
// so a query's probe rows are read side by side (P + U is 13 at the
// 100k table's B = 512 batches) instead of one after another. A lane
// reads a row's E fingerprint pairs, then only the matched entry's
// members (the XLA program evaluates the members of every entry), then
// the query's uri or host fingerprints each member names; it keeps the
// packed max, and a butterfly of shuffles folds the warp. Every index
// the reference gathers with JAX's clamp is clamped: the slot to the
// table's rows, a member's lset position and host length to the
// query's arrays. Chain per lane: probe arrays -> row pairs -> member
// records -> query fingerprints, 4 dependent loads. Not yet done:
// staging a query's arrays in shared memory, and spreading one row's
// entries over lanes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // queries per block
constexpr int HOST_SHIFT = 10;

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

struct Member {
  int meta, idx, f1, f2;
};

__device__ __forceinline__ Member load_member(const int32_t* m) {
  return {__ldg(m), __ldg(m + 1), __ldg(m + 2), __ldg(m + 3)};
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The uri level of a host-side member (kind 0 none / 1 normal / 2
// wildcard): its fingerprints against the query's at lset position lidx.
__device__ int uri_side_level(const FpHintArgs& a, int q, const Member& mb,
                              int has_uri) {
  const int kind = (mb.meta >> 16) & 3;
  if (kind == 0) return 0;
  const bool trimmed = a.um_fp1 != nullptr;
  const int L = trimmed ? a.l : a.u;
  const int li = clampi((mb.meta >> 18) & 0x7F, 0, L - 1);
  const size_t at = (size_t)q * L + li;
  const int f1 = __ldg((trimmed ? a.um_fp1 : a.up_fp1) + at);
  const int f2 = __ldg((trimmed ? a.um_fp2 : a.up_fp2) + at);
  const int sc = __ldg((trimmed ? a.um_score : a.up_score) + at);
  const int content = (f1 == mb.f1 && f2 == mb.f2 && sc > 0) ? sc : 0;
  if (kind == 1) return content;
  if (kind == 2) return content > has_uri ? content : has_uri;
  return 0;
}

// The host level of a uri-side member: exact 3 / dot-suffix 2 /
// wildcard 1, its reversed-host fingerprints against the query's
// rolling ones at the member's host length.
__device__ int host_side_level(const FpHintArgs& a, int q, const Member& mb,
                               int qhlen, int has_host) {
  const int kind = (mb.meta >> 16) & 3;
  if (kind == 0) return 0;
  const int hl = (mb.meta >> 18) & 0x7F;
  const int32_t* hm =
      a.q_hmeta + ((size_t)q * a.w + clampi(hl, 0, a.w - 1)) * 3;
  const bool fp_ok = __ldg(hm) == mb.f1 && __ldg(hm + 1) == mb.f2;
  int lvl = 0;
  if (fp_ok && hl == qhlen) lvl = 3;
  else if (fp_ok && __ldg(hm + 2) != 0) lvl = 2;
  if (kind == 1) return lvl;
  if (kind == 2) return lvl > has_host ? lvl : has_host;
  return 0;
}

__device__ __forceinline__ int pack(const FpHintArgs& a, int level, int idx,
                                    int qport, int mport) {
  if (idx < 0 || level <= 0) return 0;
  if (qport != 0 && mport != 0 && mport != qport) return 0;
  return level * (a.r_cap + 1) + (a.r_cap - idx);
}

// The entry of slot row `row` (e entries of 2 + 4m ints) whose
// fingerprint pair is (f1, f2), or -1.
__device__ __forceinline__ int match_entry(const int32_t* row, int e, int m,
                                           int f1, int f2) {
  const int ew = 2 + 4 * m;
  for (int j = 0; j < e; ++j)
    if (__ldg(row + j * ew) == f1 && __ldg(row + j * ew + 1) == f2) return j;
  return -1;
}

__global__ void __launch_bounds__(WARPS * 32)
fp_hint_kernel(FpHintArgs a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= a.b) return;  // whole warps leave together
  const int qport = __ldg(a.port + q);
  const int qhlen = __ldg(a.hlen + q);
  const int has_host = __ldg(a.has_host + q) ? 1 : 0;
  const int has_uri = __ldg(a.has_uri + q) ? 1 : 0;
  const int n_items = a.p + a.u + a.whc + a.wuc;
  int best = 0;
  for (int it = lane; it < n_items; it += 32) {
    if (it < a.p) {  // host probe: members score their uri side
      const size_t at = (size_t)q * a.p + it;
      const int lvl = __ldg(a.hp_level + at);
      if (lvl <= 0) continue;
      const int32_t* row =
          a.rec + (size_t)clampi(__ldg(a.hp_slot + at), 0, a.rows - 1) * a.rw;
      const int j = match_entry(row, a.he, a.hm, __ldg(a.hp_fp1 + at),
                                __ldg(a.hp_fp2 + at));
      if (j < 0) continue;
      const int32_t* mem = row + j * (2 + 4 * a.hm) + 2;
      for (int k = 0; k < a.hm; ++k) {
        const Member mb = load_member(mem + 4 * k);
        if (mb.idx < 0) continue;
        const int level = (lvl << HOST_SHIFT) +
                          uri_side_level(a, q, mb, has_uri);
        best = max(best, pack(a, level, mb.idx, qport, mb.meta & 0xFFFF));
      }
    } else if (it < a.p + a.u) {  // uri probe: members score their host
      const size_t at = (size_t)q * a.u + (it - a.p);
      const int score = __ldg(a.up_score + at);
      if (score <= 0) continue;
      const int32_t* row =
          a.rec + (size_t)clampi(__ldg(a.up_slot + at), 0, a.rows - 1) * a.rw;
      const int j = match_entry(row, a.ue, a.um, __ldg(a.up_fp1 + at),
                                __ldg(a.up_fp2 + at));
      if (j < 0) continue;
      const int32_t* mem = row + j * (2 + 4 * a.um) + 2;
      for (int k = 0; k < a.um; ++k) {
        const Member mb = load_member(mem + 4 * k);
        if (mb.idx < 0) continue;
        const int level =
            (host_side_level(a, q, mb, qhlen, has_host) << HOST_SHIFT) +
            score;
        best = max(best, pack(a, level, mb.idx, qport, mb.meta & 0xFFFF));
      }
    } else if (it < a.p + a.u + a.whc) {  // host="*": host level 1
      const Member mb = load_member(a.wh_rec + 4 * (it - a.p - a.u));
      const int level = (has_host << HOST_SHIFT) +
                        uri_side_level(a, q, mb, has_uri);
      best = max(best, pack(a, level, mb.idx, qport, mb.meta & 0xFFFF));
    } else {  // uri="*": uri level 1
      const Member mb =
          load_member(a.wu_rec + 4 * (it - a.p - a.u - a.whc));
      const int level =
          (host_side_level(a, q, mb, qhlen, has_host) << HOST_SHIFT) +
          has_uri;
      best = max(best, pack(a, level, mb.idx, qport, mb.meta & 0xFFFF));
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (lane == 0) {
    const size_t o = (size_t)q * a.out_stride;
    a.out_idx[o] = best > 0 ? a.r_cap - best % (a.r_cap + 1) : -1;
    if (a.out_level != nullptr) a.out_level[o] = best / (a.r_cap + 1);
  }
}

}  // namespace

extern "C" int vproxy_fp_hint_args_size() { return (int)sizeof(FpHintArgs); }

// Launch on `stream` (PyTorch's current stream; no synchronisation).
// Returns cudaGetLastError() after the launch: 0 when it was accepted;
// cudaErrorInvalidValue, before any launch, for a table or batch whose
// sizes the kernel cannot index.
extern "C" int vproxy_fp_hint(const FpHintArgs* args, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const FpHintArgs& a = *args;
  if (a.b <= 0) return 0;
  if (a.rows <= 0 || a.w <= 0 || a.u <= 0 || a.whc <= 0 || a.wuc <= 0 ||
      a.r_cap <= 0 || a.out_stride <= 0 || a.he * (2 + 4 * a.hm) > a.rw ||
      a.ue * (2 + 4 * a.um) > a.rw || (a.um_fp1 != nullptr && a.l <= 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.b + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fp_hint_kernel<<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}
