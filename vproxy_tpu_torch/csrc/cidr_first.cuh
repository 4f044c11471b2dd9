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
// Design: the whole warp takes one query. Lane l takes the probes
// p = l, l + 32, ... of the 2 x g (group, salt) pairs (group p >> 1,
// salt p & 1), drops a probe whose group has another family (or none:
// g_fam < 0, the padding groups and the family of pad rows, -1), and
// walks the bucket of a probe whose key matches; a warp min-reduction
// folds the lanes. The result is a minimum, so lane order cannot
// change it. A slot record, a key and a meta row are one 16-byte load
// each. Every index the reference gathers with JAX's clamp is clamped
// here too, but the rule index of a meta row: it is read only while it
// is below the best so far, which starts at r_cap.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cidr {

constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t FNV32_OFFSET = 2166136261u;
constexpr uint32_t FNV32_PRIME = 16777619u;

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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// FNV-32 over the 4 bytes of a little-endian word, lowest byte first
// (byte order of the 16-byte key: ops/cuckoo.py fnv32_masked).
__device__ __forceinline__ uint32_t fnv_word(uint32_t h, uint32_t w) {
#pragma unroll
  for (int s = 0; s < 32; s += 8) h = (h ^ ((w >> s) & 0xffu)) * FNV32_PRIME;
  return h;
}

// The least matching rule index of one query, the same on every lane;
// t.r_cap or more when none matches. Every lane of the warp calls it
// with the same query (addr, fam, and port when `gate`).
__device__ __forceinline__ int first_match(const Table& t, const uint4 addr,
                                           int fam, bool gate, int port,
                                           int lane) {
  int best = t.r_cap;
  for (int p = lane; p < 2 * t.g; p += 32) {
    const int g = p >> 1;
    const int gf = __ldg(t.g_fam + g);
    if (gf < 0 || gf != fam) continue;
    const uint4 m = __ldg(reinterpret_cast<const uint4*>(t.g_mask) + g);
    const uint32_t salt = __ldg((p & 1 ? t.g_salt2 : t.g_salt1) + g);
    const int off = __ldg(t.g_off + g);
    const int capmask = __ldg(t.g_capmask + g);
    const uint4 k = make_uint4(addr.x & m.x, addr.y & m.y, addr.z & m.z,
                               addr.w & m.w);
    uint32_t h = FNV32_OFFSET ^ salt;
    h = fnv_word(h, k.x);
    h = fnv_word(h, k.y);
    h = fnv_word(h, k.z);
    h = fnv_word(h, k.w);
    const int slot = clampi(off + ((int)h & capmask), 0, t.ct - 1);
    const int4 rec = __ldg(reinterpret_cast<const int4*>(t.pk_cslot) + slot);
    const uint4 key = __ldg(reinterpret_cast<const uint4*>(t.s_key) + slot);
    if (rec.x <= 0 || key.x != k.x || key.y != k.y || key.z != k.z ||
        key.w != k.w)
      continue;
    // live entries: j < count and j < the bucket cap, as the reference
    // takes j from bk_iota
    const int cnt = clampi(rec.z, 0, t.bk);
    for (int j = 0; j < cnt; ++j) {
      const int item = __ldg(t.cb_items + clampi(rec.y + j, 0, t.cb - 1));
      // best <= r_cap, so a rule past the meta rows is never read (the
      // reference reads its clamped row and then drops it: >= r_cap)
      if (item < 0 || item >= best) continue;
      const int4 meta =
          __ldg(reinterpret_cast<const int4*>(t.pk_cmeta) + item);
      if (meta.x > 0 && (!gate || (meta.y <= port && port <= meta.z)))
        best = item;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int o = __shfl_xor_sync(FULL, best, off);
    best = o < best ? o : best;
  }
  return best;
}

}  // namespace cidr
