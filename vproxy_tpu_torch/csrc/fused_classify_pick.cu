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
// The hint verdict itself (the word compares, the score, one warp's
// fold over a query's candidates) is hint_probe.cuh's `warp_verdict`,
// which B8 (sharded_match.cu) runs once per rule shard, or in its
// interleaved form over S shards; this file is the kernel around it:
// the launch shape, the route blocks, the output.
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
#include "hint_probe.cuh"

using hint::FusedArgs;

namespace {

constexpr int WARPS = 4;          // queries per block
constexpr int MIN_BLOCKS = 8;     // blocks per SM: <= 64 registers

template <bool URI, int W, bool PICK>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
fused_kernel(FusedArgs a, int np, int smem_words) {
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
  int bl, bi;
  const int pick = hint::warp_verdict<URI, W, PICK>(
      a, smem + warp * smem_words, b, np, lane, bl, bi);
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
  const int smem_words = hint::warp_smem_words(a, np, URI);
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
                    a.hw % w == 0 && a.hw <= hint::MAX_HW &&
                    aligned(a.pk_bytes, w) && aligned(a.pk_hkey, w) &&
                    (!uri_rules || (a.uw % w == 0 && a.uw <= hint::MAX_UW &&
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
