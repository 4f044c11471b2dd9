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
//
// The Maglev column (the PICK instance, `fp_hint_kernel_pick`, with an
// FpPickArgs of its own):
// B5's take folded in, so a classify+pick batch of a "torch-fp" matcher
// is one launch answering (verdict, pick) into int32 [B, 2], the row
// layout of B1's `fused_classify_pick`. Replaces, with B5
// (csrc/maglev_take.cu), vproxy_tpu/rules/maglev.py:235 `_device_take`
// on that path. Each query's warp loads its flow slot
// and gathers mtab[clamp(slot, 0, m - 1)] before the routine starts:
// the two loads are off the verdict's chain, their latency hides under
// it, and the pick waits in a register until lane 0 stores it beside
// the verdict. It adds 12 bytes a flow to the bound (an 8-byte slot
// read, a 4-byte pick written) and 4 for each distinct entry gathered;
// without a column, the verdict-only kernel is as it was.
//
// The routine (the staged query, the pairs, the member levels, one
// warp's packed best) is fp_hint.cuh's `warp_best`, which B8
// (sharded_match.cu) also runs, once per rule shard; this file is the
// kernel around it: the launch shape and the output.

#include <cstdint>

#include <cuda_runtime.h>

#include "fp_hint.cuh"

using fph::FpHintArgs;
using fph::FpPickArgs;

namespace {

constexpr int WARPS = 4;    // queries per block

// One warp's query (the kernels below are its entry points: the
// verdict-only one takes FpHintArgs alone).
template <bool PICK>
__device__ __forceinline__ void hint_warp(const FpHintArgs& a,
                                          const FpPickArgs& pa) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= a.b) return;  // whole warps leave together; no block sync
  // the pick, issued before the routine's first load: every lane loads
  // the same slot and entry (one broadcast each, no lane-0 branch to
  // hold the loads back); lane 0 stores it
  const int pick =
      PICK ? fph::maglev_at(
                 pa.mtab, pa.m,
                 __ldg(reinterpret_cast<const long long*>(pa.slots) + q))
           : 0;
  const int best = fph::warp_best(
      a, smem + (size_t)warp * fph::warp_words(a), q, lane);
  if (lane == 0) {
    const size_t o = (size_t)q * a.out_stride;
    a.out_idx[o] = best > 0 ? a.r_cap - best % (a.r_cap + 1) : -1;
    if (PICK)
      pa.out_pick[o] = pick;
    else if (a.out_level != nullptr)
      a.out_level[o] = best / (a.r_cap + 1);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
fp_hint_kernel(FpHintArgs a) {
  hint_warp<false>(a, FpPickArgs{});
}

__global__ void __launch_bounds__(WARPS * 32)
fp_hint_kernel_pick(FpHintArgs a, FpPickArgs pa) {
  hint_warp<true>(a, pa);
}

bool aligned8(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0;
}

}  // namespace

extern "C" int vproxy_fp_hint_args_size() { return (int)sizeof(FpHintArgs); }
extern "C" int vproxy_fp_pick_args_size() { return (int)sizeof(FpPickArgs); }

// Launch on `stream` (PyTorch's current stream; no synchronisation).
// Returns cudaGetLastError() after the launch: 0 when it was accepted;
// cudaErrorInvalidValue, before any launch, for a table or batch whose
// sizes the kernel cannot index: entries wider than a row, a row width
// that is odd or a table of 2^31 ints or more, a table or wildcard
// array that is not 8-byte aligned, a batch whose staged arrays pass
// the 48 KB of shared memory a launch may take unasked, or a Maglev
// column without its table (m <= 0), slots or output. A non-null `pick`
// runs the PICK instance: (verdict, pick) per row, no level.
extern "C" int vproxy_fp_hint(const FpHintArgs* args, const FpPickArgs* pick,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const FpHintArgs& a = *args;
  if (a.b <= 0) return 0;
  const size_t smem = (size_t)WARPS * fph::warp_words(a) * 4;
  if (a.rows <= 0 || a.w <= 0 || a.p <= 0 || a.u <= 0 || a.whc <= 0 ||
      a.wuc <= 0 || a.he <= 0 || a.ue <= 0 || a.hm <= 0 || a.um <= 0 ||
      a.r_cap <= 0 || a.out_stride <= 0 || a.rw % 2 != 0 ||
      a.he * (2 + 4 * a.hm) > a.rw || a.ue * (2 + 4 * a.um) > a.rw ||
      (long long)a.rows * a.rw >= (1ll << 31) ||
      (a.um_fp1 != nullptr && a.l <= 0) || smem > 48 * 1024 ||
      !aligned8(a.rec) || !aligned8(a.wh_rec) || !aligned8(a.wu_rec) ||
      (pick != nullptr &&
       (pick->mtab == nullptr || pick->slots == nullptr ||
        pick->out_pick == nullptr || pick->m <= 0)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.b + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pick != nullptr)
    fp_hint_kernel_pick<<<grid, block, smem, s>>>(a, *pick);
  else
    fp_hint_kernel<<<grid, block, smem, s>>>(a);
  return (int)cudaGetLastError();
}
