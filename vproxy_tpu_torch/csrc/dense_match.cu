// Dense (brute-force) hint and CIDR matching for Hopper (sm_90a): every
// query of a batch against every live rule of a table, one launch per
// batch (B9).
//
// Replaces: vproxy_tpu/ops/matchers.py `hint_match` (:33) /
// `hint_match_chunked` (:85) with `_hint_levels` (:175), and
// `cidr_first_match` (:55) / `cidr_first_match_chunked` (:132), over
// vproxy_tpu/ops/bitmatch.py `unpack_bits` (:39) and `mismatch_counts`
// (:47): the XLA programs every batch of a "jax-dense" matcher runs
// (`hint_match_jit`, `cidr_match_jit`), and the three programs of
// `classify_all` (:200). Plain version: ops/matchers.py of this
// package, which tier-1 holds int32-equal to the reference.
//
// What it computes. A pattern matches a query iff
// ((q XOR v) AND m) == 0 over every 32-bit word, where m (the mask bit)
// is W != 0 and v (the value bit) is W < 0 of the reference's bit-plane
// weights W: the predicate the TPU computes as a [B, K] x [K, N]
// product + bias compared with 0. Here it is a masked word compare,
// exact, with no [B, N] count matrix in device memory, over a layout
// ops/dense_cuda.py packs when a matcher publishes.
// * hint: per rule, host level max(exact*3, suffix*2, wild*1) when the
//   query has a host, uri level max(prefix*score, wild*1) when it has a
//   uri, level (host << 10) + uri, 0 unless the port gate (query port
//   0, rule port 0, or equal) holds and the rule is active; the answer
//   is the highest level, the earliest rule among equals: (index,
//   level), (-1, 0) when no rule scores.
// * cidr: the first rule with a valid pattern of the query's family
//   whose masked compare holds (and, with ports given, whose
//   [min_port, max_port] holds the port); -1 when none does. Pad rows
//   (family -1) match nothing.
//
// Bound. It is O(rules) per query by design: the reference keeps the
// dense backend as the brute-force cross-check. At B >= ~32 it is
// integer-op bound. chip_smoke.py `dense_hint_work()` /
// `dense_cidr_work()` count 2 int ops for every word with a mask bit of
// every pattern a query must compare (a query's host words only when it
// has a host, its uri words only when it has a uri, only the rules its
// port gate admits; for cidr the rules up to each query's first match)
// and those words' bytes once; the bound is the larger of the two
// times. A time split of the design before this one (tools/
// dense_split.py: staging only, compares only, whole) put ~98% of the
// time in the compares and ~11% in the staging.
//
// Design.
// * Layout (ops/dense_cuda.py `pack_dense_hint_table`): the live rules
//   are grouped by (host chunks, uri chunks, port gate) and each group
//   cut into tiles of TILE rows (pad rows match nothing), so the rows
//   of a tile share their trip counts. A host chunk is 4 host words
//   (query words in HOST_ORDER: the length-byte word first) as three
//   uint4: the exact pattern's masks, the suffix pattern's masks, and
//   the values both share (they agree wherever both mask: the packer
//   checks it). A uri chunk is 4 uri words as (masks, values). Only a
//   rule's live chunks are stored: ~12 MB for 100k `mk_rules` rules,
//   which L2 holds across query tiles. A tile is one contiguous run:
//   TILE meta int4s, then the host chunks, then the uri chunks.
// * A block is up to 128 threads, each holding Q queries' host words in
//   registers and their uri words in shared memory (Q = 2 at large
//   batches: every staged word feeds two queries), over a range of
//   tiles; the grid is query tiles x tile ranges. Tiles are staged into a two-slot ring in shared memory with
//   cp.async, tile t + 1 in flight while tile t is compared.
// * The compare loops run a tile's chunk counts (block-uniform): per
//   host word x = q ^ v, then exact |= x & m_exact and
//   suffix |= x & m_suffix; no per-word exit. An absent exact or suffix
//   pattern carries a mask bit on the host slot's padding byte (value
//   1, the query's byte is 0), so it never matches.
// * hint: a rule's key is (host level << 30) | (uri level << 20) |
//   (0xFFFFF - index): the max key is the highest level, then the
//   earliest rule, whatever order the groups run in. Each thread keeps
//   its queries' max; one 32-bit atomicMax per query and block, then
//   the last block of a query tile (a device-scope ticket after a
//   fence) writes (index, level). A table whose last live rule lies
//   past 2^20 takes the WIDE instances: the same level fields shifted
//   up 12 bits over (2^31 - 1 - index) in a 64-bit key and a 64-bit
//   atomicMax (the packer writes that index field and flags the tiles;
//   the rule is the same). They keep two more registers a query
//   thread, so they ask for 3 blocks an SM, not 4; the 32-bit
//   instances serve every table of at most 2^20 rules as before.
// * The Maglev column (the PICK instances, `dense_hint_kernel_pick`, with
//   a DensePickArgs of their own):
//   B5's take folded in, so a classify+pick batch of a "torch-dense"
//   matcher is one launch answering (verdict, pick) into int32 [B, 2],
//   the row layout of B1's `fused_classify_pick`. Replaces, with B5
//   (csrc/maglev_take.cu), vproxy_tpu/rules/maglev.py:235
//   `_device_take` on that path. The blocks of the first tile range
//   (blockIdx.y 0) load their queries' flow slots and gather
//   mtab[clamp(slot, 0, m - 1)] right after their first tile's copies
//   are issued, and store the picks at once: the two loads wait under
//   the tile's landing, off the verdict's chain, and hold no register
//   through the compare loop (the last block, which writes the
//   verdict, is known only at the end, and the Q = 2 instance sits at
//   its 128-register bound). 12 bytes a flow more (an 8-byte slot read,
//   a 4-byte pick written) and 4 for each distinct entry gathered.
// * cidr: per family a list of the valid patterns in ascending rule
//   order (an IPv4 pattern is one mask and value word: 16 B with its
//   rule and ports; an IPv6 one four: 48 B). A block takes one family's
//   list range and its query tile's queries of that family (compacted
//   in shared memory), Q = 4 per thread when a batch has enough work
//   for the card at that (else 1: more blocks); a query stops
//   at its first
//   match, a block leaves its range once each of its queries has one,
//   or an earlier range's block already wrote a smaller rule (the
//   answers' unsigned atomicMin, read before each tile). The wrapper
//   fills the answers with -1, so a query with no match keeps -1.
// Both reductions are order-independent: the result is deterministic.

#include <cstdint>
#include <type_traits>

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int HOST_BYTES = 66;  // HOST_SLOT: 65 reversed bytes + length
constexpr int HOST_WORDS = 17;  // padded to 68 bytes
constexpr int URI_WORDS = 32;   // MAX_URI = 128 bytes
constexpr int HC_MAX = 5;       // host chunks: 20 words >= 17
constexpr int UC_MAX = 8;       // uri chunks: 32 words
constexpr int TILE = 32;        // hint rows a tile
constexpr int CTILE = 64;       // cidr entries a tile
constexpr int MAX_THREADS = 128;
constexpr int HINT_MIN_BLOCKS = 4;  // <= 128 registers a thread
constexpr int WIDE_MIN_BLOCKS = 3;  // the 64-bit key: <= 168
constexpr int CIDR_Q = 4;           // cidr queries a thread, many queries
constexpr unsigned IDX_MASK = 0xFFFFFu;  // 20 bits of rule index
constexpr unsigned WIDE_MASK = 0x7FFFFFFFu;  // 31 bits (WIDE)

}  // namespace

struct DenseHintArgs {
  const uint8_t* q_host;     // [b, 66]
  const uint8_t* q_uri;      // [b, 128], 16-byte aligned rows
  const uint8_t* has_host;   // bool [b]
  const uint8_t* has_uri;    // bool [b]
  const int32_t* port;       // [b]
  const int32_t* rows;       // the tiles, one after another (int4s)
  const int32_t* tiles;      // [n_tiles, 4]: first int4, host chunks |
                             // uri chunks << 8 | gated << 16, 0, 0
  unsigned int* key;         // [b] (WIDE: 64-bit), zero-filled by the
                             // wrapper
  unsigned int* done;        // [query tiles], zero-filled by the wrapper
  int32_t* out_idx;          // [b] (stride ostride with a Maglev column)
  int32_t* out_level;        // [b] (unused with a Maglev column)
  int32_t b, n_tiles, threads, split, stage_vec, q;
};

// The Maglev column, a parameter of the PICK instances alone: the
// verdict-only instances keep DenseHintArgs as it was, and with it their
// code (a parameter grown by these fields changed the SASS of the
// 32-bit verdict-only Q = 2 instance, which then read 7-9% slower on the
// H100: PERF.md).
struct DensePickArgs {
  const int32_t* mtab;       // [m] Maglev table
  const int64_t* slots;      // [b] flow slots (maglev.flow_slots)
  int32_t* out_pick;         // [b], stride ostride
  int32_t m, ostride;        // out_idx's and out_pick's row stride
};

struct DenseCidrArgs {
  const uint8_t* a16;        // [b, 16], 16-byte aligned rows
  const int32_t* fam;        // [b]
  const int32_t* port;       // [b], or null: no port gate
  const int32_t* v4;         // [n4, 4]: mask, value, rule, ports
  const int32_t* v6;         // [n6, 3, 4]: masks, values, (rule, ports)
  int32_t* out;              // [b], filled with -1 by the wrapper
  int32_t b, n4, n6, q, split4, split6;  // q: queries a thread, 1 or 4
};

namespace {

// The Maglev entry at a flow slot, clamped to [0, m - 1] as
// jnp.take(mode="clip") clamps it, through the read-only path.
__device__ __forceinline__ int maglev_at(const int32_t* mtab, int m,
                                         long long slot) {
  return __ldg(mtab + (slot < 0 ? 0 : (slot >= m ? m - 1 : slot)));
}

// Copy n_vec uint4s from `src` to `dst` (shared memory) with
// asynchronous 16-byte copies spread over the block, then commit them
// as one group.
__device__ __forceinline__ void stage(uint4* dst, const uint4* src,
                                      int n_vec) {
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, 16);
  __pipeline_commit();
}

__host__ __device__ constexpr int tile_vec(int hc, int uc) {
  return TILE * (1 + 3 * hc + 2 * uc);
}

// One query's host words (HOST_ORDER: the length byte's word 16 first;
// words 17-19 are 0) into registers, and its uri words into its column
// of `qu` (shared memory: chunk c of the block's slot s at c * slots +
// s); zeros for a dead slot.
__device__ __forceinline__ void load_query(const DenseHintArgs& a, int qi,
                                           uint32_t (&qh)[4 * HC_MAX],
                                           uint4* qu, int slots) {
  const bool live = qi < a.b;
#pragma unroll
  for (int w = 0; w < 4 * HC_MAX; ++w) qh[w] = 0;
#pragma unroll
  for (int w = 0; w < HOST_WORDS; ++w) {
    uint32_t x = 0;
    if (live) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int byte = 4 * w + k;
        if (byte < HOST_BYTES)
          x |= uint32_t(__ldg(a.q_host + (size_t)qi * HOST_BYTES + byte))
               << (8 * k);
      }
    }
    qh[w == HOST_WORDS - 1 ? 0 : w + 1] = x;
  }
  const uint4* qrow = reinterpret_cast<const uint4*>(a.q_uri) +
                      (size_t)(live ? qi : 0) * (URI_WORDS / 4);
#pragma unroll
  for (int k = 0; k < UC_MAX; ++k)
    qu[k * slots] = live ? __ldg(qrow + k) : make_uint4(0, 0, 0, 0);
}

}  // namespace

// One block's part of a hint batch (the kernels below are its entry
// points: the verdict-only instances take DenseHintArgs alone).
template <int Q, bool WIDE, bool PICK>
__device__ __forceinline__ void hint_block(const DenseHintArgs& a,
                                           const DensePickArgs& pa) {
  // the key: level fields over the complemented rule index
  using Key = typename std::conditional<WIDE, unsigned long long,
                                        uint32_t>::type;
  // two ring slots of stage_vec uint4s, then the queries' uri chunks
  extern __shared__ uint4 ring[];
  __shared__ unsigned int ticket;
  const int base = blockIdx.x * a.threads * Q + threadIdx.x;
  const int slots = a.threads * Q;
  uint4* qu = ring + 2 * a.stage_vec + threadIdx.x;
  uint32_t qh[Q][4 * HC_MAX];
  uint32_t hmask[Q], umask[Q];
  Key best[Q];
  int qport[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int qi = base + k * a.threads;
    const bool live = qi < a.b;
    load_query(a, qi, qh[k], qu + k * a.threads, slots);
    hmask[k] = live && a.has_host[qi] ? 3u << 30 : 0u;  // key fields
    umask[k] = live && a.has_uri[qi] ? 0x3FFu << 20 : 0u;
    qport[k] = live ? a.port[qi] : 0;
    best[k] = 0;
  }

  const int t0 = blockIdx.y * a.split;
  const int t1 = min(t0 + a.split, a.n_tiles);
  const uint4* rows = reinterpret_cast<const uint4*>(a.rows);
  const int4* tiles = reinterpret_cast<const int4*>(a.tiles);
  int4 td = t0 < t1 ? __ldg(tiles + t0) : make_int4(0, 0, 0, 0);
  if (t0 < t1)
    stage(ring, rows + td.x, tile_vec(td.y & 0xff, (td.y >> 8) & 0xff));
  if (PICK && blockIdx.y == 0) {  // while the first tile lands
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int qi = base + k * a.threads;
      if (qi < a.b)
        pa.out_pick[(size_t)qi * pa.ostride] = maglev_at(
            pa.mtab, pa.m,
            __ldg(reinterpret_cast<const long long*>(pa.slots) + qi));
    }
  }
  for (int t = t0; t < t1; ++t) {
    const int4 cur = td;
    if (t + 1 < t1) {  // tile t + 1 lands while tile t is compared
      td = __ldg(tiles + t + 1);
      stage(ring + ((t + 1 - t0) & 1) * a.stage_vec, rows + td.x,
            tile_vec(td.y & 0xff, (td.y >> 8) & 0xff));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // every thread's copies of tile t have landed
    const int hc = cur.y & 0xff, uc = (cur.y >> 8) & 0xff;
    const bool gated = (cur.y >> 16) & 1;
    const uint4* slot = ring + ((t - t0) & 1) * a.stage_vec;
    const int4* meta = reinterpret_cast<const int4*>(slot);
    const uint4* host = slot + TILE;
    const uint4* uri = host + TILE * 3 * hc;
#pragma unroll 1
    for (int j = 0; j < TILE; ++j) {
      const int4 mt = meta[j];  // uniform across the block
      // a tile without host chunks holds no host pattern: no exact or
      // suffix match, the wildcard alone
      uint32_t de[Q], ds[Q], du[Q];
#pragma unroll
      for (int k = 0; k < Q; ++k) de[k] = ds[k] = hc == 0, du[k] = 0;
      const uint4* hr = host + j * 3 * hc;
#pragma unroll
      for (int c = 0; c < HC_MAX; ++c) {
        if (c >= hc) break;  // uniform: the tile's count
        const uint4 me = hr[3 * c], ms = hr[3 * c + 1], v = hr[3 * c + 2];
#pragma unroll
        for (int k = 0; k < Q; ++k) {
          const uint32_t x0 = qh[k][4 * c] ^ v.x, x1 = qh[k][4 * c + 1] ^ v.y,
                         x2 = qh[k][4 * c + 2] ^ v.z,
                         x3 = qh[k][4 * c + 3] ^ v.w;
          de[k] |= (x0 & me.x) | (x1 & me.y) | (x2 & me.z) | (x3 & me.w);
          ds[k] |= (x0 & ms.x) | (x1 & ms.y) | (x2 & ms.z) | (x3 & ms.w);
        }
      }
      const uint4* ur = uri + j * 2 * uc;
#pragma unroll
      for (int c = 0; c < UC_MAX; ++c) {
        if (c >= uc) break;
        const uint4 m = ur[2 * c], v = ur[2 * c + 1];
#pragma unroll
        for (int k = 0; k < Q; ++k) {
          const uint4 w = qu[c * slots + k * a.threads];  // its own
          du[k] |= ((w.x ^ v.x) & m.x) | ((w.y ^ v.y) & m.y) |
                   ((w.z ^ v.z) & m.z) | ((w.w ^ v.w) & m.w);
        }
      }
      // mt: (0xFFFFF - index, port, uri level on a match | on a miss
      // << 10 | host wildcard << 20, live), taken apart once a rule into
      // the key's fields: levels at bit 30 (host) and 20 (uri)
      const uint32_t hit = (mt.z & 0x3FF) << 20;
      const uint32_t miss = ((mt.z >> 10) & 0x3FF) << 20;
      const uint32_t wild = ((mt.z >> 20) & 1) << 30;
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const uint32_t hl =
            de[k] == 0 ? 3u << 30 : (ds[k] == 0 ? 2u << 30 : wild);
        // a tile without uri chunks: every row's uri compare holds
        const uint32_t ul = uc == 0 || du[k] == 0 ? hit : miss;
        const uint32_t lv = (hl & hmask[k]) | (ul & umask[k]);
        Key key = WIDE ? ((Key)lv << 12) | (uint32_t)mt.x
                       : (Key)(lv | (uint32_t)mt.x);
        if (gated && !(qport[k] == 0 || mt.y == 0 || qport[k] == mt.y))
          key = 0;
        best[k] = max(best[k], key);
      }
    }
    __syncthreads();  // every warp is done with the slot refilled next
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int qi = base + k * a.threads;
    if (qi < a.b && best[k] > (WIDE ? WIDE_MASK : IDX_MASK))
      atomicMax(reinterpret_cast<Key*>(a.key) + qi, best[k]);
  }
  // the last block of this query tile writes the answers
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(a.done + blockIdx.x, 1u);
  __syncthreads();
  if (ticket != gridDim.y - 1) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int qi = base + k * a.threads;
    if (qi >= a.b) continue;
    const Key key = __ldcg(reinterpret_cast<const Key*>(a.key) + qi);
    const int level = (int)(key >> (WIDE ? 32 : 20));
    const unsigned mask = WIDE ? WIDE_MASK : IDX_MASK;
    const int idx = level > 0 ? (int)(mask - (unsigned)(key & mask)) : -1;
    if (PICK) {
      a.out_idx[(size_t)qi * pa.ostride] = idx;
    } else {
      a.out_idx[qi] = idx;
      a.out_level[qi] = level;
    }
  }
}

template <int Q, bool WIDE>
__global__ void __launch_bounds__(MAX_THREADS,
                                  WIDE ? WIDE_MIN_BLOCKS : HINT_MIN_BLOCKS)
dense_hint_kernel(const DenseHintArgs a) {
  hint_block<Q, WIDE, false>(a, DensePickArgs{});
}

template <int Q, bool WIDE>
__global__ void __launch_bounds__(MAX_THREADS,
                                  WIDE ? WIDE_MIN_BLOCKS : HINT_MIN_BLOCKS)
dense_hint_kernel_pick(const DenseHintArgs a, const DensePickArgs pa) {
  hint_block<Q, WIDE, true>(a, pa);
}

namespace {

// A block's part of a cidr batch for one family: the query tile's
// queries of that family, compacted, Q a thread; the block's range
// [r0, r1) of the family's list, CTILE entries a tile through a
// two-slot ring.
template <bool V6, int Q>
__device__ __forceinline__ void cidr_family(const DenseCidrArgs& a,
                                            uint4* ring, int* s_q,
                                            int* s_n, int r0, int r1) {
  constexpr int VEC = V6 ? 3 : 1;  // uint4s an entry
  const int fam = V6 ? 1 : 0;
  const uint4* list = reinterpret_cast<const uint4*>(V6 ? a.v6 : a.v4);
  const int stage_vec = CTILE * VEC;
  // the first tile is in flight while the queries are gathered
  if (r0 < r1)
    stage(ring, list + (size_t)r0 * VEC, min(CTILE, r1 - r0) * VEC);
  const int threads = blockDim.x;
  const int qbase = blockIdx.x * threads * Q;
  if (threadIdx.x == 0) *s_n = 0;
  __syncthreads();
  // every family loaded at once; then each warp counts its queries of
  // the family with a ballot and takes their places with one shared
  // atomic (one a query serialises)
  const int lane = threadIdx.x & 31;
  int qf[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int qi = qbase + k * threads + threadIdx.x;
    qf[k] = qi < a.b ? __ldg(a.fam + qi) : -1;
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const bool mine = qf[k] == fam;
    const unsigned ballot = __ballot_sync(0xffffffffu, mine);
    int at = 0;
    if (lane == 0 && ballot) at = atomicAdd(s_n, __popc(ballot));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (mine)
      s_q[at + __popc(ballot & ((1u << lane) - 1u))] =
          qbase + k * threads + threadIdx.x;
  }
  __syncthreads();
  const int nq = *s_n;
  if (nq == 0 || r0 >= r1) {  // uniform
    __pipeline_wait_prior(0);
    return;
  }
  const bool gate = a.port != nullptr;
  const int kq = (nq + threads - 1) / threads;  // slots in use, <= Q
  uint4 q[Q];
  int qi[Q], qport[Q];
  unsigned first[Q];  // the least matching rule so far, ~0u: none
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int s = k * threads + threadIdx.x;
    qi[k] = s < nq ? s_q[s] : -1;
    q[k] = qi[k] >= 0 ? __ldg(reinterpret_cast<const uint4*>(a.a16) + qi[k])
                      : make_uint4(0, 0, 0, 0);
    qport[k] = qi[k] >= 0 && gate ? __ldg(a.port + qi[k]) : 0;
    first[k] = qi[k] >= 0 ? ~0u : 0u;  // a dead slot is done (qi -1)
  }
  // the range's first rule: a candidate at or past it is this block's
  // own match (an earlier range's answer taken below lies before it)
  const unsigned range_head =
      __ldg(V6 ? a.v6 + (size_t)r0 * 12 + 8 : a.v4 + (size_t)r0 * 4 + 2);
  for (int t0 = r0, n = 0; t0 < r1; t0 += CTILE, ++n) {
    const int nt = min(CTILE, r1 - t0);
    // what earlier ranges' blocks answered, read while the tile lands
    unsigned seen[Q];
#pragma unroll
    for (int k = 0; k < Q; ++k)
      seen[k] = first[k] == ~0u ? (unsigned)__ldcg(a.out + qi[k]) : 0u;
    if (t0 + CTILE < r1) {
      stage(ring + ((n + 1) & 1) * stage_vec,
            list + (size_t)(t0 + CTILE) * VEC,
            min(CTILE, r1 - t0 - CTILE) * VEC);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    // a query is done once it has a match, or once an earlier range's
    // block answered it with a rule before this tile's first (taken as
    // its candidate, not its own: no atomic for it)
    const unsigned head =
        __ldg(V6 ? a.v6 + (size_t)t0 * 12 + 8 : a.v4 + (size_t)t0 * 4 + 2);
    bool done = true;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      if (first[k] == ~0u && seen[k] < head) first[k] = seen[k];
      done &= first[k] != ~0u;
    }
    if (__syncthreads_and(done)) {  // and every copy of the tile landed
      __pipeline_wait_prior(0);
      break;
    }
    const uint4* slot = ring + (n & 1) * stage_vec;
#pragma unroll 4
    for (int j = 0; j < nt; ++j) {
      const uint4 e = slot[j * VEC];  // uniform across the block
      unsigned rule, ports;
      uint4 v = e;
      if (V6) {
        v = slot[j * VEC + 1];
        const uint4 r = slot[j * VEC + 2];
        rule = r.x, ports = r.y;
      } else {
        rule = e.z, ports = e.w;
      }
      const int lo = ports & 0xFFFF, hi = ports >> 16;
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        if (k >= kq) break;  // uniform: no thread has a query here
        uint32_t d;
        if (V6)
          d = ((q[k].x ^ v.x) & e.x) | ((q[k].y ^ v.y) & e.y) |
              ((q[k].z ^ v.z) & e.z) | ((q[k].w ^ v.w) & e.w);
        else
          d = (q[k].w ^ e.y) & e.x;
        const bool port_ok = !gate || (lo <= qport[k] && qport[k] <= hi);
        if (d == 0 && port_ok) first[k] = min(first[k], rule);
      }
    }
    __syncthreads();  // every warp is done with the slot refilled next
  }
#pragma unroll
  for (int k = 0; k < Q; ++k)  // only its own matches: no atomic traffic
    if (qi[k] >= 0 && first[k] != ~0u && first[k] >= range_head)
      atomicMin(reinterpret_cast<unsigned int*>(a.out) + qi[k], first[k]);
}

}  // namespace

template <int Q>
__global__ void __launch_bounds__(MAX_THREADS)
dense_cidr_kernel(const DenseCidrArgs a) {
  __shared__ uint4 ring[2 * CTILE * 3];  // 6,144 B
  __shared__ int s_q[MAX_THREADS * CIDR_Q];
  __shared__ int s_n;
  const int y = blockIdx.y, y4 = (a.n4 + a.split4 - 1) / a.split4;
  if (y < y4)
    cidr_family<false, Q>(a, ring, s_q, &s_n, y * a.split4,
                          min((y + 1) * a.split4, a.n4));
  else
    cidr_family<true, Q>(a, ring, s_q, &s_n, (y - y4) * a.split6,
                         min((y - y4 + 1) * a.split6, a.n6));
}

namespace {

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// Every hint instance of one Q may take `bytes` of dynamic shared
// memory.
template <int Q>
cudaError_t opt_in(int bytes) {
  const cudaFuncAttribute at = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(dense_hint_kernel<Q, false>, at,
                                         bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dense_hint_kernel<Q, true>, at, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dense_hint_kernel_pick<Q, false>, at, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dense_hint_kernel_pick<Q, true>, at, bytes);
  return err;
}

template <int Q>
void launch_hint(const DenseHintArgs& a, const DensePickArgs* pick,
                 bool wide, dim3 grid, size_t smem, cudaStream_t s) {
  if (wide && pick != nullptr)
    dense_hint_kernel_pick<Q, true><<<grid, a.threads, smem, s>>>(a, *pick);
  else if (wide)
    dense_hint_kernel<Q, true><<<grid, a.threads, smem, s>>>(a);
  else if (pick != nullptr)
    dense_hint_kernel_pick<Q, false><<<grid, a.threads, smem, s>>>(a, *pick);
  else
    dense_hint_kernel<Q, false><<<grid, a.threads, smem, s>>>(a);
}

}  // namespace

extern "C" int vproxy_dense_hint_args_size() {
  return (int)sizeof(DenseHintArgs);
}
extern "C" int vproxy_dense_cidr_args_size() {
  return (int)sizeof(DenseCidrArgs);
}
extern "C" int vproxy_dense_pick_args_size() {
  return (int)sizeof(DensePickArgs);
}

// Launch on `stream` (PyTorch's current stream; no synchronisation).
// Returns cudaGetLastError() after the launch: 0 when it was accepted;
// cudaErrorInvalidValue, before any launch, for a block that is not
// 32-128 threads in warps, Q other than 1 or 2, a tile range of 0, a
// ring slot under the largest tile, a row array or uri batch that is
// not 16-byte aligned, a `wide` key array that is not 8-byte aligned,
// or a Maglev column without its table (m <= 0), slots, output or a row
// stride. The grid is ceil(b / (threads * q)) query tiles x
// ceil(n_tiles / split) ranges: the wrapper zero-fills `key` (32-bit,
// or 64-bit with `wide`: the WIDE instances) and `done` for the query
// tiles. A non-null `pick` runs the PICK instances: (verdict, pick) at
// out_idx / pick->out_pick with row stride pick->ostride, no level.
extern "C" int vproxy_dense_hint(const DenseHintArgs* args,
                                 const DensePickArgs* pick, int wide,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const DenseHintArgs& a = *args;
  if (a.b < 0 || a.n_tiles < 0 || a.threads <= 0 ||
      a.threads > MAX_THREADS || a.threads % 32 != 0 || a.split <= 0 ||
      (a.q != 1 && a.q != 2) || a.stage_vec < TILE ||
      a.stage_vec > tile_vec(HC_MAX, UC_MAX) || !aligned(a.q_uri, 16) ||
      !aligned(a.rows, 16) || !aligned(a.tiles, 16) ||
      (wide != 0 && wide != 1) || (wide && !aligned(a.key, 8)) ||
      (pick != nullptr &&
       (pick->mtab == nullptr || pick->slots == nullptr ||
        pick->out_pick == nullptr || pick->m <= 0 || pick->ostride <= 0)))
    return (int)cudaErrorInvalidValue;
  if (a.b == 0) return 0;
  const dim3 grid((a.b + a.threads * a.q - 1) / (a.threads * a.q),
                  a.n_tiles > 0 ? (a.n_tiles + a.split - 1) / a.split : 1);
  const size_t smem = (size_t)16 * (2 * a.stage_vec +
                                    UC_MAX * a.threads * a.q);
  static unsigned long long opted_in = 0;  // devices asked for > 48 KB
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidValue;
  if (!(opted_in >> device & 1)) {
    const int most = 16 * (2 * tile_vec(HC_MAX, UC_MAX) +
                           UC_MAX * MAX_THREADS * 2);
    err = opt_in<1>(most);
    if (err == cudaSuccess) err = opt_in<2>(most);
    if (err != cudaSuccess) return (int)err;
    opted_in |= 1ull << device;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.q == 2)
    launch_hint<2>(a, pick, wide != 0, grid, smem, s);
  else
    launch_hint<1>(a, pick, wide != 0, grid, smem, s);
  return (int)cudaGetLastError();
}

// The same for a cidr batch: Q = 1 query a thread up to 512 queries
// (more blocks, each with less work, hide the tiles' latency), else 4; the grid is ceil(b / (threads * Q)) query tiles x (the IPv4
// ranges of split4 entries + the IPv6 ranges of split6), each range a
// multiple of the 64-entry tile.
extern "C" int vproxy_dense_cidr(const DenseCidrArgs* args, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const DenseCidrArgs& a = *args;
  if (a.b < 0 || a.n4 < 0 || a.n6 < 0 || (a.q != 1 && a.q != CIDR_Q) ||
      a.split4 <= 0 ||
      a.split6 <= 0 || a.split4 % CTILE || a.split6 % CTILE ||
      !aligned(a.a16, 16) ||
      !aligned(a.v4, 16) || !aligned(a.v6, 16))
    return (int)cudaErrorInvalidValue;
  if (a.b == 0) return 0;
  const int y4 = (a.n4 + a.split4 - 1) / a.split4,
            y6 = (a.n6 + a.split6 - 1) / a.split6;
  if (y4 + y6 == 0) return 0;  // no pattern: every answer stays -1
  // up to 4 warps of queries, as few as the batch needs
  const int threads =
      min(MAX_THREADS, 32 * ((a.b + 32 * a.q - 1) / (32 * a.q)));
  const dim3 grid((a.b + threads * a.q - 1) / (threads * a.q), y4 + y6);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.q == 1)
    dense_cidr_kernel<1><<<grid, threads, 0, s>>>(a);
  else
    dense_cidr_kernel<CIDR_Q><<<grid, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
