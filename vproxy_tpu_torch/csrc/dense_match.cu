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
// exact, with no [B, N] count matrix in device memory, over a table
// ~16x smaller than the float32 planes (ops/dense_cuda.py packs it
// when a matcher publishes).
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
// integer-op bound: 2 ops a compared word (the LOP3 of (q ^ v) & m,
// the OR into the pattern's mismatch), e.g. 512 queries x 100,000 live
// rules x (2 x 17 host + 32 uri words) x 2 ~ 6.8e9 int32 ops, ~0.4 ms at
// chip_smoke.py's INT_OPS_PER_S, when every word is compared. The
// packed table (528 B a hint rule: ~56 MB at cap 106,496; 96 B a CIDR
// rule) takes ~17 us from HBM. chip_smoke.py `dense_hint_work()` /
// `dense_cidr_work()` count the words this batch's data needs (of each
// pattern, the words with a mask bit, ops/dense_cuda.py
// `hint_pattern_words` / `cidr_slot_words`; a query's host words only
// when it has a host, its uri words only when it has a uri, only the
// rules its port gate admits; for cidr, the rules up to each query's
// first match) and the bound is the larger of the two times.
//
// Design (simple first):
// * a thread per query, its query words in registers (17 host words,
//   the length-byte word first, and 32 uri words); a block is up to 4
//   warps of queries (fewer for a small batch);
// * the grid spans query tiles x rule ranges, about 16 blocks per SM
//   (ops/dense_cuda.py `grid`: ranges of at least one tile), so B = 16
//   still fills the 132 SMs;
// * a block walks its rule range in tiles of TILE rules: the tile's rows
//   and meta are staged into shared memory with asynchronous 16-byte
//   copies (every copy of the tile in flight at once), then every warp
//   reads a rule's words as warp-uniform (broadcast) 16-byte shared
//   loads. A first design read the rows straight from global memory,
//   one word behind the last: each rule waited on a chain of dependent
//   misses, and the kernel ran latency-bound far above its op bound;
// * a rule row is rule-major: 17 host words of (exact m, exact v,
//   suffix m, suffix v), then 16 of two uri words (m, v, m, v); the
//   rule's meta (flags, live word counts, uri score, port) is one int4.
//   Host words are ordered length-byte word first: the live prefix of
//   an exact pattern is then 1 + ceil(len / 4) words, of a suffix 2 +
//   floor(len / 4), of a uri ceil(len / 4), and the loops stop at the
//   rule's counts (uniform across the block: no divergence). Rules with
//   no host or no uri pattern skip that half;
// * hint: each thread keeps its best (level, index) over its range
//   (ascending, so the earliest wins ties) and ORs it into one 64-bit
//   atomicMax key per query, (level << 32) | (0xFFFFFFFF - index): max
//   level, then least index, whatever order blocks run in. The last
//   block of a query tile to finish (a device-scope ticket after a
//   fence) writes (index, level);
// * cidr: each thread stops at its first match in the range (the block
//   leaves the range once all its queries have one) and takes
//   atomicMin on the answer as unsigned: the wrapper fills it with -1
//   (0xFFFFFFFF), so a query with no match keeps -1 and no second pass
//   is needed.
// Both reductions are order-independent: the result is deterministic.

#include <cstdint>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int HOST_BYTES = 66;  // HOST_SLOT: 65 reversed bytes + length
constexpr int HOST_WORDS = 17;  // padded to 68 bytes
constexpr int URI_WORDS = 32;   // MAX_URI = 128 bytes
constexpr int URI_PAIRS = URI_WORDS / 2;
constexpr int CIDR_SLOTS = 3;
constexpr int MAX_THREADS = 128;
constexpr int TILE = 32;  // rules a block stages in shared memory at once

// hint meta.x: flags in bits 0-7, live word counts above
constexpr int F_ACTIVE = 1, F_EXACT = 2, F_SUFFIX = 4, F_HWILD = 8,
              F_URI = 16, F_UWILD = 32;
// cidr meta.x: slot s valid at bit s, its family (1 = V6) at bit 3 + s

}  // namespace

struct DenseHintArgs {
  const uint8_t* q_host;     // [b, 66]
  const uint8_t* q_uri;      // [b, 128], 16-byte aligned rows
  const uint8_t* has_host;   // bool [b]
  const uint8_t* has_uri;    // bool [b]
  const int32_t* port;       // [b]
  const int32_t* hrows;      // [n, 17, 4]
  const int32_t* urows;      // [n, 16, 4]
  const int32_t* meta;       // [n, 4]
  unsigned long long* key;   // [b], zero-filled by the wrapper
  unsigned int* done;        // [tiles], zero-filled by the wrapper
  int32_t* out_idx;          // [b]
  int32_t* out_level;        // [b]
  int32_t b, n, threads, split;
};

struct DenseCidrArgs {
  const uint8_t* a16;        // [b, 16], 16-byte aligned rows
  const int32_t* fam;        // [b]
  const int32_t* port;       // [b], or null: no port gate
  const int32_t* rows;       // [n, 6, 4]
  const int32_t* meta;       // [n, 4]
  int32_t* out;              // [b], filled with -1 by the wrapper
  int32_t b, n, threads, split;
};

// Stage rules [t0, t0 + nt) of `n_vec` uint4s each from `src` into
// `dst` (shared memory) with asynchronous 16-byte copies: every copy of
// the tile is in flight at once, and none holds a register.
__device__ __forceinline__ void stage(uint4* dst, const uint4* src, int t0,
                                      int nt, int n_vec) {
  src += (size_t)t0 * n_vec;
  for (int i = threadIdx.x; i < nt * n_vec; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, 16);
}

__global__ void __launch_bounds__(MAX_THREADS)
dense_hint_kernel(const DenseHintArgs a) {
  __shared__ uint4 s_host[TILE * HOST_WORDS];  // 8,704 B
  __shared__ uint4 s_uri[TILE * URI_PAIRS];    // 8,192 B
  __shared__ int4 s_meta[TILE];
  __shared__ unsigned int ticket;
  const int qi = blockIdx.x * a.threads + threadIdx.x;
  const bool live = qi < a.b;
  // the query's words: host word 16 (the length byte's) first
  uint32_t qh[HOST_WORDS], qu[URI_WORDS];
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
  for (int k = 0; k < URI_WORDS / 4; ++k) {
    const uint4 t = live ? __ldg(qrow + k) : make_uint4(0, 0, 0, 0);
    qu[4 * k] = t.x, qu[4 * k + 1] = t.y, qu[4 * k + 2] = t.z,
    qu[4 * k + 3] = t.w;
  }
  const bool has_host = live && a.has_host[qi];
  const bool has_uri = live && a.has_uri[qi];
  const int qport = live ? a.port[qi] : 0;

  const int r0 = blockIdx.y * a.split;
  const int r1 = min(r0 + a.split, a.n);
  int best_level = 0, best_idx = 0;
  for (int t0 = r0; t0 < r1; t0 += TILE) {
    const int nt = min(TILE, r1 - t0);
    __syncthreads();  // every warp is done with the last tile
    stage(s_host, reinterpret_cast<const uint4*>(a.hrows), t0, nt,
          HOST_WORDS);
    stage(s_uri, reinterpret_cast<const uint4*>(a.urows), t0, nt,
          URI_PAIRS);
    stage(reinterpret_cast<uint4*>(s_meta),
          reinterpret_cast<const uint4*>(a.meta), t0, nt, 1);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      const int4 mt = s_meta[j];  // uniform across the block
      const int flags = mt.x & 0xff;
      if (!(flags & F_ACTIVE)) continue;
      int hl = 0, ul = 0;
      if (flags & (F_EXACT | F_SUFFIX)) {
        const int nw = max((mt.x >> 8) & 0xff, (mt.x >> 16) & 0xff);
        const uint4* row = s_host + j * HOST_WORDS;
        uint32_t de = 0, ds = 0;
#pragma unroll
        for (int w = 0; w < HOST_WORDS; ++w) {
          if (w >= nw) break;
          const uint4 t = row[w];  // (exact m, v, suffix m, v)
          de |= (qh[w] ^ t.y) & t.x;
          ds |= (qh[w] ^ t.w) & t.z;
        }
        hl = ((flags & F_EXACT) && de == 0) ? 3
             : ((flags & F_SUFFIX) && ds == 0) ? 2 : 0;
      }
      if (flags & F_HWILD) hl = max(hl, 1);
      if (flags & F_URI) {
        const int nu = (mt.x >> 24) & 0xff;
        const uint4* row = s_uri + j * URI_PAIRS;
        uint32_t du = 0;
#pragma unroll
        for (int k = 0; k < URI_PAIRS; ++k) {
          if (2 * k >= nu) break;
          const uint4 t = row[k];  // (m, v) of words 2k and 2k + 1
          du |= ((qu[2 * k] ^ t.y) & t.x) | ((qu[2 * k + 1] ^ t.w) & t.z);
        }
        if (du == 0) ul = mt.y;
      }
      if (flags & F_UWILD) ul = max(ul, 1);
      if (!has_host) hl = 0;
      if (!has_uri) ul = 0;
      int level = (hl << 10) + ul;
      if (!(qport == 0 || mt.z == 0 || qport == mt.z)) level = 0;
      if (level > best_level) best_level = level, best_idx = t0 + j;
    }
  }
  if (live && best_level > 0)
    atomicMax(a.key + qi, ((unsigned long long)best_level << 32) |
                              (0xFFFFFFFFu - (uint32_t)best_idx));
  // the last block of this query tile writes the answers
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(a.done + blockIdx.x, 1u);
  __syncthreads();
  if (ticket != gridDim.y - 1 || !live) return;
  __threadfence();
  const unsigned long long k = __ldcg(a.key + qi);
  const int level = (int)(k >> 32);
  a.out_idx[qi] = level > 0 ? (int)(0xFFFFFFFFu - (uint32_t)k) : -1;
  a.out_level[qi] = level;
}

__global__ void __launch_bounds__(MAX_THREADS)
dense_cidr_kernel(const DenseCidrArgs a) {
  __shared__ uint4 s_rows[TILE * 2 * CIDR_SLOTS];  // 3,072 B
  __shared__ int4 s_meta[TILE];
  const int qi = blockIdx.x * a.threads + threadIdx.x;
  const bool live = qi < a.b;
  uint4 q = make_uint4(0, 0, 0, 0);
  int qfam = -1, qport = 0;
  if (live) {
    q = __ldg(reinterpret_cast<const uint4*>(a.a16) + qi);
    qfam = a.fam[qi];
    if (a.port != nullptr) qport = a.port[qi];
  }
  bool done = qfam != 0 && qfam != 1;  // no query, or a pad row
  const int r0 = blockIdx.y * a.split;
  const int r1 = min(r0 + a.split, a.n);
  for (int t0 = r0; t0 < r1; t0 += TILE) {
    // the block leaves its range once every query has its first match
    if (__syncthreads_and(done)) break;
    const int nt = min(TILE, r1 - t0);
    stage(s_rows, reinterpret_cast<const uint4*>(a.rows), t0, nt,
          2 * CIDR_SLOTS);
    stage(reinterpret_cast<uint4*>(s_meta),
          reinterpret_cast<const uint4*>(a.meta), t0, nt, 1);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int j = 0; j < nt && !done; ++j) {
      const int4 mt = s_meta[j];
      if (a.port != nullptr && !(mt.y <= qport && qport <= mt.z)) continue;
      bool hit = false;
#pragma unroll
      for (int s = 0; s < CIDR_SLOTS; ++s) {
        if (!((mt.x >> s) & 1) || ((mt.x >> (3 + s)) & 1) != qfam) continue;
        const uint4 m = s_rows[(j * CIDR_SLOTS + s) * 2];
        const uint4 v = s_rows[(j * CIDR_SLOTS + s) * 2 + 1];
        hit |= (((q.x ^ v.x) & m.x) | ((q.y ^ v.y) & m.y) |
                ((q.z ^ v.z) & m.z) | ((q.w ^ v.w) & m.w)) == 0;
      }
      if (hit) {
        atomicMin(reinterpret_cast<unsigned int*>(a.out) + qi,
                  (unsigned)(t0 + j));
        done = true;
      }
    }
  }
}

namespace {

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

bool bad_grid(int b, int n, int threads, int split) {
  return b < 0 || n < 0 || threads <= 0 || threads > MAX_THREADS ||
         threads % 32 != 0 || split <= 0;
}

dim3 grid_of(int b, int n, int threads, int split) {
  return dim3((b + threads - 1) / threads, n > 0 ? (n + split - 1) / split
                                                 : 1);
}

}  // namespace

extern "C" int vproxy_dense_hint_args_size() {
  return (int)sizeof(DenseHintArgs);
}
extern "C" int vproxy_dense_cidr_args_size() {
  return (int)sizeof(DenseCidrArgs);
}

// Launch on `stream` (PyTorch's current stream; no synchronisation).
// Returns cudaGetLastError() after the launch: 0 when it was accepted;
// cudaErrorInvalidValue, before any launch, for a block that is not
// 32-128 threads in warps, a rule range of 0, or a row array or uri
// batch that is not 16-byte aligned. The grid's y extent is
// ceil(n / split): the wrapper zero-fills `done` for its x extent.
extern "C" int vproxy_dense_hint(const DenseHintArgs* args, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const DenseHintArgs& a = *args;
  if (bad_grid(a.b, a.n, a.threads, a.split) || !aligned(a.q_uri, 16) ||
      !aligned(a.hrows, 16) || !aligned(a.urows, 16) ||
      !aligned(a.meta, 16))
    return (int)cudaErrorInvalidValue;
  if (a.b == 0) return 0;
  dense_hint_kernel<<<grid_of(a.b, a.n, a.threads, a.split), a.threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int vproxy_dense_cidr(const DenseCidrArgs* args, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const DenseCidrArgs& a = *args;
  if (bad_grid(a.b, a.n, a.threads, a.split) || !aligned(a.a16, 16) ||
      !aligned(a.rows, 16) || !aligned(a.meta, 16))
    return (int)cudaErrorInvalidValue;
  if (a.b == 0) return 0;
  dense_cidr_kernel<<<grid_of(a.b, a.n, a.threads, a.split), a.threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
