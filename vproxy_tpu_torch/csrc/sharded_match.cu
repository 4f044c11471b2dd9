// The sharded winner reduction for Hopper (sm_90a): a batch of hint or
// CIDR queries against S rule shards, every (query, shard) pair and the
// winner across the shards in one launch per batch (B8).
//
// Replaces: vproxy_tpu/parallel/mesh.py `make_sharded_hint_fn` (:364),
// `make_sharded_cidr_fn` (:406) and `make_sharded_classify` (:449): the
// shard_map programs of the "jax-sharded" and "jax-fp-sharded" backends,
// where each device of the mesh's "rules" axis runs the single-shard
// matcher on its slice and the winner rides pmax / pmin collectives.
// Plain version: ops/sharded_cuda.py `hint_keys_plain` /
// `cidr_keys_plain` + `finish_plain` of this package, which tier-1
// holds int32-equal to the reference.
//
// What it computes. The tables are S per-shard tables compiled under
// one unified caps dict (vproxy_tpu/ops/hashmatch.py:816
// `_compile_sharded`), stacked on a leading shard axis; shard s holds
// the rules [s * size, (s + 1) * size) of the list. For shard s a query
// runs the unchanged single-shard routine on shard s's slice of the
// stacked arrays:
// * cuckoo hint: B3's `hint::warp_verdict` (hint_probe.cuh), over the
//   packed layout (ops/sharded_cuda.py `pack_hint_sharded`);
// * cuckoo CIDR (routes, ACL with its port gate): B4's
//   `cidr::block_first_match` (cidr_first.cuh);
// * fingerprint hint: B6's `fph::warp_best` (fp_hint.cuh);
// * fingerprint CIDR: B7's `fpc::block_first` (fp_cidr.cuh).
// The global answer (mesh.py:383-393, :418-437):
// * hint: the highest level over the shards with a match, then among
//   the shards at that level the least global index s * size + idx;
//   -1 when the best level is 0 (a shard that matched at level 0 never
//   wins);
// * CIDR: the least global index, -1 for none.
// The classify form answers hint, routes and ACL in the columns of one
// int32 [B, 3].
//
// The reduction is decided in the kernel, on one 64-bit key per
// (query, column), zero-filled before the launch and taken with
// atomicMax: hint key (level << 32) | (BIG - gidx) when the level is
// above 0, else no key; CIDR key BIG - gidx (the least index is the
// greatest key, so both columns reduce with one max, and one
// all_reduce(MAX) does for every column where the rules axis spans
// ranks). BIG = 2^30, the reference's sentinel, bounds gidx. The last
// block of a query tile (a device-scope ticket after a fence, as B9's)
// turns its keys into int32: BIG - (key & 0xffffffff), -1 for 0. A
// launch without `out` writes the keys only: parallel/mesh.py reduces
// them across the ranks of the rules axis, then `vproxy_sharded_finish`
// is the last pass.
//
// Bound. The bytes the S shards' probes read, each shard as its own
// single-shard kernel reads them (chip_smoke.py `work()` / `cidr_work()`
// / the fp counts, summed over the shards), plus each (query, column)
// key and answer, over the 3.35 TB/s HBM rate. As for B3 / B4 / B6 /
// B7, the time sits well above it: each pair walks the chain of
// dependent loads of its routine (4 steps for B3 / B4, 3 for B6 / B7).
//
// Design (simple first): a block is WARPS warps of one query tile, one
// shard and one column: blockIdx.x the query tile, blockIdx.y the
// shard (of the launch's local shards), blockIdx.z the column. Hint
// blocks run one warp per query as B3 / B6 do; CIDR blocks stage their
// shard's group rows once per block as B4 / B7 do. A shard's slice of a
// stacked array is the array's base plus the shard times its stride (in
// elements, passed per pointer; 0 for a query array every shard
// shares). S launches of the unsharded kernel and a torch max would
// answer the same, but pay S launches and a [S, B] round trip through
// memory; here the S x B pairs run side by side in one grid and only
// the keys are written.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cidr_first.cuh"
#include "fp_cidr.cuh"
#include "fp_hint.cuh"
#include "hint_probe.cuh"

namespace {

constexpr int WARPS = 4;  // queries per block (the routines' own shape)
// blocks per SM the register budget must allow: <= 128 registers. With
// no such bound ptxas took 72 registers and spilled 8 bytes in one
// instance; with it, 80-108 and no spill (a chip run's ptxas report).
constexpr int MIN_BLOCKS = 4;
constexpr unsigned long long BIG = 1ull << 30;
constexpr int HASH_STRIDES = 24;  // FusedArgs' pointers hostb .. wu_idx
constexpr int CIDR_STRIDES = 10;  // cidr::Table's pointers
constexpr int FPH_STRIDES = 19;   // FpHintArgs' pointers rec .. has_uri
constexpr int FPC_STRIDES = 12;   // FpCidrArgs' table pointers g_mask4 ..

}  // namespace

// Every field in the order of the ctypes mirrors in
// ops/sharded_cuda.py; their sizes are checked against
// vproxy_sharded_*_args_size() at load.
struct ShardedHashArgs {
  hint::FusedArgs h;         // hint column at the launch's first shard;
                             // h.pk_meta null: no hint column
  cidr::Table c[2];          // CIDR columns at the first shard (pk_cslot
                             // null: none)
  const uint8_t* a16;        // [B, 16] addresses (CIDR columns)
  const int32_t* fam;        // [B] family, -1 for pad rows
  const int32_t* cport[2];   // [B] a column's port gate, or null
  unsigned long long* keys;  // [B, ncols], zero-filled
  unsigned int* tickets;     // [tiles], zero-filled
  int32_t* out;              // [B, ncols], or null: the keys only
  long long hstride[HASH_STRIDES];     // elements per shard, 0: shared
  long long cstride[2][CIDR_STRIDES];
  int32_t b, ncols, s0;
  int32_t np, smem_words;    // set by the launcher
  int32_t size[3];           // shard size per column
};

struct ShardedFpArgs {
  fph::FpHintArgs h;         // hint column (h.rec null: none)
  fpc::FpCidrArgs c;         // CIDR column (c.rec null: none)
  unsigned long long* keys;  // [B, ncols], zero-filled
  unsigned int* tickets;     // [tiles], zero-filled
  int32_t* out;              // [B, ncols], or null: the keys only
  long long hstride[FPH_STRIDES];
  long long cstride[FPC_STRIDES];
  int32_t b, ncols, s0;
  int32_t smem_words;        // set by the launcher
  int32_t size[2];           // shard size per column
};

namespace {

template <typename T>
__device__ __forceinline__ void shift(T*& p, long long stride, int j) {
  if (p != nullptr) p += stride * j;
}

// The launch's arguments moved to local shard j.
__device__ __forceinline__ hint::FusedArgs hint_at(const ShardedHashArgs& a,
                                                   int j) {
  hint::FusedArgs h = a.h;
  const long long* st = a.hstride;
  shift(h.hostb, st[0], j);
  shift(h.urib, st[1], j);
  shift(h.hlen, st[2], j);
  shift(h.ulen, st[3], j);
  shift(h.port, st[4], j);
  shift(h.has_host, st[5], j);
  shift(h.has_uri, st[6], j);
  shift(h.hp_len, st[7], j);
  shift(h.hp_slot1, st[8], j);
  shift(h.hp_slot2, st[9], j);
  shift(h.up_len, st[10], j);
  shift(h.up_slot1, st[11], j);
  shift(h.up_slot2, st[12], j);
  shift(h.slots, st[13], j);
  shift(h.pk_meta, st[14], j);
  shift(h.pk_bytes, st[15], j);
  shift(h.pk_hslot, st[16], j);
  shift(h.pk_hkey, st[17], j);
  shift(h.pk_uslot, st[18], j);
  shift(h.pk_ukey, st[19], j);
  shift(h.hb_items, st[20], j);
  shift(h.ub_items, st[21], j);
  shift(h.wh_idx, st[22], j);
  shift(h.wu_idx, st[23], j);
  return h;
}

__device__ __forceinline__ cidr::Table cidr_at(const ShardedHashArgs& a,
                                               int ci, int j) {
  cidr::Table t = a.c[ci];
  const long long* st = a.cstride[ci];
  shift(t.pk_cslot, st[0], j);
  shift(t.pk_cmeta, st[1], j);
  shift(t.s_key, st[2], j);
  shift(t.cb_items, st[3], j);
  shift(t.g_fam, st[4], j);
  shift(t.g_mask, st[5], j);
  shift(t.g_off, st[6], j);
  shift(t.g_capmask, st[7], j);
  shift(t.g_salt1, st[8], j);
  shift(t.g_salt2, st[9], j);
  return t;
}

__device__ __forceinline__ fph::FpHintArgs fp_hint_at(const ShardedFpArgs& a,
                                                      int j) {
  fph::FpHintArgs h = a.h;
  const long long* st = a.hstride;
  shift(h.rec, st[0], j);
  shift(h.wh_rec, st[1], j);
  shift(h.wu_rec, st[2], j);
  shift(h.hp_slot, st[3], j);
  shift(h.hp_fp1, st[4], j);
  shift(h.hp_fp2, st[5], j);
  shift(h.hp_level, st[6], j);
  shift(h.up_slot, st[7], j);
  shift(h.up_fp1, st[8], j);
  shift(h.up_fp2, st[9], j);
  shift(h.up_score, st[10], j);
  shift(h.um_fp1, st[11], j);
  shift(h.um_fp2, st[12], j);
  shift(h.um_score, st[13], j);
  shift(h.q_hmeta, st[14], j);
  shift(h.hlen, st[15], j);
  shift(h.port, st[16], j);
  shift(h.has_host, st[17], j);
  shift(h.has_uri, st[18], j);
  return h;
}

__device__ __forceinline__ fpc::FpCidrArgs fp_cidr_at(const ShardedFpArgs& a,
                                                      int j) {
  fpc::FpCidrArgs c = a.c;
  const long long* st = a.cstride;
  shift(c.g_mask4, st[0], j);
  shift(c.g_fam, st[1], j);
  shift(c.g_salt_s, st[2], j);
  shift(c.g_salt_f1, st[3], j);
  shift(c.g_salt_f2, st[4], j);
  shift(c.g_off, st[5], j);
  shift(c.g_capmask, st[6], j);
  shift(c.rec, st[7], j);
  shift(c.mrows, st[8], j);
  shift(c.t_l0, st[9], j);
  shift(c.t_l1, st[10], j);
  shift(c.t_l2, st[11], j);
  return c;
}

__device__ __forceinline__ unsigned long long hint_key(int level, int s,
                                                       int size, int idx) {
  const unsigned long long g = (unsigned long long)s * size + idx;
  return level > 0 ? ((unsigned long long)level << 32) | (BIG - g) : 0ull;
}

__device__ __forceinline__ unsigned long long cidr_key(int s, int size,
                                                       int idx) {
  return BIG - ((unsigned long long)s * size + idx);
}

__device__ __forceinline__ int answer(unsigned long long k) {
  return k != 0 ? (int)(BIG - (k & 0xffffffffull)) : -1;
}

// This block's key into the batch, then the ticket: the last block of
// the query tile (of gridDim.y x gridDim.z) turns the tile's keys into
// answers when the launch has an output.
__device__ __forceinline__ void reduce(unsigned long long* keys,
                                       unsigned int* tickets, int32_t* out,
                                       int b, int ncols, int q, int col,
                                       unsigned long long key, int lane) {
  __shared__ unsigned int ticket;
  if (key != 0 && lane == 0 && q < b)
    atomicMax(keys + (size_t)q * ncols + col, key);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(tickets + blockIdx.x, 1u);
  __syncthreads();
  if (out == nullptr || ticket != gridDim.y * gridDim.z - 1) return;
  __threadfence();
  const int q0 = blockIdx.x * WARPS;
  for (int i = threadIdx.x; i < WARPS * ncols; i += blockDim.x) {
    const int qi = q0 + i / ncols;
    if (qi < b) {
      const size_t o = (size_t)q0 * ncols + i;
      out[o] = answer(__ldcg(keys + o));
    }
  }
}

template <bool URI, int W>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
sharded_hash_kernel(const ShardedHashArgs a) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  const int j = blockIdx.y;
  const int s = a.s0 + j;
  const int col = blockIdx.z;
  const bool hint_col = a.h.pk_meta != nullptr;  // column 0 when present
  unsigned long long key = 0;
  if (hint_col && col == 0) {
    if (q < a.b) {  // warp-uniform; no block sync on this path
      const hint::FusedArgs h = hint_at(a, j);
      int bl, bi;
      hint::warp_verdict<URI, W, false>(h, smem + warp * a.smem_words, q,
                                        a.np, lane, bl, bi);
      key = hint_key(bl, s, a.size[col], bi);
    }
  } else {  // every thread of the block: the routine syncs the block
    const int ci = col - (hint_col ? 1 : 0);
    const cidr::Table t = cidr_at(a, ci, j);
    const int r = cidr::block_first_match(t, smem, a.a16, a.fam,
                                          a.cport[ci], a.b, q, warp, lane,
                                          WARPS);
    if (r >= 0 && r < t.r_cap) key = cidr_key(s, a.size[col], r);
  }
  reduce(a.keys, a.tickets, a.out, a.b, a.ncols, q, col, key, lane);
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
sharded_fp_kernel(const ShardedFpArgs a) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  const int j = blockIdx.y;
  const int s = a.s0 + j;
  const int col = blockIdx.z;
  const bool hint_col = a.h.rec != nullptr;  // column 0 when present
  unsigned long long key = 0;
  if (hint_col && col == 0) {
    if (q < a.b) {  // warp-uniform; no block sync on this path
      const fph::FpHintArgs h = fp_hint_at(a, j);
      const int best =
          fph::warp_best(h, smem + (size_t)warp * a.smem_words, q, lane);
      if (best > 0)
        key = hint_key(best / (h.r_cap + 1), s, a.size[col],
                       h.r_cap - best % (h.r_cap + 1));
    }
  } else {  // every thread of the block: the routine syncs the block
    const fpc::FpCidrArgs c = fp_cidr_at(a, j);
    const int r = fpc::block_first(c, smem, q, warp, lane);
    if (q < a.b && r >= 0 && r < c.r_cap) key = cidr_key(s, a.size[col], r);
  }
  reduce(a.keys, a.tickets, a.out, a.b, a.ncols, q, col, key, lane);
}

__global__ void sharded_finish_kernel(const unsigned long long* keys,
                                      int32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = answer(keys[i]);
}

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// A per-shard stride (elements of `elem` bytes) that keeps every
// shard's slice as aligned as the base.
bool stride_ok(long long stride, size_t elem, size_t n) {
  return stride >= 0 && ((size_t)stride * elem) % n == 0;
}

template <int W>
cudaError_t launch_hash_word(const ShardedHashArgs& a, dim3 grid,
                             size_t smem, cudaStream_t s, bool uri) {
  if (uri)
    sharded_hash_kernel<true, W><<<grid, WARPS * 32, smem, s>>>(a);
  else
    sharded_hash_kernel<false, W><<<grid, WARPS * 32, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vproxy_sharded_hash_args_size() {
  return (int)sizeof(ShardedHashArgs);
}
extern "C" int vproxy_sharded_fp_args_size() {
  return (int)sizeof(ShardedFpArgs);
}

// Launch on `stream` (PyTorch's current stream; no synchronisation)
// over `shards` local shards. Returns cudaGetLastError() after the
// launch: 0 when it was accepted; cudaErrorInvalidValue, before any
// launch, for a column count that disagrees with the tables, a hint
// compare word that does not divide the windows or align the byte
// tables and every shard's slice of them, a CIDR table that is empty or
// whose 16-byte rows (or a shard's slice of them) are off 16 bytes, or
// more shared memory than a launch may take unasked (48 KB).
extern "C" int vproxy_sharded_hash(const ShardedHashArgs* args, int shards,
                                   int uri_rules, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ShardedHashArgs a = *args;
  if (a.b <= 0) return 0;
  const bool hint_col = a.h.pk_meta != nullptr;
  int nc = 0;
  size_t smem = 0;
  if (hint_col) {
    const hint::FusedArgs& h = a.h;
    a.np = 2 * h.maxp + (uri_rules ? 2 * h.lw : 0);
    a.smem_words = hint::warp_smem_words(h, a.np, uri_rules);
    const int w = h.word;
    const long long* st = a.hstride;
    const bool ok_w =
        (w == 16 || w == 8 || w == 4 || w == 1) && h.hw % w == 0 &&
        h.hw <= hint::MAX_HW && aligned(h.pk_bytes, w) &&
        aligned(h.pk_hkey, w) && stride_ok(st[15], 1, w) &&
        stride_ok(st[17], 1, w) && aligned(h.pk_meta, 16) &&
        aligned(h.pk_hslot, 16) && stride_ok(st[14], 4, 16) &&
        stride_ok(st[16], 4, 16) &&
        (!uri_rules || (h.uw % w == 0 && h.uw <= hint::MAX_UW &&
                        h.ukw == h.uw && aligned(h.pk_ukey, w) &&
                        stride_ok(st[19], 1, w) && aligned(h.pk_uslot, 16) &&
                        stride_ok(st[18], 4, 16)));
    if (!ok_w || h.b != a.b || h.mtab != nullptr || a.np <= 0)
      return (int)cudaErrorInvalidValue;
    smem = (size_t)a.smem_words * 4 * WARPS;
  }
  for (int i = 0; i < 2; ++i) {
    const cidr::Table& t = a.c[i];
    if (t.pk_cslot == nullptr) continue;
    if (i != nc) return (int)cudaErrorInvalidValue;  // columns in order
    const long long* st = a.cstride[i];
    if (t.ct <= 0 || t.r_cap <= 0 || t.cb <= 0 || t.g <= 0 ||
        a.fam == nullptr || !aligned(a.a16, 16) ||
        !aligned(t.pk_cslot, 16) || !aligned(t.pk_cmeta, 16) ||
        !aligned(t.s_key, 16) || !aligned(t.g_mask, 16) ||
        !stride_ok(st[0], 4, 16) || !stride_ok(st[1], 4, 16) ||
        !stride_ok(st[2], 1, 16) || !stride_ok(st[5], 1, 16))
      return (int)cudaErrorInvalidValue;
    const size_t need = cidr::block_bytes(t.g, WARPS);
    if (need > smem) smem = need;
    ++nc;
  }
  if (shards <= 0 || a.ncols != (hint_col ? 1 : 0) + nc || a.ncols <= 0 ||
      smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.b + WARPS - 1) / WARPS, shards, a.ncols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool uri = hint_col && uri_rules;
  switch (hint_col ? a.h.word : 16) {
    case 16: return (int)launch_hash_word<16>(a, grid, smem, s, uri);
    case 8: return (int)launch_hash_word<8>(a, grid, smem, s, uri);
    case 4: return (int)launch_hash_word<4>(a, grid, smem, s, uri);
    default: return (int)launch_hash_word<1>(a, grid, smem, s, uri);
  }
}

// The fingerprint tables' form (B6 / B7's routines); errors as above,
// with B6's and B7's own checks (fp_hint.cu, fp_cidr.cu) per column.
extern "C" int vproxy_sharded_fp(const ShardedFpArgs* args, int shards,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ShardedFpArgs a = *args;
  if (a.b <= 0) return 0;
  const bool hint_col = a.h.rec != nullptr;
  const bool cidr_col = a.c.rec != nullptr;
  size_t smem = 0;
  if (hint_col) {
    const fph::FpHintArgs& h = a.h;
    a.smem_words = fph::warp_words(h);
    const long long* st = a.hstride;
    if (h.b != a.b || h.rows <= 0 || h.w <= 0 || h.p <= 0 || h.u <= 0 ||
        h.whc <= 0 || h.wuc <= 0 || h.he <= 0 || h.ue <= 0 || h.hm <= 0 ||
        h.um <= 0 || h.r_cap <= 0 || h.rw % 2 != 0 ||
        h.he * (2 + 4 * h.hm) > h.rw || h.ue * (2 + 4 * h.um) > h.rw ||
        (long long)h.rows * h.rw >= (1ll << 31) ||
        (h.um_fp1 != nullptr && h.l <= 0) || !aligned(h.rec, 8) ||
        !aligned(h.wh_rec, 8) || !aligned(h.wu_rec, 8) ||
        !stride_ok(st[0], 4, 8) || !stride_ok(st[1], 4, 8) ||
        !stride_ok(st[2], 4, 8))
      return (int)cudaErrorInvalidValue;
    smem = (size_t)WARPS * a.smem_words * 4;
  }
  if (cidr_col) {
    const fpc::FpCidrArgs& c = a.c;
    const long long* st = a.cstride;
    if (c.b != a.b || c.ct <= 0 || c.e <= 0 || c.r_cap <= 0 || c.g < 0 ||
        !aligned(c.a16, 16) || !aligned(c.g_mask4, 16) ||
        !aligned(c.rec, 16) || !stride_ok(st[0], 4, 16) ||
        !stride_ok(st[7], 4, 16) ||
        (c.mrows != nullptr &&
         (c.nm <= 0 || c.mk <= 0 || !aligned(c.mrows, 8) ||
          !stride_ok(st[8], 4, 8))) ||
        (c.t_l0 != nullptr && (c.s1 <= 0 || c.s2 <= 0)))
      return (int)cudaErrorInvalidValue;
    const size_t need = fpc::block_bytes(c.g);
    if (need > smem) smem = need;
  }
  if (shards <= 0 || a.ncols != (hint_col ? 1 : 0) + (cidr_col ? 1 : 0) ||
      a.ncols <= 0 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.b + WARPS - 1) / WARPS, shards, a.ncols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sharded_fp_kernel<<<grid, WARPS * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The last pass of a launch made without `out`, after the keys were
// reduced across ranks: n keys -> n answers.
extern "C" int vproxy_sharded_finish(const unsigned long long* keys,
                                     int32_t* out, int n, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sharded_finish_kernel<<<(n + 255) / 256, 256, 0, s>>>(keys, out, n);
  return (int)cudaGetLastError();
}
