// CIDR first match for Hopper (sm_90a): the route or ACL rule of each
// query of a batch, one launch per batch (B4).
//
// Replaces: vproxy_tpu/ops/hashmatch.py:723 `cidr_hash_match` (with
// `_fnv32_device`, :713), the XLA program every `cidr` batch of
// ClassifyService runs (rules/engine.py CidrMatcher.dispatch_snap). It
// reads the packed layout (ops/fused.py pack_cidr_table), so its plain
// version is ops/fused.py `_cidr_first_packed`, which tier-1 holds
// equal to ops/hashmatch.py `cidr_hash_match`. The routine itself is
// cidr_first.cuh, shared with the route column of
// fused_classify_pick.cu; its note gives the design.
//
// Bound. Per query the kernel reads its 16-byte address, its family, a
// port when the table is an ACL, and writes one int32; per live pair
// (a group of the query's family, two salts each) one 16-byte slot
// record and one 16-byte key; per entry of a matching bucket 4 bytes;
// per listed rule one 16-byte meta row; and once per batch the g_*
// rows. No products and ~40 integer ops per pair, so the floor is those
// distinct bytes over the 3.35 TB/s HBM rate (chip_smoke.py
// `cidr_work()`), read against the cold time. Well above it, the time
// is latency: the chain of dependent loads one query walks. The
// routine's note (cidr_first.cuh) counts that chain: ~16 steps for a
// route query and up to ~50 for a deep ACL bucket in the first version
// of the routine, which walked a lane's pairs and a bucket's entries
// one after another; 4 here (the block's group rows and the query ->
// slot records and keys -> bucket entries -> meta rows) while a query
// has at most 96 live pairs and 128 bucket entries, the warp's lanes
// taking pairs and entries side by side. wgmma and TMA tiles do not
// serve it (no products; scattered 16-byte rows chosen by the data):
// the group rows are the one contiguous read, staged into shared
// memory once per block with cp.async.
//
// Launch shape: one warp per query, WARPS queries per block, at most
// 64 registers (MIN_BLOCKS blocks of WARPS warps per SM), so B = 4096
// (1,024 blocks) is one wave on 132 SMs; dynamic shared memory is
// cidr::block_bytes: the staged group rows (36 B per group) plus, per
// warp, the family's group list and the entry list. The kernel is the
// routine's block_first_match, which the route column of
// fused_classify_pick.cu runs in its route blocks too. At B = 4096
// every SM is full and the time follows the 32-byte sectors the batch
// reads from L2 (two per live pair, the staged rows once per block)
// more than the chain (PERF.md).

#include "cidr_first.cuh"

namespace {

constexpr int WARPS = 4;       // queries per block
constexpr int MIN_BLOCKS = 8;  // blocks per SM: <= 64 registers

}  // namespace

// Every pointer first, then every int: the ctypes mirror in
// ops/cidr_cuda.py has the same order, and its size is checked against
// vproxy_cidr_args_size() at load.
struct CidrArgs {
  const uint8_t* a16;        // [B, 16] addresses
  const int32_t* fam;        // [B] family, -1 for pad rows
  const int32_t* port;       // [B], or null: no port gate (routes)
  const int32_t* pk_cslot;   // [ct, 4]
  const int32_t* pk_cmeta;   // [r_cap, 4]
  const uint8_t* s_key;      // [ct, 16]
  const int32_t* cb_items;   // [cb]
  const int32_t* g_fam;      // [g]
  const uint8_t* g_mask;     // [g, 16]
  const int32_t* g_off;      // [g]
  const int32_t* g_capmask;  // [g]
  const uint32_t* g_salt1;   // [g]
  const uint32_t* g_salt2;   // [g]
  int32_t* out;              // [B] first match, -1 for none
  int32_t b, ct, r_cap, cb, g, bk;
};

namespace {

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
cidr_first_kernel(CidrArgs a) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  const cidr::Table t = {a.pk_cslot, a.pk_cmeta, a.s_key, a.cb_items,
                         a.g_fam, a.g_mask, a.g_off, a.g_capmask,
                         a.g_salt1, a.g_salt2, a.ct, a.r_cap, a.cb, a.g,
                         a.bk};
  const int best = cidr::block_first_match(t, smem, a.a16, a.fam, a.port,
                                           a.b, b, warp, lane, WARPS);
  if (b < a.b && lane == 0) a.out[b] = best < a.r_cap ? best : -1;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int vproxy_cidr_args_size() { return (int)sizeof(CidrArgs); }

// Launch on `stream` (PyTorch's current stream; no synchronisation).
// Returns cudaGetLastError() after the launch: 0 when it was accepted;
// cudaErrorInvalidValue, before any launch, for an empty table or a
// 16-byte row array that is not 16-byte aligned.
extern "C" int vproxy_cidr_first(const CidrArgs* args, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const CidrArgs& a = *args;
  if (a.b <= 0) return 0;
  if (a.ct <= 0 || a.r_cap <= 0 || a.cb <= 0 || a.g <= 0 ||
      !aligned16(a.a16) || !aligned16(a.pk_cslot) ||
      !aligned16(a.pk_cmeta) || !aligned16(a.s_key) || !aligned16(a.g_mask))
    return (int)cudaErrorInvalidValue;
  // 8.7 KB at 128 groups; a table has at most 162 live groups of
  // prefix masks, far below the 48 KB a launch may take unasked
  const size_t smem = cidr::block_bytes(a.g, WARPS);
  const dim3 grid((a.b + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cidr_first_kernel<<<grid, block, smem, s>>>(a);
  return (int)cudaGetLastError();
}
