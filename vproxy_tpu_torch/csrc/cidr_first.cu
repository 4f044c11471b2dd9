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
// port when the table is an ACL, and writes one int32; per live probe
// (a group of the query's family, two salts each) one 16-byte slot
// record and one 16-byte key; per entry of a matching bucket 4 bytes;
// per listed rule one 16-byte meta row; and once per batch the g_*
// rows. There is no arithmetic to speak of (16 FNV rounds per probe),
// so the floor is those distinct bytes over the 3.35 TB/s HBM rate
// (chip_smoke.py `cidr_work()`). Well above it, the time is latency:
// per lane, its probes one after another, each a chain of dependent
// loads (group row -> slot record and key -> bucket entries -> meta
// rows). This first version keeps that simple and exact; shortening
// the chain (every probe of a lane in flight at once) is later work.

#include "cidr_first.cuh"

namespace {

constexpr int WARPS = 4;  // queries per block

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

__global__ void __launch_bounds__(WARPS * 32)
cidr_first_kernel(CidrArgs a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= a.b) return;  // warp-uniform: the whole warp leaves together
  const cidr::Table t = {a.pk_cslot, a.pk_cmeta, a.s_key, a.cb_items,
                         a.g_fam, a.g_mask, a.g_off, a.g_capmask,
                         a.g_salt1, a.g_salt2, a.ct, a.r_cap, a.cb, a.g,
                         a.bk};
  const uint4 addr = __ldg(reinterpret_cast<const uint4*>(a.a16) + b);
  const int fam = __ldg(a.fam + b);
  const bool gate = a.port != nullptr;
  const int port = gate ? __ldg(a.port + b) : 0;
  const int best = cidr::first_match(t, addr, fam, gate, port, lane);
  if (lane == 0) a.out[b] = best < a.r_cap ? best : -1;
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
  const dim3 grid((a.b + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cidr_first_kernel<<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}
