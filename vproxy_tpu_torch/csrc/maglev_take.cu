// The Maglev take for Hopper (sm_90a): the pick column of a Maglev
// table gathered at a batch's flow slots, clipped to the table, one
// launch per batch (B5).
//
// Replaces: vproxy_tpu/rules/maglev.py:235 `_device_take`, the jitted
// `jnp.take(table, slots, mode="clip")` every classify+pick batch of an
// unfused backend runs after its hint program (the reference's
// two-dispatch chain: "jax-fp" and "jax-dense"; the fused backend takes
// the column inside its one kernel). Plain version: the torch indexing
// of rules/maglev.py `_device_take` on CPU tensors.
//
// What it computes: out[i] = mtab[clamp(slots[i], 0, M - 1)], int32 out,
// int64 slots (host-computed by maglev.flow_slots, the one slot-hash
// contract), M the table's length.
//
// In this package the classify+pick batches of the unfused backends
// carry the same take as the Maglev column of their hint kernel (B6,
// B8, B9: one launch a batch); this kernel serves the standalone
// Maglev batches (rules/maglev.py MaglevMatcher.dispatch_snap / match).
//
// Bound: 16 bytes a flow (an 8-byte slot read, a 4-byte column entry
// gathered, a 4-byte pick written) over the 3.35 TB/s HBM rate: well
// under a microsecond at any batch the service forms, so a launch is
// latency: one dependent load (the slot, then the entry). Design: a
// thread per flow, 256 to a block, coalesced slot loads and stores,
// the gather through the read-only path.

#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr int THREADS = 256;
}

__global__ void __launch_bounds__(THREADS)
maglev_take_kernel(const int32_t* __restrict__ mtab, int m,
                   const int64_t* __restrict__ slots, int b,
                   int32_t* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= b) return;
  const int64_t s = __ldg(slots + i);
  out[i] = __ldg(mtab + (s < 0 ? 0 : s >= m ? m - 1 : s));
}

// Launch on `stream` (PyTorch's current stream; no synchronisation).
// Returns cudaGetLastError() after the launch: 0 when it was accepted;
// cudaErrorInvalidValue, before any launch, for an empty table or a
// negative batch.
extern "C" int vproxy_maglev_take(const int32_t* mtab, int m,
                                  const int64_t* slots, int b,
                                  int32_t* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m <= 0 || b < 0) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  maglev_take_kernel<<<(b + THREADS - 1) / THREADS, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(mtab, m, slots,
                                                            b, out);
  return (int)cudaGetLastError();
}
