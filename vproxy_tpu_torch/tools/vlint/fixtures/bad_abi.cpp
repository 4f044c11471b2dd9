// vlint ABI-pass fixture: a mirror whose TOTAL size matches the
// python side exactly but whose fields drifted — the compensating-
// error case the old sizeof-only guards let through. The python half
// is bad_abi_vtl.py; tests/test_vlint.py asserts the pass flags the
// swapped pair field-by-field.
#include <stdint.h>

#pragma pack(push, 1)
struct BadRec {
  uint32_t conn_id;
  uint16_t flags;     // python mirror has `port` (u16) here — name drift
  uint8_t tag[4];     // python mirror has a u32 here — same size, wrong type
  int32_t backend;
};
struct CleanRec {
  uint32_t conn_id;
  uint16_t port;
  uint8_t v6;
  uint8_t weight;
};
#pragma pack(pop)
