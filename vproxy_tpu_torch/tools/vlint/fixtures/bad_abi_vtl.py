"""vlint ABI-pass fixture — the python half of bad_abi.cpp.

BAD_REC totals 14 bytes, exactly like the C BadRec, but field 2 is
named/typed differently and field 3 swapped a u32 for a 4-byte array:
total-size guards pass, the field-by-field pass must not. CLEAN_REC
mirrors CleanRec exactly (the no-false-positive case).
"""
import struct

BAD_REC = struct.Struct("<IHIi")
BAD_REC_FIELDS = ("conn_id", "port", "peer_ip", "backend")

CLEAN_REC = struct.Struct("<IHBB")
CLEAN_REC_FIELDS = ("conn_id", "port", "v6", "weight")
