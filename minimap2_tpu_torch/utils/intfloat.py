"""Bit-exact integer/float primitives (copy of minimap2_tpu.utils.intfloat's
SEQ_NT4, hash64 and the tie-break hashes and mg_log2 the host mapping path
uses: sketch.c:9-38, hit.c:40-50, khash.h, map.c:246-248, mmpriv.h:139-147)."""
from __future__ import annotations

import numpy as np

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def hash64(key, mask=_M64):
    """Invertible 64-bit mix (sketch.c:28-38). key: uint64 scalar/array."""
    key = np.asarray(key, dtype=np.uint64)
    mask = np.uint64(mask)
    with np.errstate(over="ignore"):
        key = (~key + (key << np.uint64(21))) & mask
        key = key ^ (key >> np.uint64(24))
        key = ((key + (key << np.uint64(3))) + (key << np.uint64(8))) & mask
        key = key ^ (key >> np.uint64(14))
        key = ((key + (key << np.uint64(2))) + (key << np.uint64(4))) & mask
        key = key ^ (key >> np.uint64(28))
        key = (key + (key << np.uint64(31))) & mask
    return key



def hash64_full(key):
    """hit.c:40-50 hash64 with implicit 2^64 wrap (no mask)."""
    return hash64(key, _M64)


def wang_hash32(key: int) -> int:
    """khash.h __ac_Wang_hash on uint32."""
    key = key & 0xFFFFFFFF
    key += ~(key << 15) & 0xFFFFFFFF
    key &= 0xFFFFFFFF
    key ^= key >> 10
    key += (key << 3) & 0xFFFFFFFF
    key &= 0xFFFFFFFF
    key ^= key >> 6
    key += ~(key << 11) & 0xFFFFFFFF
    key &= 0xFFFFFFFF
    key ^= key >> 16
    return key & 0xFFFFFFFF


def x31_hash_string(s: str | bytes) -> int:
    """khash.h __ac_X31_hash_string."""
    if isinstance(s, str):
        s = s.encode()
    h = 0
    for ch in s:
        h = ((h << 5) - h + ch) & 0xFFFFFFFF
    return h


def qname_hash(qname: str | None, qlen_sum: int, seed: int,
               no_hash_name: bool) -> int:
    """map.c:246-248: the per-fragment tie-break hash."""
    h = x31_hash_string(qname) if (qname is not None
                                   and not no_hash_name) else 0
    h ^= (wang_hash32(qlen_sum & 0xFFFFFFFF)
          + wang_hash32(seed & 0xFFFFFFFF)) & 0xFFFFFFFF
    return wang_hash32(h)


def mg_log2(x):
    """Fast log2 approximation (mmpriv.h:139-147); float32 bit-exact, for
    x >= 2 as in the reference.  Scalars or arrays; returns float32."""
    z = np.asarray(x, dtype=np.float32)
    zi = z.view(np.uint32)
    log_2 = (((zi >> np.uint32(23)) & np.uint32(255)).astype(np.int32)
             - 128).astype(np.float32)
    zi = zi & np.uint32(~np.uint32(255 << 23) & 0xFFFFFFFF)
    zi = zi + np.uint32(127 << 23)
    zf = zi.view(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        log_2 = log_2 + ((np.float32(-0.34484843) * zf
                          + np.float32(2.02466578)) * zf
                         - np.float32(0.67487759))
    return log_2


# seq_nt4_table (sketch.c:9-26): ASCII -> 2-bit code, 4 = ambiguous
SEQ_NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    SEQ_NT4[ord(_c)] = _i
    SEQ_NT4[ord(_c.lower())] = _i
