"""encode_host_ms: host milliseconds a batch of the program's encode
spans: encode:read (reading the fragments, flatten_fragments) and
encode:pack (encode_batch, pack_codes, the uploads)."""
from benchmarks import program_spans as ps


def read(rec, log=None):
    w = ps.window(rec, log)
    return w and w.ms("encode:read", "encode:pack")
