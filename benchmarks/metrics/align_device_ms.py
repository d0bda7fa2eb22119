"""align_device_ms: device milliseconds per batch of the launches made in
align_batch.AlignBatcher.dispatch (the extd2 DP and the traceback;
profiler)."""


def read(rec):
    if not rec["batches"] or rec["align_device_ms"] <= 0:
        return None
    return rec["align_device_ms"] / rec["batches"]
