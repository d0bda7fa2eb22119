"""paf_step_ms: device milliseconds per batch of the kernels and torch
ops launched inside engine.PafStep.forward (profiler)."""


def read(rec):
    if not rec["batches"] or rec["paf_step_device_ms"] <= 0:
        return None
    return rec["paf_step_device_ms"] / rec["batches"]
