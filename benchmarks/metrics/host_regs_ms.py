"""host_regs_ms: host milliseconds per call of engine.batch_build_regs
(chain records and CIGARs to regions, one call a batch) in the window."""


def read(rec):
    spans = rec["spans"].get("regs", [])
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
