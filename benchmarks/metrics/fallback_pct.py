"""fallback_pct: share of the window's reads that the program mapped on
its host path (engine.host_path), in percent."""


def read(rec):
    if not rec["reads"]:
        return None
    return 100.0 * rec["host_path_reads"] / rec["reads"]
