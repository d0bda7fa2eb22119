"""host_tables_s: seconds of the program's devbuild.host_tables in set-up
(the device index's tables copied and decoded on the host for the host
path and the aligner)."""


def read(rec):
    return rec.get("host_tables_s") or None
