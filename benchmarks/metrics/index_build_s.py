"""index_build_s: seconds of the device index build, the sum of the
program's own stage timings (devbuild.DevBuildMeta.stage_s)."""


def read(rec):
    return rec.get("index_build_s")
