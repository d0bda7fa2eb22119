"""Build the device half of a port kernel (``minimap2_tpu_torch/ops/csrc``)
with g++ on the CUDA host shim (``cuda_host_shim.h``), for CPU tests that
hold the kernel's own code bit-equal to its plain version."""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "minimap2_tpu_torch" / "ops" \
    / "csrc"
SHIM = Path(__file__).resolve().parent / "cuda_host_shim.h"
SHARED = "extern __shared__ uint4 smem[];"


def build_on_host(name, runner, out_dir):
    """csrc/<name>.cu up to the end of its anonymous namespace, with the
    CUDA headers dropped, its dynamic shared memory on the shim's, and
    ``runner`` (extern "C" entry points calling emu_launch) appended;
    returns the loaded library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ with C++20")
    src = (CSRC / f"{name}.cu").read_text()
    dev = src.split("}  // namespace")[0] + "}  // namespace\n"
    assert dev.count(SHARED) == 1
    dev = re.sub(r"#include <cuda[a-z_]*\.h>\n", "", dev)
    dev = dev.replace(SHARED, "uint4* smem = emu_smem;")
    cpp = Path(out_dir) / f"{name}_host.cpp"
    so = cpp.with_suffix(".so")
    cpp.write_text(f'#include "{SHIM}"\n' + dev + runner)
    subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", "-o", str(so), str(cpp)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))
