"""PyTorch/CUDA port of minimap2_tpu, the TPU-native minimap2.

The package stands alone: it imports torch and numpy, never jax and
nothing of ``minimap2_tpu``.  Module names follow the JAX package so each
counterpart is easy to find.  The seven Pallas kernels (sketch, the
3-plane and 1-plane bitonic sorts, the chain DP, the extd2 and exts2 DPs
and the traceback) are hand-written CUDA under ``ops/csrc``; the device
paths are ``parallel/`` (the ``--batch`` steps, the device index build).
The entry points are the CLI (``cli.py``, with and without ``--batch``,
its debug output included), ``mappy.py`` (the Python binding's API, on the
host) and ``tools/paftools.py``; the host mapping path is ``map/`` over
``native/``.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Without a card and without an explicit device this raises;
    the port never carries on silently on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return torch.device("cuda")
