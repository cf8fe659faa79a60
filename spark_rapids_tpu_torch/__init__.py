"""spark_rapids_tpu_torch — the PyTorch + CUDA port of spark_rapids_tpu.

The JAX package (`spark_rapids_tpu/`) stays the reference; this package
mirrors its layout (plan/, ops/, exec/, columnar/, shuffle/, session.py,
conf.py) and runs the same DataFrame programs on an NVIDIA card, with the
group-by's hot kernels written by hand in CUDA C++ for sm_90a (csrc/,
built and loaded by cuda_build.py). It imports torch and numpy, never jax
and nothing of spark_rapids_tpu.

    import spark_rapids_tpu_torch as srt
    sess = srt.new_session()               # cuda:0; raises without a card
    cpu = srt.new_session(device="cpu")    # explicit CPU (the tests)
"""

__version__ = "0.1.0"

from spark_rapids_tpu_torch.conf import TpuConf  # noqa: F401


def new_session(settings=None, device=None):
    """Create a new TpuSession on `device` (default: cuda:0)."""
    from spark_rapids_tpu_torch.session import TpuSession

    return TpuSession(settings, device=device)
