"""ldpc_sims_tpu_torch — the PyTorch/CUDA port of ``ldpc_sims_tpu``.

A second package beside the JAX one, for one NVIDIA H100: the same
public names and layouts (LLRs ``(batch, n)`` in log(Pr1/Pr0), bits int8
``(batch, n)``), PyTorch for the tensor code, and hand-written CUDA
kernels where the JAX package has Pallas kernels. It imports neither
``jax`` nor ``ldpc_sims_tpu``. Entry points run on ``cuda`` unless the
caller passes ``device='cpu'``.

Subpackages
-----------
codes      LDPC code library (NumPy copies of the JAX package's).
ops        BP decode dispatch and its plain PyTorch version, encoder,
           PHY chain, link step.
kernels    CUDA min-sum decode kernels (flooding, layered).
parallel   The Monte-Carlo sweep engine on one device.
utils      Phase timers, device selection.
cli        ``python -m ldpc_sims_tpu_torch sweep ...``.
"""

__version__ = "0.1.0"

from ldpc_sims_tpu_torch.codes import LdpcCode, TannerGraph  # noqa: F401
