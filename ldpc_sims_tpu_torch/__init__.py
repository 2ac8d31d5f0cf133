"""ldpc_sims_tpu_torch — the PyTorch/CUDA port of ``ldpc_sims_tpu``.

A second package beside the JAX one, for one NVIDIA H100: the same
public names and layouts (LLRs ``(batch, n)`` in log(Pr1/Pr0), bits int8
``(batch, n)``), PyTorch for the tensor code, and hand-written CUDA
kernels where the JAX package has Pallas kernels. It imports neither
``jax`` nor ``ldpc_sims_tpu``. Entry points run on ``cuda`` unless the
caller passes ``device='cpu'``.

Subpackages
-----------
codes      LDPC code library (NumPy copies of the JAX package's), code
           analysis (``analyze``) and protograph density evolution
           (``de``).
ops        BP decode dispatch (the cuda, roll, dense and gather backends),
           syndromes, encoder, PHY chain, link step.
kernels    CUDA BP decode kernels (flooding, layered, group-serial;
           min-sum, sum-product; weighted; early stop; f32, bf16 and
           int8 message storage) and their launch tuner (``tune``).
models     The neural LLR estimators and the joint LLR→BP model
           (``torch.nn``).
training   The trainers (LLR estimators, the joint model, per-edge
           neural-BP weights, per-iteration min-sum schedules) and their
           datasets, on ``torch.optim``.
evaluate   BER/BLER/WMSE evaluation sweeps (Traditional, Quantized, NN).
parallel   Process meshes on torch.distributed and the sharded
           Monte-Carlo engine (sweeps, grids, the scaling probe).
native     The C++ PEG builder, built with g++ on first use.
utils      Checkpoints in the JAX package's format (its own msgpack
           codec), metrics, phase timers, profiler traces, the run
           registry, device selection, decoder-weight loading.
plotting   BER/BLER/WMSE figures (matplotlib, imported on use).
grid       The per-SNR model-family chain (``train_grid``) and its grid
           evaluation (``evaluate_grid``).
diagnostics  The quantization-noise study and the joint model's
           cross-check.
cli        ``python -m ldpc_sims_tpu_torch sweep|evaluate|scaling-probe|
           train-llr|train-joint|train-grid|train-minsum|evaluate-grid|
           noise-study|evaluate-joint|generate-data|code-info``.
examples   ``bigcode`` (the 5G-class codes at full width on the card),
           ``error_floor_campaign``, ``de_thresholds``,
           ``joint_before_after``.
"""

__version__ = "0.1.0"

from ldpc_sims_tpu_torch.codes import LdpcCode, TannerGraph  # noqa: F401
