"""CLI entry points (``python -m ldpc_sims_tpu_torch …``)."""

from ldpc_sims_tpu_torch.cli.main import build_parser, main  # noqa: F401
