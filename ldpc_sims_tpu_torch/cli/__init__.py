"""CLI entry points (``python -m ldpc_sims_tpu_torch …``)."""

from ldpc_sims_tpu_torch.cli.main import (  # noqa: F401
    PRESETS,
    build_parser,
    main,
)
