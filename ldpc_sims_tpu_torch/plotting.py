"""Publication figures: BER/BLER/WMSE curves (the port of
``ldpc_sims_tpu.plotting``).

The matplotlib counterpart of the reference's ``plots.py:29-52`` and the
inline plot blocks in every evaluator (``evaluate_snr.py:157-197``):
semilogy BER + BLER panels comparing Traditional / NN / Quantized, plus
the WMSE panel. Figures are written to files with the headless Agg
backend. matplotlib is imported when a figure is drawn, not with this
module: the machine that runs the port on the card may not have it
(``sweep --plot`` checks before it starts).
"""

from __future__ import annotations

__all__ = ["plot_ber_curves", "plot_wmse", "plot_grid"]

_SERIES = [
    ("coded_ber", "Traditional", "C0"),
    ("coded_ber_nn", "NN", "C1"),
    ("coded_ber_qllr", "Quantized", "C2"),
]
_SERIES_BLER = [
    ("coded_bler", "Traditional", "C0"),
    ("coded_bler_nn", "NN", "C1"),
    ("coded_bler_qllr", "Quantized", "C2"),
]


def _pyplot():
    """matplotlib's pyplot on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_ber_curves(curves: dict, path: str, title: str = "") -> str:
    """Two-panel semilogy BER/BLER figure (plots.py:29-52 layout)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    snr = curves["snrdb"]
    ax = axes[0]
    if "uncoded_ber" in curves:
        ax.semilogy(snr, curves["uncoded_ber"], "k--", label="Uncoded")
    for key, label, color in _SERIES:
        if key in curves:
            ax.semilogy(snr, curves[key], marker="o", color=color,
                        label=label)
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("BER")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    ax = axes[1]
    for key, label, color in _SERIES_BLER:
        if key in curves:
            ax.semilogy(snr, curves[key], marker="s", color=color,
                        label=label)
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("BLER")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_grid(grid: dict, path: str, title: str = "") -> str:
    """Checkpoint-family grid comparison figure.

    One BER panel per qbits value: Traditional vs quantized-LLR vs NN
    curves over SNR, one line style per clipdb — the figure family the
    reference assembles from ``evaluate_quantized_grid.py`` output
    (commented-out variants in ``plots.py:55-228``).
    """
    import numpy as np

    plt = _pyplot()
    snr = grid["snrdb"]
    qbits = grid["qbits"]
    clipdb = grid["clipdb"]
    fig, axes = plt.subplots(
        1, max(len(qbits), 1), figsize=(5.5 * max(len(qbits), 1), 4.5),
        squeeze=False,
    )
    styles = ["-", "--", ":", "-."]
    for qi, qb in enumerate(qbits):
        ax = axes[0][qi]
        trad = np.asarray(grid["coded_ber"])
        for ci, cl in enumerate(clipdb):
            sty = styles[ci % len(styles)]
            ax.semilogy(snr, trad[:, qi, ci], "k" + sty, alpha=0.6,
                        label=f"Trad clip={cl:g}dB")
            for key, lbl, color in [
                ("coded_ber_qllr", "Quant", "C2"),
                ("coded_ber_nn", "NN", "C1"),
            ]:
                vals = np.asarray(grid[key])[:, qi, ci]
                if np.isfinite(vals).any():
                    ax.semilogy(snr, vals, sty, color=color, marker="o",
                                markersize=3,
                                label=f"{lbl} clip={cl:g}dB")
        ax.set_title(f"qbits={qb}")
        ax.set_xlabel("SNR (dB)")
        ax.set_ylabel("coded BER")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend(fontsize=7)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_wmse(curves: dict, path: str, title: str = "") -> str:
    """WMSE-vs-SNR panel (evaluate_snr.py:186-197)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4.5))
    for key, label in [("wmse_nn", "NN"), ("wmse_qllr", "Quantized")]:
        if key in curves:
            ax.plot(curves["snrdb"], curves[key], marker="o", label=label)
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("weighted MSE")
    ax.grid(True, alpha=0.3)
    ax.legend()
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path
