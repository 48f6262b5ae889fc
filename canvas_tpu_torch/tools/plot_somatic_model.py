"""Plot the somatic purity model against observed segments.

Port of ``Tools/scripts/plotSomaticModelMatrix.r`` (the last unported
reference script): reads ``CNVModeling.txt`` from a Canvas TempCNV*
directory — expected model points (MAF, coverage, MCC/CN genotype) above a
blank line, observed segments below it — and writes
``CanvasSomaticModel.png`` (680x680): observed coverage/MAFs as gray dots,
expected model points in red with genotype labels.

Usage:
    python -m canvas_tpu_torch.tools.plot_somatic_model TEMPCNV_DIR OUT_DIR
"""

from __future__ import annotations

import sys
from pathlib import Path


def read_cnv_modeling(path) -> tuple[list[tuple[float, float, str]],
                                     list[tuple[float, float]]]:
    """Returns (expected [(maf, cov, genotype)], observed [(maf, cov)]).
    The R script splits the two tables on the column-count transition; the
    blank line the writer emits marks the same boundary."""
    expected: list[tuple[float, float, str]] = []
    observed: list[tuple[float, float]] = []
    section = 0
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            section = 1
            continue
        if line.startswith("#"):
            continue
        parts = line.split("\t")
        if section == 0:
            expected.append((float(parts[0]), float(parts[1]), parts[2]))
        else:
            observed.append((float(parts[0]), float(parts[1])))
    return expected, observed


def plot_somatic_model(tempcnv_dir, out_dir) -> Path | None:
    """plotSomaticModelMatrix.r main body; returns the PNG path (None when
    CNVModeling.txt is absent, matching the R script's message-and-exit)."""
    path = Path(tempcnv_dir) / "CNVModeling.txt"
    if not path.exists():
        print("File CNVModeling does not exist. Check that Canvas TempCNV* "
              "directory is specified correctly.", file=sys.stderr)
        return None
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    expected, observed = read_cnv_modeling(path)
    fig, ax = plt.subplots(figsize=(6.8, 6.8), dpi=100)
    if observed:
        ax.scatter([m for m, _ in observed], [c for _, c in observed],
                   s=60, color="gray", label="Observed Coverage/MAFs")
    if expected:
        ax.scatter([m for m, _c, _g in expected],
                   [c for _m, c, _g in expected],
                   s=100, color="red", label="Expected + CN GTs")
        for m, c, g in expected:
            ax.annotate(g, (m, c), textcoords="offset points",
                        xytext=(8, 4), fontsize=11)
    ax.set_xlim(0, 0.5)
    ax.set_xlabel("MAF")
    ax.set_ylabel("Coverage")
    ax.set_title("Canvas somatic model")
    ax.legend(loc="lower left", title="Legend", frameon=False)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    png = out / "CanvasSomaticModel.png"
    fig.savefig(png)
    plt.close(fig)
    return png


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("Usage: plot_somatic_model.py [Canvas TempCNV* directory] "
              "[output directory]", file=sys.stderr)
        return 2
    png = plot_somatic_model(argv[0], argv[1])
    if png is None:
        return 1
    print(f"Creating Canvas somatic model plot: {png}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
