"""Dataset label statistics: the reference's CSV analysis scripts
(counterpart of the JAX package's ``cli/dataset_stats.py``).

Covers ``CSV_reformatting/count_pos_neg_in_csv.py`` (per-pattern counts)
and ``count_pos_neg_V2.py:50-51`` (the per-class pos/neg printout).  The
``faq-patterns/*_patterns.png`` bar chart (``--patterns-png``) is not yet
ported: figures need matplotlib, which the card's machine lacks.

    python -m incremental_multimodal_medical_learning_ii_torch.cli.dataset_stats \\
        --csv test_labels.csv
"""

from __future__ import annotations

import argparse

PLOT_NOT_PORTED = ("not yet ported: --patterns-png needs evaluation/plots.py (matplotlib, which "
                   "the card's machine lacks; ROADMAP Queue 1, item 9)")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--csv", required=True, help="CheXpert-format label CSV")
    p.add_argument("--patterns-png", help="the pattern-frequency bar chart: not yet ported")
    p.add_argument("--title", default="Pattern Frequencies")
    args = p.parse_args(argv)
    if args.patterns_png:
        raise NotImplementedError(PLOT_NOT_PORTED)

    from incremental_multimodal_medical_learning_ii_torch.data.manifest import ChexpertManifest

    m = ChexpertManifest.from_csv(args.csv)
    n = len(m)
    if n == 0:
        print("0 rows — nothing to report")
        return
    # per-class pos/neg printout (count_pos_neg_V2.py:50-51)
    for name, pos in zip(m.label_names, m.positive_counts()):
        pos = int(pos)
        print(f"{name} {pos} {pos / n:.6f} {n - pos} {(n - pos) / n:.6f}")

    counts = m.label_pattern_counts()
    print(f"{len(counts)} distinct patterns over {n} rows")
    for pat, cnt in sorted(counts.items(), key=lambda kv: -kv[1]):
        print(f"  {''.join(str(v) for v in pat)}  {cnt}  {cnt / n:.6f}")


if __name__ == "__main__":
    main()
