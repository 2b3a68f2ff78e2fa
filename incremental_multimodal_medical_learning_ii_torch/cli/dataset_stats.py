"""Dataset label statistics: the reference's CSV analysis scripts
(counterpart of the JAX package's ``cli/dataset_stats.py``).

Covers ``CSV_reformatting/count_pos_neg_in_csv.py`` (per-pattern counts),
``count_pos_neg_V2.py:50-51`` (the per-class pos/neg printout) and its
``faq-patterns/*_patterns.png`` bar charts of pattern frequencies
(``--patterns-png``, drawn by ``evaluation/plots.py``).

    python -m incremental_multimodal_medical_learning_ii_torch.cli.dataset_stats \\
        --csv test_labels.csv [--patterns-png faq-patterns/test_patterns.png] \\
        [--title "Test Pattern Frequencies"]
"""

from __future__ import annotations

import argparse

def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--csv", required=True, help="CheXpert-format label CSV")
    p.add_argument("--patterns-png", help="write the pattern-frequency bar chart here")
    p.add_argument("--title", default="Pattern Frequencies")
    args = p.parse_args(argv)

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

    if args.patterns_png:
        from incremental_multimodal_medical_learning_ii_torch.evaluation.plots import (
            label_pattern_frequency_figure,
        )

        label_pattern_frequency_figure(counts, m.label_names, title=args.title).save(
            args.patterns_png)
        print(f"wrote {args.patterns_png}")


if __name__ == "__main__":
    main()
