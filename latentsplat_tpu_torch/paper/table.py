"""Ranked LaTeX table generation.

Counterpart of latentsplat_tpu/paper/table.py: round per-column, rank the
rounded values (best bold, runner-up underlined), add up/down arrows to
metric headers, pad cells, and emit a booktabs tabular.
"""

from __future__ import annotations

from typing import Dict, List, Literal, Optional, Sequence

import numpy as np

RankOrder = Literal[-1, 0, 1]

_RANK_STYLES = (
    lambda x: f"\\textbf{{{x}}}",
    lambda x: f"\\underline{{{x}}}",
    lambda x: x,
)
_RANK_ARROWS = {0: "", 1: " $\\uparrow$", -1: " $\\downarrow$"}


def _column_ranks(values: np.ndarray, order: RankOrder) -> np.ndarray:
    """Dense ranks of one column; order=+1 means higher is better."""
    if order == 0:
        return np.full(values.shape, 10**5, dtype=np.int64)
    unique = np.sort(np.unique(values))
    if order == 1:
        unique = unique[::-1]
    ranks = np.zeros(values.shape, dtype=np.int64)
    for rank, value in enumerate(unique):
        ranks[values == value] = rank
    return ranks


def make_latex_table(
    results: Dict[str, Sequence[Optional[float]]],
    metrics: List[str],
    precisions: List[int],
    rank_orders: List[RankOrder],
) -> str:
    """results: {method name: [value per metric]} -> booktabs LaTeX source.

    Missing values (None/NaN) render as "--" and are excluded from ranking.
    """
    names = list(results.keys())
    data = np.array(
        [[np.nan if v is None else float(v) for v in results[n]] for n in names],
        dtype=np.float64,
    )
    n_rows, n_cols = data.shape
    assert n_cols == len(metrics) == len(precisions) == len(rank_orders)

    # Rank the ROUNDED values so ties at display precision share a rank.
    rounded = np.stack(
        [np.round(data[:, c], precisions[c]) for c in range(n_cols)], axis=1
    )
    ranks = np.full((n_rows, n_cols), 10**5, dtype=np.int64)
    for c in range(n_cols):
        present = ~np.isnan(rounded[:, c])
        if present.any():
            ranks[present, c] = _column_ranks(rounded[present, c], rank_orders[c])

    headers = [
        f"{metric}{_RANK_ARROWS[order]}"
        for metric, order in zip(metrics, rank_orders)
    ]
    cells: List[List[str]] = [["Method", *headers]]
    for r, name in enumerate(names):
        row = [name]
        for c in range(n_cols):
            if np.isnan(data[r, c]):
                row.append("--")
                continue
            text = f"{data[r, c]:.{precisions[c]}f}"
            style = _RANK_STYLES[min(ranks[r, c], len(_RANK_STYLES) - 1)]
            row.append(style(text))
        cells.append(row)

    widths = [
        max(len(cells[r][c]) for r in range(len(cells)))
        for c in range(n_cols + 1)
    ]
    padded = [
        [
            (cell.rjust if (r > 0 and c > 0) else cell.ljust)(widths[c])
            for c, cell in enumerate(row)
        ]
        for r, row in enumerate(cells)
    ]
    rows = [" & ".join(row) + " \\\\" for row in padded]
    header_row, *body_rows = rows
    return "\n".join(
        [
            "%%% BEGIN AUTOGENERATED %%%",
            f"\\begin{{tabular}}{{l{'r' * n_cols}}}",
            "\\toprule",
            header_row,
            "\\midrule",
            *body_rows,
            "\\bottomrule",
            "\\end{tabular}",
            "%%% END AUTOGENERATED %%%",
        ]
    )
