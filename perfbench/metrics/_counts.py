"""Shared by the readers of the program's counters (``fragnet_tpu_torch/
obs.py``: ``count``, kept with the spans): a counter summed over a span
table's rows. A program that keeps no counters gives None."""


def total(tab, name):
    """The counter ``name`` summed over every span of the table ``tab``
    (``obs.span_table``), or None where no span holds it."""
    if tab is None:
        return None
    vals = [row["counts"][name] for row in tab["spans"].values()
            if name in row.get("counts", {})]
    return float(sum(vals)) if vals else None
