"""Host syncs of the traced passes per million pixel samples: the entries of
the program's ``sync.*`` spans, counted in its pass records
(``ptbench/spans.py``)."""

from ptbench import spans


def read(rec):
    a = spans.analysis(rec)
    if a is None:
        return None
    return sum(a["syncs"].values()) / (rec["trace_samples"] / 1e6)
