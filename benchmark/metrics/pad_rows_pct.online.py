"""pad_rows_pct.online: share of the rows the program computed for the
traced requests that are padding, from the attributes of their ``solve``
spans: 100 x sum(bucket - rows) / sum(bucket), in percent."""

from benchmark.metrics import program_spans


def read(run):
    reqs = program_spans.requests(run)
    roots = [r["solve"].attrs for r in reqs or ()]
    computed = sum(a["bucket"] for a in roots)
    if computed == 0:
        return None
    return 100.0 * sum(a["bucket"] - a["rows"] for a in roots) / computed
