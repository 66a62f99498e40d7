"""One reader a metric, named as in BENCHMARK.json: `read(run)` takes the
finished run (run.py's `Run`) and returns the metric's value, or None
when the run holds nothing for it to read (the metric is then left out of
the result line; a share of a roofline or a peak is never reported as 0)."""
