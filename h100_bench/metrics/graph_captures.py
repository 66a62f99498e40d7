"""CUDA graphs the engine captured during the untraced window:
len(engine.cached_graphs) after it less before it (0 when the warm-up
covered the traffic; the tower's eager path captures none)."""


def read(run):
    return float(run.graphs_after - run.graphs_before)
