"""The H100 benchmark's yardstick: traffic, weights, the counts of work,
the profiler's window and the reduction of its trace. Nothing here imports
the program under test but `systems.py`, which builds it."""
