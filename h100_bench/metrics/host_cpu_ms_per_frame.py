"""The process's CPU time (user and system, every thread:
resource.getrusage) over the untraced window, a frame embedded."""


def read(run):
    return 1e3 * run.cpu_s / run.frames if run.frames else None
