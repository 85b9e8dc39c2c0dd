"""pool_ms.serve: host milliseconds a request in the program's
``vimo.serve.pool`` spans: grouping the clips and concatenating their frames
on the host before the embedding windows."""

from perfbench.spans import ms_per


def read(ctx):
    return ms_per(ctx, ["vimo.serve.pool"], "host_s", "units")
