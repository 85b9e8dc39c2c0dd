"""fetch_wait_ms.serve: host milliseconds a request in the program's
``vimo.serve.fetch`` spans: fetching each window's embeddings, which waits
for the towers on the card."""

from perfbench.spans import ms_per


def read(ctx):
    return ms_per(ctx, ["vimo.serve.fetch"], "host_s", "units")
