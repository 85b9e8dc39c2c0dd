"""upload_ms.serve: host milliseconds a request in the program's
``vimo.serve.upload`` spans: each frame window's pinned copy and its
upload to the card."""

from perfbench.spans import ms_per


def read(ctx):
    return ms_per(ctx, ["vimo.serve.upload"], "host_s", "units")
