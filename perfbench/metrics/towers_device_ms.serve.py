"""towers_device_ms.serve: device milliseconds a request of the kernels,
copies and sets launched inside the program's ``vimo.serve.embed`` spans:
preprocessing, frame differences and both towers."""

from perfbench.spans import ms_per


def read(ctx):
    return ms_per(ctx, ["vimo.serve.embed"], "device_s", "units")
