"""data_wait_ms.train: host milliseconds a step in the program's
``vimo.train.data_wait`` span: the trainer waiting on its next batch (the
loader's items, ``collate_pad`` and the upload, ``vimo.data.*`` inside)."""

from perfbench.spans import ms_per


def read(ctx):
    return ms_per(ctx, ["vimo.train.data_wait"], "host_s", "steps")
