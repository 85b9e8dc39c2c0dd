"""host_step_ms.train: the mean host time of the benchmark's span around each
call of the trainer's ``train_step`` in the traced window."""


def read(ctx):
    spans = ctx.stats.get("host_step_s") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
