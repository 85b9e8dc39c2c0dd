"""setup_s: seconds from the process's start to the window's first unit of work."""


def read(ctx):
    return ctx.setup_s
