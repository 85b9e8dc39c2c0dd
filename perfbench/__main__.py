import sys
import time


def _process_start() -> float:
    """Wall-clock time this process started (from /proc; this module's
    import time where /proc is not there)."""
    try:
        import os

        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


_START = _process_start()

from perfbench.harness import main  # noqa: E402

sys.exit(main(start=_START))
