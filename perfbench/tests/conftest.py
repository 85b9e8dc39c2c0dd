"""The drivers that register their faults with ``perfbench/faults.py`` when
imported, imported before the tests are collected: the fault tests list
each cell's faults by its driver's name."""

import perfbench.drivers.serve_siglip  # noqa: F401
