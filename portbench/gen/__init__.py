"""Traffic generators, one per kind of traffic file (``train``,
``serve``).  Each ``run(...)`` sets a cell up from its configuration and
traffic files, measures the window, checks what the window produced and
returns a ``harness.runner.Outcome``."""
