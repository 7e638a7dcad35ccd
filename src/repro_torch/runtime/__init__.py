"""Runtime of the port: ``resilience`` (serving: fault plans, retry, health
and the degradation ladder) and ``trainer`` (training: checkpoint and
restart, failure injection, the straggler watchdog)."""
