"""Serving runtime of the port: ``resilience`` (fault plans, retry, health
and the degradation ladder)."""
