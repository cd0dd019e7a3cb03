"""Telemetry: the process-global counter registry."""

from .counters import COUNTERS, CounterRegistry

__all__ = ["COUNTERS", "CounterRegistry"]
