"""Telemetry (counterpart of :mod:`rabit_tpu.obs`).  Ported so far: the
log2-bucket :class:`~rabit_tpu_torch.obs.metrics.Histogram` that the
profiler's ``Timer`` wraps.  Counters, gauges, the registry and the
rest of the obs plane are not ported yet (ROADMAP A8)."""
