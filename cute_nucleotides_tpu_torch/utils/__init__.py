"""Host-side utilities of the port (numpy only; ``tracing``, the span
recorder, reads torch's profiler flag)."""
