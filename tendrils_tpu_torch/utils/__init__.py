"""Host-side utilities: functional helpers, profiling and tracing."""
