"""Telemetry of the port: so far only the hook containers of
``paddle_tpu/observability/_state.py`` (copied), which the resilience
modules read.  The metrics registry, spans and the request trace are
still to port (ROADMAP.md, queue 1 item 4)."""
