"""Host-side telemetry of the port (no device work, no host syncs)."""
