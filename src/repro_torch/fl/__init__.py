"""Single-host FL simulator."""
