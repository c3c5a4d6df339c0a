"""Dataset constants and zone geometry."""
