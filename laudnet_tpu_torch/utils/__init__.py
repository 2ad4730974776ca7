"""Host-side helpers of the port (metrics, logging, config files)."""
