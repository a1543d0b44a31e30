"""Weight conversion and checkpoint loading."""
