"""Weight conversion and drawing helpers."""
