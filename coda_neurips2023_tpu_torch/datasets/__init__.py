"""Dataset configuration and synthetic scenes (numpy only)."""
