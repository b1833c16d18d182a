"""Configuration, device resolution and logging."""
