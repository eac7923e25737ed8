"""Device timing."""
