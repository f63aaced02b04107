"""Step-addressed synthetic token data."""
